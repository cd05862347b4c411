"""Input embeddings, counterparts of ``deepsvg_tpu/models/embeddings.py``.

``SVGEmbedding`` sums the command embedding, the per-argument embedding
(11 args x 64 dims through one Linear to d_model) and a learned positional
table. The group-index embedding and the relative-argument vocabulary of
the one-stage and autoregressive variants are not ported yet (the model
raises on those variants). The argument embedding and its
Linear fold into per-slot ``[vocab, D]`` tables (``ops.embedding.
fold_arg_tables``) and the whole sum runs as kernel K1.

``ConstEmbedding`` gives the learned positional queries of the one-shot
decoders.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import embedding as embedding_ops
from .config import ModelConfig
from .layers import PositionalEncodingLUT

ARG_EMBED_DIM = 64


class SVGEmbedding(nn.Module):
    """Command + argument + positional embedding of ``commands [B, S]``,
    ``args [B, S, n_args]`` (PAD -1, shifted by +1)."""

    def __init__(self, cfg: ModelConfig, seq_len: int):
        super().__init__()
        d = cfg.d_model
        self.n_args = cfg.n_args
        self.command_embed = nn.Parameter(torch.zeros(cfg.n_commands, d))
        self.arg_embed = nn.Parameter(torch.zeros(cfg.args_dim + 1, ARG_EMBED_DIM))
        self.embed_fcn = nn.Linear(ARG_EMBED_DIM * cfg.n_args, d)
        self.pos_embed = nn.Parameter(torch.zeros(seq_len + 2, d))

    def forward(self, commands, args):
        s = commands.shape[1]
        arg_tables = embedding_ops.fold_arg_tables(
            self.arg_embed, self.embed_fcn.weight, self.embed_fcn.bias, self.n_args)
        return embedding_ops.fused_embedding(
            commands, args, None, self.command_embed, arg_tables, None,
            self.pos_embed[:s])


class ConstEmbedding(nn.Module):
    """Learned positional queries for one-shot decoding: the positional
    table applied to zeros, repeated over the batch."""

    def __init__(self, cfg: ModelConfig, seq_len: int):
        super().__init__()
        self.seq_len = seq_len
        self.PE = PositionalEncodingLUT(seq_len, cfg.d_model)

    def forward(self, batch_size: int):
        table = self.PE.pos_embed
        return self.PE(torch.zeros((batch_size, self.seq_len, table.shape[1]),
                                   dtype=table.dtype, device=table.device))
