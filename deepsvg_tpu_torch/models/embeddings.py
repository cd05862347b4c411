"""Input embeddings, counterparts of ``deepsvg_tpu/models/embeddings.py``.

``SVGEmbedding`` sums the command embedding, the per-argument embedding
(11 args x 64 dims through one Linear to d_model) and a learned positional
table. The group-index embedding and the relative-argument vocabulary of
the one-stage and autoregressive variants are not ported yet (the model
raises on those variants). The argument embedding and its Linear fold into
per-slot ``[vocab, D]`` tables (``ops.embedding.fold_arg_tables``) and the
whole sum runs as kernel K1; when training, the fold stays in the graph
(plain products, as JAX leaves it to XLA), so ``arg_embed`` and ``embed_fcn``
get their gradients through kernel K6's gradient of the folded tables.

``ConstEmbedding`` gives the learned positional queries of the one-shot
decoders.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import embedding as embedding_ops
from .cast import DropoutRng, cast_at_use
from .config import ModelConfig
from .layers import PositionalEncodingLUT

ARG_EMBED_DIM = 64


class SVGEmbedding(nn.Module):
    """Command + argument + positional embedding of ``commands [B, S]``,
    ``args [B, S, n_args]`` (PAD -1, shifted by +1), then dropout."""

    def __init__(self, cfg: ModelConfig, seq_len: int):
        super().__init__()
        d = cfg.d_model
        self.n_args = cfg.n_args
        self.dropout = cfg.dropout
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.command_embed = nn.Parameter(torch.zeros(cfg.n_commands, d))
        self.arg_embed = nn.Parameter(torch.zeros(cfg.args_dim + 1, ARG_EMBED_DIM))
        self.embed_fcn = nn.Linear(ARG_EMBED_DIM * cfg.n_args, d)
        self.pos_embed = nn.Parameter(torch.zeros(seq_len + 2, d))

    def tables(self, deterministic: bool = True):
        """(command table, folded argument tables, positional table) in the
        compute dtype. At inference the fold is made once per weight load."""
        dt = self.compute_dtype
        cast = lambda name, p: cast_at_use(self, name, p, dt,  # noqa: E731
                                           deterministic=deterministic)
        masters = (self.arg_embed, self.embed_fcn.weight, self.embed_fcn.bias)
        if deterministic:
            stamp = tuple((p._version, p.data_ptr()) for p in masters)
            hit = self.__dict__.get("_folded")
            if hit is None or hit[0] != stamp:
                with torch.no_grad():
                    hit = (stamp, embedding_ops.fold_arg_tables(
                        *(p.detach().to(dt) for p in masters), self.n_args))
                self.__dict__["_folded"] = hit
            arg_tables = hit[1]
        else:
            arg_tables = embedding_ops.fold_arg_tables(*(p.to(dt) for p in masters),
                                                       self.n_args)
        return cast("cmd", self.command_embed), arg_tables, cast("pos", self.pos_embed)

    def forward(self, commands, args, deterministic: bool = True,
                rng: DropoutRng | None = None):
        s = commands.shape[1]
        cmd_table, arg_tables, pos_table = self.tables(deterministic)
        if deterministic:
            return embedding_ops.fused_embedding(commands, args, None, cmd_table,
                                                 arg_tables, None, pos_table[:s])
        src = embedding_ops.fused_embedding_train(commands, args, None, cmd_table,
                                                  arg_tables, None, pos_table[:s])
        return rng.dropout(src, self.dropout) if rng is not None else src


class ConstEmbedding(nn.Module):
    """Learned positional queries for one-shot decoding: the positional
    table applied to zeros, repeated over the batch."""

    def __init__(self, cfg: ModelConfig, seq_len: int):
        super().__init__()
        self.seq_len = seq_len
        self.PE = PositionalEncodingLUT(seq_len, cfg.d_model, cfg.dropout,
                                        getattr(torch, cfg.compute_dtype))

    def forward(self, batch_size: int, deterministic: bool = True,
                rng: DropoutRng | None = None):
        table = self.PE.table(deterministic)
        zeros = torch.zeros((batch_size, self.seq_len, table.shape[1]),
                            dtype=table.dtype, device=table.device)
        return self.PE(zeros, deterministic, rng)
