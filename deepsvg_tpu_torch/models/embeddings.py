"""Input embeddings, counterparts of ``deepsvg_tpu/models/embeddings.py``.

``SVGEmbedding`` sums the command embedding, the per-argument embedding
(11 args x 64 dims through one Linear to d_model), the group-index
embedding of the one-stage models (``use_group``: the running moveto count,
``group_len + 2`` rows) and a learned positional table. The argument
vocabulary is ``args_dim + 1`` (PAD and the quantized values) or, for the
relative targets of the autoregressive decoder (``rel_args``),
``2 * args_dim``. The argument embedding and its Linear fold into per-slot
``[vocab, D]`` tables (``ops.embedding.fold_arg_tables``) and the whole sum
runs as kernel K1; when training, the fold stays in the graph (plain
products, as JAX leaves it to XLA), so ``arg_embed`` and ``embed_fcn`` get
their gradients through kernel K6's gradient of the folded tables.
:meth:`SVGEmbedding.token` embeds the one token of an autoregressive decode
step at a given position, with plain lookups and the Linear, as the JAX
package's ``pos_index`` path does.

``ConstEmbedding`` gives the learned positional queries of the one-shot
decoders, ``LabelEmbedding`` the class-label table of the label-conditioned
models.
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
    """Command + argument (+ group) + positional embedding of
    ``commands [B, S]``, ``args [B, S, n_args]`` (PAD -1, shifted by +1),
    ``groups [B, S]`` (with ``use_group``), then dropout."""

    def __init__(self, cfg: ModelConfig, seq_len: int, rel_args: bool = False,
                 use_group: bool = False, group_len: int | None = None):
        super().__init__()
        d = cfg.d_model
        self.n_args = cfg.n_args
        self.dropout = cfg.dropout
        self.use_group = use_group
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        vocab = 2 * cfg.args_dim if rel_args else cfg.args_dim + 1
        self.command_embed = nn.Parameter(torch.zeros(cfg.n_commands, d))
        self.arg_embed = nn.Parameter(torch.zeros(vocab, ARG_EMBED_DIM))
        self.embed_fcn = nn.Linear(ARG_EMBED_DIM * cfg.n_args, d)
        if use_group:
            group_len = cfg.max_num_groups if group_len is None else group_len
            self.group_embed = nn.Parameter(torch.zeros(group_len + 2, d))
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
                if not torch.compiler.is_compiling():    # kept as cast_at_use keeps
                    self.__dict__["_folded"] = hit
            arg_tables = hit[1]
        else:
            arg_tables = embedding_ops.fold_arg_tables(*(p.to(dt) for p in masters),
                                                       self.n_args)
        return cast("cmd", self.command_embed), arg_tables, cast("pos", self.pos_embed)

    def group_table(self, deterministic: bool = True):
        if not self.use_group:
            return None
        return cast_at_use(self, "group", self.group_embed, self.compute_dtype,
                           deterministic=deterministic)

    def forward(self, commands, args, groups=None, deterministic: bool = True,
                rng: DropoutRng | None = None):
        s = commands.shape[1]
        cmd_table, arg_tables, pos_table = self.tables(deterministic)
        inputs = (commands, args, groups, cmd_table, arg_tables,
                  self.group_table(deterministic), pos_table[:s], self.use_group)
        if deterministic:
            return embedding_ops.fused_embedding(*inputs)
        src = embedding_ops.fused_embedding_train(*inputs)
        return rng.dropout(src, self.dropout) if rng is not None else src

    def token(self, commands, args, groups, index: int):
        """The embedding of one token per sequence at position ``index``:
        ``commands [B]``, ``args [B, n_args]``, ``groups [B]`` -> ``[B, D]``
        in the compute type, no dropout (inference). Plain lookups and the
        argument Linear, summed in the JAX package's order."""
        dt = self.compute_dtype
        cast = lambda name, p: cast_at_use(self, name, p, dt)  # noqa: E731
        b = commands.shape[0]
        arg_emb = cast("arg", self.arg_embed)[(args + 1).long()].reshape(b, -1)
        src = (cast("cmd", self.command_embed)[commands.long()]
               + torch.nn.functional.linear(arg_emb, cast("fcn_w", self.embed_fcn.weight),
                                            cast("fcn_b", self.embed_fcn.bias)))
        if self.use_group:
            src = src + self.group_table()[groups.long()]
        return src + cast("pos", self.pos_embed)[index]


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


class LabelEmbedding(nn.Module):
    """Class-label embedding ``label [B]`` -> ``[B, dim_label]`` in the compute
    dtype: an ``n_labels x dim_label`` table (flax ``nn.Embed``, initialised
    as the other tables), cast at use."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.embedding = nn.Parameter(torch.zeros(cfg.n_labels, cfg.dim_label))

    def forward(self, label, deterministic: bool = True):
        table = cast_at_use(self, "embedding", self.embedding, self.compute_dtype,
                            deterministic=deterministic)
        return table[label.long()]
