"""Fused SVG-token embedding: kernel K1 and its plain version.

The model's input embedding is a sum of lookups. With the argument
embedding and its projection folded into per-slot tables
(:func:`fold_arg_tables`), every output row is

    out[b, s] = CmdT[cmd] + sum_i T_i[arg_i + 1] (+ GroupT[gid]) + PosT[s]

Kernel note (``csrc/embedding.cu``). Replaces the Pallas kernel
``deepsvg_tpu/ops/embedding.py:_embed_kernel`` (wrapper ``fused_embedding``),
which ran the lookups as one-hot matmuls because the TPU's gathers are slow.
On the H100 the op is a gather-sum bound by memory: at the flagship's
N=1024 it writes 8192x32x256 bf16 (134 MB) and reads 12.6 MB of ids, about
44 us at 3.35 TB/s; the 1.4 MB of tables stay in L2. The kernel therefore
gathers: one thread per pair of output columns (bf16x2), f32 sums in the
same order as the one-hot matmuls, one bf16 store.

An id outside ``[0, vocab)`` matches no one-hot column in the Pallas kernel
and so contributes zero; the kernel and the plain version do the same.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def fold_arg_tables(arg_embed: torch.Tensor, fcn_weight: torch.Tensor,
                    fcn_bias: torch.Tensor, n_args: int) -> torch.Tensor:
    """Fold ``embed_fcn(concat_i(arg_embed[a_i]))`` into per-slot tables
    ``T_i = arg_embed @ W_i`` with the bias on slot 0.

    arg_embed ``[vocab, E]``; fcn_weight ``[D, E*n_args]`` (``nn.Linear``
    layout); returns ``[n_args*vocab, D]``.
    """
    vocab, e = arg_embed.shape
    w = fcn_weight.t().reshape(n_args, e, -1)          # [n_args, E, D]
    tables = torch.matmul(arg_embed, w)                # [n_args, vocab, D]
    tables[0] += fcn_bias
    return tables.reshape(n_args * vocab, -1)


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """f32 rows of ``table`` at ``ids``; out-of-range ids give zero rows."""
    n = table.shape[0]
    valid = (ids >= 0) & (ids < n)
    rows = table.float()[ids.clamp(0, n - 1)]
    return torch.where(valid[..., None], rows, torch.zeros_like(rows))


def embedding_reference(commands, args, groups, cmd_table, arg_tables,
                        group_table, pos_table, use_group: bool = False):
    """Plain version of :func:`fused_embedding` (same arguments)."""
    s = commands.shape[1]
    n_args = args.shape[-1]
    vocab = arg_tables.shape[0] // n_args
    a = args.to(torch.int64) + 1                       # PAD -1 -> row 0
    acc = _lookup(cmd_table, commands.to(torch.int64))
    for i in range(n_args):
        acc = acc + _lookup(arg_tables[i * vocab:(i + 1) * vocab], a[..., i])
    if use_group:
        acc = acc + _lookup(group_table, groups.to(torch.int64))
    acc = acc + pos_table[:s].float()
    return acc.to(cmd_table.dtype)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def fused_embedding(commands, args, groups, cmd_table, arg_tables, group_table,
                    pos_table, use_group: bool = False):
    """Embedding sum for ``commands [B, S]`` (int), ``args [B, S, n_args]``
    (float or int, PAD -1), ``groups [B, S]`` (used when ``use_group``);
    tables ``cmd [n_cmd, D]``, ``arg [n_args*vocab, D]``, ``group [g, D]``,
    ``pos [S, D]``. Returns ``[B, S, D]`` in the tables' dtype.

    A CPU tensor takes :func:`embedding_reference`; a CUDA tensor launches
    the kernel (bfloat16 tables) or raises.
    """
    if commands.device.type == "cpu":
        return embedding_reference(commands, args, groups, cmd_table, arg_tables,
                                   group_table, pos_table, use_group)
    if commands.device.type != "cuda":
        raise ValueError(f"no embedding kernel for device {commands.device}")
    dev = commands.device
    b, s = commands.shape
    n_args = args.shape[-1]
    d = cmd_table.shape[1]
    vocab = arg_tables.shape[0] // n_args
    bf16 = torch.bfloat16
    if d % 2:
        raise ValueError(f"d_model must be even, got {d}")
    _build.require(args, "args", dev, shape=(b, s, n_args))
    _build.require(cmd_table, "cmd_table", dev, bf16, (cmd_table.shape[0], d))
    _build.require(arg_tables, "arg_tables", dev, bf16, (n_args * vocab, d))
    _build.require(pos_table, "pos_table", dev, bf16, (s, d))
    cmd32 = commands.to(torch.int32).contiguous()
    args32 = args.to(torch.int32).contiguous()          # one cast, as the TPU wrapper
    if use_group:
        _build.require(group_table, "group_table", dev, bf16, (group_table.shape[0], d))
        groups32 = groups.to(torch.int32).contiguous()
        _build.require(groups32, "groups", dev, shape=(b, s))
        n_group = group_table.shape[0]
    else:
        groups32, group_table, n_group = cmd32, cmd_table, 0
    out = torch.empty((b, s, d), dtype=bf16, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.kernel_function("dsvg_embedding", _ARGTYPES)
    rc = fn(cmd32.data_ptr(), args32.data_ptr(), groups32.data_ptr(),
            cmd_table.data_ptr(), arg_tables.data_ptr(), group_table.data_ptr(),
            pos_table.data_ptr(), out.data_ptr(), b * s, s, d, n_args, vocab,
            cmd_table.shape[0], n_group, int(use_group),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "embedding")
    fused_embedding.launches += 1
    return out


fused_embedding.launches = 0
