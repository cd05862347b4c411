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

Backward: kernel K6 (``csrc/embedding_bwd.cu``) replaces the Pallas kernel
``deepsvg_tpu/ops/embedding.py:_embed_bwd_kernel`` (wrapper
``fused_embedding_train``), which formed the table gradients as transposed
one-hot matmuls because scatters are slow on the TPU. Here they are what they
are, a scatter-add of the ``dy`` rows, bound by reading ``dy`` once (16.8 MB
at B=128, 5 us), and summed with no atomics, in an order fixed by the inputs:
the tables are the same to the bit from run to run, as the Pallas kernel's
sequential grid gives them. The rows that most tokens hit (the 7 command rows
and each slot's PAD row) are summed per block of 128 tokens in shared memory,
each block's sums written to a slice of a scratch tensor and the slices added
in block order. The other argument rows and the group rows are a segment sum
over the (token, row) entries ordered by row: a small kernel writes each
entry's row as its key, a stable sort on the device (``torch.sort``) orders
them, and warps sum chunks of 32 sorted entries, a row that spans chunks
joined in chunk order. The position rows, one per position of the sequence,
are summed in blocks of their own in a fixed order (they do not sit in the
shared table, which would not fit at S >= 210 with D = 256). Its plain
version is autograd through :func:`embedding_reference`.
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


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def fused_embedding(commands, args, groups, cmd_table, arg_tables, group_table,
                    pos_table, use_group: bool = False):
    """Embedding sum for ``commands [B, S]`` (int), ``args [B, S, n_args]``
    (float or int, PAD -1), ``groups [B, S]`` (used when ``use_group``);
    tables ``cmd [n_cmd, D]``, ``arg [n_args*vocab, D]``, ``group [g, D]``,
    ``pos [S, D]``. Returns ``[B, S, D]`` in the tables' dtype.

    A CPU tensor takes :func:`embedding_reference`; a CUDA tensor launches
    the kernel (tables all bfloat16 or all float32) or raises.
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
    dt = _build.kernel_dtype(cmd_table, "cmd_table")
    if d % 2:
        raise ValueError(f"d_model must be even, got {d}")
    _build.require(cmd_table, "cmd_table", dev, dt, (cmd_table.shape[0], d))
    _build.require(arg_tables, "arg_tables", dev, dt, (n_args * vocab, d))
    _build.require(pos_table, "pos_table", dev, dt, (s, d))
    cmd32 = commands.to(torch.int32).contiguous()
    # one cast, as the TPU wrapper; the ids may come as a view (the teacher-
    # forced decoder's targets without their last position)
    args32 = args.to(torch.int32).contiguous()
    _build.require(args32, "args", dev, shape=(b, s, n_args))
    if use_group:
        _build.require(group_table, "group_table", dev, dt, (group_table.shape[0], d))
        groups32 = groups.to(torch.int32).contiguous()
        _build.require(groups32, "groups", dev, shape=(b, s))
        n_group = group_table.shape[0]
    else:
        groups32, group_table, n_group = cmd32, cmd_table, 0
    out = torch.empty((b, s, d), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.kernel_function("dsvg_embedding", _ARGTYPES)
    rc = fn(cmd32.data_ptr(), args32.data_ptr(), groups32.data_ptr(),
            cmd_table.data_ptr(), arg_tables.data_ptr(), group_table.data_ptr(),
            pos_table.data_ptr(), out.data_ptr(), b * s, s, d, n_args, vocab,
            cmd_table.shape[0], n_group, int(use_group), int(dt == torch.float32),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "embedding")
    fused_embedding.launches += 1
    fused_embedding.float32_launches += dt == torch.float32
    return out


fused_embedding.launches = 0            # every launch
fused_embedding.float32_launches = 0    # those of its float32 form


_BWD_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 8
                 + [ctypes.c_void_p])
_KEYS_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
BWD_TOKENS_PER_BLOCK = 128   # tokens a hot block sums (csrc/embedding_bwd.cu)
BWD_COLD_CHUNK = 32          # sorted entries a warp sums (csrc/embedding_bwd.cu)


def embedding_backward(commands, args, groups, dy, n_cmd: int, vocab: int, n_group: int,
                       use_group: bool):
    """Kernel K6: ``dy [B, S, D]`` (bfloat16 or float32, CUDA; D a multiple
    of 8, any S) -> float32 ``dcmd [n_cmd, D]``, ``darg [n_args*vocab, D]``,
    ``dgroup [n_group, D]``, ``dpos [S, D]``, the same to the bit from run
    to run."""
    dev = dy.device
    b, s, d = dy.shape
    n_args = args.shape[-1]
    if dy.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dy has dtype {dy.dtype}, expected bfloat16 or float32")
    if d % 8:
        raise ValueError(f"the embedding backward kernel takes D a multiple of 8, got {d}")
    dy = dy.contiguous()
    cmd32 = commands.to(torch.int32).contiguous()
    args32 = args.to(torch.int32).contiguous()
    groups32 = groups.to(torch.int32).contiguous() if use_group else cmd32
    _build.require(cmd32, "commands", dev, shape=(b, s))
    _build.require(args32, "args", dev, shape=(b, s, n_args))
    _build.require(groups32, "groups", dev, shape=(b, s))
    zeros = lambda n: torch.zeros((n, d), dtype=torch.float32, device=dev)  # noqa: E731
    dcmd, darg, dgroup, dpos = zeros(n_cmd), zeros(n_args * vocab), zeros(max(n_group, 1)), zeros(s)
    if dy.numel():
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows, n_group_used = b * s, n_group if use_group else 0
        entries = rows * (n_args + int(use_group))
        # the cold entries' rows as keys, then their stable order by row
        keys = torch.empty(entries, dtype=torch.int32, device=dev)
        fn = _build.kernel_function("dsvg_embedding_bwd_keys", _KEYS_ARGTYPES)
        _build.check_launch(fn(args32.data_ptr(), groups32.data_ptr(), keys.data_ptr(), rows,
                               n_args, vocab, n_group_used, int(use_group), stream),
                            "embedding_bwd_keys")
        keys, order = torch.sort(keys, stable=True)
        part = torch.empty((-(-rows // BWD_TOKENS_PER_BLOCK), n_cmd + n_args, d),
                           dtype=torch.float32, device=dev)
        head = torch.empty((2, -(-entries // BWD_COLD_CHUNK), d), dtype=torch.float32,
                           device=dev)
        fn = _build.kernel_function("dsvg_embedding_bwd", _BWD_ARGTYPES)
        rc = fn(cmd32.data_ptr(), args32.data_ptr(), dy.data_ptr(), dcmd.data_ptr(),
                darg.data_ptr(), dgroup.data_ptr(), dpos.data_ptr(), keys.data_ptr(),
                order.data_ptr(), part.data_ptr(), head[0].data_ptr(), head[1].data_ptr(),
                rows, s, d, n_args, vocab, n_cmd, n_group_used, int(use_group),
                int(dy.dtype == torch.float32), stream)
        _build.check_launch(rc, "embedding_bwd")
        embedding_backward.launches += 1
    return dcmd, darg, dgroup[:n_group], dpos


embedding_backward.launches = 0


class _FusedEmbeddingTrain(torch.autograd.Function):
    """K1 forward, K6 backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, commands, args, groups, cmd_table, arg_tables, group_table,
                pos_table, use_group):
        tables = [t.detach().contiguous() for t in (cmd_table, arg_tables, pos_table)]
        gt = group_table.detach().contiguous() if use_group else None
        out = fused_embedding(commands, args, groups, tables[0], tables[1], gt, tables[2],
                              use_group)
        ctx.save_for_backward(commands, args, groups if use_group else commands)
        ctx.meta = (cmd_table.shape[0], arg_tables.shape[0] // args.shape[-1],
                    group_table.shape[0] if use_group else 0, use_group,
                    cmd_table.dtype)
        return out

    @staticmethod
    def backward(ctx, dy):
        commands, args, groups = ctx.saved_tensors
        n_cmd, vocab, n_group, use_group, dt = ctx.meta
        dcmd, darg, dgroup, dpos = embedding_backward(
            commands, args, groups, dy, n_cmd, vocab, n_group, use_group)
        return (None, None, None, dcmd.to(dt), darg.to(dt),
                dgroup.to(dt) if use_group else None, dpos.to(dt), None)


def fused_embedding_train(commands, args, groups, cmd_table, arg_tables, group_table,
                          pos_table, use_group: bool = False):
    """Differentiable :func:`fused_embedding`: gradients flow to the four
    tables (in their dtype, summed in float32). A CPU tensor takes
    :func:`embedding_reference` under autograd; a CUDA tensor runs kernel K1
    forward and kernel K6 backward."""
    if commands.device.type == "cpu":
        return embedding_reference(commands, args, groups, cmd_table, arg_tables,
                                   group_table, pos_table, use_group)
    return _FusedEmbeddingTrain.apply(commands, args, groups, cmd_table, arg_tables,
                                      group_table, pos_table, use_group)
