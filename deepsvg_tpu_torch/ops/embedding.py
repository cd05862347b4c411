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
gathers, f32 sums in the same order as the one-hot matmuls, one store in the
tables' type. Its Hopper form (D a multiple of 64, 11 argument slots) runs
a warp a row, 16 bytes a lane, the rows most tokens read (command rows,
each slot's PAD row and, where they fit, the position rows; :func:`k1_plan`)
in shared memory with each command's float32 prefix sums over the leading
PAD slots (a row starts from one: the same sum, a third of the adds), and
writes with streaming stores; any other even D takes
the first kernel, one thread a pair of columns, counted apart under
``fused_embedding.narrow_launches``.

An id outside ``[0, vocab)`` matches no one-hot column in the Pallas kernel
and so contributes zero; the kernel and the plain version do the same.

Backward: kernel K6 (``csrc/embedding_bwd.cu``) replaces the Pallas kernel
``deepsvg_tpu/ops/embedding.py:_embed_bwd_kernel`` (wrapper
``fused_embedding_train``), which formed the table gradients as transposed
one-hot matmuls because scatters are slow on the TPU. Here they are what they
are, a scatter-add of the ``dy`` rows, bound by reading ``dy`` once (16.8 MB
at B=128, 5 us), and summed with no atomics, in an order fixed by the inputs:
the tables are the same to the bit from run to run, as the Pallas kernel's
sequential grid gives them. One launch of a persistent grid with one
grid-wide barrier: per block of 128 or 256 tokens, the rows most tokens hit
(the 7 command rows and each slot's PAD row) are summed in registers, and
the other argument and group entries are sorted by row in token order (a
counting sort within the block), a row's segment of 8 or more entries summed
there in chunks; after
the barrier, a warp takes each such row and sums its items (tokens' rows,
chunk sums) over the blocks in block order, each position row over the
sequences, and each hot row over the blocks' sums. No sort, no zero fill:
every element of the four tables is written once. Its workspace
(:func:`k6_plan`) is kept from call to call. Its plain version is autograd
through :func:`embedding_reference`.
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
_HOPPER_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])
K1_ARGS = 11                 # argument slots the Hopper kernel unrolls (csrc/embedding.cu)
K1_SMEM_MAX = 96 * 1024      # its shared memory a block (HOT_SMEM_MAX): 2 or 3 blocks an SM
K1_PREFIXES = 3              # float32 prefix sums a command (slots 0-4, 0-8, 0-10 PAD)


def k1_plan(n_cmd: int, n_args: int, s: int, d: int, itemsize: int):
    """Which K1 kernel takes these widths: ``None`` for the first kernel
    (D not a multiple of 64, or not 11 argument slots), else ``(pos_in_smem,
    smem_bytes)`` for the Hopper kernel, whose blocks hold in shared memory
    each command's float32 prefix sums, the command rows and each slot's
    PAD row, and the ``s`` position rows too where all fit in
    K1_SMEM_MAX."""
    if d % 64 or n_args != K1_ARGS:
        return None
    row = d * itemsize
    hot = n_cmd * K1_PREFIXES * d * 4 + (n_cmd + n_args) * row
    if hot + s * row <= K1_SMEM_MAX:
        return True, hot + s * row
    if hot <= K1_SMEM_MAX:
        return False, hot
    return None


def _ids(commands, args, groups, use_group: bool):
    """The ids as the kernels read them: contiguous int32 (one cast, as the
    TPU wrapper; the ids may come as a view, the teacher-forced decoder's
    targets without their last position)."""
    cmd32 = commands.to(torch.int32).contiguous()
    args32 = args.to(torch.int32).contiguous()
    groups32 = groups.to(torch.int32).contiguous() if use_group else cmd32
    return cmd32, args32, groups32


def fused_embedding(commands, args, groups, cmd_table, arg_tables, group_table,
                    pos_table, use_group: bool = False):
    """Embedding sum for ``commands [B, S]`` (int), ``args [B, S, n_args]``
    (float or int, PAD -1), ``groups [B, S]`` (used when ``use_group``);
    tables ``cmd [n_cmd, D]``, ``arg [n_args*vocab, D]``, ``group [g, D]``,
    ``pos [S, D]``. Returns ``[B, S, D]`` in the tables' dtype.

    The operator ``deepsvg::embedding``: a CPU tensor takes
    :func:`embedding_reference`; a CUDA tensor launches the kernel (tables all
    bfloat16 or all float32) or raises.
    """
    _build.check_device(commands, "embedding")
    if _build.plain(commands, cmd_table, arg_tables, group_table, pos_table):
        return embedding_reference(commands, args, groups, cmd_table, arg_tables,
                                   group_table, pos_table, use_group)
    return torch.ops.deepsvg.embedding(commands, args, groups if use_group else None,
                                       cmd_table, arg_tables,
                                       group_table if use_group else None, pos_table,
                                       use_group)


fused_embedding.launches = 0            # every launch
fused_embedding.float32_launches = 0    # those of its float32 form
fused_embedding.narrow_launches = 0     # those of the first kernel (widths the Hopper one refuses)


@torch.library.custom_op("deepsvg::embedding", mutates_args=())
def _embedding_op(commands: torch.Tensor, args: torch.Tensor, groups: torch.Tensor | None,
                  cmd_table: torch.Tensor, arg_tables: torch.Tensor,
                  group_table: torch.Tensor | None, pos_table: torch.Tensor,
                  use_group: bool) -> torch.Tensor:
    return embedding_reference(commands, args, groups, cmd_table, arg_tables, group_table,
                               pos_table, use_group)


@_embedding_op.register_fake
def _(commands, args, groups, cmd_table, arg_tables, group_table, pos_table, use_group):
    return cmd_table.new_empty(tuple(commands.shape) + (cmd_table.shape[1],))


@_embedding_op.register_kernel("cuda")
def _(commands, args, groups, cmd_table, arg_tables, group_table, pos_table, use_group):
    dev = commands.device
    b, s = commands.shape
    n_args = args.shape[-1]
    d = cmd_table.shape[1]
    vocab = arg_tables.shape[0] // n_args
    n_cmd = cmd_table.shape[0]
    dt = _build.kernel_dtype(cmd_table, "cmd_table")
    if d % 2:
        raise ValueError(f"d_model must be even, got {d}")
    _build.require(cmd_table, "cmd_table", dev, dt, (n_cmd, d))
    _build.require(arg_tables, "arg_tables", dev, dt, (n_args * vocab, d))
    _build.require(pos_table, "pos_table", dev, dt, (s, d))
    cmd32, args32, groups32 = _ids(commands, args, groups, use_group)
    _build.require(args32, "args", dev, shape=(b, s, n_args))
    if use_group:
        _build.require(group_table, "group_table", dev, dt, (group_table.shape[0], d))
        _build.require(groups32, "groups", dev, shape=(b, s))
        n_group = group_table.shape[0]
    else:
        group_table, n_group = cmd_table, 0
    out = torch.empty((b, s, d), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    ptrs = (cmd32.data_ptr(), args32.data_ptr(), groups32.data_ptr(), cmd_table.data_ptr(),
            arg_tables.data_ptr(), group_table.data_ptr(), pos_table.data_ptr(),
            out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = k1_plan(n_cmd, n_args, s, d, cmd_table.element_size())
    if plan is None:
        fn = _build.kernel_function("dsvg_embedding", _ARGTYPES)
        rc = fn(*ptrs, b * s, s, d, n_args, vocab, n_cmd, n_group, int(use_group),
                int(dt == torch.float32), stream)
        fused_embedding.narrow_launches += 1
    else:
        fn = _build.kernel_function("dsvg_embedding_hopper", _HOPPER_ARGTYPES)
        rc = fn(*ptrs, b * s, s, d, vocab, n_cmd, n_group, int(use_group), int(plan[0]),
                plan[1], int(dt == torch.float32), stream)
    _build.check_launch(rc, "embedding")
    fused_embedding.launches += 1
    fused_embedding.float32_launches += dt == torch.float32
    return out


_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 11
                 + [ctypes.c_void_p])
# csrc/embedding_bwd.cu: threads a block (16 warps), the hot sums' token
# groups, hot rows a pass, four-column quads a pass, and the entries of one
# row in a token block from which phase 1 sums them
K6_THREADS, K6_GROUPS, K6_HOT_G, K6_QUADS, K6_LONG = 512, 8, 9, 64, 8
# tokens a token block: 128, or 256 above 132 x 128 tokens (an H100's SMs x
# 128), so that a block takes one token block on the flagship's B=128 step;
# a fixed rule of the token count, so the sums' order is the inputs' alone
K6_TB_SMALL, K6_TB_LARGE, K6_TB_SWITCH = 128, 256, 132 * 128
K6_SMEM_MAX = 232448         # an H100 block's shared memory
_ALIGN = 256


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def k6_plan(rows: int, d: int, n_args: int, vocab: int, n_cmd: int, n_group: int,
            use_group: bool) -> dict:
    """K6's sizes for ``rows`` tokens: tokens a token block ``tb``, token
    blocks ``ntb``, cold rows ``R``
    (``n_args * vocab + n_group``), cold slots a token ``per``, the shared
    memory of a block, and the workspace's four parts, each a byte offset
    and a size: ``part`` (float32 [ntb, n_cmd + n_args, d], the hot rows'
    sums by block), ``lp`` (int32 [R + 1, ntb], each block's first place of
    each cold row), ``list`` (int32 [ntb, tb * per], each block's cold
    entries' tokens, ordered by row) and ``seg`` (float32 [ntb, tb * per /
    8, d], the sums of the chunks of a block's segments of at least 8
    entries). Raises on widths the kernel does not take."""
    per = n_args + int(use_group)
    if d % 8:
        raise ValueError(f"the embedding backward kernel takes D a multiple of 8, got {d}")
    if n_cmd + n_args > 32 or per > K6_THREADS // 32:
        raise ValueError(f"the embedding backward kernel takes at most 32 hot rows and 16 "
                         f"slots, got {n_cmd} + {n_args} and {per}")
    tb = K6_TB_LARGE if rows > K6_TB_SWITCH else K6_TB_SMALL
    ntb = -(-rows // tb)
    r = n_args * vocab + n_group
    # phase 1's arrays; phase 2 reuses them for each warp's 2 x 512 items
    smem = max(tb * 4 + 3 * tb * per * 4 + _up(r + 1, 4) * 4
               + K6_GROUPS * K6_HOT_G * K6_QUADS * 16 + (K6_THREADS // 32) * 4,
               K6_THREADS // 32 * 2 * 512 * 4)
    if smem > K6_SMEM_MAX:
        raise ValueError(f"the embedding backward kernel takes at most about 36,000 table rows, "
                         f"got {r}")
    sizes = {"part": ntb * (n_cmd + n_args) * d * 4, "lp": ntb * (r + 1) * 4,
             "list": ntb * tb * per * 4, "seg": ntb * (tb * per // K6_LONG) * d * 4}
    plan, at = {"tb": tb, "ntb": ntb, "R": r, "per": per, "smem": smem}, 0
    for name, size in sizes.items():
        plan[name] = (at, size)
        at += _up(size, _ALIGN)
    plan["workspace"] = at
    return plan


_workspaces: dict = {}


def _workspace(dev, stream: int, n_bytes: int) -> torch.Tensor:
    """K6's workspace on ``dev``, kept from call to call on one stream and
    grown when a call needs more."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < n_bytes:
        ws = torch.empty(max(n_bytes, 1), dtype=torch.uint8, device=dev)
        _workspaces[key] = ws
    return ws


def embedding_backward(commands, args, groups, dy, n_cmd: int, vocab: int, n_group: int,
                       use_group: bool, stamps=None):
    """Kernel K6: ``dy [B, S, D]`` (bfloat16 or float32, CUDA; D a multiple
    of 8, any S) -> float32 ``dcmd [n_cmd, D]``, ``darg [n_args*vocab, D]``,
    ``dgroup [n_group, D]`` (zero unless ``use_group``), ``dpos [S, D]``,
    the same to the bit from run to run. One launch (int32 contiguous ids
    are read as they are; other ids are cast first). ``stamps``, an int64
    CUDA tensor ``[n, 8]``, takes the card's clock (ns) for the first ``n``
    blocks at the start, after phase 1, after the grid barrier and at the
    end, and within its first token block (a measurement; None in use; see
    ``csrc/embedding_bwd.cu``)."""
    dev = dy.device
    b, s, d = dy.shape
    n_args = args.shape[-1]
    if dy.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dy has dtype {dy.dtype}, expected bfloat16 or float32")
    plan = k6_plan(b * s, d, n_args, vocab, n_cmd, n_group, use_group)
    dy = dy.contiguous()
    cmd32, args32, groups32 = _ids(commands, args, groups, use_group)
    _build.require(cmd32, "commands", dev, shape=(b, s))
    _build.require(args32, "args", dev, shape=(b, s, n_args))
    _build.require(groups32, "groups", dev, shape=(b, s))
    out = lambda n: torch.empty((n, d), dtype=torch.float32, device=dev)  # noqa: E731
    dcmd, darg, dgroup, dpos = out(n_cmd), out(n_args * vocab), out(n_group), out(s)
    if not dy.numel():
        return tuple(t.zero_() for t in (dcmd, darg, dgroup, dpos))
    stream = torch.cuda.current_stream(dev).cuda_stream
    base = _workspace(dev, stream, plan["workspace"]).data_ptr()
    fn = _build.kernel_function("dsvg_embedding_bwd", _BWD_ARGTYPES)
    rc = fn(cmd32.data_ptr(), args32.data_ptr(), groups32.data_ptr(), dy.data_ptr(),
            dcmd.data_ptr(), darg.data_ptr(), dgroup.data_ptr(), dpos.data_ptr(),
            base + plan["part"][0], base + plan["lp"][0], base + plan["list"][0],
            base + plan["seg"][0], None if stamps is None else stamps.data_ptr(), b * s, s, d,
            n_args, vocab, n_cmd, n_group, int(use_group),
            0 if stamps is None else stamps.shape[0], plan["tb"], plan["smem"],
            int(dy.dtype == torch.float32), stream)
    _build.check_launch(rc, "embedding_bwd")
    embedding_backward.launches += 1
    return dcmd, darg, dgroup, dpos


embedding_backward.launches = 0


class _FusedEmbeddingTrain(torch.autograd.Function):
    """K1 forward, K6 backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, commands, args, groups, cmd_table, arg_tables, group_table,
                pos_table, use_group):
        tables = [t.detach().contiguous() for t in (cmd_table, arg_tables, pos_table)]
        gt = group_table.detach().contiguous() if use_group else None
        ids = _ids(commands, args, groups, use_group)   # cast once, read by K1 and K6
        out = fused_embedding(ids[0], ids[1], ids[2], tables[0], tables[1], gt, tables[2],
                              use_group)
        ctx.save_for_backward(*ids)
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
