"""Fused classification heads + argmax: kernel K3 and its plain version.

Greedy sampling needs only the argmax of the command head ``[D, 7]`` and of
each of the 11 argument slots of the argument head ``[D, 11*257]``. The
kernel never stores the logits: it returns ``ids [R, 12]`` int32 (column 0
the command, columns 1..11 the arguments), ties to the smallest index.

Both versions read the head in a per-slot padded layout that
:func:`pack_head` builds once when the weights are loaded: the command slot
is padded to 16 rows and each 257-row argument slot to 272, so every slot
is a whole number of 16-column tensor-core tiles; padded columns are masked.

Kernel note (``csrc/head.cu``). Replaces the Pallas kernel
``deepsvg_tpu/ops/head.py:_head_kernel`` (wrapper ``fused_head_argmax``).
At the flagship's N=1024 (R = 1024*8*31 = 253,952 rows) the heads are
2*R*256*2834 = 368 GFLOP, 0.37 ms at 989 TFLOP/s bf16; the inputs are 130
MB (0.04 ms). The bound is the tensor cores. The kernel is the argument
cross-entropy's forward (``csrc/ce.cu``, K5) with a running (max, first
index) in place of the log-sum-exp: persistent blocks of a TMA producer warp
and two ``wgmma`` consumer warpgroups; a work item is (128 or 256 rows,
slot), a block's items run tile by tile so that the rows' ``x`` is loaded
into shared memory once for all 12 slots; the head streams through an
``mbarrier`` ring in chunks of 128 columns (a slot's last 16 columns as a
narrow chunk), the logits stay in the accumulators with the bias added from
the stage, and the running (max, index) of a row is merged across the quad
by shuffles at the slot's end. The autoregressive decode calls it with R = N
rows a step (8 row tiles x 12 slots at N=1024).

A float32 model takes the kernel's float32 form: float32 ``x``, head and
bias, products on the tensor cores in TF32 (``wgmma`` m64nNk8; the operands
rounded to nearest TF32, the sums float32): the kernel rounds ``x`` in shared
memory as each tile arrives, and :func:`fused_head_argmax` rounds the packed
head once per packed head (``layer.tf32_copy``). The Pallas kernel
multiplies in its operands' type; the plain version here in full float32, so
ids may differ only where two logits lie within TF32's rounding of each
other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .layer import tf32_copy

TILE = 16


def _round_up(n: int, m: int = TILE) -> int:
    return -(-n // m) * m


def pack_head(wc, bc, wa, ba, n_args: int):
    """Command head ``wc [n_cmd, D]``, ``bc [n_cmd]`` and argument head
    ``wa [n_args*vocab, D]``, ``ba`` (``nn.Linear`` layout) -> the padded
    per-slot layout ``w [C, D]`` and ``b [C]``, both in the weights' dtype
    (the bias is added in float32 inside the kernel)."""
    n_cmd, d = wc.shape
    vocab = wa.shape[0] // n_args
    cw, aw = _round_up(n_cmd), _round_up(vocab)
    w = torch.zeros(cw + n_args * aw, d, dtype=wc.dtype, device=wc.device)
    b = torch.zeros(cw + n_args * aw, dtype=wc.dtype, device=wc.device)
    w[:n_cmd], b[:n_cmd] = wc, bc
    for i in range(n_args):
        o = cw + i * aw
        w[o:o + vocab] = wa[i * vocab:(i + 1) * vocab]
        b[o:o + vocab] = ba[i * vocab:(i + 1) * vocab]
    return w, b


def head_argmax_reference(x, w_packed, b_packed, n_commands: int, n_args: int,
                          args_vocab: int):
    """Plain version of :func:`fused_head_argmax` (same arguments)."""
    logits = torch.matmul(x.float(), w_packed.float().t()) + b_packed.float()
    cw, aw = _round_up(n_commands), _round_up(args_vocab)
    ids = [logits[:, :n_commands].argmax(dim=-1)]
    for i in range(n_args):
        o = cw + i * aw
        ids.append(logits[:, o:o + args_vocab].argmax(dim=-1))
    return torch.stack(ids, dim=1).to(torch.int32)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fused_head_argmax(x, w_packed, b_packed, n_commands: int, n_args: int,
                      args_vocab: int):
    """``x [R, D]`` decoder states -> ``ids [R, 1 + n_args]`` int32.

    A CPU tensor takes :func:`head_argmax_reference`; a CUDA tensor launches
    the kernel (``x`` and head both bfloat16 or both float32) or raises.
    """
    if x.device.type == "cpu":
        return head_argmax_reference(x, w_packed, b_packed, n_commands, n_args,
                                     args_vocab)
    if x.device.type != "cuda":
        raise ValueError(f"no head kernel for device {x.device}")
    dev = x.device
    r, d = x.shape
    c = _round_up(n_commands) + n_args * _round_up(args_vocab)
    dt = _build.kernel_dtype(x, "x")
    if d % TILE:
        raise ValueError(f"head kernel takes D a multiple of {TILE}, got {d}")
    _build.require(x, "x", dev, dt, (r, d))
    _build.require(w_packed, "w_packed", dev, dt, (c, d))
    _build.require(b_packed, "b_packed", dev, dt, (c,))
    if b_packed.data_ptr() % 16:
        raise ValueError("the head kernel takes b_packed 16-byte aligned")
    ids = torch.empty((r, 1 + n_args), dtype=torch.int32, device=dev)
    if r == 0:
        return ids
    if dt == torch.float32:
        w_packed = tf32_copy(w_packed)
    fn = _build.kernel_function("dsvg_head_argmax", _ARGTYPES)
    rc = fn(x.data_ptr(), w_packed.data_ptr(), b_packed.data_ptr(), ids.data_ptr(),
            r, d, n_commands, n_args, args_vocab, int(dt == torch.float32),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "head")
    fused_head_argmax.launches += 1
    fused_head_argmax.float32_launches += dt == torch.float32
    return ids


fused_head_argmax.launches = 0            # every launch
fused_head_argmax.float32_launches = 0    # those of its float32 form
