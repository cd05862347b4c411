"""Fused argument-head softmax cross-entropy: kernel K5 and its plain version.

The argument head expands the decoder states ``[R, D]`` to ``[R, 11, 257]``
logits, the largest tensor of the training step. This op computes the
per-token, per-slot cross-entropy ``[R, 11]`` straight from
``(y, Wa, ba, targets)``: the forward never stores the logits and the
backward recomputes them tile by tile.

Kernel note (``csrc/ce.cu``). Replaces the Pallas kernels
``deepsvg_tpu/ops/ce.py:_fwd_kernel`` and ``_bwd_kernel`` (wrapper
``args_ce``). At the flagship's B=128 (R = 128*8*31 = 31,744 rows) the
forward is 2*R*256*2827 = 45.9 GFLOP (0.046 ms at 989 TFLOP/s bf16) and the
backward three such products (logits again, dy, dW), 0.14 ms; the bytes (y,
dy, the head, its gradient) are 37 MB, 0.011 ms. The bound is the tensor
cores. The kernels read the head in K3's padded per-slot layout (257 -> 272
columns per slot), stage it in 64-column chunks, and keep a running
(max, sum, target logit) per row. ``dlg = (softmax - onehot) * g`` is rounded
to the activation type before the ``dy`` and ``dW`` products, as in the
Pallas body. ``dW`` and ``db`` are sums over all rows: a second backward
kernel owns one chunk of the head per block, walks a split of the rows
recomputing the logits, and writes per-split partial sums that a reduction
kernel adds in a fixed order (no atomics; the result is deterministic). The
logits are therefore computed twice in the backward.

Targets outside ``[0, vocab)`` match no class: the row's loss is its
log-sum-exp and its gradient the plain softmax, as with the one-hot of the
Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .head import _round_up
from .layer_vjp import reduce_partials


def args_ce_reference(y, wa, ba, targets, n_args: int):
    """Plain version of :func:`args_ce` (differentiable): ``y [R, D]``,
    ``wa [n_args*vocab, D]``, ``ba`` as they are used (already cast),
    ``targets [R, n_args]`` int -> ``[R, n_args]`` float32. The gradient of
    the logits is rounded to ``y``'s type before it reaches ``y`` and ``wa``,
    as the kernel rounds it."""
    r = y.shape[0]
    vocab = wa.shape[0] // n_args
    logits = torch.matmul(y.float(), wa.float().t()).reshape(r, n_args, vocab)
    logits = _RoundGrad.apply(logits, y.dtype) + ba.float().reshape(n_args, vocab)
    lse = torch.logsumexp(logits, dim=-1)
    t = targets.to(torch.int64)
    valid = (t >= 0) & (t < vocab)
    tl = logits.gather(-1, t.clamp(0, vocab - 1)[..., None])[..., 0]
    return lse - torch.where(valid, tl, torch.zeros_like(tl))


class _RoundGrad(torch.autograd.Function):
    """Identity whose gradient is rounded to ``dtype`` (and back)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DY_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DW_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
DW_MAX_SPLITS = 8


def pack_args_head(wa, ba, n_args: int, dtype):
    """``wa [n_args*vocab, D]``, ``ba`` -> the argument slots of K3's padded
    layout, ``[n_args*round16(vocab), D]`` and ``[n_args*round16(vocab)]``, in
    ``dtype``."""
    vocab, d = wa.shape[0] // n_args, wa.shape[1]
    aw = _round_up(vocab)
    w = torch.zeros((n_args, aw, d), dtype=dtype, device=wa.device)
    b = torch.zeros((n_args, aw), dtype=dtype, device=wa.device)
    w[:, :vocab] = wa.detach().reshape(n_args, vocab, d)
    b[:, :vocab] = ba.detach().reshape(n_args, vocab)
    return w.reshape(n_args * aw, d), b.reshape(n_args * aw)


class _ArgsCE(torch.autograd.Function):
    """K5 on CUDA tensors."""

    @staticmethod
    def forward(ctx, y, wa, ba, targets, n_args, weight_dtype):
        dev = y.device
        r, d = y.shape
        vocab = wa.shape[0] // n_args
        if y.dtype != torch.bfloat16 or weight_dtype != torch.bfloat16:
            raise ValueError(f"the cross-entropy kernel takes bfloat16 states and head, "
                             f"got {y.dtype} and {weight_dtype}")
        if d % 32 or d > 256:
            raise ValueError(f"the cross-entropy kernel takes D a multiple of 32 up to "
                             f"256, got {d}")
        y = y.contiguous()
        w, b = pack_args_head(wa, ba, n_args, torch.bfloat16)
        tgt = targets.to(torch.int32).contiguous()
        _build.require(y, "y", dev, torch.bfloat16, (r, d))
        _build.require(tgt, "targets", dev, torch.int32, (r, n_args))
        ce = torch.empty((r, n_args), dtype=torch.float32, device=dev)
        lse = torch.empty_like(ce)
        if r > 0:
            fn = _build.kernel_function("dsvg_ce_fwd", _FWD_ARGTYPES)
            rc = fn(y.data_ptr(), w.data_ptr(), b.data_ptr(), tgt.data_ptr(),
                    ce.data_ptr(), lse.data_ptr(), r, d, n_args, vocab,
                    torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(rc, "ce_fwd")
            args_ce.launches += 1
        ctx.save_for_backward(y, w, b, tgt, lse)
        ctx.meta = (n_args, vocab)
        return ce

    @staticmethod
    def backward(ctx, g):
        y, w, b, tgt, lse = ctx.saved_tensors
        n_args, vocab = ctx.meta
        dev = y.device
        r, d = y.shape
        aw = _round_up(vocab)
        stream = torch.cuda.current_stream(dev).cuda_stream
        g = g.to(torch.float32).contiguous()
        dy = torch.empty_like(y)
        common = (y.data_ptr(), w.data_ptr(), b.data_ptr(), tgt.data_ptr(), g.data_ptr(),
                  lse.data_ptr())
        fn = _build.kernel_function("dsvg_ce_bwd_dy", _DY_ARGTYPES)
        _build.check_launch(fn(*common, dy.data_ptr(), r, d, n_args, vocab, stream),
                            "ce_bwd_dy")
        args_ce.backward_launches += 1
        splits = max(1, min(DW_MAX_SPLITS, -(-r // 64)))
        dw_part = torch.empty((splits, n_args * aw * d), dtype=torch.float32, device=dev)
        db_part = torch.empty((splits, n_args * aw), dtype=torch.float32, device=dev)
        fn = _build.kernel_function("dsvg_ce_bwd_dw", _DW_ARGTYPES)
        _build.check_launch(fn(*common, dw_part.data_ptr(), db_part.data_ptr(), r, d,
                               n_args, vocab, splits, stream), "ce_bwd_dw")
        dwa = reduce_partials(dw_part).view(n_args, aw, d)[:, :vocab].reshape(-1, d)
        dba = reduce_partials(db_part).view(n_args, aw)[:, :vocab].reshape(-1)
        return dy, dwa, dba, None, None, None


def plain_args_ce(y, wa, ba, targets, weight_dtype=None):
    """:func:`args_ce` through the plain version, on any device."""
    weight_dtype = weight_dtype or y.dtype
    n_args = targets.shape[-1]
    ce = args_ce_reference(y.reshape(-1, y.shape[-1]), wa.to(weight_dtype),
                           ba.to(weight_dtype), targets.reshape(-1, n_args), n_args)
    return ce.reshape(y.shape[:-1] + (n_args,))


def args_ce(y, wa, ba, targets, weight_dtype=None):
    """Per-token, per-slot cross-entropy ``[..., n_args]`` (float32) of the
    argument head ``wa [n_args*vocab, D]``, ``ba`` (``nn.Linear`` layout, the
    master parameters, cast to ``weight_dtype`` at use) applied to
    ``y [..., D]``, against integer ``targets [..., n_args]`` in
    ``[0, vocab)``. Differentiable in ``y``, ``wa``, ``ba``.

    A CPU tensor takes :func:`args_ce_reference` under autograd; a CUDA
    tensor launches the kernels (bfloat16) or raises.
    """
    if y.device.type == "cpu":
        return plain_args_ce(y, wa, ba, targets, weight_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"no cross-entropy kernel for device {y.device}")
    n_args = targets.shape[-1]
    ce = _ArgsCE.apply(y.reshape(-1, y.shape[-1]), wa, ba, targets.reshape(-1, n_args),
                       n_args, weight_dtype or y.dtype)
    return ce.reshape(y.shape[:-1] + (n_args,))


args_ce.launches = 0            # forward launches
args_ce.backward_launches = 0   # backward passes (dy, dW, two reductions)
