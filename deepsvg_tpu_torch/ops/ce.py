"""Fused argument-head softmax cross-entropy: kernels K5 and K8 and their
plain versions.

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

A float32 model takes the kernels' float32 forms: float32 ``y``, head, bias
and ``dy``, products on the tensor cores in TF32 (``wmma`` 16x16x8, float32
sums), the forward staging 32-column chunks (its 128-row ``y`` tile is twice
the bytes), the backward as in bfloat16 with ``dlg`` kept in float32; the
weight gradients stay float32 in a fixed order. The Pallas kernels multiply
in their operands' type; the plain version multiplies in full float32.

Targets outside ``[0, vocab)`` match no class: the row's loss is its
log-sum-exp and its gradient the plain softmax, as with the one-hot of the
Pallas kernel.

Kernel note, K8 (``csrc/ce.cu``, ``ce_pairwise``). Replaces
``deepsvg_tpu/ops/ce.py:_pairwise_kernel`` (wrapper ``args_ce_pairwise``):
the self-match cost, each row's argument CE against G candidate target rows,
forward only (the matching runs under ``no_grad``). It is K5's forward with
G targets: the same blocks of 128 rows, the same 64-column head chunks
through ``wmma`` and running (max, sum) per row and slot; each candidate's
target logit is read from the chunk's logits in shared memory when its column
passes. At the self-match recipe (B=60: R = 60*8*31 = 14,880 rows, G = 8)
the products are 2*R*256*2827 = 21.5 GFLOP, 0.022 ms at the bf16 peak; the
bytes (y, the head, the targets and the ``[R, 88]`` float32 output) are about
20 MB, 0.006 ms: the bound is the tensor cores. The targets keep the JAX
contract, one row of G*11 per state row, so the caller broadcasts the
``[N, S, G*11]`` targets over the P proposals (5.2 MB at the recipe) and
the kernel reads them once per row.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .head import _round_up
from .layer_vjp import reduce_partials


def args_ce_reference(y, wa, ba, targets, n_args: int):
    """Plain version of :func:`args_ce` (differentiable) and, with V > 1, of
    :func:`args_ce_pairwise`: ``y [R, D]``, ``wa [n_args*vocab, D]``, ``ba``
    as they are used (already cast), ``targets [R, V*n_args]`` int (V
    candidate target rows, variant-major) -> ``[R, V*n_args]`` float32. The
    gradient of the logits is rounded to ``y``'s type before it reaches ``y``
    and ``wa``, as the kernel rounds it."""
    r = y.shape[0]
    vocab = wa.shape[0] // n_args
    logits = torch.matmul(y.float(), wa.float().t()).reshape(r, 1, n_args, vocab)
    logits = _RoundGrad.apply(logits, y.dtype) + ba.float().reshape(n_args, vocab)
    lse = torch.logsumexp(logits, dim=-1)                                # [R, 1, n_args]
    t = targets.to(torch.int64).reshape(r, -1, n_args)
    valid = (t >= 0) & (t < vocab)
    tl = logits.expand(t.shape + (vocab,)).gather(-1, t.clamp(0, vocab - 1)[..., None])[..., 0]
    return (lse - torch.where(valid, tl, torch.zeros_like(tl))).reshape(targets.shape)


class _RoundGrad(torch.autograd.Function):
    """Identity whose gradient is rounded to ``dtype`` (and back)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DY_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DW_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
DW_MAX_SPLITS = 8


def _check_types(what: str, y_dtype, weight_dtype) -> None:
    """Raise unless the states and the head are both bfloat16 or both float32."""
    if y_dtype not in _build.KERNEL_DTYPES or weight_dtype != y_dtype:
        raise ValueError(f"the {what} kernel takes states and head both bfloat16 or both "
                         f"float32, got states of dtype {y_dtype} and head of dtype "
                         f"{weight_dtype}")


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
        dt = y.dtype
        _check_types("cross-entropy", dt, weight_dtype)
        if d % 32 or d > 256:
            raise ValueError(f"the cross-entropy kernel takes D a multiple of 32 up to "
                             f"256, got {d}")
        y = y.contiguous()
        w, b = pack_args_head(wa, ba, n_args, dt)
        tgt = targets.to(torch.int32).contiguous()
        _build.require(y, "y", dev, dt, (r, d))
        _build.require(tgt, "targets", dev, torch.int32, (r, n_args))
        ce = torch.empty((r, n_args), dtype=torch.float32, device=dev)
        lse = torch.empty_like(ce)
        if r > 0:
            fn = _build.kernel_function("dsvg_ce_fwd", _FWD_ARGTYPES)
            rc = fn(y.data_ptr(), w.data_ptr(), b.data_ptr(), tgt.data_ptr(),
                    ce.data_ptr(), lse.data_ptr(), r, d, n_args, vocab,
                    int(dt == torch.float32), torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(rc, "ce_fwd")
            args_ce.launches += 1
            args_ce.float32_launches += dt == torch.float32
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
        is_f32 = int(y.dtype == torch.float32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        g = g.to(torch.float32).contiguous()
        dy = torch.empty_like(y)
        common = (y.data_ptr(), w.data_ptr(), b.data_ptr(), tgt.data_ptr(), g.data_ptr(),
                  lse.data_ptr())
        fn = _build.kernel_function("dsvg_ce_bwd_dy", _DY_ARGTYPES)
        _build.check_launch(fn(*common, dy.data_ptr(), r, d, n_args, vocab, is_f32, stream),
                            "ce_bwd_dy")
        args_ce.backward_launches += 1
        args_ce.float32_backward_launches += is_f32
        splits = max(1, min(DW_MAX_SPLITS, -(-r // 64)))
        dw_part = torch.empty((splits, n_args * aw * d), dtype=torch.float32, device=dev)
        db_part = torch.empty((splits, n_args * aw), dtype=torch.float32, device=dev)
        fn = _build.kernel_function("dsvg_ce_bwd_dw", _DW_ARGTYPES)
        _build.check_launch(fn(*common, dw_part.data_ptr(), db_part.data_ptr(), r, d,
                               n_args, vocab, splits, is_f32, stream), "ce_bwd_dw")
        dwa = reduce_partials(dw_part).view(n_args, aw, d)[:, :vocab].reshape(-1, d)
        dba = reduce_partials(db_part).view(n_args, aw)[:, :vocab].reshape(-1)
        return dy, dwa, dba, None, None, None


def args_ce_pairwise_reference(y, wa, ba, targets, n_variants: int):
    """Plain version of :func:`args_ce_pairwise` in its contract: ``y [R,
    D]``, ``wa [n_args*vocab, D]``, ``ba`` as they are used, ``targets [R,
    n_variants*n_args]`` int (variant-major) -> ``[R, n_variants*n_args]``
    float32, ``lse - logit[target]`` (a target outside ``[0, vocab)``
    matches no class)."""
    return args_ce_reference(y, wa, ba, targets, targets.shape[-1] // n_variants)


_PAIRWISE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def plain_args_ce_pairwise(y, wa, ba, targets, n_variants: int, weight_dtype=None):
    """:func:`args_ce_pairwise` through the plain version, on any device."""
    weight_dtype = weight_dtype or y.dtype
    with torch.no_grad():
        ce = args_ce_pairwise_reference(y.reshape(-1, y.shape[-1]), wa.to(weight_dtype),
                                        ba.to(weight_dtype),
                                        targets.reshape(-1, targets.shape[-1]), n_variants)
    return ce.reshape(targets.shape)


def args_ce_pairwise(y, wa, ba, targets, n_variants: int, weight_dtype=None):
    """Pairwise argument-head cross-entropy ``[..., n_variants*n_args]``
    (float32) of ``y [..., D]`` against ``n_variants`` candidate target rows
    per row (``targets [..., n_variants*n_args]``, variant-major, classes in
    ``[0, vocab)``); ``wa [n_args*vocab, D]``, ``ba`` are the master
    parameters, cast to ``weight_dtype`` at use. No gradient.

    A CPU tensor takes :func:`args_ce_pairwise_reference`; a CUDA tensor
    launches K8 (states and head both bfloat16 or both float32) or raises.
    """
    if y.device.type == "cpu":
        return plain_args_ce_pairwise(y, wa, ba, targets, n_variants, weight_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"no pairwise cross-entropy kernel for device {y.device}")
    dev = y.device
    d, k = y.shape[-1], targets.shape[-1]
    n_args = k // n_variants
    vocab = wa.shape[0] // n_args
    dt = y.dtype
    _check_types("pairwise cross-entropy", dt, weight_dtype or dt)
    if d % 32 or d > 256:
        raise ValueError(f"the pairwise cross-entropy kernel takes D a multiple of 32 up to "
                         f"256, got {d}")
    if k != n_variants * n_args or targets.shape[:-1] != y.shape[:-1]:
        raise ValueError(f"targets {tuple(targets.shape)} do not fit y {tuple(y.shape)} and "
                         f"{n_variants} variants of {n_args} slots")
    with torch.no_grad():
        yf = y.detach().reshape(-1, d).contiguous()
        r = yf.shape[0]
        w, b = pack_args_head(wa, ba, n_args, dt)
        tgt = targets.reshape(r, k).to(torch.int32).contiguous()
        _build.require(yf, "y", dev, dt, (r, d))
        _build.require(tgt, "targets", dev, torch.int32, (r, k))
        ce = torch.empty((r, k), dtype=torch.float32, device=dev)
        if r > 0:
            fn = _build.kernel_function("dsvg_ce_pairwise", _PAIRWISE_ARGTYPES)
            rc = fn(yf.data_ptr(), w.data_ptr(), b.data_ptr(), tgt.data_ptr(), ce.data_ptr(), r,
                    d, n_args, vocab, n_variants, int(dt == torch.float32),
                    torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(rc, "ce_pairwise")
            args_ce_pairwise.launches += 1
            args_ce_pairwise.float32_launches += dt == torch.float32
    return ce.reshape(targets.shape)


args_ce_pairwise.launches = 0            # every launch
args_ce_pairwise.float32_launches = 0    # those of its float32 form


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
    tensor launches the kernels (states and head both bfloat16 or both
    float32) or raises.
    """
    if y.device.type == "cpu":
        return plain_args_ce(y, wa, ba, targets, weight_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"no cross-entropy kernel for device {y.device}")
    n_args = targets.shape[-1]
    ce = _ArgsCE.apply(y.reshape(-1, y.shape[-1]), wa, ba, targets.reshape(-1, n_args),
                       n_args, weight_dtype or y.dtype)
    return ce.reshape(y.shape[:-1] + (n_args,))


args_ce.launches = 0                    # forward launches
args_ce.backward_launches = 0           # backward passes (dy, dW, two reductions)
args_ce.float32_launches = 0            # those of the float32 form
args_ce.float32_backward_launches = 0
