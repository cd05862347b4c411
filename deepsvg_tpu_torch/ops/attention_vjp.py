"""Differentiable attention block with dropout: kernel K11 and its plain
version.

The counterpart of the JAX package's ``ops/attention_vjp.py``
(``fused_mha_train``): :func:`ops.attention.fused_mha` with dropout on the
attention probabilities, differentiable in ``x`` and the four weights.

Dropout uses the port's hash masks (``ops/dropout.py``) at
``SITE_ATTN_PROB``, row ``(b * H + h) * S + i``, column ``j``: at one seed
K11 drops exactly the probabilities that K4 drops, and the kernel and its
plain version drop the same ones. The TPU's PRNG and the interpret-mode
hash of the Pallas kernel (salted by its grid index) are not reproduced.

Kernel note. Replaces the Pallas kernels
``deepsvg_tpu/ops/attention_vjp.py:_fwd_kernel`` and ``_bwd_kernel``
(wrapper ``fused_mha_train``). As there, the forward saves nothing but its
inputs, and the backward recomputes QKV, the probabilities and the context.
On the H100 the block is bound by its products: at Sketchformer's encoder
shape (60 sequences of 242, D=256) the forward is 2 x 14,520 x 262,144 =
7.6 GFLOP of projections and 2 x 60 x 8 x 242^2 x 64 = 3.6 GFLOP of
attention, the backward about twice that plus the recompute.

The forward is K10's (``ops/attention.py``, :func:`~.attention.mha_form`)
with the dropout switch: at D=256 the Hopper forms (``csrc/layer_long.cu``
in bfloat16, ``csrc/layer_f32.cu`` in float32) drop the probabilities in
registers at the hash coordinates, other widths the first port's kernels
(``csrc/attention.cu``, counted under ``narrow_launches``).

The backward is the first port's (``csrc/attention.cu``), three launches
and the weight products: (a) over row tiles, the QKV recompute and ``dctx =
g Wo``, and the column sums of ``g``; (b) one block per (sequence, head),
with Q, K and V of the head in shared memory: per tile of queries the scores
and the probabilities recomputed, ``dPe = dctx V^T``, the softmax backward,
the context (for ``dWo``) and ``dQ`` written, ``dK`` and ``dV`` held in
tensor-core accumulators over the tiles in order; (c) over row tiles,
``dx = dqkv Wqkv`` and the column sums of ``dqkv``; then ``csrc/wgrad.cu``
for ``dWqkv = dqkv^T x`` and ``dWo = g^T ctx`` in fixed-order partial sums,
and the reductions. At D=256 the QKV of (a) comes from the Hopper forms' own
QKV launch (:func:`~.attention.launch_qkv`), so the backward starts from
the forward's QKV to the bit; its softmax and context products are the
first port's, which sum in another order than the Hopper forward (the
recomputed probabilities and context can differ from the forward's in the
last bit). No atomics: reruns are bit-equal.

Roundings are the Pallas kernels': QKV, the dropped probabilities and the
context before their products; in the backward ``dctx``, ``ds`` and ``dq``,
``dk``, ``dv`` before theirs. ``dx`` comes back in ``x``'s type and the
weight gradients are summed in float32 and cast to the weights' type (``dbo``
to ``wo``'s), as the JAX rule casts them.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .attention import check_mha_inputs, count_launch, launch_forward, launch_qkv, mha_reference
from .dropout import drop_threshold, keep_scale
from .layer import HEAD_DIM
from .layer_vjp import _padded_rows, reduce_partials, weight_products

_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _pad_rows(t: torch.Tensor) -> torch.Tensor:
    """``t [rows, n]`` with zero rows appended up to a multiple of 16 (the
    weight-product kernel reads whole 16-row fragments)."""
    extra = -t.shape[0] % 16
    return F.pad(t, (0, 0, 0, extra)) if extra else t


def launch_backward(x, g, wqkv, bqkv, wo, mask, n_heads: int, causal: int, seed: int,
                    thr: int, kp: float, form: str, parts: dict | None = None):
    """K11's backward on the forward's checked CUDA operands and ``g`` in
    their type; returns ``dx, dwqkv, dbqkv, dwo, dbo`` (the weight gradients
    float32). ``form``: the forward's :func:`~.attention.mha_form`; at the
    Hopper forms' width the QKV is recomputed by their own QKV launch.
    ``parts``, a dict, receives the recomputed QKV (``"qkv"``, ``[B*S,
    3D]``) and context (``"ctx"``, ``[B*S, D]``): a card test's view."""
    b, s, d = x.shape
    dev, dt = x.device, x.dtype
    rows = b * s
    is_f32 = int(dt == torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tile = _build.kernel_function("dsvg_mha_rows", [ctypes.c_int])(is_f32)
    # scratch (the recomputed QKV, dctx), the padded operands of the
    # weight products (dqkv, the recomputed context), dx and one row of
    # column sums per row tile of the first and of the third launch
    qkv = torch.empty((rows, 3 * d), dtype=dt, device=dev)
    qkv_given = form != "narrow"
    if qkv_given:
        launch_qkv(x, wqkv, bqkv, qkv)
    dctx = torch.empty((rows, d), dtype=dt, device=dev)
    dqkv = _padded_rows(rows, 3 * d, dt, dev)
    ctx_o = _padded_rows(rows, d, dt, dev)
    dx = torch.empty_like(x)
    small = torch.empty((2 * -(-rows // tile), 4 * d), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (x, g, wqkv, bqkv, wo, mask, qkv, dctx, dqkv, ctx_o, dx,
                                   small)]
    fn = _build.kernel_function("dsvg_mha_bwd", _BWD_ARGTYPES)
    rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, n_heads, causal, is_f32, seed, thr,
            kp, HEAD_DIM ** -0.5, int(qkv_given), stream)
    _build.check_launch(rc, "mha_bwd")
    # nn.Linear layout [out, in]: dWqkv = dqkv^T x, dWo = g^T ctx
    dwqkv, dwo = weight_products(
        ((dqkv, _pad_rows(x.view(rows, d))), (_pad_rows(g.view(rows, d)), ctx_o)),
        is_f32, stream)
    sums = reduce_partials(small)
    if parts is not None:
        parts.update(qkv=qkv, ctx=ctx_o[:rows])
    return dx, dwqkv, sums[:3 * d], dwo, sums[3 * d:]


class _FusedMHATrain(torch.autograd.Function):
    """K11 on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, mask, seed, n_heads, causal, rate):
        x = x.contiguous()
        mask = mask.to(torch.float32).contiguous()
        weights = [w.detach().contiguous() for w in (wqkv, bqkv, wo, bo)]
        form = check_mha_inputs(x, *weights, mask, n_heads)
        if x.shape[2] % 64:
            raise ValueError(f"the attention training kernel takes D a multiple of 64, "
                             f"got D={x.shape[2]}")
        thr = drop_threshold(rate) if rate > 0.0 else 0
        kp = keep_scale(rate) if rate > 0.0 else 1.0
        out = launch_forward(x, *weights, mask, n_heads, causal, seed, thr, kp)
        if x.shape[0] > 0:
            count_launch(fused_mha_train, form)
        ctx.save_for_backward(x, *weights[:3], mask)
        ctx.meta = (n_heads, int(causal), int(seed), thr, kp, form)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wo, mask = ctx.saved_tensors
        n_heads, causal, seed, thr, kp, form = ctx.meta
        dx, dwqkv, dbqkv, dwo, dbo = launch_backward(x, g.to(x.dtype).contiguous(), wqkv, bqkv,
                                                     wo, mask, n_heads, causal, seed, thr, kp,
                                                     form)
        fused_mha_train.backward_launches += 1
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwo.to(wo.dtype),
                dbo.to(wo.dtype), None, None, None, None, None)


def fused_mha_train(x, wqkv, bqkv, wo, bo, mask, seed: int, n_heads: int,
                    causal: bool = False, dropout_rate: float = 0.0):
    """The attention block, differentiable, with dropout ``dropout_rate`` on
    the probabilities; ``seed`` a host integer below 2**31. Operands as
    :func:`ops.attention.fused_mha`. Gradients flow to ``x`` and the four
    weights.

    A CPU tensor takes :func:`ops.attention.mha_reference` under autograd; a
    CUDA tensor runs K11 (operands all bfloat16 or all float32, head dim 32,
    D <= 256 a multiple of 64, 1 <= S <= 256; the Hopper forms at D=256) or
    raises.
    """
    if x.device.type == "cpu":
        return mha_reference(x, wqkv, bqkv, wo, bo, mask, n_heads, causal, dropout_rate, seed)
    if x.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {x.device}")
    return _FusedMHATrain.apply(x, wqkv, bqkv, wo, bo, mask, seed, n_heads, causal,
                                dropout_rate)


fused_mha_train.launches = 0            # forward calls (K10's launches with dropout)
fused_mha_train.float32_launches = 0    # those of the float32 form
fused_mha_train.narrow_launches = 0     # those of the first port's kernels (D < 256)
fused_mha_train.backward_launches = 0   # backward calls (the Hopper QKV launch at D=256,
                                        # three launches, wgrad, reductions)
