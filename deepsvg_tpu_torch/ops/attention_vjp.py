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

The backward at D=256 runs on the layer kernels' Hopper device code
(:func:`launch_backward`), in its steps:

1. The forward's own launches again, in save mode: QKV, the probabilities
   before dropout (float32 in both types: the softmax backward takes them
   unrounded, as the JAX rule does) and the context, equal to the bit to the
   forward's, into scratch tensors that live only inside the call (the op
   keeps nothing more between forward and backward than its inputs). In
   bfloat16, S <= 32 is one launch (``mha_short_kernel`` without its out
   projection), 33 <= S two: the QKV launch, which then takes the tiles of
   ``g`` and computes ``dctx = g Wo`` (wgmma, Wo read as it lies through the
   TMA ring), and the split-key attention launch. In float32 the QKV launch
   and K4's ``train_attn_kernel`` in save mode.
2. ``dctx = g Wo`` where step 1 did not compute it (bfloat16 S <= 32, and
   float32) on the row product of step 4, both operands by TMA.
3. K4's saved-mode attention backward on ``mma.sync`` (bfloat16:
   ``attn_bwd_tile`` for S <= 32, ``bwd_attn_long_kernel`` above, both
   reading the float32 probabilities; float32: ``bwd_attn_kernel``):
   ``dqkv`` from the saved probabilities, no ``dseq_bias``.
4. ``dx = dqkv Wqkv`` on the row product with both operands by TMA (K4's
   ``bwd_qkv_kernel`` without LN1's backward).
5. ``dWqkv = dqkv^T x`` and ``dWo = g^T ctx`` with their column sums
   ``dbqkv`` and ``dbo`` in one wgmma launch and its fixed-order reduction
   (``layer_vjp.weight_products_hopper``).

bfloat16: six launches; float32: seven. The tensor maps of these launches
are encoded once for each set of addresses and kept (``hopper.cuh:
make_tma_2d_cached``). Other widths keep the first port's backward
(``csrc/attention.cu``: QKV and ``dctx`` over row tiles, one block per
(sequence, head) recomputing the probabilities, ``dx`` over row tiles,
``csrc/wgrad.cu``'s products), counted under ``narrow_backward_launches``.
No atomics: reruns are bit-equal.

Roundings are the Pallas kernels': QKV, the dropped probabilities and the
context before their products; in the backward ``dctx``, ``ds`` and ``dq``,
``dk``, ``dv`` before theirs. ``dx`` comes back in ``x``'s type and the
weight gradients are summed in float32 and cast to the weights' type (``dbo``
to ``wo``'s), as the JAX rule casts them. :func:`mha_backward_reference`
computes the same backward in plain PyTorch, step by step.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .attention import check_mha_inputs, count_launch, launch_forward, mha_form, mha_reference
from .dropout import SITE_ATTN_PROB, drop_threshold, dropout_factor, keep_scale
from .layer import MAX_SEQ, _mm, head_dim, softmax_scale, tf32_copy
from .layer_vjp import _padded_rows, reduce_partials, weight_products, weight_products_hopper

_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_HOPPER_BWD_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def mha_backward_reference(x, g, wqkv, bqkv, wo, mask, n_heads: int, causal: bool = False,
                           rate: float = 0.0, seed: int = 0):
    """Plain version of K11's backward: the JAX ``_bwd_kernel``'s steps and
    roundings (``deepsvg_tpu/ops/attention_vjp.py``), with the port's hash
    masks at ``SITE_ATTN_PROB``. From ``x [B, S, D]``, the output's gradient
    ``g`` and the forward's operands (``nn.Linear`` layout): QKV recomputed
    and rounded, the probabilities ``p`` (a query with every key masked gets
    zeros), the dropped ``pe = p m`` and the context ``pe V`` rounded; ``dctx
    = g Wo``, ``dV = pe^T dctx``, ``dp = (dctx V^T) m``, ``ds = p (dp - sum_j
    dp p)``, ``dQ = ds K scale`` and ``dK = ds^T Q scale``, each rounded
    before its product (in bfloat16; float32 rounds nothing); ``dx = dqkv
    Wqkv`` in ``x``'s type. Returns ``dx, dwqkv, dbqkv, dwo, dbo``, the
    weight gradients float32 sums (``dWqkv = dqkv^T x``, ``dWo = g^T ctx``).
    Runs on the CPU as on the card."""
    b, s, d = x.shape
    dt = x.dtype
    hd = d // n_heads
    scale = hd ** -0.5
    rows = b * s
    xf, gf = x.reshape(rows, d), g.reshape(rows, d).to(dt)
    qkv = (_mm(xf, wqkv) + bqkv.float()).to(dt)

    def heads(t):   # [rows, D] -> [B, H, S, hd], float
        return t.reshape(b, s, n_heads, hd).transpose(1, 2).float()

    q, k, v = (heads(qkv[:, i * d:(i + 1) * d]) for i in range(3))
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale + mask.float()[:, None, None, :]
    if causal:
        upper = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(upper, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    keep = torch.ones((), device=x.device)
    if rate > 0.0:
        prow = torch.arange(b * n_heads * s, device=x.device).reshape(b, n_heads, s, 1)
        keep = dropout_factor(seed, SITE_ATTN_PROB, prow, torch.arange(s, device=x.device), rate)
    pe = (p * keep).to(dt).float()
    ctx = torch.matmul(pe, v).to(dt).transpose(1, 2).reshape(rows, d)
    dctx = heads(torch.matmul(gf.float(), wo.float()).to(dt))
    dv = torch.matmul(pe.transpose(-1, -2), dctx).to(dt)
    dp = torch.matmul(dctx, v.transpose(-1, -2)) * keep
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = (torch.matmul(ds, k) * scale).to(dt)
    dk = (torch.matmul(ds.transpose(-1, -2), q) * scale).to(dt)
    dqkv = torch.cat([t.transpose(1, 2).reshape(rows, d) for t in (dq, dk, dv)], dim=1)
    dx = torch.matmul(dqkv.float(), wqkv.float()).to(dt).reshape(b, s, d)
    dqkv32, g32 = dqkv.float(), gf.float()
    return (dx, dqkv32.t() @ xf.float(), dqkv32.sum(0), g32.t() @ ctx.float(), g32.sum(0))


def _pad_rows(t: torch.Tensor) -> torch.Tensor:
    """``t [rows, n]`` with zero rows appended up to a multiple of 16 (the
    weight-product kernel reads whole 16-row fragments)."""
    extra = -t.shape[0] % 16
    return F.pad(t, (0, 0, 0, extra)) if extra else t


def _narrow_backward(x, g, wqkv, bqkv, wo, mask, n_heads, causal, seed, thr, kp):
    """The first port's backward (``csrc/attention.cu``, the widths
    :func:`~.attention.mha_form` names ``"narrow"``): three launches,
    ``csrc/wgrad.cu``'s weight products and the reductions."""
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
    dctx = torch.empty((rows, d), dtype=dt, device=dev)
    dqkv = _padded_rows(rows, 3 * d, dt, dev)
    ctx_o = _padded_rows(rows, d, dt, dev)
    dx = torch.empty_like(x)
    small = torch.empty((2 * -(-rows // tile), 4 * d), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (x, g, wqkv, bqkv, wo, mask, qkv, dctx, dqkv, ctx_o, dx,
                                   small)]
    fn = _build.kernel_function("dsvg_mha_bwd", _BWD_ARGTYPES)
    rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, n_heads, causal, is_f32, seed, thr,
            kp, softmax_scale(d, n_heads), stream)
    _build.check_launch(rc, "mha_bwd")
    # nn.Linear layout [out, in]: dWqkv = dqkv^T x, dWo = g^T ctx
    dwqkv, dwo = weight_products(
        ((dqkv, _pad_rows(x.view(rows, d))), (_pad_rows(g.view(rows, d)), ctx_o)),
        is_f32, stream)
    sums = reduce_partials(small)
    return dx, dwqkv, sums[:3 * d], dwo, sums[3 * d:]


def launch_backward(x, g, wqkv, bqkv, wo, mask, n_heads: int, causal: int, seed: int,
                    thr: int, kp: float, form: str, parts: dict | None = None):
    """K11's backward on the forward's checked CUDA operands and ``g`` in
    their type; returns ``dx, dwqkv, dbqkv, dwo, dbo`` (the weight gradients
    float32). ``form``: the forward's :func:`~.attention.mha_form`; at the
    Hopper forms' width (see the module note) QKV, the probabilities and
    the context are the forward's own launches' in save mode, in tensors
    that live only inside this call. ``parts``, a dict, receives them
    (``"qkv"`` ``[B*S, 3D]`` row-major, ``"p"`` ``[B, H, S, S]`` before
    dropout in float32, ``"ctx"`` ``[B*S, D]``): a card test's view (when
    causal, ``"p"`` is the forward's only up to each row's own key)."""
    b, s, d = x.shape
    dev, dt = x.device, x.dtype
    rows = b * s
    if rows == 0:
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
        return torch.zeros_like(x), zeros(3 * d, d), zeros(3 * d), zeros(d, d), zeros(d)
    if form == "narrow":
        return _narrow_backward(x, g, wqkv, bqkv, wo, mask, n_heads, causal, seed, thr, kp)
    f32 = form == "f32"
    stream = torch.cuda.current_stream(dev).cuda_stream
    empty = lambda *shape: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    # QKV head-major (the float32 attention's and the bfloat16 long form's
    # layout) and row-major (the bfloat16 attention backward's; in float32
    # only for a caller's view)
    heads = empty(n_heads, rows, 3 * head_dim(d, n_heads)) if f32 or s > MAX_SEQ else None
    qkv = empty(rows, 3 * d) if not f32 or parts is not None else None
    # the probabilities in float32 in both types: the softmax backward takes
    # them unrounded, as the JAX rule does
    probs = torch.empty((b, n_heads, s, s), dtype=torch.float32, device=dev)
    ctx, dctx, dqkv, dx = empty(rows, d), empty(rows, d), empty(rows, 3 * d), torch.empty_like(x)
    if f32:
        # the TF32 products' operands: Wqkv as the forward reads it, and the
        # K-major B operands of dx = dqkv Wqkv and dctx = g Wo
        name, w = "dsvg_mha_bwd_f32", (tf32_copy(wqkv), tf32_copy(wqkv.t()), bqkv,
                                       tf32_copy(wo.t()))
    else:
        name, w = "dsvg_mha_bwd_bf16", (wqkv, None, bqkv, wo)
    fn = _build.kernel_function(name, _HOPPER_BWD_ARGTYPES)
    ptrs = [None if t is None else t.data_ptr()
            for t in (x, g, *w, mask, heads, qkv, probs, ctx, dctx, dqkv, dx)]
    _build.check_launch(fn(*ptrs, b, s, causal, seed, thr, kp, softmax_scale(d, n_heads),
                           stream), name)
    # nn.Linear layout [out, in]: dWqkv = dqkv^T x, dWo = g^T ctx, and the
    # column sums of dqkv and g
    (dwqkv, dwo), (dbqkv, dbo) = weight_products_hopper(
        ((dqkv, x.view(rows, d)), (g.view(rows, d), ctx)), rows, stream)
    if parts is not None:
        parts.update(qkv=qkv, p=probs, ctx=ctx)
    return dx, dwqkv, dbqkv, dwo, dbo


class _FusedMHATrain(torch.autograd.Function):
    """K11 on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, mask, seed, n_heads, causal, rate):
        x = x.contiguous()
        mask = mask.to(torch.float32).contiguous()
        weights = [w.detach().contiguous() for w in (wqkv, bqkv, wo, bo)]
        check_mha_inputs(x, *weights, mask, n_heads)
        form = mha_train_form(x.dtype, x.shape[2], n_heads, x.shape[1])
        thr = drop_threshold(rate) if rate > 0.0 else 0
        kp = keep_scale(rate) if rate > 0.0 else 1.0
        out = launch_forward(x, *weights, mask, n_heads, causal, seed, thr, kp)
        if x.shape[0] > 0:
            count_launch(fused_mha_train, form, x.dtype)
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
        if x.shape[0] > 0:
            fused_mha_train.backward_launches += 1
            fused_mha_train.float32_backward_launches += form == "f32"
            fused_mha_train.narrow_backward_launches += form == "narrow"
            fused_mha_train.narrow_float32_backward_launches += (
                form == "narrow" and x.dtype == torch.float32)
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwo.to(wo.dtype),
                dbo.to(wo.dtype), None, None, None, None, None)


def mha_train_form(dtype, d: int, n_heads: int, s: int) -> str:
    """The kernels K11 runs on, forward and backward: those
    :func:`~.attention.mha_form` names, where D is a multiple of 32 (the
    older weight products' warp tiles, ``csrc/wgrad.cu``); raises
    otherwise."""
    form = mha_form(dtype, d, n_heads, s)
    if d % 32:
        raise ValueError(f"the attention training kernel takes D a multiple of 32, got D={d}")
    return form


def fused_mha_train(x, wqkv, bqkv, wo, bo, mask, seed: int, n_heads: int,
                    causal: bool = False, dropout_rate: float = 0.0):
    """The attention block, differentiable, with dropout ``dropout_rate`` on
    the probabilities; ``seed`` a host integer below 2**31. Operands as
    :func:`ops.attention.fused_mha`. Gradients flow to ``x`` and the four
    weights.

    A CPU tensor takes :func:`ops.attention.mha_reference` under autograd; a
    CUDA tensor runs K11 (operands all bfloat16 or all float32, head dim 32,
    16 or 8, D <= 256 a multiple of 32, 1 <= S <= 256; the Hopper forms at
    D=256 with 8 heads; :func:`mha_train_form` names them) or raises.

    The backward at D=256 keeps, for the length of its call, the
    probabilities in float32: a scratch of B * H * S^2 * 4 bytes (112 MB at
    60 x 242, about 2 GB at B=1,024, S=256), where a library's attention
    backward keeps only per-row statistics.
    """
    if x.device.type == "cpu":
        return mha_reference(x, wqkv, bqkv, wo, bo, mask, n_heads, causal, dropout_rate, seed)
    if x.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {x.device}")
    return _FusedMHATrain.apply(x, wqkv, bqkv, wo, bo, mask, seed, n_heads, causal,
                                dropout_rate)


fused_mha_train.launches = 0            # forward calls (K10's launches with dropout)
fused_mha_train.float32_launches = 0    # those of the float32 form
fused_mha_train.narrow_launches = 0     # those of the first port's kernels (other widths)
fused_mha_train.backward_launches = 0   # backward calls (at D=256: 6 launches in
                                        # bfloat16, 7 in float32)
fused_mha_train.float32_backward_launches = 0   # those of the float32 form
fused_mha_train.narrow_backward_launches = 0    # those of the first port's kernels
fused_mha_train.narrow_float32_launches = 0     # of the narrow ones, the float32 ones
fused_mha_train.narrow_float32_backward_launches = 0
