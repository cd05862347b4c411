"""Differentiable fused transformer layer: kernel K4 and its plain version.

The training form of the fused layer (``ops/layer.py``): the same forward
with dropout at four sites (attention probabilities, attention output, FF
hidden, FF output), and a hand-written backward. The per-sequence injection
``seq_bias [B, D]`` (the decoder's latent, with its own dropout applied
outside) gets the residual gradient summed over the sequence.

Kernel note (``csrc/layer.cu``, ``csrc/layer_bwd.cu``, ``csrc/wgrad.cu``).
Replaces the Pallas kernels ``deepsvg_tpu/ops/layer_vjp.py:_fwd_kernel`` and
``_bwd_kernel`` / ``_bwd_kernel_saved`` (wrapper ``fused_layer_train``), in
both of their modes. On the H100 the layer is bound by its matmuls: forward
and backward of an E1 layer at B=128 (1,024 sequences of 32) are about 35 +
106 GFLOP, 0.14 ms at 989 TFLOP/s bf16, against 0.02 ms for the bytes of x,
out, g, dx, the weights and their gradients.

Two designs. bfloat16 at the flagship's widths (D = 256, 8 heads, F a
multiple of 256 up to 1024, S <= 32; F a multiple of 256 because its weight
products take N multiples of 256) runs the Hopper form of
``csrc/layer_train.cuh``: K2's persistent ``wgmma`` blocks (a TMA producer
warp streaming the weights through an ``mbarrier`` ring to two consumer
warpgroups on 128-row tiles), so the weights come from L2 once per 128 rows;
its forward in both modes, and the saved mode's backward as three row-local
launches (FF, LN2 and out projection; attention on ``mma.sync``; QKV and
LN1) and a ``wgmma`` launch for the weight products and bias gradients.
float32 (S <= 16) at the same widths runs the long form's TF32 ``wgmma``
launches (``csrc/layer_f32.cu``, ``csrc/layer_f32_bwd.cu``; see *Long form*
below) in both modes, counted under the short form's counters and apart
under ``fused_layer_train.float32_launches`` / ``.float32_backward_launches``
(their times at E2 above the stack gate, B=128, against the older form's:
PERF.md §6). Narrower bfloat16 widths (counted apart:
``fused_layer_train.narrow_launches``, ``.narrow_backward_launches``),
float32 at other widths and the bfloat16 recompute mode's backward run the
older ``wmma`` form below
(``csrc/layer_fwd.cuh``, ``csrc/layer_bwd.cuh``), which K7 shares.

- *Modes.* ``save_residuals=True`` (the saved mode, what the model runs by
  default through :data:`SAVE_RESIDUALS_DEFAULT`): the forward saves to
  device memory what the backward would otherwise recompute: QKV, the
  probabilities before dropout, the context, the residual after the
  attention block (float32) and the FF hidden before dropout, about 5,000
  bytes a row in bfloat16 at the flagship's widths. ``save_residuals=False``
  (the recompute mode, the op's default as in the JAX package): the forward
  writes ``out`` alone, to the bit the saved mode's (both run the same
  kernel), and keeps nothing but its inputs; the backward first runs the
  older form's forward tile again into a workspace of this layer alone
  (QKV, the context, x1 and the FF hidden in float32; no probabilities),
  freed when the backward returns, and recomputes each (sequence, head)'s
  probabilities in float32 from Q and K. In bfloat16 that tile sums in
  another order than the ``wgmma`` forward, so what it recomputes differs
  from that forward's intermediates in their last bits.
  The probabilities enter the softmax backward, and the hidden the ReLU gate
  and the dropped hidden, in float32, as in the Pallas recompute backward;
  the saved mode reads both rounded to the activation type, so in bfloat16
  the two modes' gradients differ by that rounding.
- *Dropout masks* are a hash of (seed, site, row, column), see
  ``ops/dropout.py``: regenerated in the backward, independent of tiling,
  identical in the plain version.
- *Backward.* The row-local launches (``layer_bwd.cu``: one in the
  ``wmma`` form, three in the Hopper form) do everything local to a row or a
  sequence and need no reduction across blocks. The weight gradients are
  sums over every row of the batch, which the Pallas kernel accumulated over
  its sequential grid; CUDA blocks run concurrently, so the row-local
  launches write the rounded operands of the four products and per-block
  column sums, a ``wgrad.cu`` launch multiplies them split over the rows
  into per-split partial sums (in the Hopper form with the bias gradients,
  the column sums of the output-side operands), and a reduction adds the
  partial sums in a fixed order. There are no atomics anywhere in K4: the
  gradients are bit-identical from run to run.
- Roundings follow the Pallas body: residual stream, LayerNorm and softmax in
  float32; every product takes activation-type operands with float32
  accumulation; ``df``, ``dhpre``, ``da``, ``dctx``, ``ds`` and ``dqkv`` are
  rounded to the activation type before their products. The plain version
  differentiates its forward with autograd and so does not round those
  gradients: in float32 there is nothing to round, in bfloat16 the two differ
  by that rounding (the tolerances in ``chip_smoke.py`` say how much).

Long form: sequences that a block cannot hold whole, bfloat16 with 33 <= S
<= 256 and float32 with 17 <= S <= 256 (the short form's float32 backward
tiles hold 16 rows). Sketchformer trains its encoder at S = 242 and its
causal teacher-forced decoder at S = 241; a float32 model (the configs'
default type) trains its E1 and D1 at S = 32 and 31 in this form. At B=60
a Sketchformer layer's products are 2 x 14,520 x 786,432 = 22.8 GFLOP
forward and twice that backward, its attention 4 x 60 x 242^2 x 256 = 3.6
GFLOP forward. At the flagship's widths (D = 256, 8 heads; F a multiple of
256 up to 1024) it runs Hopper kernels:

- *Forward*, the long K2's launches with the training switch (dropout at
  the four sites, x1 through its tensor, the saves): bfloat16 the three
  launches of ``csrc/layer_long.cu`` (``layer_infer.cuh``,
  ``layer_train.cuh``: QKV on ``wgmma``; the attention, a tile of whole
  sequences and one head a block, so that B=60's 60 sequences fill the
  card; the out projection and the FF on ``wgmma`` over 128-row tiles),
  float32 the three TF32 launches of ``csrc/layer_f32.cu``; QKV and the
  context pass through device memory. The
  saved mode keeps QKV, the probabilities ``[B, H, S, S]`` before dropout,
  the context, x1 and the FF hidden before dropout; the recompute mode
  keeps its inputs.
- *Backward* (saved mode), split where a row needs other rows: the FF, LN2
  and out-projection backward on 128-row tiles of all rows; the attention
  backward, a tile of whole sequences and one head a block (each warp's 16
  query rows: dsum = sum_j dp p, then dS and dQ = dS K; then its 16 key rows:
  dK = dS^T Q and dV = Pe^T dctx in registers over the query steps in
  order), which also sums dx1 over each sequence (dseq_bias); the QKV and
  LN1 backward on 128-row tiles; then the weight products with the bias
  gradients and the fixed-order reductions. bfloat16: the short form's
  row launches (``csrc/layer_bwd.cu``, ``layer_train.cuh``) and
  ``wgrad_hopper_kernel``, the attention on ``mma.sync`` m16n8k16; float32:
  ``csrc/layer_f32_bwd.cu``, TF32 ``wgmma`` with the weights transposed by
  the wrapper and the weight products' row tiles transposed into shared
  memory, the attention on ``mma.sync`` m16n8k8. No atomics.
- *Recompute mode's backward*: the same forward again, in the saved mode,
  into this layer's workspace (freed on return), then the saved backward:
  both modes' gradients come from the same intermediates.

Other widths run the older ``wmma`` kernels of ``csrc/layer_long_train.cu``
(the long K2's ``layer_long.cuh`` with the training switch, a backward of
three launches and ``wgrad.cu``'s), counted apart
(``fused_layer_train_long.narrow_launches``, ``.narrow_backward_launches``).

Weights come in as the float32 master parameters and are cast to
``weight_dtype`` at use (then to the activation type: float32 activations
take the bfloat16-rounded values as float32, and multiply in TF32). The
gradients of the weights are returned in float32, straight to the masters.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .dropout import (
    SITE_ATTN_OUT, SITE_ATTN_PROB, SITE_FF_HIDDEN, SITE_FF_OUT, drop_threshold,
    dropout_factor, keep_scale)
from .layer import (
    HEAD_DIM, MAX_SEQ, MAX_SEQ_LONG, _layer_norm_f32, _mm, check_layer_inputs, to_tf32)

# The mode the model's layers train in (``models/layers.py``), as the JAX
# package's switch of the same name: True saves the forward's intermediates
# for the backward, False recomputes them there. Module-level, so that a
# caller or a test can switch every layer of a step at once.
SAVE_RESIDUALS_DEFAULT = True


class _RoundGrad(torch.autograd.Function):
    """The identity; its backward rounds the gradient to ``dtype`` (as the
    kernels round a gradient before the products that read it)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def layer_train_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                          mask, seed: int, n_heads: int, causal: bool = False,
                          rate: float = 0.0, relu_gate=None, round_grads: bool = False):
    """Plain version of the K4 forward (differentiable; the weights as they
    are used, already cast). With ``rate`` 0 it is ``layer_reference``.

    ``relu_gate [B, S, F]`` (bool), a diagnostic: the FF units that pass,
    in place of this version's own ``pre-activation > 0``. Two versions whose
    forward passes differ in their last bits disagree on a few units next to
    zero; with the other version's gate the comparison of their gradients
    reads the roundings alone. ``round_grads``, a diagnostic too: the
    backward rounds ``df``, ``dhpre``, ``da`` and ``ds`` to the activation
    type before the products that read them (not before the bias sums), as
    the kernels do (this version's other gradients reach the products
    already in the activation type); with ``relu_gate`` the two versions
    then round at the same points and differ by their summation orders,
    whose last bits each rounding may carry on."""
    b, s, d = x.shape
    f = w1.shape[0]
    dt = x.dtype
    rg = ((lambda t: _RoundGrad.apply(t, dt)) if round_grads and dt != torch.float32
          else (lambda t: t))
    hd = d // n_heads
    dev = x.device
    drop = rate > 0.0
    if drop:
        rows = torch.arange(b * s, device=dev).reshape(b, s, 1)
        prob_rows = torch.arange(b * n_heads * s, device=dev).reshape(b, n_heads, s, 1)
        factor = lambda site, n: dropout_factor(  # noqa: E731
            seed, site, rows, torch.arange(n, device=dev), rate)
    xf = x.float()
    xn = _layer_norm_f32(xf, ln1).to(dt)
    qkv = (_mm(xn, wqkv) + bqkv.float()).to(dt)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, s, n_heads, hd).transpose(1, 2)
               for i in range(3))
    scores = rg(torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5))
    scores = scores + mask.float()[:, None, None, :]
    if causal:
        upper = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
        scores = scores.masked_fill(upper, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if drop:
        p = p * dropout_factor(seed, SITE_ATTN_PROB, prob_rows,
                               torch.arange(s, device=dev), rate)
    ctx = torch.matmul(p.to(dt).float(), v.float()).to(dt)
    ctx = ctx.transpose(1, 2).reshape(b, s, d)
    a = rg(_mm(ctx, wo)) + bo.float()
    if drop:
        a = a * factor(SITE_ATTN_OUT, d)
    xf = xf + a
    if seq_bias is not None:
        xf = xf + seq_bias.float()[:, None, :]
    xn2 = _layer_norm_f32(xf, ln2).to(dt)
    h = rg(_mm(xn2, w1)) + b1.float()
    h = torch.relu(h) if relu_gate is None else h * relu_gate
    if drop:
        h = h * factor(SITE_FF_HIDDEN, f)
    ff = rg(_mm(h.to(dt), w2)) + b2.float()
    if drop:
        ff = ff * factor(SITE_FF_OUT, d)
    return (xf + ff).to(dt)


_FWD_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 9
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_LONG_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_WGRAD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
_REDUCE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p]
_WGRAD_HOPPER_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] * 2
                          + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int] * 4
                          + [ctypes.c_void_p] * 2)
_F32_FWD_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_BF16_LONG_ARGTYPES = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_LONG_HOPPER_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 6
                             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
F32_MAX_SEQ = 16
WGRAD_ROWS_PER_SPLIT = 1024
WGRAD_MAX_SPLITS = 16


def _hopper_form(x, n_heads: int, f: int) -> bool:
    """Whether K4's bfloat16 short form runs its wgmma kernels
    (``csrc/layer_train.cuh``) on ``x`` with these widths, by the rule the C
    entry points dispatch by; other bfloat16 widths run the older wmma
    kernels, counted apart."""
    b, s, d = x.shape
    rule = _build.kernel_function("dsvg_layer_train_hopper", [ctypes.c_int] * 4)
    return x.dtype == torch.bfloat16 and s <= MAX_SEQ and bool(rule(d, f, n_heads, s))


def _long_hopper_form(x, n_heads: int, f: int) -> bool:
    """Whether K4's long form runs its Hopper kernels on ``x``, by the rule
    the C entry points take: D = 256 with 8 heads and F a multiple of 256
    up to 1024 (bfloat16: ``csrc/layer_long.cu``'s training launches;
    float32: ``csrc/layer_f32.cu``'s and ``csrc/layer_f32_bwd.cu``), whose
    weight products take 128 x 256 tiles. Other widths run the older wmma
    kernels, counted apart."""
    b, s, d = x.shape
    rule = _build.kernel_function("dsvg_layer_long_train_hopper", [ctypes.c_int] * 4)
    return bool(rule(d, f, n_heads, s))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded_rows(rows: int, width: int, dtype, dev) -> torch.Tensor:
    """``[round16(rows), width]`` with the rows beyond ``rows`` zero: the
    weight-gradient kernel reads whole 16-row fragments."""
    t = torch.empty((_round_up(rows, 16), width), dtype=dtype, device=dev)
    if t.shape[0] > rows:
        t[rows:].zero_()
    return t


def reduce_partials(part: torch.Tensor) -> torch.Tensor:
    """``part [slices, n]`` float32 -> ``[n]``, the slices added in order by
    the hand-written reduction kernel."""
    slices, n = part.shape
    out = torch.empty(n, dtype=torch.float32, device=part.device)
    fn = _build.kernel_function("dsvg_reduce_partials", _REDUCE_ARGTYPES)
    _build.check_launch(fn(part.data_ptr(), out.data_ptr(), n, slices,
                           torch.cuda.current_stream(part.device).cuda_stream),
                        "reduce_partials")
    return out


def _used_weights(x, weights, weight_dtype):
    """The master weights as a kernel reads them: cast to ``weight_dtype``,
    then held in the activations' type, contiguous."""
    return [w.detach().to(weight_dtype).to(x.dtype).contiguous() for w in weights]


def _check_train_inputs(x, seq_bias, used, mask, n_heads, max_seq):
    bias = None if seq_bias is None else seq_bias.detach().to(x.dtype).contiguous()
    mask = mask.to(torch.float32).contiguous()
    check_layer_inputs(x, bias, *used, mask, n_heads, max_seq)
    d, f = x.shape[2], used[6].shape[0]
    if d % 64 or f % 64 or d > 256:
        raise ValueError(f"the training layer kernel takes D, F multiples of 64 and "
                         f"D <= 256; got D={d}, F={f}")
    return bias, mask


def _workspace(x, f):
    """The recompute backward's workspace, one layer's: QKV, the context
    (16-row padded, for ``wgrad``), the float32 residual after the attention
    block and the float32 FF hidden before dropout."""
    b, s, d = x.shape
    dev, dt = x.device, x.dtype
    rows = b * s
    return (torch.empty((rows, 3 * d), dtype=dt, device=dev), _padded_rows(rows, d, dt, dev),
            torch.empty((rows, d), dtype=torch.float32, device=dev),
            torch.empty((rows, f), dtype=torch.float32, device=dev))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _saved_tensors(x, n_heads, f, zero_probs):
    """What the forward keeps for the backward: QKV, the probabilities before
    dropout, the context (16-row padded, for ``wgrad``), the float32
    residual after the attention block and the FF hidden before dropout.
    ``zero_probs`` (the wgmma form, causal): the probabilities start zero;
    that forward writes each row's keys up to the last row its warp attends
    from, and its backward reads every key of the sequence."""
    b, s, d = x.shape
    dev, dt = x.device, x.dtype
    rows = b * s
    probs = torch.zeros if zero_probs else torch.empty
    return (torch.empty((rows, 3 * d), dtype=dt, device=dev),
            probs((b, n_heads, s, s), dtype=dt, device=dev),
            _padded_rows(rows, d, dt, dev),
            torch.empty((rows, d), dtype=torch.float32, device=dev),
            torch.empty((rows, f), dtype=dt, device=dev))


def _backward_outputs(x, f, small_rows, small_width):
    """The first backward launches' outputs: dx, dseq_bias, the rounded
    operands of the four weight products (16-row padded) and the per-block
    column sums ``[small_rows, small_width]``."""
    b, s, d = x.shape
    dev, dt = x.device, x.dtype
    rows = b * s
    xn1_o, da_o, xn2_o, df_o = (_padded_rows(rows, d, dt, dev) for _ in range(4))
    dqkv_o = _padded_rows(rows, 3 * d, dt, dev)
    dhpre_o, hd_o = (_padded_rows(rows, f, dt, dev) for _ in range(2))
    return (torch.empty_like(x), torch.empty((b, d), dtype=torch.float32, device=dev),
            xn1_o, dqkv_o, da_o, xn2_o, dhpre_o, hd_o, df_o,
            torch.empty((small_rows, small_width), dtype=torch.float32, device=dev))


def weight_products(problems, is_f32, stream):
    """``A^T @ B`` in float32 for each ``(A [rows_pad, M], B [rows_pad, N])``
    of ``problems`` (rows beyond the batch zero, ``rows_pad`` a multiple of
    16, M and N multiples of 64): one ``wgrad`` launch split over the rows
    into partial sums, and their fixed-order reduction. Returns the
    ``[M, N]`` products in order."""
    dev = problems[0][0].device
    rows_pad = problems[0][0].shape[0]
    splits = max(1, min(WGRAD_MAX_SPLITS, rows_pad // WGRAD_ROWS_PER_SPLIT))
    per_split = _round_up(-(-rows_pad // splits), 16)
    sizes = [a.shape[1] * bb.shape[1] for a, bb in problems]
    part = torch.empty((splits, sum(sizes)), dtype=torch.float32, device=dev)
    arr = lambda ctype, vals: (ctype * len(vals))(*vals)  # noqa: E731
    fn = _build.kernel_function("dsvg_wgrad", _WGRAD_ARGTYPES)
    _build.check_launch(
        fn(arr(ctypes.c_void_p, [a.data_ptr() for a, _ in problems]),
           arr(ctypes.c_void_p, [bb.data_ptr() for _, bb in problems]),
           arr(ctypes.c_int, [a.shape[1] for a, _ in problems]),
           arr(ctypes.c_int, [bb.shape[1] for _, bb in problems]),
           len(problems), rows_pad, per_split, splits, is_f32, part.data_ptr(), stream),
        "wgrad")
    dws = reduce_partials(part).split(sizes)
    return [w.view(a.shape[1], bb.shape[1]) for w, (a, bb) in zip(dws, problems)]


def weight_products_hopper(problems, rows: int, stream):
    """``A^T @ B`` and the column sums of ``A`` in float32 for each
    ``(A [>= rows, M], B [>= rows, N])`` of ``problems`` (M a multiple of 128,
    N of 256), bfloat16 (``dsvg_wgrad_hopper``) or float32 with TF32
    products (``dsvg_wgrad_tf32``, which transposes the row tiles into
    shared memory): one wgmma launch split over the rows into partial sums,
    and their fixed-order reduction. Returns the ``[M, N]`` products and the
    ``[M]`` sums, in order."""
    dev = problems[0][0].device
    f32 = problems[0][0].dtype == torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = sum((a.shape[1] // 128) * (bb.shape[1] // 256) for a, bb in problems)
    # about one work item (a tile of a product, a split of the rows) per SM;
    # a split is whole row steps of the kernel (32 float32 rows, 64 bfloat16)
    per_split = _round_up(-(-rows // max(1, sms // tiles)), 32 if f32 else 64)
    splits = -(-rows // per_split)
    sizes = [a.shape[1] * bb.shape[1] for a, bb in problems]
    sums = [a.shape[1] for a, _ in problems]
    part = torch.empty((splits, sum(sizes) + sum(sums)), dtype=torch.float32, device=dev)
    arr = lambda ctype, vals: (ctype * len(vals))(*vals)  # noqa: E731
    name = "dsvg_wgrad_tf32" if f32 else "dsvg_wgrad_hopper"
    fn = _build.kernel_function(name, _WGRAD_HOPPER_ARGTYPES)
    _build.check_launch(
        fn(arr(ctypes.c_void_p, [a.data_ptr() for a, _ in problems]),
           arr(ctypes.c_void_p, [bb.data_ptr() for _, bb in problems]),
           arr(ctypes.c_int, [a.shape[1] for a, _ in problems]),
           arr(ctypes.c_int, [bb.shape[1] for _, bb in problems]),
           len(problems), rows, per_split, splits, part.data_ptr(), stream),
        name)
    out = reduce_partials(part).split(sizes + sums)
    dws = [w.view(a.shape[1], bb.shape[1]) for w, (a, bb) in zip(out, problems)]
    return dws, list(out[len(problems):])


def _long_launch(x, bias, used, mask, seed, n_heads, causal, thr, kp, save):
    """K4's long form on its Hopper kernels, forward, on ``x`` with the
    weights ``used`` as the kernels read them (float32: rounded to TF32):
    ``(out, saved)``. In the saved mode (``save``) ``saved`` is what the
    backward reads: QKV, the probabilities before dropout, the context, x1
    and the FF hidden before dropout (float32: QKV head-major, as its
    attention reads it; bfloat16: the layout of the old long backward, QKV
    row-major and the context 16-row padded); else it is empty, and the
    tensors between the launches are freed on return."""
    b, s, d = x.shape
    dev, dt = x.device, x.dtype
    rows, f = b * s, used[6].shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(x)
    x1 = torch.empty((rows, d), dtype=torch.float32, device=dev)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    if dt == torch.float32:
        saved = (f32(n_heads, rows, 3 * HEAD_DIM), f32(b, n_heads, s, s) if save else None,
                 f32(rows, d), x1, f32(rows, f) if save else None)
        name, args = "dsvg_layer_f32_train", saved
        argtypes = _F32_FWD_ARGTYPES
    else:
        saved = (_saved_tensors(x, n_heads, f, False) if save
                 else (None, None, torch.empty((rows, d), dtype=dt, device=dev), x1, None))
        # the QKV of all rows between the two launches, head-major
        name, args = "dsvg_layer_long_train_bf16", (torch.empty((rows, 3 * d), dtype=dt,
                                                                device=dev), *saved)
        argtypes = _BF16_LONG_ARGTYPES
    if b > 0:
        fn = _build.kernel_function(name, argtypes)
        _build.check_launch(
            fn(x.data_ptr(), _ptr(bias), *[w.data_ptr() for w in used], mask.data_ptr(),
               out.data_ptr(), *[_ptr(t) for t in args], b, s, f, int(causal), int(seed), thr,
               kp, HEAD_DIM ** -0.5, stream), name)
    return out, (saved if save else ())


def _long_backward(x, g, used, saved, meta):
    """K4's long form on its Hopper kernels, saved-mode backward: three row
    launches (float32: ``csrc/layer_f32_bwd.cu``; bfloat16: the short form's
    ``csrc/layer_bwd.cu`` launches on 128-row tiles of all rows, with its
    attention backward for long sequences), the weight products (float32:
    ``dsvg_wgrad_tf32``; bfloat16: ``dsvg_wgrad_hopper``) and the fixed-order
    reductions. Returns dx, dseq_bias and the ten weight gradients."""
    seed, thr, kp, causal = meta
    ln1, wqkv, _, wo, _, ln2, w1, _, w2, _ = used
    qkv_s, p_s, ctx_s, x1_s, h_s = saved
    b, s, d = x.shape
    f = w1.shape[0]
    rows, dev, dt = b * s, x.device, x.dtype
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    if dt == torch.float32:
        grid = _build.kernel_function("dsvg_layer_f32_bwd_grid", [ctypes.c_int] * 2)(b, s)
        # the weights as the TF32 products read them, K-major: transposed
        trans = [w.t().contiguous() for w in (wqkv, wo, w1, w2)]
        dx, dbias = torch.empty_like(x), f32(b, d)
        xn1, dqkv, da, xn2 = f32(rows, d), f32(rows, 3 * d), f32(rows, d), f32(rows, d)
        # the LayerNorm partial sums: a row a warp of the row launches' blocks,
        # then a row a block, the rows the reduction adds
        dhpre, hd, df, small = f32(rows, f), f32(rows, f), f32(rows, d), f32(grid * 9, 4 * d)
        sums = small[grid * 8:]
        tensors = (x, g, ln1, ln2, qkv_s, p_s, x1_s, h_s, *trans, dx, dbias, xn1, dqkv, da, xn2,
                   dhpre, hd, df, small, f32(rows, d), f32(rows, d), f32(rows, d))
        name = "dsvg_layer_f32_train_bwd"
    else:
        grid = _build.kernel_function("dsvg_layer_long_train_bwd_grid", [ctypes.c_int] * 2)(b, s)
        outs = _backward_outputs(x, f, grid, 4 * d)
        dx, dbias, xn1, dqkv, da, xn2, dhpre, hd, df, sums = outs
        tensors = (x, g, ln1, wqkv, wo, ln2, w1, w2, qkv_s, p_s, ctx_s, x1_s, h_s, *outs,
                   f32(rows, d), torch.empty((rows, d), dtype=dt, device=dev), f32(rows, d))
        name = "dsvg_layer_long_train_bwd_bf16"
    ptrs = [t.data_ptr() for t in tensors]
    fn = _build.kernel_function(name, _LONG_HOPPER_BWD_ARGTYPES)
    _build.check_launch(fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, f, causal, seed, thr, kp,
                           HEAD_DIM ** -0.5, stream), name)
    (dwqkv, dwo, dw1, dw2), (dbqkv, dbo, db1, db2) = weight_products_hopper(
        ((dqkv, xn1), (da, ctx_s), (dhpre, xn2), (df, hd)), rows, stream)
    dln1, dln2 = reduce_partials(sums).split([2 * d, 2 * d])
    return dx, dbias, (dln1.view(2, d), dwqkv, dbqkv, dwo, dbo, dln2.view(2, d), dw1, db1,
                       dw2, db2)


def _weight_grads_hopper(ctx_s, outs, d, rows, stream):
    """The wgmma form's launches after its row-local backward: the four
    weight products with the bias gradients, and the LayerNorm gradients'
    per-block partial sums reduced. Returns the ten weight gradients in the
    fused layer's argument order."""
    _, _, xn1_o, dqkv_o, da_o, xn2_o, dhpre_o, hd_o, df_o, small_part = outs
    (dwqkv, dwo, dw1, dw2), (dbqkv, dbo, db1, db2) = weight_products_hopper(
        ((dqkv_o, xn1_o), (da_o, ctx_s), (dhpre_o, xn2_o), (df_o, hd_o)), rows, stream)
    dln1, dln2 = reduce_partials(small_part).split([2 * d, 2 * d])
    return dln1.view(2, d), dwqkv, dbqkv, dwo, dbo, dln2.view(2, d), dw1, db1, dw2, db2


def _weight_grads(ctx_s, outs, d, f, is_f32, stream):
    """The launches after the row-local backward: ``wgrad`` (the four weight
    products split over the rows) and the fixed-order reductions of its
    partial sums and of the column sums. Returns the ten weight gradients in
    the fused layer's argument order."""
    _, _, xn1_o, dqkv_o, da_o, xn2_o, dhpre_o, hd_o, df_o, small_part = outs
    # dW = (output-side gradient)^T @ (input), nn.Linear layout [out, in]
    dwqkv, dwo, dw1, dw2 = weight_products(
        ((dqkv_o, xn1_o), (da_o, ctx_s), (dhpre_o, xn2_o), (df_o, hd_o)), is_f32, stream)
    small = reduce_partials(small_part)
    dln1, dbqkv, dbo, dln2, db1, db2 = small.split([2 * d, 3 * d, d, 2 * d, f, d])
    return dln1.view(2, d), dwqkv, dbqkv, dwo, dbo, dln2.view(2, d), dw1, db1, dw2, db2


class _FusedLayerTrain(torch.autograd.Function):
    """K4 on CUDA tensors: the short form (a block holds whole sequences) or,
    with ``long_form``, the long form (see the module note); in the saved
    mode (``save``) or the recompute mode."""

    @staticmethod
    def forward(ctx, x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                seed, n_heads, causal, rate, weight_dtype, long_form, save):
        dev, dt = x.device, x.dtype
        x = x.contiguous()
        used = _used_weights(x, (ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2), weight_dtype)
        bias, mask = _check_train_inputs(x, seq_bias, used, mask, n_heads,
                                         MAX_SEQ_LONG if long_form else MAX_SEQ)
        b, s, d = x.shape
        f = used[6].shape[0]
        if not long_form and dt == torch.float32 and s > F32_MAX_SEQ:
            raise ValueError(f"the short float32 training layer kernel takes S <= "
                             f"{F32_MAX_SEQ} (its backward tiles hold {F32_MAX_SEQ} rows), "
                             f"got S={s}")
        hopper = not long_form and _hopper_form(x, n_heads, f)
        thr = drop_threshold(rate) if rate > 0.0 else 0
        kp = keep_scale(rate) if rate > 0.0 else 1.0
        ctx.save_residuals = save
        ctx.meta = (n_heads, int(seed), thr, kp, int(causal), long_form, hopper,
                    seq_bias is not None, None if seq_bias is None else seq_bias.dtype)
        # the Hopper launches of the long form: the long form at its widths,
        # and the float32 short form (S <= 16) at the same, in both modes
        ctx.long_hopper = ((long_form or dt == torch.float32)
                           and _long_hopper_form(x, n_heads, f))
        if ctx.long_hopper:
            if dt == torch.float32:
                # the weights as the TF32 products read them
                used = [to_tf32(w) if i in (1, 3, 6, 8) else w for i, w in enumerate(used)]
            out, saved = _long_launch(x, bias, used, mask, seed, n_heads, causal, thr, kp, save)
            counter = fused_layer_train_long if long_form else fused_layer_train
            if b > 0 and save:
                counter.launches += 1
                counter.float32_launches += dt == torch.float32
            elif b > 0:
                counter.recompute_launches += 1
            ctx.save_for_backward(x, *used, mask, bias, *saved)
            return out
        out = torch.empty_like(x)
        if save:
            saved = _saved_tensors(x, n_heads, f, causal and hopper)
            ptrs = [t.data_ptr() for t in saved]
        else:
            # only the long form's QKV, passed between its two launches, or
            # the wgmma form's x1; freed on return
            saved = ()
            qkv = (torch.empty((b * s, 3 * d), dtype=dt, device=dev) if long_form else None)
            x1 = (torch.empty((b * s, d), dtype=torch.float32, device=dev) if hopper else None)
            ptrs = [_ptr(qkv), None, None, _ptr(x1), None]
        counter = fused_layer_train_long if long_form else fused_layer_train
        if b > 0:
            name = ("layer_long_train_fwd" if long_form else "layer_train_fwd") \
                + ("" if save else "_recompute")
            fn = _build.kernel_function(f"dsvg_{name}", _FWD_ARGTYPES)
            rc = fn(x.data_ptr(), _ptr(bias), *[w.data_ptr() for w in used], mask.data_ptr(),
                    out.data_ptr(), *ptrs, b, s, d, f, n_heads, int(causal),
                    int(dt == torch.float32), int(seed), thr, kp, HEAD_DIM ** -0.5,
                    torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(rc, name)
            if long_form or (dt == torch.bfloat16 and not hopper):
                counter.narrow_launches += 1
            elif save:
                counter.launches += 1
            else:
                counter.recompute_launches += 1
        if save:
            ctx.save_for_backward(x, *used, *saved)
        else:
            ctx.save_for_backward(x, *used, mask, bias)
        return out

    @staticmethod
    def backward(ctx, g):
        save = ctx.save_residuals
        n_heads, seed, thr, kp, causal, long_form, hopper, has_bias, bias_dtype = ctx.meta
        if ctx.long_hopper:
            x, *rest = ctx.saved_tensors
            used, (mask, bias), saved = rest[:10], rest[10:12], rest[12:]
            if not save:
                # the recompute mode: the same forward again, saving, into
                # this layer's workspace, freed when the backward returns
                _, saved = _long_launch(x, bias, used, mask, seed, n_heads, causal, thr, kp, True)
            dx, dbias, dws = _long_backward(x, g.to(x.dtype).contiguous(), used, saved,
                                            (seed, thr, kp, causal))
            counter = fused_layer_train_long if long_form else fused_layer_train
            if save:
                counter.backward_launches += 1
                counter.float32_backward_launches += x.dtype == torch.float32
            else:
                counter.recompute_backward_launches += 1
            return (dx, dbias.to(bias_dtype) if has_bias else None, *dws,
                    None, None, None, None, None, None, None, None)
        if save:
            x, ln1, wqkv, _, wo, _, ln2, w1, _, w2, _, qkv_s, p_s, ctx_s, x1_s, h_s = \
                ctx.saved_tensors
            extra = ()
        else:
            x, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, bias = ctx.saved_tensors
            # this layer's workspace, written by the backward's first launch
            # and freed when the backward returns
            qkv_s, ctx_s, x1_s, h32 = _workspace(x, w1.shape[0])
            p_s = h_s = None
            extra = (h32, bias, bqkv, bo, b1, b2, mask)
        b, s, d = x.shape
        f = w1.shape[0]
        rows = b * s
        is_f32 = int(x.dtype == torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        g = g.to(x.dtype).contiguous()
        tensors = (x, g, ln1, wqkv, wo, ln2, w1, w2, qkv_s, p_s, ctx_s, x1_s, h_s)
        mode = "" if save else "_recompute"
        if long_form:
            # one row of column sums per row tile of the first and of the
            # third launch; dctx and dx1 pass from the first launch to the
            # second and third
            tile = _build.kernel_function("dsvg_layer_long_bwd_rows", [])()
            outs = _backward_outputs(x, f, 2 * -(-rows // tile), 9 * d + f)
            scratch = (torch.empty((rows, d), dtype=x.dtype, device=x.device),
                       torch.empty((rows, d), dtype=torch.float32, device=x.device))
            ptrs = [_ptr(t) for t in tensors + outs + scratch + extra]
            fn = _build.kernel_function(f"dsvg_layer_long_train_bwd{mode}", _LONG_BWD_ARGTYPES)
            rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, f, n_heads, causal, is_f32,
                    seed, thr, kp, HEAD_DIM ** -0.5, stream)
            _build.check_launch(rc, f"layer_long_train_bwd{mode}")
        elif save and hopper:
            # the wgmma form: three row-local launches, one row of LayerNorm
            # partial sums per persistent block; dx1, dctx and dxn1 pass
            # through scratch tensors freed on return
            grid = _build.kernel_function("dsvg_layer_train_bwd_grid",
                                          [ctypes.c_int, ctypes.c_int])(b, s)
            outs = _backward_outputs(x, f, grid, 4 * d)
            scratch = (torch.empty((rows, d), dtype=torch.float32, device=x.device),
                       torch.empty((rows, d), dtype=x.dtype, device=x.device),
                       torch.empty((rows, d), dtype=torch.float32, device=x.device))
            ptrs = [_ptr(t) for t in tensors + outs + scratch]
            fn = _build.kernel_function("dsvg_layer_train_bwd", _BWD_ARGTYPES)
            _build.check_launch(fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, f, n_heads,
                                   is_f32, seed, thr, kp, HEAD_DIM ** -0.5, stream),
                                "layer_train_bwd")
        else:
            # one row of column sums per block of the first launch
            block_rows = _build.kernel_function("dsvg_layer_bwd_rows", [ctypes.c_int])(is_f32)
            outs = _backward_outputs(x, f, -(-b // (block_rows // s)), 9 * d + f)
            ptrs = [_ptr(t) for t in tensors + outs + extra]
            if save:
                fn = _build.kernel_function("dsvg_layer_train_bwd", _BWD_ARGTYPES)
                rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, f, n_heads, is_f32, seed,
                        thr, kp, HEAD_DIM ** -0.5, stream)
            else:
                fn = _build.kernel_function("dsvg_layer_train_bwd_recompute",
                                            _LONG_BWD_ARGTYPES)
                rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, f, n_heads, causal,
                        is_f32, seed, thr, kp, HEAD_DIM ** -0.5, stream)
            _build.check_launch(rc, f"layer_train_bwd{mode}")
        counter = fused_layer_train_long if long_form else fused_layer_train
        if save and (long_form or (not is_f32 and not hopper)):
            counter.narrow_backward_launches += 1
        elif save:
            counter.backward_launches += 1
        else:
            counter.recompute_backward_launches += 1
        if save and hopper:
            dws = _weight_grads_hopper(ctx_s, outs, d, rows, stream)
        else:
            dws = _weight_grads(ctx_s, outs, d, f, is_f32, stream)
        dx, dbias = outs[0], outs[1]
        return (dx, dbias.to(bias_dtype) if has_bias else None, *dws,
                None, None, None, None, None, None, None, None)


def plain_layer_train(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                      seed: int, n_heads: int, causal: bool = False, rate: float = 0.0,
                      weight_dtype=None, relu_gate=None, save_residuals: bool = False):
    """:func:`fused_layer_train` through the plain version, on any device: the
    master weights cast to ``weight_dtype`` in the graph, then
    :func:`layer_train_reference` under autograd. Autograd keeps what it
    needs and the probabilities stay float32, so ``save_residuals`` (taken
    for the kernel's signature) changes nothing."""
    used = [w.to(weight_dtype or x.dtype)
            for w in (ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2)]
    return layer_train_reference(x, seq_bias, *used, mask, seed, n_heads, causal, rate,
                                 relu_gate)


def kernel_relu_gate(out: torch.Tensor) -> torch.Tensor:
    """``[B, S, F]`` bool: the FF units that passed the ReLU in the kernel
    forward that made ``out`` (read from what its saved mode kept for the
    backward). The recompute mode keeps no hidden: raises; a saved-mode
    forward of the same inputs makes the same ``out`` to the bit, and its
    gate is the one to take."""
    if not getattr(out.grad_fn, "save_residuals", False):
        raise ValueError("kernel_relu_gate reads the FF hidden that K4's saved mode keeps; "
                         "this output was not made by it (run the same inputs with "
                         "save_residuals=True)")
    hidden = out.grad_fn.saved_tensors[-1]
    return (hidden > 0).view(out.shape[0], out.shape[1], -1)


def fused_layer_train(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                      seed: int, n_heads: int, causal: bool = False, rate: float = 0.0,
                      weight_dtype=None, save_residuals: bool = False):
    """One fused transformer layer, differentiable, with dropout ``rate``.

    Arguments as :func:`ops.layer.fused_layer`, except that the weights are
    the master parameters (any float type) and are cast to ``weight_dtype``
    (default: ``x``'s type) where they are used; ``seed`` is a host integer
    below 2**31. Gradients flow to ``x``, ``seq_bias`` and all weights.
    ``save_residuals`` picks the kernels' mode (see the module note): True
    keeps the forward's intermediates until the backward, False (the
    default, as in the JAX package) recomputes them there; the model passes
    :data:`SAVE_RESIDUALS_DEFAULT`.

    A CPU tensor takes :func:`layer_train_reference` under autograd; a CUDA
    tensor launches the kernels (head dim 32, D <= 256) or raises: the short
    form for bfloat16 activations with S <= 32 and float32 activations with
    S <= 16 (the flagship's E2; at its widths on the long form's TF32
    launches), the long form
    (:func:`fused_layer_train_long`) for bfloat16 with 33 <= S <= 256 and
    float32 with 17 <= S <= 256 (Sketchformer's encoder at S = 242 and its
    teacher-forced decoder at S = 241; a float32 model's E1 and D1 at S = 32
    and 31).
    """
    weights = (ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return plain_layer_train(x, seq_bias, *weights, mask, seed, n_heads, causal, rate,
                                 weight_dtype)
    weight_dtype = weight_dtype or x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"no layer kernel for device {x.device}")
    short = F32_MAX_SEQ if x.dtype == torch.float32 else MAX_SEQ
    if x.dim() == 3 and x.shape[1] > short:
        return fused_layer_train_long(x, seq_bias, *weights, mask, seed, n_heads, causal,
                                      rate, weight_dtype, save_residuals)
    return _FusedLayerTrain.apply(x, seq_bias, *weights, mask, seed, n_heads, causal,
                                  rate, weight_dtype, False, bool(save_residuals))


# the short form's launches, counted apart by mode
fused_layer_train.launches = 0                      # saved mode: forward launches
fused_layer_train.backward_launches = 0             # its backward passes (bf16 D=256: five
#                                                     launches; float32: four)
fused_layer_train.float32_launches = 0              # those of the float32 Hopper form
fused_layer_train.float32_backward_launches = 0     # (the long form's TF32 launches)
fused_layer_train.recompute_launches = 0            # recompute mode: forward launches
fused_layer_train.recompute_backward_launches = 0   # its backward passes (five launches)
# bfloat16 at widths the wgmma kernels do not take (D < 256), on the older
# wmma kernels: forward launches of either mode, saved-mode backward passes
fused_layer_train.narrow_launches = 0
fused_layer_train.narrow_backward_launches = 0


def fused_layer_train_long(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                           seed: int, n_heads: int, causal: bool = False, rate: float = 0.0,
                           weight_dtype=None, save_residuals: bool = False):
    """The long form of :func:`fused_layer_train` (same arguments), for CUDA
    tensors with 1 <= S <= 256 (see the module note). Counted once per
    forward and once per backward, by mode; the float32 Hopper form's also
    apart, and the older kernels' at other widths apart."""
    if x.device.type != "cuda":
        raise ValueError(f"the long training layer kernel runs on CUDA tensors, got "
                         f"{x.device}")
    return _FusedLayerTrain.apply(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                                  mask, seed, n_heads, causal, rate, weight_dtype or x.dtype,
                                  True, bool(save_residuals))


# the long form's passes, counted apart by mode
fused_layer_train_long.launches = 0                      # saved mode: forward passes
fused_layer_train_long.backward_launches = 0             # its backward passes
fused_layer_train_long.float32_launches = 0              # those of the float32 Hopper form
fused_layer_train_long.float32_backward_launches = 0
fused_layer_train_long.recompute_launches = 0            # recompute mode: forward passes
fused_layer_train_long.recompute_backward_launches = 0   # its backward passes
# float32 at widths the Hopper form does not take, on the older wmma
# kernels: forward launches of either mode, saved-mode backward passes
fused_layer_train_long.narrow_launches = 0
fused_layer_train_long.narrow_backward_launches = 0
