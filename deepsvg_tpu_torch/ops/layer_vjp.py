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

- *Modes.* ``save_residuals=True`` (the saved mode, what the model runs by
  default through :data:`SAVE_RESIDUALS_DEFAULT`): the forward saves to
  device memory what the backward would otherwise recompute: QKV, the
  probabilities before dropout, the context, the residual after the
  attention block (float32) and the FF hidden before dropout, about 5,000
  bytes a row in bfloat16 at the flagship's widths. ``save_residuals=False``
  (the recompute mode, the op's default as in the JAX package): the forward
  writes ``out`` alone, to the bit the saved mode's, and keeps nothing but
  its inputs; the backward first runs the forward tile again into a
  workspace of this layer alone (QKV, the context, x1 and the FF hidden in
  float32; no probabilities), freed when the backward returns, and
  recomputes each (sequence, head)'s probabilities in float32 from Q and K.
  The probabilities enter the softmax backward, and the hidden the ReLU gate
  and the dropped hidden, in float32, as in the Pallas recompute backward;
  the saved mode reads both rounded to the activation type, so in bfloat16
  the two modes' gradients differ by that rounding.
- *Dropout masks* are a hash of (seed, site, row, column), see
  ``ops/dropout.py``: regenerated in the backward, independent of tiling,
  identical in the plain version.
- *Backward* is three launches. The first (``layer_bwd.cu``) does everything
  local to a row or a sequence and needs no reduction across blocks. The
  weight gradients are sums over every row of the batch, which the Pallas
  kernel accumulated over its sequential grid; CUDA blocks run concurrently,
  so the first launch writes the rounded operands of the four products and
  per-block column sums, the second (``wgrad.cu``) multiplies them split over
  the rows into per-split partial sums, and the third adds the partial sums
  in a fixed order. There are no atomics anywhere in K4: the gradients are
  bit-identical from run to run.
- Roundings follow the Pallas body: residual stream, LayerNorm and softmax in
  float32; every product takes activation-type operands with float32
  accumulation; ``df``, ``dhpre``, ``da``, ``dctx``, ``ds`` and ``dqkv`` are
  rounded to the activation type before their products. The plain version
  differentiates its forward with autograd and so does not round those
  gradients: in float32 there is nothing to round, in bfloat16 the two differ
  by that rounding (the tolerances in ``chip_smoke.py`` say how much).

Long form (``csrc/layer_long_train.cu``): sequences that a block cannot hold
whole, bfloat16 with 33 <= S <= 256 and float32 with 17 <= S <= 256 (the
short form's float32 backward tiles hold 16 rows). Sketchformer trains its
encoder at S = 242 and its causal teacher-forced decoder at S = 241; at the
recipe's B=60 a layer's products are 2 x 14,520 x 786,432 = 22.8 GFLOP
forward and twice that backward, and its attention 4 x 60 x 242^2 x 256 =
3.6 GFLOP forward (0.03 ms at 989 TFLOP/s bf16, 0.07 with the backward).
The forward is the long K2's two launches with the training switch; in the
saved mode it saves the probabilities ``[B, H, S, S]`` (56 MB a layer at
B=60 in bfloat16) and what the short form saves, in the recompute mode
nothing (its QKV between the two launches is freed on return). The
backward splits the short
form's walk where a row needs other rows: (a) over 32-row tiles of all rows,
the FF, LN2 and out-projection backward down to ``dctx``; (b) one (sequence,
head) per block, the attention backward with K, V and Q of the head in
shared memory, ``dQ`` per tile of queries and ``dK``, ``dV`` held in
tensor-core accumulators over the query tiles in order; (c) over row tiles,
the QKV and LN1 backward; then the short form's ``wgrad`` and reductions.
No atomics: its gradients are bit-identical from run to run too. Same
roundings as the short form. The recompute mode's backward first runs the
forward's two launches into the layer's workspace (no ``[B, H, S, S]``
buffer), and (b) recomputes the scores and probabilities of each query tile
from Q and K in shared memory, as K11's backward does.

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
from .layer import HEAD_DIM, MAX_SEQ, MAX_SEQ_LONG, _layer_norm_f32, _mm, check_layer_inputs

# The mode the model's layers train in (``models/layers.py``), as the JAX
# package's switch of the same name: True saves the forward's intermediates
# for the backward, False recomputes them there. Module-level, so that a
# caller or a test can switch every layer of a step at once.
SAVE_RESIDUALS_DEFAULT = True


def layer_train_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                          mask, seed: int, n_heads: int, causal: bool = False,
                          rate: float = 0.0, relu_gate=None):
    """Plain version of the K4 forward (differentiable; the weights as they
    are used, already cast). With ``rate`` 0 it is ``layer_reference``.

    ``relu_gate [B, S, F]`` (bool), a diagnostic: the FF units that pass,
    in place of this version's own ``pre-activation > 0``. Two versions whose
    forward passes differ in their last bits disagree on a few units next to
    zero; with the other version's gate the comparison of their gradients
    reads the roundings alone."""
    b, s, d = x.shape
    f = w1.shape[0]
    dt = x.dtype
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
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
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
    a = _mm(ctx, wo) + bo.float()
    if drop:
        a = a * factor(SITE_ATTN_OUT, d)
    xf = xf + a
    if seq_bias is not None:
        xf = xf + seq_bias.float()[:, None, :]
    xn2 = _layer_norm_f32(xf, ln2).to(dt)
    h = _mm(xn2, w1) + b1.float()
    h = torch.relu(h) if relu_gate is None else h * relu_gate
    if drop:
        h = h * factor(SITE_FF_HIDDEN, f)
    ff = _mm(h.to(dt), w2) + b2.float()
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
F32_MAX_SEQ = 16
WGRAD_ROWS_PER_SPLIT = 1024
WGRAD_MAX_SPLITS = 16


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


def _saved_tensors(x, n_heads, f):
    """What the forward keeps for the backward: QKV, the probabilities before
    dropout, the context (16-row padded, for ``wgrad``), the float32
    residual after the attention block and the FF hidden before dropout."""
    b, s, d = x.shape
    dev, dt = x.device, x.dtype
    rows = b * s
    return (torch.empty((rows, 3 * d), dtype=dt, device=dev),
            torch.empty((b, n_heads, s, s), dtype=dt, device=dev),
            _padded_rows(rows, d, dt, dev),
            torch.empty((rows, d), dtype=torch.float32, device=dev),
            torch.empty((rows, f), dtype=dt, device=dev))


def _backward_outputs(x, f, small_rows):
    """The first backward launches' outputs: dx, dseq_bias, the rounded
    operands of the four weight products (16-row padded) and the per-block
    column sums."""
    b, s, d = x.shape
    dev, dt = x.device, x.dtype
    rows = b * s
    xn1_o, da_o, xn2_o, df_o = (_padded_rows(rows, d, dt, dev) for _ in range(4))
    dqkv_o = _padded_rows(rows, 3 * d, dt, dev)
    dhpre_o, hd_o = (_padded_rows(rows, f, dt, dev) for _ in range(2))
    return (torch.empty_like(x), torch.empty((b, d), dtype=torch.float32, device=dev),
            xn1_o, dqkv_o, da_o, xn2_o, dhpre_o, hd_o, df_o,
            torch.empty((small_rows, 9 * d + f), dtype=torch.float32, device=dev))


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
    with ``long_form``, the long form (``csrc/layer_long_train.cu``); in the
    saved mode (``save``) or the recompute mode."""

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
        out = torch.empty_like(x)
        if save:
            saved = _saved_tensors(x, n_heads, f)
            ptrs = [t.data_ptr() for t in saved]
        else:
            # only the long form's QKV, passed between its two launches and
            # freed on return
            saved = ()
            qkv = (torch.empty((b * s, 3 * d), dtype=dt, device=dev) if long_form else None)
            ptrs = [_ptr(qkv), None, None, None, None]
        thr = drop_threshold(rate) if rate > 0.0 else 0
        kp = keep_scale(rate) if rate > 0.0 else 1.0
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
            if save:
                counter.launches += 1
            else:
                counter.recompute_launches += 1
        if save:
            ctx.save_for_backward(x, *used, *saved)
        else:
            ctx.save_for_backward(x, *used, mask, bias)
        ctx.save_residuals = save
        ctx.meta = (n_heads, int(seed), thr, kp, int(causal), long_form, seq_bias is not None,
                    None if seq_bias is None else seq_bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        save = ctx.save_residuals
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
        n_heads, seed, thr, kp, causal, long_form, has_bias, bias_dtype = ctx.meta
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
            outs = _backward_outputs(x, f, 2 * -(-rows // tile))
            scratch = (torch.empty((rows, d), dtype=x.dtype, device=x.device),
                       torch.empty((rows, d), dtype=torch.float32, device=x.device))
            ptrs = [_ptr(t) for t in tensors + outs + scratch + extra]
            fn = _build.kernel_function(f"dsvg_layer_long_train_bwd{mode}", _LONG_BWD_ARGTYPES)
            rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, f, n_heads, causal, is_f32,
                    seed, thr, kp, HEAD_DIM ** -0.5, stream)
            _build.check_launch(rc, f"layer_long_train_bwd{mode}")
        else:
            # one row of column sums per block of the first launch
            block_rows = _build.kernel_function("dsvg_layer_bwd_rows", [ctypes.c_int])(is_f32)
            outs = _backward_outputs(x, f, -(-b // (block_rows // s)))
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
        if save:
            counter.backward_launches += 1
        else:
            counter.recompute_backward_launches += 1
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
    S <= 16 (the flagship's E2), the long form
    (:func:`fused_layer_train_long`) for bfloat16 with 33 <= S <= 256 and
    float32 with 17 <= S <= 256 (Sketchformer's encoder at S = 242 and its
    teacher-forced decoder at S = 241; a float32 model's E1 and D1).
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
fused_layer_train.backward_launches = 0             # its backward passes (four launches)
fused_layer_train.recompute_launches = 0            # recompute mode: forward launches
fused_layer_train.recompute_backward_launches = 0   # its backward passes (five launches)


def fused_layer_train_long(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                           seed: int, n_heads: int, causal: bool = False, rate: float = 0.0,
                           weight_dtype=None, save_residuals: bool = False):
    """The long form of :func:`fused_layer_train` (same arguments), for CUDA
    tensors with 1 <= S <= 256: a forward of two launches and a backward of
    six (eight in the recompute mode). Counted once per forward and once per
    backward, by mode."""
    if x.device.type != "cuda":
        raise ValueError(f"the long training layer kernel runs on CUDA tensors, got "
                         f"{x.device}")
    return _FusedLayerTrain.apply(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                                  mask, seed, n_heads, causal, rate, weight_dtype or x.dtype,
                                  True, bool(save_residuals))


# the long form's passes, counted apart by mode
fused_layer_train_long.launches = 0                      # saved mode: forward passes
fused_layer_train_long.backward_launches = 0             # its backward passes
fused_layer_train_long.recompute_launches = 0            # recompute mode: forward passes
fused_layer_train_long.recompute_backward_launches = 0   # its backward passes
