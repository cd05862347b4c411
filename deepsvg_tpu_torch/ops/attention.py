"""The attention block alone: kernel K10 and its plain versions.

``out = softmax(Q K^T / sqrt(hd) + mask [, causal]) V Wo^T + bo`` per head,
with ``QKV = x Wqkv^T + bqkv``: no LayerNorm, no residual, no FF. The
counterpart of the JAX package's ``ops/attention.py`` (``fused_mha``,
``mha_blockpacked``, ``mha_reference``), reached there through its public
ops API; the model reaches the whole layer kernels instead.

Operands in the port's convention (``ops/layer.py``): ``x [B, S, D]``;
weights in ``nn.Linear`` layout, ``wqkv [3D, D]`` (q|k|v), ``bqkv [3D]``,
``wo [D, D]``, ``bo [D]``; ``mask [B, S]`` additive float32 over keys. The
TPU-only arguments (``tile_b``, ``interpret``) and ``pick_tile_b``, which
sizes TPU VMEM blocks, are not ported. ``models/weights.py:
attention_operands`` turns the JAX package's ``(wqkv [D, 3D], bqkv, wo
[D, D], bo)`` into these operands.

Roundings are the Pallas kernel's: QKV, the probabilities and the context
are rounded to the activation type before their products, which sum in
float32; the scores, the softmax and the bias adds are float32. The softmax
subtracts the row maximum (the Pallas kernel clamps the scores to +-75
instead, a TPU-only choice) and a query whose keys are all masked gets zero
probabilities (the JAX functions give NaN there).

Kernel note. Replaces the Pallas kernel
``deepsvg_tpu/ops/attention.py:_fused_mha_kernel`` (wrapper ``fused_mha``),
which packed sequences into 128-row blocks with a block-diagonal mask so
that its matrix unit ran at full shape. On the H100 the block is bound by
its products: at the flagship's E1 inference shape (8,192 sequences of 32,
D=256, 8 heads) the QKV and output projections are 1.37e11 operations and
the attention 8.6e9, 0.15 ms at 989 TFLOP/s bf16, against 0.08 ms for the
268 MB of ``x`` in and ``out`` back. At D=256 with 8 heads (every shipped
config's width) the block runs on the layer kernels' Hopper device code
without LN1, the residual, LN2 and the FF (:func:`mha_form` picks the form):

- bfloat16, S <= 32 (``csrc/layer_long.cu``: ``mha_short_kernel``): one
  persistent launch over 128-row tiles of whole sequences, as K2's short
  form walks them. A TMA producer warp lands the tile's ``x`` in the
  128-byte swizzle ``wgmma`` reads and streams Wqkv and Wo through an
  ``mbarrier`` ring; two consumer warpgroups run, head by head, a 64 x 96
  ``wgmma`` for Q, K and V, the attention on ``mma.sync`` with the
  probabilities in registers (K11's dropout applied there), the context into
  shared memory in bf16, then the out projection on ``wgmma`` onto ``bo``.
  QKV never reaches device memory.
- bfloat16, 33 <= S <= 256 (same file): three launches. The QKV product over
  128-row tiles of all rows (``x`` double-buffered by TMA) into a head-major
  scratch; the attention (``mha_long_attn_kernel``), a tile of whole
  sequences and a head a block as K4's long attention launch (so that B=60
  fills the card), but each 16-row query block's keys split over a pair of
  warps, which exchange row maxima, sums and partial contexts through shared
  memory: half the score registers a thread, two blocks an SM; the context
  to a scratch tensor; the out projection onto ``bo`` over 128-row tiles,
  the context landing by TMA.
- float32 (``csrc/layer_f32.cu``), any S up to 256: the same three launches
  on TF32 ``wgmma`` and ``mma.sync`` (K2-f32's pattern and K4's float32
  attention launch), ``x``, QKV, the probabilities and the context rounded
  to TF32 where they are written for a product, the weights once
  (``layer.tf32_copy``).

Other widths (D <= 256 with head dim 32, 16 or 8, e.g. the JAX tests' D=64
with 4 heads and D=32 with 2 or 4) keep the first port's kernels
(``csrc/attention.cu``: QKV over row tiles on ``wmma`` into a scratch
tensor, then a block per (sequence, query tile) running the long layer's
``attend_tile`` and the output projection; the head dim a template
parameter, a head below 16 columns padded with zero columns to a tensor-core
tile), counted under ``narrow_launches``. No form falls back to another or
to the CPU. Every launch passes the scale ``(D / heads) ** -0.5``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ce import _RoundGrad
from .dropout import SITE_ATTN_PROB, dropout_factor
from .layer import (
    HOPPER_HEADS, MAX_SEQ, MAX_SEQ_LONG, _mm, head_dim, softmax_scale, tf32_copy)

HOPPER_WIDTH = 256   # the D of the Hopper forms (8 heads of 32)


class _RoundValue(torch.autograd.Function):
    """``x`` rounded to ``dtype`` (held in float32) with the gradient passed
    through unrounded."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def mha_reference(x, wqkv, bqkv, wo, bo, mask, n_heads: int, causal: bool = False,
                  rate: float = 0.0, seed: int = 0):
    """Plain version of :func:`fused_mha` and, with ``rate`` > 0 and under
    autograd, of :func:`ops.attention_vjp.fused_mha_train`: the
    probabilities dropped with the hash masks of ``ops/dropout.py`` at
    ``SITE_ATTN_PROB`` (row ``(b * H + h) * S + i``, column ``j``), as K4
    drops them.

    Differentiable, with the gradient rounded where the Pallas backward
    rounds it (in bfloat16; nothing is rounded in float32): ``dctx``, ``ds``
    and ``dq``, ``dk``, ``dv`` to the activation type before their
    products, the gradient of the dropped probabilities not."""
    b, s, d = x.shape
    dt = x.dtype
    hd = d // n_heads
    qkv = (_mm(x, wqkv) + bqkv.float()).to(dt)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, s, n_heads, hd).transpose(1, 2)
               for i in range(3))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    scores = _RoundGrad.apply(scores, dt) + mask.float()[:, None, None, :]
    if causal:
        upper = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(upper, float("-inf"))
    m = scores.detach().amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if rate > 0.0:
        rows = torch.arange(b * n_heads * s, device=x.device).reshape(b, n_heads, s, 1)
        p = p * dropout_factor(seed, SITE_ATTN_PROB, rows, torch.arange(s, device=x.device),
                               rate)
    ctx = torch.matmul(_RoundValue.apply(p, dt), v.float()).to(dt)
    ctx = ctx.transpose(1, 2).reshape(b, s, d)
    return (_mm(ctx, wo) + bo.float()).to(dt)


def mha_blockpacked(x, wqkv, bqkv, wo, bo, mask, n_heads: int, causal: bool = False,
                    tile_b: int | None = None):
    """The JAX package's ``mha_blockpacked`` in plain PyTorch: ``tile_b``
    sequences packed into one row block, cross-sequence terms killed by a
    block-diagonal mask (on the TPU this ran the score and value products at
    the matrix unit's shape). The same function as :func:`mha_reference`
    (``tile_b`` must divide B; default the largest power of two up to 256
    rows that does)."""
    b, s, d = x.shape
    if tile_b is None:
        tile_b, t = 1, 1
        while t * s <= 256:
            if b % t == 0:
                tile_b = t
            t *= 2
    hd = d // n_heads
    rows = tile_b * s
    nb = b // tile_b
    dt = x.dtype
    qkv = (_mm(x.reshape(-1, d), wqkv) + bqkv.float()).to(dt).reshape(nb, rows, 3 * d)
    r = torch.arange(rows, device=x.device)
    allowed = (r[:, None] // s) == (r[None, :] // s)
    if causal:
        allowed = allowed & ((r[None, :] % s) <= (r[:, None] % s))
    big_mask = torch.where(allowed[None], mask.float().reshape(nb, 1, rows),
                           torch.full((), float("-inf"), device=x.device))
    heads = []
    for h in range(n_heads):
        q, k, v = (qkv[..., i * d + h * hd:i * d + (h + 1) * hd].float() for i in range(3))
        scores = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)) + big_mask
        m = scores.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
        e = torch.exp(scores - m)
        p = (e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(dt)
        heads.append(torch.matmul(p.float(), v).to(dt))
    ctx = torch.cat(heads, dim=-1).reshape(b * s, d)
    return (_mm(ctx, wo) + bo.float()).to(dt).reshape(b, s, d)


def mha_form(dtype, d: int, n_heads: int, s: int) -> str:
    """Which kernels run the attention block on the card: ``"bf16_short"``
    (bfloat16, S <= 32: one launch), ``"bf16_long"`` (bfloat16, 33 <= S <=
    256: three launches) or ``"f32"`` (float32, S <= 256: three launches)
    at D=256 with 8 heads; ``"narrow"`` (the first port's kernels) at the
    other widths with head dim 32, 16 or 8 up to D=256. Raises on any other
    shape or dtype."""
    if dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"x has dtype {dtype}, expected bfloat16 or float32")
    head_dim(d, n_heads)
    if d > 256 or d % 16 or not 1 <= s <= MAX_SEQ_LONG:
        raise ValueError(f"the attention kernel takes D <= 256, a multiple of 16, and "
                         f"1 <= S <= {MAX_SEQ_LONG}; got D={d}, heads={n_heads}, S={s}")
    if d != HOPPER_WIDTH or n_heads != HOPPER_HEADS:
        return "narrow"
    if dtype == torch.float32:
        return "f32"
    return "bf16_short" if s <= MAX_SEQ else "bf16_long"


def check_mha_inputs(x, wqkv, bqkv, wo, bo, mask, n_heads: int) -> str:
    """Raise unless the attention kernels take these CUDA tensors (operands
    all bfloat16 or all float32, :func:`mha_form`'s shapes); return the
    form."""
    dev, dt = x.device, x.dtype
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got shape {tuple(x.shape)}")
    b, s, d = x.shape
    form = mha_form(dt, d, n_heads, s)
    for name, t, shape in (("x", x, (b, s, d)), ("wqkv", wqkv, (3 * d, d)),
                           ("bqkv", bqkv, (3 * d,)), ("wo", wo, (d, d)), ("bo", bo, (d,))):
        _build.require(t, name, dev, dt, shape)
    _build.require(mask, "mask", dev, torch.float32, (b, s))
    return form


_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_HOPPER_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_forward(x, wqkv, bqkv, wo, bo, mask, n_heads: int, causal: bool, seed: int,
                   thr: int, kp: float, parts: dict | None = None):
    """The forward's launches (K10 with ``thr`` 0, K11's forward with the
    dropout threshold ``thr`` and keep scale ``kp``) on checked CUDA
    tensors, by :func:`mha_form`; returns ``out [B, S, D]``. ``parts``, a
    dict, receives the Hopper forms' QKV (``"qkv"``, ``[B*S, 3D]``
    row-major), probabilities before dropout (``"p"``, ``[B, H, S, S]``
    float32; when causal, zero past the keys each row's warp attends) and context
    (``"ctx"``, ``[B*S, D]``) as they were used (a card test's view; the
    narrow kernels give none)."""
    b, s, d = x.shape
    form = mha_form(x.dtype, d, n_heads, s)
    out = torch.empty_like(x)
    if b == 0:
        return out
    dev, dt = x.device, x.dtype
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = b * s
    if form == "narrow":
        qkv = torch.empty((rows, 3 * d), dtype=dt, device=dev)
        ptrs = [t.data_ptr() for t in (x, wqkv, bqkv, wo, bo, mask, out, qkv)]
        fn = _build.kernel_function("dsvg_mha_fwd", _ARGTYPES)
        rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, n_heads, int(causal),
                int(dt == torch.float32), int(seed), thr, kp, softmax_scale(d, n_heads), stream)
        _build.check_launch(rc, "mha_fwd")
        return out
    keep = parts is not None
    # the long forms' head-major QKV and context scratch; the short form's
    # context only where a caller keeps it
    head_major = (None if form == "bf16_short"
                  else torch.empty((n_heads, rows, 3 * head_dim(d, n_heads)), dtype=dt,
                                   device=dev))
    ctx = (torch.empty((rows, d), dtype=dt, device=dev) if keep or form != "bf16_short"
           else None)
    qkv_rows = torch.empty((rows, 3 * d), dtype=dt, device=dev) if keep else None
    probs = torch.zeros((b, n_heads, s, s), dtype=torch.float32, device=dev) if keep else None
    if form == "f32":
        wqkv, wo = tf32_copy(wqkv), tf32_copy(wo)
    fn = _build.kernel_function("dsvg_mha_f32" if form == "f32" else "dsvg_mha_bf16",
                                _HOPPER_ARGTYPES)
    rc = fn(x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            mask.data_ptr(), out.data_ptr(), _ptr(head_major), _ptr(ctx), _ptr(qkv_rows),
            _ptr(probs), b, s, int(causal), int(seed), thr, kp, softmax_scale(d, n_heads), stream)
    _build.check_launch(rc, f"mha {form}")
    if keep:
        parts.update(qkv=qkv_rows, p=probs, ctx=ctx)
    return out


def count_launch(fn, form: str, dtype) -> None:
    """One more forward call of ``fn`` (:func:`fused_mha` or
    ``fused_mha_train``) in ``dtype``, under its form's counter too."""
    fn.launches += 1
    fn.float32_launches += form == "f32"
    fn.narrow_launches += form == "narrow"
    fn.narrow_float32_launches += form == "narrow" and dtype == torch.float32


def fused_mha(x, wqkv, bqkv, wo, bo, mask, n_heads: int, causal: bool = False):
    """The attention block, inference (no dropout, no gradient).

    A CPU tensor takes :func:`mha_reference`; a CUDA tensor launches K10
    (operands all bfloat16 or all float32, :func:`mha_form`'s shapes: head
    dim 32, 16 or 8, D <= 256, 1 <= S <= 256) or raises.
    """
    if x.device.type == "cpu":
        return mha_reference(x, wqkv, bqkv, wo, bo, mask, n_heads, causal)
    if x.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {x.device}")
    x = x.contiguous()
    mask = mask.to(torch.float32).contiguous()
    form = check_mha_inputs(x, wqkv, bqkv, wo, bo, mask, n_heads)
    with torch.no_grad():
        out = launch_forward(x, wqkv, bqkv, wo, bo, mask, n_heads, causal, 0, 0, 1.0)
    if x.shape[0] > 0:
        count_launch(fused_mha, form, x.dtype)
    return out


fused_mha.launches = 0            # calls: 1 launch (bf16, S <= 32), 3 (the other
                                  # Hopper forms) or 2 (narrow) each
fused_mha.float32_launches = 0    # those of the float32 form
fused_mha.narrow_launches = 0     # those of the first port's kernels (other widths)
fused_mha.narrow_float32_launches = 0   # of those, the float32 ones
