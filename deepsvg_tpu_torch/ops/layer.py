"""Fully fused pre-LN transformer layer: kernel K2 and its plain version.

One layer per launch: LN1 -> QKV -> per-head masked softmax(QK^T/sqrt(hd))V
-> out projection -> residual -> + ``seq_bias[B, D]`` -> LN2 -> ReLU FF ->
residual. The residual stream, both LayerNorms and the softmax are float32;
matmul inputs are in the activation dtype with float32 accumulation.

Two activation types. bfloat16 is the serving profile's E1, D1 and D2. In
float32 (E2 of that profile, whose input is the float32 pooled E1 output, and
every stack of a float32 model) the kernel takes float32 activations and
float32 weights and multiplies on the tensor cores in TF32: the operands are
rounded to 10 mantissa bits, three more than bfloat16 keeps, so weights whose
values were rounded to bfloat16 enter exactly and only the activations lose
bits (about 2^-11 relative each). The plain version multiplies in full
float32.

Kernel note (``csrc/layer.cu``). Replaces the Pallas kernel
``deepsvg_tpu/ops/layer.py:_layer_kernel`` (wrapper ``fused_layer``, used
through ``fused_encoder_layer`` / ``fused_decoder_layer``). On the H100 the
layer is bound by its matmuls: an E1 layer at N=1024 (8192 sequences of 32)
is about 283 GFLOP, 0.29 ms at 989 TFLOP/s bf16, while it moves only its
input and output (2 x 134 MB, 0.08 ms). The design keeps every
intermediate on chip: a block owns whole sequences (64 rows: 2x32 for E1,
2x31 for D1 with the ragged rows masked, 8x8 for E2/D2), holds the f32
residual and the bf16 QKV / FF hidden in shared memory, runs the four
products on the tensor cores (``nvcuda::wmma`` bf16 16x16x16, f32
accumulate) with the weights read from L2, and does the attention of each
(sequence, head) in one warp with S <= 32 keys, one key per lane.

The softmax subtracts the row maximum (the Pallas kernel clamps scores to
+-75 instead, a TPU-only choice); a query whose keys are all masked gets
exact zero probabilities, as the Pallas guard gives.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

LN_EPS = 1e-5


def _layer_norm_f32(x: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    """LayerNorm of f32 ``x`` with stacked ``ln [2, D]`` (scale, bias)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + LN_EPS) * ln[0].float() + ln[1].float()


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` in f32 from (possibly bf16) operands: exact products,
    f32 accumulation, as the kernels compute."""
    return torch.matmul(a.float(), w.float().t())


def layer_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                    mask, n_heads: int, causal: bool = False):
    """Plain version of :func:`fused_layer` (same arguments and roundings)."""
    b, s, d = x.shape
    dt = x.dtype
    hd = d // n_heads
    xf = x.float()
    xn = _layer_norm_f32(xf, ln1).to(dt)
    qkv = (_mm(xn, wqkv) + bqkv.float()).to(dt)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, s, n_heads, hd).transpose(1, 2)
               for i in range(3))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    scores = scores + mask.float()[:, None, None, :]
    if causal:
        upper = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(upper, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    e = torch.exp(scores - m)
    p = (e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(dt)
    ctx = torch.matmul(p.float(), v.float()).to(dt)
    ctx = ctx.transpose(1, 2).reshape(b, s, d)
    xf = xf + (_mm(ctx, wo) + bo.float())
    if seq_bias is not None:
        xf = xf + seq_bias.float()[:, None, :]
    xn2 = _layer_norm_f32(xf, ln2).to(dt)
    h = torch.relu(_mm(xn2, w1) + b1.float()).to(dt)
    xf = xf + (_mm(h, w2) + b2.float())
    return xf.to(dt)


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
MAX_SEQ = 32
HEAD_DIM = 32
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads: int) -> None:
    """Raise unless the layer kernels take these CUDA tensors: activations
    and weights of one type (bfloat16 or float32), S <= 32, head dim 32."""
    dev, dt = x.device, x.dtype
    b, s, d = x.shape
    f = w1.shape[0]
    if dt not in KERNEL_DTYPES:
        raise ValueError(f"x has dtype {dt}, expected bfloat16 or float32")
    if d != n_heads * HEAD_DIM or not 1 <= s <= MAX_SEQ or d % 16 or f % 16:
        raise ValueError(
            f"layer kernel takes head dim {HEAD_DIM}, 1 <= S <= {MAX_SEQ} and "
            f"D, F multiples of 16; got D={d}, heads={n_heads}, S={s}, F={f}")
    for name, t, shape in (
            ("x", x, (b, s, d)), ("ln1", ln1, (2, d)), ("wqkv", wqkv, (3 * d, d)),
            ("bqkv", bqkv, (3 * d,)), ("wo", wo, (d, d)), ("bo", bo, (d,)),
            ("ln2", ln2, (2, d)), ("w1", w1, (f, d)), ("b1", b1, (f,)),
            ("w2", w2, (d, f)), ("b2", b2, (d,))):
        _build.require(t, name, dev, dt, shape)
    _build.require(mask, "mask", dev, torch.float32, (b, s))
    if seq_bias is not None:
        _build.require(seq_bias, "seq_bias", dev, dt, (b, d))


def fused_layer(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                n_heads: int, causal: bool = False):
    """One fused transformer layer.

    ``x [B, S, D]``; ``seq_bias [B, D]`` or None (per-sequence injection);
    ``ln1``/``ln2`` stacked ``[2, D]``; weights in ``nn.Linear`` layout:
    ``wqkv [3D, D]`` (q|k|v), ``wo [D, D]``, ``w1 [F, D]``, ``w2 [D, F]``;
    ``mask [B, S]`` additive float32 over keys.

    A CPU tensor takes :func:`layer_reference`; a CUDA tensor launches the
    kernel (activations and weights both bfloat16 or both float32, S <= 32,
    head dim 32) or raises.
    """
    if x.device.type == "cpu":
        return layer_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1,
                               w2, b2, mask, n_heads, causal)
    if x.device.type != "cuda":
        raise ValueError(f"no layer kernel for device {x.device}")
    dev = x.device
    b, s, d = x.shape
    f = w1.shape[0]
    check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads)
    out = torch.empty_like(x)
    if b == 0:
        return out
    fn = _build.kernel_function("dsvg_layer", _ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(x.data_ptr(), ptr(seq_bias), ln1.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln2.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            mask.data_ptr(), out.data_ptr(), b, s, d, f, n_heads, int(causal),
            int(x.dtype == torch.float32), HEAD_DIM ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "layer")
    fused_layer.launches += 1
    fused_layer.float32_launches += x.dtype == torch.float32
    return out


fused_layer.launches = 0            # every launch
fused_layer.float32_launches = 0    # those of the float32 form


def fused_encoder_layer(x, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                        n_heads: int, causal: bool = False, seq_bias=None):
    """Encoder layer (optional per-sequence bias)."""
    return fused_layer(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                       mask, n_heads, causal)


def fused_decoder_layer(x, z, ln1, wqkv, bqkv, wo, bo, wg, bg, ln2, w1, b1, w2, b2,
                        mask, n_heads: int, causal: bool = False):
    """Decoder layer: the latent injection ``z @ Wg + bg`` (a small product
    left to ``F.linear``, as the JAX wrapper leaves it to XLA) becomes the
    per-sequence bias."""
    seq_bias = F.linear(z, wg, bg).to(x.dtype)
    return fused_layer(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                       mask, n_heads, causal)
