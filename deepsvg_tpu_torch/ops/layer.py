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
input and output (2 x 134 MB, 0.08 ms).

bfloat16 (``csrc/layer_infer.cuh``; D=256, F a multiple of 64 up to 1024):
persistent blocks, one TMA producer warp streaming x and the weights through
an ``mbarrier`` ring, two consumer warpgroups running the four products on
``wgmma`` over 128-row tiles of whole sequences (E1 4x32, D1 4x31, D2 16x8),
the attention of each 16-row query block on ``mma.sync`` with the exact
softmax in registers, the context and the FF hidden staged in shared memory,
the residual in the accumulators. The long form (``csrc/layer_long.cu``,
33 <= S <= 256: the one-stage models' E1 over a whole icon, S = 242 with SOS
and EOS, and their teacher-forced decoder, S = 241, causal) is two launches:
LN1 and QKV over 128-row tiles of all B*S rows into a scratch tensor, then
tiles of whole sequences (one at S=242) whose K and V come into shared
memory once a head, with every key's score of a query in registers. An E1
layer of that form at N=1024 (B=1024, S=242) is 0.26 TFLOP of products and
0.06 TFLOP of attention, 0.33 ms at 989 TFLOP/s bf16.

float32 (``csrc/layer_fwd.cuh``, ``csrc/layer_long.cuh``, which K4 shares):
a block owns whole sequences (32 rows), holds the f32 residual and the QKV /
FF hidden in shared memory, runs the products on ``nvcuda::wmma`` TF32
16x16x8 with the weights read from L2, and does the attention of each
(sequence, head) in one warp, one key per lane; its long form takes 32-query
tiles of a sequence in its second launch.

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
_LONG_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                  ctypes.c_void_p]
MAX_SEQ = 32
MAX_SEQ_LONG = 256
HEAD_DIM = 32
BF16_WIDTH = 256    # the D of the bfloat16 kernels (csrc/layer_infer.cuh)
BF16_MAX_FF = 1024  # and their widest F


def check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads: int, max_seq: int = MAX_SEQ) -> None:
    """Raise unless the layer kernels take these CUDA tensors: activations
    and weights of one type (bfloat16 or float32), S <= ``max_seq``, head
    dim 32."""
    dev, dt = x.device, x.dtype
    b, s, d = x.shape
    f = w1.shape[0]
    _build.kernel_dtype(x, "x")
    if d != n_heads * HEAD_DIM or not 1 <= s <= max_seq or d % 16 or f % 16:
        raise ValueError(
            f"layer kernel takes head dim {HEAD_DIM}, 1 <= S <= {max_seq} and "
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


def _check_bf16_widths(x, w1) -> None:
    """Raise unless K2's bfloat16 kernels take these widths."""
    d, f = x.shape[-1], w1.shape[0]
    if x.dtype == torch.bfloat16 and (d != BF16_WIDTH or f % 64 or f > BF16_MAX_FF):
        raise ValueError(f"the bfloat16 layer kernels take D={BF16_WIDTH} and F a multiple of "
                         f"64 up to {BF16_MAX_FF}; got D={d}, F={f}")


def fused_layer(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                n_heads: int, causal: bool = False):
    """One fused transformer layer.

    ``x [B, S, D]``; ``seq_bias [B, D]`` or None (per-sequence injection);
    ``ln1``/``ln2`` stacked ``[2, D]``; weights in ``nn.Linear`` layout:
    ``wqkv [3D, D]`` (q|k|v), ``wo [D, D]``, ``w1 [F, D]``, ``w2 [D, F]``;
    ``mask [B, S]`` additive float32 over keys.

    A CPU tensor takes :func:`layer_reference`; a CUDA tensor launches the
    kernel (activations and weights both bfloat16 or both float32, head dim
    32; S <= 32 the short form, up to 256 the long form,
    :func:`fused_layer_long`) or raises.
    """
    if x.device.type == "cpu":
        return layer_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1,
                               w2, b2, mask, n_heads, causal)
    if x.device.type != "cuda":
        raise ValueError(f"no layer kernel for device {x.device}")
    if x.dim() == 3 and x.shape[1] > MAX_SEQ:
        return fused_layer_long(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                                mask, n_heads, causal)
    dev = x.device
    b, s, d = x.shape
    f = w1.shape[0]
    check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads)
    _check_bf16_widths(x, w1)
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


fused_layer.launches = 0            # every launch of the short form
fused_layer.float32_launches = 0    # those of its float32 form


def fused_layer_long(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                     n_heads: int, causal: bool = False):
    """The long form of :func:`fused_layer` (same arguments), for CUDA
    tensors with 1 <= S <= 256: two launches, with the QKV of all rows in a
    scratch tensor between them. Counted once per layer."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the long layer kernel runs on CUDA tensors, got {dev}")
    b, s, d = x.shape
    f = w1.shape[0]
    check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads, MAX_SEQ_LONG)
    _check_bf16_widths(x, w1)
    out = torch.empty_like(x)
    if b == 0:
        return out
    qkv = torch.empty((b * s, 3 * d), dtype=x.dtype, device=dev)
    fn = _build.kernel_function("dsvg_layer_long", _LONG_ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(x.data_ptr(), ptr(seq_bias), ln1.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln2.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            mask.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, s, d, f, n_heads,
            int(causal), int(x.dtype == torch.float32), HEAD_DIM ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "long layer")
    fused_layer_long.launches += 1
    fused_layer_long.float32_launches += x.dtype == torch.float32
    return out


fused_layer_long.launches = 0           # every layer run by the long form
fused_layer_long.float32_launches = 0   # those of its float32 form


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
