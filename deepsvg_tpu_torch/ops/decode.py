"""One token of an autoregressive decode through the whole decoder stack,
against the key/value caches: kernel K9 and its plain version.

For each of the L layers: LN1 -> QKV -> attention of the token's query over
the cached positions before ``index`` plus the token's own key and value as
an explicit extra term (the caches do not hold it yet), with the additive
key padding on both -> out projection -> residual -> ``+ seq_bias[l]`` ->
LN2 -> ReLU FF -> residual; then the stack's final LayerNorm. Returns
``y [R, D]`` and the token's keys and values ``k_new, v_new [L, R, D]``,
which the caller writes into the caches at ``index``.

The roundings are the JAX kernel's: the residual, both LayerNorms, the
query, the scores, the probabilities and the context sums are float32; the
LN outputs, the token's keys and values, the context and the FF hidden are
rounded to the activation type before their products, which sum in float32.
The softmax subtracts the maximum (the Pallas kernel clamps the scores to
+-75 instead, a TPU-only choice); a query whose keys are all masked gets a
zero context.

Operands are the JAX wrapper's (``deepsvg_tpu/ops/decode.py:
fused_decode_step``) in the port's ``nn.Linear`` layout: ``x [R, D]``;
``seq_bias [L, R, D]``; ``ln1s``/``ln2s [L, 2, D]``; ``wqkvs [L, 3D, D]``
(q|k|v), ``bqkvs [L, 3D]``, ``wos [L, D, D]``, ``bos [L, D]``, ``w1s
[L, F, D]``, ``b1s [L, F]``, ``w2s [L, D, F]``, ``b2s [L, D]``; ``lnf
[2, D]``; ``kcache``/``vcache [L, R, T, D]``; ``key_pad [R, T]`` float32;
``index`` the position of the token (an int: positions ``< index`` are
cached).

Kernel note (``csrc/decode.cu``). Replaces the Pallas kernel
``deepsvg_tpu/ops/decode.py:_decode_kernel`` (wrapper
``fused_decode_step``). On the H100 a step is bound by reading the caches:
at R = 1024 rows, L = 4, D = 256 and ``index`` = 120 it must read 2 x 4 x
1024 x 120 x 256 x 2 bytes = 503 MB, 0.15 ms at 3.35 TB/s, against 4.3
GFLOP of products (4 us on the tensor cores). The Pallas kernel reads the
whole cache length T every step; this one reads only the positions before
``index``. A block of 16 warps owns 8 rows (``m8n32k16`` tensor-core
tiles, so R = 1024 gives 128 blocks on the 132 SMs) and loops over the
layers with the residual in shared memory; the four products run on
``wmma`` with the weights read from L2; a warp takes one (row, head) pair
at a time and streams its ``[index, 32]`` key and value slices with 16-byte
loads, four lanes per position, folding them into an online softmax. Every
block reads all the weights from L2 at every step (4 MB, 512 MB over the
grid), which costs about 0.24 ms a step whatever ``index`` is (PERF.md).

A float32 model takes the kernel's float32 form: float32 activations,
weights and caches, the products in TF32 (``wmma`` 16x16x8, whose 16-row
tile holds the block's 8 rows and 8 zero rows), the cache read as two
16-byte loads per lane. Its caches are twice the bytes: 1,007 MB a step at
``index`` 120, 0.30 ms at 3.35 TB/s.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .layer import HEAD_DIM, _layer_norm_f32, _mm

MAX_D = 256       # the kernel's widest row


def decode_step_reference(x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s, b1s,
                          w2s, b2s, lnf, kcache, vcache, key_pad, index: int, n_heads: int):
    """Plain version of :func:`fused_decode_step` (same arguments and
    roundings)."""
    r, d = x.shape
    dt = x.dtype
    hd = d // n_heads
    xf = x.float()
    kp_past = key_pad[:, None, :index].float()                 # [R, 1, i]
    kp_cur = key_pad[:, index, None].float()                   # [R, 1]
    k_new, v_new = [], []
    for l in range(kcache.shape[0]):
        xn = _layer_norm_f32(xf, ln1s[l]).to(dt)
        qkv = _mm(xn, wqkvs[l]) + bqkvs[l].float()
        q = (qkv[:, :d] * hd ** -0.5).reshape(r, n_heads, hd)
        k_t, v_t = qkv[:, d:2 * d].to(dt), qkv[:, 2 * d:].to(dt)
        k_new.append(k_t)
        v_new.append(v_t)
        kc = kcache[l, :, :index].float().reshape(r, index, n_heads, hd)
        vc = vcache[l, :, :index].float().reshape(r, index, n_heads, hd)
        s_past = torch.einsum("rhd,rjhd->rhj", q, kc) + kp_past
        s_cur = (q * k_t.float().reshape(r, n_heads, hd)).sum(-1) + kp_cur
        scores = torch.cat([s_past, s_cur[..., None]], dim=-1)  # [R, H, index + 1]
        m = scores.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
        e = torch.exp(scores - m)
        p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        ctx = (torch.einsum("rhj,rjhd->rhd", p[..., :index], vc)
               + p[..., index:] * v_t.float().reshape(r, n_heads, hd))
        ctx = ctx.reshape(r, d).to(dt)
        xf = xf + (_mm(ctx, wos[l]) + bos[l].float()) + seq_bias[l].float()
        xn2 = _layer_norm_f32(xf, ln2s[l]).to(dt)
        h = torch.relu(_mm(xn2, w1s[l]) + b1s[l].float()).to(dt)
        xf = xf + (_mm(h, w2s[l]) + b2s[l].float())
    y = _layer_norm_f32(xf, lnf).to(dt)
    return y, torch.stack(k_new), torch.stack(v_new)


_ARGTYPES = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def fused_decode_step(x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s, b1s, w2s, b2s,
                      lnf, kcache, vcache, key_pad, index: int, n_heads: int):
    """One token through the decoder stack: ``(y [R, D], k_new [L, R, D],
    v_new [L, R, D])``.

    A CPU tensor takes :func:`decode_step_reference`; a CUDA tensor launches
    the kernel (activations, weights and caches all bfloat16 or all float32,
    head dim 32, D <= 256 and D, F multiples of 32) or raises.
    """
    if x.device.type == "cpu":
        return decode_step_reference(x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s,
                                     b1s, w2s, b2s, lnf, kcache, vcache, key_pad, index,
                                     n_heads)
    if x.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {x.device}")
    dev = x.device
    n_layers, r, t, d = kcache.shape
    f = w1s.shape[1]
    dt = _build.kernel_dtype(x, "x")
    if d != n_heads * HEAD_DIM or d > MAX_D or d % 32 or f % 32:
        raise ValueError(f"decode kernel takes head dim {HEAD_DIM}, D <= {MAX_D} and D, F "
                         f"multiples of 32; got D={d}, heads={n_heads}, F={f}")
    if not 0 <= index < t:
        raise ValueError(f"index {index} outside the cache length {t}")
    for name, tensor, shape in (
            ("x", x, (r, d)), ("seq_bias", seq_bias, (n_layers, r, d)),
            ("ln1s", ln1s, (n_layers, 2, d)), ("wqkvs", wqkvs, (n_layers, 3 * d, d)),
            ("bqkvs", bqkvs, (n_layers, 3 * d)), ("wos", wos, (n_layers, d, d)),
            ("bos", bos, (n_layers, d)), ("ln2s", ln2s, (n_layers, 2, d)),
            ("w1s", w1s, (n_layers, f, d)), ("b1s", b1s, (n_layers, f)),
            ("w2s", w2s, (n_layers, d, f)), ("b2s", b2s, (n_layers, d)),
            ("lnf", lnf, (2, d)), ("kcache", kcache, (n_layers, r, t, d)),
            ("vcache", vcache, (n_layers, r, t, d))):
        _build.require(tensor, name, dev, dt, shape)
    _build.require(key_pad, "key_pad", dev, torch.float32, (r, t))
    y = torch.empty_like(x)
    k_new = torch.empty((n_layers, r, d), dtype=dt, device=dev)
    v_new = torch.empty_like(k_new)
    if r == 0:
        return y, k_new, v_new
    fn = _build.kernel_function("dsvg_decode_step", _ARGTYPES)
    rc = fn(x.data_ptr(), seq_bias.data_ptr(), ln1s.data_ptr(), wqkvs.data_ptr(),
            bqkvs.data_ptr(), wos.data_ptr(), bos.data_ptr(), ln2s.data_ptr(),
            w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(), b2s.data_ptr(), lnf.data_ptr(),
            kcache.data_ptr(), vcache.data_ptr(), key_pad.data_ptr(), y.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), r, t, d, f, n_heads, n_layers, index,
            int(dt == torch.float32), HEAD_DIM ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "decode")
    fused_decode_step.launches += 1
    fused_decode_step.float32_launches += dt == torch.float32
    return y, k_new, v_new


fused_decode_step.launches = 0            # every launch
fused_decode_step.float32_launches = 0    # those of its float32 form
