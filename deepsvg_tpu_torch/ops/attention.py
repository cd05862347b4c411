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

Kernel note (``csrc/attention.cu``). Replaces the Pallas kernel
``deepsvg_tpu/ops/attention.py:_fused_mha_kernel`` (wrapper ``fused_mha``),
which packed sequences into 128-row blocks with a block-diagonal mask so
that its matrix unit ran at full shape. On the H100 the block is bound by
its products: at the flagship's E1 inference shape (8,192 sequences of 32,
D=256, 8 heads) the QKV and output projections are 1.37e11 operations and
the attention 8.6e9, 0.15 ms at 989 TFLOP/s bf16, against 0.08 ms for the
268 MB of ``x`` in and ``out`` back. Two launches: QKV over row tiles into a
scratch tensor, then one block per (sequence, query tile of 64, 32 in
float32) holding the sequence's keys and values in shared memory, the
long layer's attention (``csrc/layer_long.cuh``: ``attend_tile``), and the
output projection of the tile's rows. The products run on ``wmma`` (bf16,
or TF32 for float32 operands) with the weights read from L2. 1 <= S <= 256,
head dim 32.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ce import _RoundGrad
from .dropout import SITE_ATTN_PROB, dropout_factor
from .layer import HEAD_DIM, MAX_SEQ_LONG, _mm



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


def check_mha_inputs(x, wqkv, bqkv, wo, bo, mask, n_heads: int) -> None:
    """Raise unless the attention kernels take these CUDA tensors: operands
    all bfloat16 or all float32, head dim 32, D <= 256, 1 <= S <= 256."""
    dev, dt = x.device, x.dtype
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got shape {tuple(x.shape)}")
    b, s, d = x.shape
    _build.kernel_dtype(x, "x")
    if d != n_heads * HEAD_DIM or d > 256 or not 1 <= s <= MAX_SEQ_LONG:
        raise ValueError(f"the attention kernel takes head dim {HEAD_DIM}, D <= 256 and "
                         f"1 <= S <= {MAX_SEQ_LONG}; got D={d}, heads={n_heads}, S={s}")
    for name, t, shape in (("x", x, (b, s, d)), ("wqkv", wqkv, (3 * d, d)),
                           ("bqkv", bqkv, (3 * d,)), ("wo", wo, (d, d)), ("bo", bo, (d,))):
        _build.require(t, name, dev, dt, shape)
    _build.require(mask, "mask", dev, torch.float32, (b, s))


_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def launch_forward(x, wqkv, bqkv, wo, bo, mask, n_heads: int, causal: bool, seed: int,
                   thr: int, kp: float):
    """The forward's two launches (K10 with ``thr`` 0, K11's forward with
    the dropout threshold ``thr`` and keep scale ``kp``) on checked CUDA
    tensors; returns ``out [B, S, D]``."""
    b, s, d = x.shape
    out = torch.empty_like(x)
    if b == 0:
        return out
    qkv = torch.empty((b * s, 3 * d), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (x, wqkv, bqkv, wo, bo, mask, out, qkv)]
    fn = _build.kernel_function("dsvg_mha_fwd", _ARGTYPES)
    rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), b, s, d, n_heads, int(causal),
            int(x.dtype == torch.float32), int(seed), thr, kp, HEAD_DIM ** -0.5,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, "mha_fwd")
    return out


def fused_mha(x, wqkv, bqkv, wo, bo, mask, n_heads: int, causal: bool = False):
    """The attention block, inference (no dropout, no gradient).

    A CPU tensor takes :func:`mha_reference`; a CUDA tensor launches K10
    (operands all bfloat16 or all float32, head dim 32, D <= 256,
    1 <= S <= 256) or raises.
    """
    if x.device.type == "cpu":
        return mha_reference(x, wqkv, bqkv, wo, bo, mask, n_heads, causal)
    if x.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {x.device}")
    x = x.contiguous()
    mask = mask.to(torch.float32).contiguous()
    check_mha_inputs(x, wqkv, bqkv, wo, bo, mask, n_heads)
    with torch.no_grad():
        out = launch_forward(x, wqkv, bqkv, wo, bo, mask, n_heads, causal, 0, 0, 1.0)
    fused_mha.launches += x.shape[0] > 0
    return out


fused_mha.launches = 0   # calls (two launches each)
