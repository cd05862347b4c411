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

float32 (``csrc/layer_f32.cu``; D=256, 8 heads, F a multiple of 64 up to
1024, any S up to 256, the short and the long form alike): three launches,
on TF32 ``wgmma`` and ``mma.sync``. A float32 tile's LN1 output and context
(128 KB each at 128 rows) do not fit a block's shared memory together, nor
does a 242-row sequence's context, so QKV and the context pass through
scratch tensors in device memory: LN1 and QKV over 128-row tiles of all
rows (a TMA producer warp, an ``mbarrier`` weight ring, two consumer
warpgroups on m64n96k8); the attention per (tile of whole sequences, head)
on ``mma.sync`` m16n8k8 with the exact softmax in registers; then the out
projection onto the residual in the accumulators, LN2 and the FF over
128-row tiles, as the bfloat16 form's second half. The activations are
rounded to TF32 (to nearest) where they are written for a product, the
weights once when first used (:func:`tf32_copy`).

Other widths, in both types (head dim 8, 16 or 32 at any D up to what a
block's shared memory holds; the test configs' D=32 with 4 heads of 8), keep
the first port's code (``csrc/layer_fwd.cuh``, ``csrc/layer_long.cuh``,
which K4 and K7 share: a block owns whole sequences, 64 rows in bfloat16 and
32 in float32, ``nvcuda::wmma`` bf16 or TF32 with the weights read from L2;
the attention of a (sequence, head) on one warp at S <= 32, on ``wmma``
tiles over the head padded to 16 columns in the long form), with the head
dim a template parameter; counted apart (``narrow_launches``).
:func:`layer_form` names the form a shape takes, from the shape alone.
Every launch passes the softmax scale ``(D / heads) ** -0.5``
(:func:`softmax_scale`).

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


def to_tf32(t):
    """Float32 ``t`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: the operands of the
    float32 forms' TF32 products (K2, K3, K5, K8)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


TF32_CACHE = 256  # rounded copies kept by tf32_copy


def tf32_copy(t):
    """Float32 ``t`` rounded to TF32 (:func:`to_tf32`), made once per tensor
    and reused: the float32 kernels' weights, rounded when they are first
    used. A copy is kept beside a reference to ``t`` (so that its storage is
    not reused while the copy is kept), keyed by its storage, version and
    layout; an in-place update bumps the version and makes a new copy. The
    oldest of more than :data:`TF32_CACHE` copies is dropped."""
    key = (t.data_ptr(), t._version, tuple(t.shape), tuple(t.stride()), t.device)
    cache = tf32_copy.cache
    hit = cache.pop(key, None)
    if hit is None:
        with torch.no_grad():
            hit = (t, to_tf32(t.detach().contiguous()))
    cache[key] = hit
    while len(cache) > TF32_CACHE:
        del cache[next(iter(cache))]
    return hit[1]


tf32_copy.cache = {}


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_LONG_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                  ctypes.c_void_p]
MAX_SEQ = 32
MAX_SEQ_LONG = 256
HEAD_DIM = 32       # the head dim of the Hopper forms (D=256, 8 heads)
HEAD_DIMS = (32, 16, 8)   # the head dims (D / heads) the first port's kernels take
BF16_WIDTH = 256    # the D of the bfloat16 kernels (csrc/layer_infer.cuh)
BF16_MAX_FF = 1024  # and their widest F
HOPPER_HEADS = BF16_WIDTH // HEAD_DIM
SMEM_LIMIT = 232448         # shared memory a block can use on the H100
# The first port's layer forward's shared-memory plan (narrow_smem), a copy
# of the C's that must change with it: a block's rows are the ROWS (QROWS) of
# the launch<T, ROWS> calls in csrc/layer.cu (launch_forward in
# csrc/layer_long.cu); SPAD and NWARPS are csrc/common.cuh's, HPAD
# csrc/layer_long.cuh's. The launches refuse a larger plan on their own
# (cudaFuncSetAttribute); this copy names the limit before one is tried.
NARROW_ROWS = {torch.bfloat16: 64, torch.float32: 32}
SPAD, HPAD, NWARPS = 8, 8, 8


def head_dim(d: int, n_heads: int) -> int:
    """``D / heads``; raise unless it is a head dim the kernels take (32,
    16 or 8)."""
    if n_heads < 1 or d % n_heads or d // n_heads not in HEAD_DIMS:
        raise ValueError(f"the kernels take head dim 32, 16 or 8 (D / heads); got D={d}, "
                         f"heads={n_heads}")
    return d // n_heads


def softmax_scale(d: int, n_heads: int) -> float:
    """The softmax scale every attention launch passes: ``(D / heads) **
    -0.5``, as the JAX kernels and the plain versions take it."""
    return head_dim(d, n_heads) ** -0.5


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def narrow_smem(dtype, s: int, d: int, f: int, n_heads: int, long_form: bool) -> int:
    """Shared-memory bytes of a block of the first port's layer forward:
    ``smem_bytes`` of csrc/layer_fwd.cuh (the short form, whole sequences
    in a block) or the long form's larger launch (``LongLayout`` of
    csrc/layer_long.cuh; its head slices padded to ``head_pad``, 16
    columns at least)."""
    es = torch.empty((), dtype=dtype).element_size()
    rows = NARROW_ROWS[dtype]
    scratch = NWARPS * 256 * 4      # each warp's float32 wmma scratch
    if not long_form:
        return (rows * d * 4 + rows * (d + SPAD) * es + rows * (max(3 * d, f) + SPAD) * es
                + scratch)
    spad, ldh = _round16(s), max(d // n_heads, 16) + HPAD
    region = rows * (d + SPAD) * es
    attention = region + (rows + 2 * spad) * ldh * es + rows * (spad + 8) * 4
    ffn = region + rows * d * 4 + rows * (f + SPAD) * es
    return max(attention, ffn) + scratch


def layer_form(dtype, d: int, f: int, n_heads: int, s: int) -> str:
    """The kernels K2 runs a layer on, from its shape alone: at D=256 with
    8 heads (F a multiple of 64 up to 1024) the Hopper forms, ``"bf16"`` (S
    <= 32, one launch), ``"bf16_long"`` (S up to 256), ``"f32"`` / ``"f32_long"``
    (the float32 ``wgmma`` launches, counted as the short or the long
    form); at the other widths the first port's kernels, ``"narrow"`` (S <=
    32) or ``"narrow_long"``, at head dim 32, 16 or 8 where a block's shared
    memory holds them. Raises on any other shape, naming the limit (a
    bfloat16 layer at D=256 with 8 heads and another F included)."""
    _build.kernel_dtype(torch.empty((), dtype=dtype), "x")
    head_dim(d, n_heads)
    if not 1 <= s <= MAX_SEQ_LONG or d % 16 or f % 16 or f < 16:
        raise ValueError(f"the layer kernels take 1 <= S <= {MAX_SEQ_LONG} and D, F multiples "
                         f"of 16; got D={d}, S={s}, F={f}")
    long_form = s > MAX_SEQ
    suffix = "_long" if long_form else ""
    if d == BF16_WIDTH and n_heads == HOPPER_HEADS:
        if f % 64 == 0 and f <= BF16_MAX_FF:
            return ("bf16" if dtype == torch.bfloat16 else "f32") + suffix
        if dtype == torch.bfloat16:
            raise ValueError(f"the bfloat16 layer kernels take D={BF16_WIDTH} and F a multiple "
                             f"of 64 up to {BF16_MAX_FF} at {HOPPER_HEADS} heads; got D={d}, "
                             f"F={f}")
    smem = narrow_smem(dtype, s, d, f, n_heads, long_form)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the layer kernels at D={d}, F={f}, S={s} need {smem} bytes of shared "
                         f"memory a block, over the {SMEM_LIMIT} a block can use")
    return "narrow" + suffix


def check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads: int, max_seq: int = MAX_SEQ) -> None:
    """Raise unless the layer kernels take these CUDA tensors: activations
    and weights of one type (bfloat16 or float32), S <= ``max_seq``, head
    dim 32, 16 or 8."""
    dev, dt = x.device, x.dtype
    b, s, d = x.shape
    f = w1.shape[0]
    _build.kernel_dtype(x, "x")
    head_dim(d, n_heads)
    if not 1 <= s <= max_seq or d % 16 or f % 16:
        raise ValueError(
            f"layer kernel takes 1 <= S <= {max_seq} and D, F multiples of 16; got D={d}, "
            f"heads={n_heads}, S={s}, F={f}")
    for name, t, shape in (
            ("x", x, (b, s, d)), ("ln1", ln1, (2, d)), ("wqkv", wqkv, (3 * d, d)),
            ("bqkv", bqkv, (3 * d,)), ("wo", wo, (d, d)), ("bo", bo, (d,)),
            ("ln2", ln2, (2, d)), ("w1", w1, (f, d)), ("b1", b1, (f,)),
            ("w2", w2, (d, f)), ("b2", b2, (d,))):
        _build.require(t, name, dev, dt, shape)
    _build.require(mask, "mask", dev, torch.float32, (b, s))
    if seq_bias is not None:
        _build.require(seq_bias, "seq_bias", dev, dt, (b, d))


def f32_hopper_form(x, n_heads: int, f: int) -> bool:
    """Whether the float32 ``wgmma`` forms (``csrc/layer_f32.cu``) take this
    CUDA layer: :func:`layer_form` names ``"f32"`` or ``"f32_long"`` (D=256
    with 8 heads, F a multiple of 64 up to 1024, any S up to 256)."""
    return layer_form(x.dtype, x.shape[2], f, n_heads, x.shape[1]).startswith("f32")


def fused_layer(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                n_heads: int, causal: bool = False):
    """One fused transformer layer.

    ``x [B, S, D]``; ``seq_bias [B, D]`` or None (per-sequence injection);
    ``ln1``/``ln2`` stacked ``[2, D]``; weights in ``nn.Linear`` layout:
    ``wqkv [3D, D]`` (q|k|v), ``wo [D, D]``, ``w1 [F, D]``, ``w2 [D, F]``;
    ``mask [B, S]`` additive float32 over keys.

    A CPU tensor takes :func:`layer_reference`; a CUDA tensor launches the
    kernel (activations and weights both bfloat16 or both float32, head dim
    32, 16 or 8; S <= 32 the short form, up to 256 the long form,
    :func:`fused_layer_long`; :func:`layer_form` names the kernels) or
    raises. The operators: ``deepsvg::layer``
    (the short form), ``deepsvg::layer_f32`` (the float32 ``wgmma`` forms,
    where :func:`f32_hopper_form` takes the widths) and
    ``deepsvg::layer_long``.
    """
    _build.check_device(x, "layer")
    args = (x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask)
    if _build.plain(*args):
        return layer_reference(*args, n_heads, causal)
    if x.device.type == "cuda" and x.dim() == 3:
        if x.shape[1] > MAX_SEQ:
            return fused_layer_long(*args, n_heads, causal)
        if f32_hopper_form(x, n_heads, w1.shape[0]):
            return torch.ops.deepsvg.layer_f32(*args, n_heads, causal, False)
    return torch.ops.deepsvg.layer(*args, n_heads, causal)


fused_layer.launches = 0            # every layer of the short form on its wgmma kernels
fused_layer.float32_launches = 0    # those of its float32 form
fused_layer.narrow_launches = 0     # layers at other widths (both types), on the older code
fused_layer.narrow_float32_launches = 0   # those in float32


def fused_layer_long(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                     n_heads: int, causal: bool = False):
    """The long form of :func:`fused_layer` (same arguments), for CUDA
    tensors with 1 <= S <= 256: two launches, with the QKV of all rows in a
    scratch tensor between them. Counted once per layer."""
    if x.device.type != "cuda":
        raise ValueError(f"the long layer kernel runs on CUDA tensors, got {x.device}")
    args = (x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask)
    if x.dim() == 3 and f32_hopper_form(x, n_heads, w1.shape[0]):
        return torch.ops.deepsvg.layer_f32(*args, n_heads, causal, True)
    return torch.ops.deepsvg.layer_long(*args, n_heads, causal)


fused_layer_long.launches = 0           # every layer run by the long form's wgmma kernels
fused_layer_long.float32_launches = 0   # those of its float32 form
fused_layer_long.narrow_launches = 0    # layers at other widths (both types), on the older code
fused_layer_long.narrow_float32_launches = 0   # those in float32


# The operators. Each takes the layer's thirteen tensors, then ``n_heads``
# and ``causal``; the CPU runs the plain version, a CUDA tensor its kernel.

def _layer_fake(x, *_):
    return torch.empty_like(x)


def _ptr(t):
    return None if t is None else t.data_ptr()


@torch.library.custom_op("deepsvg::layer", mutates_args=())
def _layer_op(x: torch.Tensor, seq_bias: torch.Tensor | None, ln1: torch.Tensor,
              wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
              ln2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, mask: torch.Tensor, n_heads: int,
              causal: bool) -> torch.Tensor:
    return layer_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                           n_heads, causal)


_layer_op.register_fake(_layer_fake)


@_layer_op.register_kernel("cuda")
def _(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, n_heads, causal):
    """The short form: the bfloat16 ``wgmma`` kernels, or the older code at
    the widths :func:`layer_form` names ``"narrow"``."""
    check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads)
    b, s, d = x.shape
    narrow = not layer_form(x.dtype, d, w1.shape[0], n_heads, s).startswith("bf16")
    out = torch.empty_like(x)
    if b == 0:
        return out
    fn = _build.kernel_function("dsvg_layer", _ARGTYPES)
    rc = fn(x.data_ptr(), _ptr(seq_bias), ln1.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln2.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            mask.data_ptr(), out.data_ptr(), b, s, d, w1.shape[0], n_heads, int(causal),
            int(x.dtype == torch.float32), softmax_scale(d, n_heads),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, "layer")
    if narrow:
        fused_layer.narrow_launches += 1
        fused_layer.narrow_float32_launches += x.dtype == torch.float32
    else:
        fused_layer.launches += 1
    return out


_F32_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_void_p])


@torch.library.custom_op("deepsvg::layer_f32", mutates_args=())
def _layer_f32_op(x: torch.Tensor, seq_bias: torch.Tensor | None, ln1: torch.Tensor,
                  wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  ln2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, mask: torch.Tensor, n_heads: int, causal: bool,
                  long_form: bool) -> torch.Tensor:
    """``long_form``: counted as a layer of the long form (S up to 256), not of
    the short one (S up to 32)."""
    return layer_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                           n_heads, causal)


_layer_f32_op.register_fake(_layer_fake)


@_layer_f32_op.register_kernel("cuda")
def _(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, n_heads, causal,
      long_form):
    """The float32 ``wgmma`` forms: three launches through two float32
    scratch tensors, the weights rounded to TF32 once."""
    counter = fused_layer_long if long_form else fused_layer
    check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads, MAX_SEQ_LONG if long_form else MAX_SEQ)
    b, s, d = x.shape
    dev = x.device
    out = torch.empty_like(x)
    if b == 0:
        return out
    hd = head_dim(d, n_heads)
    qkv = torch.empty((n_heads, b * s, 3 * hd), dtype=torch.float32, device=dev)
    ctx = torch.empty((b * s, d), dtype=torch.float32, device=dev)
    wqkv, wo, w1, w2 = (tf32_copy(w) for w in (wqkv, wo, w1, w2))
    fn = _build.kernel_function("dsvg_layer_f32", _F32_ARGTYPES)
    rc = fn(x.data_ptr(), _ptr(seq_bias), ln1.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), ln2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), mask.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
            out.data_ptr(), b, s, w1.shape[0], int(causal), softmax_scale(d, n_heads),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "float32 layer")
    counter.launches += 1
    counter.float32_launches += 1
    return out


@torch.library.custom_op("deepsvg::layer_long", mutates_args=())
def _layer_long_op(x: torch.Tensor, seq_bias: torch.Tensor | None, ln1: torch.Tensor,
                   wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                   ln2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, mask: torch.Tensor, n_heads: int,
                   causal: bool) -> torch.Tensor:
    return layer_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                           n_heads, causal)


_layer_long_op.register_fake(_layer_fake)


@_layer_long_op.register_kernel("cuda")
def _(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, n_heads, causal):
    """The long form: the bfloat16 ``wgmma`` kernels, or the older code at
    the widths :func:`layer_form` names ``"narrow"`` / ``"narrow_long"``."""
    check_layer_inputs(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       n_heads, MAX_SEQ_LONG)
    b, s, d = x.shape
    narrow = not layer_form(x.dtype, d, w1.shape[0], n_heads, s).startswith("bf16")
    dev = x.device
    out = torch.empty_like(x)
    if b == 0:
        return out
    qkv = torch.empty((b * s, 3 * d), dtype=x.dtype, device=dev)
    fn = _build.kernel_function("dsvg_layer_long", _LONG_ARGTYPES)
    rc = fn(x.data_ptr(), _ptr(seq_bias), ln1.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln2.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            mask.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, s, d, w1.shape[0], n_heads,
            int(causal), int(x.dtype == torch.float32), softmax_scale(d, n_heads),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "long layer")
    if narrow:
        fused_layer_long.narrow_launches += 1
        fused_layer_long.narrow_float32_launches += x.dtype == torch.float32
    else:
        fused_layer_long.launches += 1
    return out


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
