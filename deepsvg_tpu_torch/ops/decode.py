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

Kernel note (``csrc/decode_cluster.cu``; other widths ``csrc/decode.cu``).
Replaces the Pallas kernel ``deepsvg_tpu/ops/decode.py:_decode_kernel``
(wrapper ``fused_decode_step``). On the H100 a step is bound by reading the
caches: at R = 1024 rows, L = 4, D = 256 and ``index`` = 120 it must read 2 x
4 x 1024 x 120 x 256 x 2 bytes = 503 MB, 0.15 ms at 3.35 TB/s, against 4.3
GFLOP of products (4 us on the tensor cores). The Pallas kernel reads the
whole cache length T every step; this one reads only the positions before
``index``.

How the data reach the SMs, at the flagship's width (D = 256, 8 heads;
:func:`decode_launch_plan`):

- *The caches*: a block owns 8 rows and every head, 16 warps; a warp
  streams one (row, head) pair's ``[index, 32]`` key and value slices with
  evict-first 16-byte loads, four lanes a position, four rounds of eight
  positions in flight (two in float32), folded into an online softmax.
  R = 1,024 is 128 blocks, one an SM.
- *The weights*: two blocks form a thread block cluster and split every
  product by its output columns: for the cluster's 16 rows, block c
  computes columns c*128 .. c*128 + 127 of each 256-column slab, so it
  reads half of the weight stack from L2 each step (2.1 MB in bfloat16,
  where every block of the older kernel read all 4.2 MB with ``wmma``
  fragment loads and few loads in flight). Its weight rows arrive through a
  TMA ring of 16 KB stages (128 rows x 128 bytes) that runs ahead across
  products and layers; the products run on ``mma.sync`` (TF32 in float32)
  from the swizzled stages. The two blocks exchange rows through
  distributed shared memory: each writes its rows of a product's input (the
  LN output, the context) into both blocks, each product's outputs go to
  the block that owns the row, the FF hidden to both; seven cluster
  barriers a layer.

An H100 holds 66 such clusters at once, so the decode's 1,024 rows run in
one wave. Other widths run the older kernel (``csrc/decode.cu``: a block of
8 rows with every head, its weights read from L2 by each block), counted
apart (``narrow_launches``), with the head dim (32, 16 or 8) a template
parameter: a cached position takes 4, 2 or 1 lanes of a warp, 8, 16 or 32
positions a warp load.

A float32 model takes the float32 forms: float32 activations, weights and
caches, the products in TF32. Its caches are twice the bytes: 1,007 MB a
step at ``index`` 120, 0.30 ms at 3.35 TB/s.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .layer import _layer_norm_f32, _mm, head_dim, softmax_scale

MAX_D = 256       # the older kernel's widest row
BLOCK_ROWS, CLUSTER = 8, 2   # csrc/decode_cluster.cu: ROWS, CLUSTER (blocks splitting the columns)
RING_STAGES = {torch.bfloat16: 8, torch.float32: 6}   # its weight ring: stages of
STAGE_BYTES = 16384                                   # 128 weight rows x 128 bytes
MAX_F = 1024
SMEM_LIMIT = 232448          # shared memory a block can use on the H100


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def decode_launch_plan(r: int, d: int, f: int, n_heads: int, dtype, wave: int = 0) -> dict:
    """How the cluster kernel (``csrc/decode_cluster.cu``) launches a step
    of R rows at width D, FF width F, ``n_heads`` heads of 32 and activation
    type ``dtype``, where one wave of the card holds ``wave`` clusters
    (:func:`cluster_wave`; 0: unknown, ``waves`` None): a
    block of ``block_rows`` rows with every head, ``cluster`` blocks
    splitting each product's columns, the ``grid`` (the blocks, padded to
    whole clusters), the block's shared-memory bytes (``smem``; the kernel
    refuses other counts) and the ``waves``. ``takes`` is False where the
    kernel does not take the widths (D = 256 with 8 heads, F a multiple of
    256 up to 1024); the older kernel runs then."""
    esz = dtype.itemsize
    pad, pair = 16 // esz, BLOCK_ROWS * CLUSTER
    stages = RING_STAGES[dtype]
    smem = (stages * STAGE_BYTES + BLOCK_ROWS * d * 4 * 5           # residual, QKV, output
            + 2 * _round_up(pair * (d + pad) * esz, 128)            # LN output, context
            + _round_up(pair * (f + pad) * esz, 128) + 2 * stages * 8 + 1024)
    clusters = -(-r // pair)
    takes = (d == 256 and n_heads == 8 and f > 0 and f % 256 == 0 and f <= MAX_F
             and smem <= SMEM_LIMIT and r >= 1)
    return {"block_rows": BLOCK_ROWS, "cluster": CLUSTER, "clusters": clusters,
            "grid": clusters * CLUSTER, "smem": smem,
            "waves": -(-clusters // wave) if wave else None, "takes": takes}


def decode_form(d: int, f: int, n_heads: int, dtype) -> str:
    """The kernel K9 runs a step on, from its widths alone: ``"cluster"``
    where :func:`decode_launch_plan` takes them (D=256, 8 heads of 32),
    else ``"narrow"``, the older kernel of ``csrc/decode.cu`` at head dim
    32, 16 or 8 (a template parameter: 4, 2 or 1 lanes a cached position).
    Raises on any other widths, naming the limit."""
    _build.kernel_dtype(torch.empty((), dtype=dtype), "x")
    head_dim(d, n_heads)
    if d > MAX_D or d % 32 or f % 32 or f < 32:
        raise ValueError(f"decode kernel takes D <= {MAX_D} and D, F multiples of 32; got "
                         f"D={d}, heads={n_heads}, F={f}")
    return "cluster" if _cluster_smem(d, f, n_heads, dtype) else "narrow"


@functools.lru_cache(maxsize=None)
def _cluster_smem(d: int, f: int, n_heads: int, dtype) -> int:
    """The cluster kernel's shared-memory bytes at these widths, 0 where it
    does not take them: :func:`decode_launch_plan` once per widths, not once
    a step."""
    plan = decode_launch_plan(1, d, f, n_heads, dtype)
    return plan["smem"] if plan["takes"] else 0


def cluster_wave(dtype) -> int:
    """The clusters of the cluster kernel that one wave of this card holds
    at one block an SM (``cudaOccupancyMaxActiveClusters``)."""
    fn = _build.kernel_function("dsvg_decode_cluster_wave", [ctypes.c_int])
    n = fn(int(dtype == torch.float32))
    if n < 1:
        raise RuntimeError("cudaOccupancyMaxActiveClusters failed for the decode kernel")
    return n


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
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 9
                     + [ctypes.c_float, ctypes.c_void_p])


def fused_decode_step(x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s, b1s, w2s, b2s,
                      lnf, kcache, vcache, key_pad, index: int, n_heads: int):
    """One token through the decoder stack: ``(y [R, D], k_new [L, R, D],
    v_new [L, R, D])``. The caches are read, not written: the caller writes
    ``k_new`` / ``v_new`` at ``index``.

    The operator ``deepsvg::decode_step``: a CPU tensor takes
    :func:`decode_step_reference`; a CUDA tensor launches the kernel
    (activations, weights and caches all bfloat16 or all float32, head dim
    32, 16 or 8, D <= 256 and D, F multiples of 32) or raises: the cluster
    kernel where :func:`decode_launch_plan` takes the widths, else the older
    one (counted under ``narrow_launches``; :func:`decode_form` names the
    kernel).
    """
    _build.check_device(x, "decode")
    tensors = (x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s, b1s, w2s, b2s, lnf,
               kcache, vcache, key_pad)
    if _build.plain(*tensors):
        return decode_step_reference(*tensors, index, n_heads)
    return torch.ops.deepsvg.decode_step(*tensors, index, n_heads)


fused_decode_step.launches = 0            # every launch
fused_decode_step.float32_launches = 0    # those of its float32 form
fused_decode_step.cluster_launches = 0    # those of the cluster kernel (both types)
fused_decode_step.narrow_launches = 0     # those of the older kernel (other widths)
fused_decode_step.narrow_float32_launches = 0   # of those, the float32 ones


@torch.library.custom_op("deepsvg::decode_step", mutates_args=())
def _decode_step_op(x: torch.Tensor, seq_bias: torch.Tensor, ln1s: torch.Tensor,
                    wqkvs: torch.Tensor, bqkvs: torch.Tensor, wos: torch.Tensor,
                    bos: torch.Tensor, ln2s: torch.Tensor, w1s: torch.Tensor,
                    b1s: torch.Tensor, w2s: torch.Tensor, b2s: torch.Tensor,
                    lnf: torch.Tensor, kcache: torch.Tensor, vcache: torch.Tensor,
                    key_pad: torch.Tensor, index: int,
                    n_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return decode_step_reference(x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s, b1s,
                                 w2s, b2s, lnf, kcache, vcache, key_pad, index, n_heads)


@_decode_step_op.register_fake
def _(x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s, b1s, w2s, b2s, lnf, kcache,
      vcache, key_pad, index, n_heads):
    new = x.new_empty((kcache.shape[0],) + tuple(x.shape))
    return torch.empty_like(x), new, torch.empty_like(new)


@_decode_step_op.register_kernel("cuda")
def _(x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s, b1s, w2s, b2s, lnf, kcache,
      vcache, key_pad, index, n_heads):
    dev = x.device
    n_layers, r, t, d = kcache.shape
    f = w1s.shape[1]
    dt = _build.kernel_dtype(x, "x")
    form = decode_form(d, f, n_heads, dt)
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
    ptrs = [t_.data_ptr() for t_ in (x, seq_bias, ln1s, wqkvs, bqkvs, wos, bos, ln2s, w1s,
                                     b1s, w2s, b2s, lnf, kcache, vcache, key_pad, y, k_new,
                                     v_new)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_f32 = int(dt == torch.float32)
    scale = softmax_scale(d, n_heads)
    if form == "cluster":
        fn = _build.kernel_function("dsvg_decode_cluster", _CLUSTER_ARGTYPES)
        rc = fn(*ptrs, r, t, d, f, n_heads, n_layers, index, is_f32,
                _cluster_smem(d, f, n_heads, dt), scale, stream)
        _build.check_launch(rc, "decode_cluster")
        fused_decode_step.cluster_launches += 1
    else:
        fn = _build.kernel_function("dsvg_decode_step", _ARGTYPES)
        rc = fn(*ptrs, r, t, d, f, n_heads, n_layers, index, is_f32, scale, stream)
        _build.check_launch(rc, "decode")
        fused_decode_step.narrow_launches += 1
        fused_decode_step.narrow_float32_launches += is_f32
    fused_decode_step.launches += 1
    fused_decode_step.float32_launches += is_f32
    return y, k_new, v_new
