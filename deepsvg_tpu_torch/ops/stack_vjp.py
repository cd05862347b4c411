"""A fused stack of L training layers: kernel K7 and its plain version.

The short-sequence stages of the hierarchical model (E2 over the path
latents, D2 over the group queries: S = 8) run their L layers as one forward
and one backward. Each layer is exactly K4 (``ops/layer_vjp.py``) with the
dropout seed :func:`~.dropout.stack_layer_seed` ``(seed, l)``: with rate 0
the stack equals L successive :func:`~.layer_vjp.fused_layer_train` calls,
and with dropout on, layer l drops what K4 with that seed drops. So the plain
version is a loop of :func:`~.layer_vjp.layer_train_reference` over the
layers, and kernel and plain version compare element by element, dropout on.

Arguments are K4's, stacked: ``ln1 [L, 2, D]``, ``wqkv [L, 3D, D]``,
``bqkv [L, 3D]``, ``wo [L, D, D]``, ``bo [L, D]``, ``ln2 [L, 2, D]``,
``w1 [L, F, D]``, ``b1 [L, F]``, ``w2 [L, D, F]``, ``b2 [L, D]`` (float32
masters, cast at use) and ``seq_bias [L, B, D]``, each layer's per-sequence
injection with its dropout already applied (zeros at E2, the latent's
``glob`` per layer at D2). Gradients flow to x, ``seq_bias`` and every
stacked weight, the weights' in float32.

Kernel note (``csrc/stack_cluster.cu``; the weight products in ``wgrad.cu``
and ``layer_f32_bwd.cu``). Replaces the Pallas kernels
``deepsvg_tpu/ops/stack_vjp.py:_stack_fwd_kernel`` and ``_stack_bwd_kernel``
(wrapper ``fused_stack_train``), whose sequential ``(L,)`` grid carried the
activation in VMEM. On the H100 the work is small: at the flagship's recipe
batch (B=60, S=8, D=256, F=512, L=4) a layer is about 0.5 GFLOP forward and
twice that backward, a few microseconds at 989 TFLOP/s, and its weights 1 MB
(bf16). What bounds a kernel that small is how much of the card it keeps
busy, and how long its warps wait on weights from L2:

- *Forward*, one launch for the stack, on thread block clusters: a tile of
  whole sequences (32 rows in bf16, 16 in float32) is a cluster of H blocks,
  block h owning head h and 1/H of every product's output columns, the
  slices exchanged through distributed shared memory. The tile keeps its
  residual stream in shared memory through the L layers and writes what the
  backward reads. At B=60 the grid is 15 x 8 blocks in bf16 and 30 x 8 in
  float32 (:func:`stack_launch_plan`); each block streams only its weight
  slices, through a ring of asynchronous copies that runs ahead across
  layers.
- *Backward*, three launches: the row-local part of all L layers in reverse
  on the same clusters (the gradient between layers kept in shared memory),
  writing each layer's rounded product operands and per-tile column sums;
  one launch of the Hopper weight-gradient kernel for all 4 L products
  (``wgrad_hopper_kernel`` in bf16, ``wgrad_tf32_kernel`` in float32, the
  rows unsplit); one fixed-order reduction of the column sums. No atomics:
  the gradients are bit-identical from run to run.

Widths the cluster kernels do not take (head dims 8 and 16, F not a
multiple of D, or a block over 227 KB of shared memory) run the older
kernels of ``csrc/stack.cu`` (the head dim a template parameter),
whose block of 64 (bf16) or 32 (float32) rows runs all L layers on K4's
``wmma`` tiles, with the older weight-product kernel where the products are
not multiples of 128 x 256: chosen from the shapes before the launch and
counted apart (``narrow_launches``). K4 through L layers takes 2 L forward
and 6 L backward launches; the stack takes 1 and 3.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .dropout import drop_threshold, keep_scale, stack_layer_seed
from .layer import HEAD_DIM, check_layer_inputs, head_dim, narrow_smem, softmax_scale
from .layer_vjp import (
    _WGRAD_ARGTYPES, _WGRAD_HOPPER_ARGTYPES, F32_MAX_SEQ, SMEM_LIMIT, WGRAD_MAX_SPLITS,
    WGRAD_ROWS_PER_SPLIT, _round_up, layer_train_reference, reduce_partials)

WEIGHT_NAMES = ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "w1", "b1", "w2", "b2")
MAX_LAYERS = 8               # the weight-gradient launch takes 32 products
TILE_ROWS = {torch.bfloat16: 32, torch.float32: 16}   # rows of a cluster's tile
RING_STAGES, RING_STAGE_BYTES = 4, 20480   # csrc/stack_cluster.cu: NS, STAGE
LAYER_VECTORS = 6 * 256      # a block's LN and bias values a layer: VEC_PER_THREAD x NTHREADS
_FWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 10
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 9
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_CLUSTER_FWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 10
                         + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_CLUSTER_BWD_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 9
                         + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _round128(n: int) -> int:
    return (n + 127) // 128 * 128


def stack_launch_plan(b: int, s: int, d: int, f: int, n_heads: int, dtype) -> dict:
    """How K7's cluster kernels launch for B sequences of S rows at width D,
    FF width F, ``n_heads`` heads (of 32, the only head dim they take) and
    activation type ``dtype``:
    ``tile_rows`` (whole sequences, ``seqs_per_tile`` of them), the
    ``cluster`` size (one block a head), the ``tiles`` and the ``grid`` (tiles
    x cluster blocks), and the shared-memory bytes of a forward and a
    backward block (``csrc/stack_cluster.cu``: FwdLayout, BwdLayout; the
    kernels refuse other byte counts). ``takes`` is False where the cluster
    kernels do not take the shape; the older kernels run then."""
    esz = torch.empty((), dtype=dtype).element_size()
    pad = 16 // esz                     # a 16-byte pad a row
    hd = d // n_heads
    rows = TILE_ROWS[dtype]
    ring = RING_STAGES * RING_STAGE_BYTES
    split = 2048 if rows == 16 else 0   # float32: the products' K halves added
    fwd = ring + split + sum(_round128(n) for n in (
        rows * d * 4, rows * d * 4, rows * (max(d, f) + pad) * esz, rows * (d + pad) * esz,
        rows * (3 * hd + pad) * esz,
        (4 * d + 5 * hd + f // n_heads) * 4))    # LN1, LN2 and the bias columns
    bwd = ring + split + sum(_round128(n) for n in (
        rows * d * 4, rows * d * 4, rows * (max(3 * d, f) + pad) * esz, rows * (d + pad) * esz,
        rows * (3 * hd + pad) * esz, rows * rows * esz, rows * (hd + pad) * esz,
        4096, 4 * d * esz))       # 4096: the column sums' partial sums
    seqs = max(rows // s, 1)
    tiles = -(-b // seqs)
    takes = (d == n_heads * HEAD_DIM and 2 <= n_heads <= 8 and d % 64 == 0 and f % 64 == 0
             and f % d == 0 and s <= rows and max(fwd, bwd) <= SMEM_LIMIT
             and 4 * d + 5 * hd + f // n_heads <= LAYER_VECTORS)
    return {"tile_rows": rows, "seqs_per_tile": seqs, "cluster": n_heads, "tiles": tiles,
            "grid": tiles * n_heads, "fwd_smem": fwd, "bwd_smem": bwd, "takes": takes}


def stack_form(b: int, s: int, d: int, f: int, n_heads: int, dtype) -> str:
    """The kernels K7 runs a stack on, from its shape alone: ``"cluster"``
    where :func:`stack_launch_plan` takes it (head dim 32), else
    ``"narrow"``, the older kernels of ``csrc/stack.cu`` at head dim 32, 16
    or 8 (a block of whole sequences, K4's older device code). Raises on any
    other shape, naming the limit: D and F multiples of 32 (the older weight
    products' warp tiles) with D <= 256, S <= 32 in bfloat16 and 16 in
    float32."""
    _build.kernel_dtype(torch.empty((), dtype=dtype), "x")
    head_dim(d, n_heads)
    if d % 32 or f % 32 or d > 256 or f < 32:
        raise ValueError(f"the stack kernel takes D, F multiples of 32 and D <= 256; "
                         f"got D={d}, F={f}")
    short = F32_MAX_SEQ if dtype == torch.float32 else TILE_ROWS[torch.bfloat16]
    if not 1 <= s <= short:
        raise ValueError(f"the {'float32' if dtype == torch.float32 else 'bfloat16'} stack "
                         f"kernel takes 1 <= S <= {short} (its backward tiles hold {short} "
                         f"rows), got S={s}")
    if stack_launch_plan(b, s, d, f, n_heads, dtype)["takes"]:
        return "cluster"
    smem = narrow_smem(dtype, s, d, f, n_heads, False)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the stack kernel at D={d}, F={f} needs {smem} bytes of shared "
                         f"memory a block, over the {SMEM_LIMIT} a block can use")
    return "narrow"


def stack_train_reference(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                          seed: int, n_heads: int, causal: bool = False, rate: float = 0.0,
                          relu_gates=None, round_grads: bool = False):
    """Plain version of the K7 forward (differentiable; the weights as they
    are used, already cast): layer l is :func:`layer_train_reference` with
    ``seq_bias[l]`` and the seed ``stack_layer_seed(seed, l)``.
    ``relu_gates [L, B, S, F]``: each layer's ``relu_gate``; ``round_grads``:
    the kernels' roundings of the gradients (diagnostics, see
    :func:`layer_train_reference`)."""
    for layer in range(ln1.shape[0]):
        weights = [w[layer] for w in (ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2)]
        x = layer_train_reference(x, seq_bias[layer], *weights, mask,
                                  stack_layer_seed(seed, layer), n_heads, causal, rate,
                                  None if relu_gates is None else relu_gates[layer],
                                  round_grads)
    return x


def plain_stack_train(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                      seed: int, n_heads: int, causal: bool = False, rate: float = 0.0,
                      weight_dtype=None, relu_gates=None, round_grads: bool = False):
    """:func:`fused_stack_train` through the plain version, on any device:
    the master weights cast to ``weight_dtype`` in the graph, then
    :func:`stack_train_reference` under autograd."""
    used = [w.to(weight_dtype or x.dtype) for w in (ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2)]
    return stack_train_reference(x, seq_bias, *used, mask, seed, n_heads, causal, rate,
                                 relu_gates, round_grads)


def kernel_relu_gates(out: torch.Tensor) -> torch.Tensor:
    """``[L, B, S, F]`` bool: the FF units that passed the ReLU in each layer
    of the kernel forward that made ``out`` (read from what it saved)."""
    hidden = out.grad_fn.saved_tensors[-1]
    return (hidden > 0).view(hidden.shape[0], out.shape[0], out.shape[1], -1)


def kernel_layer_inputs(out: torch.Tensor) -> list:
    """The input of each layer of the kernel forward that made ``out``: the
    stack's input, then each layer's output as the next layer read it (what
    the forward saved for the backward)."""
    x, xs, ln1 = out.grad_fn.saved_tensors[:3]
    return [x] + [xs[layer].view(x.shape) for layer in range(ln1.shape[0] - 1)]


def _check_stack_inputs(x, bias, used, mask, n_heads):
    """Raise unless K7 takes these CUDA tensors: each layer as K4 takes it
    (checked on layer 0's slices), every weight stacked over the same L."""
    n_layers = used[0].shape[0]
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"the stack kernel takes 1 <= L <= {MAX_LAYERS} layers, got {n_layers}")
    for name, w in zip(WEIGHT_NAMES, used):
        if w.shape[0] != n_layers:
            raise ValueError(f"{name} stacks {w.shape[0]} layers, ln1 {n_layers}")
    b, _, d = x.shape
    _build.require(bias, "seq_bias", x.device, x.dtype, (n_layers, b, d))
    check_layer_inputs(x, bias[0], *[w[0] for w in used], mask, n_heads)
    for name, w in zip(WEIGHT_NAMES, used):
        _build.require(w, name, x.device)


def _padded(n_layers: int, rows: int, width: int, dtype, dev) -> torch.Tensor:
    """``[L, round16(rows), width]`` with each layer's rows beyond ``rows``
    zero: the weight-gradient kernel reads whole 16-row fragments."""
    t = torch.empty((n_layers, _round_up(rows, 16), width), dtype=dtype, device=dev)
    if t.shape[1] > rows:
        t[:, rows:].zero_()
    return t


class _FusedStackTrain(torch.autograd.Function):
    """K7 on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                seed, n_heads, causal, rate, weight_dtype):
        dev, dt = x.device, x.dtype
        x = x.contiguous()
        used = [w.detach().to(weight_dtype).to(dt).contiguous()
                for w in (ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2)]
        bias = seq_bias.detach().to(dt).contiguous()
        mask = mask.to(torch.float32).contiguous()
        _check_stack_inputs(x, bias, used, mask, n_heads)
        n_layers = used[0].shape[0]
        b, s, d = x.shape
        f = used[6].shape[1]
        form = stack_form(b, s, d, f, n_heads, dt)
        plan = stack_launch_plan(b, s, d, f, n_heads, dt)
        rows = b * s
        out = torch.empty_like(x)
        xs = torch.empty((max(n_layers - 1, 1), rows, d), dtype=dt, device=dev)
        qkv_s = torch.empty((n_layers, rows, 3 * d), dtype=dt, device=dev)
        p_s = torch.empty((n_layers, b, n_heads, s, s), dtype=dt, device=dev)
        ctx_s = _padded(n_layers, rows, d, dt, dev)
        x1_s = torch.empty((n_layers, rows, d), dtype=torch.float32, device=dev)
        h_s = torch.empty((n_layers, rows, f), dtype=dt, device=dev)
        thr = drop_threshold(rate) if rate > 0.0 else 0
        kp = keep_scale(rate) if rate > 0.0 else 1.0
        if b > 0:
            tensors = (x, bias, *used, mask, out, xs, qkv_s, p_s, ctx_s, x1_s, h_s)
            ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
            stream = torch.cuda.current_stream(dev).cuda_stream
            args = (ptrs, n_layers, b, s, d, f, n_heads, int(causal), int(dt == torch.float32),
                    int(seed), thr, kp, softmax_scale(d, n_heads))
            if form == "cluster":
                fn = _build.kernel_function("dsvg_stack_cluster_fwd", _CLUSTER_FWD_ARGTYPES)
                _build.check_launch(fn(*args, plan["fwd_smem"], stream), "stack_cluster_fwd")
            else:
                fn = _build.kernel_function("dsvg_stack_train_fwd", _FWD_ARGTYPES)
                _build.check_launch(fn(*args, stream), "stack_train_fwd")
                fused_stack_train.narrow_launches += 1
                fused_stack_train.narrow_float32_launches += dt == torch.float32
            fused_stack_train.launches += 1
        ctx.save_for_backward(x, xs, *used, qkv_s, p_s, ctx_s, x1_s, h_s)
        ctx.meta = (n_heads, int(seed), thr, kp, seq_bias.dtype, plan)
        return out

    @staticmethod
    def backward(ctx, g):
        x, xs, ln1, wqkv, _, wo, _, ln2, w1, _, w2, _, qkv_s, p_s, ctx_s, x1_s, h_s = \
            ctx.saved_tensors
        n_heads, seed, thr, kp, bias_dtype, plan = ctx.meta
        dev, dt = x.device, x.dtype
        n_layers = ln1.shape[0]
        b, s, d = x.shape
        f = w1.shape[1]
        rows = b * s
        is_f32 = int(dt == torch.float32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        g = g.to(dt).contiguous()
        dx = torch.empty_like(x)
        dbias = torch.empty((n_layers, b, d), dtype=torch.float32, device=dev)
        n_small = 9 * d + f
        xn1_o, da_o, xn2_o, df_o = (_padded(n_layers, rows, d, dt, dev) for _ in range(4))
        dqkv_o = _padded(n_layers, rows, 3 * d, dt, dev)
        dhpre_o, hd_o = (_padded(n_layers, rows, f, dt, dev) for _ in range(2))
        operands = (xn1_o, dqkv_o, da_o, xn2_o, dhpre_o, hd_o, df_o)
        scalars = (seed, thr, kp, softmax_scale(d, n_heads))
        if plan["takes"]:
            small_part = torch.empty((plan["tiles"], n_layers * n_small), dtype=torch.float32,
                                     device=dev)
            tensors = (x, xs, g, ln1, wqkv, wo, ln2, w1, w2, qkv_s, p_s, x1_s, h_s, dx, dbias,
                       *operands, small_part)
            ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
            fn = _build.kernel_function("dsvg_stack_cluster_bwd", _CLUSTER_BWD_ARGTYPES)
            _build.check_launch(fn(ptrs, n_layers, b, s, d, f, n_heads, is_f32, *scalars,
                                   plan["bwd_smem"], stream), "stack_cluster_bwd")
        else:
            block_rows = _build.kernel_function("dsvg_layer_bwd_rows", [ctypes.c_int])(is_f32)
            blocks = -(-b // (block_rows // s))
            small_part = torch.empty((blocks, n_layers * n_small), dtype=torch.float32,
                                     device=dev)
            dcur = torch.empty((max(n_layers - 1, 1), rows, d), dtype=dt, device=dev)
            tensors = (x, xs, g, ln1, wqkv, wo, ln2, w1, w2, qkv_s, p_s, ctx_s, x1_s, h_s, dx,
                       dcur, dbias, *operands, small_part)
            ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
            fn = _build.kernel_function("dsvg_stack_train_bwd", _BWD_ARGTYPES)
            _build.check_launch(fn(ptrs, n_layers, b, s, d, f, n_heads, is_f32, *scalars,
                                   stream), "stack_train_bwd")
            fused_stack_train.narrow_backward_launches += 1
            fused_stack_train.narrow_float32_backward_launches += is_f32
        fused_stack_train.backward_launches += 1

        # dW = (output-side gradient)^T @ (input), nn.Linear layout [out, in];
        # all layers' products of one kind side by side, so that each kind
        # comes out as one [L, out, in] block
        kinds = ((dqkv_o, xn1_o), (da_o, ctx_s), (dhpre_o, xn2_o), (df_o, hd_o))
        dws = _stack_weight_products(
            [(a[layer], bb[layer]) for a, bb in kinds for layer in range(n_layers)],
            rows, is_f32, stream)
        dwqkv, dwo, dw1, dw2 = (
            w.view(n_layers, a.shape[2], bb.shape[2])
            for w, (a, bb) in zip(dws.split([n_layers * a.shape[2] * bb.shape[2]
                                             for a, bb in kinds]), kinds))
        small = reduce_partials(small_part).view(n_layers, n_small)
        dln1, dbqkv, dbo, dln2, db1, db2 = small.split([2 * d, 3 * d, d, 2 * d, f, d], dim=1)
        return (dx, dbias.to(bias_dtype), dln1.reshape(n_layers, 2, d), dwqkv, dbqkv, dwo,
                dbo, dln2.reshape(n_layers, 2, d), dw1, db1, dw2, db2,
                None, None, None, None, None, None)


def _stack_weight_products(problems, rows: int, is_f32: int, stream) -> torch.Tensor:
    """``A^T @ B`` in float32 for each ``(A [rows_pad, M], B [rows_pad, N])``
    of ``problems`` (rows beyond ``rows`` zero), flattened in order: one
    launch. Where every M is a multiple of 128 and every N of 256, the Hopper
    kernel (bfloat16 ``dsvg_wgrad_hopper``, float32 ``dsvg_wgrad_tf32``) over
    all rows unsplit, its column sums unread (the stack launch has them); else
    the older ``dsvg_wgrad``, split over the rows as K4 splits them, and a
    fixed-order reduction where it is split."""
    dev = problems[0][0].device
    sizes = [a.shape[1] * bb.shape[1] for a, bb in problems]
    arr = lambda ctype, vals: (ctype * len(vals))(*vals)  # noqa: E731
    a_ptrs = arr(ctypes.c_void_p, [a.data_ptr() for a, _ in problems])
    b_ptrs = arr(ctypes.c_void_p, [bb.data_ptr() for _, bb in problems])
    ms = arr(ctypes.c_int, [a.shape[1] for a, _ in problems])
    ns = arr(ctypes.c_int, [bb.shape[1] for _, bb in problems])
    if all(a.shape[1] % 128 == 0 and bb.shape[1] % 256 == 0 for a, bb in problems):
        sums = sum(a.shape[1] for a, _ in problems)
        part = torch.empty((1, sum(sizes) + sums), dtype=torch.float32, device=dev)
        name = "dsvg_wgrad_tf32" if is_f32 else "dsvg_wgrad_hopper"
        fn = _build.kernel_function(name, _WGRAD_HOPPER_ARGTYPES)
        _build.check_launch(fn(a_ptrs, b_ptrs, ms, ns, len(problems), rows,
                               _round_up(rows, 32 if is_f32 else 64), 1, part.data_ptr(),
                               stream), name)
        return part[0, :sum(sizes)]
    rows_pad = problems[0][0].shape[0]
    splits = max(1, min(WGRAD_MAX_SPLITS, rows_pad // WGRAD_ROWS_PER_SPLIT))
    per_split = _round_up(-(-rows_pad // splits), 16)
    part = torch.empty((splits, sum(sizes)), dtype=torch.float32, device=dev)
    fn = _build.kernel_function("dsvg_wgrad", _WGRAD_ARGTYPES)
    _build.check_launch(fn(a_ptrs, b_ptrs, ms, ns, len(problems), rows_pad, per_split, splits,
                           is_f32, part.data_ptr(), stream), "wgrad")
    return part[0] if splits == 1 else reduce_partials(part)


def fused_stack_train(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                      seed: int, n_heads: int, causal: bool = False, rate: float = 0.0,
                      weight_dtype=None):
    """L fused transformer layers, differentiable, with dropout ``rate``.

    Arguments as :func:`~.layer_vjp.fused_layer_train`, with every weight
    and ``seq_bias [L, B, D]`` stacked over the layers; ``seed`` is a host
    integer below 2**31, and layer l uses ``stack_layer_seed(seed, l)``.

    A CPU tensor takes :func:`stack_train_reference` under autograd; a CUDA
    tensor launches the kernels (bfloat16 activations with S <= 32, or
    float32 activations with S <= 16; head dim 32, 16 or 8, D and F
    multiples of 32, D <= 256, L <= 8; :func:`stack_form` names them) or
    raises.
    """
    weights = (ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return plain_stack_train(x, seq_bias, *weights, mask, seed, n_heads, causal, rate,
                                 weight_dtype)
    weight_dtype = weight_dtype or x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"no stack kernel for device {x.device}")
    return _FusedStackTrain.apply(x, seq_bias, *weights, mask, seed, n_heads, causal, rate,
                                  weight_dtype)


fused_stack_train.launches = 0            # forward launches (one per stack)
fused_stack_train.backward_launches = 0   # backward passes (three launches each)
fused_stack_train.narrow_launches = 0     # forward launches on the older kernels
fused_stack_train.narrow_backward_launches = 0   # and backward passes
fused_stack_train.narrow_float32_launches = 0    # of those, the float32 ones
fused_stack_train.narrow_float32_backward_launches = 0
