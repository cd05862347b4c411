"""Fused argument-head softmax cross-entropy: kernels K5 and K8 and their
plain versions.

The argument head expands the decoder states ``[R, D]`` to ``[R, 11, 257]``
logits, the largest tensor of the training step. This op computes the
per-token, per-slot cross-entropy ``[R, 11]`` straight from
``(y, Wa, ba, targets)``: the forward never stores the logits and the
backward recomputes them tile by tile.

Kernel note (``csrc/ce.cu``, shared Hopper primitives in ``csrc/hopper.cuh``).
Replaces the Pallas kernels ``deepsvg_tpu/ops/ce.py:_fwd_kernel`` and
``_bwd_kernel`` (wrapper ``args_ce``). The bound is the tensor cores: at the
flagship's B=128 (R = 128*8*31 = 31,744 rows) the forward is 2*R*256*2827 =
45.9 GFLOP, 0.04646 ms at 989 TFLOP/s bf16, and the backward three such
products (logits again, dy, dW), 0.1394 ms; the bytes (y, dy, the head, its
float32 gradient) are 37 MB, 0.011 ms. The float32 form multiplies in TF32 at
495 TFLOP/s.

Design (``wgmma`` for ``sm_90a``). Each kernel is a persistent grid of
blocks of two consumer warpgroups and one producer warp. The producer streams
the operands with TMA into a ring of shared-memory stages guarded by
``mbarrier``s; the consumers multiply them with ``wgmma`` into registers. The
head is packed per slot to a multiple of a 256-byte chunk of columns (128 in
bf16, 64 in float32; 257 classes -> 384 / 320 columns, 512 -> 512), its
bias float32 with -inf in the padded columns, so they fall out of the
softmax unmasked. The forward's unit of work is (128 rows, slot), a
warpgroup's 64 rows against every column of a chunk: the logits stay in the
accumulators, and a running (max, sum of exp) per row is taken there with
quad shuffles. The backward's ``dy`` kernel walks every slot's chunks for 64
rows, each warpgroup one 128-byte column slice of a chunk:
``dlg = (softmax - onehot) * g``, rounded to the activation type, is staged
as the A operand of ``dy += dlg @ W_chunk``. Its ``dW`` kernel owns a chunk
and walks a split of the rows: ``dW^T += y^T @ dlg``, ``db`` beside it, each
split's partial sums written unpadded and added in a fixed order (no
atomics; equal to the bit from run to run). In bf16 both backward products
read the head chunk and the states as they already lie in shared memory,
through transposed (MN-major) descriptors. TF32 ``wgmma`` takes K-major
operands only, so the float32 form reads the head and the states transposed
as well, the copies made here, and its operands are rounded to TF32 here (to
nearest, as the ``wmma`` form rounded them), ``dlg`` in the kernel; the plain
version multiplies in full float32.

Targets outside ``[0, vocab)`` match no class: the row's loss is its
log-sum-exp and its gradient the plain softmax, as with the one-hot of the
Pallas kernel.

Kernel note, K8 (``csrc/ce.cu``, ``ce_pairwise``). Replaces
``deepsvg_tpu/ops/ce.py:_pairwise_kernel`` (wrapper ``args_ce_pairwise``):
the self-match cost, each row's argument CE against G candidate target rows,
forward only (the matching runs under ``no_grad``). It is K5's forward
kernel with G targets: each candidate's logit is taken by the thread that
holds its column, so a variant's columns equal K5's forward on its targets to
the bit. At the self-match recipe (B=60: R = 60*8*31 = 14,880 rows, G = 8)
the products are 2*R*256*2827 = 21.5 GFLOP, 0.022 ms at the bf16 peak; the
bytes (y, the head, the targets and the ``[R, 88]`` float32 output) are about
20 MB, 0.006 ms: the bound is the tensor cores. The targets keep the JAX
contract, one row of G*11 per state row, so the caller broadcasts the
``[N, S, G*11]`` targets over the P proposals (5.2 MB at the recipe) and
the kernel reads them once per row.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .layer import to_tf32
from .layer_vjp import reduce_partials


def args_ce_reference(y, wa, ba, targets, n_args: int):
    """Plain version of :func:`args_ce` (differentiable) and, with V > 1, of
    :func:`args_ce_pairwise`: ``y [R, D]``, ``wa [n_args*vocab, D]``, ``ba``
    as they are used (already cast), ``targets [R, V*n_args]`` int (V
    candidate target rows, variant-major) -> ``[R, V*n_args]`` float32. The
    gradient of the logits is rounded to ``y``'s type before it reaches ``y``
    and ``wa``, as the kernel rounds it."""
    r = y.shape[0]
    vocab = wa.shape[0] // n_args
    logits = torch.matmul(y.float(), wa.float().t()).reshape(r, 1, n_args, vocab)
    logits = _RoundGrad.apply(logits, y.dtype) + ba.float().reshape(n_args, vocab)
    lse = torch.logsumexp(logits, dim=-1)                                # [R, 1, n_args]
    t = targets.to(torch.int64).reshape(r, -1, n_args)
    valid = (t >= 0) & (t < vocab)
    tl = logits.expand(t.shape + (vocab,)).gather(-1, t.clamp(0, vocab - 1)[..., None])[..., 0]
    return (lse - torch.where(valid, tl, torch.zeros_like(tl))).reshape(targets.shape)


class _RoundGrad(torch.autograd.Function):
    """Identity whose gradient is rounded to ``dtype`` (and back)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 6 + [_I] * 6 + [_P]
_PAIRWISE_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]
_DY_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]
_DW_ARGTYPES = [_P] * 2 + [_I] + [_P] * 7 + [_I] * 7 + [_P]
_PACK_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]
ROW_TILE = 64           # rows of a work item of the kernels


def _check_types(what: str, y_dtype, weight_dtype) -> None:
    """Raise unless the states and the head are both bfloat16 or both float32."""
    if y_dtype not in _build.KERNEL_DTYPES or weight_dtype != y_dtype:
        raise ValueError(f"the {what} kernel takes states and head both bfloat16 or both "
                         f"float32, got states of dtype {y_dtype} and head of dtype "
                         f"{weight_dtype}")


def _check_width(what: str, d: int) -> None:
    if d % 32 or d > 256:
        raise ValueError(f"the {what} kernel takes D a multiple of 32 up to 256, got {d}")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def chunk_columns(dtype) -> int:
    """Columns of the kernels' head chunk: 256 bytes of a row of D."""
    return 256 // dtype.itemsize


def pack_args_head(wa, ba, n_args: int, dtype):
    """``wa [n_args*vocab, D]``, ``ba`` (CUDA) -> the head as the kernels read
    it: each slot padded to a multiple of :func:`chunk_columns`, ``[n_args*awp,
    D]`` in ``dtype`` (float32 rounded to TF32) with zero rows, and its bias
    ``[n_args*awp]`` in float32 (the values in ``dtype``) with -inf in the
    padded columns. One launch of a packing kernel."""
    vocab, d = wa.shape[0] // n_args, wa.shape[1]
    awp = _round_up(vocab, chunk_columns(dtype))
    wa = wa.detach().to(torch.float32).contiguous()
    ba = ba.detach().to(torch.float32).contiguous()
    w = torch.empty((n_args * awp, d), dtype=dtype, device=wa.device)
    b = torch.empty(n_args * awp, dtype=torch.float32, device=wa.device)
    fn = _build.kernel_function("dsvg_ce_pack_head", _PACK_ARGTYPES)
    _build.check_launch(fn(wa.data_ptr(), ba.data_ptr(), w.data_ptr(), b.data_ptr(), n_args,
                           vocab, awp, d, int(dtype == torch.float32),
                           torch.cuda.current_stream(wa.device).cuda_stream), "ce_pack_head")
    return w, b


def _kernel_states(y):
    """``y`` as the kernels read it: contiguous, float32 rounded to TF32."""
    y = y.detach().contiguous()
    return to_tf32(y) if y.dtype == torch.float32 else y


def dw_splits(chunks: int, row_tiles: int, sms: int) -> int:
    """Row splits of the dW kernel: its work items are (chunk, split), and
    the fewest splits that fill 90% of the waves on ``sms`` SMs (else the
    fullest within 16) keep the partial sums small."""
    best, best_fill = 1, 0.0
    for s in range(1, min(16, max(1, row_tiles)) + 1):
        items = chunks * s
        fill = items / (-(-items // sms) * sms)
        if fill >= 0.9:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


class _ArgsCE(torch.autograd.Function):
    """K5 on CUDA tensors."""

    @staticmethod
    def forward(ctx, y, wa, ba, targets, n_args, weight_dtype):
        dev = y.device
        r, d = y.shape
        vocab = wa.shape[0] // n_args
        dt = y.dtype
        _check_types("cross-entropy", dt, weight_dtype)
        _check_width("cross-entropy", d)
        y = _kernel_states(y)
        w, b = pack_args_head(wa, ba, n_args, dt)
        tgt = targets.to(torch.int32).contiguous()
        _build.require(y, "y", dev, dt, (r, d))
        _build.require(tgt, "targets", dev, torch.int32, (r, n_args))
        ce = torch.empty((r, n_args), dtype=torch.float32, device=dev)
        lse = torch.empty_like(ce)
        if r > 0:
            fn = _build.kernel_function("dsvg_ce_fwd", _FWD_ARGTYPES)
            rc = fn(y.data_ptr(), w.data_ptr(), b.data_ptr(), tgt.data_ptr(),
                    ce.data_ptr(), lse.data_ptr(), r, d, n_args, vocab, w.shape[0] // n_args,
                    int(dt == torch.float32), torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(rc, "ce_fwd")
            args_ce.launches += 1
            args_ce.float32_launches += dt == torch.float32
        ctx.save_for_backward(y, w, b, tgt, lse)
        ctx.meta = (n_args, vocab)
        return ce

    @staticmethod
    def backward(ctx, g):
        y, w, b, tgt, lse = ctx.saved_tensors
        n_args, vocab = ctx.meta
        dev = y.device
        r, d = y.shape
        awp = w.shape[0] // n_args
        is_f32 = int(y.dtype == torch.float32)
        if r == 0:
            return (torch.zeros_like(y), torch.zeros((n_args * vocab, d), device=dev),
                    torch.zeros(n_args * vocab, device=dev), None, None, None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        g = g.to(torch.float32).contiguous()
        # TF32 products read their operands K-major only, so the float32 form
        # takes the head [D, n_args*awp] and the states [D, R] (rows padded
        # to 16 bytes) the other way round too; bf16 reads them transposed
        wt = yt = None
        rp = _round_up(r, 8)
        if is_f32:
            wt = w.t().contiguous()
            yt = torch.empty((d, rp), dtype=y.dtype, device=dev)
            yt[:, :r] = y.t()
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        dy = torch.empty_like(y)
        fn = _build.kernel_function("dsvg_ce_bwd_dy", _DY_ARGTYPES)
        _build.check_launch(fn(y.data_ptr(), w.data_ptr(), ptr(wt), b.data_ptr(),
                               tgt.data_ptr(), g.data_ptr(), lse.data_ptr(), dy.data_ptr(),
                               r, d, n_args, vocab, awp, is_f32, stream), "ce_bwd_dy")
        args_ce.backward_launches += 1
        args_ce.float32_backward_launches += is_f32
        chunks = n_args * awp // chunk_columns(y.dtype)
        splits = dw_splits(chunks, -(-r // ROW_TILE),
                           torch.cuda.get_device_properties(dev).multi_processor_count)
        cols = n_args * vocab
        dw_part = torch.empty((splits, cols * d), dtype=torch.float32, device=dev)
        db_part = torch.empty((splits, cols), dtype=torch.float32, device=dev)
        fn = _build.kernel_function("dsvg_ce_bwd_dw", _DW_ARGTYPES)
        _build.check_launch(fn(y.data_ptr(), ptr(yt), rp, w.data_ptr(), b.data_ptr(),
                               tgt.data_ptr(), g.data_ptr(), lse.data_ptr(), dw_part.data_ptr(),
                               db_part.data_ptr(), r, d, n_args, vocab, awp, splits, is_f32,
                               stream), "ce_bwd_dw")
        if splits > 1:
            dw_part, db_part = reduce_partials(dw_part)[None], reduce_partials(db_part)[None]
        return dy, dw_part[0].view(cols, d), db_part[0], None, None, None


def args_ce_pairwise_reference(y, wa, ba, targets, n_variants: int):
    """Plain version of :func:`args_ce_pairwise` in its contract: ``y [R,
    D]``, ``wa [n_args*vocab, D]``, ``ba`` as they are used, ``targets [R,
    n_variants*n_args]`` int (variant-major) -> ``[R, n_variants*n_args]``
    float32, ``lse - logit[target]`` (a target outside ``[0, vocab)``
    matches no class)."""
    return args_ce_reference(y, wa, ba, targets, targets.shape[-1] // n_variants)


def plain_args_ce_pairwise(y, wa, ba, targets, n_variants: int, weight_dtype=None):
    """:func:`args_ce_pairwise` through the plain version, on any device."""
    weight_dtype = weight_dtype or y.dtype
    with torch.no_grad():
        ce = args_ce_pairwise_reference(y.reshape(-1, y.shape[-1]), wa.to(weight_dtype),
                                        ba.to(weight_dtype),
                                        targets.reshape(-1, targets.shape[-1]), n_variants)
    return ce.reshape(targets.shape)


def args_ce_pairwise(y, wa, ba, targets, n_variants: int, weight_dtype=None):
    """Pairwise argument-head cross-entropy ``[..., n_variants*n_args]``
    (float32) of ``y [..., D]`` against ``n_variants`` candidate target rows
    per row (``targets [..., n_variants*n_args]``, variant-major, classes in
    ``[0, vocab)``); ``wa [n_args*vocab, D]``, ``ba`` are the master
    parameters, cast to ``weight_dtype`` at use. No gradient.

    A CPU tensor takes :func:`args_ce_pairwise_reference`; a CUDA tensor
    launches K8 (states and head both bfloat16 or both float32) or raises.
    """
    if y.device.type == "cpu":
        return plain_args_ce_pairwise(y, wa, ba, targets, n_variants, weight_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"no pairwise cross-entropy kernel for device {y.device}")
    dev = y.device
    d, k = y.shape[-1], targets.shape[-1]
    n_args = k // n_variants
    vocab = wa.shape[0] // n_args
    dt = y.dtype
    _check_types("pairwise cross-entropy", dt, weight_dtype or dt)
    _check_width("pairwise cross-entropy", d)
    if k != n_variants * n_args or targets.shape[:-1] != y.shape[:-1]:
        raise ValueError(f"targets {tuple(targets.shape)} do not fit y {tuple(y.shape)} and "
                         f"{n_variants} variants of {n_args} slots")
    with torch.no_grad():
        yf = _kernel_states(y.reshape(-1, d))
        r = yf.shape[0]
        w, b = pack_args_head(wa, ba, n_args, dt)
        tgt = targets.reshape(r, k).to(torch.int32).contiguous()
        _build.require(yf, "y", dev, dt, (r, d))
        _build.require(tgt, "targets", dev, torch.int32, (r, k))
        ce = torch.empty((r, k), dtype=torch.float32, device=dev)
        if r > 0:
            fn = _build.kernel_function("dsvg_ce_pairwise", _PAIRWISE_ARGTYPES)
            rc = fn(yf.data_ptr(), w.data_ptr(), b.data_ptr(), tgt.data_ptr(), ce.data_ptr(), r,
                    d, n_args, vocab, w.shape[0] // n_args, n_variants,
                    int(dt == torch.float32), torch.cuda.current_stream(dev).cuda_stream)
            _build.check_launch(rc, "ce_pairwise")
            args_ce_pairwise.launches += 1
            args_ce_pairwise.float32_launches += dt == torch.float32
    return ce.reshape(targets.shape)


args_ce_pairwise.launches = 0            # every launch
args_ce_pairwise.float32_launches = 0    # those of its float32 form


def plain_args_ce(y, wa, ba, targets, weight_dtype=None):
    """:func:`args_ce` through the plain version, on any device."""
    weight_dtype = weight_dtype or y.dtype
    n_args = targets.shape[-1]
    ce = args_ce_reference(y.reshape(-1, y.shape[-1]), wa.to(weight_dtype),
                           ba.to(weight_dtype), targets.reshape(-1, n_args), n_args)
    return ce.reshape(y.shape[:-1] + (n_args,))


def args_ce(y, wa, ba, targets, weight_dtype=None):
    """Per-token, per-slot cross-entropy ``[..., n_args]`` (float32) of the
    argument head ``wa [n_args*vocab, D]``, ``ba`` (``nn.Linear`` layout, the
    master parameters, cast to ``weight_dtype`` at use) applied to
    ``y [..., D]``, against integer ``targets [..., n_args]`` in
    ``[0, vocab)``. Differentiable in ``y``, ``wa``, ``ba``.

    A CPU tensor takes :func:`args_ce_reference` under autograd; a CUDA
    tensor launches the kernels (states and head both bfloat16 or both
    float32) or raises.
    """
    if y.device.type == "cpu":
        return plain_args_ce(y, wa, ba, targets, weight_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"no cross-entropy kernel for device {y.device}")
    n_args = targets.shape[-1]
    ce = _ArgsCE.apply(y.reshape(-1, y.shape[-1]), wa, ba, targets.reshape(-1, n_args),
                       n_args, weight_dtype or y.dtype)
    return ce.reshape(y.shape[:-1] + (n_args,))


args_ce.launches = 0                    # forward launches
args_ce.backward_launches = 0           # backward passes (dy, dW, the reductions)
args_ce.float32_launches = 0            # those of the float32 form
args_ce.float32_backward_launches = 0
