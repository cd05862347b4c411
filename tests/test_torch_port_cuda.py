"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips where
PyTorch sees no CUDA card. The file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Inputs are bfloat16 (or float32, for the float32 forms), made from a seed
with numpy, at small batches but the flagship's widths (D=256, 8 heads of
32, FF 512, 11 x 257 argument classes). Tolerances as in ``chip_smoke.py``:
the kernel rounds to bfloat16 at the same points as its plain version, but
sums in another order; a float32 form multiplies in TF32 against the plain
version's full float32.
"""
import numpy as np
import pytest
import torch

from deepsvg_tpu_torch.ops import attention as attn_ops
from deepsvg_tpu_torch.ops import attention_vjp
from deepsvg_tpu_torch.ops import ce as ce_ops
from deepsvg_tpu_torch.ops import decode as decode_ops
from deepsvg_tpu_torch.ops import embedding as emb_ops
from deepsvg_tpu_torch.ops import head as head_ops
from deepsvg_tpu_torch.ops import layer as layer_ops
from deepsvg_tpu_torch.ops import layer_vjp

pytestmark = pytest.mark.cuda

D, H, F_FF, N_ARGS, VOCAB, N_CMD = 256, 8, 512, 11, 257, 7
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bf16(rng, dev, *shape, scale=1.0):
    return torch.from_numpy(scale * rng.normal(size=shape).astype(np.float32)).to(dev, BF16)


@pytest.mark.parametrize("use_group", [False, True])
def test_embedding_kernel_matches_plain(cuda, use_group):
    rng = np.random.default_rng(0)
    b, s, n_group = 16, 32, 10
    commands = torch.from_numpy(rng.integers(0, N_CMD, (b, s)).astype(np.int32)).to(cuda)
    args = torch.from_numpy(rng.integers(-1, VOCAB - 1, (b, s, N_ARGS)).astype(np.float32)).to(cuda)
    groups = torch.from_numpy(rng.integers(0, n_group, (b, s)).astype(np.int32)).to(cuda)
    commands[1, 2], args[1, 3, 4], args[2, 1, 0], groups[3, 5] = N_CMD + 2, VOCAB + 5, -3, n_group
    inputs = (commands, args, groups, _bf16(rng, cuda, N_CMD, D),
              _bf16(rng, cuda, N_ARGS * VOCAB, D), _bf16(rng, cuda, n_group, D),
              _bf16(rng, cuda, s, D), use_group)
    before = emb_ops.fused_embedding.launches
    out = emb_ops.fused_embedding(*inputs)
    assert emb_ops.fused_embedding.launches == before + 1
    ref = emb_ops.embedding_reference(*inputs)
    assert out.dtype == BF16 and out.shape == (b, s, D)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2


def test_embedding_takes_the_teacher_forced_views(cuda):
    """The autoregressive decoder embeds its targets without their last
    position, ``commands[..., :-1]`` and ``args[..., :-1, :]``: views that
    are not contiguous. K1 forward (and K6 behind it) take them as the
    contiguous tensors they equal."""
    rng = np.random.default_rng(9)
    b, s, vocab = 6, 242, 512
    commands = torch.from_numpy(rng.integers(0, N_CMD, (b, s)).astype(np.int32)).to(cuda)
    args = torch.from_numpy(rng.integers(-1, vocab - 1, (b, s, N_ARGS)).astype(np.float32)).to(cuda)
    groups = torch.from_numpy(rng.integers(0, s, (b, s - 1)).astype(np.int32)).to(cuda)
    c_view, a_view = commands[:, :-1], args[:, :-1, :]
    assert not a_view.is_contiguous()
    tables = (_bf16(rng, cuda, N_CMD, D), _bf16(rng, cuda, N_ARGS * vocab, D),
              _bf16(rng, cuda, s, D), _bf16(rng, cuda, s - 1, D))
    got = emb_ops.fused_embedding(c_view, a_view, groups, *tables, True)
    want = emb_ops.fused_embedding(c_view.contiguous(), a_view.contiguous(), groups, *tables,
                                   True)
    assert torch.equal(got, want)
    dy = _bf16(rng, cuda, b, s - 1, D)
    grads = emb_ops.embedding_backward(c_view, a_view, groups, dy, N_CMD, vocab, s, True)
    ref = emb_ops.embedding_backward(c_view.contiguous(), a_view.contiguous(), groups, dy,
                                     N_CMD, vocab, s, True)
    for a, r in zip(grads, ref):
        assert (a - r).abs().max().item() <= 1e-5 * r.abs().max().item() + 1e-6


@pytest.mark.parametrize("s,b,seq_bias,causal", [
    (32, 12, False, False), (8, 12, False, False), (31, 12, True, False), (8, 12, True, False),
    (31, 12, True, True),
    # every S the bfloat16 kernel's 128-row tiles treat apart (1 to 128 whole
    # sequences a tile, query blocks of 16 rows spanning 1 to 3 sequences),
    # ragged last tiles, and a batch at which every persistent block loops
    (1, 5, False, False), (2, 5, True, True), (7, 5, True, False), (16, 1, True, True),
    (17, 5, False, False), (17, 12, True, True), (32, 1, False, True), (32, 4096, True, False),
])
def test_layer_kernel_matches_plain(cuda, s, b, seq_bias, causal):
    rng = np.random.default_rng(s + 2 * seq_bias + causal + b)
    ln = lambda: torch.stack([1 + _bf16(rng, cuda, D, scale=0.1),  # noqa: E731
                              _bf16(rng, cuda, D, scale=0.1)]).contiguous()
    weights = (ln(), _bf16(rng, cuda, 3 * D, D, scale=D ** -0.5), _bf16(rng, cuda, 3 * D, scale=0.1),
               _bf16(rng, cuda, D, D, scale=D ** -0.5), _bf16(rng, cuda, D, scale=0.1), ln(),
               _bf16(rng, cuda, F_FF, D, scale=D ** -0.5), _bf16(rng, cuda, F_FF, scale=0.1),
               _bf16(rng, cuda, D, F_FF, scale=F_FF ** -0.5), _bf16(rng, cuda, D, scale=0.1))
    x = _bf16(rng, cuda, b, s, D)
    bias = _bf16(rng, cuda, b, D) if seq_bias else None
    lengths = torch.from_numpy(rng.integers(1, s + 1, b)).to(cuda)
    lengths[0] = 0                                     # one fully masked sequence
    mask = torch.where(torch.arange(s, device=cuda)[None] < lengths[:, None], 0.0,
                       float("-inf")).to(torch.float32)
    inputs = (x, bias, *weights, mask, H, causal)
    out = layer_ops.fused_layer(*inputs).float()
    ref = layer_ops.layer_reference(*inputs).float()
    assert torch.isfinite(out).all()
    err = (out - ref).abs()
    # up to one bf16 step of the output, plus flipped intermediates
    assert (err <= 0.1 + 2.0 ** -7 * ref.abs()).all()
    assert (err.norm() / ref.norm()).item() <= 1e-3


def test_head_kernel_matches_plain(cuda):
    rng = np.random.default_rng(4)
    r = 1000                                            # not a multiple of the row tile
    x = _bf16(rng, cuda, r, D)
    wc, bc = _bf16(rng, cuda, N_CMD, D, scale=D ** -0.5), _bf16(rng, cuda, N_CMD)
    wa = _bf16(rng, cuda, N_ARGS * VOCAB, D, scale=D ** -0.5)
    ba = _bf16(rng, cuda, N_ARGS * VOCAB)
    wc[5], bc[5] = wc[2], bc[2]                         # exact ties go to the first index
    wa[3 * VOCAB + 200], ba[3 * VOCAB + 200] = wa[3 * VOCAB + 17], ba[3 * VOCAB + 17]
    w, b = head_ops.pack_head(wc, bc, wa, ba, N_ARGS)
    ids = head_ops.fused_head_argmax(x, w, b, N_CMD, N_ARGS, VOCAB).long()
    ref = head_ops.head_argmax_reference(x, w, b, N_CMD, N_ARGS, VOCAB).long()
    assert ids.shape == (r, 1 + N_ARGS)
    assert not (ids[:, 0] == 5).any() and not (ids[:, 4] == 200).any()
    # ids may differ only where the two best logits are closer than 1e-2
    offsets = torch.tensor([0] + [head_ops._round_up(N_CMD) + i * head_ops._round_up(VOCAB)
                                  for i in range(N_ARGS)], device=cuda)
    logits = torch.matmul(x.float(), w.float().t()) + b.float()
    gap = logits.gather(1, offsets + ref) - logits.gather(1, offsets + ids)
    assert (gap.abs()[ids != ref] < 1e-2).all()


def _layer_weights(rng, dev, dtype, d=D, f=F_FF):
    """The ten layer weights with bfloat16-representable values, in ``dtype``
    (width ``d``, FF width ``f``)."""
    ln = lambda: torch.stack([1 + _bf16(rng, dev, d, scale=0.1),  # noqa: E731
                              _bf16(rng, dev, d, scale=0.1)]).contiguous()
    ws = (ln(), _bf16(rng, dev, 3 * d, d, scale=d ** -0.5), _bf16(rng, dev, 3 * d, scale=0.1),
          _bf16(rng, dev, d, d, scale=d ** -0.5), _bf16(rng, dev, d, scale=0.1), ln(),
          _bf16(rng, dev, f, d, scale=d ** -0.5), _bf16(rng, dev, f, scale=0.1),
          _bf16(rng, dev, d, f, scale=f ** -0.5), _bf16(rng, dev, d, scale=0.1))
    return tuple(w.to(dtype) for w in ws)


def _key_mask(rng, dev, b, s):
    lengths = torch.from_numpy(rng.integers(1, s + 1, b)).to(dev)
    lengths[0] = 0                                     # one fully masked sequence
    return torch.where(torch.arange(s, device=dev)[None] < lengths[:, None], 0.0,
                       float("-inf")).to(torch.float32)


def _rel_rms(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("s,seq_bias,causal", [(8, False, False), (8, True, False),
                                               (31, True, True)])
def test_layer_kernel_float32_matches_plain(cuda, s, seq_bias, causal):
    """K2's float32 form multiplies in TF32 (activations rounded to 10 mantissa
    bits); the plain version in full float32."""
    rng = np.random.default_rng(40 + s + seq_bias)
    b = 13
    weights = _layer_weights(rng, cuda, torch.float32)
    x = _bf16(rng, cuda, b, s, D).float() + 1e-3 * _bf16(rng, cuda, b, s, D).float()
    bias = _bf16(rng, cuda, b, D).float() if seq_bias else None
    inputs = (x, bias, *weights, _key_mask(rng, cuda, b, s), H, causal)
    out = layer_ops.fused_layer(*inputs)
    ref = layer_ops.layer_reference(*inputs)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    print("K2-f32 rel rms", _rel_rms(out, ref), "max", (out - ref).abs().max().item())
    assert _rel_rms(out, ref) <= 1e-3
    assert ((out - ref).abs() <= 2e-2 + 2e-3 * ref.abs()).all()


# K4's gradients, relative RMS error: (against the plain version as it is,
# with the ReLU units aligned), about twice the largest readings of the cases
# below on an H100: bfloat16 (0.0091, 0.0050), float32 (0.0129, 0.0018)
GRAD_RMS_LIMITS = {BF16: (1.5e-2, 1e-2), torch.float32: (3e-2, 4e-3)}
TRAIN_NAMES = ("x", "seq_bias", "ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("dtype,s,b,causal,rate", [
    (BF16, 32, 9, False, 0.0), (BF16, 32, 9, False, 0.1), (BF16, 31, 7, False, 0.1),
    (BF16, 8, 21, False, 0.1), (BF16, 8, 21, False, 0.0), (BF16, 31, 7, True, 0.0),
    (BF16, 31, 7, False, 0.0), (BF16, 31, 64, True, 0.1), (BF16, 17, 9, False, 0.0),
    (BF16, 17, 9, False, 0.1), (BF16, 32, 600, False, 0.1), (BF16, 8, 300, False, 0.1),
    (torch.float32, 8, 21, False, 0.0), (torch.float32, 8, 21, False, 0.1),
    (torch.float32, 16, 5, True, 0.1)])
def test_layer_train_kernel_matches_plain(cuda, dtype, s, b, causal, rate):
    """K4 forward and its twelve gradients against autograd through the plain
    version with the same hash masks, by each gradient's relative RMS error.
    bfloat16 differs by the rounding of df, dhpre, da, dctx, ds and dqkv,
    which the plain version's autograd does not do. float32 runs TF32
    products, forward and backward, against full float32. In both, the plain
    version's weight gradients are rounded to bfloat16 once on their way back
    through its cast of the master weights (0.0016 RMS), and a few FF
    pre-activations next to zero fall on the other side of the ReLU in one
    version, which moves dln2, dw1 and db1 most where the rows are few. So
    each gradient is held twice: to the plain version as it is, and, more
    tightly, to the plain version made to pass the kernel's own FF units.
    bfloat16 runs the wgmma form (E1's S=32, D1's S=31, D2's S=8, S=17,
    causal; B=600 at S=32 and B=300 at S=8 give more tiles than the card
    has SMs, so the persistent blocks loop)."""
    _hold_layer_train(cuda, np.random.default_rng(s + b), dtype, s, b, causal, rate,
                      layer_vjp.fused_layer_train, layer_vjp.fused_layer_train_long)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("save_residuals", [True, False], ids=["saved", "recompute"])
def test_layer_train_narrow_width_takes_the_wmma_form(cuda, rate, save_residuals):
    """bfloat16 below the wgmma form's width (D=128, 4 heads, FF 256) runs
    the older wmma kernels, counted apart; the same limits against the plain
    version."""
    d, heads, f = 128, 4, 256
    rng = np.random.default_rng(128 + int(10 * rate))
    ln = lambda: torch.stack([1 + _bf16(rng, cuda, d, scale=0.1),  # noqa: E731
                              _bf16(rng, cuda, d, scale=0.1)]).float()
    masters = [w.float().requires_grad_() for w in (
        ln(), _bf16(rng, cuda, 3 * d, d, scale=d ** -0.5), _bf16(rng, cuda, 3 * d, scale=0.1),
        _bf16(rng, cuda, d, d, scale=d ** -0.5), _bf16(rng, cuda, d, scale=0.1), ln(),
        _bf16(rng, cuda, f, d, scale=d ** -0.5), _bf16(rng, cuda, f, scale=0.1),
        _bf16(rng, cuda, d, f, scale=f ** -0.5), _bf16(rng, cuda, d, scale=0.1))]
    b, s = 9, 31
    x = _bf16(rng, cuda, b, s, d).requires_grad_()
    bias = _bf16(rng, cuda, b, d).requires_grad_()
    mask = _key_mask(rng, cuda, b, s)
    g = _bf16(rng, cuda, b, s, d)
    leaves = [x, bias, *masters]
    call = (x, bias, *masters, mask, 99, heads, False, rate, BF16)
    fn = layer_vjp.fused_layer_train
    counts = lambda: (fn.narrow_launches, fn.narrow_backward_launches, fn.launches,  # noqa: E731
                      fn.backward_launches, fn.recompute_launches)
    before = counts()
    out = fn(*call, save_residuals=save_residuals)
    grads = torch.autograd.grad(out, leaves, g)
    moved = tuple(a - c for a, c in zip(counts(), before))
    assert moved == ((1, 1, 0, 0, 0) if save_residuals else (1, 0, 0, 0, 0))
    ref = layer_vjp.plain_layer_train(*call)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    print(f"K4 D={d} rate={rate}: fwd rel rms {_rel_rms(out, ref):.3g}")
    assert torch.isfinite(out).all() and _rel_rms(out, ref) <= 1e-3
    for name, got, want in zip(TRAIN_NAMES, grads, ref_grads):
        print(f"  d{name}: rel rms {_rel_rms(got, want):.3g}")
        assert got.shape == want.shape and _rel_rms(got, want) <= GRAD_RMS_LIMITS[BF16][0], name


def _hold_layer_train(dev, rng, dtype, s, b, causal, rate, counted, untouched,
                      save_residuals=True, f=F_FF, seq_bias=True):
    """K4 on one case against the plain version, as it is and with the
    kernel's ReLU units, and against itself run again (to the bit). The
    form that must run is ``counted`` (the forward and backward counters of
    the mode ``save_residuals`` go up by one, those of the other mode do
    not), the other form ``untouched``. The recompute mode keeps no FF
    hidden: its output must equal the saved mode's to the bit, and the ReLU
    units are read from that saved-mode forward."""
    masters = [w.requires_grad_() for w in _layer_weights(rng, dev, torch.float32, f=f)]
    x = _bf16(rng, dev, b, s, D).to(dtype).requires_grad_()
    bias = _bf16(rng, dev, b, D).to(dtype).requires_grad_() if seq_bias else None
    mask = _key_mask(rng, dev, b, s)
    g = _bf16(rng, dev, b, s, D).to(dtype)
    seed = 1234
    leaves = [x, *([bias] if seq_bias else []), *masters]
    call = (x, bias, *masters, mask, seed, H, causal, rate, BF16)
    counts = lambda fn: (fn.launches, fn.backward_launches,  # noqa: E731
                         fn.recompute_launches, fn.recompute_backward_launches)
    before, other = counts(counted), counts(untouched)
    out = layer_vjp.fused_layer_train(*call, save_residuals=save_residuals)
    if save_residuals:
        gate = layer_vjp.kernel_relu_gate(out)
    grads = torch.autograd.grad(out, leaves, g)
    moved = (1, 1, 0, 0) if save_residuals else (0, 0, 1, 1)
    assert counts(counted) == tuple(n + m for n, m in zip(before, moved))
    assert counts(untouched) == other
    if not save_residuals:
        with pytest.raises(ValueError, match="save_residuals=True"):
            layer_vjp.kernel_relu_gate(layer_vjp.fused_layer_train(*call))
        saved_out = layer_vjp.fused_layer_train(*call, save_residuals=True)
        assert torch.equal(out, saved_out)     # the same arithmetic, fewer writes
        gate = layer_vjp.kernel_relu_gate(saved_out)
        del saved_out
    ref = layer_vjp.plain_layer_train(*call)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    gate_grads = torch.autograd.grad(layer_vjp.plain_layer_train(*call, relu_gate=gate),
                                     leaves, g)
    grad_lim, gate_lim = GRAD_RMS_LIMITS[dtype]
    print(f"K4 {dtype} S={s} causal={causal} rate={rate}: fwd rel rms {_rel_rms(out, ref):.3g}")
    assert torch.isfinite(out).all() and _rel_rms(out, ref) <= 1e-3
    names = TRAIN_NAMES if seq_bias else TRAIN_NAMES[:1] + TRAIN_NAMES[2:]
    for name, got, want, want_gate in zip(names, grads, ref_grads, gate_grads):
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        print(f"  d{name}: rel rms {_rel_rms(got, want):.3g}, with the ReLU units aligned "
              f"{_rel_rms(got, want_gate):.3g}")
        assert _rel_rms(got, want) <= grad_lim, name
        assert _rel_rms(got, want_gate) <= gate_lim, name
    again = torch.autograd.grad(
        layer_vjp.fused_layer_train(*call, save_residuals=save_residuals), leaves, g)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))   # no atomics in K4


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,s,b,causal,long_form", [
    (BF16, 8, 21, False, False), (BF16, 32, 9, False, False), (BF16, 31, 7, True, False),
    (BF16, 17, 9, False, False),
    (torch.float32, 8, 21, False, False), (torch.float32, 16, 5, True, False),
    (BF16, 33, 3, False, True), (BF16, 242, 3, False, True), (BF16, 241, 3, True, True),
    (torch.float32, 32, 3, False, True), (torch.float32, 242, 3, False, True)])
def test_layer_train_recompute_kernel_matches_plain(cuda, dtype, s, b, causal, long_form, rate):
    """K4's recompute mode (``save_residuals=False``), short and long form:
    the output equal to the saved mode's to the bit, every gradient against
    the plain version within the saved mode's limits (the plain version's
    probabilities and hidden are float32, as the recompute backward's are),
    reruns equal to the bit; only the recompute counters of the form move."""
    forms = (layer_vjp.fused_layer_train_long, layer_vjp.fused_layer_train)
    counted, untouched = forms if long_form else forms[::-1]
    _hold_layer_train(cuda, np.random.default_rng(s + b + int(10 * rate)), dtype, s, b, causal,
                      rate, counted, untouched, save_residuals=False)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("s", [33, 64, 241, 242])
def test_long_layer_train_kernel_matches_plain(cuda, s, dtype, causal, rate):
    """K4's long form (bfloat16 beyond S=32, float32 beyond S=16) against
    the plain version with the short form's limits, and bit-identical from
    run to run; the short form does not run."""
    _hold_layer_train(cuda, np.random.default_rng(s + 2 * causal), dtype, s, 3, causal, rate,
                      layer_vjp.fused_layer_train_long, layer_vjp.fused_layer_train)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("save_residuals", [True, False], ids=["saved", "recompute"])
@pytest.mark.parametrize("dtype,s,b,causal", [
    (torch.float32, 17, 9, False), (torch.float32, 31, 9, True), (torch.float32, 32, 9, False),
    (torch.float32, 242, 3, False), (BF16, 33, 9, False), (BF16, 241, 3, True),
    (BF16, 242, 3, False)],
    ids=["f32-17", "f32-31-causal", "f32-32", "f32-242", "bf16-33", "bf16-241-causal",
         "bf16-242"])
def test_long_layer_train_hopper_forms(cuda, dtype, s, b, causal, save_residuals, rate):
    """K4's long form at the flagship's widths on its Hopper kernels: float32
    from S=17 (several sequences a tile, and S=31 whose key blocks straddle
    two sequences, causal with seq_bias) to S=242, bfloat16 from S=33, both
    modes, against the plain version with the short form's limits, equal to
    the bit on a second run; the older wmma kernels (``narrow`` counters) do
    not run, and the float32 counters move with the float32 cases alone."""
    fn = layer_vjp.fused_layer_train_long
    counts = lambda: (fn.float32_launches, fn.float32_backward_launches,  # noqa: E731
                      fn.narrow_launches, fn.narrow_backward_launches)
    before = counts()
    _hold_layer_train(cuda, np.random.default_rng(3 * s + b + int(10 * rate)), dtype, s, b,
                      causal, rate, fn, layer_vjp.fused_layer_train,
                      save_residuals=save_residuals)
    moved = [a - c for a, c in zip(counts(), before)]
    assert moved[2:] == [0, 0]
    if dtype == torch.float32:
        assert moved[0] >= 1 and moved[1] == (2 if save_residuals else 0)
    else:
        assert moved[:2] == [0, 0]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("seq_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("s", [8, 16])
@pytest.mark.parametrize("b", [1, 3, 128])
def test_float32_short_layer_train_takes_the_tf32_wgmma_form(cuda, b, s, seq_bias, rate):
    """K4's float32 short form (S <= 16) in the saved mode at the flagship's
    widths runs the long form's TF32 ``wgmma`` launches (``layer_f32.cu``,
    ``layer_f32_bwd.cu``), counted under the short form's counters and its
    ``float32_launches`` / ``float32_backward_launches``: forward and every
    gradient against the plain version within the float32 limits, equal to
    the bit on a second run; the older kernels (``narrow`` counters) and the
    long form's counters do not move. E2 at B=128 is the step's case."""
    fn, long_fn = layer_vjp.fused_layer_train, layer_vjp.fused_layer_train_long
    counts = lambda: (fn.float32_launches, fn.float32_backward_launches,  # noqa: E731
                      fn.narrow_launches, fn.narrow_backward_launches)
    before = counts()
    _hold_layer_train(cuda, np.random.default_rng(7 * b + s + int(10 * rate)), torch.float32, s,
                      b, s == 16, rate, fn, long_fn, seq_bias=seq_bias)
    # the forward twice (once for the rerun), the backward twice
    assert [a - c for a, c in zip(counts(), before)] == [2, 2, 0, 0]


@pytest.mark.parametrize("save_residuals", [True, False], ids=["saved", "recompute"])
@pytest.mark.parametrize("f", [320, 384])
@pytest.mark.parametrize("s,b", [(8, 21), (32, 9), (40, 3)])
def test_bf16_layer_train_ff_width_not_a_multiple_of_256(cuda, s, b, f, save_residuals):
    """bfloat16 K4 at D=256, 8 heads and an FF width that is no multiple of
    256 (F=320, F=384): the Hopper forms' weight products take N multiples
    of 256 only, so these widths run the older wmma kernels in both
    directions (counted under ``narrow_launches``), short form (S=8, 32) and
    long (S=40), both modes, against the plain version within the bfloat16
    limits. Before the width rule was narrowed the short form's forward ran
    its wgmma kernel and the backward raised CUDA error 1 in its weight
    products."""
    counted = layer_vjp.fused_layer_train_long if s > 32 else layer_vjp.fused_layer_train
    narrow = lambda: (counted.narrow_launches, counted.narrow_backward_launches)  # noqa: E731
    before = narrow()
    rng = np.random.default_rng(f + s)
    masters = [w.requires_grad_() for w in _layer_weights(rng, cuda, torch.float32, f=f)]
    x = _bf16(rng, cuda, b, s, D).requires_grad_()
    bias = _bf16(rng, cuda, b, D).requires_grad_()
    mask = _key_mask(rng, cuda, b, s)
    g = _bf16(rng, cuda, b, s, D)
    leaves = [x, bias, *masters]
    call = (x, bias, *masters, mask, 5, H, s == 32, 0.1, BF16)
    out = layer_vjp.fused_layer_train(*call, save_residuals=save_residuals)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    # the forward counts as narrow in both modes, the backward in the saved mode
    assert [a - c for a, c in zip(narrow(), before)] == [1, int(save_residuals)]
    saved_out = layer_vjp.fused_layer_train(*call, save_residuals=True)
    assert torch.equal(out, saved_out)
    gate = layer_vjp.kernel_relu_gate(saved_out)
    ref = layer_vjp.plain_layer_train(*call)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    gate_grads = torch.autograd.grad(layer_vjp.plain_layer_train(*call, relu_gate=gate),
                                     leaves, g)
    print(f"K4 bf16 F={f} S={s} save={save_residuals}: fwd rel rms {_rel_rms(out, ref):.3g}")
    # the long form's older kernel reads 0.0011 at F=320 (one bfloat16 rounding
    # of the output, 2^-9 / sqrt(3), on most elements): twice the short form's
    # limit there
    assert torch.isfinite(out).all() and _rel_rms(out, ref) <= (2e-3 if s > 32 else 1e-3)
    grad_lim, gate_lim = GRAD_RMS_LIMITS[BF16]
    for name, got, want, want_gate in zip(TRAIN_NAMES, grads, ref_grads, gate_grads):
        print(f"  d{name}: rel rms {_rel_rms(got, want):.3g}, aligned "
              f"{_rel_rms(got, want_gate):.3g}")
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        assert _rel_rms(got, want) <= grad_lim, name
        assert _rel_rms(got, want_gate) <= gate_lim, name


def test_float32_layer_train_takes_the_long_form_from_s17(cuda):
    """A float32 model's E1 (S=32) and D1 (S=31) train on the card: float32
    activations beyond the short form's 16 rows go to the long form."""
    _hold_layer_train(cuda, np.random.default_rng(17), torch.float32, 17, 4, False, 0.1,
                      layer_vjp.fused_layer_train_long, layer_vjp.fused_layer_train)
    _hold_layer_train(cuda, np.random.default_rng(32), torch.float32, 32, 4, True, 0.1,
                      layer_vjp.fused_layer_train_long, layer_vjp.fused_layer_train)


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_long_layer_train_refuses_s257(cuda, dtype):
    f = lambda *shape: torch.zeros(shape, device=cuda, dtype=dtype)  # noqa: E731
    x = f(2, 257, D).requires_grad_()
    with pytest.raises(ValueError, match="S <= 256"):
        layer_vjp.fused_layer_train(x, None, f(2, D), f(3 * D, D), f(3 * D), f(D, D), f(D),
                                    f(2, D), f(F_FF, D), f(F_FF), f(D, F_FF), f(D),
                                    torch.zeros(2, 257, device=cuda), 0, H)


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("use_group", [False, True])
def test_embedding_backward_kernel_matches_plain(cuda, dtype, use_group):
    rng = np.random.default_rng(6)
    b, s, n_group = 40, 32, 10
    commands = torch.from_numpy(rng.integers(0, N_CMD, (b, s)).astype(np.int32)).to(cuda)
    args = rng.integers(-1, VOCAB - 1, (b, s, N_ARGS)).astype(np.float32)
    args[rng.random(args.shape) < 0.8] = -1            # mostly PAD
    args = torch.from_numpy(args).to(cuda)
    groups = torch.from_numpy(rng.integers(0, n_group, (b, s)).astype(np.int32)).to(cuda)
    commands[1, 2], args[1, 3, 4], args[2, 1, 0], groups[3, 5] = N_CMD + 2, VOCAB + 5, -3, n_group
    tables = [_bf16(rng, cuda, n, D).to(dtype).requires_grad_()
              for n in (N_CMD, N_ARGS * VOCAB, n_group, s)]
    dy = _bf16(rng, cuda, b, s, D).to(dtype)
    got = emb_ops.embedding_backward(commands, args, groups, dy, N_CMD, VOCAB, n_group, use_group)
    ref = emb_ops.embedding_reference(commands, args, groups, tables[0], tables[1], tables[2],
                                      tables[3], use_group)
    want = torch.autograd.grad(ref, tables, dy, allow_unused=True)
    for name, a, w in zip(("dcmd", "darg", "dgroup", "dpos"), got, want):
        if w is None:
            assert not use_group and not a.any()
            continue
        err = (a - w.float()).abs().max().item()
        print(f"K6 {name}: max abs err {err:.3g} of max {w.abs().max().item():.3g}")
        # exact products, float32 sums in another order; the plain version
        # returns the table's dtype
        assert err <= (2.0 ** -7 if dtype == BF16 else 1e-5) * w.abs().max().item() + 1e-5


@pytest.mark.parametrize("s", [32, 210, 242])
def test_embedding_backward_long_s(cuda, s):
    """K6 at the flagship's S=32 and beyond the 209 rows its shared table
    once held (Sketchformer's S=242, with a group table of S rows and 512
    relative classes); the position rows are summed in a fixed order, so
    dpos is the same from run to run."""
    rng = np.random.default_rng(s)
    b, vocab, n_group = 12, 512, s
    commands = torch.from_numpy(rng.integers(0, N_CMD, (b, s)).astype(np.int32)).to(cuda)
    args = rng.integers(-1, vocab - 1, (b, s, N_ARGS)).astype(np.float32)
    args[rng.random(args.shape) < 0.8] = -1            # mostly PAD
    args = torch.from_numpy(args).to(cuda)
    groups = torch.from_numpy(rng.integers(0, n_group, (b, s)).astype(np.int32)).to(cuda)
    tables = [_bf16(rng, cuda, n, D).float().requires_grad_()
              for n in (N_CMD, N_ARGS * vocab, n_group, s)]
    dy = _bf16(rng, cuda, b, s, D)
    before = emb_ops.embedding_backward.launches
    got = emb_ops.embedding_backward(commands, args, groups, dy, N_CMD, vocab, n_group, True)
    assert emb_ops.embedding_backward.launches == before + 1
    ref = emb_ops.embedding_reference(commands, args, groups, tables[0], tables[1], tables[2],
                                      tables[3], True)
    want = torch.autograd.grad(ref, tables, dy.float())
    for name, a, w in zip(("dcmd", "darg", "dgroup", "dpos"), got, want):
        err = (a - w).abs().max().item()
        print(f"K6 S={s} {name}: max abs err {err:.3g} of max {w.abs().max().item():.3g}")
        assert err <= 1e-5 * w.abs().max().item() + 1e-5, name
    again = emb_ops.embedding_backward(commands, args, groups, dy, N_CMD, vocab, n_group, True)
    assert torch.equal(got[3], again[3])


def test_kernels_refuse_what_they_do_not_take(cuda):
    """Every kernel takes operands all bfloat16 or all float32: a mix raises,
    naming the dtype (K3 and K5 take float32 operands since their float32
    forms, so a float32 call runs)."""
    f32 = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    c = head_ops._round_up(N_CMD) + N_ARGS * head_ops._round_up(VOCAB)
    with pytest.raises(ValueError, match="dtype"):        # mixed activation and weight types
        layer_ops.fused_layer(f32(2, 8, D).to(BF16), None, f32(2, D), f32(3 * D, D), f32(3 * D),
                              f32(D, D), f32(D), f32(2, D), f32(F_FF, D), f32(F_FF),
                              f32(D, F_FF), f32(D), f32(2, 8), H)
    with pytest.raises(ValueError, match="dtype"):
        head_ops.fused_head_argmax(f32(8, D), f32(c, D).to(BF16), f32(c).to(BF16), N_CMD,
                                   N_ARGS, VOCAB)
    with pytest.raises(ValueError, match="dtype"):
        head_ops.fused_head_argmax(f32(8, D).to(BF16), f32(c, D), f32(c), N_CMD, N_ARGS, VOCAB)
    x32 = f32(2, 257, D).requires_grad_()
    with pytest.raises(ValueError, match="S <= 256"):     # beyond the long form too
        layer_vjp.fused_layer_train(x32, None, f32(2, D), f32(3 * D, D), f32(3 * D), f32(D, D),
                                    f32(D), f32(2, D), f32(F_FF, D), f32(F_FF), f32(D, F_FF),
                                    f32(D), f32(2, 257), 0, H)
    tgt = torch.zeros(8, N_ARGS, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype torch.float32 and head of dtype torch.bfloat16"):
        ce_ops.args_ce(f32(8, D), f32(N_ARGS * VOCAB, D), f32(N_ARGS * VOCAB), tgt, BF16)
    with pytest.raises(ValueError, match="dtype torch.bfloat16 and head of dtype torch.float32"):
        ce_ops.args_ce(f32(8, D).to(BF16), f32(N_ARGS * VOCAB, D), f32(N_ARGS * VOCAB), tgt,
                       torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        emb_ops.fused_embedding(tgt[:, :4], f32(8, 4, N_ARGS), None, f32(N_CMD, D),
                                f32(N_ARGS * VOCAB, D).to(BF16), None, f32(4, D))


def _stack_inputs(rng, dev, dtype, n_layers, b, s, with_bias, d=D, f=F_FF):
    masters = [torch.stack(ws).requires_grad_() for ws in
               zip(*(_layer_weights(rng, dev, torch.float32, d, f) for _ in range(n_layers)))]
    x = _bf16(rng, dev, b, s, d).to(dtype).requires_grad_()
    bias = (_bf16(rng, dev, n_layers, b, d) if with_bias
            else torch.zeros(n_layers, b, d, device=dev)).to(dtype).requires_grad_()
    return x, bias, masters, _key_mask(rng, dev, b, s), _bf16(rng, dev, b, s, d).to(dtype)


@pytest.mark.parametrize("dtype,b,causal,rate,with_bias,n_layers,d,f", [
    (BF16, 60, False, 0.0, False, 4, D, F_FF), (BF16, 60, False, 0.1, True, 4, D, F_FF),
    (BF16, 64, False, 0.1, False, 4, D, F_FF), (BF16, 9, True, 0.1, True, 4, D, F_FF),
    (BF16, 60, False, 0.1, True, 2, D, F_FF), (BF16, 60, False, 0.1, True, 4, 128, 512),
    (BF16, 20, False, 0.1, True, 2, 192, 512),
    (torch.float32, 13, False, 0.1, True, 4, D, F_FF),
    (torch.float32, 60, False, 0.1, True, 4, D, F_FF),
    (torch.float32, 64, False, 0.0, False, 2, D, F_FF),
    (torch.float32, 60, True, 0.1, True, 2, 128, 512)])
def test_stack_train_kernel_matches_plain(cuda, dtype, b, causal, rate, with_bias, n_layers, d,
                                          f):
    """K7 (S=8) against the plain version with the same hash masks. The
    forward layer by layer, each from the kernel's own input to that layer,
    within K4's forward limit; the whole stack's forward and its twelve
    gradients by their relative RMS error, the gradients against the plain
    version as it is and with each layer's FF units aligned to the kernel's.
    Then against the chain of K4 calls with the per-layer seeds, which
    computes the same thing in another summation order (K7's cluster kernels
    share no block code with K4): within the limits each meets against the
    plain version (a layer from K7's own input to it, the whole stack, the
    gradients). And the same again on a second run, equal to the bit (no
    atomics). D = 192, F = 512 is a width the cluster kernels do not take (F
    is not a multiple of D): the older kernels run it, counted apart."""
    from deepsvg_tpu_torch.ops import stack_vjp
    from deepsvg_tpu_torch.ops.dropout import stack_layer_seed
    s, seed, heads = 8, 4321, d // 32
    rng = np.random.default_rng(b + int(100 * rate) + n_layers + d + f)
    x, bias, masters, mask, g = _stack_inputs(rng, cuda, dtype, n_layers, b, s, with_bias, d, f)
    leaves = [x, bias, *masters]
    call = (x, bias, *masters, mask, seed, heads, causal, rate, BF16)
    narrow = not stack_vjp.stack_launch_plan(b, s, d, f, heads, dtype)["takes"]
    assert narrow == (f % d != 0)
    counts = lambda: (stack_vjp.fused_stack_train.launches,  # noqa: E731
                      stack_vjp.fused_stack_train.backward_launches,
                      stack_vjp.fused_stack_train.narrow_launches)
    before = counts()
    out = stack_vjp.fused_stack_train(*call)
    gates = stack_vjp.kernel_relu_gates(out)
    inputs = stack_vjp.kernel_layer_inputs(out)
    grads = torch.autograd.grad(out, leaves, g)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + int(narrow))
    with torch.no_grad():
        for layer, (x_l, y_l) in enumerate(zip(inputs, inputs[1:] + [out])):
            ref_l = layer_vjp.plain_layer_train(
                x_l, bias[layer], *[w[layer] for w in masters], mask,
                stack_layer_seed(seed, layer), heads, causal, rate, BF16)
            print(f"K7 {dtype} B={b} L={n_layers} D={d} F={f} rate={rate} layer {layer}: fwd "
                  f"rel rms {_rel_rms(y_l, ref_l):.3g}")
            assert torch.isfinite(y_l).all() and _rel_rms(y_l, ref_l) <= 1e-3
    ref = stack_vjp.plain_stack_train(*call)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    gate_grads = torch.autograd.grad(stack_vjp.plain_stack_train(*call, relu_gates=gates),
                                     leaves, g)
    print(f"K7 {dtype} B={b} L={n_layers} D={d} F={f} rate={rate}: whole-stack fwd rel rms "
          f"{_rel_rms(out, ref):.3g}")
    # through four layers, each layer's last-bit differences feed the next:
    # read up to 0.0029 for the forward (bfloat16, B=60) and, for the
    # gradients, 0.017 as they are and 0.0065 aligned; limits about twice
    # the readings, as K4's
    assert _rel_rms(out, ref) <= 5e-3
    grad_lim, gate_lim = GRAD_RMS_LIMITS[dtype]
    for name, got, want, want_gate in zip(TRAIN_NAMES, grads, ref_grads, gate_grads):
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        print(f"  d{name}: rel rms {_rel_rms(got, want):.3g}, with the ReLU units aligned "
              f"{_rel_rms(got, want_gate):.3g}")
        assert _rel_rms(got, want) <= 2 * grad_lim, name
        assert _rel_rms(got, want_gate) <= 2 * gate_lim, name
    # the K4 chain
    y = x
    for layer in range(n_layers):
        y = layer_vjp.fused_layer_train(y, bias[layer], *[w[layer] for w in masters], mask,
                                        stack_layer_seed(seed, layer), heads, causal, rate,
                                        BF16, save_residuals=True)
    chain_grads = torch.autograd.grad(y, leaves, g)
    with torch.no_grad():
        for layer, (x_l, y_l) in enumerate(zip(inputs, inputs[1:] + [out])):
            k4_l = layer_vjp.fused_layer_train(
                x_l, bias[layer], *[w[layer] for w in masters], mask,
                stack_layer_seed(seed, layer), heads, causal, rate, BF16, save_residuals=True)
            print(f"K7 against K4, layer {layer}: rel rms {_rel_rms(y_l, k4_l):.3g}")
            assert _rel_rms(y_l, k4_l) <= 1e-3
    print(f"K7 against the K4 chain: rel rms {_rel_rms(out, y):.3g}")
    assert _rel_rms(out, y) <= 5e-3
    for name, got, want in zip(TRAIN_NAMES, grads, chain_grads):
        print(f"  d{name}: rel rms against the K4 chain {_rel_rms(got, want):.3g}")
        assert _rel_rms(got, want) <= 2 * grad_lim, name
    again = torch.autograd.grad(stack_vjp.fused_stack_train(*call), leaves, g)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.parametrize("vocab", [VOCAB, 512])
@pytest.mark.parametrize("r,n_variants", [(1000, 8), (14880, 8), (257, 3)])
def test_pairwise_ce_kernel_matches_plain(cuda, r, n_variants, vocab):
    """K8 against its plain version (1e-3, as K5: float32 sums of exact bf16
    products in another order), with targets that match no class; each
    variant's columns equal K5's forward on that variant's targets, to the
    bit (one code path)."""
    rng = np.random.default_rng(r + n_variants + vocab)
    y = _bf16(rng, cuda, r, D)
    wa = _bf16(rng, cuda, N_ARGS * vocab, D, scale=D ** -0.5).float()
    ba = _bf16(rng, cuda, N_ARGS * vocab).float()
    k = n_variants * N_ARGS
    tgt = torch.from_numpy(rng.integers(0, vocab, (r, k)).astype(np.int32)).to(cuda)
    tgt[3, 2], tgt[4, k - 1] = vocab + 3, -1
    before = ce_ops.args_ce_pairwise.launches
    ce = ce_ops.args_ce_pairwise(y, wa, ba, tgt, n_variants, BF16)
    assert ce_ops.args_ce_pairwise.launches == before + 1
    ref = ce_ops.args_ce_pairwise_reference(y, wa.to(BF16), ba.to(BF16), tgt, n_variants)
    err = (ce - ref).abs().max().item()
    print(f"K8 R={r} G={n_variants}: max abs err {err:.3g}")
    assert ce.shape == (r, k) and ce.dtype == torch.float32 and err <= 1e-3
    k5 = torch.cat([ce_ops.args_ce(y, wa, ba, tgt[:, g * N_ARGS:(g + 1) * N_ARGS].contiguous(),
                                   BF16) for g in range(n_variants)], dim=1)
    print(f"  K8 vs K5 per variant: max abs diff {(ce - k5).abs().max().item():.3g}")
    assert torch.equal(ce, k5)
    with pytest.raises(ValueError, match="bfloat16"):      # float32 states, bfloat16 head
        ce_ops.args_ce_pairwise(y.float(), wa, ba, tgt, n_variants, BF16)
    with pytest.raises(ValueError, match="do not fit"):
        ce_ops.args_ce_pairwise(y, wa, ba, tgt[:, :-1], n_variants, BF16)


def test_self_match_step_launches_k8_once(cuda):
    """One training step of the self-matching model at the flagship's widths
    (random weights, B=4, dropout 0.1): K8 once for the matching, K5 once
    forward and once backward on the permuted targets; finite loss terms."""
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import SVGTransformer, gpu_fast, hierarchical_self_matching
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)
    model = SVGTransformer(gpu_fast(hierarchical_self_matching())).to(cuda)
    optimizer = make_optimizer(constant(1e-3))
    state = create_train_state(model, optimizer)
    b = generate_batch(np.random.default_rng(0), 4)
    batch = {k: torch.from_numpy(b[k]).to(cuda) for k in ("commands", "args")}
    counts = (ce_ops.args_ce_pairwise.launches, ce_ops.args_ce.launches,
              ce_ops.args_ce.backward_launches)
    weights = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_visibility_weight=1.0,
                   loss_cmd_weight=1.0, loss_args_weight=2.0)
    _, res = train_step(state, batch, weights, optimizer, ["commands", "args"] * 2)
    torch.cuda.synchronize()
    after = (ce_ops.args_ce_pairwise.launches, ce_ops.args_ce.launches,
             ce_ops.args_ce.backward_launches)
    assert [a - c for a, c in zip(after, counts)] == [1, 1, 1]
    assert all(bool(torch.isfinite(v)) for v in res.values()) and "loss_kl" in res


# the long form of K2 and K9: the layer's limits (one bf16 step of the output
# plus flipped intermediates); K9 runs four layers, whose last-bit
# differences feed each other, so its relative RMS limit is twice the layer's
TOL_ATOL, TOL_RTOL, TOL_RMS = 0.1, 2.0 ** -7, 1e-3
TOL_F32_ATOL, TOL_F32_RTOL = 2e-2, 2e-3


@pytest.mark.parametrize("dtype,s,seq_bias,causal", [
    (BF16, 33, False, False), (BF16, 240, False, False), (BF16, 241, True, True),
    (BF16, 242, True, False), (BF16, 256, False, True), (torch.float32, 241, True, True),
    (torch.float32, 100, False, False),
    # the bfloat16 kernel's tiles of 256 / S whole sequences: 4, 3, 2 and 1 a tile
    (BF16, 64, True, True), (BF16, 65, False, False), (BF16, 128, True, False),
    (BF16, 200, False, True)])
def test_long_layer_kernel_matches_plain(cuda, dtype, s, seq_bias, causal):
    """K2's long form (two launches, counted once) against the plain layer,
    with key padding and one fully masked sequence."""
    rng = np.random.default_rng(s + 2 * causal)
    b = 5
    weights = _layer_weights(rng, cuda, dtype)
    x = _bf16(rng, cuda, b, s, D).to(dtype)
    bias = _bf16(rng, cuda, b, D).to(dtype) if seq_bias else None
    inputs = (x, bias, *weights, _key_mask(rng, cuda, b, s), H, causal)
    before, short = layer_ops.fused_layer_long.launches, layer_ops.fused_layer.launches
    out = layer_ops.fused_layer(*inputs)
    assert layer_ops.fused_layer_long.launches == before + 1
    assert layer_ops.fused_layer.launches == short
    ref = layer_ops.layer_reference(*inputs).float()
    assert out.dtype == dtype and torch.isfinite(out).all()
    err = (out.float() - ref).abs()
    atol, rtol = (TOL_ATOL, TOL_RTOL) if dtype == BF16 else (TOL_F32_ATOL, TOL_F32_RTOL)
    assert (err <= atol + rtol * ref.abs()).all(), (err - rtol * ref.abs()).max().item()
    assert _rel_rms(out, ref) <= TOL_RMS


def test_layer_kernels_rerun_to_the_bit(cuda):
    """K2's bfloat16 kernels sum in a fixed order (no atomics): the same
    inputs give the same output to the bit, short and long form."""
    for s, b in ((31, 300), (242, 7)):
        rng = np.random.default_rng(s)
        inputs = (_bf16(rng, cuda, b, s, D), _bf16(rng, cuda, b, D), *_layer_weights(rng, cuda, BF16),
                  _key_mask(rng, cuda, b, s), H, True)
        first = layer_ops.fused_layer(*inputs)
        assert all(torch.equal(layer_ops.fused_layer(*inputs), first) for _ in range(3)), s


def test_bf16_layer_refuses_other_widths(cuda):
    """The bfloat16 kernels take D=256 and F a multiple of 64 up to 1024."""
    rng = np.random.default_rng(1)
    for d, f, s in ((128, 512, 8), (D, 96, 8), (D, 2048, 40)):
        ln = torch.stack([1 + _bf16(rng, cuda, d), _bf16(rng, cuda, d)]).contiguous()
        ws = (ln, _bf16(rng, cuda, 3 * d, d), _bf16(rng, cuda, 3 * d), _bf16(rng, cuda, d, d),
              _bf16(rng, cuda, d), ln, _bf16(rng, cuda, f, d), _bf16(rng, cuda, f),
              _bf16(rng, cuda, d, f), _bf16(rng, cuda, d))
        with pytest.raises(ValueError, match="bfloat16 layer kernels take D=256"):
            layer_ops.fused_layer(_bf16(rng, cuda, 2, s, d), None, *ws,
                                  torch.zeros(2, s, device=cuda), d // 32)


def test_layer_kernels_are_wgmma_kernels(cuda):
    """K2's bfloat16 kernels (the short form, and the long form's two
    launches) multiply with Hopper's warpgroup instructions: HGMMA in the
    built library's SASS (cuobjdump)."""
    import re
    import shutil
    import subprocess

    from deepsvg_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build.build()], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    k2 = {re.search(r"infer_\w+?_kernel", n).group(0): c for n, c in counts.items()
          if re.search(r"infer_(short|qkv|attn_ffn)_kernel", n)}
    print("HGMMA instructions:", k2)
    assert set(k2) == {"infer_short_kernel", "infer_qkv_kernel", "infer_attn_ffn_kernel"}, k2
    assert all(c > 0 for c in k2.values()), k2


def _sass_counts(pattern: str, instruction: str) -> dict:
    """Instructions matching ``instruction`` in each kernel of the built
    library whose name matches ``pattern`` (cuobjdump's SASS)."""
    import re
    import shutil
    import subprocess

    from deepsvg_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build.build()], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                counts[name] = 0
        elif name and instruction in line:
            counts[name] += 1
    return counts


def test_head_and_float32_layer_kernels_are_wgmma_kernels(cuda):
    """K3 (bfloat16 with one and two row tiles a warpgroup, float32) and K2's
    float32 products (its QKV and out-projection/FF launches) multiply with
    Hopper's warpgroup instructions; its attention launch with mma.sync."""
    head = _sass_counts(r"\d+head_kernelI", "HGMMA")
    # K2's launches alone (a digit of the mangled length right before the
    # name: not K4's train_*_kernel beside them, nor layer_f32_bwd's)
    layer = _sass_counts(r"9layer_f32.*\d(qkv|out_ffn)_kernelE", "HGMMA")
    attn = _sass_counts(r"9layer_f32.*\dattn_kernelI", "HMMA")
    print("HGMMA instructions:", head, layer, "HMMA:", attn)
    assert len(head) == 3 and all(c > 0 for c in head.values()), head
    assert len(layer) == 2 and all(c > 0 for c in layer.values()), layer
    assert len(attn) == 2 and all(c > 0 for c in attn.values()), attn


def test_long_train_kernels_are_tensor_core_kernels(cuda):
    """K4's long form on Hopper: its products (QKV, the out projection and
    FF forward; the FF, QKV and weight-product backward launches) multiply
    with warpgroup instructions in both types, its attention launches with
    mma.sync."""
    products = {
        "float32 forward": _sass_counts(r"layer_f32.*train_(qkv|out_ffn)_kernel", "HGMMA"),
        "float32 backward": _sass_counts(r"layer_f32_bwd.*(bwd_ff|bwd_qkv|wgrad_tf32)_kernel",
                                         "HGMMA"),
        "bfloat16 forward": _sass_counts(r"train_long_(qkv|out_ffn)_kernel", "HGMMA")}
    attention = {
        "float32 forward": _sass_counts(r"layer_f32.*train_attn_kernel", "HMMA"),
        "float32 backward": _sass_counts(r"layer_f32_bwd.*bwd_attn_kernel", "HMMA"),
        "bfloat16 forward": _sass_counts(r"train_long_attn_kernel", "HMMA"),
        "bfloat16 backward": _sass_counts(r"bwd_attn_long_kernel", "HMMA")}
    print("HGMMA:", products, "HMMA:", attention)
    # train_qkv, train_out_ffn x 2 modes; bwd_ff, bwd_qkv, wgrad; and the bf16 pair
    for what, n in (("float32 forward", 3), ("float32 backward", 3), ("bfloat16 forward", 3)):
        assert len(products[what]) == n and all(c > 0 for c in products[what].values()), what
    for what, n in (("float32 forward", 4), ("float32 backward", 2), ("bfloat16 forward", 2),
                    ("bfloat16 backward", 1)):
        assert len(attention[what]) == n and all(c > 0 for c in attention[what].values()), what


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("r,vocab", [(1024, VOCAB), (1024, 512), (4099, VOCAB), (130, 33)])
def test_head_kernel_at_the_decode_rows(cuda, dtype, r, vocab):
    """K3 at the decode's R = N = 1,024 rows a step (the flagship's 257
    classes and Sketchformer's 512), and at row counts off its tiles: ids
    equal to the plain version's wherever its top-2 gap is at least 1e-2
    (bfloat16: 1e-3); pairs of equal columns across the 128-column chunk
    edges go to the first."""
    rng = np.random.default_rng(r + vocab)
    x = _bf16(rng, cuda, r, D).to(dtype)
    wc, bc = _bf16(rng, cuda, N_CMD, D, scale=D ** -0.5), _bf16(rng, cuda, N_CMD)
    wa = _bf16(rng, cuda, N_ARGS * vocab, D, scale=D ** -0.5)
    ba = _bf16(rng, cuda, N_ARGS * vocab)
    edges = [(c - 1, c) for c in (64, 128, 256) if c < vocab]
    for i, (lo, hi) in enumerate(edges):       # slots 1, 2, 3 win at the edge
        wa[i * vocab + hi], ba[i * vocab + lo], ba[i * vocab + hi] = wa[i * vocab + lo], 50., 50.
    w, b = head_ops.pack_head(*(t.to(dtype) for t in (wc, bc, wa, ba)), N_ARGS)
    before = head_ops.fused_head_argmax.launches
    ids = head_ops.fused_head_argmax(x, w, b, N_CMD, N_ARGS, vocab).long()
    assert head_ops.fused_head_argmax.launches == before + 1
    ref = head_ops.head_argmax_reference(x, w, b, N_CMD, N_ARGS, vocab).long()
    for i, (lo, _) in enumerate(edges):
        assert (ids[:, 1 + i] == lo).all() and (ref[:, 1 + i] == lo).all()
    offsets = torch.tensor([0] + [head_ops._round_up(N_CMD) + i * head_ops._round_up(vocab)
                                  for i in range(N_ARGS)], device=cuda)
    logits = torch.matmul(x.float(), w.float().t()) + b.float()
    gap = logits.gather(1, offsets + ref) - logits.gather(1, offsets + ids)
    print(f"K3 R={r} {dtype}: {int((ids != ref).sum())} ids differ")
    assert (gap.abs()[ids != ref] < (1e-2 if dtype == torch.float32 else 1e-3)).all()


@pytest.mark.parametrize("s,b,seq_bias,causal", [
    (32, 40, False, False), (31, 40, True, False), (17, 30, True, True), (8, 200, False, False),
    (1, 300, True, False), (242, 5, False, False), (241, 5, True, True), (33, 9, False, True)])
def test_float32_layer_wgmma_form_matches_plain(cuda, s, b, seq_bias, causal):
    """K2's float32 form on TF32 wgmma (D=256, 8 heads) at the paths' lengths
    (E1 32, D1 31, E2 8, the long form's 242 and 241, and S=1, 17, 33)
    against the plain version in full float32, within the float32 limits;
    counted once a layer, under the short or the long form by S."""
    rng = np.random.default_rng(50 + s)
    weights = _layer_weights(rng, cuda, torch.float32)
    x = _bf16(rng, cuda, b, s, D).float() + 1e-3 * _bf16(rng, cuda, b, s, D).float()
    bias = _bf16(rng, cuda, b, D).float() if seq_bias else None
    inputs = (x, bias, *weights, _key_mask(rng, cuda, b, s), H, causal)
    counter = layer_ops.fused_layer if s <= 32 else layer_ops.fused_layer_long
    before = _counts(counter, "launches", "float32_launches", "narrow_launches")
    out = layer_ops.fused_layer(*inputs)
    assert _counts(counter, "launches", "float32_launches", "narrow_launches") == (
        before[0] + 1, before[1] + 1, before[2])
    ref = layer_ops.layer_reference(*inputs)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.equal(layer_ops.fused_layer(*inputs), out)
    print("K2-f32 rel rms", _rel_rms(out, ref), "max", (out - ref).abs().max().item())
    assert _rel_rms(out, ref) <= TOL_RMS
    assert ((out - ref).abs() <= TOL_F32_ATOL + TOL_F32_RTOL * ref.abs()).all()


@pytest.mark.parametrize("s", [8, 100])
def test_float32_layer_narrow_width_takes_the_wmma_form(cuda, s):
    """Float32 below the wgmma form's width (D=128, 4 heads, FF 256) still
    runs on the card, on the older wmma code, counted apart."""
    rng = np.random.default_rng(60 + s)
    d, f = 128, 256
    ln = lambda: torch.stack([1 + _f32(rng, cuda, d, scale=0.1),  # noqa: E731
                              _f32(rng, cuda, d, scale=0.1)]).contiguous()
    ws = (ln(), _f32(rng, cuda, 3 * d, d, scale=d ** -0.5), _f32(rng, cuda, 3 * d, scale=0.1),
          _f32(rng, cuda, d, d, scale=d ** -0.5), _f32(rng, cuda, d, scale=0.1), ln(),
          _f32(rng, cuda, f, d, scale=d ** -0.5), _f32(rng, cuda, f, scale=0.1),
          _f32(rng, cuda, d, f, scale=f ** -0.5), _f32(rng, cuda, d, scale=0.1))
    b = 6
    inputs = (_f32(rng, cuda, b, s, d), None, *ws, _key_mask(rng, cuda, b, s), d // 32, False)
    counter = layer_ops.fused_layer if s <= 32 else layer_ops.fused_layer_long
    before = _counts(counter, "launches", "float32_launches", "narrow_launches")
    out = layer_ops.fused_layer(*inputs)
    assert _counts(counter, "launches", "float32_launches", "narrow_launches") == (
        before[0], before[1], before[2] + 1)
    ref = layer_ops.layer_reference(*inputs)
    assert _rel_rms(out, ref) <= TOL_RMS
    assert ((out - ref).abs() <= TOL_F32_ATOL + TOL_F32_RTOL * ref.abs()).all()


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,n_group,vocab", [(1024, 32, 0, VOCAB), (60, 242, 10, VOCAB),
                                               (60, 241, 242, 512)])
def test_embedding_backward_reruns_to_the_bit(cuda, dtype, b, s, n_group, vocab):
    """K6 sums with no atomics, in an order fixed by its inputs: three runs
    give the same tables to the bit, at the flagship step's B=128 x 32
    sequences and Sketchformer's S=242 and 241 (a skewed argument column, so
    that one row spans many chunks of sorted entries)."""
    rng = np.random.default_rng(b + s)
    commands = torch.from_numpy(rng.integers(0, N_CMD, (b, s)).astype(np.int32)).to(cuda)
    args = rng.integers(-1, vocab - 1, (b, s, N_ARGS))
    args[rng.random(args.shape) < 0.5] = -1
    args[..., 1] = 3
    args = torch.from_numpy(args.astype(np.float32)).to(cuda)
    groups = torch.from_numpy(rng.integers(0, max(n_group, 1), (b, s)).astype(np.int32)).to(cuda)
    dy = _bf16(rng, cuda, b, s, D).to(dtype)
    use = n_group > 0
    runs = [emb_ops.embedding_backward(commands, args, groups, dy, N_CMD, vocab, n_group, use)
            for _ in range(3)]
    assert all(torch.equal(x, y) for run in runs[1:] for x, y in zip(runs[0], run))
    tables = [torch.zeros(n, D, device=cuda, requires_grad=True)
              for n in (N_CMD, N_ARGS * vocab, max(n_group, 1), s)]
    want = torch.autograd.grad(emb_ops.embedding_reference(
        commands, args, groups, *tables, use), tables, dy.float(), allow_unused=True)
    for got, ref in zip(runs[0], want):
        if ref is not None:
            assert (got - ref[:got.shape[0]]).abs().max() <= 1e-5 * ref.abs().max()


def _decode_inputs(rng, dev, n_layers, r, t):
    """K9's operands at the flagship's widths: per-layer weight stacks, random
    caches, and key padding with EOS-padded tails (row 1 open at position 0
    only, row 2 fully masked, others from random positions on)."""
    stacks = [torch.stack(ws).contiguous() for ws in
              zip(*(_layer_weights(rng, dev, BF16) for _ in range(n_layers)))]
    lnf = torch.stack([1 + _bf16(rng, dev, D, scale=0.1), _bf16(rng, dev, D, scale=0.1)])
    key_pad = torch.zeros(r, t, device=dev)
    eos = torch.from_numpy(rng.integers(1, t, r)).to(dev)
    tail = torch.arange(r, device=dev) % 3 == 0
    key_pad[tail] = torch.where(torch.arange(t, device=dev)[None] < eos[tail, None], 0.0,
                                float("-inf"))
    key_pad[1, 1:] = float("-inf")
    key_pad[2] = float("-inf")
    return (_bf16(rng, dev, r, D), _bf16(rng, dev, n_layers, r, D, scale=0.3), *stacks,
            lnf.contiguous(), _bf16(rng, dev, n_layers, r, t, D), _bf16(rng, dev, n_layers, r, t, D),
            key_pad)


DECODE_ROWS = (13, 64, 65, 1000, 1024)
DECODE_INDICES = (0, 1, 120, 240)


def _decode_case(dev, dtype, r, index, seed):
    """K9 at T = 241, four layers, on the flagship's widths in ``dtype``: the
    kernel's outputs (counted: the cluster kernel must launch, the older one
    not), its second run on the same inputs, and the plain version's."""
    rng = np.random.default_rng(seed)
    inputs = [t.to(dtype) if t.dtype == BF16 else t for t in _decode_inputs(rng, dev, 4, r, 241)]
    fn = decode_ops.fused_decode_step
    names = ("launches", "float32_launches", "cluster_launches", "narrow_launches")
    before = _counts(fn, *names)
    got = fn(*inputs, index, H)
    again = fn(*inputs, index, H)
    f32 = int(dtype == torch.float32)
    assert _counts(fn, *names) == (before[0] + 2, before[1] + 2 * f32, before[2] + 2, before[3])
    return got, again, decode_ops.decode_step_reference(*inputs, index, H)


@pytest.mark.parametrize("index", DECODE_INDICES)
@pytest.mark.parametrize("r", DECODE_ROWS)
def test_decode_kernel_matches_plain(cuda, r, index):
    """K9's cluster kernel against its plain version at T = 241, four
    layers: y, the new keys and values of every layer, at batches of one
    cluster with a partial block (13), whole clusters (64), a cluster whose
    second block has no rows (65), and the decode's batch (1,000, 1,024:
    63 and 64 clusters of two 8-row blocks in one wave), at the first step
    (no cached position), the second and deep into the caches; a second
    run equal to the bit."""
    got, again, want = _decode_case(cuda, BF16, r, index, r + index)
    for name, o, o2, ref in zip(("y", "k_new", "v_new"), got, again, want):
        ref = ref.float()
        err = (o.float() - ref).abs()
        print(f"K9 R={r} index {index} {name}: rel rms {_rel_rms(o, ref):.3g}")
        assert o.dtype == BF16 and o.shape == ref.shape and torch.isfinite(o).all(), name
        assert (err <= TOL_ATOL + TOL_RTOL * ref.abs()).all(), (name, err.max().item())
        assert _rel_rms(o, ref) <= 2 * TOL_RMS, (name, _rel_rms(o, ref))
        assert torch.equal(o, o2), name


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_decode_narrow_width_takes_the_older_kernel(cuda, dtype):
    """A width the cluster kernel does not take (D=128, 4 heads, F=256) runs
    the older K9 kernel, counted under ``narrow_launches``, within the same
    limits."""
    rng = np.random.default_rng(128)
    d, heads, f, r, tl, index = 128, 4, 256, 40, 33, 20

    def t(*shape, scale=1.0):
        return _bf16(rng, cuda, *shape, scale=scale).to(dtype)

    def ln(*lead):
        return torch.stack([1 + t(*lead, d, scale=0.1), t(*lead, d, scale=0.1)],
                           len(lead)).contiguous()

    inputs = (t(r, d), t(4, r, d, scale=0.3), ln(4), t(4, 3 * d, d, scale=d ** -0.5),
              t(4, 3 * d, scale=0.1), t(4, d, d, scale=d ** -0.5), t(4, d, scale=0.1), ln(4),
              t(4, f, d, scale=d ** -0.5), t(4, f, scale=0.1), t(4, d, f, scale=f ** -0.5),
              t(4, d, scale=0.1), ln(), t(4, r, tl, d), t(4, r, tl, d),
              torch.zeros(r, tl, device=cuda))
    fn = decode_ops.fused_decode_step
    before = _counts(fn, "cluster_launches", "narrow_launches")
    got = fn(*inputs, index, heads)
    assert _counts(fn, "cluster_launches", "narrow_launches") == (before[0], before[1] + 1)
    want = decode_ops.decode_step_reference(*inputs, index, heads)
    atol, rtol = (TOL_ATOL, TOL_RTOL) if dtype == BF16 else (TOL_F32_ATOL, TOL_F32_RTOL)
    for name, o, ref in zip(("y", "k_new", "v_new"), got, want):
        ref = ref.float()
        assert torch.isfinite(o).all(), name
        assert ((o.float() - ref).abs() <= atol + rtol * ref.abs()).all(), name
        assert _rel_rms(o, ref) <= 2 * TOL_RMS, name


def test_decode_kernel_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(0)
    inputs = list(_decode_inputs(rng, cuda, 2, 16, 9))
    with pytest.raises(ValueError, match="index"):
        decode_ops.fused_decode_step(*inputs, 9, H)
    inputs[-1] = inputs[-1].to(BF16)                   # key_pad must be float32
    with pytest.raises(ValueError, match="key_pad"):
        decode_ops.fused_decode_step(*inputs, 3, H)


# ---- the float32 forms of K1, K3, K5, K8 and K9: float32 operands, TF32
# products (K1: none, an exact float32 sum), float32 sums. Their limits: K1
# 1e-6 of the largest entry (it reads 0); K5's loss and gradients by relative
# RMS, about four times the readings on the H100 (PERF.md: 4.4e-5 and
# 2.8e-4); K3's ids where the plain top-2 margin is at least 1e-2; K9 by the
# float32 layer limits.
CE_F32_RMS, CE_F32_GRAD_RMS = 2e-4, 1e-3


def _f32(rng, dev, *shape, scale=1.0):
    return torch.from_numpy(scale * rng.normal(size=shape).astype(np.float32)).to(dev)


def _counts(fn, *names):
    return tuple(getattr(fn, n) for n in names)


def test_embedding_float32_form(cuda):
    """K1 in float32: the exact float32 gather-sum, no rounding anywhere;
    max abs err at most 1e-6 of the largest entry."""
    rng = np.random.default_rng(32)
    b, s, n_group = 16, 32, 10
    commands = torch.from_numpy(rng.integers(0, N_CMD, (b, s)).astype(np.int32)).to(cuda)
    args = torch.from_numpy(rng.integers(-1, VOCAB - 1, (b, s, N_ARGS)).astype(np.float32)).to(cuda)
    groups = torch.from_numpy(rng.integers(0, n_group, (b, s)).astype(np.int32)).to(cuda)
    commands[1, 2], args[2, 1, 0] = N_CMD + 2, -3
    inputs = (commands, args, groups, _f32(rng, cuda, N_CMD, D), _f32(rng, cuda, N_ARGS * VOCAB, D),
              _f32(rng, cuda, n_group, D), _f32(rng, cuda, s, D), True)
    before = _counts(emb_ops.fused_embedding, "launches", "float32_launches")
    out = emb_ops.fused_embedding(*inputs)
    assert _counts(emb_ops.fused_embedding, "launches", "float32_launches") == (
        before[0] + 1, before[1] + 1)
    ref = emb_ops.embedding_reference(*inputs)
    err = (out - ref).abs().max().item()
    print(f"K1 float32: max abs err {err:.3g} of max {ref.abs().max().item():.3g}")
    assert out.dtype == torch.float32 and err <= 1e-6 * ref.abs().max().item()


def test_head_float32_form(cuda):
    """K3 in float32 (TF32 products): ids equal to the plain version's
    wherever its top-2 margin is at least 1e-2; exact ties to the first."""
    rng = np.random.default_rng(44)
    r = 1000
    x = _f32(rng, cuda, r, D)
    wc, bc = _f32(rng, cuda, N_CMD, D, scale=D ** -0.5), _f32(rng, cuda, N_CMD)
    wa, ba = _f32(rng, cuda, N_ARGS * VOCAB, D, scale=D ** -0.5), _f32(rng, cuda, N_ARGS * VOCAB)
    wc[5], bc[5] = wc[2], bc[2]
    w, b = head_ops.pack_head(wc, bc, wa, ba, N_ARGS)
    before = _counts(head_ops.fused_head_argmax, "launches", "float32_launches")
    ids = head_ops.fused_head_argmax(x, w, b, N_CMD, N_ARGS, VOCAB).long()
    assert _counts(head_ops.fused_head_argmax, "launches", "float32_launches") == (
        before[0] + 1, before[1] + 1)
    ref = head_ops.head_argmax_reference(x, w, b, N_CMD, N_ARGS, VOCAB).long()
    assert not (ids[:, 0] == 5).any()
    offsets = torch.tensor([0] + [head_ops._round_up(N_CMD) + i * head_ops._round_up(VOCAB)
                                  for i in range(N_ARGS)], device=cuda)
    logits = torch.matmul(x, w.t()) + b
    gap = logits.gather(1, offsets + ref) - logits.gather(1, offsets + ids)
    print(f"K3 float32: {int((ids != ref).sum())} of {ids.numel()} ids differ, largest gap "
          f"{gap.abs().max().item():.3g}")
    assert (gap.abs()[ids != ref] < 1e-2).all()


@pytest.mark.parametrize("vocab", [VOCAB, 512])
def test_pairwise_ce_float32_form(cuda, vocab):
    """K8 in float32: each variant's columns equal K5's float32 forward to the
    bit, and the plain version within K5's float32 limit."""
    rng = np.random.default_rng(88 + vocab)
    r, n_variants = 1000, 8
    y = _f32(rng, cuda, r, D)
    wa = _f32(rng, cuda, N_ARGS * vocab, D, scale=D ** -0.5)
    ba = _f32(rng, cuda, N_ARGS * vocab)
    k = n_variants * N_ARGS
    tgt = torch.from_numpy(rng.integers(0, vocab, (r, k)).astype(np.int32)).to(cuda)
    tgt[3, 2], tgt[4, k - 1] = vocab + 3, -1
    before = _counts(ce_ops.args_ce_pairwise, "launches", "float32_launches")
    ce = ce_ops.args_ce_pairwise(y, wa, ba, tgt, n_variants, torch.float32)
    assert _counts(ce_ops.args_ce_pairwise, "launches", "float32_launches") == (
        before[0] + 1, before[1] + 1)
    ref = ce_ops.args_ce_pairwise_reference(y, wa, ba, tgt, n_variants)
    print(f"K8 float32: rel rms {_rel_rms(ce, ref):.3g}")
    assert ce.dtype == torch.float32 and _rel_rms(ce, ref) <= CE_F32_RMS
    k5 = torch.cat([ce_ops.args_ce(y, wa, ba, tgt[:, g * N_ARGS:(g + 1) * N_ARGS].contiguous(),
                                   torch.float32) for g in range(n_variants)], dim=1)
    assert torch.equal(ce, k5)


# ---- K5 in every form the paths take: bf16 and float32, 257 and 512 classes,
# R from one row to the paths' 14,460 (Sketchformer), 14,880 (B=60) and
# 31,744 (B=128); targets outside [0, vocab) and rows of g that are zero.
# Limits as above: ce within TOL_CE in bf16 (relative RMS CE_F32_RMS in
# float32), the gradients' relative RMS within 1e-2 (CE_F32_GRAD_RMS).
TOL_CE = 1e-3
K5_ROWS = [1, 63, 65, 129, 2000, 14460, 14880, 31744]


def _k5_case(rng, dev, dtype, r, vocab, d=D):
    make = _bf16 if dtype == BF16 else _f32
    y = make(rng, dev, r, d).to(dtype).requires_grad_()
    wa = make(rng, dev, N_ARGS * vocab, d, scale=d ** -0.5).float().requires_grad_()
    ba = make(rng, dev, N_ARGS * vocab).float().requires_grad_()
    tgt = torch.from_numpy(rng.integers(0, vocab, (r, N_ARGS)).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.random((r, N_ARGS)).astype(np.float32)).to(dev) / r
    if r > 5:
        tgt[3, 2], tgt[4, 0], tgt[5, 1] = vocab, -1, vocab - 1   # two match no class
    if r > 2:
        g[r // 2] = g[-1] = 0.0                                  # rows that add nothing
    return y, wa, ba, tgt, g


@pytest.mark.parametrize("r", K5_ROWS)
@pytest.mark.parametrize("vocab", [VOCAB, 512])
@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_ce_kernel_matches_plain(cuda, dtype, vocab, r):
    """K5's forward and its three gradients against the plain version; the
    launch counters move by one a pass; the gradients equal to the bit on a
    rerun (fixed-order sums, no atomics)."""
    rng = np.random.default_rng(r + vocab)
    y, wa, ba, tgt, g = _k5_case(rng, cuda, dtype, r, vocab)
    names = ("launches", "backward_launches", "float32_launches", "float32_backward_launches")
    before = _counts(ce_ops.args_ce, *names)
    ce = ce_ops.args_ce(y, wa, ba, tgt, dtype)
    grads = torch.autograd.grad(ce, [y, wa, ba], g)
    f32 = int(dtype == torch.float32)
    assert _counts(ce_ops.args_ce, *names) == (before[0] + 1, before[1] + 1, before[2] + f32,
                                               before[3] + f32)
    ref = ce_ops.args_ce_reference(y, wa.to(dtype), ba.to(dtype), tgt, N_ARGS)
    ref_grads = torch.autograd.grad(ref, [y, wa, ba], g)
    err, rms = (ce - ref).abs().max().item(), _rel_rms(ce, ref)
    print(f"K5 {dtype} {vocab} classes R={r}: ce max abs err {err:.3g}, rel rms {rms:.3g}")
    assert ce.shape == (r, N_ARGS) and ce.dtype == torch.float32
    assert (err <= TOL_CE) if dtype == BF16 else (rms <= CE_F32_RMS)
    limit = 1e-2 if dtype == BF16 else CE_F32_GRAD_RMS
    for name, got, want in zip(("dy", "dWa", "dba"), grads, ref_grads):
        print(f"  {name}: rel rms {_rel_rms(got, want):.3g}")
        assert got.shape == want.shape and _rel_rms(got, want) <= limit, name
    again = torch.autograd.grad(ce_ops.args_ce(y, wa, ba, tgt, dtype), [y, wa, ba], g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_args_ce_widths(cuda, dtype):
    """K5 and K8 take D a multiple of 32 up to 256 (32, 128 and 256 against
    the plain version) and refuse D=48 and D=288."""
    for d in (32, 128, 256):
        rng = np.random.default_rng(d)
        y, wa, ba, tgt, g = _k5_case(rng, cuda, dtype, 300, VOCAB, d)
        ce = ce_ops.args_ce(y, wa, ba, tgt, dtype)
        grads = torch.autograd.grad(ce, [y, wa, ba], g)
        ref = ce_ops.args_ce_reference(y, wa.to(dtype), ba.to(dtype), tgt, N_ARGS)
        ref_grads = torch.autograd.grad(ref, [y, wa, ba], g)
        assert ((ce - ref).abs().max().item() <= TOL_CE if dtype == BF16
                else _rel_rms(ce, ref) <= CE_F32_RMS), d
        limit = 1e-2 if dtype == BF16 else CE_F32_GRAD_RMS
        assert all(_rel_rms(a, b) <= limit for a, b in zip(grads, ref_grads)), d
        pair = ce_ops.args_ce_pairwise(y.detach(), wa, ba, tgt, 1, dtype)
        assert torch.equal(pair, ce), d
    for d in (48, 288):
        y = torch.zeros(8, d, device=cuda, dtype=dtype)
        w, b = torch.zeros(N_ARGS * VOCAB, d, device=cuda), torch.zeros(N_ARGS * VOCAB, device=cuda)
        tgt = torch.zeros(8, N_ARGS, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="multiple of 32 up to 256"):
            ce_ops.args_ce(y, w, b, tgt, dtype)
        with pytest.raises(ValueError, match="multiple of 32 up to 256"):
            ce_ops.args_ce_pairwise(y, w, b, tgt, 1, dtype)


def test_ce_kernels_are_wgmma_kernels(cuda):
    """K5's forward (and K8's, the same kernel), dy and dW kernels, in both
    types, multiply with Hopper's warpgroup instructions: HGMMA in the built
    library's SASS (cuobjdump)."""
    import re
    import shutil
    import subprocess

    from deepsvg_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build.build()], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    ce = {n: c for n, c in counts.items() if re.search(r"ce_(fwd|bwd_dy|bwd_dw)_kernel", n)}
    print("HGMMA instructions:", {re.sub(r"^.*?(ce_\w+_kernelI\w{1,20}).*$", r"\1", n): c
                                  for n, c in ce.items()})
    assert len(ce) == 6 and all(c > 0 for c in ce.values()), ce


@pytest.mark.parametrize("index", DECODE_INDICES)
@pytest.mark.parametrize("r", DECODE_ROWS)
def test_decode_float32_form(cuda, r, index):
    """K9's cluster kernel in float32 (TF32 products) at T = 241, four
    layers, the bfloat16 test's batches and positions: y and the new keys
    and values against the plain version in full float32, with the float32
    layer's elementwise limits and twice its relative RMS limit; a second
    run equal to the bit."""
    got, again, want = _decode_case(cuda, torch.float32, r, index, r + index + 7)
    for name, o, o2, ref in zip(("y", "k_new", "v_new"), got, again, want):
        err = (o - ref).abs()
        print(f"K9 float32 R={r} index {index} {name}: rel rms {_rel_rms(o, ref):.3g}")
        assert o.dtype == torch.float32 and torch.isfinite(o).all(), name
        assert (err <= TOL_F32_ATOL + TOL_F32_RTOL * ref.abs()).all(), (name, err.max().item())
        assert _rel_rms(o, ref) <= 2 * TOL_RMS, name
        assert torch.equal(o, o2), name


# ---- K10 and K11: the attention block alone. The kernel rounds QKV, the
# probabilities and the context at the plain version's points (bfloat16) or
# multiplies in TF32 (float32); the layer's limits for the output. K11's
# gradients by relative RMS, about four times the largest reading on the H100
# (PERF.md: 1.0e-3 in bfloat16, 5.4e-4 in float32).
MHA_GRAD_RMS = {BF16: 4e-3, torch.float32: 2e-3}


def _mha_inputs(rng, dev, dtype, b, s):
    x = _bf16(rng, dev, b, s, D).to(dtype)
    w = (_bf16(rng, dev, 3 * D, D, scale=D ** -0.5), _bf16(rng, dev, 3 * D, scale=0.1),
         _bf16(rng, dev, D, D, scale=D ** -0.5), _bf16(rng, dev, D, scale=0.1))
    return x, [t.to(dtype) for t in w], _key_mask(rng, dev, b, s)


def _hold_output(out, ref, dtype):
    err = (out.float() - ref.float()).abs()
    atol, rtol = (TOL_ATOL, TOL_RTOL) if dtype == BF16 else (TOL_F32_ATOL, TOL_F32_RTOL)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (err <= atol + rtol * ref.float().abs()).all(), (err - rtol * ref.abs()).max().item()
    assert _rel_rms(out, ref) <= TOL_RMS, _rel_rms(out, ref)


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [8, 32, 33, 241, 242, 256])
def test_mha_kernel_matches_plain(cuda, s, causal, dtype):
    """K10 against ``mha_reference`` with key padding; sequence 0 has every
    key masked and gets zero probabilities (its output is ``bo``)."""
    rng = np.random.default_rng(s + 2 * causal)
    x, w, mask = _mha_inputs(rng, cuda, dtype, 5, s)
    before = attn_ops.fused_mha.launches
    out = attn_ops.fused_mha(x, *w, mask, H, causal)
    assert attn_ops.fused_mha.launches == before + 1
    ref = attn_ops.mha_reference(x, *w, mask, H, causal)
    print(f"K10 {dtype} S={s} causal={causal}: rel rms {_rel_rms(out, ref):.3g}")
    _hold_output(out, ref, dtype)
    assert torch.equal(out[0], w[3].expand(s, D))


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("s", [32, 241, 242])
def test_mha_train_kernel_matches_plain(cuda, s, rate, dtype):
    """K11 forward and backward against the plain version under autograd
    with the same hash masks (S=241 causal), elementwise with dropout on;
    reruns bit-equal."""
    causal = s == 241
    rng = np.random.default_rng(s + int(rate * 10))
    x, w, mask = _mha_inputs(rng, cuda, dtype, 3, s)
    leaves = [t.requires_grad_() for t in (x, *w)]
    g = _bf16(rng, cuda, 3, s, D).to(dtype)
    seed = 4321
    names = ("launches", "backward_launches")
    before = _counts(attention_vjp.fused_mha_train, *names)
    out = attention_vjp.fused_mha_train(x, *w, mask, seed, H, causal, rate)
    grads = torch.autograd.grad(out, leaves, g)
    assert _counts(attention_vjp.fused_mha_train, *names) == (before[0] + 1, before[1] + 1)
    ref = attn_ops.mha_reference(x, *w, mask, H, causal, rate, seed)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    print(f"K11 {dtype} S={s} rate={rate}: fwd rel rms {_rel_rms(out, ref):.3g}")
    _hold_output(out, ref, dtype)
    for name, got, want in zip(("x", "wqkv", "bqkv", "wo", "bo"), grads, ref_grads):
        print(f"  d{name}: rel rms {_rel_rms(got, want):.3g}")
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        assert _rel_rms(got, want) <= MHA_GRAD_RMS[dtype], name
    out2 = attention_vjp.fused_mha_train(x, *w, mask, seed, H, causal, rate)
    again = torch.autograd.grad(out2, leaves, g)
    assert torch.equal(out, out2) and all(torch.equal(a, c) for a, c in zip(grads, again))


def test_mha_kernels_refuse_what_they_do_not_take(cuda):
    """S = 257, head dim 16 and mixed types raise, in both wrappers."""
    rng = np.random.default_rng(0)
    calls = (lambda x, w, mask, heads: attn_ops.fused_mha(x, *w, mask, heads),
             lambda x, w, mask, heads: attention_vjp.fused_mha_train(x, *w, mask, 0, heads))
    for fn in calls:
        x, w, mask = _mha_inputs(rng, cuda, BF16, 2, 257)
        with pytest.raises(ValueError, match="S <= 256"):
            fn(x, w, mask, H)
        x, w, mask = _mha_inputs(rng, cuda, BF16, 2, 16)
        with pytest.raises(ValueError, match="head dim 32"):
            fn(x, w, mask, 2 * H)                          # head dim 16
        with pytest.raises(ValueError, match="dtype"):
            fn(x, [w[0].float(), *w[1:]], mask, H)


# ------------------------------------------- K1 and K6 redesigned for Hopper

def _embedding_ids(rng, dev, b, s, vocab, n_group, pad=0.5):
    """Ids as the model gives them (commands int32, arguments float with PAD
    -1, groups int32), a share ``pad`` of the arguments PAD, and an
    out-of-range command, argument (both ways) and group."""
    commands = torch.from_numpy(rng.integers(0, N_CMD, (b, s)).astype(np.int32)).to(dev)
    args = rng.integers(-1, vocab - 1, (b, s, N_ARGS)).astype(np.float32)
    args[rng.random(args.shape) < pad] = -1
    args = torch.from_numpy(args).to(dev)
    groups = torch.from_numpy(rng.integers(0, max(n_group, 1), (b, s)).astype(np.int32)).to(dev)
    commands[0, 0], args[0, s - 1, 4], args[b - 1, 0, 0] = N_CMD + 2, vocab + 5, -3
    groups[b - 1, s - 1] = n_group
    return commands, args, groups


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,vocab,n_group", [
    (4099, 1, VOCAB, 10),          # S=1, rows not a multiple of a block's 8
    (77, 32, VOCAB, 10),           # the flagship's S (position rows in shared memory)
    (13, 241, 512, 242),           # Sketchformer's decoder and encoder, a 242-row group
    (13, 242, 512, 242),           # table (position rows from L2 in both types)
])
@pytest.mark.parametrize("use_group", [False, True])
def test_embedding_hopper_form_matches_plain(cuda, dtype, b, s, vocab, n_group, use_group):
    """K1's Hopper form at D=256 against its plain version: the float32 form
    exact to 1e-6 of the largest entry, bfloat16 one rounding (1e-2); only
    the Hopper kernel's count moves."""
    rng = np.random.default_rng(b + s)
    commands, args, groups = _embedding_ids(rng, cuda, b, s, vocab, n_group)
    tables = [_bf16(rng, cuda, n, D).to(dtype) for n in (N_CMD, N_ARGS * vocab, n_group, s)]
    inputs = (commands, args, groups, tables[0], tables[1], tables[2], tables[3], use_group)
    before = _counts(emb_ops.fused_embedding, "launches", "narrow_launches")
    out = emb_ops.fused_embedding(*inputs)
    assert _counts(emb_ops.fused_embedding, "launches", "narrow_launches") == (
        before[0] + 1, before[1])
    ref = emb_ops.embedding_reference(*inputs)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"K1 {dtype} B={b} S={s} group {use_group}: max abs err {err:.3g}")
    assert out.dtype == dtype and out.shape == (b, s, D)
    assert err <= (1e-6 * ref.abs().max().item() if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_embedding_width_the_hopper_forms_refuse(cuda, dtype):
    """D=200 (even, no multiple of 64): K1 takes its first kernel, counted
    under narrow_launches, and K6 (any D a multiple of 8) its one kernel;
    D=202 makes K6 raise."""
    rng = np.random.default_rng(200)
    b, s, d, n_group = 9, 32, 200, 10
    commands, args, groups = _embedding_ids(rng, cuda, b, s, VOCAB, n_group)
    tables = [_bf16(rng, cuda, n, d).to(dtype).requires_grad_()
              for n in (N_CMD, N_ARGS * VOCAB, n_group, s)]
    inputs = (commands, args, groups, *tables, True)
    before = _counts(emb_ops.fused_embedding, "launches", "narrow_launches")
    out = emb_ops.fused_embedding(*inputs)
    assert _counts(emb_ops.fused_embedding, "launches", "narrow_launches") == (
        before[0] + 1, before[1] + 1)
    ref = emb_ops.embedding_reference(*inputs)
    assert (out.float() - ref.float()).abs().max().item() <= (
        1e-6 * ref.abs().max().item() if dtype == torch.float32 else 1e-2)
    dy = _bf16(rng, cuda, b, s, d).to(dtype)
    got = emb_ops.embedding_backward(commands, args, groups, dy, N_CMD, VOCAB, n_group, True)
    tables32 = [t.detach().float().requires_grad_() for t in tables]
    want = torch.autograd.grad(emb_ops.embedding_reference(
        commands, args, groups, *tables32, True), tables32, dy.float())
    for a, w in zip(got, want):
        assert (a - w).abs().max().item() <= 1e-5 * w.abs().max().item() + 1e-5
    with pytest.raises(ValueError, match="multiple of 8"):
        emb_ops.embedding_backward(commands, args, groups, _bf16(rng, cuda, b, s, 202), N_CMD,
                                   VOCAB, n_group, True)


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ["one_row_every_token", "one_row_every_block"])
@pytest.mark.parametrize("b", [128, 1024])
def test_embedding_backward_adversarial_rows(cuda, dtype, case, b):
    """K6 where its segments are extreme: every token's argument 3 on one
    cold row (4,096 or 32,768 entries, and every slot's other rows empty),
    or one row hit by exactly one token in every run of 128 tokens (K6's
    blocks are 128 tokens at B=128 x 32, 256 at B=1024 x 32). Against its
    plain version, and three runs equal to the bit."""
    rng = np.random.default_rng(3)
    s, n_group = 32, 10
    commands, args, groups = _embedding_ids(rng, cuda, b, s, VOCAB, n_group, pad=0.9)
    if case == "one_row_every_token":
        args[..., 3] = 7.0
        groups.fill_(4)
    else:
        flat = args.view(-1, N_ARGS)
        flat[:, 5] = -1
        flat[::128, 5] = 200.0            # the first token of every block
    tables = [torch.zeros(n, D, device=cuda, requires_grad=True)
              for n in (N_CMD, N_ARGS * VOCAB, n_group, s)]
    dy = _bf16(rng, cuda, b, s, D).to(dtype)
    runs = [emb_ops.embedding_backward(commands, args, groups, dy, N_CMD, VOCAB, n_group, True)
            for _ in range(3)]
    assert all(torch.equal(x, y) for run in runs[1:] for x, y in zip(runs[0], run))
    want = torch.autograd.grad(emb_ops.embedding_reference(
        commands, args, groups, *tables, True), tables, dy.float())
    for got, ref in zip(runs[0], want):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_embedding_backward_is_one_launch_and_no_sort(cuda, dtype, monkeypatch):
    """K6 at the flagship step's B=128 x 32 on int32 ids (as the model's
    backward gets them): one call of its C entry point a call and no sort
    (counted by spies), and under the profiler at most two kernels a call,
    K6's own among them, none a sort."""
    from torch.profiler import ProfilerActivity, profile
    from deepsvg_tpu_torch.ops import _build
    rng = np.random.default_rng(5)
    b, s, calls = 1024, 32, 5
    commands, args, groups = _embedding_ids(rng, cuda, b, s, VOCAB, 0, pad=0.9)
    args = args.to(torch.int32)
    dy = _bf16(rng, cuda, b, s, D).to(dtype)
    entered, sorts = [], []
    kernel_function = _build.kernel_function

    def spy_function(name, argtypes):
        fn = kernel_function(name, argtypes)
        return lambda *a: (entered.append(name), fn(*a))[1]
    monkeypatch.setattr(_build, "kernel_function", spy_function)
    for name in ("sort", "argsort"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, real=real, **k: (sorts.append(1),
                                                                       real(*a, **k))[1])
    emb_ops.embedding_backward(commands, args, groups, dy, N_CMD, VOCAB, 0, False)
    assert entered == ["dsvg_embedding_bwd"] and not sorts
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            emb_ops.embedding_backward(commands, args, groups, dy, N_CMD, VOCAB, 0, False)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    print(f"K6 kernels over {calls} calls: {names}")
    assert len(names) <= 2 * calls and any("embedding_bwd" in n for n in names)
    assert not any("sort" in n.lower() for n in names)
