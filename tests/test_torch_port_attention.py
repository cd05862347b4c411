"""The port's attention block (``ops/attention.py``, K10, and
``ops/attention_vjp.py``, K11) against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions (the
Pallas kernels in interpret mode, as ``tests/test_ops.py`` runs them) and
the port's plain versions, which is what the port's wrappers run for CPU
tensors. The weights pass through ``models.weights.attention_operands``.
Widths are small (D=64, head dim 32); tolerances are stated at each test.

Where a query has every key masked, the JAX functions give NaN and the port
gives zero probabilities (an output of ``bo``): the comparisons with JAX
keep every query a key, and one test holds the port's zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu.ops.attention import fused_mha as jax_fused_mha
from deepsvg_tpu.ops.attention import mha_blockpacked as jax_mha_blockpacked
from deepsvg_tpu.ops.attention import mha_reference as jax_mha_reference
from deepsvg_tpu.ops.attention import pick_tile_b
from deepsvg_tpu.ops.attention_vjp import fused_mha_train as jax_fused_mha_train
from deepsvg_tpu_torch.models.weights import attention_operands
from deepsvg_tpu_torch.ops import attention as port_attention
from deepsvg_tpu_torch.ops import attention_vjp as port_attention_vjp
from deepsvg_tpu_torch.ops import dropout as port_dropout
from deepsvg_tpu_torch.ops import layer_vjp as port_layer_vjp

D, H = 64, 2        # head dim 32, as the port's kernels take


def _inputs(seed, b, s, d=D):
    """x and the JAX layout's weights (``x @ wqkv``), float32, as
    ``tests/test_ops.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    wqkv = (rng.standard_normal((d, 3 * d)) * 0.05).astype(np.float32)
    bqkv = (rng.standard_normal(3 * d) * 0.05).astype(np.float32)
    wo = (rng.standard_normal((d, d)) * 0.05).astype(np.float32)
    bo = (rng.standard_normal(d) * 0.05).astype(np.float32)
    return x, (wqkv, bqkv, wo, bo)


def _trailing_pad(b, s, n_pad=6):
    mask = np.zeros((b, s), np.float32)
    mask[:, max(s - n_pad, 1):] = -np.inf
    return mask


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [8, 31, 32, 40])
def test_mha_reference_matches_jax(s, causal):
    """Port ``mha_reference`` (what ``fused_mha`` runs on the CPU) against
    JAX ``mha_reference`` (XLA) and JAX ``fused_mha`` (the Pallas kernel,
    interpret mode), key padding on trailing positions. float32, atol 2e-5
    (``TestFusedMHA``'s own)."""
    b = 16
    x, w = _inputs(s, b, s)
    mask = _trailing_pad(b, s)
    want_xla = np.asarray(jax_mha_reference(*_jax(x, *w, mask), H, causal=causal))
    want_pallas = np.asarray(jax_fused_mha(*_jax(x, *w, mask), n_heads=H,
                                           tile_b=pick_tile_b(b, s), causal=causal))
    got = port_attention.fused_mha(torch.from_numpy(x), *attention_operands(*w),
                                   torch.from_numpy(mask), H, causal).numpy()
    np.testing.assert_allclose(got, want_xla, atol=2e-5)
    np.testing.assert_allclose(got, want_pallas, atol=2e-5)


@pytest.mark.parametrize("s,causal", [(8, False), (31, True), (32, False)])
def test_mha_blockpacked_matches_jax(s, causal):
    """Port ``mha_blockpacked`` against JAX's at the same inputs and tile,
    and against the port's ``mha_reference``. float32, atol 2e-5."""
    b = 16
    x, w = _inputs(100 + s, b, s)
    mask = _trailing_pad(b, s)
    tile_b = pick_tile_b(b, s)
    want = np.asarray(jax_mha_blockpacked(*_jax(x, *w, mask), H, causal=causal, tile_b=tile_b))
    ops = (torch.from_numpy(x), *attention_operands(*w), torch.from_numpy(mask), H, causal)
    got = port_attention.mha_blockpacked(*ops, tile_b=tile_b).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, port_attention.mha_reference(*ops).numpy(), atol=2e-5)


def _port_value_and_grads(x, w, mask, causal, rate=0.0, seed=0, dtype=torch.float32):
    """The port's plain ``fused_mha_train`` (autograd) and the gradients of
    ``sum(out ** 2)`` in the JAX layout: (out, [dx, dwqkv, dbqkv, dwo, dbo])."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    ops = [t.requires_grad_() for t in attention_operands(*w, dtype=dtype)]
    out = port_attention_vjp.fused_mha_train(xt, *ops, torch.from_numpy(mask), seed, H, causal,
                                             rate)
    (out.float() ** 2).sum().backward()
    dwqkv, dbqkv, dwo, dbo = (t.grad.float().numpy() for t in ops)
    return out.detach().float().numpy(), [xt.grad.float().numpy(), dwqkv.T, dbqkv, dwo.T, dbo]


def _jax_value_and_grads(x, w, mask, causal, dtype=jnp.float32):
    seed = jnp.asarray([0], jnp.int32)
    mask = jnp.asarray(mask)

    def f(*a):
        return jax_fused_mha_train(*a, mask, seed, H, 4, causal, 0.0)

    args = _jax(x, *w, dtype=dtype)
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a).astype(jnp.float32) ** 2),
                     argnums=(0, 1, 2, 3, 4))(*args)
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32))
                                                 for g in grads]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_mha_train_matches_jax(causal):
    """The port's plain ``fused_mha_train`` at rate 0 against JAX
    ``fused_mha_train`` (Pallas forward and backward, interpret mode): the
    value and the gradients of x, wqkv, bqkv, wo and bo. float32, atol 5e-5
    (``TestFusedMHATrain``'s own)."""
    b, s = 8, 12
    x, w = _inputs(7, b, s)
    mask = _trailing_pad(b, s, 3) if not causal else np.zeros((b, s), np.float32)
    got, got_grads = _port_value_and_grads(x, w, mask, causal)
    want, want_grads = _jax_value_and_grads(x, w, mask, causal)
    np.testing.assert_allclose(got, want, atol=2e-5)
    for name, g, gw in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got_grads, want_grads):
        np.testing.assert_allclose(g, gw, atol=5e-5, err_msg=name)


def test_fused_mha_train_bf16_matches_jax():
    """bfloat16: both round QKV, the dropped probabilities and the context
    before their products, and dctx, ds and dq/dk/dv before theirs, and sum
    in float32, perhaps in another order. Limits: the output within one
    bfloat16 step (2^-8) of the largest |out| elementwise, every gradient
    within 1e-3 relative RMS of JAX's, a quarter of the 4e-3 by which the
    same computation in float32 differs from it. (The readings, printed,
    are 0 at this seed.)"""
    b, s = 8, 12
    x, w = _inputs(11, b, s)
    mask = _trailing_pad(b, s, 3)
    got, got_grads = _port_value_and_grads(x, w, mask, False, dtype=torch.bfloat16)
    want, want_grads = _jax_value_and_grads(x, w, mask, False, dtype=jnp.bfloat16)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"bf16 out: max abs err {err:.3g} of max |out|")
    assert err <= 2.0 ** -8
    for name, g, gw in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got_grads, want_grads):
        rms = np.linalg.norm(g - gw) / np.linalg.norm(gw)
        print(f"bf16 {name}: relative RMS err {rms:.3g}")
        assert rms <= 1e-3, name


def test_dropout_gradient_is_the_forward_mask():
    """At rate 0.3 the gradient of the port's plain ``fused_mha_train`` is
    that of the function it computes: JAX's directional finite-difference
    check (``test_dropout_mask_consistent_fwd_bwd``, rtol 2e-2), float32."""
    b, s = 4, 8
    x, w = _inputs(3, b, s)
    mask = np.zeros((b, s), np.float32)
    ops = attention_operands(*w)
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))

    def f(x_):
        out = port_attention_vjp.fused_mha_train(x_, *ops, torch.from_numpy(mask), 7, H, False,
                                                 0.3)
        return (out ** 2).sum()

    xt = torch.from_numpy(x).requires_grad_()
    f(xt).backward()
    eps = 1e-3
    with torch.no_grad():
        fd = (f(xt + eps * v) - f(xt - eps * v)) / (2 * eps)
    analytic = (xt.grad * v).sum()
    np.testing.assert_allclose(float(analytic), float(fd), rtol=2e-2)


def test_dropout_drops_the_hash_mask_of_k4():
    """The dropped probabilities are ``dropout.keep_mask(seed,
    SITE_ATTN_PROB, (b * H + h) * S + i, j)``: read out through V = the
    identity on the keys and Wo = the identity, the output is the dropped
    probabilities themselves. And at one seed they are what K4's plain
    version drops (its SITE_ATTN_PROB factor, recorded, is the same)."""
    b, s, rate, seed = 2, 16, 0.3, 1234
    x = torch.zeros(b, s, D)
    x[:, torch.arange(s), torch.arange(s)] = 1.0             # x_j = e_j
    rng = np.random.default_rng(5)
    wqkv = torch.zeros(3 * D, D)
    wqkv[:2 * D] = torch.from_numpy(rng.standard_normal((2 * D, D)).astype(np.float32))
    for h in range(H):                                       # v_j = e_j in every head
        wqkv[2 * D + h * 32 + torch.arange(s), torch.arange(s)] = 1.0
    zeros_b, eye = torch.zeros(3 * D), torch.eye(D)
    mask = torch.zeros(b, s)
    out = port_attention_vjp.fused_mha_train(x, wqkv, zeros_b, eye, torch.zeros(D), mask,
                                             seed, H, False, rate)
    kept = port_attention.mha_reference(x, wqkv, zeros_b, eye, torch.zeros(D), mask, H)
    probs = out.reshape(b, s, H, 32)[..., :s].permute(0, 2, 1, 3)      # [B, H, S, S]
    p0 = kept.reshape(b, s, H, 32)[..., :s].permute(0, 2, 1, 3)
    rows = torch.arange(b * H * s).reshape(b, H, s, 1)
    keep = port_dropout.keep_mask(seed, port_dropout.SITE_ATTN_PROB, rows, torch.arange(s), rate)
    assert 0.5 < keep.float().mean() < 0.9
    torch.testing.assert_close(probs, torch.where(keep, p0 * port_dropout.keep_scale(rate),
                                                  torch.zeros_like(p0)), atol=1e-6, rtol=1e-5)

    # K4's plain version at the same seed: the same factor at SITE_ATTN_PROB
    seen = []
    real = port_layer_vjp.dropout_factor

    def spy(seed_, site, rows_, cols, rate_):
        factor = real(seed_, site, rows_, cols, rate_)
        if site == port_dropout.SITE_ATTN_PROB:
            seen.append(factor.expand(b, H, s, s))
        return factor
    port_layer_vjp.dropout_factor = spy
    try:
        ln = torch.stack([torch.ones(D), torch.zeros(D)])
        port_layer_vjp.layer_train_reference(
            x, None, ln, wqkv, zeros_b, eye, torch.zeros(D), ln, torch.zeros(128, D),
            torch.zeros(128), torch.zeros(D, 128), torch.zeros(D), mask, seed, H, False, rate)
    finally:
        port_layer_vjp.dropout_factor = real
    assert len(seen) == 1
    assert torch.equal(seen[0] != 0, keep)


def test_fully_masked_sequence_gives_zeros():
    """Every key of sequence 0 masked: zero probabilities (the output is
    ``bo``) and finite gradients, in the forward and the training op; the
    other sequences as they are without it."""
    b, s = 4, 8
    x, w = _inputs(9, b, s)
    mask = np.zeros((b, s), np.float32)
    mask[0] = -np.inf
    ops = attention_operands(*w)
    out = port_attention.fused_mha(torch.from_numpy(x), *ops, torch.from_numpy(mask), H)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0], ops[3].expand(s, D), atol=0, rtol=0)
    alone = port_attention.fused_mha(torch.from_numpy(x[1:]), *ops, torch.from_numpy(mask[1:]),
                                     H)
    torch.testing.assert_close(out[1:], alone, atol=1e-6, rtol=1e-6)
    _, grads = _port_value_and_grads(x, w, mask, True, rate=0.1, seed=3)
    assert all(np.isfinite(g).all() for g in grads)
    assert np.abs(grads[0][0]).max() == 0.0        # sequence 0 reads nothing


def test_attention_operands_bridge():
    """JAX layout ``(wqkv [D, 3D], bqkv, wo [D, D], bo)`` -> ``nn.Linear``
    layout: ``x @ wqkv == F.linear(x, wqkv_port)``."""
    x, w = _inputs(1, 2, 3)
    wqkv, bqkv, wo, bo = attention_operands(*w, dtype=torch.float64)
    assert wqkv.shape == (3 * D, D) and wo.shape == (D, D) and wqkv.is_contiguous()
    assert wqkv.dtype == torch.float64
    xr = torch.from_numpy(x.reshape(-1, D)).double()
    np.testing.assert_allclose(torch.nn.functional.linear(xr, wqkv, bqkv).numpy(),
                               x.reshape(-1, D).astype(np.float64) @ w[0] + w[1], atol=1e-6)
    np.testing.assert_allclose(torch.nn.functional.linear(xr, wo, bo).numpy(),
                               x.reshape(-1, D).astype(np.float64) @ w[2] + w[3], atol=1e-6)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused, not run."""
    x = torch.empty((2, 8, D), device="meta")
    w = (torch.empty((3 * D, D), device="meta"), torch.empty(3 * D, device="meta"),
         torch.empty((D, D), device="meta"), torch.empty(D, device="meta"))
    mask = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        port_attention.fused_mha(x, *w, mask, H)
    with pytest.raises(ValueError, match="no attention kernel"):
        port_attention_vjp.fused_mha_train(x, *w, mask, 0, H)


@pytest.mark.parametrize("dtype,d,heads,s,form", [
    (torch.bfloat16, 256, 8, 1, "bf16_short"), (torch.bfloat16, 256, 8, 32, "bf16_short"),
    (torch.bfloat16, 256, 8, 33, "bf16_long"), (torch.bfloat16, 256, 8, 256, "bf16_long"),
    (torch.float32, 256, 8, 1, "f32"), (torch.float32, 256, 8, 256, "f32"),
    (torch.bfloat16, 128, 4, 32, "narrow"), (torch.float32, 64, 2, 241, "narrow"),
    (torch.bfloat16, 256, 16, 32, "narrow"), (torch.bfloat16, 64, 4, 31, "narrow"),
    (torch.float32, 32, 2, 8, "narrow"), (torch.float32, 32, 4, 40, "narrow"),
    (torch.bfloat16, 256, 4, 32, "head dim 32"), (torch.bfloat16, 32, 8, 8, "head dim 32"),
    (torch.bfloat16, 256, 8, 257, "S <= 256"),
    (torch.float32, 512, 16, 8, "D <= 256"), (torch.float16, 256, 8, 32, "dtype")])
def test_mha_form_dispatch_rule(dtype, d, heads, s, form):
    """The rule by which the CUDA wrappers pick their kernels, from the
    dtype, D, the heads and S alone, before any launch: at D=256 with 8
    heads the Hopper forms (bf16 one launch up to S=32, three launches
    above; float32 three), at the other widths with head dim 32, 16 or 8
    (D=256 with 16 heads among them) the first port's kernels; any other
    shape raises (head dims 64 and 4 here)."""
    if form in ("bf16_short", "bf16_long", "f32", "narrow"):
        assert port_attention.mha_form(dtype, d, heads, s) == form
    else:
        with pytest.raises(ValueError, match=form):
            port_attention.mha_form(dtype, d, heads, s)


def _jax_layout(grads, dtype):
    """``dx, dwqkv, dbqkv, dwo, dbo`` (``nn.Linear`` layout) in the JAX
    layout, rounded to ``dtype`` as the op returns them, as float32 numpy."""
    dx, dwqkv, dbqkv, dwo, dbo = (t.to(dtype).float().numpy() for t in grads)
    return [dx, dwqkv.T, dbqkv, dwo.T, dbo]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [12, 33])
def test_mha_backward_reference_matches_jax(s, causal, dtype):
    """The port's plain backward (``mha_backward_reference``, K11's yardstick
    on the card) at rate 0 against the gradients of JAX ``fused_mha_train``
    (the Pallas backward, interpret mode) of ``sum(out ** 2)``, handed JAX's
    own output gradient ``2 out``: B=8 (JAX's ``tile_b`` of 4 divides it),
    trailing key padding, every query a key; the weight gradients rounded to
    the weights' type, as the op and JAX return them. float32 atol 5e-5,
    bfloat16 1e-3 relative RMS (the tolerances of
    ``test_fused_mha_train_matches_jax`` and
    ``test_fused_mha_train_bf16_matches_jax``)."""
    b = 8
    x, w = _inputs(200 + s + causal, b, s)
    mask = _trailing_pad(b, s, 3)
    want, want_grads = _jax_value_and_grads(x, w, mask, causal, dtype=getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    wqkv, bqkv, wo, _ = attention_operands(*w, dtype=tdt)
    g = torch.from_numpy(2.0 * want).to(tdt)
    got = port_attention_vjp.mha_backward_reference(
        torch.from_numpy(x).to(tdt), g, wqkv, bqkv, wo, torch.from_numpy(mask), H, causal)
    assert got[0].dtype == tdt and all(t.dtype == torch.float32 for t in got[1:])
    for name, gp, gw in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), _jax_layout(got, tdt),
                            want_grads):
        if dtype == "float32":
            np.testing.assert_allclose(gp, gw, atol=5e-5, err_msg=name)
        else:
            rms = np.linalg.norm(gp - gw) / np.linalg.norm(gw)
            print(f"bf16 S={s} causal={causal} {name}: relative RMS err {rms:.3g}")
            assert rms <= 1e-3, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [12, 33])
def test_mha_backward_reference_matches_autograd(s, causal, dtype):
    """The plain backward with dropout (rate 0.1) against autograd of
    ``mha_reference`` with the same hash masks: B=3, sequence 0 with every
    key masked (zero gradients through it), sequence 1 padded. float32 to
    1e-5 relative RMS; bfloat16, the weight gradients rounded to the
    weights' type as the op returns them, to 1e-3 relative RMS (the two
    round at the same points and differ only in float32 summation order;
    the readings, printed, are 0 at these seeds)."""
    b, seed, rate = 3, 77, 0.1
    x, w = _inputs(300 + s + causal, b, s)
    mask = np.zeros((b, s), np.float32)
    mask[0] = -np.inf
    mask[1, s - 4:] = -np.inf
    ops = attention_operands(*w, dtype=dtype)
    xt = torch.from_numpy(x).to(dtype)
    g = torch.from_numpy(np.random.default_rng(s).standard_normal((b, s, D))
                         .astype(np.float32)).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (xt, *ops)]
    out = port_attention.mha_reference(*leaves, torch.from_numpy(mask), H, causal, rate, seed)
    want = torch.autograd.grad(out, leaves, g)
    got = port_attention_vjp.mha_backward_reference(xt, g, *ops[:3], torch.from_numpy(mask), H,
                                                    causal, rate, seed)
    assert torch.count_nonzero(got[0][0]) == 0
    for name, gp, gw in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got, want):
        rms = ((gp.to(dtype).float() - gw.float()).norm() / gw.float().norm()).item()
        print(f"{dtype} S={s} causal={causal} {name}: relative RMS {rms:.3g}")
        assert torch.isfinite(gp).all() and rms <= (1e-5 if dtype == torch.float32 else 1e-3), name
