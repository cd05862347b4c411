"""The port's training ops against the JAX package, on the CPU.

The plain PyTorch versions of the training kernels (what a wrapper runs for a
CPU tensor, differentiated by autograd) are held against the JAX Pallas
kernels they replace, run in interpret mode as the JAX package's own tests run
them on the CPU: K4 (the fused layer, forward and its twelve gradients), K5
(the argument-head cross-entropy) and K6 (the embedding tables' gradients).
Inputs are float32 unless said, small (d_model 64 with 2 heads of 32, FF 128)
and made from a seed with numpy; the tolerances are float32 rounding with the
sums taken in another order. JAX's dropout masks are not part of the contract,
so parity with JAX is at dropout 0; with dropout on, the port's hash masks are
tested on their own.

Also here: the loss, the schedules and the optimizer against their JAX-package
and optax counterparts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models.layers import DecoderLayerGlobalImproved as JaxDecoderLayer
from deepsvg_tpu.models.loss import svg_loss as jax_svg_loss
from deepsvg_tpu.ops import ce as jax_ce
from deepsvg_tpu.ops import embedding as jax_embedding
from deepsvg_tpu.ops import layer_vjp as jax_layer_vjp
from deepsvg_tpu.ops.attention import pick_tile_b
from deepsvg_tpu.training import schedulers as jax_schedulers
from deepsvg_tpu.training import trainer as jax_trainer
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import hierarchical_ordered
from deepsvg_tpu_torch.models.loss import svg_loss
from deepsvg_tpu_torch.ops import ce as port_ce
from deepsvg_tpu_torch.ops import dropout as port_dropout
from deepsvg_tpu_torch.ops import embedding as port_embedding
from deepsvg_tpu_torch.ops import layer_vjp as port_layer_vjp
from deepsvg_tpu_torch.training import schedulers as port_schedulers
from deepsvg_tpu_torch.training import trainer as port_trainer

D, H, FF = 64, 2, 128
NAMES = ("x", "seq_bias", "ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "w1", "b1", "w2", "b2")
# which of the twelve are stored transposed in the port (nn.Linear layout)
TRANSPOSED = {"wqkv", "wo", "w1", "w2"}


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _layer_inputs(rng, b, s, masked_seq=True):
    """JAX-layout inputs of the fused layer (kernels ``[in, out]``)."""
    n = lambda *shape, scale=1.0: (scale * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    ln = lambda: np.stack([1 + n(D, scale=0.1), n(D, scale=0.1)])  # noqa: E731
    vals = dict(x=n(b, s, D), seq_bias=n(b, D), ln1=ln(), wqkv=n(D, 3 * D, scale=D ** -0.5),
                bqkv=n(3 * D, scale=0.1), wo=n(D, D, scale=D ** -0.5), bo=n(D, scale=0.1),
                ln2=ln(), w1=n(D, FF, scale=D ** -0.5), b1=n(FF, scale=0.1),
                w2=n(FF, D, scale=FF ** -0.5), b2=n(D, scale=0.1))
    lengths = rng.integers(1, s + 1, b)
    if masked_seq:
        lengths[0] = 0                                  # one fully masked sequence
    mask = np.where(np.arange(s)[None] < lengths[:, None], 0.0, -np.inf).astype(np.float32)
    return vals, mask, n(b, s, D)


def _port_layer_grads(vals, mask, g, causal, rate=0.0, seed=0):
    ts = [_t(vals[k].T if k in TRANSPOSED else vals[k], grad=True) for k in NAMES]
    out = port_layer_vjp.fused_layer_train(*ts, _t(mask), seed, H, causal, rate,
                                           save_residuals=True)
    grads = torch.autograd.grad(out, ts, _t(g))
    return out.detach().numpy(), {k: (gr.numpy().T if k in TRANSPOSED else gr.numpy())
                                  for k, gr in zip(NAMES, grads)}


# ------------------------------------------------------------------ K4 layer

@pytest.mark.parametrize("s,causal", [(8, False), (32, False), (8, True), (32, True),
                                      (48, False), (48, True)])
def test_layer_train_matches_pallas(s, causal):
    """Forward and all twelve gradients at dropout 0, with key padding, one
    fully masked sequence (zero attention output, zero attention gradients)
    and seq_bias; S=48 is a length of the long form (the plain version the
    card holds its kernels against), causal too."""
    rng = np.random.default_rng(s + causal)
    b = 4
    vals, mask, g = _layer_inputs(rng, b, s)

    def run(*args):
        return jax_layer_vjp.fused_layer_train(
            *args, jnp.asarray(mask), jnp.zeros((1,), jnp.int32), H, pick_tile_b(b, s),
            causal, 0.0, None, False, True)

    args = [jnp.asarray(vals[k]) for k in NAMES]
    ref, vjp = jax.vjp(run, *args)
    ref_grads = dict(zip(NAMES, vjp(jnp.asarray(g))))
    out, grads = _port_layer_grads(vals, mask, g, causal)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)
    for k in NAMES:
        scale = max(1.0, float(np.abs(ref_grads[k]).max()))
        np.testing.assert_allclose(grads[k], np.asarray(ref_grads[k]).reshape(grads[k].shape),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_layer_train_matches_xla_layer_at_s31():
    """The flax decoder layer on its XLA path (``mha_reference``), S=31: the
    port does not pad the sequence to a multiple of 8."""
    rng = np.random.default_rng(31)
    b, s, dz = 3, 31, 16
    vals, mask, g = _layer_inputs(rng, b, s, masked_seq=False)
    z = rng.normal(size=(b, dz)).astype(np.float32)
    wg = (rng.normal(size=(dz, D)) * dz ** -0.5).astype(np.float32)
    bg = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    layer = JaxDecoderLayer(D, H, FF, 0.0, dim_z=dz)
    params = {"norm1": vals["ln1"], "wqkv": vals["wqkv"], "bqkv": vals["bqkv"],
              "wo": vals["wo"], "bo": vals["bo"], "norm2": vals["ln2"],
              "ff1_kernel": vals["w1"], "ff1_bias": vals["b1"], "ff2_kernel": vals["w2"],
              "ff2_bias": vals["b2"], "glob_kernel": wg, "glob_bias": bg}

    def run(params, x):
        return layer.apply({"params": params}, x, jnp.asarray(z), key_pad=jnp.asarray(mask),
                           deterministic=False)

    ref, vjp = jax.vjp(jax.jit(run), jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(vals["x"]))
    ref_p, ref_x = vjp(jnp.asarray(g))
    vals = dict(vals, seq_bias=z @ wg + bg)
    out, grads = _port_layer_grads(vals, mask, g, False)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grads["x"], np.asarray(ref_x), rtol=1e-4, atol=1e-4)
    # dseq_bias is the gradient of the injection; summed over the batch it is glob_bias's
    np.testing.assert_allclose(grads["seq_bias"].sum(0), np.asarray(ref_p["glob_bias"]),
                               rtol=1e-4, atol=1e-4)
    for ours, theirs in (("ln1", "norm1"), ("wqkv", "wqkv"), ("bqkv", "bqkv"), ("wo", "wo"),
                         ("bo", "bo"), ("ln2", "norm2"), ("w1", "ff1_kernel"),
                         ("b1", "ff1_bias"), ("w2", "ff2_kernel"), ("b2", "ff2_bias")):
        np.testing.assert_allclose(grads[ours], np.asarray(ref_p[theirs]), rtol=1e-4,
                                   atol=1e-4, err_msg=ours)


def _explicit_mask_layer(ts, mask, factors, causal):
    """The layer written again with library calls, the four dropout factors
    given as tensors."""
    x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2 = ts
    b, s, d = x.shape
    xn = F.layer_norm(x, (d,), ln1[0], ln1[1], 1e-5)
    q, k, v = (t.reshape(b, s, H, d // H).transpose(1, 2)
               for t in F.linear(xn, wqkv, bqkv).chunk(3, dim=-1))
    scores = q @ k.transpose(-1, -2) * (d // H) ** -0.5 + mask[:, None, None, :]
    if causal:
        scores = scores + torch.full((s, s), float("-inf")).triu(1)
    p = torch.nan_to_num(torch.softmax(scores, dim=-1)) * factors[0]
    ctx = (p @ v).transpose(1, 2).reshape(b, s, d)
    x = x + F.linear(ctx, wo, bo) * factors[1] + seq_bias[:, None]
    h = torch.relu(F.linear(F.layer_norm(x, (d,), ln2[0], ln2[1], 1e-5), w1, b1)) * factors[2]
    return x + F.linear(h, w2, b2) * factors[3]


@pytest.mark.parametrize("causal", [False, True])
def test_layer_train_dropout_mask_is_the_same_forward_and_backward(causal):
    """With dropout 0.1: output and gradients equal those of the layer written
    with the hash masks made explicit, so the backward drops what the forward
    dropped; and the keep rate of each site is within 3 sigma of 0.9."""
    rng = np.random.default_rng(7)
    b, s, rate, seed = 5, 8, 0.1, 4321
    vals, mask, g = _layer_inputs(rng, b, s, masked_seq=False)
    out, grads = _port_layer_grads(vals, mask, g, causal, rate, seed)
    rows = torch.arange(b * s).reshape(b, s, 1)
    prob_rows = torch.arange(b * H * s).reshape(b, H, s, 1)
    factors = [port_dropout.dropout_factor(seed, port_dropout.SITE_ATTN_PROB, prob_rows,
                                           torch.arange(s), rate)]
    factors += [port_dropout.dropout_factor(seed, site, rows, torch.arange(n), rate)
                for site, n in ((port_dropout.SITE_ATTN_OUT, D),
                                (port_dropout.SITE_FF_HIDDEN, FF),
                                (port_dropout.SITE_FF_OUT, D))]
    for f in factors:
        n = f.numel()
        assert abs(float((f > 0).float().mean()) - 0.9) <= 3 * np.sqrt(0.09 / n)
        assert set(np.unique(f.numpy())) <= {0.0, np.float32(1 / 0.9)}
    ts = [_t(vals[k].T if k in TRANSPOSED else vals[k], grad=True) for k in NAMES]
    ref = _explicit_mask_layer(ts, _t(mask), factors, causal)
    ref_grads = torch.autograd.grad(ref, ts, _t(g))
    np.testing.assert_allclose(out, ref.detach().numpy(), rtol=1e-4, atol=1e-5)
    for k, rg in zip(NAMES, ref_grads):
        rg = rg.numpy().T if k in TRANSPOSED else rg.numpy()
        np.testing.assert_allclose(grads[k], rg, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layer_train_plain_version_takes_a_relu_gate(monkeypatch, rate):
    """``relu_gate`` replaces the plain version's own choice of the FF units
    that pass: its own gate changes nothing, forward or backward; a unit
    closed everywhere gets no gradient in its row of ``w1``."""
    rng = np.random.default_rng(5)
    vals, mask, g = _layer_inputs(rng, 3, 8)
    ts = [_t(vals[k].T if k in TRANSPOSED else vals[k], grad=True) for k in NAMES]
    gates = []
    relu = torch.relu
    monkeypatch.setattr(torch, "relu", lambda t: (gates.append(t > 0), relu(t))[1])
    out = port_layer_vjp.plain_layer_train(*ts, _t(mask), 7, H, False, rate)
    monkeypatch.undo()
    own, = gates
    assert own.shape == (3, 8, FF) and 0.2 < own.float().mean() < 0.8
    grads = torch.autograd.grad(out, ts, _t(g))
    same = port_layer_vjp.plain_layer_train(*ts, _t(mask), 7, H, False, rate, relu_gate=own)
    torch.testing.assert_close(same, out, rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(same, ts, _t(g)), grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    unit = 5
    closed = own.clone()
    closed[..., unit] = False
    other = port_layer_vjp.plain_layer_train(*ts, _t(mask), 7, H, False, rate, relu_gate=closed)
    dw1 = torch.autograd.grad(other, ts[NAMES.index("w1")], _t(g))[0]
    assert not dw1[unit].any() and grads[NAMES.index("w1")][unit].any()


def test_dropout_mask_does_not_depend_on_chunking_or_the_call():
    """A mask element is a function of (seed, site, row, column) alone."""
    rows, cols = torch.arange(4096).reshape(-1, 1), torch.arange(96)
    full = port_dropout.keep_mask(11, 2, rows, cols, 0.1)
    for lo, hi in ((0, 100), (100, 1500), (4000, 4096)):
        assert torch.equal(port_dropout.keep_mask(11, 2, rows[lo:hi], cols, 0.1), full[lo:hi])
    assert torch.equal(port_dropout.keep_mask(11, 2, rows, cols[5:9], 0.1), full[:, 5:9])
    assert not torch.equal(port_dropout.keep_mask(12, 2, rows, cols, 0.1), full)
    assert not torch.equal(port_dropout.keep_mask(11, 3, rows, cols, 0.1), full)

    def fmix(x):                                        # the hash in Python integers
        x ^= x >> 16
        x = x * 0x7FEB352D & 0xFFFFFFFF
        x ^= x >> 15
        x = x * 0x846CA68B & 0xFFFFFFFF
        return x ^ x >> 16

    key = fmix(11 ^ (3 * 0x9E3779B9 & 0xFFFFFFFF))
    for r, c in ((0, 0), (17, 95), (4095, 3)):
        keep = (fmix(fmix(r ^ key) + c & 0xFFFFFFFF) >> 8) >= int(0.1 * 2 ** 24)
        assert bool(full[r, c]) == keep


# ------------------------------------------------------------ K5 argument CE

def _ce_inputs(rng, r, d, n_args=11, vocab=257):
    y = rng.normal(size=(r, d)).astype(np.float32)
    wa = (rng.normal(size=(d, n_args * vocab)) * d ** -0.5).astype(np.float32)
    ba = (0.1 * rng.normal(size=(n_args * vocab,))).astype(np.float32)
    tgt = rng.integers(0, vocab, (r, n_args)).astype(np.int32)
    g = (rng.random((r, n_args)) / r).astype(np.float32)
    return y, wa, ba, tgt, g


@pytest.mark.parametrize("vocab", [257, 512])
@pytest.mark.parametrize("r", [40, 300])                 # the JAX wrapper pads its last tile
def test_args_ce_matches_pallas(r, vocab):
    """The plain version against JAX's ``args_ce`` (Pallas, interpret mode),
    forward and the three gradients, at the flagship's 257 classes a slot and
    Sketchformer's 512: the contract the card kernels are held to."""
    rng = np.random.default_rng(3 + r + vocab)
    y, wa, ba, tgt, g = _ce_inputs(rng, r, D, vocab=vocab)
    run = lambda y, wa, ba: jax_ce.args_ce(y, wa, ba, jnp.asarray(tgt), tile_rows=16)  # noqa: E731
    ref, vjp = jax.vjp(run, jnp.asarray(y), jnp.asarray(wa), jnp.asarray(ba))
    ref_grads = vjp(jnp.asarray(g))
    ts = [_t(y, True), _t(wa.T, True), _t(ba, True)]
    ce = port_ce.args_ce(*ts, _t(tgt))
    grads = torch.autograd.grad(ce, ts, _t(g))
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dy", "dWa", "dba"), (grads[0], grads[1].T, grads[2]), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_args_ce_bfloat16_rounds_the_logit_gradient_as_pallas_does():
    """In bfloat16 the Pallas backward rounds dlg to bfloat16 before the dy and
    dW products. The plain version does the same: its dW is then much closer
    to the Pallas result than the same gradient without that rounding."""
    rng = np.random.default_rng(4)
    y, wa, ba, tgt, g = _ce_inputs(rng, 32, D)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    run = lambda y, wa, ba: jax_ce.args_ce(y, wa, ba, jnp.asarray(tgt), tile_rows=16)  # noqa: E731
    _, vjp = jax.vjp(run, bf(y), bf(wa), bf(ba))
    ref_dw = np.asarray(vjp(jnp.asarray(g))[1].astype(jnp.float32))
    ts = [_t(y).bfloat16().requires_grad_(), _t(wa.T).bfloat16().float().requires_grad_(),
          _t(ba).bfloat16().float().requires_grad_()]
    dw = torch.autograd.grad(port_ce.args_ce(*ts, _t(tgt), torch.bfloat16), ts, _t(g))[1]
    logits = (ts[0].float() @ ts[1].t() + ts[2]).reshape(32, 11, 257)
    unrounded = torch.autograd.grad(
        F.cross_entropy(logits.reshape(-1, 257), _t(tgt).long().reshape(-1),
                        reduction="none").reshape(32, 11), ts, _t(g))[1]
    err = np.abs(dw.numpy().T - ref_dw).max()
    err_unrounded = np.abs(unrounded.numpy().T - ref_dw).max()
    scale = np.abs(ref_dw).max()
    # JAX rounds dW itself to bfloat16 on return (2^-9 relative); what is left
    # of the port's error is summation order
    assert err <= 2.0 ** -8 * scale, (err, scale)
    assert err_unrounded > err, (err_unrounded, err)


@pytest.mark.parametrize("vocab", [257, 512])
def test_args_ce_target_outside_the_vocabulary_matches_no_class(vocab):
    rng = np.random.default_rng(5)
    y, wa, ba, tgt, _ = _ce_inputs(rng, 4, D, vocab=vocab)
    tgt[1, 2], tgt[2, 0] = vocab, -1
    ce = port_ce.args_ce(_t(y), _t(wa.T), _t(ba), _t(tgt)).numpy()
    lse = torch.logsumexp((_t(y) @ _t(wa) + _t(ba)).reshape(4, 11, vocab), -1).numpy()
    np.testing.assert_allclose(ce[1, 2], lse[1, 2], rtol=1e-6)
    np.testing.assert_allclose(ce[2, 0], lse[2, 0], rtol=1e-6)


# -------------------------------------------------------- K6 embedding tables

@pytest.mark.parametrize("use_group", [False, True])
def test_embedding_table_gradients_match_pallas(use_group):
    """Mostly-PAD arguments and out-of-range ids (which add nothing)."""
    rng = np.random.default_rng(6)
    b, s, d, n_args, vocab, n_cmd, n_group = 4, 8, 32, 11, 257, 7, 10
    commands = rng.integers(0, n_cmd, (b, s)).astype(np.int32)
    args = rng.integers(-1, vocab - 1, (b, s, n_args)).astype(np.float32)
    args[rng.random(args.shape) < 0.8] = -1.0
    groups = rng.integers(0, n_group, (b, s)).astype(np.int32)
    commands[1, 2], args[1, 3, 4], args[2, 1, 0], groups[3, 5] = n_cmd + 2, vocab + 5, -3.0, n_group
    tables = [rng.normal(size=(n, d)).astype(np.float32)
              for n in (n_cmd, n_args * vocab, n_group, s)]
    dy = rng.normal(size=(b, s, d)).astype(np.float32)

    def run(cmd_t, arg_t, grp_t, pos_t):
        return jax_embedding.fused_embedding_train(
            jnp.asarray(commands), jnp.asarray(args), jnp.asarray(groups), cmd_t, arg_t,
            grp_t, pos_t, 2, use_group, jnp.float32, True)

    ref, vjp = jax.vjp(run, *map(jnp.asarray, tables))
    ref_grads = vjp(jnp.asarray(dy))
    ts = [_t(t, True) for t in tables]
    out = port_embedding.fused_embedding_train(_t(commands), _t(args), _t(groups), ts[0],
                                               ts[1], ts[2], ts[3], use_group)
    grads = torch.autograd.grad(out, ts, _t(dy), allow_unused=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dcmd", "darg", "dgroup", "dpos"), grads, ref_grads):
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=name)


# ------------------------------------------------------------------------ loss

WEIGHTS = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_visibility_weight=1.0,
               loss_cmd_weight=1.0, loss_args_weight=2.0)


@pytest.mark.parametrize("fused", [False, True])
def test_svg_loss_matches_jax(fused):
    """One output dict with random logits; sample 1 has no visible group."""
    rng = np.random.default_rng(8)
    n = 3
    batch = generate_batch(np.random.default_rng(1), n)
    commands, args = batch["commands"].copy(), batch["args"].copy()
    commands[1, :, 1:], args[1] = 4, -1                                   # EOS everywhere
    g, s = commands.shape[1], commands.shape[2] - 1
    out = {"tgt_commands": commands, "tgt_args": args,
           "command_logits": rng.normal(size=(n, g, s, 7)).astype(np.float32),
           "visibility_logits": rng.normal(size=(n, g, 2)).astype(np.float32)}
    if fused:
        out["args_ce"] = rng.random((n, g, s, 11)).astype(np.float32) * 5
    else:
        out["args_logits"] = rng.normal(size=(n, g, s, 11, 257)).astype(np.float32)
    cfg = JaxModelConfig(encode_stages=2, decode_stages=2, use_vae=False)
    ref = jax.jit(lambda o: jax_svg_loss(o, WEIGHTS, cfg))(
        {k: jnp.asarray(v) for k, v in out.items()})
    res = svg_loss({k: _t(v) for k, v in out.items()}, WEIGHTS, hierarchical_ordered())
    assert set(res) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(res[k]), float(ref[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_svg_loss_refuses_the_vae_term():
    """A VAE model's loss needs the forward's mu and logsigma: without them
    the KL term is refused rather than left out."""
    import dataclasses
    cfg = dataclasses.replace(hierarchical_ordered(), use_vae=True)
    with pytest.raises(ValueError, match="mu and logsigma"):
        svg_loss({}, WEIGHTS, cfg)


# ------------------------------------------------------ schedules and optimizer

@pytest.mark.parametrize("name,args", [
    ("warmup_step_decay", (1e-3, 4, 3, 0.9)), ("constant", (2e-3,)),
    ("linear_ramp", (2, 7, 0.0, 1.0))])
def test_schedules_match_jax(name, args):
    ref, ours = getattr(jax_schedulers, name)(*args), getattr(port_schedulers, name)(*args)
    for step in range(10):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("start_step", [0, 2])
def test_optimizer_matches_optax(start_step):
    """Clip, AdamW and the start gate over 5 steps on random leaves; the
    gradients are large enough that the clip acts."""
    rng = np.random.default_rng(9)
    shapes = [(7, 5), (5,), (2, 3, 4), (1,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(3 * rng.normal(size=s) * (0.05 if step == 3 else 1)).astype(np.float32)
              for s in shapes] for step in range(5)]
    schedule = (1e-2, 2, 2, 0.5)
    ref_opt = jax_trainer.make_optimizer(jax_schedulers.warmup_step_decay(*schedule),
                                         start_step=start_step)
    ref_p = [jnp.asarray(p) for p in params]
    ref_state = ref_opt.init(ref_p)
    opt = port_trainer.make_optimizer(port_schedulers.warmup_step_decay(*schedule))
    if start_step:
        opt = port_trainer.delayed_start(opt, start_step)
    ours = [_t(p.copy()) for p in params]
    state = opt.init(ours)
    for step in range(5):
        updates, ref_state = ref_opt.update([jnp.asarray(g) for g in grads[step]], ref_state, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
        norm = opt.update(ours, [_t(g) for g in grads[step]], state)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads[step])), rtol=1e-6)
        for a, b in zip(ours, ref_p):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert state["count"] == 5 - start_step


def test_make_optimizers_matches_optax_multi_transform():
    """Two labelled members with their own schedule, clip and start step, over
    5 steps on random leaves, against the JAX package's ``make_optimizers``."""
    rng = np.random.default_rng(10)
    shapes = {"a/w": (6, 4), "a/b": (4,), "b/w": (3, 5), "b/b": (5,)}
    names = list(shapes)
    params = [rng.normal(size=shapes[n]).astype(np.float32) for n in names]
    grads = [[(2 * rng.normal(size=shapes[n])).astype(np.float32) for n in names]
             for _ in range(5)]
    labels = {n: n.split("/")[0] for n in names}
    specs = lambda mod: {  # noqa: E731
        "a": dict(lr_schedule=mod.constant(1e-2), grad_clip=1.0),
        "b": dict(lr_schedule=mod.warmup_step_decay(5e-3, 2, 2, 0.5), grad_clip=0.5,
                  weight_decay=0.1, start_step=2)}
    ref_opt = jax_trainer.make_optimizers(specs(jax_schedulers), dict(zip(names, labels.values())))
    ref_p = {n: jnp.asarray(p) for n, p in zip(names, params)}
    ref_state = ref_opt.init(ref_p)
    opt = port_trainer.make_optimizers(specs(port_schedulers), labels)
    opt.bind(names)
    ours = [_t(p.copy()) for p in params]
    state = opt.init(ours)
    for step in range(5):
        g = {n: jnp.asarray(v) for n, v in zip(names, grads[step])}
        updates, ref_state = ref_opt.update(g, ref_state, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
        norm = opt.update(ours, [_t(v) for v in grads[step]], state)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for n, a in zip(names, ours):
            np.testing.assert_allclose(a.numpy(), np.asarray(ref_p[n]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{n} after step {step + 1}")
    assert state["a"]["count"] == 5 and state["b"]["count"] == 3


def test_create_train_state_initialises_as_flax_does():
    """A fresh state at a small size against the JAX package's: the leaves flax
    fills with a constant (biases, LayerNorm scales) are equal, the random ones
    have flax's standard deviation (within 15%, leaves of 2,000 entries or
    more); moments zero, step 0, and the same seed gives the same parameters."""
    import dataclasses

    from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
    from deepsvg_tpu_torch.models import SVGTransformer, to_flax_params
    small = dict(d_model=64, n_heads=2, dim_feedforward=128, n_layers=2, n_layers_decode=2,
                 dim_z=32, dropout=0.0)
    batch = generate_batch(np.random.default_rng(2), 2)
    data = {"commands": jnp.asarray(batch["commands"]), "args": jnp.asarray(batch["args"])}
    ref_model = JaxSVGTransformer(JaxModelConfig(encode_stages=2, decode_stages=2,
                                                 use_vae=False, **small))
    ref = jax.jit(lambda: jax_trainer.create_train_state(
        ref_model, jax_trainer.make_optimizer(jax_schedulers.constant(1e-3)), data,
        ["commands", "args", "commands", "args"]))()
    cfg = dataclasses.replace(hierarchical_ordered(), **small)
    opt = port_trainer.make_optimizer(port_schedulers.constant(1e-3))
    state = port_trainer.create_train_state(SVGTransformer(cfg), opt, seed=42)
    again = port_trainer.create_train_state(SVGTransformer(cfg), opt, seed=42)
    assert state.step == 0 and state.opt_state["count"] == 0
    assert all(not m.any() for m in state.opt_state["mu"] + state.opt_state["nu"])
    assert all(torch.equal(p, q) for p, q in zip(state.parameters(), again.parameters()))
    ours = {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_leaves_with_path(to_flax_params(state.model))}
    theirs = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
              jax.tree_util.tree_leaves_with_path(ref.params)}
    assert set(ours) == set(theirs)
    compared = 0
    for k, want in theirs.items():
        got = ours[k]
        assert got.shape == want.shape and got.dtype == np.float32, k
        rows = want.reshape(-1, want.shape[-1])
        if (rows == rows[:, :1]).all():                 # constant rows: zeros, or norm1/norm2
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif want.size >= 2000:
            assert abs(got.std() / want.std() - 1) <= 0.15 and abs(got.mean()) <= 0.1 * got.std(), k
            compared += 1
    assert compared >= 30
