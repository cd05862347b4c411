"""The one-stage one-shot model and the label-conditioned models against the
JAX package, on the CPU.

Small models (d_model 64, 2 heads of 32, FF 128, dim_z 48, two layers per
stack, 2 paths x 16 commands, 10 labels of 64 dims, the width of the JAX
layers' ``glob2``) with the JAX package's own initialisation from a seed, a
batch of N=8 synthetic icons with labels from a numpy seed. E1 (S=18) and D1
(S=17) are longer than the stack gate's 16 rows, so their layers run one at a
time (K4), E2 and D2 (S=2) as one stack (K7). The variants:

- ``one_stage``: ``one_stage_one_shot()`` (one-stage encoder with the group
  embedding at S=34, ResNet + VAE, one decoder over the 33 constant queries
  of ``max_total_len + 1``, no visibility head: the long forms' lengths);
- ``label`` and ``label_vae``: the two-stage model with label conditioning,
  without and with the VAE (the fonts config's);
- ``one_stage_label``: the one-stage one-shot model with labels.

The port's kernels run as their plain versions (CPU tensors); the JAX
package's Pallas kernels in interpret mode. Held:

- the encoder's latent (the VAE's mean) and the logits decoded from it
  against JAX's XLA path (float32, 1e-4, as the flagship's forward), and
  against JAX's Pallas path: the logits within 1e-4, the argmax ids equal
  wherever JAX's two best logits differ by at least 1e-4;
- one training step at dropout 0 against JAX's ``train_step`` on its XLA
  path: each loss term (the one-stage loss has no visibility term), every
  leaf's gradient within 1e-3 of its largest entry, the global norm, the
  parameters after the step; the label-conditioned steps go through the
  stack gate (K7's plain version at E2 and D2), as the JAX package's
  Pallas step does;
- with dropout on, the latent's and the label's injections draw masks of
  their own, and the backward sees the forward's masks, in the layer and
  on the stack path;
- the weight bridge both ways for the one-stage and the label trees;
- a label-conditioned Sketchformer: the teacher-forced logits, the KV-cached
  decode (module path) and the decode through K9's plain version with the
  label's term in its ``seq_bias``, against JAX's cached scan and JAX's
  ``autoregressive_sample_fused`` (its Pallas decode kernel in interpret
  mode);
- the port's configs, and the training CLI on both, cut to this size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models import sample as jax_sample
from deepsvg_tpu.training import schedulers as jax_schedulers
from deepsvg_tpu.training import trainer as jax_trainer
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    DropoutRng, ModelConfig, SVGTransformer, autoregressive_sample_cached,
    autoregressive_sample_fused, load_flax_params, to_flax_params)
from deepsvg_tpu_torch.models import layers as port_layers
from deepsvg_tpu_torch.ops import stack_vjp
from deepsvg_tpu_torch.training import constant, create_train_state, make_optimizer, train_step

N, G, S, N_LABELS = 8, 2, 16, 10
BASE = dict(d_model=64, n_heads=2, dim_feedforward=128, dim_z=48, n_layers=2,
            n_layers_decode=2, dropout=0.0, max_num_groups=G, max_seq_len=S,
            n_labels=N_LABELS, dim_label=64)
VARIANTS = {
    "one_stage": dict(encode_stages=1, decode_stages=1, use_vae=True),
    "label": dict(encode_stages=2, decode_stages=2, use_vae=False, label_condition=True),
    "label_vae": dict(encode_stages=2, decode_stages=2, use_vae=True, label_condition=True),
    "one_stage_label": dict(encode_stages=1, decode_stages=1, use_vae=False,
                            label_condition=True),
}
LOGIT_TOL = 1e-4
MARGIN = 1e-4
LR = 1e-3
WEIGHTS = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_visibility_weight=1.0,
               loss_cmd_weight=1.0, loss_args_weight=2.0)
LOSS_TOL = 1e-5          # each loss term, absolute and relative
GRAD_TOL = 1e-3          # each leaf's gradient, of the leaf's largest entry
PARAM_TOL = 2e-5         # parameters after the step, where the gradient is signal
NOISE = 1e-3             # below this share of its leaf's largest entry a gradient
                         # entry is rounding noise, which Adam turns into a step of lr
VAE_SCALE = 100.0        # the VAE's kernels, times this: the KL term above its tolerance


def _kw(variant, dtype="float32", **extra):
    return {**BASE, **VARIANTS[variant], "compute_dtype": dtype, **extra}


def _model_args(variant):
    return ModelConfig(**_kw(variant)).get_model_args()


def _batch(variant):
    b = generate_batch(np.random.default_rng(1), N, G, S, label_range=N_LABELS)
    return {k: b[k] for k in set(_model_args(variant))}


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_model(variant, impl="xla", **extra):
    return JaxSVGTransformer(JaxModelConfig(**_kw(variant, **extra), attention_impl=impl))


def _inputs(variant, batch, lib=jnp):
    """(commands, args, label) of the encoder, as ``lib`` arrays."""
    c, a = (batch[k] for k in _model_args(variant)[:2])
    label = batch.get("label")
    conv = jnp.asarray if lib is jnp else torch.from_numpy
    return conv(c), conv(a), None if label is None else conv(label)


_TREES = {}


def _tree(variant):
    """JAX's initialisation of the variant (cached), the VAE's kernels times
    VAE_SCALE."""
    if variant not in _TREES:
        batch = _batch(variant)
        data = [jnp.asarray(batch[k]) for k in _model_args(variant)]
        tree = jax.jit(_jax_model(variant).init)(
            {"params": jax.random.key(0), "vae": jax.random.key(1)}, *data)["params"]
        tree = jax.tree_util.tree_map(np.asarray, tree)
        if "vae" in tree:
            tree = dict(tree, vae={k: dict(v, kernel=v["kernel"] * VAE_SCALE)
                                   for k, v in tree["vae"].items()})
        _TREES[variant] = tree
    return _TREES[variant]


def _port_model(variant, dtype="float32", **extra):
    model = SVGTransformer(ModelConfig(**_kw(variant, dtype, **extra)))
    load_flax_params(model, _tree(variant))
    return model


def _top2_margin(logits):
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# ------------------------------------------------------------------- forwards

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax_xla(variant):
    """The latent (the VAE's mean) and the logits decoded from it; the
    one-stage decoder gives ``[N, 1, max_total_len + 1, ...]`` and no
    visibility logits."""
    batch = _batch(variant)
    jm, tree = _jax_model(variant), _tree(variant)
    c, a, label = _inputs(variant, batch)
    z_ref = jm.apply({"params": tree}, c, a, label, method=JaxSVGTransformer.encode,
                     sample_vae=False)[0]
    ref = jm.apply({"params": tree}, None, None, None, None, label=label, z=z_ref,
                   return_tgt=False)
    model = _port_model(variant).eval()
    with torch.no_grad():
        z, _, _ = model.encode(*_inputs(variant, batch, torch), sample_vae=False)
        res = model(label=_inputs(variant, batch, torch)[2], z=torch.from_numpy(np.asarray(z_ref)))
    err = np.abs(z.numpy() - np.asarray(z_ref)).max()
    print(f"{variant}: latent max abs err {err:.3g}")
    assert err <= LOGIT_TOL
    assert set(res) == set(ref)
    one_stage = VARIANTS[variant]["decode_stages"] == 1
    assert ("visibility_logits" in res) != one_stage
    if one_stage:
        assert res["command_logits"].shape == (N, 1, G * S + 1, 7)
    for key in ref:
        assert res[key].shape == ref[key].shape, key
        err = np.abs(res[key].numpy() - np.asarray(ref[key])).max()
        print(f"  {key}: max abs err {err:.3g}")
        assert err <= LOGIT_TOL, key


@pytest.mark.parametrize("variant", ["one_stage_label", "label"])
def test_forward_matches_jax_pallas(variant):
    """Against JAX's Pallas path (its inference kernels in interpret mode;
    the label's injection folded into each layer's ``seq_bias``): the logits,
    and the argmax ids of the fused head where JAX's margin allows."""
    batch = _batch(variant)
    jm, tree = _jax_model(variant, "pallas"), _tree(variant)
    c, a, label = _inputs(variant, batch)
    ref = jm.apply({"params": tree}, c, a, None, None, label=label, return_tgt=False)
    ids_ref = jm.apply({"params": tree}, c, a, None, None, label=label, return_tgt=False,
                       argmax_head=True)
    model = _port_model(variant).eval()
    with torch.no_grad():
        res = model(*_inputs(variant, batch, torch)[:2], label=_inputs(variant, batch, torch)[2])
        ids = model(*_inputs(variant, batch, torch)[:2], label=_inputs(variant, batch, torch)[2],
                    argmax_head=True)
    for key in ref:
        err = np.abs(res[key].numpy() - np.asarray(ref[key])).max()
        print(f"{variant} {key}: max abs err {err:.3g} against JAX's Pallas path")
        assert err <= LOGIT_TOL, key
    for key, lkey in (("command_ids", "command_logits"), ("args_ids", "args_logits")):
        differ = ids[key].numpy() != np.asarray(ids_ref[key])
        assert (_top2_margin(ref[lkey])[differ] < MARGIN).all(), key


# ---------------------------------------------------------------------- steps

def _remember_gradients():
    """An optax transformation that changes nothing and keeps the gradients
    it was given as its state (chained before the optimizer)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


def _jax_step(variant, batch):
    """One of JAX's own train_steps from PRNGKey(0): the loss terms, the
    gradients, the parameters after it and the VAE noise it drew (None
    without the VAE)."""
    model = _jax_model(variant)
    tree = _tree(variant)
    optimizer = optax.chain(_remember_gradients(),
                            jax_trainer.make_optimizer(jax_schedulers.constant(LR)))
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                                   opt_state=optimizer.init(tree), rng=jax.random.PRNGKey(0))
    data = {k: jnp.asarray(v) for k, v in batch.items()}
    model_args = _model_args(variant)
    eps = None
    if model.cfg.use_vae:
        _, _, vae_rng = jax.random.split(state.rng, 3)
        _, inter = model.apply({"params": tree}, *[data[k] for k in model_args],
                               deterministic=False, rngs={"vae": vae_rng, "dropout": vae_rng},
                               capture_intermediates=lambda mdl, _: mdl.name == "vae",
                               mutable=["intermediates"])
        z, mu, logsigma = (np.asarray(x, np.float32)
                           for x in inter["intermediates"]["vae"]["__call__"][0])
        eps = (z - mu) / np.exp(logsigma / 2.0)
    step = jax_trainer.jit_train_step(model, optimizer, model_args, donate=False)
    state, res = step(state, data, WEIGHTS)
    to_np = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    return to_np(res), to_np(state.opt_state[0]), to_np(state.params), eps


@pytest.mark.parametrize("variant", ["one_stage", "label", "label_vae"])
def test_train_step_matches_jax(monkeypatch, variant):
    batch = _batch(variant)
    ref_res, ref_grads, ref_params, eps = _jax_step(variant, batch)
    if eps is not None:
        # JAX's VAE noise is read from its step and handed to the port's VAE
        def normal(self, shape, dtype, device):
            assert tuple(shape) == eps.shape
            return torch.from_numpy(eps).to(device=device, dtype=dtype)
        monkeypatch.setattr(DropoutRng, "normal", normal)
    stacks = []
    kernel_stack = stack_vjp.fused_stack_train

    def spy(*args, **kw):
        stacks.append(args[0].shape)
        return kernel_stack(*args, **kw)
    monkeypatch.setattr(stack_vjp, "fused_stack_train", spy)
    model = _port_model(variant)
    optimizer = make_optimizer(constant(LR))
    state = create_train_state(model, optimizer, init=False)
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, res = train_step(state, data, WEIGHTS, optimizer, _model_args(variant))
    assert set(res) == set(ref_res)
    two_stage = VARIANTS[variant]["decode_stages"] == 2
    assert ("loss_visibility" in res) == two_stage
    # the two-stage stacks E2 and D2 (N x G rows) take the stack gate: K7's plain version
    assert stacks == ([(N, G, 64)] * 2 if two_stage else [])
    if eps is not None:
        assert float(res["loss_kl"]) > WEIGHTS["kl_tolerance"]
    for k in ref_res:
        if k != "grad_norm":
            np.testing.assert_allclose(float(res[k]), float(ref_res[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(float(res["grad_norm"]), float(ref_res["grad_norm"]), rtol=1e-4)
    ours, theirs = _leaves(to_flax_params(state.model, grads=True)), _leaves(ref_grads)
    assert set(ours) == set(theirs)
    errs = {k: np.abs(ours[k] - g).max() / max(np.abs(g).max(), 1e-12)
            for k, g in theirs.items()}
    worst = max(errs, key=errs.get)
    signal = {k: np.abs(g) >= NOISE * np.abs(g).max() for k, g in theirs.items()}
    p_ours, p_ref = _leaves(to_flax_params(state.model)), _leaves(ref_params)
    err_signal = max(float(np.abs(p_ours[k] - p_ref[k])[signal[k]].max(initial=0.0))
                     for k in p_ref)
    print(f"{variant}: losses {({k: float(res[k]) for k in ref_res})}; worst gradient leaf "
          f"{worst}: {errs[worst]:.3g} of its largest entry; parameters max abs err "
          f"{err_signal:.3g} where the gradient is signal")
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert any(k.endswith("glob2_kernel") for k in theirs) == ("label" in variant)
    assert err_signal <= PARAM_TOL
    assert max(float(np.abs(p_ours[k] - p_ref[k]).max()) for k in p_ref) <= 1.01 * LR


# -------------------------------------------------------------------- dropout

class _RecordingRng(DropoutRng):
    """A DropoutRng that keeps every mask it draws outside the kernels, with
    the shape it was drawn for."""

    def __init__(self, seed=3):
        super().__init__(torch.Generator().manual_seed(seed))
        self.masks = []

    def dropout(self, x, rate):
        out = super().dropout(x, rate)
        self.masks.append((out != 0).to(x.dtype) / (1.0 - rate))
        return out


def test_decoder_layer_injections_draw_separate_masks():
    """A decoder layer in training (dropout 0.5): the latent's and the
    label's injections each take a mask of their own, and the gradients of
    ``glob`` and ``glob2`` are those masks times the gradient of the
    kernel's ``seq_bias``: the backward sees the forward's masks."""
    torch.manual_seed(0)
    b, s, d = 6, 5, 64
    layer = port_layers.DecoderLayerGlobalImproved(d, 2, 128, 48, 0.5, dim_label=64)
    x, z, le = torch.randn(b, s, d), torch.randn(b, 48), torch.randn(b, 64)
    mask = torch.zeros(b, s)
    seen = {}
    run = layer._run

    def spy(x_, seq_bias, *rest):
        seq_bias.retain_grad()
        seen["seq_bias"] = seq_bias
        return run(x_, seq_bias, *rest)
    layer._run = spy
    rng = _RecordingRng()
    layer(x, z, mask, False, False, rng, le).square().sum().backward()
    injections = [m for m in rng.masks if m.shape == (b, d)]
    assert len(injections) == 2
    keep_z, keep_label = injections
    assert not torch.equal(keep_z, keep_label)
    g = seen["seq_bias"].grad
    torch.testing.assert_close(layer.glob.bias.grad, (keep_z * g).sum(0))
    torch.testing.assert_close(layer.glob2.bias.grad, (keep_label * g).sum(0))
    torch.testing.assert_close(layer.glob2.weight.grad, (keep_label * g).t() @ le)


def test_stack_injections_draw_separate_masks(monkeypatch):
    """The decoder stack on the K7 path (training, short sequences): one draw
    over the latent's ``[L, B, D]`` injections and one over the label's,
    summed into K7's biases; the gradients of each layer's ``glob2`` are
    its slice of the label's mask times K7's ``dseq_bias``. The encoder
    stack passes the label's alone."""
    torch.manual_seed(1)
    n_layers, b, s, d = 2, 5, 8, 64
    stack = port_layers.DecoderStack(n_layers, d, 2, 128, 48, 0.5, dim_label=64)
    x, z, le = torch.randn(b, s, d), torch.randn(b, 48), torch.randn(b, 64)
    seen = []
    kernel_stack = stack_vjp.fused_stack_train

    def spy(x_, seq_bias, *rest):
        seq_bias.retain_grad()
        seen.append(seq_bias)
        return kernel_stack(x_, seq_bias, *rest)
    monkeypatch.setattr(stack_vjp, "fused_stack_train", spy)
    rng = _RecordingRng()
    stack(x, z, False, rng, label_emb=le).square().sum().backward()
    (biases,) = seen
    injections = [m for m in rng.masks if m.shape == (n_layers, b, d)]
    assert len(injections) == 2
    keep_z, keep_label = injections
    assert not torch.equal(keep_z, keep_label)
    for i, layer in enumerate(stack.layers):
        g = biases.grad[i]
        torch.testing.assert_close(layer.glob.bias.grad, (keep_z[i] * g).sum(0))
        torch.testing.assert_close(layer.glob2.bias.grad, (keep_label[i] * g).sum(0))
    enc = port_layers.EncoderStack(n_layers, d, 2, 128, 0.5, dim_label=64)
    seen.clear()
    rng = _RecordingRng()
    enc(x, torch.zeros(b, s), False, rng, le).sum().backward()
    (biases,) = seen
    (keep,) = [m for m in rng.masks if m.shape == (n_layers, b, d)]
    want = torch.stack([keep[i] * enc.layers[i].label_injection(le, False)
                        for i in range(n_layers)])
    torch.testing.assert_close(biases, want)


# --------------------------------------------------------------- weight bridge

@pytest.mark.parametrize("variant", ["one_stage", "label_vae"])
def test_weight_bridge_round_trip(variant):
    """Every leaf of the tree is used once and comes back to the bit: the
    one-stage tree's decoder queries over ``max_total_len + 1`` positions and
    no ``hierarchical_*``; the label tree's two label tables and each
    layer's ``glob2``."""
    tree = _leaves(_tree(variant))
    model = _port_model(variant)
    assert load_flax_params(model, _tree(variant)) == len(tree)
    back = _leaves(to_flax_params(model))
    assert set(back) == set(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if variant == "one_stage":
        assert tree["decoder/embedding/PE/pos_embed"].shape == (G * S + 1, 64)
        assert not any("hierarchical" in k or "label" in k for k in tree)
    else:
        for part in ("encoder", "decoder"):
            assert tree[f"{part}/label_embedding/label_embedding/embedding"].shape == (N_LABELS,
                                                                                      64)
        glob2 = [k for k in tree if k.endswith("glob2_kernel")]
        assert len(glob2) == 8 and all(tree[k].shape == (64, 64) for k in glob2)


def test_weight_bridge_rejects_a_label_tree_that_does_not_fit():
    """A label tree without one layer's ``glob2`` does not load into the
    label model, nor the full tree into the model without labels."""
    tree = jax.tree_util.tree_map(lambda v: v, _tree("label"))
    del tree["decoder"]["decoder"]["layer_1"]["glob2_bias"]
    with pytest.raises(ValueError, match="glob2_bias"):
        load_flax_params(SVGTransformer(ModelConfig(**_kw("label"))), tree)
    with pytest.raises(ValueError, match="label_embedding"):
        load_flax_params(SVGTransformer(ModelConfig(**_kw("label", label_condition=False))),
                         _tree("label"))


# ------------------------------------------------------ autoregressive, labelled

AR = dict(BASE, encode_stages=1, decode_stages=1, pred_mode="autoregressive", rel_targets=True,
          use_vae=True, label_condition=True, max_num_groups=2, max_seq_len=5)


@pytest.fixture(scope="module")
def ar_case():
    """A label-conditioned Sketchformer: JAX's tree, the batch, the latent
    (the VAE's mean) and the labels."""
    b = generate_batch(np.random.default_rng(2), 4, 2, 5, label_range=N_LABELS)
    c, a, a_rel, label = (jnp.asarray(b[k]) for k in
                          ("commands_grouped", "args_grouped", "args_rel_grouped", "label"))
    model = JaxSVGTransformer(JaxModelConfig(**AR))
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        {"params": jax.random.key(0), "vae": jax.random.key(1)}, c, a, c, a_rel,
        label=label)["params"])
    z = model.apply({"params": tree}, c, a, label, method=JaxSVGTransformer.encode,
                    sample_vae=False)[0]
    port = SVGTransformer(ModelConfig(**AR)).eval()
    load_flax_params(port, tree)
    return dict(model=model, tree=tree, batch=b, z=np.asarray(z), label=np.asarray(label),
                port=port)


def test_autoregressive_label_teacher_forced_matches_jax(ar_case):
    b, label = ar_case["batch"], ar_case["label"]
    ref = ar_case["model"].apply(
        {"params": ar_case["tree"]}, None, None, jnp.asarray(b["commands_grouped"]),
        jnp.asarray(b["args_rel_grouped"]), label=jnp.asarray(label),
        z=jnp.asarray(ar_case["z"]), return_tgt=False)
    with torch.no_grad():
        res = ar_case["port"](commands_dec=torch.from_numpy(b["commands_grouped"]),
                              args_dec=torch.from_numpy(b["args_rel_grouped"]),
                              label=torch.from_numpy(label), z=torch.from_numpy(ar_case["z"]))
    for key in ("command_logits", "args_logits"):
        err = np.abs(res[key].numpy() - np.asarray(ref[key])).max()
        print(f"labelled teacher forcing {key}: max abs err {err:.3g}")
        assert err <= LOGIT_TOL, key


@pytest.mark.parametrize("sampler", [autoregressive_sample_cached, autoregressive_sample_fused])
def test_autoregressive_label_decode_matches_jax(ar_case, sampler):
    """The port's cached scan (``decode_step``: the label's injection after
    the latent's in each layer) and its K9 decode (K9's plain version, the
    label's term in each layer's ``seq_bias``) against JAX's cached scan and
    its fused decode (Pallas in interpret mode): ids equal, arguments within
    1e-5; a different label decodes differently."""
    z, label = jnp.asarray(ar_case["z"]), jnp.asarray(ar_case["label"])
    variables = {"params": ar_case["tree"]}
    refs = [jax_sample.autoregressive_sample_cached(ar_case["model"], variables, z, label=label),
            jax_sample.autoregressive_sample_fused(
                JaxSVGTransformer(JaxModelConfig(**AR, attention_impl="pallas")), variables, z,
                label=label)]
    c, a = sampler(ar_case["port"], torch.from_numpy(ar_case["z"]),
                   torch.from_numpy(ar_case["label"]))
    for ref_c, ref_a in refs:
        np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
        np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), atol=1e-5, rtol=0)
    other = sampler(ar_case["port"], torch.from_numpy(ar_case["z"]),
                    torch.from_numpy((ar_case["label"] + 1) % N_LABELS))
    assert not (torch.equal(other[0], c) and torch.equal(other[1], a))


# -------------------------------------------------------------- configs and CLI

def test_configs_build_at_full_width():
    """The port's ``one_stage_one_shot`` and ``hierarchical_ordered_fonts``
    configs: their models build (bfloat16 compute, float32 masters), the
    dataset keys the CLI feeds them, and the one-stage data budget that
    fits its decoder."""
    from deepsvg_tpu_torch.configs import hierarchical_ordered_fonts, one_stage_one_shot
    one, fonts = one_stage_one_shot.Config(1), hierarchical_ordered_fonts.Config(1)
    assert one.model_args == ["commands_grouped", "args_grouped"] * 2
    assert one.max_total_len == one.model_cfg.max_total_len == 240
    assert fonts.model_args == ["commands", "args", "commands", "args", "label"]
    assert (fonts.model_cfg.dim_z, fonts.model_cfg.n_labels, fonts.batch_size,
            fonts.learning_rate, len(fonts.filter_uni)) == (128, 100, 60, 2e-4, 62)
    for cfg in (one, fonts):
        assert cfg.model_cfg.compute_dtype == "bfloat16"
        model = SVGTransformer(cfg.model_cfg)
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.decoder.decoder.layers[0].glob.weight.shape == (256, 128)
    assert model.encoder.label_embedding.embedding.shape == (100, 64)


@pytest.mark.parametrize("config", ["one_stage_one_shot", "hierarchical_ordered_fonts"])
def test_train_cli_runs_the_config(tmp_path, config):
    """``train()`` on each config cut to this size, on the synthetic dataset
    (labels drawn for the label-conditioned model), dropout 0.1: 4 steps, a
    checkpoint, a resume to 6 that equals 6 steps without a stop, to the
    bit; the losses finite."""
    import importlib

    import test_torch_port_runtime as runtime_test

    from deepsvg_tpu_torch.training.train import train
    module = importlib.import_module(f"deepsvg_tpu_torch.configs.{config}")
    variant = "one_stage" if config == "one_stage_one_shot" else "label_vae"

    def cfg():
        c = module.Config(1)
        model_cfg = dataclasses.replace(c.model_cfg, **_kw(variant, dropout=0.1))
        return runtime_test._configure(c, model_cfg, None)
    torch.use_deterministic_algorithms(True)
    try:
        ds = runtime_test._port_dataset(cfg())
        assert ("label" in ds[0]) == (variant == "label_vae")
        train(cfg(), "cli", "split", log_dir=str(tmp_path), dataset=ds, max_steps=4,
              device="cpu")
        resumed, _ = train(cfg(), "cli", "split", log_dir=str(tmp_path), dataset=ds,
                           max_steps=6, resume=True, device="cpu")
        whole, stats = train(cfg(), "cli", "whole", log_dir=str(tmp_path), dataset=ds,
                             max_steps=6, device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    logged = stats.stats["train"]
    assert np.isfinite(list(logged["loss"].deque)).all()
    assert ("loss_visibility" in logged) == (variant == "label_vae")
    assert resumed.step == whole.step == 6
    for x, y in zip(runtime_test._state_tensors(resumed), runtime_test._state_tensors(whole),
                    strict=True):
        assert torch.equal(x, y)
