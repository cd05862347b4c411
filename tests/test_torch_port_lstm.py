"""The LSTM variants (SketchRNN) against the JAX package, on the CPU.

Small models (the widths of ``tests/test_model.py:SMALL``: d_model 32, 4
heads, FF 64, dim_z 16, two layers a stack, 4 paths x 8 commands, so
``max_total_len`` 32) with weights of the JAX model's shapes drawn from a
numpy seed, a batch of N=4 synthetic icons from a numpy seed, float32, JAX's
XLA path, jitted (no Pallas kernel backs the LSTM there). The variants:

- ``sketchrnn``: ``config.sketchrnn()`` (a bidirectional LSTM encoder over
  the whole icon, ResNet + VAE, the autoregressive LSTM decoder with
  relative targets, 512 argument classes);
- ``lstm_one_shot_1`` / ``_2``: the LSTM encoder with a one-shot transformer
  decoder, one and two stages;
- ``lstm_ar_2``: two-stage encoding with the LSTM as E1, and two-stage
  autoregressive decoding with the LSTM as D1.

Held: the latent (the VAE's mean) and the logits decoded from it within
1e-4; one training step at dropout 0 against the gradients of JAX's ``svg_loss``
(each loss term, every leaf's gradient within 1e-3 of its largest entry; the
VAE at its mean in both: ``sample_vae=False`` in JAX, zero noise in the
port's ``train_step``); SketchRNN's
``autoregressive_sample`` ids equal to JAX's; the LSTM encoder on an empty
icon (length 0: JAX's backward direction then runs over the whole reversed
sequence); the weight bridge both ways; what the JAX package cannot do,
refused with an error that says why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models import sample as jax_sample
from deepsvg_tpu.models.config import sketchrnn as jax_sketchrnn
from deepsvg_tpu.models.loss import svg_loss as jax_svg_loss
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    DropoutRng, ModelConfig, SVGTransformer, autoregressive_sample,
    autoregressive_sample_cached, autoregressive_sample_fused, greedy_sample,
    load_flax_params, sketchrnn, to_flax_params)
from deepsvg_tpu_torch.svgtensor import CMD_EOS
from deepsvg_tpu_torch.training import constant, create_train_state, make_optimizer, train_step

N, G, S = 4, 4, 8
SMALL = dict(max_num_groups=G, max_seq_len=S, d_model=32, dim_feedforward=64, dim_z=16,
             n_layers=2, n_layers_decode=2, n_heads=4, dropout=0.0)
VARIANTS = {
    "sketchrnn": dict(model_type="lstm", pred_mode="autoregressive", rel_targets=True),
    "lstm_one_shot_1": dict(model_type="lstm", encode_stages=1, decode_stages=1),
    "lstm_one_shot_2": dict(model_type="lstm", encode_stages=2, decode_stages=2),
    "lstm_ar_2": dict(model_type="lstm", encode_stages=2, decode_stages=2,
                      pred_mode="autoregressive"),
}
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-3          # each leaf's gradient, of the leaf's largest entry
LOSS_TOL = 1e-5
ARGS_TOL = 1e-5
LR = 1e-3
WEIGHTS = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_visibility_weight=1.0,
               loss_cmd_weight=1.0, loss_args_weight=2.0)


def _kw(variant, dtype="float32"):
    return {**SMALL, **VARIANTS[variant], "compute_dtype": dtype}


def _model_args(variant):
    return ModelConfig(**_kw(variant)).get_model_args()


def _batch(variant):
    b = generate_batch(np.random.default_rng(1), N, G, S)
    return {k: b[k] for k in set(_model_args(variant))}


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_model(variant, dtype="float32"):
    return JaxSVGTransformer(JaxModelConfig(**_kw(variant, dtype), attention_impl="xla"))


_TREES = {}


def _random_tree(jax_model, data, seed=0):
    """A parameter tree of the JAX model's shapes (``jax.eval_shape`` of its
    init, nothing compiled) filled from a numpy seed: kernels and tables
    normal over the square root of their first axis, biases 0.1 normal,
    LayerNorm scales 1 + 0.1 normal."""
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.key(0),
                                             "vae": jax.random.key(1)}, *data)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name, n = path[-1].key, rng.standard_normal(shape.shape).astype(np.float32)
        if name in ("norm1", "norm2"):
            return np.stack([1 + 0.1 * n[0], 0.1 * n[1]])
        if name == "scale":
            return 1 + 0.1 * n
        return 0.1 * n if n.ndim == 1 else n / np.float32(np.sqrt(shape.shape[0]))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tree(variant):
    if variant not in _TREES:
        batch = _batch(variant)
        _TREES[variant] = _random_tree(_jax_model(variant),
                                       [jnp.asarray(batch[k]) for k in _model_args(variant)])
    return _TREES[variant]


def _port_model(variant, dtype="float32"):
    model = SVGTransformer(ModelConfig(**_kw(variant, dtype)))
    load_flax_params(model, _tree(variant))
    return model


def _split(variant, data):
    """(encoder inputs, decoder inputs): the targets when autoregressive."""
    ar = VARIANTS[variant].get("pred_mode") == "autoregressive"
    return data[:2], data[2:4] if ar else [None, None]


def _jax_forward(variant, batch, dtype="float32"):
    """JAX's latent (the VAE's mean) and the logits decoded from it
    (teacher-forced on the batch's targets when autoregressive), jitted."""
    jm = _jax_model(variant, dtype)

    @jax.jit
    def run(params, enc, dec):
        z = jm.apply({"params": params}, *enc, method=JaxSVGTransformer.encode,
                     sample_vae=False)[0]
        return z, jm.apply({"params": params}, None, None, *dec, z=z, return_tgt=False)
    z, ref = run(_tree(variant), *_split(variant, [jnp.asarray(batch[k])
                                                    for k in _model_args(variant)]))
    return np.asarray(z), jax.tree_util.tree_map(np.asarray, ref)


def _port_forward(model, variant, batch, z):
    enc, dec = _split(variant, [torch.from_numpy(batch[k]) for k in _model_args(variant)])
    with torch.no_grad():
        z_port = model.encode(*enc, sample_vae=False)[0]
        res = model(None, None, *dec, z=torch.from_numpy(z))
    return z_port, res


# ------------------------------------------------------------------- forwards

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    batch = _batch(variant)
    z_ref, ref = _jax_forward(variant, batch)
    z, res = _port_forward(_port_model(variant).eval(), variant, batch, z_ref)
    assert z.dtype == torch.float32
    err = np.abs(z.numpy() - z_ref).max()
    print(f"{variant}: latent max abs err {err:.3g}")
    assert err <= LOGIT_TOL
    assert set(res) == set(ref)
    for key in ref:
        assert res[key].shape == ref[key].shape, key
        err = np.abs(res[key].float().numpy() - ref[key]).max()
        print(f"  {key}: max abs err {err:.3g}")
        assert err <= LOGIT_TOL, key


def test_encoder_reads_an_empty_icon_as_jax_does():
    """An icon of length 0 (all EOS) and one without EOS (every position
    valid): the LSTM encoder's latent against JAX's."""
    batch = _batch("sketchrnn")
    batch["commands_grouped"] = batch["commands_grouped"].copy()
    batch["commands_grouped"][0] = CMD_EOS
    batch["commands_grouped"][1, :, :] = np.where(
        batch["commands_grouped"][1] == CMD_EOS, 1, batch["commands_grouped"][1])
    z_ref, _ = _jax_forward("sketchrnn", batch)
    z, _ = _port_forward(_port_model("sketchrnn").eval(), "sketchrnn", batch, z_ref)
    np.testing.assert_allclose(z.numpy(), z_ref, atol=LOGIT_TOL, rtol=0)


def test_lstm_encoder_in_bfloat16_computes_in_float32():
    """The LSTM encoder with a one-shot transformer decoder runs in bfloat16
    (the JAX package's does): the cells compute in float32 on the bfloat16
    embedding and return float32, so the latent is JAX's bfloat16 latent up
    to the two frameworks' roundings in the bfloat16 stages after it."""
    variant = "lstm_one_shot_2"
    batch = _batch(variant)
    z_ref, ref = _jax_forward(variant, batch, "bfloat16")
    model = _port_model(variant, "bfloat16").eval()
    seen = []
    model.encoder.encoder.register_forward_hook(lambda m, i, o: seen.append((i[0].dtype,
                                                                              o.dtype)))
    z, res = _port_forward(model, variant, batch, z_ref.astype(np.float32))
    assert seen == [(torch.bfloat16, torch.float32)] and z.dtype == torch.bfloat16
    z_ref = z_ref.astype(np.float32)
    err = np.abs(z.float().numpy() - z_ref).max()
    print(f"bfloat16 latent max abs err {err:.3g} (|z| up to {np.abs(z_ref).max():.3g})")
    assert err <= 2e-2 * max(1.0, float(np.abs(z_ref).max()))
    for key in ref:
        assert res[key].shape == ref[key].shape and bool(torch.isfinite(res[key]).all()), key


# ---------------------------------------------------------------------- steps

def _jax_grads(variant, batch):
    """JAX's loss terms, gradients and global norm at dropout 0, the VAE
    read at its mean (``sample_vae=False``), through ``svg_loss`` as JAX's
    ``train_step`` computes them."""
    jm = _jax_model(variant)
    data = [jnp.asarray(batch[k]) for k in _model_args(variant)]

    @jax.jit
    def grads(params):
        def loss(p):
            out = jm.apply({"params": p}, *data, deterministic=False, sample_vae=False,
                           rngs={"dropout": jax.random.key(0)})
            res = jax_svg_loss(out, WEIGHTS, jm.cfg)
            return res["loss"], res
        (_, res), g = jax.value_and_grad(loss, has_aux=True)(params)
        return res, g, optax.global_norm(g)
    res, g, norm = grads(_tree(variant))
    to_np = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    return to_np(res), to_np(g), float(norm)


@pytest.mark.parametrize("variant", ["sketchrnn", "lstm_ar_2"])
def test_train_step_matches_jax(monkeypatch, variant):
    """One step at dropout 0 with the VAE at its mean (the port's noise set
    to zero): each loss term, the global norm and every leaf's gradient,
    the LSTM cells' included."""
    batch = _batch(variant)
    ref_res, ref_grads, ref_norm = _jax_grads(variant, batch)
    monkeypatch.setattr(DropoutRng, "normal",
                        lambda self, shape, dtype, device: torch.zeros(shape, dtype=dtype,
                                                                       device=device))
    model = _port_model(variant)
    optimizer = make_optimizer(constant(LR))
    state = create_train_state(model, optimizer, init=False)
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, res = train_step(state, data, WEIGHTS, optimizer, _model_args(variant))
    ref_res["grad_norm"] = ref_norm
    assert set(res) == set(ref_res)
    assert float(res["loss_kl"]) > WEIGHTS["kl_tolerance"]
    for k in ref_res:
        if k != "grad_norm":
            np.testing.assert_allclose(float(res[k]), float(ref_res[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(float(res["grad_norm"]), ref_norm, rtol=1e-4)
    ours, theirs = _leaves(to_flax_params(state.model, grads=True)), _leaves(ref_grads)
    assert set(ours) == set(theirs)
    errs = {k: np.abs(ours[k] - g).max() / max(np.abs(g).max(), 1e-12)
            for k, g in theirs.items()}
    worst = max(errs, key=errs.get)
    print(f"{variant}: losses {({k: float(res[k]) for k in ref_res})}; worst gradient leaf "
          f"{worst}: {errs[worst]:.3g} of its largest entry")
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert any("OptimizedLSTMCell" in k and np.abs(g).max() > 0 for k, g in theirs.items())


# ------------------------------------------------------------------- sampling

def test_sketchrnn_autoregressive_sample_matches_jax():
    """SketchRNN's one sampler, the full re-forward at every step: ids equal
    to JAX's ``autoregressive_sample``, the absolute arguments within 1e-5."""
    batch = _batch("sketchrnn")
    z_ref, _ = _jax_forward("sketchrnn", batch)
    jm = _jax_model("sketchrnn")
    ref_c, ref_a = jax.jit(lambda p, z: jax_sample.autoregressive_sample(jm, {"params": p}, z))(
        _tree("sketchrnn"), jnp.asarray(z_ref))
    model = _port_model("sketchrnn").eval()
    c, a = autoregressive_sample(model, torch.from_numpy(z_ref))
    assert c.shape == ref_c.shape == (N, 1, G * S)
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), atol=ARGS_TOL, rtol=0)


def test_sketchrnn_refusals():
    """What the JAX package cannot do with the LSTM, refused: its KV-cached
    decoders (greedy_sample fails there on the transformer stack it builds)
    and the LSTM decoder in bfloat16 (its scan's carry changes type)."""
    model = _port_model("sketchrnn").eval()
    z = torch.zeros(2, SMALL["dim_z"])
    for sampler in (greedy_sample, autoregressive_sample_cached, autoregressive_sample_fused):
        with pytest.raises(ValueError, match="autoregressive_sample"):
            sampler(model, z=z) if sampler is greedy_sample else sampler(model, z)
    with pytest.raises(ValueError, match="autoregressive_sample"):
        model.decode_step(z, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 11),
                          torch.zeros(2, dtype=torch.int32), 0, [], torch.zeros(2, 33))
    with pytest.raises(ValueError, match="float32"):
        SVGTransformer(ModelConfig(**_kw("sketchrnn", "bfloat16")))
    with pytest.raises(ValueError, match="float32"):
        SVGTransformer(ModelConfig(**_kw("lstm_ar_2", "bfloat16")))


def test_config():
    cfg = sketchrnn()
    assert (cfg.model_type, cfg.encode_stages, cfg.decode_stages, cfg.pred_mode,
            cfg.rel_targets, cfg.use_vae, cfg.args_dim_out) == (
        "lstm", 1, 1, "autoregressive", True, True, 512)
    assert cfg == ModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jax_cfg = jax_sketchrnn()
    assert {f: getattr(jax_cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


# --------------------------------------------------------------- weight bridge

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_weight_bridge_round_trip(variant):
    """Every leaf of the tree is used once and comes back to the bit: the
    encoder's two cells (``d_model / 2`` features), the decoder's cell and
    ``fc_hc`` when the LSTM decodes."""
    tree = _leaves(_tree(variant))
    model = SVGTransformer(ModelConfig(**_kw(variant)))
    assert load_flax_params(model, _tree(variant)) == len(tree)
    back = _leaves(to_flax_params(model))
    assert set(back) == set(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    half = SMALL["d_model"] // 2
    assert tree["encoder/encoder/OptimizedLSTMCell_1/hg/kernel"].shape == (half, half)
    lstm_decoder = VARIANTS[variant].get("pred_mode") == "autoregressive"
    assert ("decoder/decoder/fc_hc/kernel" in tree) == lstm_decoder
    if lstm_decoder:
        assert tree["decoder/decoder/fc_hc/kernel"].shape == (SMALL["dim_z"],
                                                              2 * SMALL["d_model"])
