"""Two-stage autoregressive decoding and the decode-only model against the
JAX package, on the CPU.

Small models (the widths of ``tests/test_model.py:SMALL``: d_model 32, 4
heads, FF 64, dim_z 16, two layers a stack, 4 paths x 8 commands) with
weights of the JAX model's shapes drawn from a numpy seed, a batch of N=4
synthetic icons from a numpy seed, float32, JAX's XLA path, jitted. The
variants:

- ``ar_2`` / ``ar_2_rel``: two-stage encoding and two-stage autoregressive
  decoding (D2 and the path latents, then D1 causally over each path's
  shifted targets: S = 9 here, so the training step takes the stack gate,
  K7's plain version with ``causal=True``, at D1), absolute and relative
  targets;
- ``dec_1`` / ``dec_2``: the decode-only model (``encode_stages=0``), one-shot,
  one and two stages; ``dec_ar_1``: decode-only, autoregressive, one stage;
  ``dec_ar_2``: decode-only, two-stage autoregressive.

Held: the logits (and visibility logits) from a given latent within 1e-4;
one training step of ``ar_2`` and ``ar_2_rel`` at dropout 0 against the
gradients of JAX's ``svg_loss`` (each loss term, every leaf within 1e-3 of
its largest entry); the decode-only models' ``greedy_sample`` ids equal to
JAX's (``one_shot_sample``, and the cached scan of ``dec_ar_1``); the weight
bridge both ways (the decode-only tree is ``decoder`` alone); and each thing
the JAX package cannot do refused with an error that says why: every sampler
of a two-stage autoregressive model, encoding or training the decode-only
model.
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
from deepsvg_tpu.models.loss import svg_loss as jax_svg_loss
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    DropoutRng, ModelConfig, SVGTransformer, autoregressive_sample, autoregressive_sample_cached,
    autoregressive_sample_fused, greedy_sample, load_flax_params, svg_loss, to_flax_params)
from deepsvg_tpu_torch.ops import stack_vjp
from deepsvg_tpu_torch.training import constant, create_train_state, make_optimizer, train_step

N, G, S = 4, 4, 8
SMALL = dict(max_num_groups=G, max_seq_len=S, d_model=32, dim_feedforward=64, dim_z=16,
             n_layers=2, n_layers_decode=2, n_heads=4, dropout=0.0)
AR2 = dict(encode_stages=2, decode_stages=2, pred_mode="autoregressive")
VARIANTS = {
    "ar_2": dict(AR2, use_vae=False),
    "ar_2_rel": dict(AR2, rel_targets=True),
    "dec_1": dict(encode_stages=0, decode_stages=1),
    "dec_2": dict(encode_stages=0, decode_stages=2),
    "dec_ar_1": dict(encode_stages=0, decode_stages=1, pred_mode="autoregressive",
                     rel_targets=True),
    "dec_ar_2": dict(encode_stages=0, **{k: v for k, v in AR2.items() if k != "encode_stages"}),
}
DECODE_ONLY = [v for v in VARIANTS if v.startswith("dec")]
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-3          # each leaf's gradient, of the leaf's largest entry
LOSS_TOL = 1e-5
ARGS_TOL = 1e-5
LR = 1e-3
WEIGHTS = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_visibility_weight=1.0,
               loss_cmd_weight=1.0, loss_args_weight=2.0)


def _kw(variant, **extra):
    return {**SMALL, **VARIANTS[variant], **extra}


def _cfg(variant, **extra):
    return ModelConfig(**_kw(variant, **extra))


def _autoregressive(variant):
    return VARIANTS[variant].get("pred_mode") == "autoregressive"


def _model_args(variant):
    return _cfg(variant).get_model_args()


def _batch(variant):
    b = generate_batch(np.random.default_rng(1), N, G, S)
    return {k: b[k] for k in set(_model_args(variant))}


def _latent():
    return np.random.default_rng(2).standard_normal((N, SMALL["dim_z"])).astype(np.float32)


def _dec_inputs(variant, batch, lib):
    """The decoder's targets when autoregressive (the third and fourth model
    arguments), as ``lib`` arrays, else ``(None, None)``."""
    if not _autoregressive(variant):
        return None, None
    conv = jnp.asarray if lib is jnp else torch.from_numpy
    return tuple(conv(batch[k]) for k in _model_args(variant)[2:4])


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_model(variant):
    return JaxSVGTransformer(JaxModelConfig(**_kw(variant), attention_impl="xla"))


_TREES = {}


def _tree(variant):
    """A parameter tree of the JAX model's shapes (``jax.eval_shape`` of its
    init) filled from a numpy seed: kernels and tables normal over the square
    root of their first axis, biases 0.1 normal, LayerNorm scales 1 + 0.1
    normal. The decode-only model is initialised from a latent."""
    if variant not in _TREES:
        batch = _batch(variant)
        data = [jnp.asarray(batch[k]) for k in _model_args(variant)]
        args = data if VARIANTS[variant].get("encode_stages") != 0 else \
            [None, None, *_dec_inputs(variant, batch, jnp)]
        shapes = jax.eval_shape(
            lambda *a: _jax_model(variant).init(
                {"params": jax.random.key(0), "vae": jax.random.key(1)}, *a,
                z=None if VARIANTS[variant].get("encode_stages") != 0 else jnp.asarray(_latent()),
                return_tgt=_autoregressive(variant) or VARIANTS[variant].get("encode_stages") != 0),
            *args)["params"]
        rng = np.random.default_rng(0)

        def leaf(path, shape):
            name, n = path[-1].key, rng.standard_normal(shape.shape).astype(np.float32)
            if name in ("norm1", "norm2"):
                return np.stack([1 + 0.1 * n[0], 0.1 * n[1]])
            if name == "scale":
                return 1 + 0.1 * n
            return 0.1 * n if n.ndim == 1 else n / np.float32(np.sqrt(shape.shape[0]))
        _TREES[variant] = jax.tree_util.tree_map_with_path(leaf, shapes)
    return _TREES[variant]


def _port_model(variant, **extra):
    model = SVGTransformer(_cfg(variant, **extra))
    load_flax_params(model, _tree(variant))
    return model


# ------------------------------------------------------------------- forwards

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_from_a_latent_matches_jax(variant):
    """The logits decoded from a given latent (teacher-forced on the batch's
    targets when autoregressive): ``[N, G, ...]`` and visibility logits for
    two stages, ``[N, 1, ...]`` for one."""
    batch, z = _batch(variant), _latent()
    jm = _jax_model(variant)
    ref = jax.jit(lambda p, z, c, a: jm.apply({"params": p}, None, None, c, a, z=z,
                                              return_tgt=False))(
        _tree(variant), jnp.asarray(z), *_dec_inputs(variant, batch, jnp))
    model = _port_model(variant).eval()
    with torch.no_grad():
        res = model(None, None, *_dec_inputs(variant, batch, torch), z=torch.from_numpy(z))
    assert set(res) == set(ref)
    two_stage = VARIANTS[variant]["decode_stages"] == 2
    assert ("visibility_logits" in res) == two_stage
    assert res["command_logits"].shape[:2] == (N, G if two_stage else 1)
    for key in ref:
        assert res[key].shape == ref[key].shape, key
        err = np.abs(res[key].numpy() - np.asarray(ref[key])).max()
        print(f"{variant} {key}: max abs err {err:.3g}")
        assert err <= LOGIT_TOL, key


# ---------------------------------------------------------------------- steps

@pytest.mark.parametrize("variant", ["ar_2", "ar_2_rel"])
def test_two_stage_autoregressive_step_matches_jax(monkeypatch, variant):
    """One step at dropout 0 (the VAE of ``ar_2_rel`` at its mean: JAX's
    ``sample_vae=False``, zero noise in the port): each loss term, the
    global norm and every leaf's gradient. Every stack takes the stack gate
    at these sizes: E1, E2, D2, and D1 causal (N x G = 16 sequences of 9)."""
    batch = _batch(variant)
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
    ref_res, ref_grads, ref_norm = grads(_tree(variant))
    monkeypatch.setattr(DropoutRng, "normal",
                        lambda self, shape, dtype, device: torch.zeros(shape, dtype=dtype,
                                                                       device=device))
    stacks = []
    kernel_stack = stack_vjp.fused_stack_train

    def spy(*args, **kw):
        stacks.append((tuple(args[0].shape), args[-3]))       # (x's shape, causal)
        return kernel_stack(*args, **kw)
    monkeypatch.setattr(stack_vjp, "fused_stack_train", spy)
    model = _port_model(variant)
    optimizer = make_optimizer(constant(LR))
    state = create_train_state(model, optimizer, init=False)
    state, res = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, WEIGHTS,
                            optimizer, _model_args(variant))
    assert sorted(stacks) == sorted([((N * G, S + 2, 32), False), ((N, G, 32), False),
                                     ((N, G, 32), False), ((N * G, S + 1, 32), True)])
    assert set(res) == set(ref_res) | {"grad_norm"}
    for k in ref_res:
        np.testing.assert_allclose(float(res[k]), float(ref_res[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(float(res["grad_norm"]), float(ref_norm), rtol=1e-4)
    ours, theirs = _leaves(to_flax_params(state.model, grads=True)), _leaves(ref_grads)
    assert set(ours) == set(theirs)
    errs = {k: np.abs(ours[k] - np.asarray(g)).max() / max(np.abs(np.asarray(g)).max(), 1e-12)
            for k, g in theirs.items()}
    worst = max(errs, key=errs.get)
    print(f"{variant}: losses {({k: float(res[k]) for k in ref_res})}; worst gradient leaf "
          f"{worst}: {errs[worst]:.3g} of its largest entry")
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


# ------------------------------------------------------------------- sampling

@pytest.mark.parametrize("variant", ["dec_1", "dec_2", "dec_ar_1"])
def test_decode_only_greedy_sample_matches_jax(variant):
    """``greedy_sample`` of a latent: JAX's one-shot sample (the visibility
    threshold with two stages) or its KV-cached scan, against the port's
    (the cached scan on CPU tensors): ids equal, arguments within 1e-5."""
    z = _latent()
    jm = _jax_model(variant)
    ref_c, ref_a = jax.jit(lambda p, z: jax_sample.greedy_sample(jm, {"params": p}, z=z))(
        _tree(variant), jnp.asarray(z))
    c, a = greedy_sample(_port_model(variant).eval(), z=torch.from_numpy(z))
    assert c.shape == ref_c.shape and a.shape == ref_a.shape
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), atol=ARGS_TOL, rtol=0)


@pytest.mark.parametrize("variant", ["ar_2", "dec_ar_2"])
def test_two_stage_autoregressive_samplers_refuse(variant):
    """Every sampler of a two-stage autoregressive model fails in the JAX
    package (a shape error where the paths are folded): the port raises."""
    model = _port_model(variant).eval()
    z = torch.from_numpy(_latent())
    for sampler in (autoregressive_sample, autoregressive_sample_cached,
                    autoregressive_sample_fused):
        with pytest.raises(ValueError, match="two-stage autoregressive"):
            sampler(model, z)
    with pytest.raises(ValueError, match="two-stage autoregressive"):
        greedy_sample(model, z=z)


def test_two_stage_autoregressive_needs_one_proposal_per_path():
    with pytest.raises(ValueError, match="num_groups_proposal"):
        SVGTransformer(_cfg("ar_2", num_groups_proposal=G + 1))
    SVGTransformer(_cfg("dec_2", num_groups_proposal=G + 1))          # one-shot: any P


def test_decode_only_model_refuses_to_encode_or_train():
    """The decode-only model has no encoder: ``encode``, a forward without
    ``z`` and the training step (whose JAX counterpart encodes its inputs
    and fails) raise; ``svg_loss`` refuses it too."""
    variant = "dec_ar_1"
    batch = _batch(variant)
    model = _port_model(variant)
    enc = [torch.from_numpy(batch[k]) for k in _model_args(variant)[:2]]
    with pytest.raises(ValueError, match="no encoder"):
        model.encode(*enc)
    with pytest.raises(ValueError, match="no encoder"):
        model(*enc, *_dec_inputs(variant, batch, torch))
    optimizer = make_optimizer(constant(LR))
    state = create_train_state(model, optimizer, init=False)
    with pytest.raises(ValueError, match="cannot be trained"):
        train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, WEIGHTS, optimizer,
                   _model_args(variant))
    out = model(None, None, *_dec_inputs(variant, batch, torch), z=torch.from_numpy(_latent()),
                return_tgt=True)
    with pytest.raises(ValueError, match="cannot be trained"):
        svg_loss(out, WEIGHTS, model.cfg)


# --------------------------------------------------------------- weight bridge

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_weight_bridge_round_trip(variant):
    """Every leaf of the tree is used once and comes back to the bit; the
    decode-only trees are ``decoder`` alone; the two-stage autoregressive
    decoder has the hierarchical modules beside the token embedding."""
    tree = _leaves(_tree(variant))
    model = SVGTransformer(_cfg(variant))
    assert load_flax_params(model, _tree(variant)) == len(tree)
    back = _leaves(to_flax_params(model))
    assert set(back) == set(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert (set(_tree(variant)) == {"decoder"}) == (variant in DECODE_ONLY)
    if variant.startswith("ar_2"):
        assert "decoder/hierarchical_decoder/norm/scale" in tree
        assert tree["decoder/embedding/group_embed"].shape == (G * S + 2, 32)
