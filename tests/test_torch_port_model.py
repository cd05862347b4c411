"""The PyTorch port's flagship inference slice against the JAX package, on
the CPU, with the trained checkpoint in the repo.

The port runs in float32 on CPU tensors, so every kernel wrapper takes its
plain version. It is held against the JAX XLA path (logits, atol 1e-4: the
two frameworks sum in different orders through 16 layers) and against
greedy sampling on the JAX Pallas path in interpret mode (ids identical
wherever JAX's two best logits differ by at least 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models.sample import one_shot_sample as jax_one_shot_sample
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    SVGTransformer, checkpoint, hierarchical_ordered, load_flax_params, load_model,
    one_shot_sample)

ARTIFACT = "docs/artifacts/full_run_final_params.msgpack"
N = 4
MARGIN = 1e-4


def _top2_margin(logits):
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.fixture(scope="module")
def tree():
    return checkpoint.load_params(ARTIFACT)


@pytest.fixture(scope="module")
def port_model(tree):
    model = SVGTransformer(hierarchical_ordered()).eval()
    load_flax_params(model, tree)
    return model


@pytest.fixture(scope="module")
def batch():
    b = generate_batch(np.random.default_rng(0), N)
    return b["commands"], b["args"]


@pytest.fixture(scope="module")
def jax_run(batch):
    """JAX XLA logits and latent, and the JAX Pallas (interpret) greedy ids
    and samples, all float32."""
    with open(ARTIFACT, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    c, a = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    out = {}
    for impl in ("xla", "pallas"):
        cfg = JaxModelConfig(encode_stages=2, decode_stages=2, use_vae=False,
                             label_condition=False, attention_impl=impl)
        model = JaxSVGTransformer(cfg)
        if impl == "xla":
            out["logits"] = model.apply({"params": params}, c, a, None, None,
                                        return_tgt=False)
            out["z"] = model.apply({"params": params}, c, a, method=model.encode)[0]
        else:
            out["ids"] = model.apply({"params": params}, c, a, None, None,
                                     return_tgt=False, argmax_head=True)
            out["sample"] = jax_one_shot_sample(model, {"params": params},
                                                commands_enc=c, args_enc=a)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_inputs(batch):
    return torch.from_numpy(batch[0]), torch.from_numpy(batch[1])


# ------------------------------------------------------------- weight bridge

def test_weight_bridge_uses_every_leaf(tree):
    model = SVGTransformer(hierarchical_ordered())
    assert load_flax_params(model, tree) == 210
    n_params = sum(p.numel() for p in model.parameters())
    n_leaves = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(tree))
    assert n_params == n_leaves == 10_304_596
    emb = model.encoder.embedding
    np.testing.assert_array_equal(emb.embed_fcn.weight.detach().numpy(),
                                  tree["encoder"]["embedding"]["embed_fcn_kernel"].T)
    layer = model.decoder.decoder.layers[3]
    np.testing.assert_array_equal(layer.norm2.detach().numpy(),
                                  tree["decoder"]["decoder"]["layer_3"]["norm2"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_weight_bridge_rejects_a_tree_that_does_not_fit(tree, fault):
    bad = jax.tree_util.tree_map(lambda x: x, tree)       # a copy of the dicts
    fcn = bad["decoder"]["fcn"]
    if fault == "missing":
        del fcn["command_bias"]
    elif fault == "extra":
        fcn["label_kernel"] = np.zeros((3, 3), np.float32)
    else:
        fcn["command_bias"] = np.zeros((8,), np.float32)
    with pytest.raises(ValueError, match="command_bias|label_kernel"):
        load_flax_params(SVGTransformer(hierarchical_ordered()), bad)


def test_load_state_dict_repacks_the_heads(port_model):
    """The kernel's padded copy of the heads follows a ``load_state_dict``."""
    model = SVGTransformer(hierarchical_ordered())
    model.load_state_dict(port_model.state_dict())
    for name in ("w_packed", "b_packed"):
        torch.testing.assert_close(getattr(model.decoder.fcn, name),
                                   getattr(port_model.decoder.fcn, name), rtol=0, atol=0)


# -------------------------------------------------------------- whole slice

def test_encode_matches_jax_xla(port_model, batch, jax_run):
    with torch.no_grad():
        z, mu, logsigma = port_model.encode(*_port_inputs(batch))
    assert mu is None and logsigma is None             # no VAE
    np.testing.assert_allclose(z.numpy(), jax_run["z"], atol=1e-4, rtol=0)


def test_logits_match_jax_xla(port_model, batch, jax_run):
    with torch.no_grad():
        res = port_model(*_port_inputs(batch))
    for key in ("command_logits", "args_logits", "visibility_logits"):
        assert res[key].shape == jax_run["logits"][key].shape, key
        np.testing.assert_allclose(res[key].numpy(), jax_run["logits"][key],
                                   atol=1e-4, rtol=0, err_msg=key)


def test_argmax_ids_match_jax_pallas(port_model, batch, jax_run):
    with torch.no_grad():
        res = port_model(*_port_inputs(batch), argmax_head=True)
    logits = jax_run["logits"]
    for key, lkey in (("command_ids", "command_logits"), ("args_ids", "args_logits")):
        ours, theirs = res[key].numpy(), jax_run["ids"][key]
        assert ours.shape == theirs.shape, key
        differ = ours != theirs
        assert (_top2_margin(logits[lkey])[differ] < MARGIN).all(), key
        assert differ.mean() < 1e-3, key


def test_one_shot_sample_matches_jax_pallas(port_model, batch, jax_run):
    commands, args = one_shot_sample(port_model, *_port_inputs(batch))
    ref_c, ref_a = jax_run["sample"]
    assert commands.shape == ref_c.shape == (N, 8, 31)
    assert args.shape == ref_a.shape == (N, 8, 31, 11)
    assert args.dtype == torch.float32
    logits = jax_run["logits"]
    vis_p = jax.nn.softmax(logits["visibility_logits"], axis=-1)[..., 1]
    close = (np.abs(np.asarray(vis_p) - 0.7) < MARGIN)[..., None]   # [N, G, 1]
    cmd_close = close | (_top2_margin(logits["command_logits"]) < MARGIN)
    cmd_differ = commands.numpy() != ref_c
    assert not (cmd_differ & ~cmd_close).any()
    args_close = cmd_close[..., None] | (_top2_margin(logits["args_logits"]) < MARGIN)
    assert not ((args.numpy() != ref_a) & ~args_close).any()
    assert commands.numpy().min() >= 0 and args.numpy().min() >= -1


# --------------------------------------------------- variants and device rule

@pytest.mark.parametrize("change", [
    {"pred_mode": "autoregressive"},
    {"pred_mode": "autoregressive", "rel_targets": True}, {"model_type": "lstm"},
    {"encode_stages": 0}, {"encode_stages": 1, "pred_mode": "autoregressive"},
])
def test_variants_outside_the_slice_raise(change):
    """The variants that raised until the LSTM, two-stage autoregressive
    decoding and the decode-only model were ported: the flagship's config
    with one change, at full width, now builds and gives JAX's logits (XLA
    path, float32, atol 1e-4) on two icons, teacher-forced when
    autoregressive, from a given latent when decode-only, with weights of
    the JAX model's shapes drawn from a numpy seed."""
    cfg = dataclasses.replace(hierarchical_ordered(), **change)
    b = generate_batch(np.random.default_rng(1), 2)
    keys = cfg.get_model_args()
    jax_model = JaxSVGTransformer(JaxModelConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))
    data = [jnp.asarray(b[k]) for k in keys]
    decode_only = cfg.encode_stages == 0
    ar = cfg.pred_mode == "autoregressive"
    z = np.random.default_rng(2).standard_normal((2, cfg.dim_z)).astype(np.float32)
    enc, dec = (None, None) if decode_only else data[:2], data[2:4] if ar else (None, None)
    shapes = jax.eval_shape(
        lambda *a: jax_model.init({"params": jax.random.key(0)}, *a,
                                  z=jnp.asarray(z) if decode_only else None, return_tgt=ar),
        *enc, *dec)["params"]
    rng = np.random.default_rng(0)

    def leaf(path, shape):
        name, n = path[-1].key, rng.standard_normal(shape.shape).astype(np.float32)
        if name in ("norm1", "norm2"):
            return np.stack([1 + 0.1 * n[0], 0.1 * n[1]])
        if name == "scale":
            return 1 + 0.1 * n
        return 0.1 * n if n.ndim == 1 else n / np.float32(np.sqrt(shape.shape[0]))
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    ref = jax.jit(lambda p, enc, dec, z: jax_model.apply(
        {"params": p}, *enc, *dec, z=z, return_tgt=False))(
        params, enc, dec, jnp.asarray(z) if decode_only else None)
    model = SVGTransformer(cfg).eval()
    load_flax_params(model, params)
    to_torch = lambda xs: [None if x is None else torch.from_numpy(np.asarray(x))  # noqa: E731
                           for x in xs]
    with torch.no_grad():
        res = model(*to_torch(enc), *to_torch(dec),
                    z=torch.from_numpy(z) if decode_only else None)
    assert set(res) == set(ref)
    for key in ref:
        assert res[key].shape == ref[key].shape, key
        np.testing.assert_allclose(res[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("change", [
    {"label_condition": True}, {"decode_stages": 1}, {"encode_stages": 1, "decode_stages": 1},
])
def test_variants_in_the_slice_match_jax(change):
    """The flagship's config with one change, at full width: the port's model
    builds, loads JAX's initialisation of the variant and gives its logits
    (JAX's XLA path, float32, atol 1e-4) on two icons."""
    cfg = dataclasses.replace(hierarchical_ordered(), **change)
    b = generate_batch(np.random.default_rng(1), 2, label_range=cfg.n_labels)
    keys = cfg.get_model_args()
    jax_model = JaxSVGTransformer(JaxModelConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))
    params = jax.jit(jax_model.init)({"params": jax.random.key(0)},
                                     *(jnp.asarray(b[k]) for k in keys))["params"]
    enc = [jnp.asarray(b[k]) for k in keys[:2]]
    label = jnp.asarray(b["label"]) if cfg.label_condition else None
    ref = jax_model.apply({"params": params}, *enc, None, None, label=label, return_tgt=False)
    model = SVGTransformer(cfg).eval()
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        res = model(*(torch.from_numpy(b[k]) for k in keys[:2]), label=None if label is None
                    else torch.from_numpy(b["label"]))
    assert set(res) == set(ref)
    for key in ref:
        assert res[key].shape == ref[key].shape, key
        np.testing.assert_allclose(res[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0,
                                   err_msg=key)


def test_default_device_needs_cuda(monkeypatch):
    """With no CUDA card, an entry point left to its default device raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(ARTIFACT, hierarchical_ordered())
    model = load_model(ARTIFACT, hierarchical_ordered(), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
