"""The reference-checkpoint import (``models/torch_import.py``) against the JAX
package's ``state_dict_to_params``, on the CPU.

No reference checkpoint is in the repository, so each case writes a
synthetic ``state_dict`` with the reference implementation's key names and
shapes (as ``deepsvg_tpu/models/torch_import.py`` reads them: ``nn.Linear``
weights ``[out, in]``, ``nn.TransformerEncoderLayer``'s ``self_attn``,
``linear1/2`` and ``norm1/2``, the embeddings' ``.weight`` tables, an
``nn.LSTM``'s ``weight_ih_l0`` / ``weight_hh_l0`` / ``bias_ih_l0`` /
``bias_hh_l0`` and their ``_reverse``) for the parameter tree of a small
model (the widths of ``tests/test_model.py:SMALL``), with values from a
numpy seed. The dict goes through both imports: every leaf equal to the bit,
the tree the JAX model's own, and the port's forward on its import within
1e-5 of JAX's on its own (the latent at the VAE's mean, then the logits;
teacher-forced when autoregressive). The models: the flagship, Sketchformer,
SketchRNN, the self-matching model (no ``hierarchical_PE``), the fonts model
(label embeddings), and a dict whose keys carry ``module.``; then
``load_torch_checkpoint`` on a ``.pth.tar``-style file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models import torch_import as jax_torch_import
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    ModelConfig, SVGTransformer, load_flax_params, load_torch_checkpoint, state_dict_to_params)

N, G, S, N_LABELS = 4, 4, 8, 10
SMALL = dict(max_num_groups=G, max_seq_len=S, d_model=32, dim_feedforward=64, dim_z=16,
             n_layers=2, n_layers_decode=2, n_heads=4, dropout=0.0)
MODELS = {
    "flagship": dict(encode_stages=2, decode_stages=2, use_vae=False),
    "sketchformer": dict(pred_mode="autoregressive", rel_targets=True),
    "sketchrnn": dict(model_type="lstm", pred_mode="autoregressive", rel_targets=True),
    "self_matching": dict(encode_stages=2, decode_stages=2, self_match=True),
    "fonts": dict(encode_stages=2, decode_stages=2, use_vae=False, label_condition=True,
                  n_labels=N_LABELS, dim_label=64),
}
FORWARD_TOL = 1e-5


def _cfg(name):
    return ModelConfig(**SMALL, **MODELS[name])


def _jax_model(name):
    return JaxSVGTransformer(JaxModelConfig(**SMALL, **MODELS[name], attention_impl="xla"))


def _batch(name):
    b = generate_batch(np.random.default_rng(1), N, G, S, label_range=N_LABELS)
    keys = _cfg(name).get_model_args()
    return [b[k] for k in keys[:4]], b["label"] if _cfg(name).label_condition else None


def _shapes(name):
    data, label = _batch(name)
    return jax.eval_shape(
        lambda *a: _jax_model(name).init({"params": jax.random.key(0), "vae": jax.random.key(1)},
                                         *a, label=label),
        *[jnp.asarray(x) for x in data])["params"]


def _reference_state_dict(tree, seed=0):
    """A state dict with the reference's names and shapes for the flax
    (shape) ``tree``, values from a numpy seed: matrices normal over the
    square root of their input width, vectors 0.1 normal, LayerNorm weights
    1 + 0.1 normal."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, shape):
        n = rng.standard_normal(shape).astype(np.float32)
        sd[key] = n / np.float32(np.sqrt(shape[-1])) if len(shape) == 2 else 0.1 * n

    def ln(prefix, d):
        sd[f"{prefix}.weight"] = 1 + 0.1 * rng.standard_normal(d).astype(np.float32)
        put(f"{prefix}.bias", (d,))

    def dense(prefix, p):
        fan_in, out = p["kernel"].shape
        put(f"{prefix}.weight", (out, fan_in))
        put(f"{prefix}.bias", (out,))

    def layer(prefix, p):
        d, f = p["wo"].shape[0], p["ff1_kernel"].shape[1]
        put(f"{prefix}.self_attn.in_proj_weight", (3 * d, d))
        put(f"{prefix}.self_attn.in_proj_bias", (3 * d,))
        dense(f"{prefix}.self_attn.out_proj", {"kernel": p["wo"], "bias": p["bo"]})
        ln(f"{prefix}.norm1", d)
        ln(f"{prefix}.norm2", d)
        dense(f"{prefix}.linear1", {"kernel": p["ff1_kernel"], "bias": p["ff1_bias"]})
        dense(f"{prefix}.linear2", {"kernel": p["ff2_kernel"], "bias": p["ff2_bias"]})
        for name, torch_name in (("glob", "linear_global"), ("glob2", "linear_global2")):
            if f"{name}_kernel" in p:
                dense(f"{prefix}.{torch_name}", {"kernel": p[f"{name}_kernel"],
                                                 "bias": p[f"{name}_bias"]})

    def stack(prefix, p):
        for i in range(sum(k.startswith("layer_") for k in p)):
            layer(f"{prefix}.layers.{i}", p[f"layer_{i}"])
        ln(f"{prefix}.norm", p["norm"]["scale"].shape[0])

    def svg_embedding(prefix, p):
        put(f"{prefix}.command_embed.weight", p["command_embed"].shape)
        put(f"{prefix}.arg_embed.weight", p["arg_embed"].shape)
        put(f"{prefix}.embed_fcn.weight", p["embed_fcn_kernel"].shape[::-1])
        put(f"{prefix}.embed_fcn.bias", p["embed_fcn_bias"].shape)
        put(f"{prefix}.pos_encoding.pos_embed.weight", p["pos_embed"].shape)
        if "group_embed" in p:
            put(f"{prefix}.group_embed.weight", p["group_embed"].shape)

    def lstm(prefix, cell, suffix=""):
        h, fan_in = cell["hi"]["kernel"].shape[0], cell["ii"]["kernel"].shape[0]
        put(f"{prefix}.weight_ih_l0{suffix}", (4 * h, fan_in))
        put(f"{prefix}.weight_hh_l0{suffix}", (4 * h, h))
        put(f"{prefix}.bias_ih_l0{suffix}", (4 * h,))
        put(f"{prefix}.bias_hh_l0{suffix}", (4 * h,))

    def label_embedding(prefix, part):
        if "label_embedding" in part:
            put(f"{prefix}.label_embedding.label_embedding.weight",
                part["label_embedding"]["label_embedding"]["embedding"].shape)

    enc = tree["encoder"]
    svg_embedding("encoder.embedding", enc["embedding"])
    if "OptimizedLSTMCell_0" in enc["encoder"]:
        lstm("encoder.encoder", enc["encoder"]["OptimizedLSTMCell_0"])
        lstm("encoder.encoder", enc["encoder"]["OptimizedLSTMCell_1"], "_reverse")
    else:
        stack("encoder.encoder", enc["encoder"])
    if "hierarchical_PE" in enc:
        put("encoder.hierarchical_PE.pos_embed.weight", enc["hierarchical_PE"]["pos_embed"].shape)
    if "hierarchical_encoder" in enc:
        stack("encoder.hierarchical_encoder", enc["hierarchical_encoder"])
    label_embedding("encoder", enc)
    for i in range(1, 5):
        dense(f"resnet.linear{i}.0", tree["resnet"][f"linear{i}"])
    if "vae" in tree:
        dense("vae.enc_mu_fcn", tree["vae"]["enc_mu_fcn"])
        dense("vae.enc_sigma_fcn", tree["vae"]["enc_sigma_fcn"])
    else:
        dense("bottleneck.bottleneck", tree["bottleneck"]["bottleneck"])
    dec = tree["decoder"]
    if "hierarchical_decoder" in dec:
        put("decoder.hierarchical_embedding.PE.pos_embed.weight",
            dec["hierarchical_embedding"]["PE"]["pos_embed"].shape)
        stack("decoder.hierarchical_decoder", dec["hierarchical_decoder"])
        for head in ("visibility_fcn", "z_fcn"):
            dense(f"decoder.hierarchical_fcn.{head}", dec["hierarchical_fcn"][head])
    if "PE" in dec["embedding"]:
        put("decoder.embedding.PE.pos_embed.weight", dec["embedding"]["PE"]["pos_embed"].shape)
    else:
        svg_embedding("decoder.embedding", dec["embedding"])
    if "fc_hc" in dec["decoder"]:
        dense("decoder.fc_hc", dec["decoder"]["fc_hc"])
        lstm("decoder.decoder", dec["decoder"]["OptimizedLSTMCell_0"])
    else:
        stack("decoder.decoder", dec["decoder"])
    fcn = dec["fcn"]
    dense("decoder.fcn.command_fcn", {"kernel": fcn["command_kernel"], "bias": fcn["command_bias"]})
    dense("decoder.fcn.args_fcn", {"kernel": fcn["args_kernel"], "bias": fcn["args_bias"]})
    label_embedding("decoder", dec)
    return sd


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_forward(name, params):
    """JAX's latent (the VAE's mean) and the logits decoded from it, jitted."""
    jm = _jax_model(name)
    data, label = _batch(name)
    autoregressive = jm.cfg.pred_mode == "autoregressive"

    @jax.jit
    def run(p, enc, dec, label):
        z = jm.apply({"params": p}, *enc, label, method=JaxSVGTransformer.encode,
                     sample_vae=False)[0]
        return z, jm.apply({"params": p}, None, None, *dec, label=label, z=z, return_tgt=False)
    data = [jnp.asarray(x) for x in data]
    out = run(params, data[:2], data[2:4] if autoregressive else [None, None],
              None if label is None else jnp.asarray(label))
    return jax.tree_util.tree_map(np.asarray, out)


def _port_forward(name, tree):
    model = SVGTransformer(_cfg(name)).eval()
    assert load_flax_params(model, tree) == len(_leaves(tree))
    data, label = _batch(name)
    data = [torch.from_numpy(x) for x in data]
    label = None if label is None else torch.from_numpy(label)
    with torch.no_grad():
        z = model.encode(*data[:2], label, sample_vae=False)[0]
        dec = data[2:4] if model.cfg.pred_mode == "autoregressive" else [None, None]
        return z, model(None, None, *dec, label=label, z=z)


@pytest.mark.parametrize("name", list(MODELS) + ["module_prefix"])
def test_import_matches_jax(name):
    model_name = "flagship" if name == "module_prefix" else name
    shapes = _shapes(model_name)
    sd = _reference_state_dict(shapes)
    if name == "module_prefix":
        sd = {f"module.{k}": v for k, v in sd.items()}
    jax_cfg = JaxModelConfig(**dataclasses.asdict(_cfg(model_name)))
    ref = _leaves(jax_torch_import.state_dict_to_params(sd, jax_cfg))
    ours = _leaves(state_dict_to_params(sd, _cfg(model_name)))
    assert set(ours) == set(ref) == set(_leaves(shapes))
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    has = {part for k in ours for part in k.split("/")}
    assert ("hierarchical_PE" in has) == (model_name in ("flagship", "fonts"))
    assert ("label_embedding" in has) == (model_name == "fonts")
    assert ("OptimizedLSTMCell_0" in has) == (model_name == "sketchrnn")
    z_ref, out_ref = _jax_forward(model_name, jax_torch_import.state_dict_to_params(sd, jax_cfg))
    z, out = _port_forward(model_name, state_dict_to_params(sd, _cfg(model_name)))
    errs = {"z": np.abs(z.numpy() - z_ref).max()}
    assert set(out) == set(out_ref)
    for key, value in out_ref.items():
        assert out[key].shape == value.shape, key
        errs[key] = np.abs(out[key].numpy() - value).max()
    print(f"{name}: max abs errors {errs}")
    assert max(errs.values()) <= FORWARD_TOL, errs


def test_load_torch_checkpoint(tmp_path):
    """A ``.pth.tar``-style file (``{"model": state_dict, "cfg": ...}`` of
    tensors) and a bare state dict load to the tree of
    ``state_dict_to_params``, and to the bits of the JAX package's loader."""
    cfg = _cfg("sketchrnn")
    sd = _reference_state_dict(_shapes("sketchrnn"), seed=3)
    want = _leaves(state_dict_to_params(sd, cfg))
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    checkpoint, bare = tmp_path / "model.pth.tar", tmp_path / "state_dict.pth"
    torch.save({"model": tensors, "cfg": {"d_model": 32}, "epoch": 3}, checkpoint)
    torch.save(tensors, bare)
    jax_cfg = JaxModelConfig(**dataclasses.asdict(cfg))
    for path in (checkpoint, bare):
        got = _leaves(load_torch_checkpoint(str(path), cfg))
        ref = _leaves(jax_torch_import.load_torch_checkpoint(str(path), jax_cfg))
        assert set(got) == set(want) == set(ref)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
