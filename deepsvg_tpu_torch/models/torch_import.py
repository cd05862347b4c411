"""Import the reference implementation's PyTorch checkpoints.

The reference publishes its weights as ``.pth.tar`` files holding
``{"model": state_dict, "cfg": {...}, ...}`` (``hierarchical_ordered.pth.tar``
and ``hierarchical_ordered_fonts.pth.tar``). :func:`state_dict_to_params`
renames such a ``state_dict`` into the flax parameter tree of
``deepsvg_tpu/models/torch_import.py``, as numpy arrays, which
:func:`models.weights.load_flax_params` copies into the port's modules:

- the ``module.`` prefix of an ``nn.DataParallel`` wrapper is dropped;
- linear weights ``[out, in]`` are transposed to flax's ``[in, out]``;
- each layer's ``norm1`` / ``norm2`` are stacked ``[2, D]`` (scale, bias);
  the stacks' final LayerNorms stay ``norm/{scale, bias}``;
- ``encoder/hierarchical_PE`` and the label embeddings are read only where
  their keys are present (the self-matching model has no path positions);
- an ``nn.LSTM`` direction (gates packed row-wise in the order i, f, g, o,
  with two biases) becomes the per-gate kernels of a flax
  ``OptimizedLSTMCell``, the hidden side's bias taking ``bias_ih + bias_hh``.

Covered: transformer and LSTM models, one or two stages, one-shot and
autoregressive decoders, the VAE or the linear bottleneck, labels.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def _strip_module_prefix(sd: dict) -> dict:
    """Drop the ``module.`` prefix that an ``nn.DataParallel`` wrapper puts
    on every key."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def state_dict_to_params(sd: dict, cfg: ModelConfig) -> dict:
    """A reference ``state_dict`` (values numpy arrays or tensors) -> the
    flax parameter tree of ``SVGTransformer(cfg)``, nested dicts of numpy
    arrays."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
          for k, v in _strip_module_prefix(sd).items()}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def ln_stacked(prefix):
        return np.stack([sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]])

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def enc_layer(prefix):
        p = {
            "wqkv": sd[f"{prefix}.self_attn.in_proj_weight"].T,
            "bqkv": sd[f"{prefix}.self_attn.in_proj_bias"],
            "wo": sd[f"{prefix}.self_attn.out_proj.weight"].T,
            "bo": sd[f"{prefix}.self_attn.out_proj.bias"],
            "norm1": ln_stacked(f"{prefix}.norm1"),
            "norm2": ln_stacked(f"{prefix}.norm2"),
            "ff1_kernel": sd[f"{prefix}.linear1.weight"].T,
            "ff1_bias": sd[f"{prefix}.linear1.bias"],
            "ff2_kernel": sd[f"{prefix}.linear2.weight"].T,
            "ff2_bias": sd[f"{prefix}.linear2.bias"],
        }
        if f"{prefix}.linear_global2.weight" in sd:          # label conditioning
            p["glob2_kernel"] = sd[f"{prefix}.linear_global2.weight"].T
            p["glob2_bias"] = sd[f"{prefix}.linear_global2.bias"]
        return p

    def dec_layer(prefix):
        p = enc_layer(prefix)
        p["glob_kernel"] = sd[f"{prefix}.linear_global.weight"].T
        p["glob_bias"] = sd[f"{prefix}.linear_global.bias"]
        return p

    def stack(prefix, n, layer_fn):
        out = {f"layer_{i}": layer_fn(f"{prefix}.layers.{i}") for i in range(n)}
        out["norm"] = ln(f"{prefix}.norm")
        return out

    def svg_embedding(prefix):
        p = {
            "command_embed": sd[f"{prefix}.command_embed.weight"],
            "arg_embed": sd[f"{prefix}.arg_embed.weight"],
            "embed_fcn_kernel": sd[f"{prefix}.embed_fcn.weight"].T,
            "embed_fcn_bias": sd[f"{prefix}.embed_fcn.bias"],
            "pos_embed": sd[f"{prefix}.pos_encoding.pos_embed.weight"],
        }
        if f"{prefix}.group_embed.weight" in sd:
            p["group_embed"] = sd[f"{prefix}.group_embed.weight"]
        return p

    def const_embedding(prefix):
        return {"PE": {"pos_embed": sd[f"{prefix}.PE.pos_embed.weight"]}}

    def label_embedding(prefix):
        return {"label_embedding": {"embedding": sd[f"{prefix}.label_embedding.weight"]}}

    def lstm_cell(prefix, suffix=""):
        """One ``nn.LSTM`` direction -> the per-gate kernels of a flax
        ``OptimizedLSTMCell`` (the same gate equations)."""
        wih = sd[f"{prefix}.weight_ih_l0{suffix}"]
        whh = sd[f"{prefix}.weight_hh_l0{suffix}"]
        bias = sd[f"{prefix}.bias_ih_l0{suffix}"] + sd[f"{prefix}.bias_hh_l0{suffix}"]
        h = whh.shape[1]
        cell = {}
        for gi, g in enumerate(("i", "f", "g", "o")):
            rows = slice(gi * h, (gi + 1) * h)
            cell[f"i{g}"] = {"kernel": wih[rows].T}
            cell[f"h{g}"] = {"kernel": whh[rows].T, "bias": bias[rows]}
        return cell

    params: dict = {}
    if cfg.model_type == "lstm":
        enc_stack = {"OptimizedLSTMCell_0": lstm_cell("encoder.encoder"),
                     "OptimizedLSTMCell_1": lstm_cell("encoder.encoder", "_reverse")}
    else:
        enc_stack = stack("encoder.encoder", cfg.n_layers, enc_layer)
    enc = {"embedding": svg_embedding("encoder.embedding"), "encoder": enc_stack}
    if cfg.encode_stages == 2:
        if "encoder.hierarchical_PE.pos_embed.weight" in sd:
            enc["hierarchical_PE"] = {"pos_embed": sd["encoder.hierarchical_PE.pos_embed.weight"]}
        enc["hierarchical_encoder"] = stack("encoder.hierarchical_encoder", cfg.n_layers,
                                            enc_layer)
    if cfg.label_condition and "encoder.label_embedding.label_embedding.weight" in sd:
        enc["label_embedding"] = label_embedding("encoder.label_embedding")
    params["encoder"] = enc

    if cfg.use_resnet:
        params["resnet"] = {f"linear{i}": dense(f"resnet.linear{i}.0") for i in range(1, 5)}
    if cfg.use_vae:
        params["vae"] = {"enc_mu_fcn": dense("vae.enc_mu_fcn"),
                         "enc_sigma_fcn": dense("vae.enc_sigma_fcn")}
    else:
        params["bottleneck"] = {"bottleneck": dense("bottleneck.bottleneck")}

    dec: dict = {}
    if cfg.decode_stages == 2:
        dec["hierarchical_embedding"] = const_embedding("decoder.hierarchical_embedding")
        dec["hierarchical_decoder"] = stack("decoder.hierarchical_decoder", cfg.n_layers_decode,
                                            dec_layer)
        dec["hierarchical_fcn"] = {
            "visibility_fcn": dense("decoder.hierarchical_fcn.visibility_fcn"),
            "z_fcn": dense("decoder.hierarchical_fcn.z_fcn"),
        }
    if cfg.pred_mode == "autoregressive":
        dec["embedding"] = svg_embedding("decoder.embedding")
    else:
        dec["embedding"] = const_embedding("decoder.embedding")
    if cfg.model_type == "lstm":
        dec["decoder"] = {"fc_hc": dense("decoder.fc_hc"),
                          "OptimizedLSTMCell_0": lstm_cell("decoder.decoder")}
    else:
        dec["decoder"] = stack("decoder.decoder", cfg.n_layers_decode, dec_layer)
    dec["fcn"] = {
        "command_kernel": sd["decoder.fcn.command_fcn.weight"].T,
        "command_bias": sd["decoder.fcn.command_fcn.bias"],
        "args_kernel": sd["decoder.fcn.args_fcn.weight"].T,
        "args_bias": sd["decoder.fcn.args_fcn.bias"],
    }
    if cfg.label_condition and "decoder.label_embedding.label_embedding.weight" in sd:
        dec["label_embedding"] = label_embedding("decoder.label_embedding")
    params["decoder"] = dec
    return params


def load_torch_checkpoint(path: str, cfg: ModelConfig) -> dict:
    """Read a reference ``.pth.tar`` checkpoint (or a bare ``state_dict``
    file) on the CPU and return the flax parameter tree of
    ``SVGTransformer(cfg)`` as numpy arrays, for
    :func:`models.weights.load_flax_params`. The file is unpickled with
    ``weights_only=True`` first, and without it where that fails (the
    reference's checkpoints also pickle their config)."""
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state.get("model", state) if isinstance(state, dict) else state
    return state_dict_to_params(dict(sd), cfg)
