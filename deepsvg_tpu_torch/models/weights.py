"""Weight bridge: the JAX package's flax parameter tree <-> the port's modules.

The layouts differ in three ways:

- a flax ``Dense`` kernel is ``[in, out]``; an ``nn.Linear`` weight is
  ``[out, in]``, so every kernel is transposed (``wqkv [D, 3D]`` stays fused
  in q|k|v order as ``qkv.weight [3D, D]``);
- each layer's ``norm1`` / ``norm2`` stay stacked ``[2, D]`` (row 0 scale,
  row 1 bias), as the fused layer kernel reads them;
- each stack's final LayerNorm is ``norm/{scale, bias}``.

``deepsvg_tpu/models/torch_import.py:state_dict_to_params`` spells out the
same name map in the other direction. Every leaf of the tree is used exactly
once: a leaf the model lacks, or a parameter the tree lacks, raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .checkpoint import load_params
from .config import ModelConfig
from .model import SVGTransformer


def _flatten(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + "/")
        else:
            yield path, np.asarray(value)


def _name_map(model: SVGTransformer):
    """(flax leaf path, port parameter, transpose) for every parameter."""
    out = []

    def dense(path, linear):
        out.append((f"{path}/kernel", linear.weight, True))
        out.append((f"{path}/bias", linear.bias, False))

    def stack(path, module, decoder):
        for i, layer in enumerate(module.layers):
            lp = f"{path}/layer_{i}"
            out.extend([
                (f"{lp}/norm1", layer.norm1, False),
                (f"{lp}/wqkv", layer.qkv.weight, True),
                (f"{lp}/bqkv", layer.qkv.bias, False),
                (f"{lp}/wo", layer.out_proj.weight, True),
                (f"{lp}/bo", layer.out_proj.bias, False),
                (f"{lp}/norm2", layer.norm2, False),
                (f"{lp}/ff1_kernel", layer.ff1.weight, True),
                (f"{lp}/ff1_bias", layer.ff1.bias, False),
                (f"{lp}/ff2_kernel", layer.ff2.weight, True),
                (f"{lp}/ff2_bias", layer.ff2.bias, False),
            ])
            if decoder:
                out.append((f"{lp}/glob_kernel", layer.glob.weight, True))
                out.append((f"{lp}/glob_bias", layer.glob.bias, False))
        out.append((f"{path}/norm/scale", module.norm.weight, False))
        out.append((f"{path}/norm/bias", module.norm.bias, False))

    enc, dec = model.encoder, model.decoder
    emb = enc.embedding
    out.extend([
        ("encoder/embedding/command_embed", emb.command_embed, False),
        ("encoder/embedding/arg_embed", emb.arg_embed, False),
        ("encoder/embedding/embed_fcn_kernel", emb.embed_fcn.weight, True),
        ("encoder/embedding/embed_fcn_bias", emb.embed_fcn.bias, False),
        ("encoder/embedding/pos_embed", emb.pos_embed, False),
    ])
    stack("encoder/encoder", enc.encoder, decoder=False)
    out.append(("encoder/hierarchical_PE/pos_embed", enc.hierarchical_PE.pos_embed, False))
    stack("encoder/hierarchical_encoder", enc.hierarchical_encoder, decoder=False)
    if model.resnet is not None:
        for i, linear in enumerate(model.resnet.linears, start=1):
            dense(f"resnet/linear{i}", linear)
    dense("bottleneck/bottleneck", model.bottleneck.bottleneck)
    out.append(("decoder/hierarchical_embedding/PE/pos_embed",
                dec.hierarchical_embedding.PE.pos_embed, False))
    stack("decoder/hierarchical_decoder", dec.hierarchical_decoder, decoder=True)
    dense("decoder/hierarchical_fcn/visibility_fcn", dec.hierarchical_fcn.visibility_fcn)
    dense("decoder/hierarchical_fcn/z_fcn", dec.hierarchical_fcn.z_fcn)
    out.append(("decoder/embedding/PE/pos_embed", dec.embedding.PE.pos_embed, False))
    stack("decoder/decoder", dec.decoder, decoder=True)
    out.extend([
        ("decoder/fcn/command_kernel", dec.fcn.command_fcn.weight, True),
        ("decoder/fcn/command_bias", dec.fcn.command_fcn.bias, False),
        ("decoder/fcn/args_kernel", dec.fcn.args_fcn.weight, True),
        ("decoder/fcn/args_bias", dec.fcn.args_fcn.bias, False),
    ])
    return out


@torch.no_grad()
def load_flax_params(model: SVGTransformer, tree: dict) -> int:
    """Copy the flax parameter ``tree`` (nested dicts of numpy arrays) into
    ``model`` and re-pack its heads. Returns the number of leaves used."""
    leaves = dict(_flatten(tree))
    names = _name_map(model)
    wanted = {path for path, _, _ in names}
    missing = sorted(wanted - set(leaves))
    extra = sorted(set(leaves) - wanted)
    if missing or extra:
        raise ValueError(f"parameter tree does not fit the model: missing {missing}, "
                         f"unused {extra}")
    for path, param, transpose in names:
        value = leaves[path].T if transpose else leaves[path]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {value.shape} (after transpose: "
                             f"{transpose}) does not fit {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return len(names)


def to_flax_params(model: SVGTransformer, grads: bool = False) -> dict:
    """The inverse of :func:`load_flax_params`: the model's parameters (or,
    with ``grads``, their gradients) as the flax tree of float32 numpy arrays,
    so that parameters and gradients compare leaf by leaf with the JAX
    package's. A parameter without a gradient gives zeros."""
    tree: dict = {}
    for path, param, transpose in _name_map(model):
        value = param.grad if grads else param
        value = (torch.zeros_like(param) if value is None else value.detach()).float().cpu().numpy()
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(value.T if transpose else value)
    return tree


def load_model(path: str, cfg: ModelConfig, device=None) -> SVGTransformer:
    """Build ``SVGTransformer(cfg)``, load the weights file that
    ``deepsvg_tpu/training/checkpoint.py:save_model`` writes, and place the
    model on ``device``, in eval mode. The parameters stay float32;
    ``cfg.compute_dtype`` is applied where they are used. ``device=None``
    means the CUDA card and raises when PyTorch sees none, instead of carrying
    on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        device = "cuda"
    model = SVGTransformer(cfg)
    load_flax_params(model, load_params(path))
    return model.to(device=device).eval()
