"""Ahead-of-time export of the inference graphs for serving, counterpart of
``deepsvg_tpu/serving.py``.

The JAX package serializes its jitted encode and decode with ``jax.export``:
the weights baked in as constants, the Pallas kernels inside as custom
calls, so that a serving process calls them with no model code on its
import path. Here each function is traced by ``torch.export`` into an
``ExportedProgram`` and saved with ``torch.export.save``. The inference
kernels are ``torch.library`` operators (``deepsvg::embedding``, ``layer``,
``layer_f32``, ``layer_long``, ``head_argmax``, ``decode_step``), so the
graph holds them as calls: on the card each one launches its kernel (and
counts the launch), on the CPU it runs its plain version. The weights enter
the graph as its constants, in the types the kernels read (rounded to
``compute_dtype``, the argument tables folded, the heads packed): the
function runs once before it is traced, and the copies that run makes are
what the trace finds (``models/cast.py``). The model is held outside the
traced module, so its float32 masters are not saved.

Usage::

    from deepsvg_tpu_torch.serving import export_session, load_session_exports

    paths = export_session(model, out_dir, batch_sizes=(1, 64))
    fns = load_session_exports(out_dir)           # in the serving process
    z = fns["encode"][64](commands, args)          # fixed-batch entries
    cmds, args_out = fns["decode"][64](z)

Shapes are exported per batch size; :func:`serve_batch` routes any batch to
the smallest bucket that holds it. An artifact runs on the device it was
exported on: the card, unless the model was on the CPU. The autoregressive
decode is unrolled over its ``max_total_len`` steps.

Artifact layout: ``<out_dir>/manifest.json`` plus one ``.pt2`` file per
(function, batch-size) pair. Loading imports ``torch`` and the operators'
modules (``deepsvg_tpu_torch.ops``), nothing of the models, the configs or
the checkpoint readers.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import torch
from torch import nn

# the deepsvg:: operators the exported graphs call
from .ops import decode as _decode_ops  # noqa: F401
from .ops import embedding as _embedding_ops  # noqa: F401
from .ops import head as _head_ops  # noqa: F401
from .ops import layer as _layer_ops  # noqa: F401

_MANIFEST = "manifest.json"


def pad_spec(with_label: bool) -> dict:
    """Each entry's pad fill, one per operand in order (the wire contract of
    ``data/loader.py``'s ``decompress_batch``): commands pad with EOS 4,
    quantized args with -1, labels and latents with 0."""
    return {"encode": [4, -1.0] + ([0] if with_label else []),
            "decode": [0.0] + ([0] if with_label else [])}


class _Traced(nn.Module):
    """One served function as the module ``torch.export`` traces. The
    function closes over the model, which is no submodule: every tensor of
    the model that the function reads is a constant of the graph."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *operands):
        return self.fn(*operands)


def _encode_fn(model, with_label: bool):
    if with_label:
        def encode(commands, args, label):
            return model.encode(commands, args, label)[0]
    else:
        def encode(commands, args):
            return model.encode(commands, args)[0]
    return encode


def _decode_fn(model, with_label: bool):
    from .models.sample import greedy_sample

    if with_label:
        def decode(z, label):
            return greedy_sample(model, z=z, label=label)
    else:
        def decode(z):
            return greedy_sample(model, z=z)
    return decode


def export_session(model, out_dir: str, batch_sizes: Sequence[int] = (1, 64),
                   with_label: bool | None = None) -> dict:
    """Export encode and decode at each batch size; returns ``{name: {B:
    path}}``. The weights are the model's own; the artifacts run on the
    model's device.

    ``with_label``: include a label operand (defaults to the model config's
    ``label_condition``). A VAE model is refused, as the JAX package's
    export fails on it."""
    cfg = model.cfg
    if cfg.use_vae:
        raise ValueError(
            "a VAE model cannot be exported: its encode samples the latent "
            "(sample_vae=True) and the served function is given no random stream; the "
            "JAX package's export_session fails on it with flax's InvalidRngError "
            "('needs PRNG for \"vae\"')")
    if cfg.encode_stages == 0:
        raise ValueError("the decode-only model (encode_stages=0) has no encoder to export")
    if with_label is None:
        with_label = bool(cfg.label_condition)
    device = next(model.parameters()).device
    os.makedirs(out_dir, exist_ok=True)
    fills = pad_spec(with_label)

    def operands(name, b):
        # canonical input dtypes (data/loader.py decompress_batch): int32
        # commands, float32 quantized args, int32 labels, float32 latents.
        # One-stage encoders take the packed flat sequence [B, 1, T+2]
        # (model_args "commands_grouped"), not [G, S] tensors.
        if name == "encode":
            shape = ((b, 1, cfg.max_total_len + 2) if cfg.encode_stages <= 1
                     else (b, cfg.max_num_groups, cfg.max_seq_len + 2))
            specs = [(shape, torch.int32), (shape + (cfg.n_args,), torch.float32)]
        else:
            specs = [((b, cfg.dim_z), torch.float32)]
        if with_label:
            specs.append(((b,), torch.int32))
        return tuple(torch.full(shape, fill, dtype=dt, device=device)
                     for (shape, dt), fill in zip(specs, fills[name]))

    fns = {"encode": _encode_fn(model, with_label), "decode": _decode_fn(model, with_label)}
    manifest = {"batch_sizes": list(map(int, batch_sizes)), "with_label": with_label,
                "pad": fills, "entries": {}}
    paths: dict = {}
    with torch.no_grad():
        for name, fn in fns.items():
            paths[name] = {}
            fn(*operands(name, 1))      # makes the weight copies the trace reads
            for b in batch_sizes:
                program = torch.export.export(_Traced(fn), operands(name, int(b)),
                                              strict=False)
                fname = f"{name}_b{int(b)}.pt2"
                torch.export.save(program, os.path.join(out_dir, fname))
                manifest["entries"][f"{name}:{int(b)}"] = fname
                paths[name][int(b)] = os.path.join(out_dir, fname)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return paths


class _Served:
    """A loaded entry: the exported program, called on its operands moved
    to the device it was exported on (numpy arrays are taken as they are)."""

    def __init__(self, program):
        self.module = program.module()
        user = set(program.graph_signature.user_inputs)
        self.device = next(n.meta["val"].device for n in program.graph.nodes
                           if n.op == "placeholder" and n.name in user)

    def __call__(self, *operands):
        return self.module(*(torch.as_tensor(x).to(self.device) for x in operands))


def load_session_exports(out_dir: str) -> dict:
    """Load every exported entry: ``{name: {batch_size: callable}}``, and
    ``"__pad__"``, the entries' pad fills for :func:`serve_batch`.

    Needs only ``torch`` and the operators' modules on the serving host: no
    model code, no checkpoint. Entry signatures are exact per bucket; use
    :func:`serve_batch` to route any batch size. Decode takes float32
    latents (cast a bfloat16 encode output with ``z.float()``)."""
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    out: dict = {}
    for key, fname in manifest["entries"].items():
        name, b = key.split(":")
        out.setdefault(name, {})[int(b)] = _Served(
            torch.export.load(os.path.join(out_dir, fname)))
    # a manifest written before the pad fills were: the encode/decode
    # contract, the only entries ever exported then
    pad = manifest.get("pad")
    if pad is None:
        pad = pad_spec(bool(manifest.get("with_label")))
    out["__pad__"] = pad
    return out


def serve_batch(fns: dict, name: str, *args):
    """Bucket-routed call: pad a batch of any size up to the largest bucket
    to the smallest exported bucket that holds it, call, and cut the outputs
    back to the batch.

    ``fns`` is :func:`load_session_exports`'s result; ``name`` the entry
    ("encode"/"decode"); ``args`` its operands with a common leading batch
    dimension. The pad fills are those the export wrote into the manifest
    (commands EOS 4, args -1, labels and latents 0)."""
    entries = fns[name]
    n = int(args[0].shape[0])
    buckets = sorted(entries)
    fit = [b for b in buckets if b >= n]
    if not fit:
        raise ValueError(
            f"batch {n} exceeds the largest exported bucket {buckets[-1]} "
            f"for {name!r}; export a bigger bucket or split the batch")
    b = fit[0]
    fills = fns.get("__pad__", {}).get(name)
    if fills is None or len(fills) != len(args):
        raise ValueError(
            f"no pad spec for entry {name!r} with {len(args)} operands "
            f"(manifest pad: {fns.get('__pad__')}); re-export with "
            "export_session or pass operands matching the export signature")

    def pad(x, fill):
        x = torch.as_tensor(x)
        if x.shape[0] == b:
            return x
        rows = torch.full((b - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, rows])

    out = entries[b](*(pad(a, f) for a, f in zip(args, fills)))

    def unpad(y):
        return y[:n] if isinstance(y, torch.Tensor) and y.dim() and y.shape[0] == b else y

    if isinstance(out, (tuple, list)):
        return type(out)(unpad(y) for y in out)
    return unpad(out)


def main(argv=None):
    """CLI: export a trained config and checkpoint to a serving directory."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config-module", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="a .pth.tar (reference), the msgpack parameters or a checkpoint "
                         "of the port")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--batch-sizes", default="1,64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu: the device the "
                         "artifacts run on")
    args = ap.parse_args(argv)

    from .inference import load_session

    session = load_session(args.config_module, args.checkpoint, device=args.device)
    sizes = tuple(int(s) for s in args.batch_sizes.split(","))
    paths = export_session(session.model, args.out_dir, batch_sizes=sizes)
    n = sum(len(v) for v in paths.values())
    print(f"exported {n} entries to {args.out_dir}")


if __name__ == "__main__":
    main()
