"""High-level inference API: encode / decode / interpolate / font sampling,
counterpart of ``deepsvg_tpu/inference.py``.

A session holds a model on its device (the CUDA card, or the CPU when the
caller asks for it) and decodes every frame of an interpolation or a class
sample in one batched call of ``models/sample.py:greedy_sample``, which on
the card runs kernels K1, K2 and K3.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .difflib.sample import unit_linspace
from .models.model import SVGTransformer
from .models.sample import flatten_groups_np, greedy_sample
from .svglib.geom import Bbox
from .svglib.svg import SVG
from .svgtensor.tensor import cmd_args_to_data14


def easein_easeout(t):
    """Smooth-step easing."""
    return t * t / (2.0 * (t * t - t) + 1.0)


class InferenceSession:
    """A loaded model + (optional) dataset, exposing the user-facing ops.

    Args:
        model: the port's ``SVGTransformer`` (its float32 parameters on the
            session's device; ``cfg.compute_dtype`` applies where used).
        dataset: optional dataset (provides ``get`` for svg -> model-args
            packing); ``encode_svg`` builds a bare packer without one.
        cfg: training config (for ``model_args``); falls back to the model
            config's ``get_model_args``.
    """

    def __init__(self, model: SVGTransformer, dataset=None, cfg=None):
        self.model = model.eval()
        self.dataset = dataset
        self.model_args = (
            cfg.model_args if cfg is not None else model.cfg.get_model_args()
        )

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _check_tokens(self, name: str, v: np.ndarray):
        """Integer inputs outside the embedding tables are refused on the
        host, with the JAX package's message."""
        cfg = self.model.cfg
        if name.startswith("commands"):
            lo, hi = 0, cfg.n_commands - 1
        elif name.startswith("args"):
            lo, hi = -1, cfg.args_dim - 1  # PAD_VAL .. quantization grid max
        else:
            return
        if not v.size:
            return
        mn, mx = int(v.min()), int(v.max())
        if mn < lo or mx > hi:
            raise ValueError(
                f"{name} contains values outside [{lo}, {hi}] "
                f"(got min {mn}, max {mx}); out-of-range tokens would "
                f"produce silent NaN on TPU")

    def _check_label(self, label):
        if label is None:
            return
        v = np.asarray(label.cpu() if torch.is_tensor(label) else label)
        if v.size and (int(v.min()) < 0
                       or int(v.max()) >= self.model.cfg.n_labels):
            raise ValueError(
                f"label out of range [0, {self.model.cfg.n_labels - 1}] "
                f"(got min {int(v.min())}, max {int(v.max())}); "
                f"out-of-range labels would produce silent NaN on TPU")

    def _label(self, label):
        if label is None:
            return None
        return torch.as_tensor(np.asarray(label.cpu() if torch.is_tensor(label) else label),
                               dtype=torch.int64, device=self.device)

    # --- encode ----------------------------------------------------------
    @torch.no_grad()
    def encode(self, batch: dict) -> torch.Tensor:
        """Packed model-args dict (unbatched or batched) -> latent ``[N, dz]``
        on the session's device, the VAE's mean for a VAE model.

        Label-conditioned models (fonts) read the class from ``batch
        ["label"]``, which they require."""
        args = []
        for k in self.model_args[:2]:
            v = batch[k]
            v = np.asarray(v.cpu() if torch.is_tensor(v) else v)
            # add the batch axis if the dict holds a single unbatched item:
            # commands come as [G, S] (-> [1, G, S]), args as [G, S, 11]
            unbatched_ndim = 3 if k.startswith("args") else 2
            if v.ndim == unbatched_ndim:
                v = v[None]
            self._check_tokens(k, v)
            dtype = torch.float32 if k.startswith("args") else torch.int32
            args.append(torch.as_tensor(v, dtype=dtype, device=self.device))
        label = None
        if "label" in self.model_args:
            if "label" not in batch:
                raise ValueError(
                    "this model is label-conditioned: encode() needs "
                    "batch['label'] (class ids)")
            lab = np.atleast_1d(np.asarray(batch["label"]))
            self._check_label(lab)
            label = self._label(lab)
        z, _, _ = self.model.encode(*args, label, sample_vae=False)
        return z

    def encode_svg(self, svg: SVG) -> torch.Tensor:
        """SVG document -> latent.

        Without an attached dataset a bare packer is built from the model
        config (the dataset is only needed here for its tensor packing, not
        its files), and attached to the session."""
        if self.dataset is None:
            from .data.dataset import MetaTable, SVGDataset

            mcfg = self.model.cfg
            self.dataset = SVGDataset(
                ".", None, self.model_args, mcfg.max_num_groups,
                mcfg.max_seq_len, df=MetaTable(),
            )
        data = self.dataset.get(model_args=self.model_args, svg=svg)
        return self.encode(data)

    def encode_icon(self, idx=None, id=None) -> torch.Tensor:
        data = self.dataset.get(idx=idx or 0, id=id, model_args=self.model_args,
                                random_aug=False)
        return self.encode(data)

    # --- decode ----------------------------------------------------------
    def decode_ids(self, z, label=None):
        """Latents ``[N, dz]`` -> the greedy decode's ``(commands, args)``
        on the session's device."""
        z = torch.as_tensor(z, dtype=torch.float32).to(self.device)
        if z.ndim == 1:
            z = z[None]
        self._check_label(label)
        return greedy_sample(self.model, z=z, label=self._label(label))

    def decode(self, z, label=None, viewbox: int = 256,
               normalize: bool = True, colored: bool = False) -> List[SVG]:
        """Latents ``[N, dz]`` -> list of SVG documents (one batched forward).
        A decode that does not make an SVG gives an empty document."""
        commands_y, args_y = self.decode_ids(z, label)
        out = []
        for c, a in flatten_groups_np(commands_y, args_y):
            data14 = cmd_args_to_data14(c, a)
            try:
                svg = SVG.from_tensor(data14, viewbox=Bbox(viewbox), allow_empty=True)
                if normalize:
                    svg = svg.normalize()
                if colored:
                    svg = svg.split_paths().set_color("random")
            except Exception:
                svg = SVG([], viewbox=Bbox(viewbox))
            out.append(svg)
        return out

    def decode_one(self, z, **kwargs) -> SVG:
        return self.decode(z, **kwargs)[0]

    # --- latent ops ------------------------------------------------------
    def interpolation_latents(self, z1, z2, n: int = 10, ease: bool = True,
                              include_endpoints: bool = False) -> torch.Tensor:
        """The ``n`` latents between ``z1`` and ``z2`` (with the endpoints,
        ``n + 2``), at the fractions ``jnp.linspace`` gives."""
        z1, z2 = z1.reshape(1, -1), z2.reshape(1, -1)
        alphas = unit_linspace(n + 2, device=z1.device)
        if not include_endpoints:
            alphas = alphas[1:-1]
        if ease:
            alphas = easein_easeout(alphas)
        return (1 - alphas[:, None]) * z1 + alphas[:, None] * z2

    def interpolate(self, z1, z2, n: int = 10, ease: bool = True,
                    include_endpoints: bool = False, label=None) -> List[SVG]:
        """Linear latent interpolation, decoded as ONE batch."""
        zs = self.interpolation_latents(z1, z2, n, ease, include_endpoints)
        if label is not None:
            label = np.broadcast_to(np.asarray(label).reshape(1), (zs.shape[0],))
        return self.decode(zs, label=label)

    def interpolate_svg(self, svg1: SVG, svg2: SVG, n: int = 10, ease: bool = True) -> List[SVG]:
        return self.interpolate(self.encode_svg(svg1), self.encode_svg(svg2), n=n, ease=ease)

    def latent_direction(self, svgs_from: Sequence[SVG], svgs_to: Sequence[SVG]) -> torch.Tensor:
        """Mean latent difference: the 'latent arithmetic direction' (e.g.
        path removal, squarify)."""
        z_from = torch.cat([self.encode_svg(s) for s in svgs_from]).mean(0)
        z_to = torch.cat([self.encode_svg(s) for s in svgs_to]).mean(0)
        return z_to - z_from

    def apply_direction(self, z, direction, amounts: Sequence[float], label=None) -> List[SVG]:
        zs = torch.stack([z.reshape(-1) + a * direction for a in amounts])
        return self.decode(zs, label=label)

    # --- font sampling ---------------------------------------------------
    def _prior(self, n: int, scale: float, generator: Optional[torch.Generator]):
        """``n`` latents from the prior, drawn on the CPU from ``generator``
        (one seeded with 0 when None), then moved to the device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return scale * torch.randn((n, self.model.cfg.dim_z), generator=generator)

    def sample_class(self, label: int, n: int = 1, scale: float = 1.0,
                     generator: Optional[torch.Generator] = None) -> List[SVG]:
        """Label-conditioned glyph sampling: decode latents drawn from the
        prior. The draws are PyTorch's, not the JAX package's."""
        return self.decode(self._prior(n, scale, generator), label=np.full((n,), label))

    def random_sample(self, n: int = 1, scale: float = 1.0,
                      generator: Optional[torch.Generator] = None) -> List[SVG]:
        return self.decode(self._prior(n, scale, generator))


_MSGPACK_MAP_HEADS = set(range(0x80, 0x90)) | {0xDE, 0xDF}


def _checkpoint_format(path: str) -> str:
    """``"torch"`` (a ``.pth.tar`` / ``.pth`` / ``.pt`` file), ``"train"``
    (the port's training checkpoint, magic ``DSVGCKPT2``) or ``"msgpack"``
    (flax weights); any other file raises a ``ValueError`` naming what it
    holds."""
    from .training.checkpoint import _CKPT_MAGIC

    if path.endswith((".pth.tar", ".pth", ".pt")):
        return "torch"
    with open(path, "rb") as f:
        head = f.read(len(_CKPT_MAGIC))
    if head == _CKPT_MAGIC:
        return "train"
    if head[:1] and head[0] in _MSGPACK_MAP_HEADS:
        return "msgpack"
    if head[:4] == b"PK\x03\x04":
        kind = ("a zip archive (the JAX package's version-1 training checkpoint, or a "
                "torch.save file without a .pt/.pth/.pth.tar name)")
    elif not head:
        kind = "an empty file"
    else:
        kind = f"an unknown format (first bytes {head[:8]!r})"
    raise ValueError(f"{path} is {kind}; load_session reads flax msgpack weights, the port's "
                     "training checkpoints (DSVGCKPT2) and .pth.tar/.pth/.pt files")


def load_session(config_module: str, checkpoint_path: str, dataset=None,
                 device=None) -> InferenceSession:
    """Build a session from a config module of the port (e.g.
    ``deepsvg_tpu_torch.configs.hierarchical_ordered``) and a weights file:
    flax msgpack weights (``training/checkpoint.py:save_model``, or the JAX
    package's), a training checkpoint of the port, or a reference PyTorch
    ``.pth.tar`` / ``.pth`` / ``.pt``. The model is placed on ``device``,
    the CUDA card when None (raises without one)."""
    from .models.torch_import import load_torch_checkpoint
    from .models.weights import load_flax_params
    from .training.checkpoint import load_ckpt, load_model
    from .training.config import load_config
    from .training.trainer import create_train_state

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        device = "cuda"
    cfg = load_config(config_module, 1)
    model = cfg.make_model()
    kind = _checkpoint_format(checkpoint_path)
    if kind == "torch":
        load_flax_params(model, load_torch_checkpoint(checkpoint_path, model.cfg))
    elif kind == "train":
        state = create_train_state(model, cfg.make_optimizer(1), init=False)
        state, found = load_ckpt(checkpoint_path, state)
        assert found, checkpoint_path
    else:
        load_model(checkpoint_path, model)
    return InferenceSession(model.to(device), dataset=dataset, cfg=cfg)
