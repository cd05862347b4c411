"""Greedy one-shot sampling, counterpart of ``deepsvg_tpu/models/sample.py``.

One forward with the fused head+argmax (kernel K3 on the card), the
visibility threshold, and :func:`make_valid`. A VAE model samples its
latent from a fixed generator, as the JAX package does with ``key(0)``. Only
the greedy decode (``key=None`` on the JAX side) is ported; temperature
sampling and the autoregressive samplers come with the variants that need
them.
"""
from __future__ import annotations

import torch

from ..svgtensor.constants import CMD_EOS, CMD_M, PAD_VAL
from ..svgtensor.masks import cmd_args_mask
from .cast import DropoutRng
from .config import ModelConfig
from .model import SVGTransformer


def threshold_sample(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """P(class 1) > threshold."""
    return torch.softmax(logits.float(), dim=-1)[..., 1] > threshold


def make_valid(commands: torch.Tensor, args: torch.Tensor,
               visibility: torch.Tensor | None = None):
    """Set the arguments a command does not use to PAD; replace each
    invisible group by an empty path (a moveto, then EOS)."""
    if visibility is not None:
        s = commands.shape[-1]
        empty = torch.full((s,), CMD_EOS, dtype=commands.dtype, device=commands.device)
        empty[0] = CMD_M
        commands = torch.where(visibility[..., None], commands, empty)
        args = torch.where(visibility[..., None, None], args,
                           torch.full_like(args, float(PAD_VAL)))
    used = cmd_args_mask(commands.device, torch.bool)[commands.long()]
    return commands, torch.where(used, args, torch.full_like(args, float(PAD_VAL)))


def _finalize_args(cfg: ModelConfig, commands, args):
    """Undo the relative argument encoding, which only the autoregressive
    variants use."""
    if cfg.rel_targets:
        raise NotImplementedError(
            "relative targets are not ported yet (ROADMAP.md, queue 1, item 8)")
    return commands, args


@torch.no_grad()
def one_shot_sample(model: SVGTransformer, commands_enc=None, args_enc=None,
                    z=None, visibility_threshold: float = 0.7):
    """Greedy one-shot decode of ``commands_enc [N, G, S]`` /
    ``args_enc [N, G, S, n_args]`` (or of a given latent ``z [N, dim_z]``).

    Returns ``commands [N, G, S_dec]`` int32 and ``args [N, G, S_dec, n_args]``
    float32 with PAD -1, on the model's device.
    """
    # a VAE samples its latent from a fixed generator (the JAX package's key(0))
    rng = DropoutRng.fixed() if model.cfg.use_vae and z is None else None
    res = model(commands_enc, args_enc, z=z, argmax_head=True, rng=rng)
    commands_y = res["command_ids"]
    args_y = (res["args_ids"] - 1).to(torch.float32)    # undo the PAD shift
    visibility_y = threshold_sample(res["visibility_logits"], visibility_threshold)
    commands_y, args_y = make_valid(commands_y, args_y, visibility_y)
    return _finalize_args(model.cfg, commands_y, args_y)
