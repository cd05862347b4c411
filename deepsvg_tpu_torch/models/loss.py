"""Training loss, counterpart of ``deepsvg_tpu/models/loss.py``.

Masked means over fixed-shape tensors: the visibility cross-entropy (a plain
mean over all groups), the command cross-entropy under the extended padding
mask times visibility, and the argument cross-entropy under
``CMD_ARGS_MASK`` of the target command; the last two are global masked means
with ``max(denominator, 1)``. All in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..svgtensor import masks as M
from .config import ModelConfig


def svg_loss(output: dict, weights: dict, cfg: ModelConfig) -> dict:
    """Weighted sum of visibility, command and argument cross-entropies.

    ``output``: the dict of ``SVGTransformer.forward(..., return_tgt=True)``
    (``args_ce`` from the fused head, or ``args_logits``); ``weights``: the
    per-step loss weights ``loss_visibility_weight``, ``loss_cmd_weight``,
    ``loss_args_weight``. Returns ``loss`` and each term.
    """
    if cfg.use_vae:
        raise NotImplementedError(
            "the KL term of the VAE bottleneck is not ported yet (ROADMAP.md, queue 1, "
            "item 8 'Model variants')")
    res = {}
    loss = 0.0
    tgt_commands, tgt_args = output["tgt_commands"], output["tgt_args"]
    vis = M.visibility_mask(tgt_commands)                                 # [N, G]
    pad = M.padding_mask(tgt_commands, extended=True) * vis[..., None].to(torch.float32)

    if cfg.decode_stages == 2:
        loss_visibility = F.cross_entropy(
            output["visibility_logits"].reshape(-1, 2).float(), vis.reshape(-1).long())
        loss = loss + weights["loss_visibility_weight"] * loss_visibility
        res["loss_visibility"] = loss_visibility

    # drop the SOS position: the logits predict positions 1..S
    tgt_c = tgt_commands[..., 1:].long()
    tgt_a = tgt_args[..., 1:, :]
    pad = pad[..., 1:]
    args_mask = M.cmd_args_mask(tgt_c.device)[tgt_c]                   # [N, G, S, n_args]

    cmd_logits = output["command_logits"].float()
    ce_cmd = F.cross_entropy(cmd_logits.reshape(-1, cmd_logits.shape[-1]),
                             tgt_c.reshape(-1), reduction="none").reshape(tgt_c.shape)
    loss_cmd = (ce_cmd * pad).sum() / pad.sum().clamp_min(1.0)

    if "args_ce" in output:
        ce_args = output["args_ce"].float()
    else:
        logits = output["args_logits"].float()
        ce_args = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  (tgt_a + 1).long().reshape(-1),   # PAD -1 -> class 0
                                  reduction="none").reshape(tgt_a.shape)
    loss_args = (ce_args * args_mask).sum() / args_mask.sum().clamp_min(1.0)

    loss = loss + weights["loss_cmd_weight"] * loss_cmd + weights["loss_args_weight"] * loss_args
    res.update({"loss": loss, "loss_cmd": loss_cmd, "loss_args": loss_args})
    return res
