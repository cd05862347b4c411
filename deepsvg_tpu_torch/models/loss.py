"""Training loss, counterpart of ``deepsvg_tpu/models/loss.py``.

Masked means over fixed-shape tensors: the VAE's KL term (clipped below at
``kl_tolerance``), the visibility cross-entropy (a plain mean over all
groups), the command cross-entropy under the extended padding
mask times visibility, and the argument cross-entropy under
``CMD_ARGS_MASK`` of the target command; the last two are global masked means
with ``max(denominator, 1)``. The cross-entropies are float32; the KL term
keeps the VAE's type, as in the JAX package.

Under data parallelism (``group``, a ``torch.distributed`` process group over
the data axis) the masked means are global, as the JAX package's
``axis_name``: the numerators and denominators are summed across the ranks
and the KL and visibility means averaged; each rank's gradient is that of its
own rows, and the ranks' gradients summed give the gradient of the whole
batch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..svgtensor import masks as M
from .config import ModelConfig


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for the decode-only model (``encode_stages=0``):
    the JAX package's training step encodes its inputs, and that model has no
    encoder, so it cannot be trained there; the port does not train it
    either."""
    if cfg.encode_stages == 0:
        raise ValueError("the decode-only model (encode_stages=0) cannot be trained: the "
                         "training step encodes its inputs and the model has no encoder "
                         "(the JAX package's step fails on it too)")


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed across the ranks of ``group`` (the JAX package's
    ``psum``); its gradient is this rank's own, one for each of its terms.
    ``group`` None: ``x``."""
    if group is None:
        return x
    total = x.detach().clone()
    dist.all_reduce(total, group=group)
    return total + (x - x.detach())


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` averaged across the ranks of ``group`` (``pmean``), summed in
    float32 and returned in ``x``'s type."""
    if group is None:
        return x
    return (_sum(x.float(), group) / dist.get_world_size(group)).to(x.dtype)


def svg_loss(output: dict, weights: dict, cfg: ModelConfig, group=None) -> dict:
    """Weighted sum of the KL term (VAE models), visibility, command and
    argument cross-entropies.

    ``output``: the dict of ``SVGTransformer.forward(..., return_tgt=True)``
    (``args_ce`` from the fused head, or ``args_logits``); ``weights``: the
    per-step loss weights ``kl_tolerance`` and ``loss_kl_weight`` (VAE
    models), ``loss_visibility_weight``, ``loss_cmd_weight``,
    ``loss_args_weight``. Returns ``loss`` and each term. The decode-only
    model is refused: the JAX package cannot train it. ``group``: the data
    axis's process group, whose ranks each hold their rows of the batch.
    """
    check_trainable(cfg)
    res = {}
    loss = 0.0
    if cfg.use_vae:
        if output.get("mu") is None or output.get("logsigma") is None:
            raise ValueError("the VAE's KL term needs the forward's mu and logsigma "
                             "(SVGTransformer.forward with return_tgt=True)")
        mu, logsigma = output["mu"], output["logsigma"]
        # in the VAE's type, as the JAX package: the elementwise terms round to
        # it, the mean sums in float32 and rounds back, and so does the clip
        kl = 1 + logsigma - mu ** 2 - torch.exp(logsigma)
        loss_kl = -0.5 * _mean(kl.float().mean().to(kl.dtype), group)
        loss_kl = torch.clamp(loss_kl, min=weights["kl_tolerance"])
        loss = loss + weights["loss_kl_weight"] * loss_kl
        res["loss_kl"] = loss_kl
    tgt_commands, tgt_args = output["tgt_commands"], output["tgt_args"]
    vis = M.visibility_mask(tgt_commands)                                 # [N, G]
    pad = M.padding_mask(tgt_commands, extended=True) * vis[..., None].to(torch.float32)

    if cfg.decode_stages == 2:
        loss_visibility = _mean(F.cross_entropy(
            output["visibility_logits"].reshape(-1, 2).float(), vis.reshape(-1).long()), group)
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
    loss_cmd = _sum((ce_cmd * pad).sum(), group) / _sum(pad.sum(), group).clamp_min(1.0)

    if "args_ce" in output:
        ce_args = output["args_ce"].float()
    else:
        logits = output["args_logits"].float()
        ce_args = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  (tgt_a + 1).long().reshape(-1),   # PAD -1 -> class 0
                                  reduction="none").reshape(tgt_a.shape)
    loss_args = (_sum((ce_args * args_mask).sum(), group)
                 / _sum(args_mask.sum(), group).clamp_min(1.0))

    loss = loss + weights["loss_cmd_weight"] * loss_cmd + weights["loss_args_weight"] * loss_args
    res.update({"loss": loss, "loss_cmd": loss_cmd, "loss_args": loss_args})
    return res
