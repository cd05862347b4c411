"""Differentiable geometry losses in torch, batched over any leading dims
(counterpart of ``deepsvg_tpu/difflib/loss.py``).

The EMD loss evaluates every cyclic shift at once as one gather and one
norm, and takes the best shift per contour with a gather, so a batch of
contours is a few tensor operations, not a loop.
"""
from __future__ import annotations

import torch

from .sample import get_length_distribution, nearest_fractions
from .utils import _norm, get_length, make_clockwise


def cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances ``[..., n, d] x [..., m, d] -> [..., n, m]``."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    return torch.sqrt(torch.maximum(torch.sum(diff * diff, dim=-1), diff.new_tensor(1e-12)))


def chamfer_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Symmetric Chamfer distance (``amin`` splits a tie's gradient as
    JAX's ``min`` does)."""
    d = cdist(x, y)
    return torch.mean(torch.amin(d, dim=-2), dim=-1) + torch.mean(torch.amin(d, dim=-1), dim=-1)


def continuity_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean consecutive-point distance."""
    return torch.mean(_norm(x[..., 1:, :] - x[..., :-1, :]), dim=-1)


def svg_length_loss(p_pred: torch.Tensor, p_target: torch.Tensor) -> torch.Tensor:
    """Relative length error."""
    pred_len, tgt_len = get_length(p_pred), get_length(p_target)
    return torch.abs(tgt_len - pred_len) / torch.maximum(tgt_len, tgt_len.new_tensor(1e-12))


def svg_emd_loss(p_pred: torch.Tensor, p_target: torch.Tensor, first_point_weight: bool = False,
                 return_matching: bool = False):
    """Earth-mover-style loss between closed contours ``p_pred [..., n, 2]``
    and ``p_target [..., m, 2]`` (leading dims broadcast):

      1. orient the target clockwise,
      2. resample it at the pred's uniform arc-length fractions,
      3. find the cyclic shift of it that minimizes the mean pointwise
         distance (all ``n`` shifts at once),
      4. the mean pointwise distance under that shift.

    Returns the loss ``[...]`` and, with ``return_matching``, ``(p_pred,
    p_target, matching)`` with the matching rolled by the best shift.
    """
    n = p_pred.shape[-2]
    lead = torch.broadcast_shapes(p_pred.shape[:-2], p_target.shape[:-2])
    p_pred = p_pred.expand(lead + p_pred.shape[-2:])
    p_target = make_clockwise(p_target.expand(lead + p_target.shape[-2:]))

    matching = nearest_fractions(get_length_distribution(p_target, normalize=True), n)
    p_target_sub = torch.take_along_dim(p_target, matching[..., None], dim=-2)  # [..., n, 2]

    # every cyclic shift at once: shifted[..., i, j] = p_target_sub[..., (i + j) % n]
    ar = torch.arange(n, device=p_pred.device)
    idx = (ar[:, None] + ar[None, :]) % n
    shifted = p_target_sub[..., idx, :]                              # [..., n, n, 2]
    dists = _norm(p_pred[..., None, :, :] - shifted)                 # [..., shift, point]
    best = torch.argmin(torch.mean(dists, dim=-1), dim=-1)           # [...]

    losses = torch.take_along_dim(dists, best[..., None, None], dim=-2)[..., 0, :]
    if first_point_weight:
        weights = torch.ones_like(losses)
        weights[..., 0] = 10.0
        losses = losses * weights

    if return_matching:
        rolled = torch.take_along_dim(matching, (ar + best[..., None]) % n, dim=-1)
        return torch.mean(losses, dim=-1), (p_pred, p_target, rolled)
    return torch.mean(losses, dim=-1)
