"""Point-set helpers in torch (counterpart of ``deepsvg_tpu/difflib/utils.py``).

Every function takes points ``[..., n, 2]`` over any leading batch dims and
is differentiable; ``make_clockwise`` selects with ``torch.where``, without
Python branching, so one call orients a whole batch.
"""
from __future__ import annotations

import torch


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, computed as the JAX package's
    ``jnp.linalg.norm`` is (the square root of the sum of squares): its
    gradient at an exact zero vector is NaN there too, where
    ``torch.linalg.vector_norm`` would give 0."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def is_clockwise(p: torch.Tensor) -> torch.Tensor:
    """Signed-area orientation test over consecutive point pairs:
    ``sum_i det([p_i, p_{i+1}]) > 0``. The SVG y-axis points down, so
    "clockwise" is the screen-space convention."""
    start, end = p[..., :-1, :], p[..., 1:, :]
    det = start[..., 0] * end[..., 1] - start[..., 1] * end[..., 0]
    return torch.sum(det, dim=-1) > 0


def make_clockwise(p: torch.Tensor) -> torch.Tensor:
    """Flip the point order of each contour that is not clockwise."""
    return torch.where(is_clockwise(p)[..., None, None], p, torch.flip(p, dims=(-2,)))


def reorder(p: torch.Tensor, i) -> torch.Tensor:
    """Cyclic shift ``[p_i, ..., p_{n-1}, p_0, ..., p_{i-1}]``; ``i`` an int
    or a tensor over the leading dims (the shift as a gather at
    ``(arange + i) % n``)."""
    n = p.shape[-2]
    i = torch.as_tensor(i, device=p.device).long()
    idx = (torch.arange(n, device=p.device) + i[..., None]) % n
    idx = idx.reshape((1,) * (p.dim() - 1 - idx.dim()) + idx.shape)
    return torch.take_along_dim(p, idx[..., None], dim=-2)


def get_length(p: torch.Tensor) -> torch.Tensor:
    """Total polyline length ``[..., n, 2] -> [...]``."""
    return torch.sum(_norm(p[..., 1:, :] - p[..., :-1, :]), dim=-1)
