"""Differentiable point sampling of SVG tensors in torch, batched
(counterpart of ``deepsvg_tpu/difflib/sample.py``).

The core is fixed-shape over any leading batch dims: every command slot
yields ``n`` points and a validity flag, so a whole batch samples in a few
tensor operations on its device; the ragged reference-layout outputs
(:func:`sample_points`, :func:`sample_uniform_points`) are thin eager
wrappers for one sequence.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..svgtensor.constants import CMD_C, CMD_L, IndexArgs, N_COMMANDS
from .utils import _norm

# Monomial-basis coefficient matrices per command:
# coeffs = Q[cmd] @ [start, control1, control2, end]  (4 control rows, 2 cols)
_Q_NP = np.zeros((N_COMMANDS, 4, 4), dtype=np.float32)
_Q_NP[CMD_L] = np.array(
    [[1.0, 0, 0, 0], [-1.0, 0, 0, 1.0], [0, 0, 0, 0], [0, 0, 0, 0]], np.float32
)
_Q_NP[CMD_C] = np.array(
    [[1.0, 0, 0, 0], [-3.0, 3.0, 0, 0], [3.0, -6.0, 3.0, 0], [-1.0, 3.0, -3.0, 1.0]],
    np.float32,
)


@functools.lru_cache(maxsize=None)
def _q(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_Q_NP`` on ``device``, made once per device and type."""
    return torch.as_tensor(_Q_NP, dtype=dtype, device=device)


def unit_linspace(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``n`` fractions from 0 to 1 computed as ``jnp.linspace(0.0, 1.0, n)``
    computes them (``i / (n - 1)``, then exactly 1), so that a nearest-
    fraction ``argmin`` sees the same values in both packages;
    ``torch.linspace`` rounds some of them otherwise."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    head = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
    return torch.cat([head, torch.ones(1, dtype=dtype, device=device)])


def command_positions(commands: torch.Tensor, args: torch.Tensor) -> torch.Tensor:
    """The ``[..., S, 4, 2]`` control-point tensor (start, c1, c2, end).
    Start positions chain from the previous command's end position; the
    first start is (0, 0)."""
    del commands
    end_pos = args[..., IndexArgs.END_POS]
    start_pos = torch.cat([end_pos.new_zeros(end_pos.shape[:-2] + (1, 2)), end_pos[..., :-1, :]],
                          dim=-2)
    return torch.stack([start_pos, args[..., IndexArgs.CONTROL1], args[..., IndexArgs.CONTROL2],
                        end_pos], dim=-2)


def sample_points_padded(commands: torch.Tensor, args: torch.Tensor, n: int = 10):
    """Sample ``n`` points per command slot, fixed-shape. Only line and cubic
    commands produce valid samples (arcs are lowered to cubics by the SVG
    library).

    Returns ``points [..., S, n, 2]`` (Bézier samples at uniform t) and
    ``valid [..., S]`` bool.
    """
    commands = commands.long()
    pos = command_positions(commands, args)                        # [..., S, 4, 2]
    t = unit_linspace(n, args.dtype, args.device)
    t2 = t * t
    z = torch.stack([torch.ones_like(t), t, t2, t * t2], dim=1)    # [n, 4]
    coeffs = _q(args.device, args.dtype)[commands] @ pos           # [..., S, 4, 2]
    points = torch.einsum("nk,...kd->...nd", z, coeffs)            # [..., S, n, 2]
    valid = (commands == CMD_L) | (commands == CMD_C)
    return points, valid


def sample_points(commands: torch.Tensor, args: torch.Tensor, n: int = 10) -> torch.Tensor:
    """Reference-layout ragged sampling: keep the l/c commands and drop each
    segment's last point except the final one. Output ``[K*(n-1)+1, 2]``
    with K the number of l/c commands (a data-dependent shape: an eager API;
    :func:`sample_points_padded` is the fixed-shape one)."""
    points, valid = sample_points_padded(commands, args, n)
    points = points[valid]                                          # [K, n, 2]
    if points.shape[0] == 0:
        return args.new_zeros((0, 2))
    return torch.cat([points[:, :-1].reshape(-1, 2), points[-1, -1][None]], dim=0)


def get_length_distribution(p: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Cumulative arc length of a polyline ``[..., n, 2] -> [..., n]``: the
    running sum, then (``normalize``) divided by its last entry, in the JAX
    module's order."""
    distr = torch.cumsum(_norm(p[..., 1:, :] - p[..., :-1, :]), dim=-1)
    distr = torch.cat([distr.new_zeros(distr.shape[:-1] + (1,)), distr], dim=-1)
    if normalize:
        distr = distr / torch.maximum(distr[..., -1:], distr.new_tensor(1e-12))
    return distr


def sample_uniform_points(commands: torch.Tensor, args: torch.Tensor,
                          n: int = 100) -> torch.Tensor:
    """Arc-length-uniform resampling of :func:`sample_points`. Eager API."""
    return resample_uniform(sample_points(commands, args, n=n), n)


def nearest_fractions(distr: torch.Tensor, n: int) -> torch.Tensor:
    """For each of ``n`` uniform fractions, the index of the nearest entry of
    ``distr [..., m]`` (the first on a tie): ``[..., n]``."""
    u = unit_linspace(n, distr.dtype, distr.device)
    return torch.argmin(torch.abs(u[:, None] - distr[..., None, :]), dim=-1)


def resample_uniform(p: torch.Tensor, n: int) -> torch.Tensor:
    """Pick, for each of ``n`` uniform arc-length fractions, the nearest
    existing sample of ``p [..., m, 2]``: ``[..., n, 2]``."""
    matching = nearest_fractions(get_length_distribution(p, normalize=True), n)
    return torch.take_along_dim(p, matching[..., None], dim=-2)
