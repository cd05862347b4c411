"""Differentiable SVG geometry in torch: Bézier sampling, point-set losses."""
from .loss import cdist, chamfer_loss, continuity_loss, svg_emd_loss, svg_length_loss
from .sample import (
    command_positions,
    get_length_distribution,
    resample_uniform,
    sample_points,
    sample_points_padded,
    sample_uniform_points,
)
from .utils import get_length, is_clockwise, make_clockwise, reorder
from .viz import plot_matching, plot_points

__all__ = [
    "cdist", "chamfer_loss", "continuity_loss", "svg_emd_loss", "svg_length_loss",
    "command_positions", "get_length_distribution", "resample_uniform",
    "sample_points", "sample_points_padded", "sample_uniform_points",
    "get_length", "is_clockwise", "make_clockwise", "reorder",
    "plot_matching", "plot_points",
]
