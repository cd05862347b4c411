"""Point-set visualization helpers (reference: difflib/utils.py:12-49).

Matplotlib-based; headless-safe (Agg figures, PIL output).
"""
from __future__ import annotations

import io
from typing import Optional

import numpy as np


def _figure(viewbox=None):
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=(4, 4), dpi=100)
    FigureCanvasAgg(fig)
    ax = fig.add_subplot(111)
    ax.set_aspect("equal")
    ax.invert_yaxis()
    ax.axis("off")
    if viewbox is not None:
        ax.set_xlim(0, viewbox[0])
        ax.set_ylim(viewbox[1], 0)
    return fig, ax


def _to_image(fig):
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    buf.seek(0)
    return Image.open(buf).convert("RGB")


def plot_points(p, viewbox=None, show_color=False, image_file: Optional[str] = None,
                return_img: bool = False):
    """Scatter a point sequence, optionally color-graded by order
    (reference difflib/utils.py:12-34)."""
    p = np.asarray(p)
    fig, ax = _figure(viewbox)
    kwargs = {"c": range(len(p)), "cmap": "RdYlBu"} if show_color else {}
    ax.scatter(p[:, 0], p[:, 1], **kwargs)
    if image_file is not None:
        fig.savefig(image_file, bbox_inches="tight")
    if return_img:
        return _to_image(fig)


def plot_matching(p1, p2, matching, viewbox=None, return_img: bool = False):
    """Two point sets + every 10th correspondence line
    (reference difflib/utils.py:37-49)."""
    p1, p2, matching = np.asarray(p1), np.asarray(p2), np.asarray(matching)
    fig, ax = _figure(viewbox)
    ax.scatter(p1[:, 0], p1[:, 1], color="C0")
    ax.scatter(p2[:, 0], p2[:, 1], color="C1")
    for start, end in zip(p1[::10], p2[matching][::10]):
        ax.plot([start[0], end[0]], [start[1], end[1]], color="C2")
    if return_img:
        return _to_image(fig)
