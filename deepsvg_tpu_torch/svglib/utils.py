"""Visualization helpers: grid composition of SVGs, GIF writer
(reference: svglib/utils.py)."""
from __future__ import annotations

import math
from typing import List

from .geom import Bbox, Point
from .svg import SVG

COLORS = [
    "aliceblue", "antiquewhite", "aqua", "aquamarine", "azure", "beige", "bisque",
    "black", "blanchedalmond", "blue", "blueviolet", "brown", "burlywood",
    "cadetblue", "chartreuse", "chocolate", "coral", "cornflowerblue",
]


def make_grid(svgs: List[SVG], num_cols: int = 2, grid_width: int = 24) -> SVG:
    """Compose SVGs left-to-right, top-to-bottom on a shared canvas
    (reference utils.py:9-22)."""
    grid = SVG([], viewbox=Bbox(0))
    for i, svg in enumerate(svgs):
        row, col = i // num_cols, i % num_cols
        svg = svg.copy().translate(Point(col * grid_width, row * grid_width))
        grid.svg_path_groups.extend(svg.svg_path_groups)
    num_rows = math.ceil(len(svgs) / num_cols)
    grid.viewbox = Bbox(0, 0, num_cols * grid_width, num_rows * grid_width)
    return grid


def make_grid_grid(svg_grid: List[List[SVG]], grid_width: int = 24) -> SVG:
    """2D nested-list version (reference utils.py:25-39)."""
    flat = [svg for row in svg_grid for svg in row]
    num_cols = len(svg_grid[0]) if svg_grid else 1
    return make_grid(flat, num_cols=num_cols, grid_width=grid_width)


def make_grid_lines(svg_grid: List[List[SVG]], grid_width: int = 24) -> SVG:
    """Row-per-line version, rows may have different lengths
    (reference utils.py:42-57)."""
    grid = SVG([], viewbox=Bbox(0))
    max_cols = 0
    for row_idx, row in enumerate(svg_grid):
        max_cols = max(max_cols, len(row))
        for col_idx, svg in enumerate(row):
            svg = svg.copy().translate(Point(col_idx * grid_width, row_idx * grid_width))
            grid.svg_path_groups.extend(svg.svg_path_groups)
    grid.viewbox = Bbox(0, 0, max_cols * grid_width, len(svg_grid) * grid_width)
    return grid


def to_gif(img_list, file_path: str = "out.gif", frame_duration: float = 0.1):
    """Write a list of PIL images as a GIF (reference utils.py:80-89,
    without the moviepy dependency)."""
    if not img_list:
        return
    img_list[0].save(
        file_path, save_all=True, append_images=img_list[1:],
        duration=int(frame_duration * 1000), loop=0,
    )
