"""CPU SVG library: parsing, canonicalization, simplification, rendering.

numpy-first re-implementation of the reference svglib (deepsvg/svglib/) with
matplotlib rasterization and raster-grid polygon booleans (no cairo/shapely).
A copy of ``deepsvg_tpu/svglib``: the port keeps its own so that it imports
nothing of the JAX package. matplotlib, PIL, networkx and IPython are
imported only by the functions that draw, render or build overlap graphs.
"""
from .geom import Angle, Bbox, Coord, Flag, Point, Radius, Size, union_bbox
from .svg import SVG
from .svg_command import (
    SVGCommand,
    SVGCommandArc,
    SVGCommandBezier,
    SVGCommandClose,
    SVGCommandLine,
    SVGCommandMove,
)
from .svg_path import Filling, Orientation, SVGPath
from .svg_primitive import (
    SVGCircle,
    SVGEllipse,
    SVGLine,
    SVGPathGroup,
    SVGPolygon,
    SVGPolyline,
    SVGRectangle,
)

__all__ = [
    "Angle", "Bbox", "Coord", "Flag", "Point", "Radius", "Size", "union_bbox",
    "SVG", "SVGCommand", "SVGCommandArc", "SVGCommandBezier", "SVGCommandClose",
    "SVGCommandLine", "SVGCommandMove", "Filling", "Orientation", "SVGPath",
    "SVGCircle", "SVGEllipse", "SVGLine", "SVGPathGroup", "SVGPolygon",
    "SVGPolyline", "SVGRectangle",
]
