"""2D geometry value types (reference: deepsvg/svglib/geom.py).

Lightweight numpy-backed versions of the reference's geometry vocabulary:
``Point``, ``Radius``, ``Size``, ``Angle``, ``Flag``, ``Bbox``, plus the
coordinate helpers the path parser needs. The array-first path representation
(svglib.svg_path) stores geometry in bulk arrays; these classes are the
scalar-value API surface.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

Num = Union[int, float]
_FLOATS = (int, float, np.floating, np.integer)


def get_rotation_matrix(angle: Union["Angle", float]) -> np.ndarray:
    theta = angle.rad if isinstance(angle, Angle) else angle
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]], dtype=np.float64)


def det(a: "Point", b: "Point") -> float:
    return float(a.pos[0] * b.pos[1] - a.pos[1] * b.pos[0])


class Point:
    num_args = 2

    __slots__ = ("pos",)

    def __init__(self, x=None, y=None):
        if isinstance(x, np.ndarray):
            self.pos = x.astype(np.float64)
        elif x is None and y is None:
            self.pos = np.zeros(2)
        else:
            if x is None:
                x = y
            if y is None:
                y = x
            self.pos = np.array([float(x), float(y)])

    # --- accessors -------------------------------------------------------
    @property
    def x(self) -> float:
        return float(self.pos[0])

    @property
    def y(self) -> float:
        return float(self.pos[1])

    def copy(self) -> "Point":
        return type(self)(self.pos.copy())

    def tolist(self):
        return [self.x, self.y]

    def to_str(self) -> str:
        return f"{_fmt(self.x)} {_fmt(self.y)}"

    def __repr__(self):
        return f"P({self.x}, {self.y})"

    # --- arithmetic ------------------------------------------------------
    def __add__(self, other: "Point") -> "Point":
        return Point(self.pos + other.pos)

    def __sub__(self, other: "Point") -> "Point":
        return Point(self.pos - other.pos)

    def __mul__(self, k) -> "Point":
        if isinstance(k, Point):
            return Point(self.pos * k.pos)
        return Point(self.pos * float(k))

    __rmul__ = __mul__

    def __truediv__(self, k) -> "Point":
        if isinstance(k, Point):
            return Point(self.pos / k.pos)
        return Point(self.pos / float(k))

    def __neg__(self) -> "Point":
        return Point(-self.pos)

    def __eq__(self, other):
        return isinstance(other, Point) and bool(np.all(self.pos == other.pos))

    def __hash__(self):
        return hash((float(self.pos[0]), float(self.pos[1])))

    # --- geometry --------------------------------------------------------
    def xproj(self) -> "Point":
        return Point(self.x, 0.0)

    def yproj(self) -> "Point":
        return Point(0.0, self.y)

    def dot(self, other: "Point") -> float:
        return float(self.pos @ other.pos)

    def cross(self, other: "Point") -> float:
        return float(np.cross(self.pos, other.pos))

    def norm(self) -> float:
        return float(np.hypot(self.pos[0], self.pos[1]))

    def dist(self, other: "Point") -> float:
        return (self - other).norm()

    def normalize(self) -> "Point":
        return self / self.norm()

    def rotate(self, angle: Union["Angle", float]) -> "Point":
        return Point(get_rotation_matrix(angle) @ self.pos)

    def rotate_(self, angle: Union["Angle", float]) -> None:
        self.pos = get_rotation_matrix(angle) @ self.pos

    def translate(self, vec: "Point") -> None:
        self.pos = self.pos + vec.pos

    def scale(self, factor) -> None:
        self.pos = self.pos * factor

    def angle(self, other: "Point", signed=False) -> "Angle":
        rad = np.arccos(np.clip(self.normalize().dot(other.normalize()), -1.0, 1.0))
        if signed and det(self, other) < 0:
            rad = -rad
        return Angle.Rad(rad)

    def dist_to_line(self, p1: "Point", p2: "Point") -> float:
        if p1.isclose(p2):
            return self.dist(p1)
        return abs((p2 - p1).cross(p1 - self)) / (p2 - p1).norm()

    def numericalize(self, n: int = 256) -> None:
        self.pos = self.pos.round().clip(0, n - 1)

    def isclose(self, other: "Point") -> bool:
        return bool(np.allclose(self.pos, other.pos))

    def iszero(self) -> bool:
        return bool(np.all(self.pos == 0))

    def pointwise_min(self, other: "Point") -> "Point":
        return Point(np.minimum(self.pos, other.pos))

    def pointwise_max(self, other: "Point") -> "Point":
        return Point(np.maximum(self.pos, other.pos))


def _fmt(v: float) -> str:
    """Compact number formatting for SVG output."""
    return f"{v:.10g}"


class Radius(Point):
    __slots__ = ()

    def translate(self, vec):  # radii don't translate
        pass

    def __repr__(self):
        return f"Rad({self.x}, {self.y})"


class Size(Point):
    __slots__ = ()

    def max(self) -> float:
        return float(self.pos.max())

    def min(self) -> float:
        return float(self.pos.min())

    def translate(self, vec):  # sizes don't translate
        pass

    def __repr__(self):
        return f"Size({self.x}, {self.y})"


class Angle:
    num_args = 1

    __slots__ = ("deg",)

    def __init__(self, deg: float):
        self.deg = float(deg)

    @property
    def rad(self) -> float:
        return float(np.deg2rad(self.deg))

    @staticmethod
    def Rad(rad: float) -> "Angle":
        return Angle(np.rad2deg(rad))

    def copy(self):
        return Angle(self.deg)

    def to_str(self):
        return _fmt(self.deg)

    def translate(self, vec):
        pass

    def scale(self, factor):
        pass

    def __add__(self, other: "Angle"):
        return Angle(self.deg + other.deg)

    def __sub__(self, other: "Angle"):
        return Angle(self.deg - other.deg)

    def __mul__(self, k):
        return Angle(self.deg * float(k))

    __rmul__ = __mul__

    def __truediv__(self, k):
        return Angle(self.deg / float(k))

    def __neg__(self):
        return Angle(-self.deg)

    def __repr__(self):
        return f"α({self.deg})"


class Flag:
    num_args = 1

    __slots__ = ("flag",)

    def __init__(self, flag):
        self.flag = int(flag)

    def copy(self):
        return Flag(self.flag)

    def to_str(self):
        return str(self.flag)

    def translate(self, vec):
        pass

    def scale(self, factor):
        pass

    def __invert__(self):
        return Flag(1 - self.flag)

    def __repr__(self):
        return f"flag({self.flag})"


class Coord:
    """Single-axis coordinate used while parsing h/v commands."""

    num_args = 1

    def __init__(self, coord: float, is_y: bool = False):
        self.coord = float(coord)
        self.is_y = is_y

    def translate(self, vec: Point):
        self.coord += vec.y if self.is_y else vec.x

    def to_point(self, pos: Point) -> Point:
        point = pos.copy()
        point.pos[1 if self.is_y else 0] = self.coord
        return point


class XCoord(Coord):
    def __init__(self, coord):
        super().__init__(coord, is_y=False)


class YCoord(Coord):
    def __init__(self, coord):
        super().__init__(coord, is_y=True)


class Bbox:
    num_args = 4

    __slots__ = ("xy", "wh")

    def __init__(self, x=None, y=None, w=None, h=None):
        if isinstance(x, Point) and isinstance(y, Point):
            self.xy = x.copy()
            d = y - x
            self.wh = Size(d.x, d.y)
        else:
            if x is None:
                x = 0.0
            if y is None:
                y = float(x)
            if w is None and h is None:
                w, h = float(x), float(y)
                x, y = 0.0, 0.0
            self.xy = Point(x, y)
            self.wh = Size(w, h)

    @property
    def xy2(self) -> Point:
        return self.xy + self.wh

    @property
    def size(self) -> Size:
        return self.wh

    @property
    def center(self) -> Point:
        return self.xy + self.wh / 2

    def copy(self) -> "Bbox":
        b = Bbox()
        b.xy, b.wh = self.xy.copy(), self.wh.copy()
        return b

    def to_str(self) -> str:
        return f"{self.xy.to_str()} {self.wh.to_str()}"

    def __repr__(self):
        return f"Bbox({self.to_str()})"

    def make_square(self, min_size=None) -> "Bbox":
        center = self.center
        size = self.wh.max()
        if min_size is not None:
            size = max(size, min_size)
        self.wh = Size(size, size)
        self.xy = center - self.wh / 2
        return self

    def translate(self, vec: Point):
        self.xy.translate(vec)

    def scale(self, factor):
        self.xy.scale(factor)
        self.wh.scale(factor)

    def union(self, other: Optional["Bbox"]) -> "Bbox":
        if other is None:
            return self
        return Bbox(self.xy.pointwise_min(other.xy), self.xy2.pointwise_max(other.xy2))

    def intersect(self, other: Optional["Bbox"]) -> Optional["Bbox"]:
        if other is None:
            return self
        b = Bbox(self.xy.pointwise_max(other.xy), self.xy2.pointwise_min(other.xy2))
        if b.wh.x < 0 or b.wh.y < 0:
            return None
        return b

    def area(self) -> float:
        return float(self.wh.pos.prod())

    def overlap(self, other: "Bbox") -> float:
        inter = self.intersect(other)
        return 0.0 if inter is None else inter.area() / self.area()

    @staticmethod
    def from_points(points: List[Point]) -> Optional["Bbox"]:
        if not points:
            return None
        arr = np.stack([p.pos for p in points])
        return Bbox(Point(arr.min(0)), Point(arr.max(0)))

    def to_rectangle(self, *args, **kwargs):
        from .svg_primitive import SVGRectangle

        return SVGRectangle(self.xy, self.wh, *args, **kwargs)


def union_bbox(bbox_list: List[Optional[Bbox]]) -> Optional[Bbox]:
    res = None
    for bbox in bbox_list:
        if bbox is not None:
            res = bbox.union(res)
    return res
