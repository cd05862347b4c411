"""SVG path commands: parsing, tensorization, Bézier/arc math.

Reference semantics: deepsvg/svglib/svg_command.py. The full SVG command set
(m l c z a q h v s t) is parsed and immediately *normalized* to the simplified
vocabulary (m, l, c, a, z): q promotes to cubic, h/v become lines, s/t apply
control-point reflection — reference svg_command.py:50-120. Tensor layout is
the shared 14-column contract (deepsvg_tpu_torch.svgtensor.constants.Index).
"""
from __future__ import annotations

import math
from typing import List, Optional, Union

import numpy as np

from ..svgtensor.constants import (
    CMD_A,
    CMD_C,
    CMD_L,
    CMD_M,
    CMD_Z,
    COMMANDS_SIMPLIFIED,
)
from .geom import Angle, Bbox, Coord, Flag, Point, Radius, XCoord, YCoord
from .util_fns import get_roots

Num = Union[int, float]

# Argument signature of each raw SVG command letter.
_CMD_ARG_TYPES = {
    "m": [Point],
    "l": [Point],
    "c": [Point, Point, Point],
    "z": [],
    "a": [Radius, Angle, Flag, Flag, Point],
    "q": [Point, Point],
    "h": [XCoord],
    "v": [YCoord],
    "s": [Point, Point],
    "t": [Point],
}


class SVGCommand:
    """Base command: knows its simplified-vocabulary index, start/end points."""

    command = None  # simplified letter

    def __init__(self, start_pos: Point, end_pos: Point):
        self.start_pos = start_pos
        self.end_pos = end_pos

    # --- parsing ---------------------------------------------------------
    @staticmethod
    def from_str(
        cmd_char: str,
        args: List[float],
        pos: Optional[Point] = None,
        initial_pos: Optional[Point] = None,
        prev_command: Optional["SVGCommand"] = None,
    ):
        """Parse one tokenized command (possibly with repeated argument
        groups) into normalized commands. Returns (commands, pos, initial_pos).
        """
        if pos is None:
            pos = Point(0.0)
        if initial_pos is None:
            initial_pos = Point(0.0)

        letter = cmd_char.lower()
        relative = cmd_char.islower()

        # moveto with extra coordinate pairs -> implicit lineto
        if letter == "m" and len(args) > 2:
            l_char = "l" if relative else "L"
            c1, pos, initial_pos = SVGCommand.from_str(cmd_char, args[:2], pos, initial_pos)
            c2, pos, initial_pos = SVGCommand.from_str(l_char, args[2:], pos, initial_pos)
            return [*c1, *c2], pos, initial_pos

        if letter == "z":
            assert not args, f"z takes no arguments, got {len(args)}"
            return [SVGCommandClose(pos, initial_pos)], initial_pos, initial_pos

        arg_types = _CMD_ARG_TYPES[letter]
        group_len = sum(t.num_args for t in arg_types)
        assert len(args) % group_len == 0, (
            f"Expected a multiple of {group_len} arguments for '{cmd_char}', got {len(args)}"
        )

        out = []
        i = 0
        for _ in range(len(args) // group_len):
            parsed = []
            for t in arg_types:
                arg = t(*args[i : i + t.num_args])
                if relative:
                    arg.translate(pos)
                if isinstance(arg, Coord):
                    arg = arg.to_point(pos)
                parsed.append(arg)
                i += t.num_args

            if letter in ("l", "h", "v"):
                cmd = SVGCommandLine(pos, parsed[0])
            elif letter == "m":
                cmd = SVGCommandMove(pos, parsed[0])
            elif letter == "a":
                cmd = SVGCommandArc(pos, *parsed)
            elif letter == "c":
                cmd = SVGCommandBezier(pos, parsed[0], parsed[1], parsed[2])
            elif letter == "q":
                cmd = SVGCommandBezier(pos, parsed[0], parsed[0], parsed[1])
            else:  # s / t: reflected control point
                if isinstance(prev_command, SVGCommandBezier):
                    control1 = pos * 2 - prev_command.control2
                else:
                    control1 = pos
                control2 = parsed[0] if letter == "s" else control1
                cmd = SVGCommandBezier(pos, control1, control2, parsed[-1])

            prev_command = cmd
            pos = cmd.end_pos
            if letter == "m":
                initial_pos = pos
            out.append(cmd)

        return out, pos, initial_pos

    # --- tensor bridge ---------------------------------------------------
    def to_tensor(self, PAD_VAL: int = -1) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def from_tensor(row) -> Optional["SVGCommand"]:
        row = np.asarray(row, dtype=np.float64)
        idx = int(row[0])
        letter = COMMANDS_SIMPLIFIED[idx]
        start = Point(row[6], row[7])
        end = Point(row[12], row[13])
        if letter == "m":
            return SVGCommandMove(start, end)
        if letter == "l":
            return SVGCommandLine(start, end)
        if letter == "c":
            return SVGCommandBezier(start, Point(row[8], row[9]), Point(row[10], row[11]), end)
        if letter == "a":
            return SVGCommandArc(
                start, Radius(row[1], row[2]), Angle(row[3]), Flag(row[4]), Flag(row[5]), end
            )
        if letter == "z":
            return SVGCommandClose(start, end)
        return None  # EOS / SOS

    # --- shared API ------------------------------------------------------
    def copy(self):
        raise NotImplementedError

    def reverse(self):
        raise NotImplementedError

    def get_geoms(self):
        return [self.start_pos, self.end_pos]

    def numericalize(self, n: int = 256):
        for g in self.get_geoms():
            if isinstance(g, Point):
                g.numericalize(n)

    def is_left_to(self, other: "SVGCommand") -> bool:
        p1, p2 = self.start_pos, other.start_pos
        if p1.y == p2.y:
            return p1.x < p2.x
        return p1.y < p2.y or (np.isclose(p1.norm(), p2.norm()) and p1.x < p2.x)

    def sample_points(self, n: int = 10, return_array: bool = False):
        if return_array:
            return np.zeros((0, 2))
        return []

    def split(self, n: int = 2):
        raise NotImplementedError

    def length(self) -> float:
        raise NotImplementedError

    def bbox(self) -> Bbox:
        raise NotImplementedError

    def to_str(self) -> str:
        raise NotImplementedError

    def __repr__(self):
        return self.to_str()

    def draw(self, *args, **kwargs):
        from .svg_path import SVGPath

        return SVGPath([self]).draw(*args, **kwargs)


class _LinearCommand(SVGCommand):
    """Shared implementation of m / l / z (no control points)."""

    cmd_index = None

    def to_tensor(self, PAD_VAL: int = -1) -> np.ndarray:
        row = np.full(14, PAD_VAL, dtype=np.float32)
        row[0] = self.cmd_index
        row[6:8] = self.start_pos.pos
        row[12:14] = self.end_pos.pos
        return row

    def copy(self):
        return type(self)(self.start_pos.copy(), self.end_pos.copy())

    def reverse(self):
        return type(self)(self.end_pos, self.start_pos)

    def split(self, n: int = 2):
        return [self]

    def bbox(self) -> Bbox:
        return Bbox(
            self.start_pos.pointwise_min(self.end_pos),
            self.start_pos.pointwise_max(self.end_pos),
        )


class SVGCommandMove(_LinearCommand):
    command = "m"
    cmd_index = CMD_M

    def __init__(self, start_pos: Point, end_pos: Optional[Point] = None):
        if end_pos is None:
            start_pos, end_pos = Point(0.0), start_pos
        super().__init__(start_pos, end_pos)

    def to_str(self):
        return f"M{self.end_pos.to_str()}"

    def bbox(self):
        return Bbox(self.end_pos.copy(), self.end_pos.copy())


class SVGCommandLine(_LinearCommand):
    command = "l"
    cmd_index = CMD_L

    def to_str(self):
        return f"L{self.end_pos.to_str()}"

    def sample_points(self, n: int = 10, return_array: bool = False):
        z = np.linspace(0.0, 1.0, n)[:, None]
        pts = (1 - z) * self.start_pos.pos[None] + z * self.end_pos.pos[None]
        if return_array:
            return pts
        return [Point(p.copy()) for p in pts]

    def split(self, n: int = 2):
        pts = self.sample_points(n + 1)
        return [SVGCommandLine(a, b) for a, b in zip(pts[:-1], pts[1:])]

    def length(self) -> float:
        return self.start_pos.dist(self.end_pos)


class SVGCommandClose(_LinearCommand):
    command = "z"
    cmd_index = CMD_Z

    def to_str(self):
        return "Z"


class SVGCommandBezier(SVGCommand):
    command = "c"

    def __init__(self, start_pos: Point, control1: Point, control2: Optional[Point], end_pos: Point):
        if control2 is None:
            control2 = control1.copy()
        super().__init__(start_pos, end_pos)
        self.control1 = control1
        self.control2 = control2

    def to_str(self):
        return f"C{self.control1.to_str()} {self.control2.to_str()} {self.end_pos.to_str()}"

    def to_tensor(self, PAD_VAL: int = -1) -> np.ndarray:
        row = np.full(14, PAD_VAL, dtype=np.float32)
        row[0] = CMD_C
        row[6:8] = self.start_pos.pos
        row[8:10] = self.control1.pos
        row[10:12] = self.control2.pos
        row[12:14] = self.end_pos.pos
        return row

    def to_vector(self) -> np.ndarray:
        return np.stack(
            [self.start_pos.pos, self.control1.pos, self.control2.pos, self.end_pos.pos]
        )

    @staticmethod
    def from_vector(v: np.ndarray) -> "SVGCommandBezier":
        return SVGCommandBezier(Point(v[0].copy()), Point(v[1].copy()), Point(v[2].copy()), Point(v[3].copy()))

    def copy(self):
        return SVGCommandBezier(
            self.start_pos.copy(), self.control1.copy(), self.control2.copy(), self.end_pos.copy()
        )

    def reverse(self):
        return SVGCommandBezier(self.end_pos, self.control2, self.control1, self.start_pos)

    def get_geoms(self):
        return [self.start_pos, self.control1, self.control2, self.end_pos]

    # --- curve math ------------------------------------------------------
    def eval(self, t: float) -> Point:
        s = 1 - t
        return (
            s**3 * self.start_pos
            + 3 * s**2 * t * self.control1
            + 3 * s * t**2 * self.control2
            + t**3 * self.end_pos
        )

    def derivative(self, t: float, n: int = 1) -> Point:
        s = 1 - t
        if n == 1:
            return (
                3 * s**2 * (self.control1 - self.start_pos)
                + 6 * s * t * (self.control2 - self.control1)
                + 3 * t**2 * (self.end_pos - self.control2)
            )
        if n == 2:
            return 6 * s * (self.control2 - 2 * self.control1 + self.start_pos) + 6 * t * (
                self.end_pos - 2 * self.control2 + self.control1
            )
        raise NotImplementedError

    def angle(self, other: "SVGCommandBezier") -> float:
        """Angle in degrees between this curve's exit tangent and the next
        curve's (negated) entry tangent (svg_command.py:362-367)."""
        t1, t2 = self.derivative(1.0), -other.derivative(0.0)
        if np.isclose(t1.norm(), 0.0) or np.isclose(t2.norm(), 0.0):
            return 0.0
        rad = np.arccos(np.clip(t1.normalize().dot(t2.normalize()), -1.0, 1.0))
        return float(np.rad2deg(rad))

    def sample_points(self, n: int = 10, return_array: bool = False):
        b = self.to_vector()
        z = np.linspace(0.0, 1.0, n)
        zpow = np.stack([np.ones_like(z), z, z**2, z**3], axis=1)
        basis = np.array(
            [[1.0, 0, 0, 0], [-3, 3, 0, 0], [3, -6, 3, 0], [-1, 3, -3, 1]]
        )
        pts = zpow @ basis @ b
        if return_array:
            return pts
        return [Point(p.copy()) for p in pts]

    def _split_two(self, z: float = 0.5):
        """De Casteljau split at parameter z (svg_command.py:386-398)."""
        b = self.to_vector()
        w = 1 - z
        q1 = np.array(
            [
                [1, 0, 0, 0],
                [w, z, 0, 0],
                [w**2, 2 * w * z, z**2, 0],
                [w**3, 3 * w**2 * z, 3 * w * z**2, z**3],
            ]
        )
        q2 = np.array(
            [
                [w**3, 3 * w**2 * z, 3 * w * z**2, z**3],
                [0, w**2, 2 * w * z, z**2],
                [0, 0, w, z],
                [0, 0, 0, 1],
            ]
        )
        return SVGCommandBezier.from_vector(q1 @ b), SVGCommandBezier.from_vector(q2 @ b)

    def split(self, n: int = 2):
        out, cur = [], self
        for i in range(n - 1):
            z = 1.0 / (n - i)
            first, cur = cur._split_two(z)
            out.append(first)
        out.append(cur)
        return out

    def length(self) -> float:
        p = self.sample_points(n=100, return_array=True)
        return float(np.linalg.norm(p[1:] - p[:-1], axis=-1).sum())

    def find_roots(self) -> List[float]:
        """Parameters of axis-aligned extrema (svg_command.py:418-426)."""
        a = 3 * (-self.start_pos + 3 * self.control1 - 3 * self.control2 + self.end_pos)
        b = 6 * (self.start_pos - 2 * self.control1 + self.control2)
        c = 3 * (self.control1 - self.start_pos)
        roots = [*get_roots(a.x, b.x, c.x), *get_roots(a.y, b.y, c.y)]
        return [r for r in roots if 0 <= r <= 1]

    def find_extrema(self) -> List[Point]:
        return [self.start_pos, self.end_pos, *(self.eval(r) for r in self.find_roots())]

    def bbox(self) -> Bbox:
        return Bbox.from_points(self.find_extrema())


class SVGCommandArc(SVGCommand):
    command = "a"

    def __init__(
        self,
        start_pos: Point,
        radius: Radius,
        x_axis_rotation: Angle,
        large_arc_flag: Flag,
        sweep_flag: Flag,
        end_pos: Point,
    ):
        super().__init__(start_pos, end_pos)
        self.radius = radius
        self.x_axis_rotation = x_axis_rotation
        self.large_arc_flag = large_arc_flag
        self.sweep_flag = sweep_flag

    def to_str(self):
        return (
            f"A{self.radius.to_str()} {self.x_axis_rotation.to_str()} "
            f"{self.large_arc_flag.to_str()} {self.sweep_flag.to_str()} {self.end_pos.to_str()}"
        )

    def to_tensor(self, PAD_VAL: int = -1) -> np.ndarray:
        row = np.full(14, PAD_VAL, dtype=np.float32)
        row[0] = CMD_A
        row[1:3] = self.radius.pos
        row[3] = self.x_axis_rotation.deg
        row[4] = self.large_arc_flag.flag
        row[5] = self.sweep_flag.flag
        row[6:8] = self.start_pos.pos
        row[12:14] = self.end_pos.pos
        return row

    def copy(self):
        return SVGCommandArc(
            self.start_pos.copy(), self.radius.copy(), self.x_axis_rotation.copy(),
            self.large_arc_flag.copy(), self.sweep_flag.copy(), self.end_pos.copy(),
        )

    def reverse(self):
        return SVGCommandArc(
            self.end_pos, self.radius, self.x_axis_rotation,
            self.large_arc_flag, ~self.sweep_flag, self.start_pos,
        )

    def get_geoms(self):
        return [
            self.start_pos, self.radius, self.x_axis_rotation,
            self.large_arc_flag, self.sweep_flag, self.end_pos,
        ]

    # --- arc -> cubic conversion (W3C implementation notes / Maisonobe) ---
    def _center_parametrization(self):
        """Endpoint -> center parametrization (svg_command.py:458-483)."""
        r = self.radius
        p1, p2 = self.start_pos, self.end_pos
        h, m = 0.5 * (p1 - p2), 0.5 * (p1 + p2)
        p1t = h.rotate(-self.x_axis_rotation)

        sign = -1 if self.large_arc_flag.flag == self.sweep_flag.flag else 1
        x2, y2, rx2, ry2 = p1t.x**2, p1t.y**2, r.x**2, r.y**2
        sqrt = math.sqrt(max((rx2 * ry2 - rx2 * y2 - ry2 * x2) / (rx2 * y2 + ry2 * x2), 0.0))
        ct = sign * sqrt * Point(r.x * p1t.y / r.y, -r.y * p1t.x / r.x)

        c = ct.rotate(self.x_axis_rotation) + m
        d, ns = (p1t - ct) / r, -(p1t + ct) / r

        theta1 = Point(1, 0).angle(d, signed=True)
        delta = d.angle(ns, signed=True)
        delta.deg %= 360
        if self.sweep_flag.flag == 0 and delta.deg > 0:
            delta = delta - Angle(360)
        return c, theta1, delta

    def _point_at(self, c: Point, t: float) -> Point:
        r = self.radius
        return c + Point(r.x * np.cos(t), r.y * np.sin(t)).rotate(self.x_axis_rotation)

    def _derivative_at(self, t: float) -> Point:
        r = self.radius
        return Point(-r.x * np.sin(t), r.y * np.cos(t)).rotate(self.x_axis_rotation)

    def to_beziers(self) -> List[SVGCommandBezier]:
        """Approximate by <=45° cubic segments (svg_command.py:493-511)."""
        c, theta1, delta = self._center_parametrization()
        n = max(int(abs(delta.deg) // 45), 1)
        etas = [theta1 + i * delta / n for i in range(n + 1)]
        out = []
        for eta1, eta2 in zip(etas[:-1], etas[1:]):
            e1, e2 = eta1.rad, eta2.rad
            alpha = np.sin(e2 - e1) * (math.sqrt(4 + 3 * np.tan(0.5 * (e2 - e1)) ** 2) - 1) / 3
            p1, p2 = self._point_at(c, e1), self._point_at(c, e2)
            q1 = p1 + alpha * self._derivative_at(e1)
            q2 = p2 - alpha * self._derivative_at(e2)
            out.append(SVGCommandBezier(p1, q1, q2, p2))
        return out

    def numericalize(self, n: int = 256):
        raise NotImplementedError("numericalize arcs after simplify_arcs")
