"""SVG sub-path: an ordered list of commands with origin/closed/filling state.

Reference: deepsvg/svglib/svg_path.py. The simplification engine (RDP +
Schneider fitting) lives in ``path_fitting`` and operates on numpy point
arrays; this module holds the path container, parsing, transforms, orientation
and splitting logic.
"""
from __future__ import annotations

import math
import re
from typing import List, Optional

import numpy as np

from .geom import Bbox, Point, det, union_bbox
from .path_fitting import fit_cubics, rdp
from .svg_command import (
    SVGCommand,
    SVGCommandArc,
    SVGCommandBezier,
    SVGCommandClose,
    SVGCommandLine,
    SVGCommandMove,
)

_COMMAND_CHARS = "MmZzLlHhVvCcSsQqTtAa"
_COMMAND_RE = re.compile(r"([MmZzLlHhVvCcSsQqTtAa])")
_FLOAT_RE = re.compile(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?")


class Orientation:
    COUNTER_CLOCKWISE = 0
    CLOCKWISE = 1


class Filling:
    OUTLINE = 0
    FILL = 1
    ERASE = 2


def _tokenize_path(path_str: str):
    cmd = None
    for tok in _COMMAND_RE.split(path_str):
        if tok and tok in _COMMAND_CHARS:
            cmd = tok
        elif cmd is not None:
            yield cmd, [float(v) for v in _FLOAT_RE.findall(tok)]


class SVGPath:
    def __init__(
        self,
        path_commands: Optional[List[SVGCommand]] = None,
        origin: Optional[Point] = None,
        closed: bool = False,
        filling: int = Filling.OUTLINE,
    ):
        self.origin = origin or Point(0.0)
        self.path_commands = path_commands
        self.closed = closed
        self.filling = filling

    # --- structure -------------------------------------------------------
    @property
    def start_command(self) -> SVGCommandMove:
        return SVGCommandMove(self.origin, self.start_pos)

    @property
    def start_pos(self) -> Point:
        return self.path_commands[0].start_pos

    @property
    def end_pos(self) -> Point:
        return self.path_commands[-1].end_pos

    def __len__(self):
        return 1 + len(self.path_commands)

    def __getitem__(self, idx):
        if idx == 0:
            return self.start_command
        return self.path_commands[idx - 1]

    def all_commands(self, with_close: bool = True) -> List[SVGCommand]:
        close = (
            [SVGCommandClose(self.end_pos.copy(), self.start_pos.copy())]
            if self.closed and self.path_commands and with_close
            else []
        )
        return [self.start_command, *self.path_commands, *close]

    def copy(self) -> "SVGPath":
        return SVGPath(
            [c.copy() for c in self.path_commands],
            self.origin.copy(), self.closed, self.filling,
        )

    def set_filling(self, filling: bool = True) -> "SVGPath":
        self.filling = Filling.FILL if filling else Filling.ERASE
        return self

    def set_closed(self, closed: bool = True) -> "SVGPath":
        self.closed = closed
        return self

    def to_group(self, *args, **kwargs):
        from .svg_primitive import SVGPathGroup

        return SVGPathGroup([self], *args, **kwargs)

    # --- parsing ---------------------------------------------------------
    @staticmethod
    def from_xml(x):
        fill = not x.hasAttribute("fill") or not x.getAttribute("fill") == "none"
        filling = Filling.OUTLINE if not x.hasAttribute("filling") else int(x.getAttribute("filling"))
        return SVGPath.from_str(x.getAttribute("d"), fill=fill, filling=filling)

    @staticmethod
    def from_str(s: str, fill=False, filling=Filling.OUTLINE, add_closing=False):
        commands = []
        pos = initial_pos = Point(0.0)
        prev = None
        for cmd_char, args in _tokenize_path(s):
            parsed, pos, initial_pos = SVGCommand.from_str(cmd_char, args, pos, initial_pos, prev)
            prev = parsed[-1]
            commands.extend(parsed)
        return SVGPath.from_commands(commands, fill=fill, filling=filling, add_closing=add_closing)

    @staticmethod
    def from_tensor(tensor, allow_empty=False):
        commands = [SVGCommand.from_tensor(row) for row in np.asarray(tensor)]
        return SVGPath.from_commands(
            [c for c in commands if c is not None], allow_empty=allow_empty
        )

    @staticmethod
    def from_commands(path_commands, fill=False, filling=Filling.OUTLINE,
                      add_closing=False, allow_empty=False):
        """Split a command stream into sub-paths at moveto/close boundaries
        (reference svg_path.py:117-157)."""
        from .svg_primitive import SVGPathGroup

        if not path_commands:
            return SVGPathGroup([])

        empty_command = SVGCommandMove(Point(0.0))
        paths: List[SVGPath] = []
        current: Optional[SVGPath] = None

        def flush(path, force_close=False):
            if path is not None and (allow_empty or path.path_commands):
                if add_closing or force_close:
                    path.closed = True
                if not path.path_commands:
                    path.path_commands.append(empty_command)
                paths.append(path)

        for command in path_commands:
            if isinstance(command, SVGCommandMove):
                flush(current)
                current = SVGPath([], command.start_pos.copy(), filling=filling)
            elif isinstance(command, SVGCommandClose):
                if current is not None:
                    current.closed = True
                    flush(current)
                current = None
            else:
                if current is None:
                    continue  # ignore drawing commands before the first moveto
                current.path_commands.append(command)
        flush(current)
        return SVGPathGroup(paths, fill=fill)

    # --- output ----------------------------------------------------------
    def __repr__(self):
        return "SVGPath({})".format(" ".join(c.to_str() for c in self.all_commands()))

    def to_str(self, fill=False) -> str:
        return " ".join(c.to_str() for c in self.all_commands())

    def to_tensor(self, PAD_VAL=-1) -> np.ndarray:
        return np.stack([c.to_tensor(PAD_VAL=PAD_VAL) for c in self.all_commands()])

    def to_points(self) -> np.ndarray:
        return np.array([self.start_pos.pos, *(c.end_pos.pos for c in self.path_commands)])

    def draw(self, viewbox=None, *args, **kwargs):
        from .svg import SVG

        if viewbox is None:
            viewbox = Bbox(24)
        return SVG([self.to_group()], viewbox=viewbox).draw(*args, **kwargs)

    # --- transforms ------------------------------------------------------
    def _unique_geoms(self):
        # dedupe by identity: consecutive commands share Point objects
        # (end_pos of one IS start_pos of the next), which must be
        # transformed exactly once
        geoms, seen = [], set()
        for command in self.all_commands():
            for g in command.get_geoms():
                if id(g) not in seen:
                    seen.add(id(g))
                    geoms.append(g)
        return geoms

    def translate(self, vec: Point) -> "SVGPath":
        for g in self._unique_geoms():
            g.translate(vec)
        return self

    def rotate(self, angle) -> "SVGPath":
        for g in self._unique_geoms():
            if isinstance(g, Point):
                g.rotate_(angle)
        return self

    def scale(self, factor) -> "SVGPath":
        for g in self._unique_geoms():
            g.scale(factor)
        return self

    def numericalize(self, n: int = 256):
        for command in self.all_commands():
            command.numericalize(n)

    # --- filters ---------------------------------------------------------
    def filter_consecutives(self) -> "SVGPath":
        self.path_commands = [
            c for c in self.path_commands if not c.start_pos.isclose(c.end_pos)
        ]
        return self

    def filter_duplicates(self, min_dist: float = 0.2) -> "SVGPath":
        out = []
        current = None
        for c in self.path_commands:
            if current is None:
                out.append(c)
                current = c
            if c.end_pos.dist(current.end_pos) >= min_dist:
                c.start_pos = current.end_pos
                out.append(c)
                current = c
        self.path_commands = out
        return self

    def duplicate_extremities(self) -> "SVGPath":
        self.path_commands = [
            SVGCommandLine(self.start_pos, self.start_pos),
            *self.path_commands,
            SVGCommandLine(self.end_pos, self.end_pos),
        ]
        return self

    # --- orientation / ordering -----------------------------------------
    def is_clockwise(self) -> bool:
        if len(self.path_commands) == 1:
            cmd = self.path_commands[0]
            return cmd.start_pos.tolist() <= cmd.end_pos.tolist()
        total = sum(det(c.start_pos, c.end_pos) for c in self.path_commands)
        return total >= 0

    def set_orientation(self, orientation: int) -> "SVGPath":
        if orientation == self.is_clockwise():
            return self
        return self.reverse()

    def reverse(self) -> "SVGPath":
        self.path_commands = [c.reverse() for c in reversed(self.path_commands)]
        return self

    def reverse_non_closed(self) -> "SVGPath":
        if not self.start_pos.isclose(self.end_pos):
            return self.reverse()
        return self

    def reorder(self) -> "SVGPath":
        """Rotate a closed path so it starts at the top-left-most command."""
        if self.closed:
            best, best_idx = None, 0
            for i, c in enumerate(self.path_commands):
                if best is None or c.is_left_to(best):
                    best, best_idx = c, i
            self.path_commands = [
                *self.path_commands[best_idx:], *self.path_commands[:best_idx]
            ]
        return self

    def simplify_arcs(self) -> "SVGPath":
        out = []
        for c in self.path_commands:
            if isinstance(c, SVGCommandArc):
                if c.radius.iszero() or c.start_pos.isclose(c.end_pos):
                    continue
                out.extend(c.to_beziers())
            else:
                out.append(c)
        self.path_commands = out
        return self

    # --- smoothing / fitting ---------------------------------------------
    def smooth(self) -> "SVGPath":
        """Closed-form smooth cubic spline through the knots via the Thomas
        tridiagonal solve (reference svg_path.py:354-384 / paper.js smooth)."""
        n = len(self.path_commands)
        knots = [self.start_pos, *(c.end_pos for c in self.path_commands)]
        r = [knots[0] + 2 * knots[1]]
        f = [2.0]
        for i in range(1, n):
            internal = i < n - 1
            b = 4.0 if internal else 2.0
            u = 4.0 if internal else 3.0
            v = 2.0 if internal else 0.0
            m = 1.0 / f[i - 1]
            f.append(b - m)
            r.append(u * knots[i] + v * knots[i + 1] - m * r[i - 1])

        p = [Point(0.0)] * (n + 1)
        p[n - 1] = r[n - 1] / f[n - 1]
        for i in range(n - 2, -1, -1):
            p[i] = (r[i] - p[i + 1]) / f[i]
        p[n] = (3 * knots[n] - p[n - 1]) / 2

        for i in range(n):
            p1, p2 = knots[i], knots[i + 1]
            c1, c2 = p[i], 2 * p2 - p[i + 1]
            self.path_commands[i] = SVGCommandBezier(p1, c1, c2, p2)
        return self

    def _curve_segments(self, angle_threshold: float):
        """Indices of consecutive curve commands, split where the tangent
        angle between curves drops below the threshold and at line commands
        (reference subdivide_indices, svg_path.py:395-420)."""
        segments, current = [], []
        prev = None
        for i, command in enumerate(self.path_commands):
            if isinstance(command, SVGCommandLine):
                if current:
                    segments.append(current)
                    current = []
                prev = None
                continue
            if prev is not None and prev.angle(command) < angle_threshold:
                if current:
                    segments.append(current)
                    current = []
            current.append(i)
            prev = command
        if current:
            segments.append(current)
        return segments

    def simplify(self, tolerance=0.1, epsilon=0.1, angle_threshold=179.0,
                 force_smooth=False, use_native=True) -> "SVGPath":
        """RDP on polyline stretches + Schneider fitting on curve stretches.

        Dispatches to the C++ engine (deepsvg_tpu_torch.native) when available;
        falls back to the vectorized numpy implementation."""
        points = np.array(
            [self.start_pos.pos, *(c.end_pos.pos for c in self.path_commands)]
        )

        fit_fn, rdp_fn = fit_cubics, rdp
        if use_native:
            from .. import native

            if native.available():
                fit_fn, rdp_fn = native.fit_cubics, native.rdp

        pieces: list = []

        def emit_fit(first, last):
            if last > first:
                fit_fn(points[first : last + 1], tolerance, out=pieces)

        def emit_rdp(first, last):
            if last > first:
                rdp_fn(points[first : last + 1], epsilon, out=pieces)

        segments = self._curve_segments(angle_threshold)
        if force_smooth:
            emit_fit(0, len(points) - 1)
        elif segments:
            emit_rdp(0, segments[0][0])
            for seg, seg_next in zip(segments[:-1], segments[1:]):
                emit_fit(seg[0], seg[-1] + 1)
                emit_rdp(seg[-1] + 1, seg_next[0])
            seg = segments[-1]
            emit_fit(seg[0], seg[-1] + 1)
            emit_rdp(seg[-1] + 1, len(points) - 1)
        else:
            emit_rdp(0, len(points) - 1)

        out = []
        for piece in pieces:
            if piece[0] == "l":
                out.append(SVGCommandLine(Point(piece[1].copy()), Point(piece[2].copy())))
            else:
                out.append(
                    SVGCommandBezier(
                        Point(piece[1].copy()), Point(piece[2].copy()),
                        Point(piece[3].copy()), Point(piece[4].copy()),
                    )
                )
        self.path_commands = out
        return self

    def simplify_heuristic(self) -> "SVGPath":
        """The canonical simplification recipe (reference svg_path.py:386-389)."""
        return (
            self.copy()
            .split(max_dist=2, include_lines=False)
            .simplify(tolerance=0.1, epsilon=0.2, angle_threshold=150)
            .split(max_dist=7.5)
        )

    # --- splitting / sampling -------------------------------------------
    def split(self, n=None, max_dist=None, include_lines=True) -> "SVGPath":
        out = []
        for c in self.path_commands:
            if isinstance(c, SVGCommandLine) and not include_lines:
                out.append(c)
                continue
            k = n
            if max_dist is not None:
                k = max(math.ceil(c.length() / max_dist), 1)
            out.extend(c.split(n=k))
        self.path_commands = out
        return self

    def bbox(self) -> Bbox:
        return union_bbox([c.bbox() for c in self.path_commands])

    def sample_points(self, max_dist: float = 0.4) -> np.ndarray:
        chunks = []
        for c in self.path_commands:
            n = max(math.ceil(c.length() / max_dist), 1)
            chunks.append(np.asarray(c.sample_points(n=n, return_array=True)))
        if not chunks:
            return np.zeros((0, 2))
        return np.concatenate(chunks, axis=0)

    def to_polygon_mask(self, grid: "PolygonGrid") -> np.ndarray:
        """Boolean occupancy of this path's filled region on a raster grid —
        the shapely-polygon replacement used for overlap/filling inference."""
        return grid.polygon_mask(self.sample_points())


class PolygonGrid:
    """Fixed raster over a bounding box for polygon boolean arithmetic.

    Replaces shapely/GEOS (unavailable here): areas and intersections are
    computed on an NxN occupancy grid via matplotlib's C point-in-polygon
    test. Resolution 128 gives <1% area error on icon-scale shapes.
    """

    def __init__(self, bbox: Bbox, resolution: int = 128):
        self.resolution = resolution
        x0, y0 = bbox.xy.x, bbox.xy.y
        w, h = max(bbox.wh.x, 1e-6), max(bbox.wh.y, 1e-6)
        xs = np.linspace(x0, x0 + w, resolution)
        ys = np.linspace(y0, y0 + h, resolution)
        gx, gy = np.meshgrid(xs, ys)
        self.points = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        self.cell_area = (w / resolution) * (h / resolution)

    def polygon_mask(self, polygon: np.ndarray) -> np.ndarray:
        from matplotlib.path import Path as MplPath

        if len(polygon) < 3:
            return np.zeros(len(self.points), dtype=bool)
        return MplPath(polygon, closed=True).contains_points(self.points)

    def area(self, mask: np.ndarray) -> float:
        return float(mask.sum()) * self.cell_area
