"""SVG shape primitives and path groups (reference: svglib/svg_primitive.py).

Every shape lowers to paths via ``to_path``. ``SVGPathGroup`` is the renderable
unit: a list of sub-paths with chained origins, color/fill attributes, and the
filling-inference machinery (overlap graph + depth parity), implemented here on
raster occupancy grids (svg_path.PolygonGrid) instead of shapely polygons.
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from .geom import Angle, Bbox, Flag, Point, Radius, Size, union_bbox
from .svg_command import SVGCommandArc, SVGCommandLine
from .svg_path import PolygonGrid, SVGPath

_FLOAT_RE = re.compile(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?")


def _extract_args(s: str) -> List[float]:
    return [float(v) for v in _FLOAT_RE.findall(s)]


def _xml_fill(x) -> bool:
    return not x.hasAttribute("fill") or not x.getAttribute("fill") == "none"


class SVGPrimitive:
    """Base: carries presentation attributes and the fill flag."""

    def __init__(self, color="black", fill=False, dasharray=None, stroke_width=".3", opacity=1.0):
        self.color = color
        self.fill = fill
        self.dasharray = dasharray
        self.stroke_width = stroke_width
        self.opacity = opacity

    def _get_fill_attr(self) -> str:
        if self.fill:
            return f'fill="{self.color}" fill-opacity="{self.opacity}"'
        attr = (
            f'fill="none" stroke="{self.color}" stroke-width="{self.stroke_width}"'
            f' stroke-opacity="{self.opacity}"'
        )
        if self.dasharray is not None:
            attr += f' stroke-dasharray="{self.dasharray}"'
        return attr

    def fill_(self, fill=True):
        self.fill = fill
        return self

    # transforms over the shape's geoms — the reference's primitives silently
    # lack these (svg_primitive.py has none), so any pipeline call on a
    # document still holding raw shapes crashes there; here every shape
    # supports translate/scale directly
    def _geoms(self):
        raise NotImplementedError

    def translate(self, vec):
        for g in self._geoms():
            g.translate(vec)
        return self

    def scale(self, factor):
        for g in self._geoms():
            g.scale(factor)
        return self

    def to_path(self):
        raise NotImplementedError

    def draw(self, viewbox=None, *args, **kwargs):
        from .svg import SVG

        if viewbox is None:
            viewbox = Bbox(24)
        return SVG([self], viewbox=viewbox).draw(*args, **kwargs)

    def _get_viz_elements(self, *args, **kwargs):
        return []


class SVGEllipse(SVGPrimitive):
    def __init__(self, center: Point, radius: Radius, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.center = center
        self.radius = radius

    def _geoms(self):
        return [self.center, self.radius]

    def __repr__(self):
        return f"SVGEllipse(c={self.center} r={self.radius})"

    def to_str(self, *args, **kwargs):
        return (
            f'<ellipse {self._get_fill_attr()} cx="{self.center.x}" cy="{self.center.y}"'
            f' rx="{self.radius.x}" ry="{self.radius.y}"/>'
        )

    @classmethod
    def from_xml(cls, x):
        center = Point(float(x.getAttribute("cx") or 0), float(x.getAttribute("cy") or 0))
        radius = Radius(float(x.getAttribute("rx")), float(x.getAttribute("ry")))
        return SVGEllipse(center, radius, fill=_xml_fill(x))

    def to_path(self):
        """Lower to four 90° arcs (reference svg_primitive.py:87-96)."""
        quarter_points = [
            self.center + self.radius.xproj(),
            self.center + self.radius.yproj(),
            self.center - self.radius.xproj(),
            self.center - self.radius.yproj(),
        ]
        commands = [
            SVGCommandArc(p1, self.radius.copy(), Angle(0.0), Flag(0), Flag(1), p2)
            for p1, p2 in zip(quarter_points, quarter_points[1:] + quarter_points[:1])
        ]
        return SVGPath(commands, closed=True).to_group(fill=self.fill)


class SVGCircle(SVGEllipse):
    def __repr__(self):
        return f"SVGCircle(c={self.center} r={self.radius})"

    def to_str(self, *args, **kwargs):
        return (
            f'<circle {self._get_fill_attr()} cx="{self.center.x}" cy="{self.center.y}"'
            f' r="{self.radius.x}"/>'
        )

    @classmethod
    def from_xml(cls, x):
        center = Point(float(x.getAttribute("cx") or 0), float(x.getAttribute("cy") or 0))
        radius = Radius(float(x.getAttribute("r")))
        return SVGCircle(center, radius, fill=_xml_fill(x))


class SVGRectangle(SVGPrimitive):
    def __init__(self, xy: Point, wh: Size, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.xy = xy
        self.wh = wh

    def _geoms(self):
        return [self.xy, self.wh]

    def __repr__(self):
        return f"SVGRectangle(xy={self.xy} wh={self.wh})"

    def to_str(self, *args, **kwargs):
        return (
            f'<rect {self._get_fill_attr()} x="{self.xy.x}" y="{self.xy.y}"'
            f' width="{self.wh.x}" height="{self.wh.y}"/>'
        )

    @classmethod
    def from_xml(cls, x):
        xy = Point(float(x.getAttribute("x") or 0), float(x.getAttribute("y") or 0))
        wh = Size(float(x.getAttribute("width")), float(x.getAttribute("height")))
        return SVGRectangle(xy, wh, fill=_xml_fill(x))

    def to_path(self):
        corners = [
            self.xy,
            self.xy + self.wh.xproj(),
            self.xy + self.wh,
            self.xy + self.wh.yproj(),
        ]
        commands = [
            SVGCommandLine(p1, p2)
            for p1, p2 in zip(corners, corners[1:] + corners[:1])
        ]
        return SVGPath(commands, closed=True).to_group(fill=self.fill)


class SVGLine(SVGPrimitive):
    def __init__(self, start_pos: Point, end_pos: Point, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.start_pos = start_pos
        self.end_pos = end_pos

    def _geoms(self):
        return [self.start_pos, self.end_pos]

    def __repr__(self):
        return f"SVGLine(xy1={self.start_pos} xy2={self.end_pos})"

    def to_str(self, *args, **kwargs):
        return (
            f'<line {self._get_fill_attr()} x1="{self.start_pos.x}" y1="{self.start_pos.y}"'
            f' x2="{self.end_pos.x}" y2="{self.end_pos.y}"/>'
        )

    @classmethod
    def from_xml(cls, x):
        start = Point(float(x.getAttribute("x1") or 0), float(x.getAttribute("y1") or 0))
        end = Point(float(x.getAttribute("x2") or 0), float(x.getAttribute("y2") or 0))
        return SVGLine(start, end, fill=_xml_fill(x))

    def to_path(self):
        return SVGPath([SVGCommandLine(self.start_pos, self.end_pos)]).to_group(fill=self.fill)


class SVGPolyline(SVGPrimitive):
    closed = False

    def __init__(self, points: List[Point], *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.points = points

    def _geoms(self):
        return self.points

    def __repr__(self):
        return f"{type(self).__name__}(points={self.points})"

    def to_str(self, *args, **kwargs):
        tag = "polygon" if self.closed else "polyline"
        pts = " ".join(p.to_str() for p in self.points)
        return f'<{tag} {self._get_fill_attr()} points="{pts}"/>'

    @classmethod
    def from_xml(cls, x):
        args = _extract_args(x.getAttribute("points"))
        assert len(args) % 2 == 0, f"odd number of polyline coordinates: {len(args)}"
        points = [Point(args[2 * i], args[2 * i + 1]) for i in range(len(args) // 2)]
        return cls(points, fill=_xml_fill(x))

    def to_path(self):
        commands = [
            SVGCommandLine(p1, p2) for p1, p2 in zip(self.points[:-1], self.points[1:])
        ]
        return SVGPath(commands, closed=self.closed).to_group(fill=self.fill)


class SVGPolygon(SVGPolyline):
    closed = True


class SVGPathGroup(SVGPrimitive):
    def __init__(self, svg_paths: Optional[List[SVGPath]] = None, origin: Optional[Point] = None,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.svg_paths = svg_paths
        self.origin = origin or Point(0.0)

    # --- structure -------------------------------------------------------
    @property
    def paths(self):
        return self.svg_paths

    @property
    def path(self) -> SVGPath:
        return self.svg_paths[0]

    def __getitem__(self, idx):
        return self.svg_paths[idx]

    def __len__(self):
        return len(self.svg_paths)

    def total_len(self):
        return sum(len(p) for p in self.svg_paths)

    @property
    def start_pos(self):
        return self.svg_paths[0].start_pos

    @property
    def end_pos(self):
        last = self.svg_paths[-1]
        return last.start_pos if last.closed else last.end_pos

    def set_origin(self, origin: Point):
        self.origin = origin
        if self.svg_paths:
            self.svg_paths[0].origin = origin
        self.recompute_origins()

    def append(self, path: SVGPath):
        self.svg_paths.append(path)

    def copy(self):
        return SVGPathGroup(
            [p.copy() for p in self.svg_paths], self.origin.copy(),
            self.color, self.fill, self.dasharray, self.stroke_width, self.opacity,
        )

    def __repr__(self):
        return "SVGPathGroup({})".format(", ".join(repr(p) for p in self.svg_paths))

    # --- output ----------------------------------------------------------
    def to_str(self, with_markers=False, *args, **kwargs):
        marker = 'marker-start="url(#arrow)" ' if with_markers else ""
        d = " ".join(p.to_str() for p in self.svg_paths)
        return (
            f'<path {self._get_fill_attr()} {marker}filling="{self.path.filling}" d="{d}"></path>'
        )

    def to_tensor(self, PAD_VAL=-1) -> np.ndarray:
        return np.concatenate([p.to_tensor(PAD_VAL=PAD_VAL) for p in self.svg_paths], axis=0)

    def to_path(self):
        return self

    def to_points(self):
        return np.concatenate([p.to_points() for p in self.svg_paths])

    def _get_viz_elements(self, *args, **kwargs):
        return []

    # --- per-path forwarding ---------------------------------------------
    def _apply_to_paths(self, method, *args, **kwargs):
        for path in self.svg_paths:
            getattr(path, method)(*args, **kwargs)
        return self

    def translate(self, vec):
        return self._apply_to_paths("translate", vec)

    def rotate(self, angle):
        return self._apply_to_paths("rotate", angle)

    def scale(self, factor):
        return self._apply_to_paths("scale", factor)

    def numericalize(self, n=256):
        return self._apply_to_paths("numericalize", n)

    def split(self, n=None, max_dist=None, include_lines=True):
        return self._apply_to_paths("split", n=n, max_dist=max_dist, include_lines=include_lines)

    def simplify_arcs(self):
        return self._apply_to_paths("simplify_arcs")

    def filter_consecutives(self):
        return self._apply_to_paths("filter_consecutives")

    def filter_duplicates(self):
        return self._apply_to_paths("filter_duplicates")

    def duplicate_extremities(self):
        return self._apply_to_paths("duplicate_extremities")

    def drop_z(self):
        return self._apply_to_paths("set_closed", False)

    # --- origin chaining --------------------------------------------------
    def recompute_origins(self):
        origin = self.origin
        for path in self.svg_paths:
            path.origin = origin.copy()
            origin = path.end_pos
        return self

    def reorder(self):
        self._apply_to_paths("reorder")
        self.recompute_origins()
        return self

    def reverse(self):
        self._apply_to_paths("reverse")
        self.recompute_origins()
        return self

    def reverse_non_closed(self):
        self._apply_to_paths("reverse_non_closed")
        self.recompute_origins()
        return self

    def simplify(self, tolerance=0.1, epsilon=0.1, angle_threshold=179.0, force_smooth=False):
        self._apply_to_paths(
            "simplify", tolerance=tolerance, epsilon=epsilon,
            angle_threshold=angle_threshold, force_smooth=force_smooth,
        )
        self.recompute_origins()
        return self

    def filter_empty(self):
        self.svg_paths = [p for p in self.svg_paths if p.path_commands]
        return self

    def canonicalize(self):
        """Sort sub-paths by (y, x) start, force first clockwise
        (reference svg_primitive.py:339-345)."""
        self.svg_paths = sorted(self.svg_paths, key=lambda p: p.start_pos.tolist()[::-1])
        if not self.svg_paths[0].is_clockwise():
            self._apply_to_paths("reverse")
        self.recompute_origins()
        return self

    def split_paths(self):
        return [
            SVGPathGroup(
                [p], self.origin, self.color, self.fill,
                self.dasharray, self.stroke_width, self.opacity,
            )
            for p in self.svg_paths
        ]

    def bbox(self):
        return union_bbox([p.bbox() for p in self.svg_paths])

    def bbox_overlap(self, other: "SVGPathGroup"):
        return self.bbox().overlap(other.bbox())

    # --- filling inference (raster-grid polygon booleans) -----------------
    def _masks_and_grid(self):
        bbox = self.bbox()
        if bbox is None:
            return None, []
        grid = PolygonGrid(bbox)
        return grid, [p.to_polygon_mask(grid) for p in self.svg_paths]

    def overlap_graph(self, threshold: float = 0.9, draw: bool = False):
        """Directed containment graph: edge j->i iff path i's area lies
        (almost) inside path j (reference svg_primitive.py:422-441)."""
        import networkx as nx

        G = nx.DiGraph()
        grid, masks = self._masks_and_grid()
        for i, mask_i in enumerate(masks):
            G.add_node(i)
            if self.svg_paths[i].closed:
                area_i = mask_i.sum()
                if area_i == 0:
                    continue
                for j, mask_j in enumerate(masks):
                    if i != j and self.svg_paths[j].closed:
                        overlap = (mask_i & mask_j).sum() / area_i
                        if overlap > threshold:
                            G.add_edge(j, i, weight=overlap)
        if draw:
            import networkx as nx2

            pos = nx2.spring_layout(G)
            nx2.draw_networkx(G, pos, with_labels=True)
        return G

    def compute_filling(self):
        """Depth-parity filling assignment over the containment graph
        (reference svg_primitive.py:392-420): odd depth fills, even erases."""
        if not self.fill:
            return self
        G = self.overlap_graph()
        root_nodes = [i for i, d in G.in_degree() if d == 0]

        for root in root_nodes:
            if not self.svg_paths[root].closed:
                continue
            current = [(1, root)]
            while current:
                visited, neighbors = set(), set()
                for d, n in current:
                    self.svg_paths[n].set_filling(d != 0)
                    for n2 in G.neighbors(n):
                        if n2 not in visited:
                            same_orient = (
                                self.svg_paths[n2].is_clockwise()
                                == self.svg_paths[n].is_clockwise()
                            )
                            visited.add(n2)
                            neighbors.add((d + same_orient * 2 - 1, n2))
                G.remove_nodes_from([n for _, n in current])
                current = [(d, n) for d, n in neighbors if G.in_degree(n) == 0]
        return self
