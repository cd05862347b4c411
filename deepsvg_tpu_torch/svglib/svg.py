"""SVG document: parsing, canonicalization pipeline, tensor bridge, rendering.

Reference: deepsvg/svglib/svg.py. Differences from the reference's
external-library choices (all unavailable in this environment, SURVEY.md §2):

- rasterization: matplotlib Agg (native cubic-Bézier path support) instead of
  cairosvg;
- polygon booleans for overlap/filling: raster occupancy grids
  (svg_path.PolygonGrid) instead of shapely/GEOS;
- GIF export: PIL ``save(append_images=...)`` instead of moviepy.
"""
from __future__ import annotations

import io
import math
import random
from typing import List, Optional, Union
from xml.dom import expatbuilder

import numpy as np

from .geom import Angle, Bbox, Point, union_bbox
from .svg_command import SVGCommandBezier, SVGCommandLine
from .svg_path import Filling, Orientation, PolygonGrid, SVGPath


def SVGCommandLineLike(move_command) -> SVGCommandLine:
    """A visible line along a moveto's pen travel (for animation frames)."""
    return SVGCommandLine(move_command.start_pos.copy(), move_command.end_pos.copy())
from .svg_primitive import (
    SVGCircle,
    SVGEllipse,
    SVGLine,
    SVGPathGroup,
    SVGPolygon,
    SVGPolyline,
    SVGRectangle,
)

Num = Union[int, float]


class SVG:
    def __init__(self, svg_path_groups: List[SVGPathGroup], viewbox: Optional[Bbox] = None):
        if viewbox is None:
            viewbox = Bbox(24)
        self.svg_path_groups = svg_path_groups
        self.viewbox = viewbox

    # --- structure -------------------------------------------------------
    def __add__(self, other: "SVG") -> "SVG":
        svg = self.copy()
        svg.svg_path_groups.extend(other.svg_path_groups)
        return svg

    @property
    def paths(self):
        for group in self.svg_path_groups:
            for path in group.svg_paths:
                yield path

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            i, j = idx
            return self.svg_path_groups[i][j]
        return self.svg_path_groups[idx]

    def __len__(self):
        return len(self.svg_path_groups)

    def empty(self) -> bool:
        return len(self.svg_path_groups) == 0

    def total_length(self):
        return sum(g.total_len() for g in self.svg_path_groups)

    @property
    def start_pos(self) -> Point:
        return Point(0.0)

    @property
    def end_pos(self) -> Point:
        if not self.svg_path_groups:
            return Point(0.0)
        return self.svg_path_groups[-1].end_pos

    def copy(self) -> "SVG":
        return SVG([g.copy() for g in self.svg_path_groups], self.viewbox.copy())

    # --- parsing ---------------------------------------------------------
    @staticmethod
    def load_svg(file_path: str) -> "SVG":
        with open(file_path, "r") as f:
            return SVG.from_str(f.read())

    @staticmethod
    def from_str(svg_str: str) -> "SVG":
        svg_path_groups = []
        dom = expatbuilder.parseString(svg_str, False)
        root = dom.getElementsByTagName("svg")[0]

        viewbox = Bbox(*map(float, root.getAttribute("viewBox").split(" ")))

        primitives = {
            "path": SVGPath,
            "rect": SVGRectangle,
            "circle": SVGCircle,
            "ellipse": SVGEllipse,
            "line": SVGLine,
            "polyline": SVGPolyline,
            "polygon": SVGPolygon,
        }
        for tag, cls in primitives.items():
            for x in dom.getElementsByTagName(tag):
                svg_path_groups.append(cls.from_xml(x))
        return SVG(svg_path_groups, viewbox)

    @staticmethod
    def load_splineset(spline_str: str, width, height, add_closing=True) -> "SVG":
        """FontForge SplineSet import (reference svg.py:77-116)."""
        if "SplineSet" not in spline_str:
            raise ValueError("Not a SplineSet")
        spline = spline_str[
            spline_str.index("SplineSet") + 10 : spline_str.index("EndSplineSet")
        ]
        svg_str = SVG._spline_to_svg_str(spline, height)
        if not svg_str:
            raise ValueError("Empty SplineSet")
        group = SVGPath.from_str(svg_str, add_closing=add_closing)
        return SVG([group], viewbox=Bbox(width, height))

    @staticmethod
    def _spline_to_svg_str(spline_str: str, height, replace_with_prev=False) -> str:
        path, prev_xy = [], []
        for line in spline_str.splitlines():
            if not line:
                continue
            tokens = line.split(" ")
            cmd = tokens[-2]
            if cmd not in "cml":
                raise ValueError(f"Command not recognized: {cmd}")
            args = [float(x) for x in tokens[:-2] if x]
            if replace_with_prev and cmd in "c":
                args[:2] = prev_xy
            prev_xy = args[-2:]
            # flip y (font coords are y-up)
            coords = [str(height - a) if i % 2 == 1 else str(a) for i, a in enumerate(args)]
            path.extend([cmd.upper()] + coords)
        return " ".join(path)

    # --- tensor bridge ---------------------------------------------------
    def to_tensor(self, concat_groups=True, PAD_VAL=-1):
        tensors = [g.to_tensor(PAD_VAL=PAD_VAL) for g in self.svg_path_groups]
        if concat_groups:
            return np.concatenate(tensors, axis=0)
        return tensors

    def to_fillings(self):
        return [g.path.filling for g in self.svg_path_groups]

    @staticmethod
    def from_tensor(tensor, viewbox: Optional[Bbox] = None, allow_empty=False) -> "SVG":
        if viewbox is None:
            viewbox = Bbox(24)
        return SVG([SVGPath.from_tensor(tensor, allow_empty=allow_empty)], viewbox=viewbox)

    @staticmethod
    def from_tensors(tensors, viewbox: Optional[Bbox] = None, allow_empty=False) -> "SVG":
        if viewbox is None:
            viewbox = Bbox(24)
        return SVG(
            [SVGPath.from_tensor(t, allow_empty=allow_empty) for t in tensors],
            viewbox=viewbox,
        )

    # --- output ----------------------------------------------------------
    def __repr__(self):
        groups = ",\n".join(f"\t{g}" for g in self.svg_path_groups)
        return f"SVG[{self.viewbox}](\n{groups}\n)"

    def to_str(self, fill=False, with_markers=False, *args, **kwargs) -> str:
        markers = (
            '<defs><marker id="arrow" viewBox="0 0 10 10" markerWidth="4" markerHeight="4"'
            ' refX="0" refY="3" orient="auto" markerUnits="strokeWidth">'
            '<path d="M0,0 L0,6 L9,3 z" fill="#f00" /></marker></defs>'
            if with_markers else ""
        )
        body = "\n".join(
            g.to_str(fill=fill, with_markers=with_markers) for g in self.svg_path_groups
        )
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" viewBox="{self.viewbox.to_str()}"'
            f' height="200px" width="200px">{markers}{body}</svg>'
        )

    def save_svg(self, file_path: str):
        with open(file_path, "w") as f:
            f.write(self.to_str())

    def save_png(self, file_path: str, width=200):
        self.render(width=width).save(file_path)

    def render(self, width: int = 200, fill: Optional[bool] = None):
        """Rasterize to a PIL image via matplotlib Agg (cairosvg replacement).

        Respects per-group color/fill/stroke and ERASE filling (drawn in
        background color on top, emulating even-odd erase).
        """
        import matplotlib
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure
        from matplotlib.patches import PathPatch
        from matplotlib.path import Path as MplPath
        from PIL import Image

        fig = Figure(figsize=(width / 100, width / 100), dpi=100)
        canvas = FigureCanvasAgg(fig)
        ax = fig.add_axes([0, 0, 1, 1])
        ax.set_xlim(self.viewbox.xy.x, self.viewbox.xy2.x)
        ax.set_ylim(self.viewbox.xy2.y, self.viewbox.xy.y)  # svg y-axis down
        ax.axis("off")

        for group in self.svg_path_groups:
            verts, codes = [], []
            for path in group.svg_paths:
                verts.append(path.start_pos.tolist())
                codes.append(MplPath.MOVETO)
                for c in path.path_commands:
                    if isinstance(c, SVGCommandBezier):
                        verts += [c.control1.tolist(), c.control2.tolist(), c.end_pos.tolist()]
                        codes += [MplPath.CURVE4] * 3
                    else:
                        verts.append(c.end_pos.tolist())
                        codes.append(MplPath.LINETO)
                if path.closed:
                    verts.append(path.start_pos.tolist())
                    codes.append(MplPath.CLOSEPOLY)
            if not verts:
                continue
            do_fill = group.fill if fill is None else fill
            erase = group.path.filling == Filling.ERASE
            color = "white" if erase else (group.color if group.color != "black" or do_fill else "black")
            patch = PathPatch(
                MplPath(verts, codes),
                fill=do_fill,
                facecolor=color if do_fill else "none",
                edgecolor="none" if do_fill else color,
                linewidth=float(group.stroke_width) * 100 / 24 if not do_fill else 0,
                alpha=float(group.opacity),
            )
            ax.add_patch(patch)

        canvas.draw()
        buf = np.asarray(canvas.buffer_rgba())
        return Image.fromarray(buf).convert("RGB")

    def draw(self, fill=False, file_path=None, do_display=False, return_png=False,
             width=200, **kwargs):
        """Render and optionally save/display (reference svg.py:175-204).

        ``do_display`` shows inline in IPython when available (no-op
        otherwise); defaults to False in this library since headless use is
        the norm.
        """
        if file_path is not None:
            if file_path.endswith(".svg"):
                self.save_svg(file_path)
            elif file_path.endswith(".png"):
                self.save_png(file_path, width=width)
            else:
                raise ValueError(f"Unsupported extension: {file_path}")

        if do_display:
            try:
                import IPython.display as ipd

                ipd.display(ipd.SVG(self.to_str(fill=fill)))
            except Exception:
                pass

        if return_png:
            return self.render(width=width)

    def draw_colored(self, *args, **kwargs):
        return self.copy().normalize().split_paths().set_color("random").draw(*args, **kwargs)

    # --- transforms ------------------------------------------------------
    def _apply_to_paths(self, method, *args, **kwargs):
        for g in self.svg_path_groups:
            getattr(g, method)(*args, **kwargs)
        return self

    def translate(self, vec: Point):
        return self._apply_to_paths("translate", vec)

    def rotate(self, angle: Angle, center: Optional[Point] = None):
        if center is None:
            center = self.viewbox.center
        self.translate(-self.viewbox.center)
        self._apply_to_paths("rotate", angle)
        self.translate(center)
        return self

    def zoom(self, factor, center: Optional[Point] = None):
        if center is None:
            center = self.viewbox.center
        self.translate(-self.viewbox.center)
        self._apply_to_paths("scale", factor)
        self.translate(center)
        return self

    def normalize(self, viewbox: Optional[Bbox] = None):
        if viewbox is None:
            viewbox = Bbox(24)
        scale_factor = viewbox.size.min() / self.viewbox.size.max()
        self.zoom(scale_factor, viewbox.center)
        self.viewbox = viewbox
        return self

    def numericalize(self, n=256):
        self.normalize(viewbox=Bbox(n))
        return self._apply_to_paths("numericalize", n)

    def fill_(self, fill=True):
        return self._apply_to_paths("fill_", fill)

    def set_color(self, color):
        colors = [
            "deepskyblue", "lime", "deeppink", "gold", "coral", "darkviolet",
            "royalblue", "darkmagenta", "teal", "gold", "green", "maroon",
            "aqua", "grey", "steelblue", "lime", "orange",
        ]
        if color == "random_random":
            random.shuffle(colors)
        if isinstance(color, list):
            colors = color
        for i, g in enumerate(self.svg_path_groups):
            if color in ("random", "random_random") or isinstance(color, list):
                g.color = colors[i % len(colors)]
            else:
                g.color = color
        return self

    # --- canonicalization pipeline ---------------------------------------
    def to_path(self):
        self.svg_path_groups = [g.to_path() for g in self.svg_path_groups]
        return self

    def simplify_arcs(self):
        return self._apply_to_paths("simplify_arcs")

    def filter_consecutives(self):
        return self._apply_to_paths("filter_consecutives")

    def filter_duplicates(self):
        return self._apply_to_paths("filter_duplicates")

    def filter_empty(self):
        self._apply_to_paths("filter_empty")
        self.svg_path_groups = [g for g in self.svg_path_groups if g.svg_paths]
        return self

    def split_paths(self):
        groups = []
        for g in self.svg_path_groups:
            groups.extend(g.split_paths())
        self.svg_path_groups = groups
        return self

    def merge_groups(self):
        first = self.svg_path_groups[0]
        for g in self.svg_path_groups[1:]:
            first.svg_paths.extend(g.svg_paths)
        self.svg_path_groups = [first]
        return self

    def drop_z(self):
        return self._apply_to_paths("drop_z")

    def recompute_origins(self):
        origin = self.start_pos
        for g in self.svg_path_groups:
            g.set_origin(origin.copy())
            origin = g.end_pos
        return self

    def reorder(self):
        return self._apply_to_paths("reorder")

    def canonicalize(self, normalize=False):
        """The canonical order/orientation pipeline (reference svg.py:333-349)."""
        self.to_path().simplify_arcs()
        if normalize:
            self.normalize()
        self.split_paths()
        self.filter_consecutives()
        self.filter_empty()
        self._apply_to_paths("reorder")
        self.svg_path_groups = sorted(
            self.svg_path_groups, key=lambda g: g.start_pos.tolist()[::-1]
        )
        self._apply_to_paths("canonicalize")
        self.recompute_origins()
        self.drop_z()
        return self

    def canonicalize_with_fillings(self, normalize=False):
        """canonicalize + filling inference (reference ``canonicalize_new``)."""
        self.to_path().simplify_arcs()
        self.compute_filling()
        if normalize:
            self.normalize()
        self.split_paths()
        self.filter_consecutives()
        self.filter_empty()
        self._apply_to_paths("reorder")
        self.svg_path_groups = sorted(
            self.svg_path_groups, key=lambda g: g.start_pos.tolist()[::-1]
        )
        self._apply_to_paths("canonicalize")
        self.recompute_origins()
        self.drop_z()
        return self

    def compute_filling(self):
        return self._apply_to_paths("compute_filling")

    # --- simplification ---------------------------------------------------
    def simplify(self, tolerance=0.1, epsilon=0.1, angle_threshold=179.0, force_smooth=False):
        self._apply_to_paths(
            "simplify", tolerance=tolerance, epsilon=epsilon,
            angle_threshold=angle_threshold, force_smooth=force_smooth,
        )
        self.recompute_origins()
        return self

    def simplify_heuristic(self, tolerance=0.1, force_smooth=False):
        """split(2) -> simplify -> split(7.5) (reference svg.py:414-417)."""
        return (
            self.copy()
            .split(max_dist=2, include_lines=False)
            .simplify(tolerance=tolerance, epsilon=0.2, angle_threshold=150,
                      force_smooth=force_smooth)
            .split(max_dist=7.5)
        )

    def split(self, n=None, max_dist=None, include_lines=True):
        return self._apply_to_paths("split", n=n, max_dist=max_dist, include_lines=include_lines)

    def reverse(self):
        return self._apply_to_paths("reverse")

    def reverse_non_closed(self):
        return self._apply_to_paths("reverse_non_closed")

    def duplicate_extremities(self):
        return self._apply_to_paths("duplicate_extremities")

    # --- misc -------------------------------------------------------------
    def bbox(self):
        return union_bbox([g.bbox() for g in self.svg_path_groups])

    def to_points(self, sort=True) -> np.ndarray:
        points = np.concatenate([g.to_points() for g in self.svg_path_groups])
        if sort:
            ind = np.lexsort((points[:, 0], points[:, 1]))
            points = points[ind]
            keep = np.append([True], np.any(np.diff(points, axis=0), 1))
            points = points[keep]
        return points

    def permute(self, indices=None):
        if indices is not None:
            self.svg_path_groups = [self.svg_path_groups[i] for i in indices]
        return self

    def add_path_group(self, group: SVGPathGroup):
        group.set_origin(self.end_pos.copy())
        self.svg_path_groups.append(group)
        return self

    def add_path_groups(self, groups: List[SVGPathGroup]):
        for g in groups:
            self.add_path_group(g)
        return self

    # --- document-level overlap ------------------------------------------
    def overlap_graph(self, threshold=0.95, draw=False):
        """Directed overlap graph between groups (reference svg.py:493-513)."""
        import networkx as nx

        G = nx.DiGraph()
        bbox = self.bbox() or self.viewbox
        grid = PolygonGrid(bbox)
        masks = []
        for g in self.svg_path_groups:
            m = np.zeros(len(grid.points), dtype=bool)
            for p in g.svg_paths:
                m |= p.to_polygon_mask(grid)
            masks.append(m)

        for i, mask_i in enumerate(masks):
            G.add_node(i)
            if self.svg_path_groups[i].path.filling != Filling.OUTLINE:
                area_i = mask_i.sum()
                if area_i == 0:
                    continue
                for j, mask_j in enumerate(masks):
                    if i != j and self.svg_path_groups[j].path.filling == Filling.FILL:
                        overlap = (mask_i & mask_j).sum() / area_i
                        if overlap > threshold:
                            G.add_edge(j, i, weight=overlap)
        return G

    def group_overlapping_paths(self) -> "SVG":
        """Group each FILL path with the ERASE paths it contains
        (reference svg.py:515-553)."""
        G = self.overlap_graph()
        path_groups = []
        root_nodes = [i for i, d in G.in_degree() if d == 0]

        for root in root_nodes:
            if self[root].path.filling == Filling.FILL:
                current = [root]
                while current:
                    n = current.pop(0)
                    fill_neighbors, erase_neighbors = [], []
                    for m in G.neighbors(n):
                        if G.in_degree(m) == 1:
                            if self[m].path.filling == Filling.ERASE:
                                erase_neighbors.append(m)
                            else:
                                fill_neighbors.append(m)
                    G.remove_node(n)

                    group = SVGPathGroup(
                        [self[n].path.copy().set_orientation(Orientation.CLOCKWISE)], fill=True
                    )
                    for m in erase_neighbors:
                        group.append(
                            self[m].path.copy().set_orientation(Orientation.COUNTER_CLOCKWISE)
                        )
                    G.remove_nodes_from(erase_neighbors)
                    path_groups.append(group)
                    current.extend(fill_neighbors)

        for g in self.svg_path_groups:
            if g.path.filling == Filling.OUTLINE:
                path_groups.append(g)
        return SVG(path_groups)

    # --- animation --------------------------------------------------------
    def to_frames(self, color="grey", width=200):
        """Progressive-drawing frame sequence as PIL images (replaces the
        reference's moviepy clip pipeline, svg.py:366-378)."""
        from .svg_command import SVGCommandMove

        frames = [SVG([], self.viewbox.copy()).render(width=width)]
        drawn: List = []
        for svg_path in self.paths:
            for command in svg_path.all_commands():
                groups = []
                done = [c for c in drawn if not isinstance(c, SVGCommandMove)]
                if done:
                    groups.append(SVGPath(done).to_group(color=color))
                if isinstance(command, SVGCommandMove):
                    # moves render as a teal pen-travel line (reference draws
                    # them dashed, svg_path.py:330-332)
                    current = SVGPath(
                        [SVGCommandLineLike(command)]
                    ).to_group(color="teal", dasharray=0.5)
                else:
                    current = SVGPath([command]).to_group(color="red")
                groups.append(current)
                frames.append(SVG(groups, self.viewbox.copy()).render(width=width))
                drawn.append(command)
        frames.append(self.render(width=width))
        return frames

    def animate(self, file_path=None, frame_duration=0.1, do_display=False, width=200):
        """Progressive-draw GIF (reference svg.py:380-390)."""
        frames = self.to_frames(width=width)
        if file_path is not None:
            frames[0].save(
                file_path, save_all=True, append_images=frames[1:],
                duration=int(frame_duration * 1000), loop=0,
            )
        if do_display:
            try:
                import IPython.display as ipd

                ipd.display(ipd.Image(filename=file_path))
            except Exception:
                pass
        return frames

    # --- canonical shapes -------------------------------------------------
    @staticmethod
    def unit_circle() -> "SVG":
        d = 2 * (math.sqrt(2) - 1) / 3
        circle = SVGPath(
            [
                SVGCommandBezier(Point(0.5, 0.0), Point(0.5 + d, 0.0), Point(1.0, 0.5 - d), Point(1.0, 0.5)),
                SVGCommandBezier(Point(1.0, 0.5), Point(1.0, 0.5 + d), Point(0.5 + d, 1.0), Point(0.5, 1.0)),
                SVGCommandBezier(Point(0.5, 1.0), Point(0.5 - d, 1.0), Point(0.0, 0.5 + d), Point(0.0, 0.5)),
                SVGCommandBezier(Point(0.0, 0.5), Point(0.0, 0.5 - d), Point(0.5 - d, 0.0), Point(0.5, 0.0)),
            ]
        ).to_group()
        return SVG([circle], viewbox=Bbox(1))

    @staticmethod
    def unit_square() -> "SVG":
        return SVG([SVGPath.from_str("m 0,0 h1 v1 h-1 v-1")], viewbox=Bbox(1))
