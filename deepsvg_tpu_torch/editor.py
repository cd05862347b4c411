"""Headless vector-animation editor core, counterpart of
``deepsvg_tpu/editor.py`` (numpy and the port's svglib only).

The reference ships a Kivy editor (deepsvg/gui/main.py, 794 LoC) whose
interaction layer — tools, Bézier control-point editing, freehand sketch
digitization, timeline/keyframes, playback easing — is entangled with Kivy
widgets. This module re-implements that state machine WITHOUT a display
dependency, so it is scriptable and testable, and a thin Kivy/web front-end
can bind to it 1:1.

Reference map (citations into the reference editor, deepsvg/gui):
  ToolMode/DrawMode/LoopMode/PlaybackMode  state/state.py:7-34
  BezierSegment (control-point hit-test + drag)  main.py:222-318
  BezierPath (segment list, endpoint coupling, SVG round trip)  main.py:321-370
  Sketch (freehand points -> polyline path)  main.py:373-403
  Editor pen/pencil flows + path digitization  main.py:426-527 (DrawViewbox)
  Timeline frames/keyframes/selection  main.py:600-660
  Playback loop modes + ease pacing  main.py:85-129, utils.py:61-66

Coordinates: the canvas is the 256x256 viewbox with y UP (screen
convention), mirrored from SVG's y-down via ``flip_vertical``
(gui/utils.py:57-58) — preserved here so positions behave like the
reference editor's.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from .animate import DeepSVGProject, Frame, preprocess_svg_path
from .svglib.geom import Point
from .svglib.svg import SVG
from .svglib.svg_command import SVGCommandBezier, SVGCommandLine, SVGCommandMove
from .svglib.svg_path import SVGPath


# ---------------------------------------------------------------------------
# modes (state/state.py:7-34)
# ---------------------------------------------------------------------------

class ToolMode:
    MOVE = 0
    PEN = 1
    PENCIL = 2
    PLAY = 3


class DrawMode:
    STILL = 0
    DRAW = 1
    HOLDING_DOWN = 2


class LoopMode:
    NORMAL = 0
    REVERSE = 1
    PINGPONG = 2


class PlaybackMode:
    NORMAL = 0
    EASE = 1


class LoopOrientation:
    FORWARD = 1
    BACKWARD = -1


def dist(a, b) -> float:
    return math.hypot(a[0] - b[0], a[1] - b[1])


def flip_vertical(p) -> list:
    """Screen y-up <-> SVG y-down mirror (gui/utils.py:57-58)."""
    return [p[0], 255 - p[1]]


def easein_easeout(t: float) -> float:
    return t * t / (2.0 * (t * t - t) + 1.0)


def d_easein_easeout(t: float) -> float:
    return 3 * (1 - t) * t / (2 * t * t - 2 * t + 1) ** 2


# ---------------------------------------------------------------------------
# Bézier editing model (main.py:222-370)
# ---------------------------------------------------------------------------

class BezierSegment:
    """One editable segment: a line (p1->p2) or cubic (p1,q1,q2,p2)."""

    SELECT_DIST = 3.0

    def __init__(self):
        self.is_curved = True
        self.is_finished = True
        self.p1 = [0.0, 0.0]
        self.q1 = [0.0, 0.0]
        self.q2 = [0.0, 0.0]
        self.p2 = [0.0, 0.0]

    def clone(self) -> "BezierSegment":
        s = BezierSegment()
        s.is_curved = self.is_curved
        s.p1, s.q1 = list(self.p1), list(self.q1)
        s.q2, s.p2 = list(self.q2), list(self.p2)
        return s

    @staticmethod
    def line(p1, p2) -> "BezierSegment":
        s = BezierSegment()
        s.is_curved = False
        s.p1 = s.q1 = list(p1)
        s.p2 = s.q2 = list(p2)
        return s

    @staticmethod
    def bezier(p1, q1, q2, p2) -> "BezierSegment":
        s = BezierSegment()
        s.is_curved = True
        s.p1, s.q1, s.q2, s.p2 = list(p1), list(q1), list(q2), list(p2)
        return s

    def hit_test(self, pos) -> Optional[str]:
        """Which control point (if any) is within SELECT_DIST of ``pos``
        (main.py:258-268: lines expose only endpoints)."""
        keys = ["p1", "q1", "q2", "p2"] if self.is_curved else ["p1", "p2"]
        for key in keys:
            if dist(pos, getattr(self, key)) < self.SELECT_DIST:
                return key
        return None

    def set_point(self, key: str, pos):
        setattr(self, key, list(pos))


class BezierPath:
    """A sequence of segments whose shared endpoints stay welded while
    dragging (main.py:321-345)."""

    def __init__(self, segments: Optional[List[BezierSegment]] = None,
                 color=None, index: int = 0, selected: bool = False):
        self.segments: List[BezierSegment] = list(segments or [])
        self.color = color
        self.index = index
        self.selected = selected

    def clone(self) -> "BezierPath":
        return BezierPath([s.clone() for s in self.segments], self.color,
                          self.index, self.selected)

    def add_segment(self, segment: BezierSegment):
        self.segments.append(segment)

    def move(self, seg_idx: int, key: str, pos):
        """Move a control point; endpoint moves drag the welded neighbor's
        matching endpoint too (main.py:335-340)."""
        seg = self.segments[seg_idx]
        seg.set_point(key, pos)
        if key == "p1" and seg_idx > 0:
            self.segments[seg_idx - 1].set_point("p2", pos)
        elif key == "p2" and seg_idx < len(self.segments) - 1:
            self.segments[seg_idx + 1].set_point("p1", pos)

    def hit_test(self, pos) -> Optional[Tuple[int, str]]:
        for i, seg in enumerate(self.segments):
            key = seg.hit_test(pos)
            if key is not None:
                return i, key
        return None

    @staticmethod
    def from_svg_path(svg_path: SVGPath, color=None, index: int = 0,
                      selected: bool = False) -> "BezierPath":
        """SVG commands -> editable segments, y-flipped to screen space
        (main.py:346-358)."""
        segments = []
        for cmd in svg_path.path_commands:
            if isinstance(cmd, SVGCommandBezier):
                segments.append(BezierSegment.bezier(
                    flip_vertical(cmd.start_pos.tolist()),
                    flip_vertical(cmd.control1.tolist()),
                    flip_vertical(cmd.control2.tolist()),
                    flip_vertical(cmd.end_pos.tolist()),
                ))
            elif isinstance(cmd, SVGCommandLine):
                segments.append(BezierSegment.line(
                    flip_vertical(cmd.start_pos.tolist()),
                    flip_vertical(cmd.end_pos.tolist()),
                ))
        return BezierPath(segments, color=color, index=index, selected=selected)

    def to_svg_path(self) -> SVGPath:
        """Editable segments -> SVG path commands (main.py:360-370)."""
        cmds = []
        for seg in self.segments:
            if seg.is_curved:
                cmds.append(SVGCommandBezier(
                    Point(*flip_vertical(seg.p1)), Point(*flip_vertical(seg.q1)),
                    Point(*flip_vertical(seg.q2)), Point(*flip_vertical(seg.p2)),
                ))
            else:
                cmds.append(SVGCommandLine(
                    Point(*flip_vertical(seg.p1)), Point(*flip_vertical(seg.p2)),
                ))
        return SVGPath(cmds)


class Sketch:
    """Freehand stroke: a flat [x0, y0, x1, y1, ...] point list
    (main.py:373-403)."""

    def __init__(self, points=None, color=None):
        self.points: List[float] = list(points or [])
        self.color = color

    def extend(self, pos):
        self.points.extend([pos[0], pos[1]])

    def to_svg_path(self) -> SVGPath:
        pts = [Point(x, 255 - y)
               for x, y in zip(self.points[::2], self.points[1::2])]
        cmds = [SVGCommandMove(pts[0])] + [
            SVGCommandLine(p1, p2) for p1, p2 in zip(pts[:-1], pts[1:])
        ]
        return SVGPath.from_commands(cmds).path


# ---------------------------------------------------------------------------
# timeline (main.py:600-660)
# ---------------------------------------------------------------------------

class Timeline:
    """Frame strip with keyframe flags and a selection cursor."""

    def __init__(self):
        self.frames: List[bool] = []       # keyframe flag per frame
        self.selected_frame = -1

    @property
    def nb_frames(self) -> int:
        return len(self.frames)

    def add_frame(self, keyframe: bool = False) -> int:
        self.frames.append(keyframe)
        self.selected_frame = len(self.frames) - 1
        return self.selected_frame

    def make_keyframe(self, value: bool = True):
        if 0 <= self.selected_frame < len(self.frames):
            self.frames[self.selected_frame] = value

    def is_keyframe(self, idx: int) -> bool:
        return self.frames[idx]

    def select(self, idx: int):
        if not 0 <= idx < len(self.frames):
            raise IndexError(idx)
        self.selected_frame = idx


# ---------------------------------------------------------------------------
# the editor state machine (DrawViewbox + Header, main.py:85-129, 426-560)
# ---------------------------------------------------------------------------

class Editor:
    """Headless equivalent of the reference editor window.

    Every interaction is a method call instead of a Kivy touch event:

        ed = Editor()
        ed.select_tool(ToolMode.PENCIL)
        ed.stroke_down((10, 10)); ed.stroke_move((40, 80)); ...
        ed.stroke_up()                      # -> digitized Bézier path
        ed.select_tool(ToolMode.MOVE)
        grab = ed.touch_down((40, 80))      # grab a control point
        ed.touch_move((50, 90)); ed.touch_up()
    """

    def __init__(self, project: Optional[DeepSVGProject] = None):
        self.project = project or DeepSVGProject()
        self.timeline = Timeline()
        self.selected_tool = ToolMode.MOVE
        self.draw_mode = DrawMode.STILL
        self.loop_mode = LoopMode.PINGPONG
        self.loop_orientation = LoopOrientation.FORWARD
        self.playback_mode = PlaybackMode.EASE
        self.delay = 1 / 10.0
        self.modified = False
        self.clipboard: Optional[BezierPath] = None

        self.paths: List[BezierPath] = []   # paths of the selected frame
        self.current_path: Optional[BezierPath] = None
        self.current_sketch: Optional[Sketch] = None
        self._grab: Optional[Tuple[BezierPath, int, str]] = None

        if not self.project.frames:
            self.add_frame(keyframe=False)
        else:
            for f in self.project.frames:
                self.timeline.frames.append(bool(f.keyframe))
            self.timeline.selected_frame = 0
            self._load_frame(0)

    # -- frames -------------------------------------------------------------

    def add_frame(self, keyframe: bool = False) -> int:
        self._save_frame()
        idx = self.timeline.add_frame(keyframe)
        if idx >= len(self.project.frames):
            self.project.frames.append(Frame(idx, keyframe))
        self.paths, self.current_path = [], None
        return idx

    def select_frame(self, idx: int):
        self._save_frame()
        self.timeline.select(idx)
        self._load_frame(idx)

    def _frame_svg(self) -> SVG:
        groups = [p.to_svg_path().to_group() for p in self.paths]
        return SVG(groups, viewbox=self._viewbox())

    @staticmethod
    def _viewbox():
        from .svglib.geom import Bbox

        return Bbox(256)

    def _save_frame(self):
        idx = self.timeline.selected_frame
        if 0 <= idx < len(self.project.frames):
            self.project.frames[idx].svg = self._frame_svg()
            self.project.frames[idx].keyframe = self.timeline.frames[idx]

    def _load_frame(self, idx: int):
        frame = self.project.frames[idx]
        self.paths = []
        if frame.svg is not None:
            for i, group in enumerate(frame.svg.svg_path_groups):
                self.paths.append(BezierPath.from_svg_path(
                    group.path, index=i))
        self.current_path = None

    # -- tools --------------------------------------------------------------

    def select_tool(self, tool: int):
        self.selected_tool = tool
        self.draw_mode = DrawMode.STILL

    # pen: click-drag to place anchor+handles, move to preview, double-action
    # to finish (main.py:513-527, 288-318, 426-432)
    def pen_down(self, pos):
        assert self.selected_tool == ToolMode.PEN
        self.draw_mode = DrawMode.DRAW
        if self.current_path is None:
            self.current_path = BezierPath([], selected=True)
        seg = BezierSegment.line(pos, pos)
        seg.is_finished = False
        self.current_path.add_segment(seg)
        self.modified = True

    def pen_drag(self, pos):
        """Dragging after pen_down curves the new segment: the grab is on q1
        and p2 follows (main.py:294-303)."""
        seg = self.current_path.segments[-1]
        seg.is_curved = True
        seg.is_finished = False
        self.draw_mode = DrawMode.HOLDING_DOWN
        seg.set_point("q1", pos)
        seg.set_point("p2", pos)

    def pen_move(self, pos):
        """Hover after release: the unfinished segment's free end tracks the
        cursor (main.py:433-437)."""
        if self.draw_mode == DrawMode.DRAW and self.current_path is not None \
                and self.current_path.segments:
            seg = self.current_path.segments[-1]
            seg.set_point("p2", pos)
            seg.set_point("q2", pos)

    def pen_up(self):
        if self.current_path is not None and self.current_path.segments:
            self.current_path.segments[-1].is_finished = True
        self.draw_mode = DrawMode.DRAW

    def finish_path(self) -> Optional[BezierPath]:
        """Digitize the pen path (on_path_done, main.py:449-456)."""
        if self.current_path is None:
            return None
        raw = self.current_path.to_svg_path()
        self.current_path = None
        self.draw_mode = DrawMode.STILL
        return self._add_digitized(raw, force_smooth=False)

    # pencil: freehand stroke -> smooth-fit digitization (main.py:373-403,
    # 440-447)
    def stroke_down(self, pos):
        assert self.selected_tool == ToolMode.PENCIL
        self.current_sketch = Sketch()
        self.current_sketch.extend(pos)

    def stroke_move(self, pos):
        self.current_sketch.extend(pos)

    def stroke_up(self) -> BezierPath:
        sketch, self.current_sketch = self.current_sketch, None
        return self._add_digitized(sketch.to_svg_path(), force_smooth=True)

    def _add_digitized(self, raw_path: SVGPath, force_smooth: bool) -> BezierPath:
        svg_path = preprocess_svg_path(raw_path, force_smooth=force_smooth)
        path = BezierPath.from_svg_path(svg_path, index=len(self.paths),
                                        selected=True)
        for p in self.paths:
            p.selected = False
        self.paths.append(path)
        self.modified = True
        self.timeline.make_keyframe(True)
        return path

    def paste(self, path: Optional[BezierPath] = None) -> BezierPath:
        """Paste the clipboard (or given) path as a new layer; the pasted
        path becomes the exclusive selection (main.py:459-483:
        paste -> add_new_path -> sidebar.select)."""
        src = path or self.clipboard
        p = src.clone()
        p.index = len(self.paths)
        p.selected = True
        for q in self.paths:
            q.selected = False
        self.paths.append(p)
        self.modified = True
        self.timeline.make_keyframe(True)
        return p

    # control-point editing (MOVE tool; main.py:258-286)
    def touch_down(self, pos) -> bool:
        for path in self.paths:
            if not path.selected:
                continue
            hit = path.hit_test(pos)
            if hit is not None:
                self._grab = (path, hit[0], hit[1])
                self.modified = True
                return True
        return False

    def touch_move(self, pos):
        if self._grab is None:
            return
        path, seg_idx, key = self._grab
        path.move(seg_idx, key, pos)

    def touch_up(self):
        self._grab = None

    def select_path(self, idx: int):
        for p in self.paths:
            p.selected = p.index == idx

    # -- playback (main.py:85-114) -------------------------------------------

    def next_frame(self) -> Tuple[int, float]:
        """Advance the playback cursor one frame; returns (frame_idx, delay
        before the following advance) honoring loop mode and ease pacing."""
        tl = self.timeline
        n = tl.nb_frames
        if self.loop_mode == LoopMode.NORMAL:
            idx = (tl.selected_frame + 1) % n
        elif self.loop_mode == LoopMode.REVERSE:
            idx = (tl.selected_frame - 1) % n
        else:  # PINGPONG
            idx_tmp = tl.selected_frame + self.loop_orientation
            if not 0 <= idx_tmp < n:
                self.loop_orientation *= -1
                idx = (tl.selected_frame + self.loop_orientation) % n
            else:
                idx = idx_tmp
        tl.selected_frame = idx
        if self.playback_mode == PlaybackMode.EASE:
            t = idx / n
            delay = 2 * self.delay / (1 + d_easein_easeout(t))
        else:
            delay = self.delay
        return idx, delay

    # -- integration ---------------------------------------------------------

    def sync_project(self) -> DeepSVGProject:
        """Flush the edited frame + all keyframe flags into the project."""
        self._save_frame()
        for i, flag in enumerate(self.timeline.frames):
            if i < len(self.project.frames):
                self.project.frames[i].keyframe = flag
        return self.project

    def interpolate(self, session, cfg=None, **kw):
        """Fill in-between frames with the model (Header.interpolate,
        main.py:126-129 -> animate.compute_interpolation)."""
        from .animate import compute_interpolation

        self.sync_project()
        compute_interpolation(session, self.project, cfg=cfg, **kw)
        self.timeline.frames = [bool(f.keyframe) for f in self.project.frames]
        return self.project
