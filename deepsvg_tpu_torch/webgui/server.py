"""JSON-over-HTTP binding of the headless editor core.

The counterpart of ``deepsvg_tpu/webgui/server.py``. Maps every interaction
of the reference Kivy editor (deepsvg/gui/main.py:85-660) onto a small REST
surface over ``deepsvg_tpu_torch.editor.Editor``. The server owns ONE editor instance (the
reference app is single-window too); the browser client holds no state
beyond the last ``/api/state`` snapshot it rendered.

Endpoints (all POST bodies and responses are JSON; every mutating call
returns the full editor state so the client re-renders from truth):

    GET  /                    editor page
    GET  /api/state           editor snapshot
    POST /api/tool            {"tool": 0|1|2|3}         select_tool
    POST /api/pointer         {"type": "down|move|up", "pos": [x, y]}
                              dispatched by active tool (move/pen/pencil)
    POST /api/pen/finish      finish_path (double-click in the reference)
    POST /api/frame/add       {"keyframe": bool}
    POST /api/frame/select    {"index": i}
    POST /api/frame/keyframe  {"value": bool}
    POST /api/path/select     {"index": i}
    POST /api/path/copy       copy selected path to clipboard
    POST /api/path/paste      paste clipboard as new layer
    POST /api/playback        {"loop_mode"?, "playback_mode"?, "delay"?}
    POST /api/play/next       -> {"index", "delay"} (client schedules itself)
    POST /api/project/save    {"path"?}
    POST /api/project/load    {"path"}
    POST /api/export/gif      {"path"?}
    POST /api/interpolate     model in-betweens (requires --config/--weights;
                              with --config the session finetunes first, and a
                              session loaded without a dataset is refused)

Stdlib only — no flask/websockets — so the GUI runs anywhere the package
does.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from ..animate import DeepSVGProject
from ..editor import BezierPath, Editor, ToolMode

STATIC_DIR = Path(__file__).parent / "static"
_MIME = {".html": "text/html", ".js": "text/javascript", ".css": "text/css",
         ".svg": "image/svg+xml", ".png": "image/png"}


def _path_state(p: BezierPath) -> dict:
    return {
        "index": p.index,
        "selected": p.selected,
        "color": p.color,
        "segments": [
            {"is_curved": s.is_curved, "is_finished": s.is_finished,
             "p1": s.p1, "q1": s.q1, "q2": s.q2, "p2": s.p2}
            for s in p.segments
        ],
    }


class EditorAPI:
    """The server-side application: an editor + optional model session.

    Thread-safe: the HTTP server is threading, the editor is not — one lock
    serializes all editor access (interactions are sub-millisecond except
    digitization/interpolation, which the reference also runs blocking).
    """

    def __init__(self, project: Optional[DeepSVGProject] = None,
                 session=None, train_cfg=None):
        self.editor = Editor(project)
        self.session = session
        self.train_cfg = train_cfg
        self.lock = threading.RLock()

    # -- state ---------------------------------------------------------------

    def state(self) -> dict:
        ed = self.editor
        sk = ed.current_sketch
        return {
            "tool": ed.selected_tool,
            "draw_mode": ed.draw_mode,
            "loop_mode": ed.loop_mode,
            "playback_mode": ed.playback_mode,
            "delay": ed.delay,
            "modified": ed.modified,
            "has_session": self.session is not None,
            "has_clipboard": ed.clipboard is not None,
            "project_name": ed.project.name,
            "timeline": {
                "frames": list(ed.timeline.frames),
                "selected": ed.timeline.selected_frame,
            },
            "paths": [_path_state(p) for p in ed.paths],
            "current_path": _path_state(ed.current_path)
            if ed.current_path is not None else None,
            "sketch": list(sk.points) if sk is not None else None,
        }

    # -- dispatch ------------------------------------------------------------

    def pointer(self, kind: str, pos=None) -> None:
        """Route a pointer event by the active tool, mirroring the Kivy
        touch handlers (reference main.py:469-527)."""
        ed = self.editor
        tool = ed.selected_tool
        if tool == ToolMode.MOVE:
            if kind == "down":
                ed.touch_down(pos)
            elif kind == "move":
                ed.touch_move(pos)
            else:
                ed.touch_up()
        elif tool == ToolMode.PEN:
            if kind == "down":
                ed.pen_down(pos)
            elif kind == "drag":
                ed.pen_drag(pos)
            elif kind == "move":
                ed.pen_move(pos)
            else:
                ed.pen_up()
        elif tool == ToolMode.PENCIL:
            if kind == "down":
                ed.stroke_down(pos)
            elif kind in ("move", "drag"):
                if ed.current_sketch is not None:
                    ed.stroke_move(pos)
            else:
                if ed.current_sketch is not None:
                    ed.stroke_up()

    def handle(self, route: str, body: dict) -> dict:
        """Execute one API call; returns the JSON payload."""
        ed = self.editor
        with self.lock:
            if route == "state":
                return self.state()
            if route == "tool":
                ed.select_tool(int(body["tool"]))
            elif route == "pointer":
                self.pointer(body["type"], body.get("pos"))
            elif route == "pen/finish":
                ed.finish_path()
            elif route == "frame/add":
                ed.add_frame(bool(body.get("keyframe", False)))
            elif route == "frame/select":
                ed.select_frame(int(body["index"]))
            elif route == "frame/keyframe":
                ed.timeline.make_keyframe(bool(body.get("value", True)))
            elif route == "path/select":
                ed.select_path(int(body["index"]))
            elif route == "path/copy":
                sel = [p for p in ed.paths if p.selected]
                if sel:
                    ed.clipboard = sel[0].clone()
            elif route == "path/paste":
                if ed.clipboard is not None:
                    ed.paste()
            elif route == "playback":
                if "loop_mode" in body:
                    ed.loop_mode = int(body["loop_mode"])
                if "playback_mode" in body:
                    ed.playback_mode = int(body["playback_mode"])
                if "delay" in body:
                    ed.delay = float(body["delay"])
            elif route == "play/next":
                ed._save_frame()  # edits on the outgoing frame persist
                idx, delay = ed.next_frame()
                ed._load_frame(idx)
                return {"index": idx, "delay": delay, "state": self.state()}
            elif route == "project/save":
                ed.sync_project()
                if body.get("dir"):
                    ed.project.root_dir = body["dir"]
                if body.get("name"):
                    ed.project.name = body["name"]
                ed.project.save_project()
                ed.modified = False
                return {"saved": ed.project.filename, "state": self.state()}
            elif route == "project/load":
                project = DeepSVGProject()
                project.load_project(body["path"])
                self.editor = Editor(project)
            elif route == "export/gif":
                ed.sync_project()
                path = ed.project.export_to_gif(body.get("path"))
                return {"gif": str(path), "state": self.state()}
            elif route == "interpolate":
                if self.session is None:
                    raise ValueError(
                        "no model session loaded (start with --config/--weights)")
                ed.interpolate(self.session, cfg=self.train_cfg)
                ed._load_frame(ed.timeline.selected_frame)
            else:
                raise KeyError(route)
            return {"state": self.state()}


class _Handler(BaseHTTPRequestHandler):
    api: EditorAPI = None  # class attr, set by make_server

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, payload: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode())

    def do_GET(self):
        path = self.path.split("?")[0]
        if path == "/api/state":
            with self.api.lock:
                return self._send_json(200, self.api.state())
        if path == "/":
            path = "/index.html"
        rel = path.lstrip("/")
        if rel.startswith("static/"):
            rel = rel[len("static/"):]
        file = (STATIC_DIR / rel).resolve()
        if STATIC_DIR.resolve() in file.parents and file.is_file():
            ctype = _MIME.get(file.suffix, "application/octet-stream")
            return self._send(200, file.read_bytes(), ctype)
        self._send_json(404, {"error": "not found"})

    def do_POST(self):
        if not self.path.startswith("/api/"):
            return self._send_json(404, {"error": "not found"})
        route = self.path[len("/api/"):]
        length = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
            result = self.api.handle(route, body)
        except KeyError:
            return self._send_json(404, {"error": f"unknown route {route}"})
        except Exception as exc:  # surfaced to the UI toast
            return self._send_json(400, {"error": str(exc)})
        self._send_json(200, result)


def make_server(host="127.0.0.1", port=0, project=None, session=None,
                train_cfg=None) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``port=0`` picks a free one."""
    api = EditorAPI(project, session, train_cfg)
    handler = type("Handler", (_Handler,), {"api": api})
    server = ThreadingHTTPServer((host, port), handler)
    server.api = api
    return server


def run(argv=None):
    """The ``deepsvg-tpu-torch-gui`` console script: serve the editor, with a
    model session on the CUDA card (``--device cpu`` for the CPU) when
    ``--config`` and ``--weights`` are given."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8640)
    ap.add_argument("--project", help="project manifest (.json) to open")
    ap.add_argument("--config", help="config module for model features "
                                     "(e.g. deepsvg_tpu_torch.configs.hierarchical_ordered)")
    ap.add_argument("--weights", help="checkpoint for the model session")
    ap.add_argument("--device", default=None,
                    help="the session's device (default: the CUDA card)")
    args = ap.parse_args(argv)

    project = None
    if args.project:
        project = DeepSVGProject()
        project.load_project(args.project)

    session = train_cfg = None
    if args.config:
        from ..inference import load_session
        from ..training.config import load_config

        train_cfg = load_config(args.config, 1)
        session = load_session(args.config, args.weights, device=args.device)

    server = make_server(args.host, args.port, project, session, train_cfg)
    print(f"deepsvg-tpu-torch editor: http://{args.host}:{server.server_address[1]}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    run()
