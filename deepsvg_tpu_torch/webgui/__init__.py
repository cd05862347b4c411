"""Browser-based front-end for the vector-animation editor, counterpart of
``deepsvg_tpu/webgui``.

The display chrome over the headless editor core
(``deepsvg_tpu_torch.editor``): a zero-dependency HTTP server (stdlib
``http.server``) exposing the editor as a JSON API, plus a canvas UI (static
HTML/JS) that binds pointer events to it 1:1 — pen/pencil/move tools, Bézier
control-point editing, timeline with keyframes, ease-paced playback, model
interpolation (on the CUDA card) and GIF export (where matplotlib and PIL
are installed).

Run::

    python -m deepsvg_tpu_torch.webgui [--port 8640] [--project file.json]
        [--config deepsvg_tpu_torch.configs.hierarchical_ordered --weights ckpt]
        [--device cpu]

and open http://localhost:8640/.
"""
from .server import EditorAPI, make_server, run

__all__ = ["EditorAPI", "make_server", "run"]
