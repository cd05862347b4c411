"""The editor's model-facing API under one entry point, counterpart of
``deepsvg_tpu/gui.py``: the headless equivalents of the reference GUI's
encode / decode / interpolate / finetune and project functions.

    from deepsvg_tpu_torch import gui
    session = gui.load_session("deepsvg_tpu_torch.configs.hierarchical_ordered", weights)
    z = gui.encode_svg(session, svg)
    frames = gui.interpolate_svg(session, svg1, svg2, n=10)
    gui.compute_interpolation(session, project, cfg=cfg)

``deepsvg_tpu_torch.editor`` is the interaction core and
``deepsvg_tpu_torch.webgui`` its browser front-end.
"""
from __future__ import annotations

from .animate import (
    DeepSVGProject,
    Frame,
    LoopMode,
    compute_interpolation,
    finetune_model,
    preprocess_svg_path,
)
from .inference import InferenceSession, easein_easeout, load_session


def encode_svg(session: InferenceSession, svg):
    """SVG -> latent."""
    return session.encode_svg(svg)


def decode(session: InferenceSession, z, **kwargs):
    """Latent -> SVG."""
    return session.decode_one(z, **kwargs)


def interpolate_svg(session: InferenceSession, svg1, svg2, n: int = 10,
                    ease: bool = True):
    """Latent-interpolated in-betweens."""
    return session.interpolate_svg(svg1, svg2, n=n, ease=ease)


__all__ = [
    "DeepSVGProject", "Frame", "LoopMode", "InferenceSession",
    "compute_interpolation", "decode", "easein_easeout", "encode_svg",
    "finetune_model", "interpolate_svg", "load_session", "preprocess_svg_path",
]
