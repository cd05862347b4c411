"""Animation projects: keyframes, finetuning, interpolation, GIF export,
counterpart of ``deepsvg_tpu/animate.py``.

A timeline of frames with keyframes, per-project SVG persistence,
finetuning the model on the user's keyframes via :class:`SVGFinetuneDataset`,
and filling in-between frames by latent interpolation; the headless model
layer of the editor. The finetune trains a copy of the session's model and
returns a new session: the live session keeps its weights. GIF export
renders with matplotlib and PIL, imported when it runs.
"""
from __future__ import annotations

import copy
import json
import os
import uuid
from typing import List, Optional

from .inference import InferenceSession
from .svglib.geom import Bbox
from .svglib.svg import SVG
from .svglib.svg_path import SVGPath


def preprocess_svg_path(svg_path: SVGPath, force_smooth: bool = False) -> SVGPath:
    """Digitize a freehand path: normalize -> canonicalize -> dedupe ->
    smooth-fit -> renormalize -> quantize."""
    svg = SVG([svg_path.to_group()], viewbox=Bbox(256)).normalize()
    svg.canonicalize()
    svg.filter_duplicates()
    svg = svg.simplify_heuristic(force_smooth=force_smooth)
    svg.normalize()
    svg.numericalize(256)
    return svg[0].path


class Frame:
    """One timeline frame."""

    def __init__(self, index: int, keyframe: bool = False, svg: Optional[SVG] = None):
        self.index = index
        self.keyframe = keyframe
        self.svg = svg if svg is not None else SVG([], viewbox=Bbox(256))

    def to_dict(self):
        return {"index": self.index, "keyframe": self.keyframe}

    @staticmethod
    def load_dict(d):
        return Frame(d["index"], d["keyframe"])


class LoopMode:
    NORMAL = 0
    REVERSE = 1
    PINGPONG = 2


class DeepSVGProject:
    """Persistent animation project: JSON manifest + one SVG per frame."""

    def __init__(self, name: str = "Title", root_dir: str = "."):
        self.name = name
        self.uid = str(uuid.uuid4())
        self.root_dir = root_dir
        self.frames: List[Frame] = [Frame(index=0)]

    @property
    def filename(self):
        return os.path.join(self.root_dir, f"{self.uid}.json")

    @property
    def base_dir(self):
        d = os.path.join(self.root_dir, self.uid)
        os.makedirs(d, exist_ok=True)
        return d

    def load_project(self, file_path: str):
        with open(file_path) as f:
            data = json.load(f)
        self.name = data["name"]
        self.uid = data["uid"]
        self.root_dir = os.path.dirname(file_path) or "."
        self.frames = [Frame.load_dict(fr) for fr in data["frames"]]
        for frame in self.frames:
            frame.svg = SVG.load_svg(os.path.join(self.base_dir, f"{frame.index}.svg"))

    def save_project(self):
        with open(self.filename, "w") as f:
            json.dump(
                {"name": self.name, "uid": self.uid,
                 "frames": [fr.to_dict() for fr in self.frames]}, f,
            )
        for frame in self.frames:
            frame.svg.save_svg(os.path.join(self.base_dir, f"{frame.index}.svg"))

    def export_to_gif(self, file_path: Optional[str] = None, frame_duration: float = 0.1,
                      loop_mode: int = LoopMode.NORMAL, width: int = 200):
        """Render every frame and write an animated GIF (needs matplotlib
        and PIL)."""
        imgs = [fr.svg.copy().normalize().render(width=width) for fr in self.frames]
        if loop_mode == LoopMode.REVERSE:
            imgs = imgs[::-1]
        elif loop_mode == LoopMode.PINGPONG:
            imgs = imgs + imgs[::-1]
        if file_path is None:
            file_path = os.path.join(self.root_dir, f"{self.uid}.gif")
        imgs[0].save(
            file_path, save_all=True, append_images=imgs[1:],
            duration=int(frame_duration * 1000), loop=0,
        )
        return file_path


def finetune_model(session: InferenceSession, svg_list: List[SVG], cfg,
                   nb_augmentations: int = 3500, max_steps: Optional[int] = None,
                   log_every: int = 20) -> InferenceSession:
    """Finetune a copy of the session's model on user keyframes: a train
    loop of ``training/trainer.py:train_step`` over an SVGFinetuneDataset of
    the keyframes, on the session's device. Returns a new session; the
    given one keeps its weights. A session without a dataset is refused
    (``SVGFinetuneDataset``), where the JAX package fails on its first
    item."""
    from .data.dataset import SVGFinetuneDataset
    from .data.loader import DataLoader, to_device
    from .training.trainer import create_train_state, train_step

    finetune_ds = SVGFinetuneDataset(
        session.dataset, svg_list, frac=1.0, nb_augmentations=nb_augmentations
    )
    loader = DataLoader(
        finetune_ds, batch_size=cfg.batch_size, shuffle=True, drop_last=False,
        num_workers=cfg.loader_num_workers,
    )
    steps_per_epoch = max(len(loader), 1)
    optimizer = cfg.make_optimizer(steps_per_epoch)
    model_args = cfg.model_args
    device = session.device

    model = copy.deepcopy(session.model)
    state = create_train_state(model, optimizer, init=False)
    print("Finetuning...")
    # the loader's second epoch: the JAX package draws its first batch (the
    # state's template) from the first, then loops over the next
    for step, batch in enumerate(loader.epoch_batches(2)):
        weights = cfg.get_weights(step, 0)
        batch = to_device(batch, device, keys=set(model_args))
        state, res = train_step(state, batch, weights, optimizer, model_args)
        if step % log_every == 0:
            print(f"Step {step}: loss: {float(res['loss']):.4f}")
        if max_steps is not None and step + 1 >= max_steps:
            break
    print("Finetuning done.")
    return InferenceSession(model, dataset=session.dataset, cfg=cfg)


def compute_interpolation(session: InferenceSession, project: DeepSVGProject,
                          cfg=None, finetune: bool = True, **finetune_kwargs):
    """Fill non-keyframe frames by latent interpolation between consecutive
    keyframes (after finetuning on the keyframes when ``cfg`` is given).
    Returns the session that decoded them."""
    keyframe_ids = [i for i, fr in enumerate(project.frames) if fr.keyframe]
    if len(keyframe_ids) < 2:
        return session

    if finetune and cfg is not None:
        svgs = [project.frames[i].svg for i in keyframe_ids]
        session = finetune_model(session, svgs, cfg, **finetune_kwargs)

    for i1, i2 in zip(keyframe_ids[:-1], keyframe_ids[1:]):
        n_between = i2 - i1 - 1
        if n_between == 0:
            continue
        svgs = session.interpolate_svg(
            project.frames[i1].svg, project.frames[i2].svg, n=n_between, ease=False
        )
        for di, svg in enumerate(svgs, 1):
            project.frames[i1 + di] = Frame(i1 + di, keyframe=False, svg=svg)
    return session
