"""The port's apps against the JAX package's, on the CPU: ``InferenceSession``
and ``load_session``, the animation project and the finetune, the headless
editor and the web GUI over HTTP.

One small model of the flagship's architecture (two stages, one-shot, no
VAE: G=3 paths of S=6 commands, d_model 32, 4 heads, one layer a stack),
initialised in the port from a seed and handed to the JAX model (XLA path)
through the weight bridge (``to_flax_params``); a label-conditioned twin
(5 classes). The disk fixture (tensor pickles and a meta CSV written with
``csv``) is written by the tests from a numpy seed. Held:

- latents within 1e-5 (``encode``, ``encode_svg``, ``encode_icon``,
  ``latent_direction``; labelled ``encode``), the interpolation's latents
  equal, and the decodes' ids and SVG text equal (``decode``,
  ``interpolate``, ``apply_direction``, the labelled decode of a given z);
  the token and label refusals with the JAX package's messages;
- ``load_session`` from flax msgpack weights and from a training checkpoint
  of the port, and its refusal of other files;
- ``finetune_model`` at dropout 0 with one loader worker: the parameters
  after 2 steps within 1e-5 of JAX's, the live session unchanged; without a
  dataset both packages fail (the port with a ValueError);
- ``compute_interpolation``, the project's round trip and a GIF on the CPU;
- the editor's flows against the JAX editor's (hit test, welding, the y
  flip, pencil, pen, drag, the timeline, the ease), and the web GUI's cases
  over HTTP on port 0 (with the CPU session, the 400 without one, and the
  400 of ``/api/interpolate`` with a training config and a session without
  a dataset, which fails in the JAX package's server too).
"""
import json
import math
import os
import pickle
import re
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu import animate as jax_animate
from deepsvg_tpu import editor as jax_editor
from deepsvg_tpu import inference as jax_inference
from deepsvg_tpu.data import dataset as jax_ds
from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.svglib import SVG as JaxSVG
from deepsvg_tpu.training.config import TrainConfig as JaxTrainConfig
from deepsvg_tpu.webgui import make_server as jax_make_server
from deepsvg_tpu_torch import animate, editor, gui, inference
from deepsvg_tpu_torch.data import dataset as port_ds
from deepsvg_tpu_torch.data.synthetic import _random_path
from deepsvg_tpu_torch.models import ModelConfig, SVGTransformer, to_flax_params
from deepsvg_tpu_torch.svglib import SVG, Bbox
from deepsvg_tpu_torch.training.config import TrainConfig
from deepsvg_tpu_torch.training.trainer import init_parameters
from deepsvg_tpu_torch.webgui import make_server
from deepsvg_tpu_torch.webgui.server import STATIC_DIR

LATENT_TOL = 1e-5
PARAM_TOL = 1e-5
SMALL = dict(encode_stages=2, decode_stages=2, use_vae=False, max_num_groups=3, max_seq_len=6,
             d_model=32, dim_feedforward=64, dim_z=16, n_layers=1, n_layers_decode=1,
             n_heads=4, dropout=0.0)
LABELLED = dict(SMALL, label_condition=True, n_labels=5, dim_label=64)
# AdamW's eps in the finetune comparison (both packages): at the default 1e-8 a
# leaf whose gradient is float32 noise moves by the learning rate in a sign
# the noise picks (as in test_torch_port_runtime.py's CLI comparison)
ADAM_EPS = 1e-4
WEIGHTS = {"kl_tolerance": 0.1, "loss_kl_weight": 1.0, "loss_visibility_weight": 1.0,
           "loss_cmd_weight": 1.0, "loss_args_weight": 2.0}


def _text(svg) -> str:
    """A document's paths as text (an empty group has no ``to_str``)."""
    return "\n".join(" ".join(p.to_str() for p in g.svg_paths) for g in svg.svg_path_groups)


def _circle(pkg=SVG):
    return pkg.unit_circle().normalize(Bbox(256)).numericalize(256)


def _square(pkg=SVG):
    return pkg.unit_square().normalize(Bbox(256)).numericalize(256)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """12 icons as tensor pickles of two variants, and their meta CSV."""
    root = tmp_path_factory.mktemp("icons")
    rng = np.random.default_rng(0)
    lines = ["id,total_len,nb_groups,max_len_group,category"]
    for i in range(12):
        n_groups = int(rng.integers(1, 4))
        tensors = [_random_path(rng, int(rng.integers(3, 7))) for _ in range(n_groups)]
        flat = np.concatenate(tensors, axis=0)
        with open(root / f"icon{i}.pkl", "wb") as f:
            pickle.dump({"tensors": [flat, flat], "fillings": [0] * n_groups}, f)
        lens = [len(t) + 1 for t in tensors]
        lines.append(f"icon{i},{sum(lens)},{n_groups},{max(lens)},free-icons")
    (root / "meta.csv").write_text("\n".join(lines) + "\n")
    return str(root), str(root / "meta.csv")


def _pair(kw, seed):
    """The port's model, seeded, and the JAX model with its weights."""
    model = SVGTransformer(ModelConfig(**kw))
    with torch.no_grad():
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval(), JaxSVGTransformer(JaxModelConfig(**kw, attention_impl="xla")), \
        {"params": to_flax_params(model)}


@pytest.fixture(scope="module")
def sessions(disk):
    """The port's session (CPU) and the JAX package's, on the same weights
    and the same icons."""
    model, jm, variables = _pair(SMALL, 21)
    args = (*disk, model.cfg.get_model_args(), 3, 6, model.cfg.max_total_len)
    port = inference.InferenceSession(model, dataset=port_ds.SVGTensorDataset(*args))
    ref = jax_inference.InferenceSession(jm, variables, dataset=jax_ds.SVGTensorDataset(*args))
    return port, ref


@pytest.fixture(scope="module")
def labelled():
    model, jm, variables = _pair(LABELLED, 22)
    return inference.InferenceSession(model), jax_inference.InferenceSession(jm, variables)


def _close(got, want, tol=LATENT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _same_decode(port, ref, z, label=None):
    """Equal ids from the same latents, and equal SVG text."""
    zj = jnp.asarray(np.asarray(z))
    lj = None if label is None else jnp.asarray(label, jnp.int32)
    c_p, a_p = port.decode_ids(z, label)
    c_j, a_j = ref._decode(ref.variables, z=zj, label=lj)
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    texts = [_text(s) for s in port.decode(z, label=label)]
    assert texts == [_text(s) for s in ref.decode(zj, label=lj)]
    return texts


# ------------------------------------------------------------ the session

def test_encode_matches_jax(sessions):
    """A batch, one unbatched item, an SVG and an icon: latents within
    1e-5 (no VAE: the encoder's output)."""
    port, ref = sessions
    items = [port.dataset.get_item_aug(i, 0) for i in range(3)]
    batch = {k: np.stack([it[k] for it in items]) for k in ("commands", "args")}
    z = port.encode(batch)
    assert z.shape == (3, 16) and z.device.type == "cpu"
    _close(z, ref.encode(batch))
    _close(port.encode(items[1]), ref.encode(items[1]))
    _close(port.encode_svg(_circle()), ref.encode_svg(_circle(JaxSVG)))
    _close(port.encode_icon(idx=2), ref.encode_icon(idx=2))


def test_decode_interpolate_and_directions_match_jax(sessions):
    """``decode`` of three latents, ``interpolate`` (its latents at the
    fractions ``jnp.linspace`` gives, eased), ``latent_direction`` and
    ``apply_direction``: ids and SVG text equal."""
    port, ref = sessions
    z1, z2 = port.encode_icon(idx=0), port.encode_icon(idx=1)
    zs = port.interpolation_latents(z1, z2, n=3)
    alphas = jax_inference.easein_easeout(jnp.linspace(0.0, 1.0, 5)[1:-1])
    want = (1 - alphas[:, None]) * jnp.asarray(z1.numpy()) + alphas[:, None] * \
        jnp.asarray(z2.numpy())
    np.testing.assert_array_equal(zs.numpy(), np.asarray(want))
    texts = _same_decode(port, ref, zs)
    assert [_text(s) for s in port.interpolate(z1, z2, n=3)] == texts
    assert [_text(s) for s in ref.interpolate(jnp.asarray(z1.numpy()), jnp.asarray(z2.numpy()),
                                              n=3)] == texts
    direction = port.latent_direction([_circle()], [_square()])
    d_ref = ref.latent_direction([_circle(JaxSVG)], [_square(JaxSVG)])
    _close(direction, d_ref)
    amounts = [0.0, 0.5, 1.0]
    got = port.apply_direction(z1, direction, amounts)
    zd = torch.stack([z1.reshape(-1) + a * direction for a in amounts])
    assert [_text(s) for s in got] == _same_decode(port, ref, zd)
    assert len(port.interpolate_svg(_circle(), _square(), n=3)) == 3


def test_label_path_matches_jax(labelled):
    """The labelled model: encode with labels within 1e-5, the decode of a
    given z and labels with equal ids and text; ``sample_class`` decodes
    prior draws from a ``torch.Generator`` with the class."""
    port, ref = labelled
    from deepsvg_tpu_torch.data.synthetic import generate_batch
    b = generate_batch(np.random.default_rng(4), 3, 3, 6)
    batch = {"commands": b["commands"], "args": b["args"], "label": np.array([1, 3, 4])}
    _close(port.encode(batch), ref.encode(batch))
    z = np.random.default_rng(5).standard_normal((3, 16)).astype(np.float32)
    _same_decode(port, ref, torch.from_numpy(z), label=np.array([0, 2, 4]))
    gen = torch.Generator().manual_seed(9)
    prior = torch.randn((3, 16), generator=torch.Generator().manual_seed(9))
    assert [_text(s) for s in port.sample_class(2, n=3, generator=gen)] == \
        [_text(s) for s in port.decode(prior, label=np.full((3,), 2))]


def test_refusals_carry_jax_messages(sessions, labelled):
    """Tokens and labels outside their tables, and an unlabelled encode of
    a labelled model, are refused on the host with the JAX package's
    messages."""
    port, ref = sessions
    item = port.dataset.get(idx=0, model_args=["commands", "args"], random_aug=False)
    bad_c = dict(item, commands=item["commands"].copy())
    bad_c["commands"][0, 0] = 99
    bad_a = dict(item, args=item["args"].copy())
    bad_a["args"][0, 0, 0] = -7
    z = np.zeros((1, 16), np.float32)
    lab_port, lab_ref = labelled
    cases = [(lambda s: s.encode(bad_c), sessions), (lambda s: s.encode(bad_a), sessions),
             (lambda s: s.decode(z, label=np.array([10 ** 6])), labelled),
             (lambda s: s.encode({"commands": item["commands"], "args": item["args"]}),
              labelled)]
    for call, (p, r) in cases:
        with pytest.raises(ValueError) as e_port:
            call(p)
        with pytest.raises(ValueError) as e_ref:
            call(r)
        assert str(e_port.value) == str(e_ref.value)


def test_random_sample_and_gui_wrappers(sessions):
    port, _ = sessions
    gen = torch.Generator().manual_seed(1)
    prior = torch.randn((3, 16), generator=torch.Generator().manual_seed(1))
    assert [_text(s) for s in port.random_sample(n=3, generator=gen)] == \
        [_text(s) for s in port.decode(prior)]
    z = gui.encode_svg(port, _circle())
    assert _text(gui.decode(port, z)) == _text(port.decode_one(z))
    assert len(gui.interpolate_svg(port, _circle(), _square(), n=2)) == 2
    t = np.linspace(0, 1, 11)
    e = inference.easein_easeout(t)
    assert e[0] == 0 and e[-1] == 1 and np.all(np.diff(e) >= 0)


# ------------------------------------------------------------ load_session

CONFIG_MODULE = """
from deepsvg_tpu_torch.models.config import ModelConfig
from deepsvg_tpu_torch.training.config import TrainConfig


class Config(TrainConfig):
    def __init__(self, num_devices=1):
        super().__init__(num_devices)
        self.model_cfg = ModelConfig(**{kw!r})
        self.model_args = self.model_cfg.get_model_args()
"""


def test_load_session_formats(sessions, tmp_path, monkeypatch):
    """Flax msgpack weights and a training checkpoint of the port give the
    session's decode; other files are refused, naming what they hold; no
    device means the card."""
    from deepsvg_tpu_torch.training.checkpoint import save_ckpt, save_model
    from deepsvg_tpu_torch.training.trainer import create_train_state, make_optimizer
    port, _ = sessions
    (tmp_path / "apps_tiny_cfg.py").write_text(CONFIG_MODULE.format(kw=SMALL))
    monkeypatch.syspath_prepend(str(tmp_path))
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 16)).astype(np.float32))
    want = port.decode_ids(z)
    save_model(str(tmp_path / "w.msgpack"), port.model)
    state = create_train_state(SVGTransformer(port.model.cfg), make_optimizer(lambda s: 1e-3),
                               init=False)
    state.model.load_state_dict(port.model.state_dict())
    save_ckpt(str(tmp_path / "ckpts"), state)
    for path in (tmp_path / "w.msgpack", tmp_path / "ckpts" / "000000.ckpt"):
        s2 = inference.load_session("apps_tiny_cfg", str(path), device="cpu")
        got = s2.decode_ids(z)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), path
    (tmp_path / "x.zip").write_bytes(b"PK\x03\x04rest")
    (tmp_path / "x.bin").write_bytes(b"\x00\x01junk")
    with pytest.raises(ValueError, match="zip archive"):
        inference.load_session("apps_tiny_cfg", str(tmp_path / "x.zip"), device="cpu")
    with pytest.raises(ValueError, match="unknown format"):
        inference.load_session("apps_tiny_cfg", str(tmp_path / "x.bin"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inference.load_session("apps_tiny_cfg", str(tmp_path / "w.msgpack"))


# ------------------------------------------------------------ animation

def _train_cfgs():
    """The port's training config and the JAX package's: the small model,
    batch 4, one loader worker, AdamW with eps ADAM_EPS."""
    import optax

    from deepsvg_tpu_torch.training.trainer import Optimizer
    out = []
    for cls, cfg_cls in ((TrainConfig, ModelConfig), (JaxTrainConfig, JaxModelConfig)):
        cfg = cls(1)
        cfg.model_cfg = cfg_cls(**SMALL)
        cfg.model_args = cfg.model_cfg.get_model_args()
        cfg.batch_size, cfg.loader_num_workers, cfg.warmup_steps = 4, 1, 2
        cfg.get_weights = lambda step, epoch: dict(WEIGHTS)
        out.append(cfg)
    p, j = out
    p.make_optimizer = lambda steps: Optimizer(p.make_lr_schedule(steps), 1e9, 0.01,
                                               eps=ADAM_EPS)
    j.make_optimizer = lambda steps: optax.chain(
        optax.clip_by_global_norm(1e9),
        optax.adamw(j.make_lr_schedule(steps), eps=ADAM_EPS, weight_decay=0.01))
    return out


def _jitted_init(monkeypatch):
    """JAX's ``create_train_state`` with its init forward jitted (eager, it
    compiles op by op): the same state. The finetune overwrites the
    parameters it initialises."""
    from deepsvg_tpu.training import trainer as jax_trainer
    create = jax_trainer.create_train_state

    def create_jitted(model, optimizer, sample_batch, model_args, seed=42):
        init = model.init
        try:
            object.__setattr__(model, "init", jax.jit(init))
            return create(model, optimizer, sample_batch, model_args, seed)
        finally:
            object.__delattr__(model, "init")
    monkeypatch.setattr(jax_trainer, "create_train_state", create_jitted)


def test_finetune_matches_jax_and_keeps_the_live_session(sessions, monkeypatch):
    """Two steps on the keyframes (dropout 0, one loader worker): every
    parameter within 1e-5 of JAX's; the live session's weights and latents
    unchanged."""
    port, ref = sessions
    cfg_p, cfg_j = _train_cfgs()
    _jitted_init(monkeypatch)
    before = port.encode_svg(_square())
    params = [p.detach().clone() for p in port.model.parameters()]
    new_p = animate.finetune_model(port, [_circle(), _square()], cfg_p, nb_augmentations=8,
                                   max_steps=2)
    new_j = jax_animate.finetune_model(ref, [_circle(JaxSVG), _square(JaxSVG)], cfg_j,
                                       nb_augmentations=8, max_steps=2)
    got = jax.tree_util.tree_leaves_with_path(to_flax_params(new_p.model))
    want = dict(jax.tree_util.tree_leaves_with_path(new_j.variables["params"]))
    assert len(got) == len(want)
    moved = 0
    for path, leaf in got:
        _close(leaf, want[path], PARAM_TOL)
    for a, b in zip(params, new_p.model.parameters()):
        moved += not torch.equal(a, b)
    assert moved > 0 and new_p.model is not port.model
    assert all(torch.equal(a, b) for a, b in zip(params, port.model.parameters()))
    assert torch.equal(port.encode_svg(_square()), before)


def test_finetune_without_a_dataset_fails_in_both(sessions):
    """A session without a dataset (as ``load_session`` builds by default)
    cannot finetune: the JAX package fails on its first item with an
    AttributeError, the port refuses with a ValueError."""
    port, ref = sessions
    cfg_p, cfg_j = _train_cfgs()
    bare_j = jax_inference.InferenceSession(ref.model, ref.variables)
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'get'"):
        jax_animate.finetune_model(bare_j, [_circle(JaxSVG)], cfg_j, nb_augmentations=4,
                                   max_steps=1)
    bare_p = inference.InferenceSession(port.model)
    with pytest.raises(ValueError, match="has none"):
        animate.finetune_model(bare_p, [_circle()], cfg_p, nb_augmentations=4, max_steps=1)


def test_compute_interpolation_project_and_gif(sessions, tmp_path):
    """In-betweens filled from the session (the decode of the interpolation
    latents), keyframes kept; the project's round trip; a GIF."""
    from PIL import Image
    port, _ = sessions
    project = animate.DeepSVGProject(name="t", root_dir=str(tmp_path))
    project.frames = [animate.Frame(0, keyframe=True, svg=_circle()), animate.Frame(1),
                      animate.Frame(2), animate.Frame(3, keyframe=True, svg=_square())]
    out = animate.compute_interpolation(port, project, finetune=False)
    assert out is port and [f.keyframe for f in project.frames] == [True, False, False, True]
    zs = port.interpolation_latents(port.encode_svg(_circle()), port.encode_svg(_square()), 2,
                                    ease=False)
    assert [_text(f.svg) for f in project.frames[1:3]] == [_text(s) for s in port.decode(zs)]
    gif = project.export_to_gif(str(tmp_path / "a.gif"), width=64,
                                loop_mode=animate.LoopMode.PINGPONG)
    with Image.open(gif) as im:
        # (PIL merges equal consecutive frames: the ping-pong's turn is one)
        assert 2 <= im.n_frames <= 8 and im.size[0] == 64
    saved = animate.DeepSVGProject(name="s", root_dir=str(tmp_path / "p"))
    os.makedirs(saved.root_dir)
    saved.frames = [animate.Frame(0, True, _circle()), animate.Frame(1),
                    animate.Frame(2, True, _square())]
    saved.save_project()
    back = animate.DeepSVGProject(root_dir=str(tmp_path))
    back.load_project(saved.filename)
    assert (back.name, back.uid) == ("s", saved.uid)
    assert [f.keyframe for f in back.frames] == [True, False, True]
    assert _text(back.frames[2].svg) == _text(saved.frames[2].svg)


def test_preprocess_svg_path_matches_jax():
    from deepsvg_tpu.svglib import SVGPath as JaxSVGPath
    from deepsvg_tpu_torch.svglib import SVGPath
    text = "M 10 10 " + " ".join(f"L {10 + 100 * np.cos(a):.2f} {10 + 100 * np.sin(a):.2f}"
                                 for a in np.linspace(0.1, 3.0, 40))
    got = animate.preprocess_svg_path(SVGPath.from_str(text).path)
    want = jax_animate.preprocess_svg_path(JaxSVGPath.from_str(text).path)
    assert got.to_str() == want.to_str() and len(got.path_commands) < 40


# ------------------------------------------------------------ the editor

def _circle_points(cx=128, cy=128, r=60, n=40):
    return [(cx + r * math.cos(2 * math.pi * t / n), cy + r * math.sin(2 * math.pi * t / n))
            for t in range(n + 1)]


def _segments(path):
    return [(s.is_curved, s.p1, s.q1, s.q2, s.p2) for s in path.segments]


def _bezier_model(mod):
    seg = mod.BezierSegment.bezier([0, 0], [10, 20], [30, 20], [40, 0])
    line = mod.BezierSegment.line([0, 0], [40, 0])
    p = mod.BezierPath([mod.BezierSegment.line([0, 0], [10, 0]),
                        mod.BezierSegment.line([10, 0], [20, 0])])
    p.move(0, "p2", [12, 3])
    p.move(1, "p1", [8, 1])
    curve = mod.BezierPath([mod.BezierSegment.bezier([0, 10], [5, 30], [15, 30], [20, 10]),
                            mod.BezierSegment.line([20, 10], [40, 10])])
    svg_path = curve.to_svg_path()
    return (seg.hit_test([10.5, 20.5]), seg.hit_test([100, 100]), line.hit_test([0.5, 0.5]),
            _segments(p), svg_path.to_str(), _segments(mod.BezierPath.from_svg_path(svg_path)),
            mod.flip_vertical([3, 10]))


def _drawing(mod):
    """Pencil stroke, drag of a control point, pen path, frames."""
    ed = mod.Editor()
    ed.select_tool(mod.ToolMode.PENCIL)
    pts = _circle_points()
    ed.stroke_down(pts[0])
    for pos in pts[1:]:
        ed.stroke_move(pos)
    path = ed.stroke_up()
    out = [_segments(path), ed.timeline.frames[:], ed.modified]
    ed.select_tool(mod.ToolMode.MOVE)
    target = list(path.segments[0].p2)
    out.append(ed.touch_down(target))
    ed.touch_move([target[0] + 2, target[1] - 2])
    ed.touch_up()
    out.append(_segments(path))
    ed.add_frame()
    ed.select_tool(mod.ToolMode.PEN)
    ed.pen_down((50, 50))
    ed.pen_up()
    ed.pen_move((150, 60))
    ed.pen_down((150, 60))
    ed.pen_drag((180, 90))
    out.append(ed.draw_mode)
    ed.pen_up()
    pen = ed.finish_path()
    out += [_segments(pen), ed.draw_mode, ed.current_path is None]
    ed.select_frame(0)
    out.append([_segments(p) for p in ed.paths])
    return out


def _playback(mod):
    ed = mod.Editor()
    for _ in range(9):
        ed.add_frame()
    ed.timeline.select(0)
    ed.playback_mode, ed.loop_mode = mod.PlaybackMode.NORMAL, mod.LoopMode.NORMAL
    seq = [ed.next_frame() for _ in range(12)]
    ed.loop_mode = mod.LoopMode.PINGPONG
    ed.timeline.select(7)
    seq += [ed.next_frame() for _ in range(6)]
    ed.playback_mode, ed.loop_mode = mod.PlaybackMode.EASE, mod.LoopMode.REVERSE
    seq += [ed.next_frame() for _ in range(10)]
    return seq


@pytest.mark.parametrize("flow", [_bezier_model, _drawing, _playback],
                         ids=["bezier_model", "drawing", "playback"])
def test_editor_flows_match_jax(flow):
    """The same scripted interactions on both editors give the same state:
    segments, selections, keyframes, draw modes, the playback order and its
    eased delays."""
    got, want = flow(editor), flow(jax_editor)
    assert got == want
    if flow is _drawing:
        assert len(got[0]) < 20 and any(s[0] for s in got[0]) and got[3]
        assert got[4][0][4] == pytest.approx([got[0][0][4][0] + 2, got[0][0][4][1] - 2])
    if flow is _playback:
        delays = dict(got[18:])                  # the eased ones
        assert delays[5] < delays[1] and delays[5] < delays[9]


def test_editor_interpolates_with_the_session(sessions):
    port, _ = sessions
    ed = editor.Editor()
    ed.select_tool(editor.ToolMode.PENCIL)
    for center in ((128, 128), (150, 110)):
        pts = _circle_points(*center, r=40)
        ed.stroke_down(pts[0])
        for pos in pts[1:]:
            ed.stroke_move(pos)
        ed.stroke_up()
        if center == (128, 128):
            ed.add_frame()
            ed.add_frame()
    project = ed.interpolate(port, cfg=None, finetune=False)
    assert [f.keyframe for f in project.frames] == [True, False, True]
    assert project.frames[1].svg.svg_path_groups is not None


# ------------------------------------------------------------ the web GUI

def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(route, body=None, method="POST"):
        data = json.dumps(body if body is not None else {}).encode() if method == "POST" else None
        req = urllib.request.Request(f"{base}{route}", data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as res:
                return res.status, json.loads(res.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    call.base = base
    return call


@pytest.fixture()
def server():
    srv = make_server(port=0)
    yield _serve(srv)
    srv.shutdown()
    srv.server_close()


def _stroke(call, pts):
    call("/api/pointer", {"type": "down", "pos": list(pts[0])})
    for p in pts[1:]:
        call("/api/pointer", {"type": "move", "pos": list(p)})
    return call("/api/pointer", {"type": "up"})


def test_webgui_static_and_state(server):
    for path, ctype, marker in [("/", "text/html", b"<canvas"),
                                ("/static/app.js", "text/javascript", b"/api/"),
                                ("/static/style.css", "text/css", b"#canvas")]:
        with urllib.request.urlopen(server.base + path) as res:
            assert res.status == 200 and res.headers["Content-Type"] == ctype
            assert marker in res.read()
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(server.base + "/../server.py")
    code, state = server("/api/state", method="GET")
    assert code == 200 and state["timeline"]["frames"] == [False]
    assert state["paths"] == [] and state["tool"] == 0 and not state["has_session"]
    assert server("/api/nope")[0] == 404
    code, res = server("/api/interpolate")
    assert code == 400 and "session" in res["error"]


def test_webgui_pencil_pen_drag_timeline(server):
    """The pencil's digitized path equals the JAX editor's for the same
    stroke; the pen, a drag, copy/paste, keyframes and ping-pong playback."""
    server("/api/tool", {"tool": 2})
    pts = _circle_points()
    _, res = _stroke(server, pts)
    st = res["state"]
    ref = jax_editor.Editor()
    ref.select_tool(jax_editor.ToolMode.PENCIL)
    ref.stroke_down(pts[0])
    for p in pts[1:]:
        ref.stroke_move(p)
    want = ref.stroke_up()
    assert [[s["p1"], s["q1"], s["q2"], s["p2"]] for s in st["paths"][0]["segments"]] == \
        [[list(s.p1), list(s.q1), list(s.q2), list(s.p2)] for s in want.segments]
    assert st["timeline"]["frames"] == [True] and st["paths"][0]["selected"]
    server("/api/path/copy")
    _, res = server("/api/path/paste")
    assert len(res["state"]["paths"]) == 2 and res["state"]["paths"][1]["selected"]
    server("/api/frame/add", {})
    server("/api/tool", {"tool": 1})
    server("/api/pointer", {"type": "down", "pos": [50, 50]})
    server("/api/pointer", {"type": "up"})
    server("/api/pointer", {"type": "down", "pos": [150, 50]})
    server("/api/pointer", {"type": "drag", "pos": [150, 120]})
    server("/api/pointer", {"type": "up"})
    _, res = server("/api/pen/finish")
    assert len(res["state"]["paths"]) == 1
    server("/api/tool", {"tool": 0})
    anchor = res["state"]["paths"][0]["segments"][0]["p1"]
    server("/api/pointer", {"type": "down", "pos": anchor})
    server("/api/pointer", {"type": "move", "pos": [anchor[0] + 2, anchor[1] + 2]})
    _, res = server("/api/pointer", {"type": "up"})
    assert res["state"]["paths"][0]["segments"][0]["p1"] == pytest.approx(
        [anchor[0] + 2, anchor[1] + 2])
    server("/api/frame/add", {})
    _, res = server("/api/frame/keyframe", {"value": True})
    assert res["state"]["timeline"] == {"frames": [True, True, True], "selected": 2}
    server("/api/frame/select", {"index": 0})
    server("/api/playback", {"loop_mode": 2, "playback_mode": 1, "delay": 0.05})
    seen = [server("/api/play/next")[1]["index"] for _ in range(6)]
    assert seen == [1, 2, 1, 0, 1, 2]


def test_webgui_save_load_export(server, tmp_path):
    server("/api/tool", {"tool": 2})
    _stroke(server, _circle_points(r=50))
    code, res = server("/api/project/save", {"dir": str(tmp_path)})
    saved = res["saved"]
    assert code == 200 and saved.startswith(str(tmp_path))
    code, res = server("/api/export/gif", {})
    assert code == 200 and res["gif"].endswith(".gif")
    code, res = server("/api/project/load", {"path": saved})
    assert code == 200 and len(res["state"]["paths"]) == 1


def test_webgui_interpolates_on_the_session(sessions, tmp_path):
    """A scripted session on a server with the CPU session: two keyframes
    with a frame between, ``/api/interpolate`` fills it from the model, and
    the GIF holds the three frames, the keyframes drawn."""
    from PIL import Image
    port, _ = sessions
    srv = make_server(port=0, session=port)
    call = _serve(srv)
    try:
        call("/api/tool", {"tool": 2})
        _stroke(call, _circle_points(r=60))
        call("/api/frame/add")
        call("/api/frame/add")
        _, res = _stroke(call, _circle_points(cx=160, cy=100, r=35))
        assert res["state"]["timeline"]["frames"] == [True, False, True]
        code, res = call("/api/interpolate")
        assert code == 200, res
        frames = srv.api.editor.project.frames
        zs = port.interpolation_latents(port.encode_svg(frames[0].svg),
                                        port.encode_svg(frames[2].svg), 1, ease=False)
        assert _text(frames[1].svg) == _text(port.decode(zs)[0])
        gif = str(tmp_path / "session.gif")
        code, res = call("/api/export/gif", {"path": gif})
        assert code == 200 and res["gif"] == gif
    finally:
        srv.shutdown()
        srv.server_close()
    with Image.open(gif) as im:
        assert im.n_frames == 3 and im.size[0] == 200
        mins = []
        for i in range(3):
            im.seek(i)
            mins.append(np.asarray(im.convert("L")).min())
        assert mins[0] < 128 and mins[2] < 128


def test_webgui_interpolate_with_a_config_and_no_dataset_fails_in_both(sessions):
    """``run()`` with ``--config/--weights`` builds a session without a
    dataset and passes the training config, so ``/api/interpolate``
    finetunes first: the JAX server answers 400 with its AttributeError,
    the port's with its ValueError."""
    port, ref = sessions
    cfg_p, cfg_j = _train_cfgs()
    for mk, session, cfg, pattern in (
            (make_server, inference.InferenceSession(port.model), cfg_p, "has none"),
            (jax_make_server, jax_inference.InferenceSession(ref.model, ref.variables), cfg_j,
             "'NoneType' object has no attribute 'get'")):
        srv = mk(port=0, session=session, train_cfg=cfg)
        call = _serve(srv)
        try:
            call("/api/tool", {"tool": 2})
            _stroke(call, _circle_points(r=60))
            call("/api/frame/add")
            call("/api/frame/add")
            _stroke(call, _circle_points(cx=160, cy=100, r=35))
            code, res = call("/api/interpolate")
            assert code == 400 and re.search(pattern, res["error"]), res
        finally:
            srv.shutdown()
            srv.server_close()


def test_webgui_client_bindings():
    """Every DOM id the port's ``app.js`` looks up exists in its page, and
    every API route it calls is handled by its server."""
    js = (STATIC_DIR / "app.js").read_text()
    html = (STATIC_DIR / "index.html").read_text()
    server_py = (STATIC_DIR.parent / "server.py").read_text()
    for dom_id in set(re.findall(r"getElementById\(\"([\w-]+)\"\)", js)):
        assert f'id="{dom_id}"' in html, dom_id
    handled = set(re.findall(r'route == "([\w/]+)"', server_py)) | {"state"}
    routes = set(re.findall(r'api\("([\w/]+)"', js))
    assert routes and routes <= handled, routes - handled
