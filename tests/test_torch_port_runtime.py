"""The port's training runtime against the JAX package's, on the CPU: the
training CLI's ``train()``, resume, the checkpoint formats, the synthetic
datasets, the loader and the device-resident epoch order.

Held:

- ``train()`` of both packages on one small hierarchical config (d_model 64,
  2 heads, F 128, 2 layers per stack, float32, dropout 0, 64 synthetic
  icons, batch 8, 6 steps, JAX's XLA path), both from one weights file that
  the JAX package's ``save_model`` writes: the same checkpoint files, every
  logged loss term within 1e-5 relative and the gradient norm within 1e-4,
  the final parameters within 3e-5 of each leaf's largest entry;
- a resumed run (4 steps, save, resume to 6) equals an uninterrupted one to
  the bit, with dropout 0.1: parameters, optimizer moments and counts, the
  step generator;
- the checkpoint formats: the port's weights file read by the JAX package's
  ``load_model`` to the bit, the training checkpoint's round trip, a
  structure mismatch raising, the retention rule;
- the data: the synthetic datasets give the JAX package's items for a seed,
  the wire format round-trips, the loader's epochs and the resident epoch
  permutation are the JAX package's, the process and thread workers agree.
"""
import dataclasses
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from deepsvg_tpu.data import loader as jax_loader
from deepsvg_tpu.data import resident as jax_resident
from deepsvg_tpu.data import synthetic as jax_synthetic
from deepsvg_tpu_torch.data import loader as port_loader
from deepsvg_tpu_torch.data import resident as port_resident
from deepsvg_tpu_torch.data import synthetic as port_synthetic
from deepsvg_tpu_torch.training import checkpoint as port_ckpt
from deepsvg_tpu_torch.training.config import TrainConfig as PortTrainConfig
from deepsvg_tpu_torch.training.train import train as port_train

WEIGHTS = {"kl_tolerance": 0.1, "loss_kl_weight": 1.0, "loss_visibility_weight": 1.0,
           "loss_cmd_weight": 1.0, "loss_args_weight": 2.0}
LOSS_RTOL = 1e-5         # each logged loss term, relative
NORM_RTOL = 1e-4         # the logged gradient norm, relative (read up to 1.3e-5: float32
                         # sums in another order)
PARAM_TOL = 3e-5         # each final parameter leaf, of its largest entry
ADAM_EPS = 1e-4          # the CLI comparison's AdamW eps (test_train_cli_matches_jax)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _model_kwargs(dropout=0.0):
    return dict(encode_stages=2, decode_stages=2, use_vae=False, d_model=64, n_heads=2,
                dim_feedforward=128, dim_z=64, n_layers=2, n_layers_decode=2,
                dropout=dropout, max_num_groups=8, max_seq_len=6)


def _configure(cfg, model_cfg, steps_per_dispatch=2):
    cfg.model_cfg = model_cfg
    cfg.model_args = model_cfg.get_model_args()
    cfg.max_num_groups, cfg.max_seq_len = model_cfg.max_num_groups, model_cfg.max_seq_len
    cfg.max_total_len = None
    cfg.synthetic_size = 64
    cfg.batch_size = 8
    cfg.num_epochs = None
    cfg.learning_rate = 1e-3
    cfg.warmup_steps = 2
    cfg.grad_clip = 1.0
    cfg.log_every, cfg.val_every, cfg.ckpt_every = 2, 10_000, 4
    cfg.loader_num_workers = 1
    cfg.steps_per_dispatch = steps_per_dispatch
    cfg.get_weights = lambda step, epoch: dict(WEIGHTS)
    return cfg


def _port_cfg(dropout=0.0, steps_per_dispatch=2):
    from deepsvg_tpu_torch.models.config import ModelConfig
    return _configure(PortTrainConfig(1), ModelConfig(**_model_kwargs(dropout)),
                      steps_per_dispatch)


def _port_dataset(cfg):
    return port_synthetic.load_dataset(cfg)


def _ckpt_files(log_dir, name):
    return sorted(os.listdir(os.path.join(log_dir, "models", "cli", name)))


def _flax_leaves(tree):
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out["/".join(prefix + (k,))] = np.asarray(v)
    walk(tree, ())
    return out


def test_train_cli_matches_jax(tmp_path):
    """Six steps through both packages' ``train()``, K = 2 steps per loop
    iteration over the resident synthetic corpus: logs at 2, 4, 6, a
    checkpoint at 4 and the final one at 6.

    The config's AdamW takes eps 1e-4. With the default 1e-8, an entry whose
    gradient is rounding noise (the key bias, FF units that barely pass the
    ReLU) moves by a whole lr in the direction the noise picks, so the two
    packages' float32 sums part after a few steps: read at 1e-8, the total
    loss agrees to 4.8e-7 but loss_cmd to 6.8e-5 and the biases (which start
    at zero) to 3.0e-2 of their largest entry. At 1e-4 every loss term agrees
    to 3.6e-6 and every leaf to 1.64e-5 of its largest entry (a bias leaf:
    six steps of lr 1e-3 make its largest entry about 6e-3). The port's run
    takes torch's deterministic algorithms: the CPU's scatter-add in the
    embedding backward otherwise sums in an order that changes from run to
    run, which read up to 5.1e-5 here."""
    import jax
    import optax

    from deepsvg_tpu.models import ModelConfig as JaxModelConfig
    from deepsvg_tpu.models import SVGTransformer as JaxModel
    from deepsvg_tpu.training import checkpoint as jax_ckpt
    from deepsvg_tpu.training.config import TrainConfig as JaxTrainConfig
    from deepsvg_tpu.training.train import train as jax_train
    from deepsvg_tpu.training.trainer import create_train_state as jax_create_state
    from deepsvg_tpu_torch.models.weights import to_flax_params

    from deepsvg_tpu_torch.training.trainer import Optimizer

    jcfg = _configure(JaxTrainConfig(1), JaxModelConfig(**_model_kwargs()))
    jcfg.make_optimizer = lambda steps_per_epoch: optax.chain(
        optax.clip_by_global_norm(jcfg.grad_clip),
        optax.adamw(jcfg.make_lr_schedule(steps_per_epoch), eps=ADAM_EPS, weight_decay=0.01))
    pcfg = _port_cfg()
    pcfg.make_optimizer = lambda steps_per_epoch: Optimizer(
        pcfg.make_lr_schedule(steps_per_epoch), pcfg.grad_clip, 0.01, eps=ADAM_EPS)
    jds, pds = jax_synthetic.load_dataset(jcfg), _port_dataset(pcfg)
    # one set of initial weights for both, written by the JAX package
    sample = jax_loader.collate([jds[i] for i in range(2)])
    init = jax_create_state(JaxModel(jcfg.model_cfg), jcfg.make_optimizer(8),
                            {k: sample[k] for k in set(jcfg.model_args)}, jcfg.model_args)
    weights_file = str(tmp_path / "init.msgpack")
    jax_ckpt.save_model(weights_file, init.params)
    jcfg.pretrained_path = pcfg.pretrained_path = weights_file

    jstate, jstats = jax_train(jcfg, "cli", "jax", log_dir=str(tmp_path), dataset=jds,
                               max_steps=6)
    torch.use_deterministic_algorithms(True)
    try:
        pstate, pstats = port_train(pcfg, "cli", "port", log_dir=str(tmp_path), dataset=pds,
                                    max_steps=6, device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    assert int(jstate.step) == pstate.step == 6
    assert _ckpt_files(tmp_path, "port") == _ckpt_files(tmp_path, "jax") == [
        "000004.ckpt", "000006.ckpt", "best.ckpt"]
    for key in ("loss", "loss_cmd", "loss_args", "loss_visibility", "grad_norm"):
        ours = list(pstats.stats["train"][key].deque)
        theirs = list(jstats.stats["train"][key].deque)
        assert len(ours) == len(theirs) == 3, key
        np.testing.assert_allclose(ours, theirs, err_msg=key,
                                   rtol=NORM_RTOL if key == "grad_norm" else LOSS_RTOL)
    ours = _flax_leaves(to_flax_params(pstate.model))
    theirs = _flax_leaves(jax.device_get(jstate.params))
    assert set(ours) == set(theirs)
    errs = {name: np.abs(ours[name] - want).max() / max(np.abs(want).max(), 1e-12)
            for name, want in theirs.items()}
    worst = max(errs, key=errs.get)
    print(f"final parameters: worst leaf {worst}, {errs[worst]:.3g} of its largest entry")
    assert errs[worst] <= PARAM_TOL, (worst, errs[worst])


def _state_tensors(state):
    out = [p.detach().clone() for p in state.parameters()]
    for group in port_ckpt._opt_groups(state.opt_state):
        out += [t.clone() for t in group["mu"] + group["nu"]]
        out += [torch.tensor(group["count"]), torch.tensor(group["calls"])]
    return out + [torch.tensor(state.step), state.generator.get_state()]


def test_resume_is_bit_exact(tmp_path):
    """4 steps, save, resume to 6, against 6 steps without a stop, dropout
    0.1 (the step generator, the optimizer's counts and the loop's place in
    its epoch travel in the checkpoint)."""
    torch.use_deterministic_algorithms(True)
    try:
        cfg = _port_cfg(dropout=0.1, steps_per_dispatch=None)
        ds = _port_dataset(cfg)
        port_train(cfg, "cli", "split", log_dir=str(tmp_path), dataset=ds, max_steps=4,
                   device="cpu")
        resumed, _ = port_train(cfg, "cli", "split", log_dir=str(tmp_path), dataset=ds,
                                max_steps=6, resume=True, device="cpu")
        whole, _ = port_train(_port_cfg(dropout=0.1, steps_per_dispatch=None), "cli", "whole",
                              log_dir=str(tmp_path), dataset=ds, max_steps=6, device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.step == whole.step == 6
    for a, b in zip(_state_tensors(resumed), _state_tensors(whole), strict=True):
        assert torch.equal(a, b)


def test_resume_misaligned_step_still_checkpoints(tmp_path):
    """32 icons, 4 batches an epoch. Resumed at step 5 with 8 steps to go,
    K = 4: steps 9 and 13 are not multiples of ckpt_every = 4, and the
    cadence still fires at 9 (window crossing), as in the JAX package's
    loop."""
    cfg = _port_cfg(steps_per_dispatch=None)
    cfg.synthetic_size = 32
    ds = _port_dataset(cfg)
    port_train(cfg, "cli", "mis", log_dir=str(tmp_path), dataset=ds, max_steps=5, device="cpu")
    state, _ = port_train(cfg, "cli", "mis", log_dir=str(tmp_path), dataset=ds, resume=True,
                          max_steps=13, device="cpu")
    assert state.step == 13
    assert "000009.ckpt" in _ckpt_files(tmp_path, "mis")


def test_profile_trace_capture(tmp_path):
    """``--profile 2:4``: a torch.profiler trace and a kernel table land
    under ``<log_dir>/profile/``."""
    cfg = _port_cfg()
    port_train(cfg, "cli", "prof", log_dir=str(tmp_path), dataset=_port_dataset(cfg),
               max_steps=4, profile_steps=(2, 4), device="cpu")
    files = [f for _, _, fs in os.walk(tmp_path / "profile") for f in fs]
    assert "trace.json" in files and "kernels.txt" in files


def test_cli_defaults_to_the_card(monkeypatch):
    """``--device`` defaults to cuda, which raises where there is no card."""
    from deepsvg_tpu_torch.training import train as train_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.resolve_device(None)
    assert train_mod.resolve_device("cpu").type == "cpu"


def test_recipe_config_gives_batch_60():
    """The flagship config at one card: B=60, lr 1e-3, bfloat16 compute,
    the icons config's loss-weight ramp; the default data module raises and
    names what is missing."""
    from deepsvg_tpu_torch.configs import hierarchical_ordered
    from deepsvg_tpu_torch.training.config import load_config, load_dataset
    cfg = load_config("deepsvg_tpu_torch.configs.hierarchical_ordered", 1)
    assert isinstance(cfg, hierarchical_ordered.Config)
    assert (cfg.batch_size, cfg.learning_rate, cfg.model_cfg.compute_dtype) == (60, 1e-3,
                                                                                 "bfloat16")
    assert not cfg.model_cfg.use_vae and cfg.model_args == ["commands", "args"] * 2
    assert cfg.get_weights(5000, 0)["loss_kl_weight"] == pytest.approx(5.0)
    assert hierarchical_ordered.Config().batch_size == 120
    with pytest.raises(ModuleNotFoundError, match="item 8"):
        load_dataset(cfg)


# --- checkpoint formats -------------------------------------------------------

def _small_state(dropout=0.0):
    from deepsvg_tpu_torch.models import SVGTransformer
    from deepsvg_tpu_torch.training import create_train_state, make_optimizer
    cfg = _port_cfg(dropout)
    model = SVGTransformer(cfg.model_cfg)
    return cfg, create_train_state(model, make_optimizer(lambda s: 1e-3))


def test_save_model_is_read_by_jax(tmp_path):
    """The port's weights file, read by the JAX package's ``load_model``
    into the JAX model's own parameter tree: every leaf equal to the bit."""
    import optax

    from deepsvg_tpu.models import ModelConfig as JaxModelConfig
    from deepsvg_tpu.models import SVGTransformer as JaxModel
    from deepsvg_tpu.training.checkpoint import load_model as jax_load_model
    from deepsvg_tpu.training.trainer import create_train_state as jax_create_state
    from deepsvg_tpu_torch.models.weights import to_flax_params
    cfg, state = _small_state()
    path = str(tmp_path / "w.msgpack")
    port_ckpt.save_model(path, state.model)
    sample = jax_loader.collate([port_synthetic.load_dataset(cfg)[i] for i in range(2)])
    template = jax_create_state(JaxModel(JaxModelConfig(**_model_kwargs())), optax.adamw(1e-3),
                                {k: sample[k] for k in set(cfg.model_args)},
                                cfg.model_args).params
    got = _flax_leaves(jax_load_model(path, template))
    want = _flax_leaves(to_flax_params(state.model))
    assert set(got) == set(want) == set(_flax_leaves(template))
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_msgpack_writer_matches_flax():
    """The pure-Python writer gives the bytes of flax's ``msgpack_serialize``
    on a tree of arrays, scalars, strings and nested dicts."""
    from flax import serialization

    from deepsvg_tpu_torch.models.checkpoint import msgpack_restore, msgpack_serialize
    rng = np.random.default_rng(0)
    tree = {"b": {"kernel": rng.normal(size=(3, 5)).astype(np.float32),
                  "count": np.int32(7)},
            "a": [np.arange(40, dtype=np.int64), "name", 3, -70000, 2.5, True, None],
            "long": "x" * 300, "big": np.zeros((70000,), np.uint8)}
    ours = msgpack_serialize(tree)
    assert ours == serialization.msgpack_serialize(tree)
    back = msgpack_restore(ours)
    np.testing.assert_array_equal(back["b"]["kernel"], tree["b"]["kernel"])


def test_ckpt_round_trip_and_mismatch(tmp_path):
    """A v2 checkpoint restores parameters, moments, counts, step and the
    generator; a checkpoint of another structure raises."""
    cfg, state = _small_state()
    with torch.no_grad():
        for i, p in enumerate(state.parameters()):
            p.add_(0.01 * i)
        state.opt_state["mu"][0].fill_(3.0)
    state.opt_state["count"], state.opt_state["calls"], state.step = 5, 6, 7
    state.generator.manual_seed(123)
    before = _state_tensors(state)
    path = port_ckpt.save_ckpt(str(tmp_path), state, cfg, position=(0, 7))
    assert os.path.basename(path) == "000007.ckpt"
    with open(path, "rb") as f:
        assert f.read(10) == b"DSVGCKPT2\n"
    _, fresh = _small_state()
    extra = {}
    fresh, found = port_ckpt.load_ckpt(str(tmp_path), fresh, extra=extra)
    assert found and extra == {"step": 7, "position": [0, 7]}
    for a, b in zip(before, _state_tensors(fresh), strict=True):
        assert torch.equal(a, b)

    from deepsvg_tpu_torch.models import SVGTransformer
    from deepsvg_tpu_torch.training import create_train_state, make_optimizer
    other = dataclasses.replace(cfg.model_cfg, n_layers=1)
    wrong = create_train_state(SVGTransformer(other), make_optimizer(lambda s: 1e-3))
    with pytest.raises(ValueError, match="structure mismatch|wrong config"):
        port_ckpt.load_ckpt(path, wrong)
    with pytest.raises(ValueError, match="training checkpoint"):
        port_ckpt.load_model(path, state.model)


def test_begin_save_snapshots_before_the_next_step(tmp_path):
    """The optimizer updates the parameters in place: a save begun at step 7
    writes step 7's values even when the parameters change before it is
    finished."""
    cfg, state = _small_state()
    state.step = 7
    want = [p.detach().clone() for p in state.parameters()]
    ctx = port_ckpt.begin_save(str(tmp_path), state, cfg)
    with torch.no_grad():
        for p in state.parameters():
            p.add_(1.0)
    port_ckpt.finish_save(ctx)
    _, fresh = _small_state()
    port_ckpt.load_ckpt(str(tmp_path), fresh)
    for a, b in zip(want, fresh.parameters(), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("steps,keep_last,keep_every,kept", [
    ((1000, 2000, 2500, 3000, 3500, 4000), 2, 2000,
     ["001000", "002000", "003500", "004000"]),
    (tuple(range(1002, 13 * 1002, 1002)), 3, 5000,
     ["001002", "005010", "010020", "011022", "012024"]),
])
def test_prune_retention(tmp_path, steps, keep_last, keep_every, kept):
    """The JAX package's retention rule (tests/test_runtime.py): the newest
    ``keep_last`` and the first checkpoint of every ``keep_every`` bucket,
    ``best.ckpt`` untouched, idempotent; ``keep_last=None`` keeps all."""
    cfg, state = _small_state()
    for step in steps:
        state.step = step
        port_ckpt.save_ckpt(str(tmp_path), state, cfg)
    assert port_ckpt.prune_ckpts(str(tmp_path), None) == []
    port_ckpt.prune_ckpts(str(tmp_path), keep_last, keep_every)
    assert sorted(os.listdir(tmp_path)) == [s + ".ckpt" for s in kept] + ["best.ckpt"]
    assert port_ckpt.prune_ckpts(str(tmp_path), keep_last, keep_every) == []
    assert port_ckpt.latest_ckpt(str(tmp_path)).endswith(kept[-1] + ".ckpt")


# --- data ---------------------------------------------------------------------

def _assert_items_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_synthetic_icon_dataset_matches_jax():
    kw = dict(n=24, seed=5, max_num_groups=4, max_seq_len=10)
    ours, theirs = port_synthetic.SyntheticIconDataset(**kw), \
        jax_synthetic.SyntheticIconDataset(**kw)
    assert len(ours) == len(theirs)
    for i in (0, 7, 23):
        _assert_items_equal(ours[i], theirs[i])
    idx = np.array([3, 1, 20])
    _assert_items_equal(ours.get_batch_arrays(idx), theirs.get_batch_arrays(idx))
    model_args = ["commands", "args", "tensor"]
    _assert_items_equal(ours.get(2, model_args), theirs.get(2, model_args))


def test_synthetic_augmented_corpus_matches_jax():
    kw = dict(n_icons=40, n_augs=3, seed=2, max_num_groups=4, max_seq_len=10,
              max_total_len=30, chunk=16)
    ours, theirs = port_synthetic.SyntheticAugmentedCorpus(**kw), \
        jax_synthetic.SyntheticAugmentedCorpus(**kw)
    assert len(ours) == len(theirs) == 120
    for icon, aug in ((0, 0), (17, 2), (39, 1)):
        _assert_items_equal(ours.get_item_aug(icon, aug), theirs.get_item_aug(icon, aug))
    _assert_items_equal(ours.get_variant_arrays(["commands", "args"]),
                        theirs.get_variant_arrays(["commands", "args"]))


def test_load_dataset_hook_matches_jax():
    cfg = _port_cfg()
    ours = port_synthetic.load_dataset(cfg)
    theirs = jax_synthetic.load_dataset(cfg)
    assert len(ours) == len(theirs) == 64
    _assert_items_equal(ours[11], theirs[11])


def test_wire_format_round_trip():
    ds = port_synthetic.SyntheticIconDataset(n=16, max_num_groups=3, max_seq_len=6)
    batch = port_loader.collate([ds[i] for i in range(8)])
    wire = port_loader.compress_batch(batch)
    assert wire["commands"].dtype == np.int8 and wire["args"].dtype == np.uint8
    _assert_items_equal(wire, jax_loader.compress_batch(batch))
    assert port_loader.compress_batch({"args": batch["args"]})["args"].dtype == np.int16
    back = port_loader.decompress_batch({k: torch.from_numpy(v) for k, v in wire.items()})
    assert back["commands"].dtype == torch.int32 and back["args"].dtype == torch.float32
    for k in ("commands", "args"):
        np.testing.assert_array_equal(back[k].numpy(), batch[k])


def test_loader_epochs_match_jax():
    """Two epochs of both loaders, shuffled from one seed: the same batches
    in the same order; ``epoch_batches(e, skip)`` resumes inside an epoch."""
    ds = port_synthetic.SyntheticIconDataset(n=40, max_num_groups=3, max_seq_len=6)
    jds = jax_synthetic.SyntheticIconDataset(n=40, max_num_groups=3, max_seq_len=6)
    ours = port_loader.DataLoader(ds, batch_size=8, seed=3, num_workers=2)
    theirs = jax_loader.DataLoader(jds, batch_size=8, seed=3, num_workers=2)
    for _ in range(2):
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == 5
        for x, y in zip(a, b):
            _assert_items_equal(x, y)
    tail = list(ours.epoch_batches(2, skip=3))
    assert len(tail) == 2
    _assert_items_equal(tail[0], b[3])


def test_epoch_icon_permutation_matches_jax():
    for args in ((64, 64, 8, 0, 2), (120, 40, 7, 3, 5)):
        np.testing.assert_array_equal(port_resident.epoch_icon_permutation(*args),
                                      jax_resident.epoch_icon_permutation(*args))


def test_resident_arrays_match_jax():
    model_args = ["commands", "args"]
    ds = port_synthetic.SyntheticAugmentedCorpus(n_icons=20, n_augs=2, max_num_groups=4,
                                                 max_seq_len=10, max_total_len=30)
    jds = jax_synthetic.SyntheticAugmentedCorpus(n_icons=20, n_augs=2, max_num_groups=4,
                                                 max_seq_len=10, max_total_len=30)
    ours = port_resident.build_resident_arrays(ds, model_args, num_workers=1)
    theirs = jax_resident.build_resident_arrays(jds, model_args, num_workers=1)
    assert ours[1:] == theirs[1:] == (20, 2)
    _assert_items_equal(ours[0], theirs[0])


class _Itemwise:
    """A dataset without the batch fast path, so that the loader's workers
    collate item by item (module level: the process workers unpickle it)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def test_process_workers_match_thread_workers():
    ds = _Itemwise(port_synthetic.SyntheticIconDataset(n=32, max_num_groups=3, max_seq_len=6))
    kw = dict(batch_size=8, shuffle=True, seed=3, num_workers=2)
    thread = list(port_loader.DataLoader(ds, **kw))
    proc_loader = port_loader.DataLoader(ds, worker_mode="process", **kw)
    try:
        proc = list(proc_loader)
    finally:
        proc_loader.close()
    assert len(proc) == len(thread) == 4
    for a, b in zip(thread, proc):
        _assert_items_equal(a, b)


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX, flax,
    msgpack or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|msgpack|deepsvg_tpu)"
                         r"(\.|\s|$)", re.M)
    files = sorted((REPO / "deepsvg_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
