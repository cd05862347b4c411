"""The port's data and tensor parallelism (``deepsvg_tpu_torch/parallel``)
against the JAX package's, on the CPU.

The port runs one process a rank, gloo through a file store, one thread
each (``tests/torch_parallel_worker.py``); three groups start together (2, 4
and 8 ranks) and run while the JAX references compile in this process, on
the 8-device mesh ``tests/conftest.py`` makes. Both packages start from the
same parameters (the port's initialisation, carried across by the weight
bridge) and train on the same batch from a numpy seed, at dropout 0 (JAX's
masks are not part of the contract), in float32; JAX's steps run its XLA
path, the port's the plain versions of its kernels (CPU tensors). Held:

- data parallelism at 2 ranks on the plain model and at 4 on the
  label-conditioned one, against JAX's ``make_parallel_train_step`` over as
  many devices: the loss at rtol 2e-4 (JAX's own DP test), ``grad_norm`` at
  rtol 2e-4, every parameter after 1 and 3 steps (:data:`PARAM_ATOL`); the
  ranks' parameters equal to the bit;
- the multi-step against K single data-parallel steps, to the bit;
- ``train()`` on its resident corpus at 2 ranks against the single-process
  run, by the JAX package's criterion (``tests/test_resident.py``: step 4,
  atol 2e-3); a batch the ranks do not divide is refused;
- tensor parallelism at 2 x 4 against JAX's ``make_tp_train_step``: the
  loss at rtol 2e-4, the parameters after one step at rtol 5e-4 / atol 5e-6
  (JAX's own TP test), qkv split by its output rows (the JAX kernel's
  columns) head by head, the loss falling over 5 more steps, and the
  refusals of the kernel path and the TP step;
- ``make_mesh(8, model_axis="model", n_model=2)``'s shape;
- the training CLI with ``--num-devices 2`` in two processes, and its
  refusal of a count that is not the number of processes.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.parallel import mesh as jax_mesh
from deepsvg_tpu.parallel import tp as jax_tp
from deepsvg_tpu.training import schedulers as jax_schedulers
from deepsvg_tpu.training import trainer as jax_trainer
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import ModelConfig, SVGTransformer, to_flax_params
from deepsvg_tpu_torch.training import init_parameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
BASE = dict(encode_stages=2, decode_stages=2, use_vae=False, max_num_groups=3,
            max_seq_len=6, d_model=32, dim_feedforward=64, dim_z=16, n_layers=1,
            n_layers_decode=1, n_heads=4, dropout=0.0)
CONFIGS = {"plain": BASE,
           # the JAX layers declare glob2 at 64 inputs whatever dim_label is
           "label": dict(BASE, label_condition=True, n_labels=5, dim_label=64)}
B = 16
LR = 1e-3
STEPS = 3
TP_STEPS = 6
WEIGHTS = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_visibility_weight=1.0,
               loss_cmd_weight=1.0, loss_args_weight=2.0)
LOSS_RTOL = 2e-4         # JAX's DP and TP tests hold their step to the single device's so
PARAM_ATOL = 2e-5        # parameters after DP steps, but the key biases (_assert_trees):
                         # summation orders alone, at lr 1e-3
DP_CASES = [("plain", 2), ("label", 4)]
WORKER_TIMEOUT = 240


def _inputs(tmp, kind):
    """The port's initial parameters and the global batch of one config,
    written for the workers; returns the job's common fields, the flax
    parameter tree and the batch."""
    cfg = ModelConfig(**CONFIGS[kind])
    model = SVGTransformer(cfg)
    init_parameters(model, torch.Generator().manual_seed(7))
    init = os.path.join(tmp, f"init_{kind}.pt")
    torch.save(model.state_dict(), init)
    model_args = cfg.get_model_args()
    raw = generate_batch(np.random.default_rng(3), B, cfg.max_num_groups, cfg.max_seq_len,
                         label_range=cfg.n_labels if cfg.label_condition else None)
    batch = {k: raw[k] for k in set(model_args)}
    path = os.path.join(tmp, f"batch_{kind}.npz")
    np.savez(path, **batch)
    job = dict(cfg=CONFIGS[kind], init=init, batch=path, lr=LR, weights=WEIGHTS,
               model_args=model_args)
    return job, to_flax_params(model), batch


def _launch(tmp, groups):
    """Start every group's ranks (one launcher that forks them)."""
    paths = []
    for world, jobs in groups.items():
        spec = dict(world=world, store=os.path.join(tmp, f"store{world}"), out=tmp, jobs=jobs)
        paths.append(os.path.join(tmp, f"spec{world}.json"))
        with open(paths[-1], "w") as f:
            json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, WORKER, *paths], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _jax_state(params, lr=LR):
    optimizer = jax_trainer.make_optimizer(jax_schedulers.constant(lr))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=optimizer.init(params),
                                   rng=jax.random.PRNGKey(0))
    return optimizer, state


def _jax_model(kind):
    return JaxSVGTransformer(JaxModelConfig(**CONFIGS[kind], attention_impl="xla"))


# the references compile at XLA's lowest backend optimisation level: each runs
# a few steps, and its compile would otherwise take most of this file's time
COMPILE = {"xla_backend_optimization_level": 0}


def _jax_dp(kind, world, params, batch, model_args):
    """JAX's data-parallel step over ``world`` devices, lowered; returns a
    function that compiles it and runs STEPS steps."""
    model = _jax_model(kind)
    optimizer, state = _jax_state(params)
    mesh = jax_mesh.make_mesh(world)
    step = jax_mesh.make_parallel_train_step(model, optimizer, model_args, mesh)
    sharded = jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    lowered = step.lower(state, sharded, WEIGHTS)

    def run():
        nonlocal state
        step = lowered.compile(compiler_options=COMPILE)
        res, after = [], {}
        for i in range(STEPS):
            state, r = step(state, sharded, WEIGHTS)
            res.append({k: float(v) for k, v in r.items()})
            if i + 1 in (1, STEPS):
                after[i + 1] = jax.tree_util.tree_map(np.asarray, state.params)
        return res, after
    return run


def _jax_tp(params, batch, model_args):
    """JAX's tensor-parallel step on the 2 x 4 mesh, lowered; returns a
    function that compiles it and runs one step."""
    model = _jax_model("plain")
    optimizer, state = _jax_state(params)
    mesh = jax_mesh.make_mesh(8, model_axis="model", n_model=4)
    state = jax_tp.shard_state_tp(state, mesh)
    step = jax_tp.make_tp_train_step(model, optimizer, model_args, mesh, state, donate=False)
    sharded = jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    lowered = step.lower(state, sharded, WEIGHTS)

    def run():
        step = lowered.compile(compiler_options=COMPILE)
        new, r = step(state, sharded, WEIGHTS)
        return float(r["loss"]), jax.tree_util.tree_map(np.asarray, new.params)
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel"))
    jobs, trees, batches = {}, {}, {}
    for kind in CONFIGS:
        jobs[kind], trees[kind], batches[kind] = _inputs(tmp, kind)
    resident = dict(name="resident", kind="resident", n_icons=64, batch_size=8, steps=4,
                    weights=WEIGHTS, log_dir=os.path.join(tmp, "logs"))
    groups = {
        2: [dict(jobs["plain"], name="dp_plain", kind="dp", steps=STEPS),
            dict(jobs["plain"], name="multi", kind="multi", steps=STEPS), resident,
            dict(name="cli", kind="cli", steps=2, log_dir=os.path.join(tmp, "cli"))],
        4: [dict(jobs["label"], name="dp_label", kind="dp", steps=STEPS)],
        8: [dict(jobs["plain"], name="tp", kind="tp", n_model=4, steps=TP_STEPS)],
        1: [dict(resident, name="single")],
    }
    launcher = _launch(tmp, groups)
    # the references while the ranks run, their compiles side by side
    runs = {f"dp_{kind}": _jax_dp(kind, world, trees[kind], batches[kind],
                                  jobs[kind]["model_args"])
            for kind, world in DP_CASES}
    runs["tp"] = _jax_tp(trees["plain"], batches["plain"], jobs["plain"]["model_args"])
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {name: pool.submit(run) for name, run in runs.items()}
        ref = {name: f.result() for name, f in futures.items()}
    ref["init_plain"] = torch.load(jobs["plain"]["init"])
    log, _ = launcher.communicate(timeout=WORKER_TIMEOUT)
    assert launcher.returncode == 0, log[-4000:]
    out = {name: [torch.load(os.path.join(tmp, f"{name}_{r}.pt")) for r in range(world)]
           for world, g in groups.items() for name in (j["name"] for j in g)}
    out["cli_dir"] = os.path.join(tmp, "cli")
    return out, ref


def _flax(kind, params: dict) -> dict:
    """The port's parameters ``{name: tensor}`` as the flax tree."""
    model = SVGTransformer(ModelConfig(**CONFIGS[kind]))
    model.load_state_dict(params)
    return to_flax_params(model)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees(ours, theirs, rtol, atol, steps):
    """Every leaf within ``rtol``/``atol``, but the key biases: their true
    gradient is zero (a key bias shifts all of a query's scores alike), so
    each package's is rounding noise, which Adam's normalisation turns into
    steps of up to lr either way; they are held to ``2 * lr * steps``."""
    ours, theirs = _leaves(ours), _leaves(theirs)
    assert set(ours) == set(theirs)
    d = BASE["d_model"]
    for k, ref in theirs.items():
        got = ours[k]
        if k.endswith("['bqkv']"):
            np.testing.assert_allclose(got[d:2 * d], ref[d:2 * d], rtol=0,
                                       atol=2 * LR * steps, err_msg=k)
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind,world", DP_CASES)
def test_data_parallel_matches_jax(runs, kind, world):
    out, ref = runs
    ranks = out[f"dp_{kind}"]
    jax_res, jax_after = ref[f"dp_{kind}"]
    for step, (ours, theirs) in enumerate(zip(ranks[0]["res"], jax_res)):
        np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
        # JAX's shard gradients come out `world` times the batch's: see
        # ROADMAP.md section 3, "Faults of the reference"
        np.testing.assert_allclose(ours["grad_norm"] * world, theirs["grad_norm"],
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
    for step in (1, STEPS):
        _assert_trees(_flax(kind, ranks[0]["params"][step]), jax_after[step], 0, PARAM_ATOL,
                      step)
    # every rank holds the same parameters and reads the same global loss
    for other in ranks[1:]:
        assert [r["loss"] for r in other["res"]] == [r["loss"] for r in ranks[0]["res"]]
        for name, value in ranks[0]["params"][STEPS].items():
            assert torch.equal(other["params"][STEPS][name], value), name


def test_multi_step_equals_single_steps(runs):
    out, _ = runs
    for rank in out["multi"]:
        assert rank["steps"] == STEPS and len(rank["loss"]) == STEPS
        for name, value in rank["single"].items():
            assert torch.equal(rank["multi"][name], value), name


def test_resident_train_matches_single_process(runs):
    out, _ = runs
    single = out["single"][0]
    for rank in out["resident"]:
        assert rank["steps"] == single["steps"] == 4
        for name, value in single["params"].items():
            np.testing.assert_allclose(rank["params"][name].numpy(), value.numpy(),
                                       atol=2e-3, err_msg=name)
        assert "does not split over 2 data ranks" in rank["refused"]


def test_training_cli_over_the_data_mesh(runs):
    """``--num-devices 2`` with two processes: the CLI trains its 2 steps
    over the data mesh and rank 0 writes the checkpoint; a count that is not
    the number of processes is refused."""
    out, _ = runs
    saved = [f for _, _, files in os.walk(os.path.join(out["cli_dir"], "models"))
             for f in files]
    assert saved, "no checkpoint written"
    for rank in out["cli"]:
        assert "--num-devices 3 with 2 processes" in rank["refused"]


def test_tensor_parallel_matches_jax(runs):
    out, ref = runs
    ranks = out["tp"]
    jax_loss, jax_params = ref["tp"]
    first = ranks[0]["res"][0]["loss"]
    np.testing.assert_allclose(first, jax_loss, rtol=LOSS_RTOL)
    _assert_trees(_flax("plain", ranks[0]["params"]), jax_params, 5e-4, 5e-6, 1)
    losses = [r["loss"] for r in ranks[0]["res"]]
    assert losses[-1] < losses[0]
    for other in ranks[1:]:
        assert [r["loss"] for r in other["res"]] == losses


def test_tensor_parallel_shardings(runs):
    """qkv is split by its output rows, head by head within q, k and v (the
    JAX kernel's columns, P(None, "model")); ff1 likewise; out_proj and ff2
    by their input columns; the rest whole. Rank r of the model axis holds
    head r (4 heads over 4 ranks)."""
    out, ref = runs
    ranks = out["tp"]
    dims = ranks[0]["dims"]
    qkv = [k for k in dims if k.endswith("qkv.weight")]
    assert qkv and all(dims[k] == 0 for k in qkv)
    assert all(dims[k] == 0 for k in dims if k.endswith(("ff1.weight", "ff1.bias")))
    assert all(dims[k] == 1 for k in dims if k.endswith(("ff2.weight", "out_proj.weight")))
    assert all(dims[k] is None for k in dims if k.endswith(("ff2.bias", "out_proj.bias")))
    d, f, m = BASE["d_model"], BASE["dim_feedforward"], 4
    for global_rank, rank in enumerate(ranks):
        model_rank = global_rank % m                 # mesh (2, 4): rank = 4 * data + model
        shapes = rank["local_shapes"]
        for k in qkv:
            assert shapes[k] == (3 * d // m, d)
            heads = ref["init_plain"][k].reshape(3, m, d // m, d)[:, model_rank]
            assert torch.equal(rank["local_qkv"][k], heads.reshape(-1, d)), k
        assert all(shapes[k] == (f // m, d) for k in shapes if k.endswith("ff1.weight"))
        assert all(shapes[k] == (d, f // m) for k in shapes if k.endswith("ff2.weight"))


def test_tensor_parallel_refusals(runs):
    out, _ = runs
    rank = out["tp"][0]
    assert "holds whole layers" in rank["refused_whole"]
    assert "make_tp_train_step" in rank["refused_sharded"]


def test_make_mesh_2d(runs):
    out, _ = runs
    assert out["tp"][0]["mesh2"] == {"data": 4, "model": 2}
