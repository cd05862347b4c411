"""The ranks of the port's data- and tensor-parallel tests on the CPU, run as

    python tests/torch_parallel_worker.py SPEC.json [SPEC.json ...]

by ``tests/test_torch_port_parallel.py``: one process a rank of each spec,
forked from this one once it has imported the port (so that no rank imports
``torch`` again; this process starts no thread before it forks), gloo
through a file store (no port, so test workers never collide), one thread a
rank, the results written with ``torch.save`` into the spec's ``out``
directory. It imports the port alone (no JAX) and exits with the first
failing rank's code. Each job of a spec runs in turn:

- ``dp``: ``steps`` data-parallel steps from the saved parameters on the
  saved global batch, each rank on its rows; the results of each step and
  the parameters after step 1 and the last;
- ``multi``: ``make_parallel_multi_step`` over K stacked batches against K
  single data-parallel steps from the same state;
- ``resident``: the training loop ``train()`` on its resident corpus over
  the data mesh, and the refusal of a batch the ranks do not divide (in a
  spec of one rank: the single-process ``train()``, no mesh);
- ``cli``: the training CLI's ``main()`` with ``--num-devices`` equal to the
  ranks (the mesh from this process group, as ``torchrun`` would give it),
  and its refusal of a count that is not the number of processes;
- ``tp``: the tensor-parallel step on a data x model mesh, its shardings,
  the parameters gathered after step 1, the losses, the refusals of the two
  paths, and the shape of a second mesh.
"""
import json
import multiprocessing
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from deepsvg_tpu_torch.models import ModelConfig, SVGTransformer
from deepsvg_tpu_torch.parallel import (
    gather_params_tp, make_mesh, make_parallel_multi_step, make_parallel_train_step,
    make_tp_train_step, shard_batch, shard_state_tp, state_tp_shardings)
from deepsvg_tpu_torch.training import constant, create_train_state, make_optimizer, train_step


def _state(job):
    model = SVGTransformer(ModelConfig(**job["cfg"]))
    model.load_state_dict(torch.load(job["init"]))
    optimizer = make_optimizer(constant(job["lr"]))
    return model, optimizer, create_train_state(model, optimizer, init=False)


def _batch(job):
    with np.load(job["batch"]) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _floats(res):
    return {k: float(v) for k, v in res.items()}


def dp(job, mesh, rank):
    model, optimizer, state = _state(job)
    step = make_parallel_train_step(model, optimizer, job["model_args"], mesh)
    local = shard_batch(_batch(job), mesh)
    out = {"res": [], "params": {}}
    for i in range(job["steps"]):
        state, res = step(state, local, job["weights"])
        out["res"].append(_floats(res))
        if i + 1 in (1, job["steps"]):
            out["params"][i + 1] = _params(state.model)
    return out


def multi(job, mesh, rank):
    k = job["steps"]
    model, optimizer, state = _state(job)
    one = make_parallel_train_step(model, optimizer, job["model_args"], mesh)
    batch = shard_batch(_batch(job), mesh)
    for _ in range(k):
        state, _ = one(state, batch, job["weights"])
    single = _params(state.model)
    model, optimizer, state = _state(job)
    many = make_parallel_multi_step(model, optimizer, job["model_args"], mesh,
                                    lambda step: job["weights"])
    stacked = shard_batch({key: torch.stack([v] * k) for key, v in _batch(job).items()},
                          mesh, batch_dim=1)
    state, res = many(state, stacked)
    return {"single": single, "multi": _params(state.model), "steps": state.step,
            "loss": res["loss"].tolist()}


def resident(job, mesh, rank):
    from deepsvg_tpu_torch.configs.test_tiny import Config
    from deepsvg_tpu_torch.data.synthetic import SyntheticIconDataset
    from deepsvg_tpu_torch.training.train import train

    def config(batch_size):
        cfg = Config(1)
        cfg.device_resident, cfg.steps_per_dispatch, cfg.num_epochs = True, 2, 2
        cfg.loader_num_workers = 0
        cfg.batch_size = batch_size
        cfg.get_weights = lambda step, epoch: job["weights"]
        return cfg

    ds = SyntheticIconDataset(n=job["n_icons"], seed=0, max_num_groups=3, max_seq_len=6)
    state, _ = train(config(job["batch_size"]), "mres", f"dp{job['world']}",
                     log_dir=job["log_dir"], debug=True, dataset=ds, max_steps=job["steps"],
                     device="cpu", mesh=mesh if job["world"] > 1 else None)
    if job["world"] == 1:        # the single-process run
        return {"params": _params(state.model), "steps": state.step}
    try:
        train(config(job["batch_size"] + 1), "mres", "odd", log_dir=job["log_dir"],
              debug=True, dataset=ds, max_steps=1, device="cpu", mesh=mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"params": _params(state.model), "steps": state.step, "refused": refused}


def cli(job, mesh, rank):
    from deepsvg_tpu_torch.training import train as train_mod

    def run(n):
        sys.argv = ["train", "--config-module", "deepsvg_tpu_torch.configs.test_tiny",
                    "--num-devices", str(n), "--device", "cpu", "--max-steps",
                    str(job["steps"]), "--log-dir", job["log_dir"]]
        train_mod.main()

    run(job["world"])
    try:
        run(job["world"] + 1)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"refused": refused}


def tp(job, mesh, rank):
    model, optimizer, state = _state(job)
    tp_mesh = make_mesh(job["world"], model_axis="model", n_model=job["n_model"])
    other = make_mesh(job["world"], model_axis="model", n_model=2)
    out = {"mesh2": dict(zip(other.mesh_dim_names, other.shape))}
    try:
        make_tp_train_step(model, optimizer, job["model_args"], tp_mesh, state)
    except ValueError as e:
        out["refused_whole"] = str(e)
    tp_state = shard_state_tp(state, tp_mesh)
    try:
        train_step(tp_state, shard_batch(_batch(job), tp_mesh), job["weights"], optimizer,
                   job["model_args"])
    except ValueError as e:
        out["refused_sharded"] = str(e)
    dims = state_tp_shardings(tp_state, tp_mesh)
    out["dims"] = dims
    out["local_shapes"] = {k: tuple(v.shape) for k, v in tp_state.model.named_parameters()}
    out["local_qkv"] = {k: v.detach().clone() for k, v in tp_state.model.named_parameters()
                        if k.endswith("qkv.weight")}
    step = make_tp_train_step(model, optimizer, job["model_args"], tp_mesh, tp_state)
    local = shard_batch(_batch(job), tp_mesh)
    out["res"] = []
    for i in range(job["steps"]):
        tp_state, res = step(tp_state, local, job["weights"])
        out["res"].append(_floats(res))
        if i == 0:
            out["params"] = gather_params_tp(tp_state)
    return out


JOIN_TIMEOUT = 200   # seconds for all ranks, well inside the test's own limit

JOBS = {"dp": dp, "multi": multi, "resident": resident, "cli": cli, "tp": tp}


def run_rank(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}", rank=rank,
                            world_size=spec["world"])
    try:
        mesh = make_mesh(spec["world"])
        for job in spec["jobs"]:
            result = JOBS[job["kind"]](dict(job, world=spec["world"]), mesh, rank)
            torch.save(result, os.path.join(spec["out"], f"{job['name']}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main(spec_paths: list) -> int:
    ctx = multiprocessing.get_context("fork")
    procs = []
    for path in spec_paths:
        with open(path) as f:
            world = json.load(f)["world"]
        procs += [ctx.Process(target=run_rank, args=(path, rank)) for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return next((p.exitcode for p in procs if p.exitcode), 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
