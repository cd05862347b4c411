"""The training loop and its command line, counterpart of
``deepsvg_tpu/training/train.py``.

    python -m deepsvg_tpu_torch.training.train \\
        --config-module deepsvg_tpu_torch.configs.hierarchical_ordered \\
        --dataset-module deepsvg_tpu_torch.data.synthetic --max-steps 100

It runs on the CUDA card unless ``--device cpu`` is given (the plain
versions of the kernels), and raises when it finds no card.

The loop keeps the host off the device's critical path:

- the dataset lives on the card when it can (``data/resident.py``); each
  loop iteration then runs K steps whose batches are gathered on the card
  from ``[K, B]`` icon indices, the only data that crosses from the host;
- the step count is a host integer, and a step's results stay on the card
  as ``[K]`` tensors until a cadence reads them;
- cadences (log, visualize, checkpoint) are rounded up to multiples of K and
  fire when a K-step window crosses them, so a resumed count that is not a
  multiple of K keeps them;
- the log fetch, the checkpoint write and the visualize hook run on one
  background worker each (``cfg.async_host_io``). A checkpoint's snapshot is
  taken on the card before the next step is enqueued, because the optimizer
  updates the parameters in place. The loop thread issues the launches, so
  while the workers run the GIL is handed back every millisecond (not every
  5) and the checkpoint and visualize workers run at the lowest priority.

A checkpoint holds the loop's place in its epoch, so a resumed run goes on
with the batches the saved run would have taken next. Epoch ``e`` (from 0)
is shuffled by the loader's generator of epoch ``e + 2``: the JAX package's
numbering, whose initialisation drew epoch 1. (The JAX loop restarts the
epoch from its first batch on resume, and numbers the epochs of a resumed
run from there.)
"""
from __future__ import annotations

import argparse
import copy
import itertools
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np
import torch

from ..data.loader import DataLoader, prefetch_to_device
from ..data.resident import build_resident_arrays, epoch_icon_permutation
from .checkpoint import begin_save, finish_save, load_ckpt, load_model, prune_ckpts, save_ckpt
from .config import TrainConfig, load_config, load_dataset
from .stats import Stats, Timer, TrainVars
from .trainer import create_train_state, train_multi_step, train_resident_multi_step

# the epoch number of the loader's shuffle for loop epoch 0
FIRST_EPOCH_NUMBER = 2


def set_seed(seed: int = 42):
    import random

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` means the CUDA card, and raises without one."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train on the "
                           "CPU with the plain versions of the kernels")
    return device


def choose_k(cfg, n_items: int, step: int, max_steps, resident: bool, profile: bool) -> int:
    """Steps per loop iteration. Resident data with K unset takes 8; K never
    exceeds an epoch's batches, and under a step budget it is the largest
    divisor of what remains, so the budget is met exactly."""
    raw_k = getattr(cfg, "steps_per_dispatch", 1)
    k = 1 if profile else max(int(raw_k or 1), 1)
    if not resident:
        return k
    if raw_k in (None, 1):
        k = 8
    k = max(min(k, max(n_items // cfg.batch_size, 1)), 1)
    for budget in (max_steps, cfg.num_steps):
        if budget is not None:
            rem = max(budget - step, 1)
            k = max(min(k, rem), 1)
            while rem % k:
                k -= 1
    return k


def train(cfg: TrainConfig, model_name: str, experiment_name: str = "",
          log_dir: str = "./logs", debug: bool = False, resume: bool = False,
          dataset=None, max_steps: int | None = None,
          profile_steps: tuple[int, int] | None = None, device=None):
    """Train ``cfg``'s model; returns ``(state, stats)``.

    ``profile_steps=(start, stop)`` traces those steps with
    ``torch.profiler`` into ``<log_dir>/profile/<run>/`` (a Chrome trace and
    a table of device time by kernel)."""
    device = resolve_device(device)
    print("Parameters")
    cfg.print_params()
    if dataset is None:
        dataset = load_dataset(cfg)
    loader = DataLoader(dataset, batch_size=cfg.batch_size, shuffle=True, drop_last=True,
                        num_workers=cfg.loader_num_workers,
                        worker_mode=getattr(cfg, "loader_worker_mode", "thread"))
    steps_per_epoch = max(len(loader), 1)
    model_args = cfg.model_args

    stats = Stats(num_epochs=cfg.num_epochs, num_steps=cfg.num_steps,
                  steps_per_epoch=steps_per_epoch, stats_to_print=cfg.stats_to_print)
    train_vars = TrainVars()
    timer = Timer()
    stats.stats["train"]
    cfg.set_train_vars(train_vars, dataset)

    run_id = f"{model_name}_{experiment_name}_{datetime.now().strftime('%b%d_%H-%M-%S')}"
    summary_writer = _make_summary_writer(
        os.path.join(log_dir, "tensorboard", "debug" if debug else "full", run_id))
    checkpoint_dir = os.path.join(log_dir, "models", model_name, experiment_name)
    visualization_dir = os.path.join(log_dir, "visualization", model_name, experiment_name)
    os.makedirs(checkpoint_dir, exist_ok=True)
    os.makedirs(visualization_dir, exist_ok=True)

    model = cfg.make_model().to(device)
    optimizer = cfg.make_optimizer(steps_per_epoch)
    state = create_train_state(model, optimizer)
    if cfg.pretrained_path is not None:
        load_model(cfg.pretrained_path, model)
    position = None
    if resume:
        saved: dict = {}
        state, found = load_ckpt(checkpoint_dir, state, cfg, stats, train_vars, extra=saved)
        if found:
            position = saved.get("position")
            print(f"Resuming model at step {state.step}")

    def weights_fn(step):
        return cfg.get_weights(step, 0)

    # the dataset on the card, in its flattened row layout
    resident = None
    if profile_steps is None and getattr(cfg, "device_resident", "auto") \
            and getattr(cfg, "steps_per_dispatch", 1) != 0:
        t0 = time.time()
        built = build_resident_arrays(
            dataset, model_args, max_bytes=getattr(cfg, "device_resident_max_bytes", 4 << 30),
            num_workers=cfg.loader_num_workers)
        if built is not None:
            data_host, n_icons, n_augs = built
            item_shapes = {k: v.shape[1:] for k, v in data_host.items()}
            t_build, t0 = time.time() - t0, time.time()
            data_dev = {k: torch.from_numpy(np.ascontiguousarray(v.reshape(len(v), -1)))
                        .to(device) for k, v in data_host.items()}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            resident = (data_dev, n_icons, n_augs, item_shapes)
            mb = sum(v.nbytes for v in data_host.values()) / 2 ** 20
            print(f"device-resident dataset: {len(dataset)} items ({n_augs} aug variants), "
                  f"{mb:.1f} MB on {device} [build {t_build:.1f}s, upload "
                  f"{time.time() - t0:.1f}s]")
    K = choose_k(cfg, len(dataset), state.step, max_steps, resident is not None,
                 profile_steps is not None)
    if resident is not None:
        print(f"K={K} steps per loop iteration")

    # cadences rounded up to multiples of K (locally: cfg is saved in checkpoints)
    log_every, val_every, ckpt_every = cfg.log_every, cfg.val_every, cfg.ckpt_every
    if K > 1:
        log_every, val_every, ckpt_every = (-(-v // K) * K
                                            for v in (log_every, val_every, ckpt_every))
    lr_schedule = cfg.make_lr_schedule(steps_per_epoch)

    if max_steps is not None or cfg.num_epochs is None:
        epoch_range = itertools.count()
    else:
        epoch_range = range(cfg.num_epochs)
    if position is not None:
        start_epoch, start_batch = position
    else:
        start_epoch, start_batch = state.step // steps_per_epoch, 0

    def epoch_batches(epoch: int, skip: int):
        """This epoch's batches from the ``skip``-th, staged on the device:
        ``{"idx": [K, B]}`` icon indices with resident data, else
        ``[K, ...]``-stacked wire-format batches."""
        number = epoch + FIRST_EPOCH_NUMBER
        if resident is not None:
            idx = epoch_icon_permutation(len(dataset), resident[1], cfg.batch_size,
                                         loader.seed, number)[skip:]
            chunks = ({"idx": idx[i:i + K]} for i in range(0, (len(idx) // K) * K, K))
            return prefetch_to_device(chunks, device, compress=False)
        return prefetch_to_device(loader.epoch_batches(number, skip), device,
                                  keys=set(model_args), stack_steps=K)

    async_io = bool(getattr(cfg, "async_host_io", True)) and not debug
    pools = {}
    futures = {"log": None, "ckpt": None, "viz": None}
    viz_skipped = 0
    old_switch = sys.getswitchinterval()
    if async_io:
        pools = {name: ThreadPoolExecutor(max_workers=1, thread_name_prefix=name)
                 for name in ("log", "ckpt", "viz")}
        sys.setswitchinterval(0.001)

    def wait(name):
        f, futures[name] = futures[name], None
        if f is not None:
            f.result()            # a worker's failure surfaces here

    def ckpt_cycle(ctx):
        _deprioritize()
        finish_save(ctx)
        prune_ckpts(checkpoint_dir, cfg.ckpt_keep_last, cfg.ckpt_keep_every)

    def viz_cycle(model_copy, step, epoch):
        _deprioritize()
        t0 = time.time()
        try:
            cfg.visualize(model_copy, train_vars, step, epoch, summary_writer, visualization_dir)
            print(f"[visualize] step {step}: background cycle {time.time() - t0:.1f}s",
                  flush=True)
        except Exception as e:  # a render never stops training
            print(f"[visualize] background cycle failed at step {step}: {e!r}", flush=True)

    step_host = state.step
    beat = {"t": time.time(), "step": step_host, "done": False}
    if getattr(cfg, "stall_watchdog_s", None):
        def watchdog(limit=float(cfg.stall_watchdog_s)):
            while not beat["done"]:
                time.sleep(min(limit / 4, 30.0))
                if beat["done"]:
                    return
                stale = time.time() - beat["t"]
                if stale > limit:
                    print(f"[watchdog] no loop progress for {stale:.0f}s (last step "
                          f"{beat['step']}): exiting 3 for the orchestrator to resume",
                          flush=True)
                    os._exit(3)
        threading.Thread(target=watchdog, daemon=True).start()

    profiler = None
    done = False
    position = (start_epoch, start_batch)
    try:
        for epoch in epoch_range:
            if done:
                break
            if epoch < start_epoch:
                continue
            print(f"Epoch {epoch + 1}")
            batches_done = start_batch if epoch == start_epoch else 0
            for batch in epoch_batches(epoch, batches_done):
                # budget guard before the steps run
                if ((cfg.num_steps is not None and step_host >= cfg.num_steps)
                        or (max_steps is not None and step_host >= max_steps)):
                    done = True
                    break
                step = step_host + K
                if profile_steps is not None:
                    if step == profile_steps[0]:
                        profiler = _start_profiler(device)
                    elif step == profile_steps[1] and profiler is not None:
                        _stop_profiler(profiler, device, os.path.join(log_dir, "profile", run_id))
                        profiler = None

                if resident is not None:
                    state, res = train_resident_multi_step(
                        state, resident[0], batch["idx"], weights_fn, optimizer, model_args,
                        resident[2], resident[3])
                else:
                    state, res = train_multi_step(state, batch, weights_fn, optimizer,
                                                  model_args)
                step_host = step
                batches_done += K
                position = (epoch, batches_done)
                beat["t"], beat["step"] = time.time(), step

                if cfg.num_steps is not None and step > cfg.num_steps:
                    done = True
                    break
                if max_steps is not None and step >= max_steps:
                    done = True

                if step % log_every < K:
                    last = {k: v[-1] for k, v in res.items()}
                    weights = cfg.get_weights(step, epoch)
                    elapsed = timer.get_elapsed_time() / log_every
                    if async_io:
                        wait("log")
                        futures["log"] = pools["log"].submit(
                            _log_cycle, stats, summary_writer, last, weights, lr_schedule(step),
                            elapsed, step, epoch)
                    else:
                        _log_cycle(stats, summary_writer, last, weights, lr_schedule(step),
                                   elapsed, step, epoch)

                if step % val_every < K:
                    if async_io:
                        f = futures["viz"]
                        if f is not None and not f.done():
                            viz_skipped += 1          # still rendering: skip
                        else:
                            futures["viz"] = pools["viz"].submit(
                                viz_cycle, copy.deepcopy(model), step, epoch)
                    else:
                        timer.reset()
                        cfg.visualize(model, train_vars, step, epoch, summary_writer,
                                      visualization_dir)

                if not debug and step % ckpt_every < K:
                    if async_io:
                        wait("ckpt")                  # one save in flight, in order
                        wait("log")                   # the log worker updates stats
                        ctx = begin_save(checkpoint_dir, state, cfg, stats, train_vars,
                                         step=step, position=position)
                        futures["ckpt"] = pools["ckpt"].submit(ckpt_cycle, ctx)
                    else:
                        save_ckpt(checkpoint_dir, state, cfg, stats, train_vars,
                                  position=position)
                        prune_ckpts(checkpoint_dir, cfg.ckpt_keep_last, cfg.ckpt_keep_every)
                if done:
                    break

        if profiler is not None:
            _stop_profiler(profiler, device, os.path.join(log_dir, "profile", run_id))
        for name in ("viz", "log", "ckpt"):
            wait(name)
        if not debug:
            save_ckpt(checkpoint_dir, state, cfg, stats, train_vars, position=position)
        if viz_skipped:
            print(f"[visualize] skipped {viz_skipped} overlapping background cycles", flush=True)
    finally:
        beat["done"] = True
        sys.setswitchinterval(old_switch)
        for pool in pools.values():
            pool.shutdown(wait=False)
    return state, stats


def _deprioritize():
    """Lower the calling worker thread to the lowest scheduling priority, so
    that the loop thread gets the cores first."""
    try:
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
    except (AttributeError, OSError):
        pass


def _log_cycle(stats, summary_writer, res, weights, lr, elapsed, step, epoch):
    """A log window: fetch the step's scalars in one copy, update the stats,
    print, write TensorBoard."""
    keys = list(res)
    values = torch.stack([res[k].float() for k in keys]).cpu().tolist() if keys else []
    scalars = dict(zip(keys, values))
    scalars.update({k: float(v) for k, v in weights.items() if np.ndim(v) == 0})
    scalars["lr"] = float(lr)
    scalars["time"] = elapsed
    stats.update("train", step, epoch, scalars)
    print(stats.get_summary("train"), flush=True)
    stats.write_tensorboard(summary_writer, "train")


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.__enter__()
    return profiler


def _stop_profiler(profiler, device, out_dir):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.__exit__(None, None, None)
    os.makedirs(out_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    sort = "cuda_time_total" if device.type == "cuda" else "cpu_time_total"
    with open(os.path.join(out_dir, "kernels.txt"), "w") as f:
        f.write(profiler.key_averages().table(sort_by=sort, row_limit=60))
    print(f"profiler trace written to {out_dir}")


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass


def _make_summary_writer(path):
    """TensorBoard's writer where the package is installed, else one that
    drops everything."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(path)
    except Exception:
        return _NullWriter()


def main():
    parser = argparse.ArgumentParser(description="DeepSVG trainer (PyTorch, CUDA)")
    parser.add_argument("--config-module", type=str, required=True)
    parser.add_argument("--num-devices", type=int, default=None,
                        help="the device count the config scales its batch and learning "
                             "rate by (default 1: the port trains on one card)")
    parser.add_argument("--log-dir", type=str, default="./logs")
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--resume", action="store_true", default=False)
    parser.add_argument("--profile", type=str, default=None, metavar="START:STOP",
                        help="trace steps [START, STOP) with torch.profiler into "
                             "<log-dir>/profile/")
    parser.add_argument("--dataset-module", type=str, default=None,
                        help="override cfg.dataloader_module (e.g. "
                             "deepsvg_tpu_torch.data.synthetic to train without the "
                             "external datasets)")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many optimization steps")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args()

    device = resolve_device(args.device)
    cfg = load_config(args.config_module, args.num_devices or 1)
    model_name, experiment_name = args.config_module.split(".")[-2:]
    if args.dataset_module:
        cfg.dataloader_module = args.dataset_module
    profile_steps = None
    if args.profile:
        start, stop = args.profile.split(":")
        profile_steps = (int(start), int(stop))
    set_seed(42)
    train(cfg, model_name, experiment_name, log_dir=args.log_dir, debug=args.debug,
          resume=args.resume, profile_steps=profile_steps, max_steps=args.max_steps,
          device=device)


if __name__ == "__main__":
    sys.exit(main())
