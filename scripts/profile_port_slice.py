"""Where the PyTorch port spends its time on a CUDA card.

    python3 scripts/profile_port_slice.py            # the inference path
    python3 scripts/profile_port_slice.py --train    # the training step, B=128
    python3 scripts/profile_port_slice.py --recipe   # the training step, B=60

Loads the trained flagship checkpoint into the port (bfloat16 compute,
float32 masters). Without ``--train`` it runs greedy one-shot encode+decode
(``deepsvg_tpu_torch.models.one_shot_sample``) on N=1024 synthetic icons
(seed 0, the batch ``chip_smoke.py`` times); with ``--train`` it runs
``deepsvg_tpu_torch.training.train_step`` at B=128, dropout 0.1, constant
learning rate 1e-3 on one batch (seed 0), as ``chip_smoke.py`` does. Either
runs under ``torch.profiler`` for 5 calls after warm-up calls. ``--recipe``
runs the step at the recipe's batch, B=60, where E2 and D2 take the fused
stack kernel K7 (B=128 is over the stack gate). Each prints the
device time by kernel name, the device's busy time against the host's wall
time over the window (the idle share), and the card's name and power limit.
The full table goes to ``slice_profile.txt``, ``train_profile.txt`` or
``train_recipe_profile.txt`` in the output directory under the repository
root. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHECKPOINT = os.path.join(ROOT, "docs", "artifacts", "full_run_final_params.msgpack")
N = 1024
B_TRAIN = 128
B_RECIPE = 60
ITERS = 5


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train", action="store_true", help="profile the training step")
    parser.add_argument("--recipe", action="store_true",
                        help="profile the training step at the recipe batch B=60")
    opts = parser.parse_args()
    opts.train = opts.train or opts.recipe
    b_train = B_RECIPE if opts.recipe else B_TRAIN
    if not torch.cuda.is_available():
        print("profile_port_slice: no CUDA device is available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, load_model, one_shot_sample
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = gpu_fast(hierarchical_ordered())
    model = load_model(CHECKPOINT, cfg, device="cuda")
    size = b_train if opts.train else N
    batch = generate_batch(np.random.default_rng(0), size, cfg.max_num_groups, cfg.max_seq_len)
    commands = torch.from_numpy(batch["commands"]).cuda()
    args = torch.from_numpy(batch["args"]).cuda()
    if opts.train:
        optimizer = make_optimizer(constant(1e-3))
        state = create_train_state(model, optimizer, init=False)
        data = {"commands": commands, "args": args}
        weights = dict(loss_visibility_weight=1.0, loss_cmd_weight=1.0, loss_args_weight=2.0)
        model_args = ["commands", "args", "commands", "args"]
        what, warmup = f"train_step B={b_train}", 3
        out_name = "train_recipe_profile.txt" if opts.recipe else "train_profile.txt"

        def run():
            train_step(state, data, weights, optimizer, model_args)
    else:
        what, out_name, warmup = f"one_shot_sample N={N}", "slice_profile.txt", 2

        def run():
            one_shot_sample(model, commands, args)
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS

    rows = [(e.key, e.device_time_total / 1e3 / ITERS, e.count / ITERS)
            for e in prof.key_averages() if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in rows)
    lines = [f"{card}; {what}; per call: wall {wall_ms:.4f} ms (host clock, under the "
             f"profiler), device busy {busy_ms:.4f} ms, idle share "
             f"{1 - busy_ms / wall_ms:.4f}, {sum(c for _, _, c in rows):.0f} device launches"
             if busy_ms else
             f"{card}; {what}; the profiler recorded no device time: not measured"]
    for name, ms, count in rows:
        lines.append(f"  {ms:10.4f} ms  {ms / busy_ms:7.2%}  x{count:<6.1f} {name[:90]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", out_name), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=60))
    print("\n".join(lines[:32]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
