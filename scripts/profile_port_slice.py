"""Where the PyTorch port's inference slice spends its time on a CUDA card.

    python3 scripts/profile_port_slice.py

Loads the trained flagship checkpoint into the port (bfloat16), runs greedy
one-shot encode+decode (``deepsvg_tpu_torch.models.one_shot_sample``) on
N=1024 synthetic icons (seed 0, the batch ``chip_smoke.py`` times) under
``torch.profiler`` for 5 calls after two warm-up calls, and prints the device time by kernel name,
the device's busy time against the host's wall time over the window (the
idle share), and the card's name and power limit. The full table goes to
``chiprun_out/slice_profile.txt``. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

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
ITERS = 5


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port_slice: no CUDA device is available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, load_model, one_shot_sample

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = gpu_fast(hierarchical_ordered())
    model = load_model(CHECKPOINT, cfg, device="cuda")
    batch = generate_batch(np.random.default_rng(0), N, cfg.max_num_groups, cfg.max_seq_len)
    commands = torch.from_numpy(batch["commands"]).cuda()
    args = torch.from_numpy(batch["args"]).cuda()
    for _ in range(2):
        one_shot_sample(model, commands, args)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            one_shot_sample(model, commands, args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS

    rows = [(e.key, e.device_time_total / 1e3 / ITERS, e.count // ITERS)
            for e in prof.key_averages() if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in rows)
    lines = [f"{card}; N={N}; per call: wall {wall_ms:.4f} ms (host clock, under the "
             f"profiler), device busy {busy_ms:.4f} ms, idle share "
             f"{1 - busy_ms / wall_ms:.4f}" if busy_ms else
             f"{card}; N={N}; the profiler recorded no device time: not measured"]
    for name, ms, count in rows:
        lines.append(f"  {ms:10.4f} ms  {ms / busy_ms:7.2%}  x{count:<4d} {name[:90]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "slice_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=40))
    print("\n".join(lines[:25]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
