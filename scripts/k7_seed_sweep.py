"""K7's gradient readings over many random inputs: its margin to chip_smoke's limits.

    python3 scripts/k7_seed_sweep.py [--tree DIR] [--seeds N] [--only TEXT] [--tag T]

``chip_smoke.py`` holds K7, the fused training stack, on one draw of inputs.
This script draws ``--seeds`` of them for each of the cases below and reads,
for each of the twelve gradients, what chip_smoke's ``check_stack_train``
reads, and two readings that tell a kernel fault from rounding:

- K7 against its plain version in the same type, as it is and with the ReLU
  units aligned (relative RMS error, and the worst element's error over the
  largest entry): chip_smoke's readings, beside its limits;
- K7, and the plain version with K7's units, each against a float32 truth:
  the plain version in full float32 (no TF32) with K7's units, on the
  weights as the type reads them (bfloat16 weights rounded once);
- the chain of L K4 calls with the per-layer seeds against K7 (chip_smoke's
  chain check, as it is) and against the plain version, as it is and with
  the chain's own ReLU units; and how many FF units the chain's forward
  passes that K7's does not, or the reverse.

Inputs as chip_smoke's E2 stage: the trained flagship's E2 layers (D=256, 8
heads, F=512), an input through E2's position table, the visibility mask of
a generated batch with sequence 0 fully masked, no injection; the input, the
output gradient, the mask and the dropout seed from the seed. Cases: bfloat16
at B=60 (rates 0 and 0.1) and B=64 (0.1), four layers; float32 at B=60, two
layers (0.1) and four (0), and at B=64, four layers (0.1). ``--tree DIR``
runs the port at DIR (an archive of another commit) on the same draws. One
line per case and seed, a summary per case, and the whole as JSON in
``chiprun_out/k7_sweep[_T].json``. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "docs", "artifacts", "full_run_final_params.msgpack")
CASES = (("bfloat16", 60, 0.0, 4), ("bfloat16", 60, 0.1, 4), ("bfloat16", 64, 0.1, 4),
         ("float32", 60, 0.1, 2), ("float32", 60, 0.0, 4), ("float32", 64, 0.1, 4))


def rel(got, want) -> dict:
    """Relative RMS error, and the worst element's error over the largest
    entry of ``want``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = want.abs().max().clamp_min(1e-30)
    return {"rms": ((got - want).norm() / want.norm().clamp_min(1e-30)).item(),
            "worst": (diff.max() / scale).item()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default="", help="the repository whose port runs")
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--tag", default="")
    parser.add_argument("--only", default="",
                        help="run only the cases whose name holds this text")
    opts = parser.parse_args()
    sys.path.insert(0, os.path.abspath(opts.tree) if opts.tree else ROOT)
    if not torch.cuda.is_available():
        print("k7_seed_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, load_model
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M

    # this checkout's limits and helpers, on the port the tree names
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = gpu_fast(hierarchical_ordered())
    model = load_model(CHECKPOINT, cfg, device=dev)
    enc = model.encoder
    layers = list(enc.hierarchical_encoder.layers)
    g, d, n_heads = cfg.max_num_groups, cfg.d_model, layers[0].n_heads
    limits = {"rms": cs.TOL_STACK_GRAD_RMS, "rms_same_gate": cs.TOL_STACK_GRAD_RMS_SAME_GATE,
              "worst": cs.TOL_GRAD_WORST, "worst_same_gate": cs.TOL_GRAD_WORST_SAME_GATE,
              "chain_rms": cs.TOL_STACK_GRAD_RMS}
    names = cs.GRAD_NAMES
    out: dict = {"card": card, "tree": opts.tree or ".", "limits": limits, "cases": {}}
    for dtype_name, b, rate, n_layers in CASES:
        dt = getattr(torch, dtype_name)
        case = f"{dtype_name} B={b} L={n_layers} rate {rate}"
        if opts.only not in case:
            continue
        runs = []
        for seed in range(opts.seeds):
            gen = torch.Generator(device=dev).manual_seed(1000 + seed)
            batch = generate_batch(np.random.default_rng(seed), b, cfg.max_num_groups,
                                   cfg.max_seq_len)
            with torch.no_grad():
                vis = M.visibility_mask(torch.from_numpy(batch["commands"]).to(dev))
                mask = key_padding_to_additive(~vis)
                mask[0] = float("-inf")
                x0 = enc.hierarchical_PE(torch.randn(b, g, d, device=dev, generator=gen))
            g_out = torch.randn(x0.shape, device=dev, generator=gen).to(dt)
            masters = cs.stacked_masters(layers[:n_layers])
            x = x0.detach().to(dt).requires_grad_()
            bias = torch.zeros(n_layers, b, d, device=dev, dtype=dt, requires_grad=True)
            leaves = [x, bias, *masters]
            call = (x, bias, *masters, mask, 4321 + seed, n_heads, False, rate, dt)
            k7 = stack_vjp.fused_stack_train(*call)
            gates = stack_vjp.kernel_relu_gates(k7)
            grads = torch.autograd.grad(k7, leaves, g_out)
            ref = torch.autograd.grad(stack_vjp.plain_stack_train(*call), leaves, g_out)
            aligned = torch.autograd.grad(stack_vjp.plain_stack_train(*call, relu_gates=gates),
                                          leaves, g_out)
            # the truth: full float32 with K7's units, on the weights as the
            # type reads them
            leaves32 = [t.detach().to(dt).float().requires_grad_() for t in leaves]
            tf32 = torch.backends.cuda.matmul.allow_tf32
            try:
                torch.backends.cuda.matmul.allow_tf32 = False
                truth = torch.autograd.grad(
                    stack_vjp.plain_stack_train(*leaves32, mask, 4321 + seed, n_heads, False,
                                                rate, torch.float32, relu_gates=gates),
                    leaves32, g_out.float())
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            chain_out, chain_gates = cs.k4_chain(layer_vjp, *call, with_gates=True)
            chain = torch.autograd.grad(chain_out, leaves, g_out)
            chain_aligned = torch.autograd.grad(
                stack_vjp.plain_stack_train(*call, relu_gates=chain_gates), leaves, g_out)
            flips = int((chain_gates != gates).sum())
            grad_rows = {}
            for i, n in enumerate(names):
                as_is, gate = rel(grads[i], ref[i]), rel(grads[i], aligned[i])
                # chip_smoke scales the aligned comparison by the plain
                # version's largest entry as it is
                worst_gate = ((grads[i].float() - aligned[i].float()).abs().max()
                              / ref[i].float().abs().max().clamp_min(1e-30)).item()
                grad_rows[n] = {
                    "rms": as_is["rms"], "worst": as_is["worst"],
                    "rms_same_gate": gate["rms"], "worst_same_gate": worst_gate,
                    "k7_vs_truth": rel(grads[i], truth[i]),
                    "plain_vs_truth": rel(aligned[i], truth[i]),
                    "chain_vs_k7_rms": rel(grads[i], chain[i])["rms"],
                    "chain_vs_plain_rms": rel(chain[i], ref[i])["rms"],
                    "chain_vs_plain_same_gate_rms": rel(chain[i], chain_aligned[i])["rms"]}
            # where dx's worst aligned element lies
            dx_err = (grads[0].float() - aligned[0].float()).abs()
            flat = int(dx_err.argmax())
            row, pos = flat // (g * d), flat // d % g
            where = {"row": row, "group": pos, "visible_keys": int(vis[row].sum()),
                     "ref_over_max": (aligned[0].float().reshape(-1)[flat].abs()
                                      / aligned[0].float().abs().max()).item()}
            over = sorted({f"d{n} {k}" for n, r in grad_rows.items()
                           for k in ("rms", "rms_same_gate", "worst", "worst_same_gate")
                           if r[k] > limits[k]}
                          | {f"chain d{n}" for n, r in grad_rows.items()
                             if r["chain_vs_k7_rms"] > limits["chain_rms"]})
            runs.append({"seed": seed, "grads": grad_rows, "dx_worst_where": where,
                         "chain_units_flipped": flips, "over_limits": over})
            top = lambda key: max(grad_rows, key=lambda n: grad_rows[n][key])  # noqa: E731
            wg, ch = top("worst_same_gate"), top("chain_vs_k7_rms")
            print(f"{case} seed {seed}: aligned worst {grad_rows[wg]['worst_same_gate']:.4f} "
                  f"(d{wg}; limit {limits['worst_same_gate']}; K7 vs truth "
                  f"{grad_rows[wg]['k7_vs_truth']['worst']:.4f}, plain vs truth "
                  f"{grad_rows[wg]['plain_vs_truth']['worst']:.4f}); aligned RMS at most "
                  f"{max(r['rms_same_gate'] for r in grad_rows.values()):.4f}; as it is RMS at "
                  f"most {max(r['rms'] for r in grad_rows.values()):.4f}; chain vs K7 "
                  f"{grad_rows[ch]['chain_vs_k7_rms']:.4f} (d{ch}; chain vs plain "
                  f"{grad_rows[ch]['chain_vs_plain_rms']:.4f}, with the chain's units "
                  f"{grad_rows[ch]['chain_vs_plain_same_gate_rms']:.4f}, K7 vs plain "
                  f"{grad_rows[ch]['rms']:.4f}; {flips} units flipped); dx's worst at row {where['row']} group "
                  f"{where['group']} ({where['visible_keys']} visible keys, |ref| "
                  f"{where['ref_over_max']:.3f} of the largest); over: {over or 'none'}",
                  flush=True)
            del k7, grads, ref, aligned, truth, chain, chain_aligned
        summary = {k: max(r["grads"][n][k] for r in runs for n in names)
                   for k in ("rms", "rms_same_gate", "worst", "worst_same_gate",
                             "chain_vs_k7_rms", "chain_vs_plain_rms",
                             "chain_vs_plain_same_gate_rms")}
        summary["k7_vs_truth_worst"] = max(r["grads"][n]["k7_vs_truth"]["worst"]
                                           for r in runs for n in names)
        summary["plain_vs_truth_worst"] = max(r["grads"][n]["plain_vs_truth"]["worst"]
                                              for r in runs for n in names)
        summary["chain_units_flipped"] = max(r["chain_units_flipped"] for r in runs)
        summary["seeds_over"] = sum(bool(r["over_limits"]) for r in runs)
        out["cases"][case] = {"summary": summary, "runs": runs}
        print(f"{case}: over {opts.seeds} seeds, {summary['seeds_over']} over a limit; "
              + ", ".join(f"{k} at most {v:.4g}" for k, v in summary.items()
                          if k != "seeds_over"), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"k7_sweep{'_' + opts.tag if opts.tag else ''}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
