"""Run the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

In order: print the card and its power limit; build the port's CUDA kernels
from ``deepsvg_tpu_torch/ops/csrc``; hold each kernel against its plain
PyTorch version on the card at the flagship's inference shapes; load the
trained flagship checkpoint and run greedy one-shot encode+decode at N=1024,
checking that the main path launched every kernel and that its output is
valid; compare the kernel path with the plain path at N=64; time each
kernel, its plain version, a PyTorch yardstick where one exists, and the
whole encode+decode. The second-to-last line is ``{"kernels": [...]}``, the
last ``{"ok": true, "device": {...}}``; the full record goes to
``chiprun_out/chip_smoke.json``. Any failed check raises, and the script
exits non-zero, as it does without a CUDA card or without the repo.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "docs", "artifacts", "full_run_final_params.msgpack")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_MAIN = 1024          # bench.py's batch
N_AGREE = 64
# kernel path vs plain path: the greedy head ids (command and each argument
# slot) must agree on at least AGREEMENT_MIN of the slots whose two best
# logits, on the plain path, differ by at least AGREE_MARGIN. Both paths
# round to bf16 at the same points but sum in another order, which moves
# the logits a little and flips near-ties. The limit sits between
# the sound reading and a control that must fail it: the plain path with E1
# layer 0's weights cut to 4 mantissa bits (readings in PERF.md).
AGREE_MARGIN = 1e-2
AGREEMENT_MIN = 0.995
CONTROL_DROP_BITS = 3
ITERS = 20
# H100 SXM published peaks (dense): tensor-core bf16, float32 outside the
# tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
TOL_EMBED = 1e-2               # one bf16 rounding of an exact f32 sum
# the layer rounds its intermediates (LN outputs, QKV, probabilities, context,
# FF hidden) to bf16 at the same points as its plain version, but the f32 sums
# before each rounding run in another order. So an output element lands up to
# one bf16 step of itself apart (at most 2^-7 |out|), and a flipped
# intermediate adds an absolute error that does not shrink with the output
# (where the residual sum cancels, the output is small). Elementwise:
# |err| <= TOL_LAYER_ATOL + TOL_LAYER_RTOL |out|, and a bound on the relative
# RMS error. The limits are a few times what sound runs read at these shapes
# (the script prints both readings; PERF.md keeps them).
TOL_LAYER_ATOL = 0.1
TOL_LAYER_RTOL = 2.0 ** -7
TOL_LAYER_RMS = 1e-3
TOL_HEAD_MARGIN = 1e-2         # ids may differ only below this top-2 logit gap


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_median_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` separately timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of moving the bytes once at the HBM
    rate and doing the operations at the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def head_slots(fcn):
    """(offset, width) of the command slot and each argument slot in the
    packed head."""
    from deepsvg_tpu_torch.ops.head import _round_up
    cw, aw = _round_up(fcn.n_commands), _round_up(fcn.args_dim)
    return [(0, fcn.n_commands)] + [(cw + i * aw, fcn.args_dim) for i in range(fcn.n_args)]


def head_ids_and_margins(model, commands, args):
    """One forward with the argmax head: ids ``[R, 1 + n_args]``, and the gap
    between the two best float32 logits of each slot, from the decoder
    output that the head read."""
    fcn = model.decoder.fcn
    seen = {}

    def grab(module, inputs, out):
        seen["x"] = inputs[0]

    hook = fcn.register_forward_hook(grab)
    try:
        res = model(commands, args, argmax_head=True)
    finally:
        hook.remove()
    x = seen["x"].reshape(-1, seen["x"].shape[-1]).float()
    logits = x @ fcn.w_packed.float().t() + fcn.b_packed.float()
    top2 = [logits[:, o:o + w].topk(2, dim=-1).values for o, w in head_slots(fcn)]
    margins = torch.stack([t[:, 0] - t[:, 1] for t in top2], dim=1)
    ids = torch.cat([res["command_ids"].reshape(-1, 1),
                     res["args_ids"].reshape(-1, fcn.n_args)], dim=1)
    return ids, margins, res


def id_agreement(ids, ids_ref, margins_ref, min_margin: float) -> dict:
    """Share of equal ids, commands and arguments apart, over the slots whose
    reference top-2 margin is at least ``min_margin``."""
    same, keep = ids == ids_ref, margins_ref >= min_margin
    return {"commands": same[:, 0][keep[:, 0]].float().mean().item(),
            "args": same[:, 1:][keep[:, 1:]].float().mean().item()}


@contextlib.contextmanager
def truncated_weights(layer, drop_bits: int):
    """Clear the low ``drop_bits`` mantissa bits of the layer's four bf16
    weight matrices (a control: one layer's products in a lower precision)."""
    mats = [layer.qkv.weight, layer.out_proj.weight, layer.ff1.weight, layer.ff2.weight]
    saved = [w.detach().clone() for w in mats]
    for w in mats:
        w.detach().view(torch.int16).bitwise_and_(~((1 << drop_bits) - 1))
    try:
        yield
    finally:
        for w, orig in zip(mats, saved):
            w.detach().copy_(orig)


@contextlib.contextmanager
def plain_path(emb_ops, layer_ops, head_ops):
    """Route the model through the kernels' plain versions, on the card."""
    saved = emb_ops.fused_embedding, layer_ops.fused_layer, head_ops.fused_head_argmax
    emb_ops.fused_embedding = emb_ops.embedding_reference
    layer_ops.fused_layer = layer_ops.layer_reference
    head_ops.fused_head_argmax = head_ops.head_argmax_reference
    try:
        yield
    finally:
        emb_ops.fused_embedding, layer_ops.fused_layer, head_ops.fused_head_argmax = saved


def layer_args(layer, x, mask, seq_bias=None, causal=False):
    return (x, seq_bias, layer.norm1, layer.qkv.weight, layer.qkv.bias,
            layer.out_proj.weight, layer.out_proj.bias, layer.norm2, layer.ff1.weight,
            layer.ff1.bias, layer.ff2.weight, layer.ff2.bias, mask, layer.n_heads, causal)


def layer_cost(args):
    x, seq_bias, *weights, mask, n_heads, _ = args
    b, s, d = x.shape
    f = weights[6].shape[0]
    ops = 2.0 * b * s * (3 * d * d + d * d + 2 * d * f) + 4.0 * b * s * s * d
    return bound(2 * nbytes(x) + nbytes(seq_bias, mask, *weights), ops, PEAK_BF16)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, load_model, one_shot_sample
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import _build
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.svgtensor.constants import CMD_ARGS_MASK, PAD_VAL

    os.makedirs(OUT_DIR, exist_ok=True)
    record: dict = {}
    card = card_line()
    print(card, flush=True)
    record["card"] = card
    dev = torch.device("cuda")
    wrappers = {"embedding": emb_ops.fused_embedding, "layer": layer_ops.fused_layer,
                "head": head_ops.fused_head_argmax}

    # ---- build
    t0 = time.perf_counter()
    so_path = _build.build()
    record["build_s"] = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        f.write(_build.build_log)
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {os.path.basename(so_path)} in {record['build_s']:.1f} s", flush=True)
    for ln in ptxas:
        print(f"  {ln}")

    # ---- model and main-path inputs
    cfg = gpu_fast(hierarchical_ordered())
    model = load_model(CHECKPOINT, cfg, device=dev)
    batch = generate_batch(np.random.default_rng(0), N_MAIN, cfg.max_num_groups,
                           cfg.max_seq_len)
    commands = torch.from_numpy(batch["commands"]).to(dev)
    args = torch.from_numpy(batch["args"]).to(dev)
    n, g, s_enc = commands.shape
    cmd_f, args_f = commands.reshape(n * g, s_enc), args.reshape(n * g, s_enc, -1)
    emb = model.encoder.embedding
    dec = model.decoder
    fcn = dec.fcn

    kernels = {}
    with torch.no_grad():
        arg_tables = emb_ops.fold_arg_tables(emb.arg_embed, emb.embed_fcn.weight,
                                             emb.embed_fcn.bias, emb.n_args)
        emb_in = (cmd_f, args_f, None, emb.command_embed, arg_tables, None,
                  emb.pos_embed[:s_enc])
        x_e1 = emb_ops.fused_embedding(*emb_in)
        key_pad = key_padding_to_additive(M.key_padding_mask(cmd_f))
        z = model.encode(commands, args)
        out_d2 = dec.hierarchical_decoder(dec.hierarchical_embedding(n), z)
        _, z_groups = dec.hierarchical_fcn(out_d2)
        zb = z_groups.reshape(n * g, -1)
        x_d1 = dec.embedding(n * g)
        y_d1 = dec.decoder(x_d1, zb)
        x_head = y_d1.reshape(-1, y_d1.shape[-1]).contiguous()
        torch.cuda.synchronize()

        # ---- K1: kernel vs plain at E1 shapes, plus out-of-range ids and groups
        out_k = emb_ops.fused_embedding(*emb_in)
        out_p = emb_ops.embedding_reference(*emb_in)
        err = (out_k.float() - out_p.float()).abs().max().item()
        check(err <= TOL_EMBED, f"embedding max abs err {err} > {TOL_EMBED}")
        small_c, small_a = cmd_f[:4].clone(), args_f[:4].clone()
        small_c[0, 3], small_a[1, 2, 4], small_a[2, 5, 0] = 9, 300.0, -3.0
        groups = M.group_mask(small_c)
        group_table = torch.randn(12, emb.command_embed.shape[1], device=dev).to(torch.bfloat16)
        small = (small_c, small_a, groups, emb.command_embed, arg_tables, group_table,
                 emb.pos_embed[:s_enc], True)
        err_small = (emb_ops.fused_embedding(*small).float()
                     - emb_ops.embedding_reference(*small).float()).abs().max().item()
        check(err_small <= TOL_EMBED, f"embedding (groups, bad ids) err {err_small}")
        print(f"K1 embedding: max abs err {err:.3g} (E1 shapes), {err_small:.3g} "
              f"(use_group, out-of-range ids); tolerance {TOL_EMBED}", flush=True)
        kernels["embedding"] = {"max_abs_err": max(err, err_small), "tolerance": TOL_EMBED}

        # ---- K2: kernel vs plain at the main path's shapes
        l_e1, l_d1, l_d2 = (model.encoder.encoder.layers[0], dec.decoder.layers[0],
                            dec.hierarchical_decoder.layers[0])
        mask_e1 = key_pad.clone()
        mask_e1[0] = float("-inf")                       # one fully masked sequence
        zeros = lambda b, s: torch.zeros((b, s), dtype=torch.float32, device=dev)  # noqa: E731
        bias_d1 = torch.nn.functional.linear(zb, l_d1.glob.weight, l_d1.glob.bias)
        bias_d2 = torch.nn.functional.linear(z, l_d2.glob.weight, l_d2.glob.bias)
        x_causal = torch.randn(64, 31, x_d1.shape[-1], device=dev).to(torch.bfloat16)
        x_e2 = torch.randn(n, 8, x_d1.shape[-1], device=dev).to(torch.bfloat16)
        mask_e2 = torch.where(torch.rand(n, 8, device=dev) < 0.3, float("-inf"), 0.0)
        mask_e2[:, 0], mask_e2[0] = 0.0, float("-inf")   # the first sequence fully masked
        layer_cases = {
            "E1 encoder S=32, key pad": layer_args(l_e1, x_e1, mask_e1),
            "D1 decoder S=31, seq_bias": layer_args(l_d1, x_d1, zeros(n * g, 31), bias_d1),
            "D2 decoder S=8, seq_bias": layer_args(l_d2, dec.hierarchical_embedding(n),
                                                   zeros(n, 8), bias_d2),
            "E2 encoder S=8, random x, key pad": layer_args(
                model.encoder.hierarchical_encoder.layers[0], x_e2, mask_e2),
            "causal S=31": layer_args(l_d1, x_causal, zeros(64, 31), bias_d1[:64], True),
        }
        layer_err = 0.0
        layer_atol = 0.0
        for what, la in layer_cases.items():
            out_k = layer_ops.fused_layer(*la).float()
            out_p = layer_ops.layer_reference(*la).float()
            diff = (out_k - out_p).abs()
            atol_needed = (diff - TOL_LAYER_RTOL * out_p.abs()).max().item()
            rms = (diff.norm() / out_p.norm()).item()
            check(bool(torch.isfinite(out_k).all()), f"layer {what}: non-finite output")
            check(atol_needed <= TOL_LAYER_ATOL and rms <= TOL_LAYER_RMS,
                  f"layer {what}: an element is off by {atol_needed} beyond "
                  f"{TOL_LAYER_RTOL} x |out|, relative RMS err {rms}")
            layer_err = max(layer_err, diff.max().item())
            layer_atol = max(layer_atol, atol_needed)
            print(f"K2 layer {what}: max abs err {diff.max().item():.3g} (|out| there "
                  f"{out_p.flatten()[diff.argmax()].abs().item():.3g}); largest excess over "
                  f"{TOL_LAYER_RTOL:.3g} x |out| {atol_needed:.3g} (limit {TOL_LAYER_ATOL}); "
                  f"relative RMS err {rms:.3g} (limit {TOL_LAYER_RMS})", flush=True)
        kernels["layer"] = {"max_abs_err": layer_err, "atol_needed": layer_atol,
                            "tolerance": {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL,
                                          "rms": TOL_LAYER_RMS}}

        # ---- K3: kernel vs plain at D1 output shapes
        head_in = (x_head, fcn.w_packed, fcn.b_packed, fcn.n_commands, fcn.n_args,
                   fcn.args_dim)
        ids_k = head_ops.fused_head_argmax(*head_in).long()
        ids_p = head_ops.head_argmax_reference(*head_in).long()
        logits = torch.matmul(x_head.float(), fcn.w_packed.float().t()) + fcn.b_packed.float()
        head_err, mismatches, exempt = 0.0, 0, 0
        for j, (o, width) in enumerate(head_slots(fcn)):
            sl = logits[:, o:o + width]
            top2 = sl.topk(2, dim=-1).values
            close = (top2[:, 0] - top2[:, 1]) < TOL_HEAD_MARGIN
            differ = ids_k[:, j] != ids_p[:, j]
            gap = (sl.gather(1, ids_p[:, j:j + 1]) - sl.gather(1, ids_k[:, j:j + 1])).abs()
            head_err = max(head_err, gap.max().item())
            mismatches += int(differ.sum())
            exempt += int((differ & close).sum())
            check(not bool((differ & ~close).any()),
                  f"head slot {j}: ids differ where the top-2 gap is >= {TOL_HEAD_MARGIN}")
        del logits
        print(f"K3 head: {mismatches} of {ids_k.numel()} ids differ, all where the plain "
              f"top-2 gap < {TOL_HEAD_MARGIN}; largest logit gap of a differing choice "
              f"{head_err:.3g}", flush=True)
        kernels["head"] = {"max_abs_err": head_err, "tolerance": TOL_HEAD_MARGIN,
                           "ids_differing": mismatches, "rows": x_head.shape[0]}
        torch.cuda.synchronize()

        # ---- the slice: one run of the main path, counted
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out_c, out_a = one_shot_sample(model, commands, args)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        print(f"main path N={N_MAIN}: launches {launches}", flush=True)
        check(launches == {"embedding": 1, "layer": 16, "head": 1},
              f"launches per forward {launches}, expected embedding 1, layer 16, head 1")
        record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        check(tuple(out_c.shape) == (N_MAIN, 8, 31) and tuple(out_a.shape) == (N_MAIN, 8, 31, 11),
              f"output shapes {tuple(out_c.shape)}, {tuple(out_a.shape)}")
        check(bool(torch.isfinite(out_a).all()), "non-finite arguments")
        check(int(out_c.min()) >= 0 and int(out_c.max()) < cfg.n_commands, "command ids out of range")
        check(float(out_a.min()) >= -1 and float(out_a.max()) <= cfg.args_dim - 1,
              "argument values out of range")
        unused = torch.as_tensor(CMD_ARGS_MASK, device=dev)[out_c.long()] == 0
        check(bool((out_a[unused] == -1).all()), "unused arguments are not PAD")
        commands_match = (out_c == commands[..., 1:]).float().mean().item()
        print(f"output valid: shapes {tuple(out_c.shape)} {tuple(out_a.shape)}; decoded "
              f"commands equal the input's at {commands_match:.4f} of positions", flush=True)

        # ---- kernel path vs plain path on the card, N=64: the head ids where
        # the plain path's top-2 margin is at least AGREE_MARGIN (the gate),
        # and a control that the gate must reject. Also reported: every id,
        # the sampled outputs of one_shot_sample, and the arguments that both
        # decoded outputs read.
        c64, a64 = commands[:N_AGREE], args[:N_AGREE]
        ids_k, _, res_k = head_ids_and_margins(model, c64, a64)
        sample_k = one_shot_sample(model, c64, a64)
        with plain_path(emb_ops, layer_ops, head_ops):
            ids_p, margins_p, res_p = head_ids_and_margins(model, c64, a64)
            sample_p = one_shot_sample(model, c64, a64)
            with truncated_weights(model.encoder.encoder.layers[0], CONTROL_DROP_BITS):
                ids_c, _, _ = head_ids_and_margins(model, c64, a64)
        agree = id_agreement(ids_k, ids_p, margins_p, AGREE_MARGIN)
        control = id_agreement(ids_c, ids_p, margins_p, AGREE_MARGIN)
        every_id = id_agreement(ids_k, ids_p, margins_p, float("-inf"))
        read = (sample_p[1] != PAD_VAL) & (sample_k[1] != PAD_VAL)
        sampled = {"commands": (sample_k[0] == sample_p[0]).float().mean().item(),
                   "args": (sample_k[1] == sample_p[1]).float().mean().item(),
                   "args_read": (sample_k[1] == sample_p[1])[read].float().mean().item()}
        compared = (margins_p >= AGREE_MARGIN).float().mean().item()
        vis_err = (res_k["visibility_logits"].float()
                   - res_p["visibility_logits"].float()).abs().max().item()
        print(f"kernel vs plain path N={N_AGREE}: head ids {agree} where the plain top-2 "
              f"margin >= {AGREE_MARGIN} ({compared:.4f} of the ids; limit {AGREEMENT_MIN}); "
              f"control (E1 layer 0 weights less {CONTROL_DROP_BITS} mantissa bits) {control}; "
              f"every id {every_id}; sampled outputs {sampled}; visibility logits max abs "
              f"err {vis_err:.3g}", flush=True)
        check(min(agree.values()) >= AGREEMENT_MIN,
              f"id agreement {agree} < {AGREEMENT_MIN}")
        check(min(control.values()) < AGREEMENT_MIN,
              f"the agreement gate passed its control {control}: it cannot see a fault "
              f"of that size")
        record["agreement"] = {"ids": agree, "ids_compared_share": compared,
                               "control": control, "every_id": every_id,
                               "sampled": sampled, "visibility_max_abs_err": vis_err}

        # ---- timing at the main path's shapes
        yardstick = {}
        # K1, and one embedding_bag call over the same rows of one stacked table
        n_cmd, vocab = emb.command_embed.shape[0], arg_tables.shape[0] // emb.n_args
        table_all = torch.cat([emb.command_embed, arg_tables, emb.pos_embed[:s_enc]])
        idx = torch.cat([
            cmd_f.long()[..., None],
            n_cmd + vocab * torch.arange(emb.n_args, device=dev) + args_f.long() + 1,
            (n_cmd + vocab * emb.n_args + torch.arange(s_enc, device=dev))
            .expand(cmd_f.shape)[..., None]], dim=-1).reshape(-1, 2 + emb.n_args)
        bag = lambda: torch.nn.functional.embedding_bag(idx, table_all, mode="sum")  # noqa: E731
        yardstick["embedding"] = (bag().float().reshape(x_e1.shape)
                                  - x_e1.float()).abs().max().item()
        rows = cmd_f.numel()
        kernels["embedding"].update(
            ms=cuda_ms(lambda: emb_ops.fused_embedding(*emb_in)),
            plain_ms=cuda_ms(lambda: emb_ops.embedding_reference(*emb_in)),
            library_ms=cuda_ms(bag))
        b_ms, b_by = bound(nbytes(cmd_f, args_f, emb.command_embed, arg_tables,
                                  emb.pos_embed[:s_enc], x_e1),
                           rows * x_e1.shape[-1] * (1.0 + emb.n_args), PEAK_F32)
        kernels["embedding"].update(bound_ms=b_ms, bound_by=b_by)

        # K2 at each stage's shapes; the E1 layer is the kernel's row, with
        # torch.nn.TransformerEncoderLayer (same function, no seq_bias) as yardstick
        stages = {
            "E1": (layer_args(l_e1, x_e1, key_pad), 4),
            "E2": (layer_args(model.encoder.hierarchical_encoder.layers[0],
                              dec.hierarchical_embedding(n), zeros(n, 8)), 4),
            "D2": (layer_cases["D2 decoder S=8, seq_bias"], 4),
            "D1": (layer_cases["D1 decoder S=31, seq_bias"], 4),
        }
        per_stage = {}
        for stage, (la, count) in stages.items():
            b_ms, b_by = layer_cost(la)
            per_stage[stage] = {
                "B": la[0].shape[0], "S": la[0].shape[1], "launches_per_forward": count,
                "ms": cuda_ms(lambda la=la: layer_ops.fused_layer(*la)),
                "plain_ms": cuda_ms(lambda la=la: layer_ops.layer_reference(*la)),
                "bound_ms": b_ms, "bound_by": b_by}
        lib = torch.nn.TransformerEncoderLayer(
            l_e1.qkv.in_features, l_e1.n_heads, l_e1.ff1.out_features, dropout=0.0,
            activation="relu", batch_first=True, norm_first=True, device=dev,
            dtype=torch.bfloat16).eval()
        lib.self_attn.in_proj_weight.copy_(l_e1.qkv.weight)
        lib.self_attn.in_proj_bias.copy_(l_e1.qkv.bias)
        lib.self_attn.out_proj.weight.copy_(l_e1.out_proj.weight)
        lib.self_attn.out_proj.bias.copy_(l_e1.out_proj.bias)
        for dst, src in ((lib.linear1, l_e1.ff1), (lib.linear2, l_e1.ff2)):
            dst.weight.copy_(src.weight)
            dst.bias.copy_(src.bias)
        for dst, src in ((lib.norm1, l_e1.norm1), (lib.norm2, l_e1.norm2)):
            dst.weight.copy_(src[0])
            dst.bias.copy_(src[1])
        pad_bool = M.key_padding_mask(cmd_f)
        lib_run = lambda: lib(x_e1, src_key_padding_mask=pad_bool)  # noqa: E731
        valid = ~pad_bool
        yardstick["layer"] = ((lib_run().float() - layer_ops.fused_layer(
            *stages["E1"][0]).float()).abs()[valid].max().item())
        e1 = per_stage["E1"]
        kernels["layer"].update(ms=e1["ms"], plain_ms=e1["plain_ms"],
                                library_ms=cuda_ms(lib_run), bound_ms=e1["bound_ms"],
                                bound_by=e1["bound_by"], stages=per_stage)

        # K3
        r, d = x_head.shape
        n_cls = fcn.n_commands + fcn.n_args * fcn.args_dim
        b_ms, b_by = bound(nbytes(x_head) + n_cls * d * 2 + n_cls * 2 + r * (1 + fcn.n_args) * 4,
                           2.0 * r * d * n_cls, PEAK_BF16)
        kernels["head"].update(
            ms=cuda_ms(lambda: head_ops.fused_head_argmax(*head_in)),
            plain_ms=cuda_ms(lambda: head_ops.head_argmax_reference(*head_in), iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        print(f"yardstick agreement (max abs diff vs the kernel): {yardstick}", flush=True)
        record["yardstick_max_abs_diff"] = yardstick

        # the slice, end to end
        slice_ms = cuda_median_ms(lambda: one_shot_sample(model, commands, args))
        with plain_path(emb_ops, layer_ops, head_ops):
            plain_slice_ms = cuda_median_ms(lambda: one_shot_sample(model, commands, args),
                                            iters=5, warmup=1)
    record["slice"] = {
        "N": N_MAIN, "median_ms": slice_ms, "samples_per_s": N_MAIN / slice_ms * 1e3,
        "plain_path_median_ms": plain_slice_ms,
        "plain_path_samples_per_s": N_MAIN / plain_slice_ms * 1e3}
    print(f"encode+decode N={N_MAIN}: {slice_ms:.3f} ms median of {ITERS}, "
          f"{N_MAIN / slice_ms * 1e3:.1f} samples/s (plain path {plain_slice_ms:.3f} ms, "
          f"{N_MAIN / plain_slice_ms * 1e3:.1f} samples/s) on {card}", flush=True)
    for stage, st in per_stage.items():
        print(f"  layer {stage} B={st['B']} S={st['S']}: {st['ms']:.4f} ms (plain "
              f"{st['plain_ms']:.4f}, bound {st['bound_ms']:.4f} by {st['bound_by']}) x "
              f"{st['launches_per_forward']} per forward")

    source = {"embedding": ("embedding.cu", "deepsvg_tpu/ops/embedding.py:34"),
              "layer": ("layer.cu", "deepsvg_tpu/ops/layer.py:108"),
              "head": ("head.cu", "deepsvg_tpu/ops/head.py:32")}
    line = []
    for name, k in kernels.items():
        src, replaces = source[name]
        line.append({
            "name": name, "route": "cuda", "source": f"deepsvg_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    record["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
