"""Where the PyTorch port spends its time on a CUDA card.

    python3 scripts/profile_port_slice.py            # the inference path
    python3 scripts/profile_port_slice.py --train    # the training step, B=128
    python3 scripts/profile_port_slice.py --recipe   # the training step, B=60
    python3 scripts/profile_port_slice.py --selfmatch  # the self-matching step, B=60
    python3 scripts/profile_port_slice.py --autoregressive [--float32]  # Sketchformer's greedy_sample
    python3 scripts/profile_port_slice.py --float32  # the inference path of the float32 model
    python3 scripts/profile_port_slice.py --train --float32  # the float32 flagship's step, B=60
    python3 scripts/profile_port_slice.py --rows [--tag T]  # kernel times at the paths' shapes
    python3 scripts/profile_port_slice.py --k4 [--tag T]    # the long K4's times at its shapes
    python3 scripts/profile_port_slice.py --k7 [--tree DIR] [--tag T]  # K7 alone at E2 and D2
    python3 scripts/profile_port_slice.py --k9 [--tree DIR] [--tag T]  # K9 alone, N=1024
    python3 scripts/profile_port_slice.py --greedy-wall [--tree DIR] [--tag T]  # greedy_sample's wall
    python3 scripts/profile_port_slice.py --embedding [--tree DIR] [--tag T]  # K1, K6, walls
    python3 scripts/profile_port_slice.py --mha [--tree DIR] [--tag T]  # K10, K11 both ways

Loads the trained flagship checkpoint into the port (bfloat16 compute,
float32 masters). Without ``--train`` it runs greedy one-shot encode+decode
(``deepsvg_tpu_torch.models.one_shot_sample``) on N=1024 synthetic icons
(seed 0, the batch ``chip_smoke.py`` times); with ``--train`` it runs
``deepsvg_tpu_torch.training.train_step`` at B=128, dropout 0.1, constant
learning rate 1e-3 on one batch (seed 0), as ``chip_smoke.py`` does. Either
runs under ``torch.profiler`` for 5 calls after warm-up calls. ``--recipe``
runs the step at the recipe's batch, B=60, where E2 and D2 take the fused
stack kernel K7 (B=128 is over the stack gate). ``--selfmatch`` runs the
step of the Hungarian self-matching model with its VAE at B=60 (K8 and the
brute-force matching), built from the flagship checkpoint as
``chip_smoke.py`` builds it. ``--autoregressive`` runs Sketchformer's
``greedy_sample`` (encode, then 240 decode steps through K9 and K3) at
N=1024 on the config's own initialisation from a seed, as ``chip_smoke.py``
builds it, for 2 calls after one (with ``--float32``: the same weights at the
config's own float32 compute, ``autoregressive_float32_profile.txt``).
``--float32`` profiles the inference path of the
flagship at its config's own ``compute_dtype``, float32 (the float32 forms
of K1, K2 and K3); with ``--train`` it profiles that model's training step
at the recipe's B=60 (``train_float32_profile.txt``: the long K4 at E1 and
D1, K7 at E2 and D2, K5's and K1's float32 forms, K6). Each prints the
device time by kernel name, the device's busy time against the host's wall
time over the window (the idle share), and the card's name and power limit.
The full table goes to ``slice_profile.txt``, ``train_profile.txt`` or
``train_recipe_profile.txt`` (``train_selfmatch_profile.txt``,
``autoregressive_profile.txt``) in the output
directory under the repository
root (``slice_float32_profile.txt`` with ``--float32``).

``--rows`` profiles nothing: it times K3 (bfloat16 and float32, at the
flagship's R = 253,952 rows and the decode's R = 1,024), K2's float32 form at
the float32 flagship's E1 and D1 (8,192 x 32 and x 31) and at the bfloat16
profile's E2, the long form in float32 at Sketchformer's S=242, and K6 at the
flagship step's B=128 x 32 and Sketchformer's S=242, with CUDA events as
``chip_smoke.py`` times them, on whichever tree the script lies in: run it
from an archive of another commit to time that commit's kernels on the same
inputs. It prints one JSON object and writes it to ``kernel_rows[_T].json``.

``--k4`` times K4's long form, forward (saved and recompute mode) and
saved-mode forward + backward with CUDA events (the host's time where the
call's launches outpace the card) and its device time under
``torch.profiler`` (every kernel of the call, and the layer's own kernels
by name), beside its plain
version, its bound (``chip_smoke.k4_bound``) and ``nn.TransformerEncoderLayer``
(pre-LN, training mode, key padding; float32 in TF32 and in full float32):
float32 at the flagship's E1 and D1 at B=60 (480 sequences of 32, and of 31
with ``seq_bias``, the trained layers) and at S=242 (60 sequences), bfloat16
at Sketchformer's E1 (60 x 242) and its causal decoder (60 x 241,
``seq_bias``); into ``k4_rows[_T].json``, as ``--rows``, on the tree the
script lies in.

``--k7`` times K7, the fused training stack, alone: four layers at E2
(key-padded, one sequence fully masked, no injection) and D2 (each layer's
injection, no mask), B=60 and the gate's edge B=64, S=8, D=256, 8 heads, F=512,
dropout 0.1, in bfloat16 and float32 (weights and inputs from a seed), forward
and forward + backward with CUDA events and as device time under
``torch.profiler`` (every kernel of the call, and by kernel name), beside the
function's bound; and K4's float32 short form at E2 above the stack gate
(B=128) beside its plain version, its bound and ``nn.TransformerEncoderLayer``;
into ``k7_rows[_T].json``. ``--tree DIR`` imports the
port from the repository at DIR (an archive of another commit) in place of
this one, so that one call can time two trees' kernels on the same inputs.

``--k9`` times K9, the decode step, alone at Sketchformer's decode (N = 1,024
rows, T = 241 cache positions, four layers, D=256, 8 heads, F=512; weights,
caches and key padding from a seed) at ``index`` 1, 120 and 240, in bfloat16
and float32: CUDA events and device time under ``torch.profiler`` (by
kernel name), beside its plain version and its bound (the cache bytes
before the index, the weights, the rows in and out, at 3.35 TB/s, against
the products at the type's peak); into ``k9_rows[_T].json``. With ``--tree
DIR`` it times the port at DIR, as ``--k7``.

``--greedy-wall`` times Sketchformer's ``greedy_sample`` at N=1024 in
bfloat16 and float32 without the profiler: the host's wall of each call,
synchronised, over ITERS calls after one, and their median; into
``greedy_wall[_T].json``. The model is built by this checkout's
``chip_smoke.sketchformer_model`` on the port that ``--tree`` names, so two
trees run the same weights.
``--embedding`` times the embedding kernels at the paths' shapes on the port
that ``--tree`` names (default this one), with CUDA events (mean of 20
after 3, the call's whole time) and as device time under ``torch.profiler``
(every kernel of the call, and the kernel's own by name): K1 in bfloat16
and float32 at the flagship's E1 (N=1024: 8,192 sequences of 32, the ids as
the inference path hands them over, arguments as floats), K6 on int32 ids
(as the step's backward gets them) at the flagship step's B=128 x 32
(bfloat16 ``dy``), Sketchformer's encoder at B=60 (S=242, a 242-row group
table) and the float32 flagship's B=60 x 32 (float32 ``dy``), each ``dy``
from a generator of its own; and the flagship's greedy one-shot inference
(``one_shot_sample``, N=1024) in both types, median of 20 after 3 between
CUDA events, as chip_smoke times it. Into ``embedding_rows[_T].json``.
``--mha`` times the attention block alone on the port that ``--tree`` names:
K10 (``fused_mha``) at the flagship's E1 (8,192 x 32) and Sketchformer's
encoder (1,024 x 242), and K11's forward (``fused_mha_train`` under
``no_grad``, dropout 0.1) at Sketchformer's encoder at B=60 (60 x 242) and
the flagship step's E1 (1,024 x 32), each in bfloat16 and float32, on the
trained flagship's E1 layer 0 attention weights and the synthetic batches'
key padding, as ``chip_smoke.py``'s attention phase builds them: CUDA events
(mean of 20 after 3), device time under ``torch.profiler`` (every kernel of
the call, and by kernel name: the QKV, attention and out-projection
launches), the bound (``chip_smoke.py``'s), and ``F.linear`` -> SDPA ->
``F.linear`` (float32 in TF32 and in full float32); and K11's backward alone
at the same two shapes and both types (one forward kept under autograd, its
backward rerun on the graph: events, device time by launch, bound, and the
backward of the library call); into ``mha_rows[_T].json``.
Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
    parser.add_argument("--selfmatch", action="store_true",
                        help="profile the self-matching model's training step at B=60")
    parser.add_argument("--autoregressive", action="store_true",
                        help="profile Sketchformer's greedy_sample at N=1024")
    parser.add_argument("--float32", action="store_true",
                        help="profile the inference path of the float32 flagship")
    parser.add_argument("--rows", action="store_true",
                        help="time the kernels at the paths' shapes (no profile)")
    parser.add_argument("--k4", action="store_true",
                        help="time the long K4 at its paths' shapes (no profile)")
    parser.add_argument("--k7", action="store_true",
                        help="time K7 alone at E2 and D2, B=60 and 64 (no model)")
    parser.add_argument("--k9", action="store_true",
                        help="time K9 alone at N=1024, index 1/120/240 (no model)")
    parser.add_argument("--greedy-wall", action="store_true",
                        help="time greedy_sample's wall at N=1024, both types, unprofiled")
    parser.add_argument("--embedding", action="store_true",
                        help="time K1, K6 and the inference walls (no model profile)")
    parser.add_argument("--mha", action="store_true",
                        help="time K10 and K11's forward alone, both types (no model)")
    parser.add_argument("--tree", default="",
                        help="with --k7, --k9, --greedy-wall, --embedding or --mha: the "
                             "repository whose port is timed (default this one)")
    parser.add_argument("--tag", default="",
                        help="suffix of --rows', --k4's, --k7's, --k9's, --greedy-wall's, "
                             "--embedding's or --mha's output file")
    opts = parser.parse_args()
    if opts.tree:
        sys.path.insert(0, os.path.abspath(opts.tree))
    opts.recipe = opts.recipe or opts.selfmatch
    opts.train = opts.train or opts.recipe
    b_train = B_RECIPE if opts.recipe or opts.float32 else B_TRAIN
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
    if opts.rows:
        return kernel_rows(card, opts.tag)
    if opts.k4:
        return k4_rows(card, opts.tag)
    if opts.k7:
        return k7_rows(card, opts.tag)
    if opts.k9:
        return k9_rows(card, opts.tag)
    if opts.greedy_wall:
        return greedy_wall(card, opts.tag)
    if opts.embedding:
        return embedding_rows(card, opts.tag)
    if opts.mha:
        return mha_rows(card, opts.tag)
    cfg = hierarchical_ordered() if opts.float32 else gpu_fast(hierarchical_ordered())
    iters = ITERS
    if opts.autoregressive:
        from chip_smoke import sketchformer_model
        from deepsvg_tpu_torch.models import greedy_sample

        # the float32 model: the config's own compute type, the same seeded
        # weights, as chip_smoke's float32 phase builds it
        model = sketchformer_model("cuda", compute_dtype="float32" if opts.float32 else None)
        cfg = model.cfg
    elif opts.selfmatch:
        from chip_smoke import self_match_model
        from deepsvg_tpu_torch.models import hierarchical_self_matching
        cfg = gpu_fast(hierarchical_self_matching())
        model = self_match_model(cfg, "cuda")
    else:
        model = load_model(CHECKPOINT, cfg, device="cuda")
    size = b_train if opts.train else N
    batch = generate_batch(np.random.default_rng(0), size, cfg.max_num_groups, cfg.max_seq_len)
    grouped = "_grouped" if opts.autoregressive else ""
    commands = torch.from_numpy(batch["commands" + grouped]).cuda()
    args = torch.from_numpy(batch["args" + grouped]).cuda()
    if opts.autoregressive:
        what, out_name, warmup, iters = (f"greedy_sample (Sketchformer) N={N}",
                                         "autoregressive_profile.txt", 1, 2)
        if opts.float32:
            what, out_name = what + ", float32", "autoregressive_float32_profile.txt"

        def run():
            greedy_sample(model, commands, args)
    elif opts.train:
        optimizer = make_optimizer(constant(1e-3))
        state = create_train_state(model, optimizer, init=False)
        data = {"commands": commands, "args": args}
        weights = dict(loss_visibility_weight=1.0, loss_cmd_weight=1.0, loss_args_weight=2.0,
                       kl_tolerance=0.1, loss_kl_weight=1.0)
        model_args = ["commands", "args", "commands", "args"]
        what, warmup = f"train_step B={b_train}", 3
        out_name = ("train_selfmatch_profile.txt" if opts.selfmatch else
                    "train_float32_profile.txt" if opts.float32 else
                    "train_recipe_profile.txt" if opts.recipe else "train_profile.txt")
        if opts.float32:
            what = f"train_step B={b_train}, float32"

        def run():
            train_step(state, data, weights, optimizer, model_args)
    else:
        what, out_name, warmup = f"one_shot_sample N={N}", "slice_profile.txt", 2
        if opts.float32:
            what, out_name = f"one_shot_sample N={N}, float32", "slice_float32_profile.txt"

        def run():
            one_shot_sample(model, commands, args)
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters

    rows = [(e.key, e.device_time_total / 1e3 / iters, e.count / iters)
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


def kernel_rows(card: str, tag: str) -> int:
    """``--rows``: the kernels' times at the paths' shapes, as one JSON object."""
    import torch.nn.functional as F

    from chip_smoke import AR_SEED, cuda_ms, layer_args, sketchformer_model
    from deepsvg_tpu_torch.configs.sketchformer import make_model_config
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import (
        SVGTransformer, gpu_fast, hierarchical_ordered, load_model)
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.training.trainer import init_parameters
    dev = torch.device("cuda")
    rows: dict = {}
    flagship = hierarchical_ordered()
    batch = generate_batch(np.random.default_rng(0), N, flagship.max_num_groups,
                           flagship.max_seq_len)
    commands = torch.from_numpy(batch["commands"]).to(dev)
    args = torch.from_numpy(batch["args"]).to(dev)
    n, g, s_enc = commands.shape
    cmd_f, args_f = commands.reshape(n * g, s_enc), args.reshape(n * g, s_enc, -1)
    pad = M.key_padding_mask(cmd_f)
    with torch.no_grad():
        for dtype_name, cfg in (("", gpu_fast(hierarchical_ordered())),
                                ("_f32", hierarchical_ordered())):
            model = load_model(CHECKPOINT, cfg, device=dev)
            fcn, enc, dec = model.decoder.fcn, model.encoder, model.decoder
            seen = {}
            hook = fcn.register_forward_hook(lambda m, i, o: seen.__setitem__("x", i[0]))
            model(commands, args, argmax_head=True)
            hook.remove()
            x_head = seen.pop("x").reshape(-1, cfg.d_model).contiguous()
            head_in = (x_head, fcn.w_packed, fcn.b_packed, fcn.n_commands, fcn.n_args,
                       fcn.args_dim)
            rows[f"head{dtype_name}"] = cuda_ms(lambda: head_ops.fused_head_argmax(*head_in))
            dec_in = (x_head[:N], *head_in[1:])
            rows[f"head{dtype_name}_decode"] = cuda_ms(
                lambda: head_ops.fused_head_argmax(*dec_in))
            del x_head, head_in, dec_in
            cmd_table, arg_tables, pos_table = enc.embedding.tables()
            x_e1 = emb_ops.fused_embedding(cmd_f, args_f, None, cmd_table, arg_tables, None,
                                           pos_table[:s_enc])
            key_pad = key_padding_to_additive(pad)
            if dtype_name:
                # the float32 model's E1 and D1
                l_e1, l_d1 = enc.encoder.layers[0], dec.decoder.layers[0]
                z, _, _ = model.encode(commands, args)
                _, z_groups = dec.hierarchical_fcn(
                    dec.hierarchical_decoder(dec.hierarchical_embedding(n), z))
                bias_d1 = F.linear(z_groups.reshape(n * g, -1), l_d1.glob.weight,
                                   l_d1.glob.bias)
                x_d1 = dec.embedding(n * g)
                for name, la in (("layer_f32_e1", layer_args(l_e1, x_e1, key_pad)),
                                 ("layer_f32_d1", layer_args(l_d1, x_d1, torch.zeros(
                                     x_d1.shape[:2], device=dev), bias_d1))):
                    rows[name] = cuda_ms(lambda la=la: layer_ops.fused_layer(*la))
            else:
                # the bfloat16 profile's float32 E2, on the pooled E1 output
                vis = M.visibility_mask(commands)
                memory = enc.encoder(x_e1, key_pad)
                keep = M.padding_mask(cmd_f)
                pooled = (memory.float() * keep[..., None]).sum(1) \
                    / keep.sum(1, keepdim=True).clamp_min(1.0)
                x_e2 = enc.hierarchical_PE(pooled.reshape(n, g, -1))
                la = layer_args(enc.hierarchical_encoder.layers[0], x_e2,
                                key_padding_to_additive(~vis))
                rows["layer_f32_e2"] = cuda_ms(lambda: layer_ops.fused_layer(*la))
            del model
            torch.cuda.empty_cache()
        # the float32 long form at Sketchformer's E1, S=242
        sf_cfg = dataclasses.replace(make_model_config(), compute_dtype="float32")
        sf = SVGTransformer(sf_cfg)
        init_parameters(sf, torch.Generator().manual_seed(AR_SEED))
        sf = sf.to(dev).eval()
        sb = generate_batch(np.random.default_rng(0), N, sf_cfg.max_num_groups,
                            sf_cfg.max_seq_len)
        sc = torch.from_numpy(sb["commands_grouped"]).to(dev)[:, 0]
        sa = torch.from_numpy(sb["args_grouped"]).to(dev)[:, 0]
        x_sf = sf.encoder.embedding(sc, sa, M.group_mask(sc))
        la = layer_args(sf.encoder.encoder.layers[0], x_sf,
                        key_padding_to_additive(M.key_padding_mask(sc)))
        rows["layer_long_f32"] = cuda_ms(lambda: layer_ops.fused_layer(*la))
        del sf, la, x_sf
        # K6 at the flagship step's B=128 x 32 and Sketchformer's S=242
        gen = torch.Generator(device=dev).manual_seed(1)
        tb = generate_batch(np.random.default_rng(0), B_TRAIN, flagship.max_num_groups,
                            flagship.max_seq_len)
        tc = torch.from_numpy(tb["commands"]).to(dev).flatten(0, 1)
        ta = torch.from_numpy(tb["args"]).to(dev).flatten(0, 1)
        dy = torch.randn(*tc.shape, 256, device=dev, generator=gen).to(torch.bfloat16)
        rows["embedding_bwd"] = cuda_ms(
            lambda: emb_ops.embedding_backward(tc, ta, None, dy, flagship.n_commands,
                                               flagship.args_dim, 0, False))
        sfm = sketchformer_model(dev)
        emb = sfm.encoder.embedding
        rb = generate_batch(np.random.default_rng(0), B_RECIPE, sfm.cfg.max_num_groups,
                            sfm.cfg.max_seq_len)
        ce = torch.from_numpy(rb["commands_grouped"]).to(dev)[:, 0]
        ae = torch.from_numpy(rb["args_grouped"]).to(dev)[:, 0]
        cmd_table, arg_tables, _ = emb.tables()
        n_group = emb.group_table().shape[0]
        dy = torch.randn(*ce.shape, 256, device=dev, generator=gen).to(torch.bfloat16)
        grp = M.group_mask(ce)
        rows["embedding_bwd_long"] = cuda_ms(lambda: emb_ops.embedding_backward(
            ce, ae, grp, dy, cmd_table.shape[0], arg_tables.shape[0] // sfm.cfg.n_args,
            n_group, True))
    out = {"card": card, "root": ROOT, "ms": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"kernel_rows{'_' + tag if tag else ''}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


def device_ms(fn, iters=20):
    """Device time of ``fn`` a call under torch.profiler: the sum over its
    kernels (every kernel that ran, the op's own and PyTorch's around it),
    and the op's own kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.device_time_total / 1e3 / iters for e in prof.key_averages()
           if e.device_time_total > 0 and e.device_type.name == "CUDA"}
    merged: dict = {}
    for k, v in per.items():
        if "at::native" in k or "cutlass" in k or "xmma" in k:
            continue
        name = k.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0].split("<")[0].split("::")[-1]
        merged[name] = merged.get(name, 0.0) + v
    return sum(per.values()), merged


def events_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn`` a call between two CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def k7_rows(card: str, tag: str) -> int:
    """``--k7``: K7's times at E2 and D2, as one JSON object."""
    from deepsvg_tpu_torch.ops import stack_vjp
    dev = torch.device("cuda")
    n_layers, s, d, heads, f, rate = 4, 8, 256, 8, 512, 0.1
    peak = {torch.bfloat16: 989e12, torch.float32: 495e12}   # dense bf16, TF32
    rows: dict = {}

    def bound(b, es, backward, peak_ops):
        """As chip_smoke's k7_bound: the inputs, the weights as read and the
        outputs once, over 3.35 TB/s, against the products and attention."""
        r = b * s
        w_elems = n_layers * (4 * d * d + 2 * d * f + 9 * d + f)
        common = r * d * es + r * 4 + w_elems * es + n_layers * b * d * es
        layer_ops = 2.0 * r * (4 * d * d + 2 * d * f) + 4.0 * b * s * s * d
        fwd_ops = n_layers * layer_ops
        if not backward:
            n_bytes, ops = common + r * d * es, fwd_ops
        else:
            n_bytes = common + 2 * r * d * es + w_elems * 4 + n_layers * b * d * 4
            ops = 2 * fwd_ops
        return max(n_bytes / 3.35e12, ops / peak_ops) * 1e3

    for dtype in (torch.bfloat16, torch.float32):
        for stage in ("E2", "D2"):
            for b in (60, 64):
                rng = np.random.default_rng(14 + b)
                rnd = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
                    scale * rng.standard_normal(shape, dtype=np.float32)).to(dev)
                ln = lambda: torch.stack([1 + rnd(n_layers, d, scale=0.1),  # noqa: E731
                                          rnd(n_layers, d, scale=0.1)], dim=1)
                masters = [ln(), rnd(n_layers, 3 * d, d, scale=d ** -0.5),
                           rnd(n_layers, 3 * d, scale=0.1), rnd(n_layers, d, d, scale=d ** -0.5),
                           rnd(n_layers, d, scale=0.1), ln(), rnd(n_layers, f, d, scale=d ** -0.5),
                           rnd(n_layers, f, scale=0.1), rnd(n_layers, d, f, scale=f ** -0.5),
                           rnd(n_layers, d, scale=0.1)]
                masters = [w.requires_grad_() for w in masters]
                x = rnd(b, s, d).to(dtype).requires_grad_()
                if stage == "E2":
                    bias = torch.zeros(n_layers, b, d, device=dev, dtype=dtype)
                    lengths = torch.from_numpy(rng.integers(1, s + 1, b)).to(dev)
                    lengths[0] = 0
                    mask = torch.where(torch.arange(s, device=dev)[None] < lengths[:, None],
                                       0.0, float("-inf"))
                else:
                    bias = rnd(n_layers, b, d, scale=0.3).to(dtype)
                    mask = torch.zeros(b, s, device=dev)
                bias.requires_grad_()
                gy = rnd(b, s, d).to(dtype)
                call = (x, bias, *masters, mask, 7, heads, False, rate, dtype)
                leaves = [x, bias, *masters]

                def fwd():
                    with torch.no_grad():
                        return stack_vjp.fused_stack_train(*call)

                def both():
                    return torch.autograd.grad(stack_vjp.fused_stack_train(*call), leaves, gy)
                es = 2 if dtype == torch.bfloat16 else 4
                f_ms, fb_ms = events_ms(fwd), events_ms(both)
                dev_f, kern_f = device_ms(fwd)
                dev_fb, kern_fb = device_ms(both)
                name = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_{stage}_b{b}"
                rows[name] = {
                    "fwd_ms": f_ms, "bwd_ms": fb_ms - f_ms, "device_fwd_ms": dev_f,
                    "device_bwd_ms": dev_fb - dev_f, "kernels_fwd_ms": kern_f,
                    "kernels_bwd_ms": {k: v - kern_f.get(k, 0.0) for k, v in kern_fb.items()
                                       if v - kern_f.get(k, 0.0) > 1e-4},
                    "fwd_bound_ms": bound(b, es, False, peak[dtype]),
                    "bwd_bound_ms": bound(b, es, True, peak[dtype])}
                print(f"{name}: " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else
                    f"{k} {{{', '.join(f'{n} {t:.4f}' for n, t in v.items())}}}"
                    for k, v in rows[name].items()), flush=True)
    rows["k4_f32_e2_b128"] = k4_short_f32_row(dev, heads, d, f, rate)
    out = {"card": card, "root": os.path.dirname(os.path.dirname(stack_vjp.__file__)),
           "ms": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"k7_rows{'_' + tag if tag else ''}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


def embedding_rows(card: str, tag: str) -> int:
    """``--embedding``: K1's and K6's times and the inference walls, as one
    JSON object."""
    import importlib.util

    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, load_model, one_shot_sample
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.svgtensor import masks as M
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    dev = torch.device("cuda")
    rows: dict = {}

    def timed(name, fn, k6_call=None):
        """``fn`` timed; with ``k6_call(stamps)`` (a tree whose K6 takes
        stamps), also K6's phases from the card's clock."""
        import inspect
        total, by_name = device_ms(fn)
        rows[name] = {"ms": events_ms(fn), "device_ms": total,
                      "kernel_device_ms": sum(v for k, v in by_name.items() if "embedding" in k)}
        print(f"{card}; {name}: {rows[name]['ms']:.4f} ms (events), device "
              f"{rows[name]['device_ms']:.4f} ms, of which the kernel "
              f"{rows[name]['kernel_device_ms']:.4f}", flush=True)
        if k6_call is not None and "stamps" in inspect.signature(
                emb_ops.embedding_backward).parameters:
            # K6's phases, from the card's clock in each block: phase 1 (the
            # token blocks), the wait at the grid barrier, phase 2 (the rows)
            stamps = torch.zeros((1024, 8), dtype=torch.int64, device=dev)
            k6_call(stamps)
            torch.cuda.synchronize()
            t = stamps[(stamps != 0).all(1)].double() / 1e3      # us
            med = lambda a, b: (t[:, b] - t[:, a]).median().item()  # noqa: E731
            rows[name]["phases_us"] = phases = {
                "staging_median": med(0, 1), "rank_and_hot_median": med(1, 2),
                "scan_scatter_median": med(2, 7), "long_segments_median": med(7, 3),
                "phase1_max": (t[:, 4] - t[:, 0]).max().item(), "phase1_median": med(0, 4),
                "barrier_wait_max": (t[:, 5] - t[:, 4]).max().item(),
                "phase2_max": (t[:, 6] - t[:, 5]).max().item(), "phase2_median": med(5, 6),
                "first_to_last": (t[:, 6].max() - t[:, 0].min()).item(), "blocks": len(t)}
            print(f"  {name} phases (us, {phases['blocks']} blocks): " + ", ".join(
                f"{k} {v:.2f}" for k, v in phases.items() if k != "blocks"), flush=True)

    flagship = hierarchical_ordered()
    batch = generate_batch(np.random.default_rng(0), N, flagship.max_num_groups,
                           flagship.max_seq_len)
    commands = torch.from_numpy(batch["commands"]).to(dev)
    args = torch.from_numpy(batch["args"]).to(dev)
    n, g, s_enc = commands.shape
    cmd_f, args_f = commands.reshape(n * g, s_enc), args.reshape(n * g, s_enc, -1)
    for suffix, cfg in (("", gpu_fast(hierarchical_ordered())), ("_f32", hierarchical_ordered())):
        model = load_model(CHECKPOINT, cfg, device=dev)
        with torch.no_grad():
            cmd_table, arg_tables, pos_table = model.encoder.embedding.tables()
            emb_in = (cmd_f, args_f, None, cmd_table, arg_tables, None, pos_table[:s_enc])
            timed("embedding" + suffix, lambda: emb_ops.fused_embedding(*emb_in))
            walls = here.cuda_median_ms(lambda: one_shot_sample(model, commands, args))
        rows["one_shot_sample" + suffix] = {"median_ms": walls}
        print(f"{card}; one_shot_sample{suffix} N={N}: {walls:.3f} ms median of 20", flush=True)
        del model
        torch.cuda.empty_cache()
    # K6: the flagship step's B=128, then the float32 flagship's B=60
    for name, b, dt in (("embedding_bwd", B_TRAIN, torch.bfloat16),
                        ("embedding_bwd_f32", B_RECIPE, torch.float32)):
        tb = generate_batch(np.random.default_rng(0), b, flagship.max_num_groups,
                            flagship.max_seq_len)
        tc = torch.from_numpy(tb["commands"]).to(dev).flatten(0, 1)
        ta = torch.from_numpy(tb["args"]).to(dev).flatten(0, 1).to(torch.int32)
        gen = torch.Generator(device=dev).manual_seed(1)
        dy = torch.randn(*tc.shape, flagship.d_model, device=dev, generator=gen).to(dt)
        k6_in = (tc, ta, None, dy, flagship.n_commands, flagship.args_dim + 1, 0, False)
        timed(name, lambda: emb_ops.embedding_backward(*k6_in),
              lambda st, k6_in=k6_in: emb_ops.embedding_backward(*k6_in, stamps=st))
    # Sketchformer's encoder at B=60, S=242
    sfm = here.sketchformer_model(dev)
    emb = sfm.encoder.embedding
    rb = generate_batch(np.random.default_rng(0), B_RECIPE, sfm.cfg.max_num_groups,
                        sfm.cfg.max_seq_len)
    ce = torch.from_numpy(rb["commands_grouped"]).to(dev)[:, 0]
    ae = torch.from_numpy(rb["args_grouped"]).to(dev)[:, 0].to(torch.int32)
    cmd_table, arg_tables, _ = emb.tables()
    n_group = emb.group_table().shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn(*ce.shape, sfm.cfg.d_model, device=dev, generator=gen).to(torch.bfloat16)
    grp = M.group_mask(ce).to(torch.int32)
    k6_in = (ce, ae, grp, dy, cmd_table.shape[0], arg_tables.shape[0] // sfm.cfg.n_args,
             n_group, True)
    timed("embedding_bwd_long", lambda: emb_ops.embedding_backward(*k6_in),
          lambda st: emb_ops.embedding_backward(*k6_in, stamps=st))
    out = {"card": card, "tree": sys.path[0], "rows": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"embedding_rows{'_' + tag if tag else ''}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


def greedy_wall(card: str, tag: str) -> int:
    """``--greedy-wall``: greedy_sample's wall per call at N=1024, both
    types, as one JSON object."""
    import importlib.util
    import statistics

    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import greedy_sample
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    rows: dict = {}
    for dtype in ("bfloat16", "float32"):
        model = here.sketchformer_model("cuda", compute_dtype=dtype)
        cfg = model.cfg
        batch = generate_batch(np.random.default_rng(0), N, cfg.max_num_groups,
                               cfg.max_seq_len)
        commands = torch.from_numpy(batch["commands_grouped"]).cuda()
        args = torch.from_numpy(batch["args_grouped"]).cuda()
        walls = []
        with torch.no_grad():
            for _ in range(1 + ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                greedy_sample(model, commands, args)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        rows[dtype] = {"walls_ms": walls[1:], "median_ms": statistics.median(walls[1:])}
        print(f"{card}; greedy_sample (Sketchformer) N={N} {dtype}: wall "
              f"{rows[dtype]['median_ms']:.3f} ms median of {ITERS} (host clock, no profiler; "
              f"{', '.join(f'{w:.3f}' for w in walls[1:])})", flush=True)
        del model
        torch.cuda.empty_cache()
    result = {"card": card, "N": N, "rows": rows}
    print(json.dumps(result))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"greedy_wall{'_' + tag if tag else ''}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return 0


def k9_rows(card: str, tag: str) -> int:
    """``--k9``: K9's times at N=1024, T=241, index 1/120/240, both types, as
    one JSON object."""
    from deepsvg_tpu_torch.ops import decode as decode_ops
    dev = torch.device("cuda")
    n, t, n_layers, d, heads, f = N, 241, 4, 256, 8, 512
    peak = {torch.bfloat16: 989e12, torch.float32: 495e12}   # dense bf16, TF32
    rng = np.random.default_rng(9)
    rnd = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        scale * rng.standard_normal(shape, dtype=np.float32)).to(dev)
    ln = lambda *lead: torch.stack([1 + rnd(*lead, d, scale=0.1),  # noqa: E731
                                    rnd(*lead, d, scale=0.1)], dim=len(lead))
    key_pad = torch.zeros(n, t, device=dev)
    eos = torch.from_numpy(rng.integers(1, t, n)).to(dev)
    tail = torch.arange(n, device=dev) % 3 == 0
    key_pad[tail] = torch.where(torch.arange(t, device=dev)[None] < eos[tail, None], 0.0,
                                float("-inf"))
    master = (rnd(n, d), rnd(n_layers, n, d, scale=0.3), ln(n_layers),
              rnd(n_layers, 3 * d, d, scale=d ** -0.5), rnd(n_layers, 3 * d, scale=0.1),
              rnd(n_layers, d, d, scale=d ** -0.5), rnd(n_layers, d, scale=0.1), ln(n_layers),
              rnd(n_layers, f, d, scale=d ** -0.5), rnd(n_layers, f, scale=0.1),
              rnd(n_layers, d, f, scale=f ** -0.5), rnd(n_layers, d, scale=0.1), ln(),
              rnd(n_layers, n, t, d), rnd(n_layers, n, t, d))
    w_elems = n_layers * (4 * d * d + 2 * d * f + 3 * d + d + f + d + 4 * d) + 2 * d
    rows: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.empty((), dtype=dtype).element_size()
        ops = [m.to(dtype).contiguous() for m in master] + [key_pad]
        for index in (1, 120, 240):
            def step():
                return decode_ops.fused_decode_step(*ops, index, heads)
            n_bytes = (2 * n_layers * n * index * d * es + w_elems * es + n * (index + 1) * 4
                       + n * d * es * 2 + n_layers * n * d * es * 3)
            flops = (2.0 * n * n_layers * (4 * d * d + 2 * d * f)
                     + 4.0 * n * n_layers * (index + 1) * d)
            dev_ms, kern = device_ms(step)
            name = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_index{index}"
            rows[name] = {
                "ms": events_ms(step), "device_ms": dev_ms, "kernels_ms": kern,
                "plain_ms": events_ms(
                    lambda: decode_ops.decode_step_reference(*ops, index, heads), iters=3,
                    warmup=1),
                "bound_ms": max(n_bytes / 3.35e12, flops / peak[dtype]) * 1e3}
            print(f"{name}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in rows[name].items()), flush=True)
        del ops
    out = {"card": card, "root": os.path.dirname(os.path.dirname(decode_ops.__file__)),
           "ms": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"k9_rows{'_' + tag if tag else ''}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


def mha_rows(card: str, tag: str) -> int:
    """``--mha``: K10 and K11's forward at chip_smoke's shapes, both types,
    as one JSON object."""
    import torch.nn.functional as F

    from chip_smoke import B_RECIPE, CHECKPOINT as CKPT, PEAK_BF16, PEAK_TF32, bound, matmul_tf32
    from deepsvg_tpu_torch.configs.sketchformer import make_model_config
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import hierarchical_ordered, load_params
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.models.weights import attention_operands
    from deepsvg_tpu_torch.ops import attention as attn_ops
    from deepsvg_tpu_torch.ops import attention_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    dev = torch.device("cuda")
    layer0 = load_params(CKPT)["encoder"]["encoder"]["layer_0"]
    w16 = attention_operands(layer0["wqkv"], layer0["bqkv"], layer0["wo"], layer0["bo"], dev,
                             torch.bfloat16)
    d = w16[0].shape[1]
    heads = d // 32
    cfg, sf_cfg = hierarchical_ordered(), make_model_config()
    fb = generate_batch(np.random.default_rng(0), N, cfg.max_num_groups, cfg.max_seq_len)
    f_cmd = torch.from_numpy(fb["commands"]).to(dev).reshape(-1, fb["commands"].shape[-1])
    sb = generate_batch(np.random.default_rng(0), N, sf_cfg.max_num_groups, sf_cfg.max_seq_len)
    s_cmd = torch.from_numpy(sb["commands_grouped"]).to(dev)[:, 0]
    mask_of = lambda c: key_padding_to_additive(M.key_padding_mask(c))  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = {"K10 8192x32": (f_cmd, 0.0), "K10 1024x242": (s_cmd, 0.0),
             "K11 fwd 60x242": (s_cmd[:B_RECIPE], 0.1),
             "K11 fwd 1024x32": (f_cmd[:B_TRAIN * cfg.max_num_groups], 0.1)}

    def lib(x, mask, w, rate):
        b, s, _ = x.shape
        qkv = F.linear(x, w[0], w[1]).reshape(b, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                             attn_mask=mask[:, None, None, :].to(x.dtype),
                                             dropout_p=rate)
        return F.linear(ctx.transpose(1, 2).reshape(b, s, d), w[2], w[3])

    rows: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        w = [t.to(dtype) for t in w16]
        for what in ("K11 bwd 60x242", "K11 bwd 1024x32"):
            rows[f"{what} {'bf16' if dtype == torch.bfloat16 else 'f32'}"] = mha_backward_row(
                cases[what.replace("bwd", "fwd")][0], mask_of, w, heads, gen, lib)
        for what, (cmd, rate) in cases.items():
            mask = mask_of(cmd)
            b, s = cmd.shape
            x = torch.randn(b, s, d, device=dev, generator=gen).to(dtype)
            if rate:
                def run():
                    with torch.no_grad():
                        return attention_vjp.fused_mha_train(x, *w, mask, 2024, heads, False,
                                                             rate)
            else:
                def run():
                    return attn_ops.fused_mha(x, *w, mask, heads)
            ops = 2.0 * b * s * d * 4 * d + 4.0 * b * s * s * d
            es = x.element_size()
            n_bytes = 2 * x.numel() * es + sum(t.numel() for t in w) * es + b * s * 4
            dev_ms, kern = device_ms(run)
            name = f"{what} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            row = {"ms": events_ms(run), "device_ms": dev_ms, "kernels_ms": kern,
                   "bound_ms": bound(n_bytes, ops,
                                     PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32)[0]}
            with torch.no_grad():
                if dtype == torch.bfloat16:
                    row["library_ms"] = events_ms(lambda: lib(x, mask, w, rate))
                else:
                    with matmul_tf32(True):
                        row["library_tf32_ms"] = events_ms(lambda: lib(x, mask, w, rate))
                    with matmul_tf32(False):
                        row["library_ms"] = events_ms(lambda: lib(x, mask, w, rate))
            rows[name] = row
            print(f"{name}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
            del x
    out = {"card": card, "root": os.path.dirname(os.path.dirname(attn_ops.__file__)),
           "ms": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"mha_rows{'_' + tag if tag else ''}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


def mha_backward_row(cmd, mask_of, w, heads, gen, lib, rate=0.1) -> dict:
    """K11's backward alone (``--mha``): one forward of ``fused_mha_train``
    at dropout ``rate`` kept under autograd, its backward rerun on the same
    graph. CUDA events, device time under ``torch.profiler`` (every kernel of
    the call, and by kernel name), the bound (``chip_smoke.py``'s), and the
    backward of ``F.linear`` -> SDPA -> ``F.linear`` the same way, events and
    device time (float32 in TF32 and in full float32)."""
    from chip_smoke import PEAK_BF16, PEAK_TF32, bound, matmul_tf32
    from deepsvg_tpu_torch.ops import attention_vjp
    dev = torch.device("cuda")
    dtype = w[0].dtype
    mask = mask_of(cmd)
    b, s = cmd.shape
    d = w[0].shape[1]
    leaves = [torch.randn(b, s, d, device=dev, generator=gen).to(dtype).requires_grad_(),
              *[t.detach().clone().requires_grad_() for t in w]]
    g = torch.randn(b, s, d, device=dev, generator=gen).to(dtype)
    out = attention_vjp.fused_mha_train(leaves[0], *leaves[1:], mask, 2024, heads, False, rate)

    def run():
        return torch.autograd.grad(out, leaves, g, retain_graph=True)

    es = g.element_size()
    n_bytes = 3 * g.numel() * es + 2 * sum(t.numel() for t in w) * es
    dev_ms, kern = device_ms(run)
    row = {"B": b, "S": s, "ms": events_ms(run), "device_ms": dev_ms, "kernels_ms": kern,
           "bound_ms": bound(n_bytes, 22.0 * b * s * d * d + 12.0 * b * s * s * d,
                             PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32)[0]}
    del out
    for key, tf32 in (("library", False), ("library_tf32", True)):
        if tf32 and dtype == torch.bfloat16:
            continue
        with matmul_tf32(tf32):
            lib_out = lib(leaves[0], mask, leaves[1:], rate)

            def lib_run():
                return torch.autograd.grad(lib_out, leaves, g, retain_graph=True)

            row[f"{key}_ms"] = events_ms(lib_run)
            row[f"{key}_device_ms"] = device_ms(lib_run)[0]
        del lib_out
    print(f"K11 bwd {b}x{s} {dtype}: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()),
        flush=True)
    return row


def k4_short_f32_row(dev, heads, d, f, rate) -> dict:
    """K4's float32 short form (S <= 16) at E2 above the stack gate (B=128
    sequences of 8, key-padded, the bfloat16 model's weights rounded to
    bfloat16, float32 activations; dropout ``rate``): forward and forward +
    backward with CUDA events and as device time, its plain version, its
    bound (as ``chip_smoke.k4_bound``) and ``nn.TransformerEncoderLayer`` on
    the same weights in float32 with TF32 products and in full float32."""
    from deepsvg_tpu_torch.ops import layer_vjp
    b, s = 128, 8
    rng = np.random.default_rng(128)
    rnd = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        scale * rng.standard_normal(shape, dtype=np.float32)).to(dev)
    masters = [torch.stack([1 + rnd(d, scale=0.1), rnd(d, scale=0.1)]),
               rnd(3 * d, d, scale=d ** -0.5), rnd(3 * d, scale=0.1), rnd(d, d, scale=d ** -0.5),
               rnd(d, scale=0.1), torch.stack([1 + rnd(d, scale=0.1), rnd(d, scale=0.1)]),
               rnd(f, d, scale=d ** -0.5), rnd(f, scale=0.1), rnd(d, f, scale=f ** -0.5),
               rnd(d, scale=0.1)]
    masters = [w.requires_grad_() for w in masters]
    x = rnd(b, s, d).requires_grad_()
    lengths = torch.from_numpy(rng.integers(1, s + 1, b)).to(dev)
    mask = torch.where(torch.arange(s, device=dev)[None] < lengths[:, None], 0.0, float("-inf"))
    gy = rnd(b, s, d)
    call = (x, None, *masters, mask, 7, heads, False, rate, torch.bfloat16)
    leaves = [x, *masters]

    def runs(fn, **kw):
        def fwd():
            with torch.no_grad():
                return fn(*call, **kw)

        def both():
            return torch.autograd.grad(fn(*call, **kw), leaves, gy)
        return fwd, both
    fwd, both = runs(layer_vjp.fused_layer_train, save_residuals=True)
    pfwd, pboth = runs(layer_vjp.plain_layer_train)
    row = {"fwd_ms": events_ms(fwd), "bwd_ms": events_ms(both) - events_ms(fwd)}
    dev_f, kern_f = device_ms(fwd)
    dev_fb, _ = device_ms(both)
    row.update(device_fwd_ms=dev_f, device_bwd_ms=dev_fb - dev_f, kernels_fwd_ms=kern_f)
    pf, pfb = events_ms(pfwd, iters=5, warmup=1), events_ms(pboth, iters=5, warmup=1)
    row.update(plain_fwd_ms=pf, plain_bwd_ms=pfb - pf)
    # the bound: x, the mask and the weights as read (bf16) in, out; the
    # products and attention at the TF32 peak; backward: g in, dx and the
    # float32 weight gradients out, twice the operations
    rows_, es, w_elems = b * s, 4, 4 * d * d + 2 * d * f + 9 * d + f
    common = rows_ * d * es + b * s * 4 + w_elems * 2
    ops = 2.0 * rows_ * (4 * d * d + 2 * d * f) + 4.0 * b * s * s * d
    row["fwd_bound_ms"] = max((common + rows_ * d * es) / 3.35e12, ops / 495e12) * 1e3
    row["bwd_bound_ms"] = max((common + 2 * rows_ * d * es + w_elems * 4) / 3.35e12,
                              2 * ops / 495e12) * 1e3
    lib = torch.nn.TransformerEncoderLayer(d, heads, f, dropout=0.0, activation="relu",
                                           batch_first=True, norm_first=True, device=dev)
    with torch.no_grad():
        used = [w.detach().to(torch.bfloat16).float() for w in masters]
        lib.norm1.weight.copy_(used[0][0])
        lib.norm1.bias.copy_(used[0][1])
        lib.self_attn.in_proj_weight.copy_(used[1])
        lib.self_attn.in_proj_bias.copy_(used[2])
        lib.self_attn.out_proj.weight.copy_(used[3])
        lib.self_attn.out_proj.bias.copy_(used[4])
        lib.norm2.weight.copy_(used[5][0])
        lib.norm2.bias.copy_(used[5][1])
        lib.linear1.weight.copy_(used[6])
        lib.linear1.bias.copy_(used[7])
        lib.linear2.weight.copy_(used[8])
        lib.linear2.bias.copy_(used[9])
    lib.train()
    x_lib = x.detach().requires_grad_()
    pad = torch.isneginf(mask)
    for name, tf32 in (("library_tf32", True), ("library", False)):
        torch.backends.cuda.matmul.allow_tf32 = tf32

        def lib_fwd():
            with torch.no_grad():
                return lib(x_lib, src_key_padding_mask=pad)

        def lib_both():
            return torch.autograd.grad(lib(x_lib, src_key_padding_mask=pad),
                                       [x_lib, *lib.parameters()], gy)
        lf, lfb = events_ms(lib_fwd), events_ms(lib_both)
        row[f"{name}_fwd_ms"], row[f"{name}_bwd_ms"] = lf, lfb - lf
    torch.backends.cuda.matmul.allow_tf32 = False
    print("k4_f32_e2_b128: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()),
        flush=True)
    return row


def k4_rows(card: str, tag: str) -> int:
    """``--k4``: the long K4's times at its paths' shapes, as one JSON object."""
    from chip_smoke import cuda_ms, k4_bound, k4_runs, sketchformer_model
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import hierarchical_ordered, load_model
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import layer_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    rows: dict = {}

    def library(layer, dtype):
        lib = torch.nn.TransformerEncoderLayer(
            layer.qkv.in_features, layer.n_heads, layer.ff1.out_features, dropout=0.0,
            activation="relu", batch_first=True, norm_first=True, device=dev, dtype=dtype)
        with torch.no_grad():
            lib.self_attn.in_proj_weight.copy_(layer.qkv.weight)
            lib.self_attn.in_proj_bias.copy_(layer.qkv.bias)
            lib.self_attn.out_proj.weight.copy_(layer.out_proj.weight)
            lib.self_attn.out_proj.bias.copy_(layer.out_proj.bias)
            for dst, src in ((lib.linear1, layer.ff1), (lib.linear2, layer.ff2)):
                dst.weight.copy_(src.weight)
                dst.bias.copy_(src.bias)
            for dst, src in ((lib.norm1, layer.norm1), (lib.norm2, layer.norm2)):
                dst.weight.copy_(src[0])
                dst.bias.copy_(src[1])
        return lib.train()

    def time_case(name, layer, x, sb, mask, causal):
        fwd, both = k4_runs(layer_vjp.fused_layer_train, layer, x, sb, mask, causal, gen=gen)
        rc_fwd, _ = k4_runs(layer_vjp.fused_layer_train, layer, x, sb, mask, causal,
                            save_residuals=False, gen=gen)
        pfwd, pboth = k4_runs(layer_vjp.plain_layer_train, layer, x, sb, mask, causal, gen=gen)
        f_ms, fb_ms, rc_ms = cuda_ms(fwd), cuda_ms(both), cuda_ms(rc_fwd)
        dev_f, kern_f = device_ms(fwd)
        dev_fb, kern_fb = device_ms(both)
        _, kern_rc = device_ms(rc_fwd)
        pf_ms, pfb_ms = cuda_ms(pfwd, iters=3, warmup=1), cuda_ms(pboth, iters=3, warmup=1)
        f_ff = layer.ff1.out_features
        (bf_ms, bf_by), (bb_ms, bb_by) = (k4_bound(x, sb, f_ff, bwd, causal)
                                          for bwd in (False, True))
        row = {"fwd_ms": f_ms, "bwd_ms": fb_ms - f_ms, "recompute_fwd_ms": rc_ms,
               "device_fwd_ms": dev_f, "device_bwd_ms": dev_fb - dev_f,
               "kernels_fwd_ms": kern_f, "kernels_recompute_fwd_ms": kern_rc,
               "kernels_bwd_ms": {
                   k: v - kern_f.get(k, 0.0) for k, v in kern_fb.items()
                   if v - kern_f.get(k, 0.0) > 1e-4},
               "plain_fwd_ms": pf_ms, "plain_bwd_ms": pfb_ms - pf_ms,
               "fwd_bound_ms": bf_ms, "fwd_bound_by": bf_by, "bwd_bound_ms": bb_ms,
               "bwd_bound_by": bb_by}
        # nn.TransformerEncoderLayer on the same rows (no seq_bias, no causal
        # mask: the yardstick of the same products and attention)
        pad = torch.isneginf(mask)
        for lib_name, tf32 in ((("library_tf32", True), ("library", False))
                               if x.dtype == torch.float32 else (("library", False),)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            lib = library(layer, x.dtype)
            x_lib = x.detach().requires_grad_()
            g_lib = torch.randn(x.shape, device=dev, generator=gen).to(x.dtype)

            def lib_fwd():
                with torch.no_grad():
                    return lib(x_lib, src_key_padding_mask=pad)

            def lib_both():
                return torch.autograd.grad(lib(x_lib, src_key_padding_mask=pad),
                                           [x_lib, *lib.parameters()], g_lib)
            lf, lfb = cuda_ms(lib_fwd), cuda_ms(lib_both)
            row[f"{lib_name}_fwd_ms"], row[f"{lib_name}_bwd_ms"] = lf, lfb - lf
            torch.backends.cuda.matmul.allow_tf32 = False
            del lib
        rows[name] = row
        print(f"{name}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else
            f"{k} {{{', '.join(f'{n} {t:.4f}' for n, t in v.items())}}}" if isinstance(v, dict)
            else f"{k} {v}" for k, v in row.items()), flush=True)

    # the float32 flagship at B=60: E1 (480 x 32, key padding) and D1 (480 x
    # 31, seq_bias), the trained layers; S=242 on E1's layer
    model = load_model(CHECKPOINT, hierarchical_ordered(), device=dev)
    l_e1, l_d1 = model.encoder.encoder.layers[0], model.decoder.decoder.layers[0]
    cfg = model.cfg
    batch = generate_batch(np.random.default_rng(0), B_RECIPE, cfg.max_num_groups,
                           cfg.max_seq_len)
    cmd = torch.from_numpy(batch["commands"]).to(dev).flatten(0, 1)
    with torch.no_grad():
        x_e1 = torch.randn(cmd.shape[0], cmd.shape[1], cfg.d_model, device=dev, generator=gen)
        kp_e1 = key_padding_to_additive(M.key_padding_mask(cmd))
        x_d1 = torch.randn(cmd.shape[0], cmd.shape[1] - 1, cfg.d_model, device=dev,
                           generator=gen)
        sb_d1 = torch.randn(cmd.shape[0], cfg.d_model, device=dev, generator=gen)
        kp_d1 = torch.zeros(x_d1.shape[:2], device=dev)
        x_242 = torch.randn(B_RECIPE, 242, cfg.d_model, device=dev, generator=gen)
        kp_242 = torch.where(torch.arange(242, device=dev)[None] < torch.randint(
            100, 243, (B_RECIPE, 1), device=dev, generator=gen), 0.0, float("-inf"))
    time_case("f32_e1", l_e1, x_e1, None, kp_e1, False)
    time_case("f32_d1", l_d1, x_d1, sb_d1, kp_d1, False)
    time_case("f32_s242", l_e1, x_242, None, kp_242, False)
    del model
    # bfloat16: Sketchformer's E1 (S=242) and its causal decoder (S=241)
    sf = sketchformer_model(dev)
    l_e, l_d = sf.encoder.encoder.layers[0], sf.decoder.decoder.layers[0]
    with torch.no_grad():
        sbatch = generate_batch(np.random.default_rng(0), B_RECIPE, sf.cfg.max_num_groups,
                                sf.cfg.max_seq_len)
        sc = torch.from_numpy(sbatch["commands_grouped"]).to(dev)[:, 0]
        sa = torch.from_numpy(sbatch["args_grouped"]).to(dev)[:, 0]
        x_se = sf.encoder.embedding(sc, sa, M.group_mask(sc))
        kp_se = key_padding_to_additive(M.key_padding_mask(sc))
        x_sd, kp_sd = x_se[:, :-1].contiguous(), kp_se[:, :-1].contiguous()
        sb_sd = torch.randn(B_RECIPE, sf.cfg.d_model, device=dev,
                            generator=gen).to(torch.bfloat16)
    time_case("bf16_e1_s242", l_e, x_se, None, kp_se, False)
    time_case("bf16_decoder_s241", l_d, x_sd, sb_sd, kp_sd, True)
    out = {"card": card, "root": ROOT, "ms": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"k4_rows{'_' + tag if tag else ''}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
