"""Run the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

In order: print the card and its power limit; build the port's CUDA kernels
from ``deepsvg_tpu_torch/ops/csrc``; load the trained flagship checkpoint;
then five paths in bfloat16, the float32 models, the attention ops, K4's
recompute mode, the model variants (the one-stage one-shot model, the
label-conditioned fonts model, temperature sampling), the variants
(SketchRNN's LSTM, two-stage autoregressive decoding, the decode-only model)
the geometry (SVG text in and out of the flagship, the reconstruction
metrics and a differentiable descent on the card), the real-data
loaders with the apps (the preprocessing CLI, training on real data, the
inference session, the animation's finetune, the web GUI), serving,
parallelism, and the kernels at head dims 8 and 16 with the tiny configs. Every earlier phase
runs K4 in its saved mode, the model's default
(``layer_vjp.SAVE_RESIDUALS_DEFAULT``).

*Inference* (greedy one-shot encode+decode, N=1024): each kernel (K1
embedding on its Hopper form, K2 fused layer in its bfloat16 and float32
forms, K3 head+argmax) against its plain PyTorch version at the path's
shapes (K2 also at S=1 and
S=17, random inputs, at batches where every persistent block of the
bfloat16 kernel takes several tiles); one counted run of
``one_shot_sample`` whose output is validated; the kernel path against the
plain path at N=64 with a control that must fail; timings (K3 also at the
autoregressive decode's R = 1,024 rows a step, and beside its library
yardstick, ``F.linear`` over the packed head then an argmax per slot).

*Training* (one step = forward with dropout, loss, backward, clip, AdamW;
B=128, bfloat16 compute, float32 masters): K4 (the fused layer's forward and
each of its twelve gradients, at the four stacks' shapes, without and with
dropout, causal, with a fully masked sequence; bfloat16 through its wgmma
form; a reading, no gate, of the float32 form's E2 output against a plain
version in full float32 and one in TF32), K5 (argument cross-entropy and
its three gradients) and K6 (the embedding tables' gradients) against their
plain versions; one step on the kernel path against the same step on the
plain path at B=16 and dropout 0 (loss terms, every leaf's gradient, the
global norm); one counted step; 23 steps on one batch at dropout 0.1 whose
loss must stay finite and fall, the last 20 timed; timings of each kernel, its
plain version and a PyTorch yardstick where one exists (K1 and K6 also as
device time under ``torch.profiler``). The B=16 step takes
K7 at E2 and D2 (16 x 8 rows is under the stack gate's 512); B=128 does not.

*The recipe's training run* (B=60, where E2 and D2 take the fused stack K7):
K7's forward, layer by layer, and its twelve gradients against its plain
version at E2 and D2 shapes, at B=60 and at the gate's edge B=64, dropout 0
and 0.1, four layers and two, in bfloat16 and in float32 (the same masters),
and at a narrower width (D=128, 4 heads, seeded layers), each case over
K7_DRAWS draws of inputs from generators of their own, the gradients held
against the plain version with K7's ReLU units and its roundings of the
gradients (as they are, read); against the chain of K4 calls within the
limits each meets against the plain version (its gradients against the
plain version with the chain's own units and roundings), and its
gradients on a second run equal to the bit; two controls (layer 1 cut to
CONTROL_MANTISSA_BITS mantissa bits) that must fail both gradient gates;
the step at B=60
(counted, timed); the B=128 loop twice more, untimed, its gradients
checksummed by step and leaf, equal in every leaf at every step (no kernel
of the step sums with atomics; K6 on the path's inputs also run three times,
equal to the bit); the training CLI's ``train()`` on the flagship config with
the synthetic dataset resident on the card: a first run with an asynchronous
checkpoint, then a resumed run (step count, finite falling loss, the
checkpoint's parameters and the resumed ones equal to the bit, launches per
step); K7 and the K4 chain timed at 480 and 1,024 rows, and K7's float32
form at E2 and D2, B=60, beside ``nn.TransformerEncoder`` in float32 (TF32
products, and full float32).

*The Hungarian self-matching model with its VAE* (B=60), built from the
flagship checkpoint's leaves (:func:`self_match_model`): K8 against its
plain version on the decoder states and targets the step gives it (R =
14,880 rows, G = 8), each variant's columns against K5's forward to the bit;
the kernel path's assignments against the plain path's, over the samples
whose visible-row margin is at least MATCH_MARGIN, and a control that must
fail; the step (counted: K1 1, K4 8 + 8, K7 2 + 2, K5 1 + 1, K6 1, K8 1;
timed, 23 steps on one batch); the CLI's ``train()`` on the
``hierarchical_self_matching`` config with a checkpoint and a resume; the
VAE model's ``one_shot_sample`` at N=1024 (counted, validated, the same
from call to call); K8, its plain version and ``F.linear`` +
``log_softmax`` + ``gather`` timed.

*Sketchformer's autoregressive greedy decode* (N=1024 icons of 8 x 30
commands, one sequence of 242 with SOS and EOS; T = 241 cache positions;
random weights from a seed, :func:`sketchformer_model`): K9 against its
plain version on the decode's own operands at positions 1, 120 and 240, and
its launch at N=1024 one wave of the card (clusters of two 8-row blocks);
K2's long form against its plain version at E1 (S=242, key padding), S=240
and the teacher-forced decoder (S=241, causal); K3 at 512 argument classes;
one counted ``greedy_sample`` (K1 1, long K2 4, K9 240, K3 240, no plain
version called); kernel path against plain path at N=64, each sequence's
outputs equal before its first position whose plain margin is below
AR_MARGIN, with a control that must fail; the teacher-forced forward over
the decoded tokens, whose argmax must be the decoded token wherever its
margin is at least TF_MARGIN; times of the encode, the decode (and K9 per
launch under the profiler), ``greedy_sample`` and the cached scan in plain
PyTorch operations (K9's yardstick), K9 alone at the three positions with
its bound, and the long K2 with its plain version and
``nn.TransformerEncoderLayer``.

*Sketchformer's training* (B=60, the recipe's batch: encoder S=242, causal
teacher-forced decoder S=241, 512 relative argument classes; random weights
from a seed): the long form of K4 against its plain version, forward and
twelve gradients, at S=242 and S=241 causal with ``seq_bias``, dropout 0 and
0.1, and in float32 at S=32, S=31 causal with ``seq_bias`` and S=242 (its
own kernel entries), with the short form's limits; its gradients bit-equal
from run to run; K6 on the path's inputs and group
tables (S=242, 241) and K5 at 512 classes against their plain versions;
one counted ``train_step`` (K1 2, long K4 8 + 8, K5 1 + 1, K6 2, no plain
version called, no short K4), 23 steps on one batch whose loss must stay
finite and fall, timed, with the device busy time, idle share and device
time by part; the CLI's ``train()`` on ``configs/sketchformer.py`` with a
checkpoint and a resume to the bit; the long K4 (both modes' forward, and
each device time under the profiler), K5 and K6 timed at the path's shapes
beside their bounds, their plain versions and a PyTorch call
(``nn.TransformerEncoderLayer`` in training mode, ``F.linear`` +
``F.cross_entropy``, ``index_add_``).

*The float32 models* (``compute_dtype`` "float32", the configs' default;
:func:`float32_phase`): the flagship's ``one_shot_sample`` at N=1024 on the
trained checkpoint and its ``train_step`` at B=60, the self-match step at
B=60 and Sketchformer's ``greedy_sample`` at N=1024, each counted (the
float32 forms of K1, K3, K5, K8 and K9 beside the float32 K2, K4 and K7, no
plain version called; K9's float32 form also alone at positions 1, 120 and
240) and against its plain path, gated by margin with a
control that must fail; the step's device busy time, idle share and device
time by part; K6 on the step's float32 ``dy`` against its plain version,
three runs equal to the bit, timed (``embedding_bwd_f32``); the long K4 at
the step's E1 and D1 (480 x 32 and x 31) and
at S=242, beside ``nn.TransformerEncoderLayer`` in TF32 and full float32; each float32 form against its plain version and
timed beside its bound, plain version and library call (K3 beside
``F.linear`` + argmax in TF32 and in full float32, and at R = 1,024; the
float32 K2 at the flagship's E1 and D1, 8,192 x 32 and x 31, and the long
form at Sketchformer's encoder, S=242, beside ``nn.TransformerEncoderLayer``
in float32).

*The attention ops* (:func:`attention_phase`): K10 (``fused_mha``) and K11
(``fused_mha_train``, dropout 0 and 0.1, forward and its five gradients) at
the model's width with the trained E1 layer 0 weights, in bfloat16 and in
float32, against their plain versions (K11 elementwise with dropout on,
bit-equal from run to run) and timed beside ``F.linear`` ->
``F.scaled_dot_product_attention`` -> ``F.linear`` (float32 also in TF32);
one D=128 case, K10 and K11 forward and backward, on the first port's
kernels.

*K4's recompute mode* (:func:`recompute_phase`; ``save_residuals=False``,
the JAX op's default): its forward and backward, short and long form,
against their plain versions at the paths' shapes (the flagship's E1 at B=60
and B=128, E2 in float32 at B=128, Sketchformer's encoder and causal decoder
at B=60, a float32 E1 at B=60), each output equal to the saved mode's to the
bit and the gradients equal from run to run; then, with the switch off, (a)
the flagship's step at B=60, (b) at B=128, (c) Sketchformer's at B=60 and
(d) the float32 flagship's at B=60: each counted (recompute launches alone,
no plain version), gated against its plain path at dropout 0 with a control
that must fail, timed in both modes (median of 20 after 3) and read for
each mode's peak memory and, under ``torch.profiler``, for the device time
of the step and of K5's kernels in it; each entry timed beside its bound,
the saved mode, its plain version and ``torch.utils.checkpoint`` around
``nn.TransformerEncoderLayer``.

*The model variants* (:func:`variants_phase`; random weights from
VARIANT_SEED). The one-stage one-shot model (``configs/one_stage_one_shot.py``),
in bfloat16, then float32: ``one_shot_sample`` at N=1024 counted (K1 1, the
long K2 8: E1 at S=242 and D1 at S=241, not causal, with ``seq_bias``; K3
1 at R = N x 241; no plain version called), validated and timed (wall,
device busy, idle share); K1, both long K2 layers and K3 against their plain
versions on the path's operands, D1's layer and K3 timed beside their bound,
plain version and library call; kernel path against plain path at N=64 (ids
above AR_MARGIN equal, logits within AR_LOGIT_LIMIT) with a control that
must fail; the long K4 at D1's shape (B=60, S=241, not causal, seq_bias)
timed; the step at B=60 counted (K1 1, long K4 8 + 8, K5 1 + 1, K6 1; no
visibility term), timed and gated against its plain path at dropout 0 with
a control; in bfloat16 the CLI's ``train()`` with a resume. The
label-conditioned fonts model (``configs/hierarchical_ordered_fonts.py``):
``one_shot_sample`` with labels at N=1024 counted (K2 12 + 4 float32, K3 1),
another label decoding otherwise, timed, and against its plain path at N=64
with a control; ``greedy_sample`` with a ``torch.Generator`` at temperature
SAMPLE_LOW_T (the greedy ids wherever the margin is at least AR_MARGIN) and 1
(valid, not the greedy ids), counted (no K3); K7 against its plain version
with the label's injections at E2 and z's plus the label's at D2, B=60,
rates 0 and 0.1, bfloat16 and float32, over K7_DRAWS draws; the step at B=60
counted (K4 8 + 8, K7 2 + 2, K5 1 + 1, K1 1, K6 1), timed and gated with a
control; the CLI with a resume. Last, Sketchformer's ``greedy_sample`` with
a generator at SAMPLE_LOW_T and 1 (K9 240, no K3), the low temperature's
draws equal to the greedy decode before each sequence's first position below
AR_MARGIN.

*The LSTM, two-stage autoregressive decoding and the decode-only model*
(:func:`decoders_phase`; random weights from LSTM_SEED). SketchRNN
(``config.sketchrnn()``, float32, its only type): encode at N=1024 counted
(K1-f32 1), timed, K1 against its plain version on its operands and the
latent against the plain path's; the teacher-forced forward at N=64 against
its plain path (logits within RNN_LOGIT_LIMIT) with a control (the LSTM
cells cut to CONTROL_MANTISSA_BITS); ``autoregressive_sample`` at
N_RNN_SAMPLE counted (K1-f32 240), timed, its output valid and the
teacher-forced argmax over its tokens equal to them above TF_MARGIN; the
step at B=60 counted (K1-f32 2, K6 2, K5-f32 1 + 1), timed and gated with a
control. The LSTM encoder with the flagship's one-shot decoder in bfloat16:
``one_shot_sample`` at N=1024 counted (K1 1, K2 8 + 4 float32, K3 1),
validated, timed, against its plain path at N=64 with a control. The
two-stage autoregressive model at the flagship's widths, bfloat16 then
float32: the teacher-forced forward at N=1024 counted (K1 2, K2 12 + 4
float32; float32 K1 2, K2 16), timed, against its plain path with a
control; K7 with ``causal=True`` and key padding at S=9, B_K7_CAUSAL, on its
D1 layers, rates 0 and 0.1; the step at B=60 counted (K1 2, K4 8 + 8 short
bf16 or long float32, K7 2 + 2, K5 1 + 1, K6 2), timed and gated with a
control. The decode-only models from a latent at N=1024: ``one_shot_sample``
at one stage (long K2 4, K3 1) and two (K2 8, K3 1) and the autoregressive
form's ``greedy_sample`` (K9 240, K3 240), each validated, timed and
against its plain path with a control. This phase's launch counts and
controls are held at the end of the run, so that one run prints them all.

*The geometry* (:func:`geometry_phase`, the trained flagship in bfloat16):
the native fitting engine built with ``g++`` and held to the Python fitting
within GEOM_NATIVE_ATOL; the documents of GEOMETRY_SVGS (relative
commands, H/V, quadratic, smooth, implicit lineto, subpaths, arcs, the
primitives) through the port's svglib (``canonicalize(normalize=True)``,
``simplify_heuristic``, ``numericalize``, ``to_tensor``), packed to 8 x 30 and
tiled to N=1024; ``evaluation.reconstruct`` counted (K1 1, K2 12 + 4 float32,
K3 1; no plain version called), validated, timed, its states against the
plain path's at N=64 (``path_gate``, ids held, a control that must fail);
every output back to SVG text (``SVG.from_tensor`` -> ``to_str``) and parsed
again; ``recon_metrics`` in both group modes on the card (no kernel
launched), its ratios printed and timed, each sum held to the CPU's on the
first N_GEOM_CPU rows within GEOM_METRIC_RTOL; the EMD descent of
``examples/02`` (the unit circle's cubics onto GEOM_TARGET, EMD_STEPS steps
at EMD_LR, float32, autograd), its first step held to the CPU's and its loss
falling. Its launch counts and gates are held at the end of the run.

*The data and the apps* (:func:`data_apps_phase`, the flagship config,
bfloat16, B=60): an SVG corpus the script writes (:func:`write_svg_corpus`:
77 files, three of which the config's filters drop and one that does not
parse) through ``python -m deepsvg_tpu_torch.data.preprocess --workers 4``
(one meta row per parsed file); the survivors as tensor pickles of
DATA_AUGS augmentations; ``training/train.py:train`` through
``load_dataset(cfg)``, DATA_STEPS steps on the pickles (device-resident)
and on the simplified SVGs (streamed, augmented on the fly), each counted at
the recipe step's launches with no plain version called, finite losses and
a checkpoint that ``inference.load_session`` reads back to the bit; the
trained flagship's session on the card (``encode_svg`` K1 1, K2 4 + 4
float32; ``interpolate_svg`` adds a decode, K2 8 and K3 1), the decode of 64
interpolation latents held to the plain path's by ``path_gate`` with a
control, every frame back to SVG text that parses again, encode and decode
timed; ``animate.compute_interpolation`` (the finetune's 8 steps and the
in-betweens, counted; the live session unchanged); the web GUI on a thread
over HTTP (two pencil keyframes, ``/api/interpolate`` counted, every frame
filled).

*Serving* (:func:`serving_phase`, the trained flagship): ``serving.
export_session`` of the bfloat16 model at buckets 1 and 64 and of the
float32 model at 64, each export timed; the bfloat16 artifacts loaded in a
child process that imports ``torch`` and the operators alone (its
``sys.modules`` read), and in this one; the served encode and decode held
to the live model (z's largest difference, the ids equal) and counted
(encode K1 1, K2 4 + K2-f32 4; decode K2 8, K3 1; float32: K1-f32 1,
K2-f32 8; K2-f32 8, K3-f32 1), a ragged batch of SERVE_RAGGED through
``serve_batch`` into bucket 64; Sketchformer's decoder (random weights; the
deterministic bottleneck in the VAE's place, whose encode no package
exports) exported at bucket SF_SERVE_BUCKET, its unrolled decode counted (K9
240, K3 240) and its ids equal to the live fused sampler's; each served call
timed with CUDA events beside the live call.

*Parallelism* (:func:`parallel_phase`, the trained flagship at B=60,
dropout 0): the recipe's step through ``make_parallel_train_step`` at one
rank on NCCL in this process, counted (the recipe step's launches) and
equal to the single-process step to the bit; the float32 model's step at
two ranks of 30 rows on the one card (two processes through gloo: NCCL
refuses two ranks on one device) and the tensor-parallel step at 1 x 2
(gloo, float32), each in child processes of this script
(``--parallel-worker``), against the single-process kernel step and the
plain single-process step: loss terms within F32_STEP_LOSS, the gradient
norm within TOL_STEP_NORM, the parameter update's cosine at least
TOL_STEP_COSINE (Adam's first step moves every entry by about lr along its
gradient's sign, so entries whose gradient is rounding noise move either
way; the update's direction is what the step decides). A child that fails
fails the run.

*Head dims 8 and 16* (:func:`head_dims_phase`, random weights from
HD_SEED): the first port's kernels that the Hopper forms' widths leave,
now templated on the head dim, at head dim 8 (D=32, 4 heads, FF 64) and 16
(D=64, 4 heads, FF 128) in both types, each against its plain version with
a control that must fail: K2 at S=1, 17, 32 and its long form at S=40 and
S=241 (causal, seq_bias); K4 at S=8 and its long form at S=40 (causal),
rate 0.1, both modes, its twelve gradients; K7 at two layers, B=60, over
K7_DRAWS draws; K9 at R=1,024 at index 1 and 40; K10 at the JAX tests'
widths (D=64 and 32 with 4 heads, D=32 with 2) at S=8, 16 (causal), 31, 32
and 40; K11 at S=8 and 40, rate 0.1, its five gradients against both
yardsticks. Each counted under its ``narrow`` counters, and timed beside
its bound, its plain version and its library call. The same checks, counted
and untimed, at the other widths the routing rules send to these kernels
(HD_WIDE: D=128 with 4 heads of 32, D=256 with 16 heads of 16; K7 where it
takes them, at D=256). Then the tiny configs'
paths, counted with no plain version called: test_tiny's
``one_shot_sample`` (bfloat16 and float32, N=1024, ids against the plain
path's), its CLI for HD_CLI_STEPS steps, one bucket of it exported and
served (ids equal to the live call's); the JAX tests' SMALL model's step at
B=16, dropout 0.1 (E2 and D2 through K7; K4 in both modes); its one-stage
autoregressive variant's ``greedy_sample`` through K9.

At the end, each form of K5 (bf16 at 257 and 512 classes, float32 at 257
and 512), of K8 and of K2 (short and long, bf16 and float32) is printed
with its multiple of its library call and of its bound.

The second-to-last line is ``{"kernels": [...]}``, the last ``{"ok": true,
"device": {...}}``; the full record goes to ``chiprun_out/chip_smoke.json``.
Any failed check raises, and the script exits non-zero, as it does without a
CUDA card or without the repo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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
N_MAIN = 1024          # bench.py's inference batch
N_AGREE = 64
B_TRAIN = 128          # bench.py's training batch
B_STEP_CHECK = 16      # kernel-path step against plain-path step
TRAIN_STEPS = 23       # 3 warm-up steps, then 20 timed ones
LR = 1e-3
DROPOUT = 0.1
LOSS_WEIGHTS = dict(loss_visibility_weight=1.0, loss_cmd_weight=1.0, loss_args_weight=2.0)
MODEL_ARGS = ["commands", "args", "commands", "args"]
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
# H100 SXM published peaks (dense): tensor-core bf16 and TF32, float32 outside
# the tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
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
# the float32 form multiplies in TF32: weights whose values are bf16 enter
# exactly, each activation operand is rounded to 10 mantissa bits (2^-11
# relative); its plain version multiplies in full float32
TOL_F32_ATOL = 2e-2
TOL_F32_RTOL = 2e-3
TOL_HEAD_MARGIN = 1e-2         # ids may differ only below this top-2 logit gap
# K4's gradients. bfloat16: the kernel rounds df, dhpre, da, dctx, ds and dqkv
# to bf16 before their products as the TPU kernel did, the plain version's
# autograd does not; each rounding is 2^-9 relative (0.0011 RMS), six of them
# chain, and dropout's 1/(1-rate) scale and the LayerNorm and softmax
# cancellations amplify them. float32: TF32 operands (2^-11) at every product
# of forward and backward against full float32. In both, the plain version's
# weight gradients are rounded to bf16 once on their way back through its cast
# of the master weights (0.0016 RMS); the kernel's are not. And in both, the
# two forward passes differ in their last bits, so a few FF pre-activations
# next to zero fall on the other side of the ReLU: such a unit's whole
# gradient term is there in one version and not in the other. That last cause
# is measured, not assumed: every case is compared twice, against the plain
# version as it is and against the plain version made to pass the kernel's
# own FF units (``relu_gate``), and both readings are printed. With the units
# aligned bfloat16 reads up to 0.0096 (dln1 at D2, rate 0.1; 0.0058 elsewhere)
# and float32 0.0023 (the roundings alone); as they are, 0.0096 and, over six
# runs, 0.011 to 0.020 (dw1 and db1 at E2, whose 1,024 rows average the
# flipped units' terms least). Limits, 1.5 to 2 times those readings: the
# relative RMS error of each gradient at most TOL_GRAD_RMS[activation type],
# and at most TOL_GRAD_RMS_SAME_GATE with the ReLU units aligned; at most
# TOL_GRAD_OUTLIERS of the elements (or TOL_GRAD_OUTLIER_COUNT of them, in a
# small tensor) outside the band
# |err| <= TOL_GRAD_ATOL * max|ref| + TOL_GRAD_RTOL * |ref|; and no element
# off by more than TOL_GRAD_WORST * max|ref| (a flipped unit; read up to
# 0.10), nor by more than TOL_GRAD_WORST_SAME_GATE with the units aligned
# (read up to 0.015).
TOL_GRAD_RMS = {torch.bfloat16: 1.5e-2, torch.float32: 4e-2}
TOL_GRAD_RMS_SAME_GATE = {torch.bfloat16: 1.5e-2, torch.float32: 5e-3}
TOL_GRAD_ATOL = 2e-2
TOL_GRAD_RTOL = 2.0 ** -6
TOL_GRAD_OUTLIERS = 1e-3
TOL_GRAD_OUTLIER_COUNT = 8
TOL_GRAD_WORST = 0.2
TOL_GRAD_WORST_SAME_GATE = 0.03
# K5: the loss is a float32 sum of exact bf16 products in another order; dlg is
# rounded to bf16 in both versions, dW and db also once more in the plain
# version's cast (0.0016 RMS)
TOL_CE = 1e-3
TOL_CE_GRAD_RMS = 1e-2
# K6: exact float32 sums of the bf16 dy rows in another (fixed) order
TOL_EMBED_BWD = 1e-5           # of the table gradient's largest entry
# kernel-path step against plain-path step, bf16, dropout 0, B=16: the two
# forward passes differ by summation order amplified through 16 layers, the
# backward passes also by the six roundings above
TOL_STEP_LOSS = 2e-2           # each loss term: relative, plus 1e-4 absolute
TOL_STEP_NORM = 5e-2           # relative, global gradient norm
TOL_STEP_COSINE = 0.999        # whole gradient, kernel path vs plain path
TOL_STEP_LEAF_RMS = 0.16       # each leaf's gradient, relative RMS (sound runs read 0.08)
# K7, four layers at S=8. Its forward is held layer by layer, each layer from
# the kernel's own input to it, to K4's forward limits above. The whole
# stack's output and its twelve gradients go through four layers, where each
# layer's last-bit differences feed the next: the card test
# (tests/test_torch_port_cuda.py) read up to 0.0029 for the output and, for
# the gradients, 0.017 as they are and 0.0065 with the ReLU units aligned;
# limits about twice those readings, as K4's. And against the chain of four
# K4 calls with the per-layer seeds, in both types within these limits and
# TOL_LAYER_RMS a layer: K7's cluster kernels share no block code with K4's
# forms and sum in another order (the float32 stack used to run K4's float32
# block code, and the two were then equal to the bit). The cases added with
# the cluster kernels (float32 on float32 masters, and D=128) hold the
# gradients' fraction of elements outside K4's band with the ReLU units
# aligned: there TF32 products against the plain version's full float32 (or,
# at D=128, another summation order) put a few units near zero on the other
# side over four layers, and each such unit moves a whole row of dW1 (D
# elements) and an element of db1 (one unit is 0.2% of dW1 at D=128, above
# TOL_GRAD_OUTLIERS); the first card run read up to 0.0088 of db1 and 0.0026
# of dW1 as they are, with every RMS within TOL_STACK_* (aligned at most
# 0.0055). Both fractions are recorded.
# Each case is held over K7_DRAWS draws of inputs, each from a generator of
# its own, so that no earlier timing or check changes what a case reads. The
# gradients are held against the plain version made to pass K7's ReLU units
# and to round df, dhpre, da and ds to bfloat16 before their products as
# the kernels (and the TPU kernel) do (``round_grads``; in float32 there is
# nothing to round). As they are, a few units near zero fall on other sides
# in the two forward passes and each moves a whole term: over 72 draws
# (scripts/k7_seed_sweep.py) 8 such readings passed TOL_STACK_GRAD_RMS. With
# the units aligned but the roundings not, D2's rows, which all start from
# the same group queries, add the two versions' rounding differences
# coherently: a bfloat16 D2 draw read dbqkv 0.0310 off, over
# TOL_GRAD_WORST_SAME_GATE, and the K4 chain (K4's kernels, the same
# roundings) read the same distance from the plain version. Both readings,
# as they are and units-only, are still read and recorded. Likewise the
# chain's gradients are held against the plain version with the chain's own
# units and the roundings (TOL_STACK_GRAD_RMS), and K7 against the chain's
# gradients is read. A control, K7 and the chain on masters with layer 1 cut
# to CONTROL_MANTISSA_BITS mantissa bits against the plain version on the
# masters as they are, must fail both gradient gates.
TOL_STACK_RMS = 5e-3
TOL_STACK_GRAD_RMS = 3e-2
TOL_STACK_GRAD_RMS_SAME_GATE = 1.5e-2
K7_DRAWS = 4
K7_SEED = 7000
B_S1, B_S17 = 20000, 2000   # K2's checks at S=1 and S=17: 157 and 286 tiles
B_RECIPE = 60          # configs_tpu/hierarchical_ordered.py at one device
B_GATE_EDGE = 64       # the largest batch the stack gate takes (512 rows)
CLI_ICONS = 480        # the CLI run's synthetic dataset: 8 batches of 60
CLI_STEPS = (24, 56)   # the first run's step budget, then the resumed run's
CLI_LOG_EVERY = 8
CLI_CKPT_EVERY = 16
CLI_WARMUP = 16        # the recipe warms up over 500 steps; the run is 56
# the self-matching model: the KL term's weight at the end of the recipe's
# ramp is 10; the smoke run holds it at 1 with the recipe's tolerance
SM_WEIGHTS = dict(LOSS_WEIGHTS, kl_tolerance=0.1, loss_kl_weight=1.0)
# K8: as K5's forward, a float32 sum of exact bf16 products in another order
TOL_PAIR = TOL_CE
# kernel path vs plain path of the fused matching at B=60: the two paths'
# costs differ by the rounding of 16 layers and K8 (the script prints the
# largest difference over the visible rows). Permutations that differ only
# on invisible target rows tie exactly, so the margin of a sample is the gap
# from its optimum to the best permutation that pairs a visible row
# differently (matching.assignment_margin). Every sample whose plain-path
# margin is at least MATCH_MARGIN must get the same assignment on both paths.
# The control adds noise of MATCH_CONTROL_NOISE x the states' RMS to the
# decoder states that K8 reads on the plain path, and must fail that gate.
MATCH_MARGIN = 5e-2
MATCH_CONTROL_NOISE = 0.1
# the autoregressive phase (Sketchformer, random weights from AR_SEED; no
# trained checkpoint of it exists). K9 and the long form of K2 round to
# bfloat16 at the same points as their plain versions and sum in another
# order: the layer's limits, and for K9, whose four layers feed each other
# their last-bit differences, twice the layer's relative RMS limit.
AR_SEED = 0
N_AR_GATE = 64
AR_INDICES = (1, 120, 240)
TOL_DECODE_RMS = 2 * TOL_LAYER_RMS
# kernel path against plain path at N=64: per sequence, the decoded outputs
# must be equal on every position before the first one where the plain
# path's top-2 logit margin (of the command, or of an argument slot the
# command uses) is below AR_MARGIN; after a position near a tie the paths
# may part, and then every later token differs. The control, the plain path
# with the four decoder layers' weights cut by AR_CONTROL_DROP_BITS mantissa
# bits, must fail this gate (decoder layer 0 cut by CONTROL_DROP_BITS, the
# inference path's control, moved the logits too little to fail it at these
# random weights: readings in PERF.md). The teacher-forced forward over the
# kernel path's decoded tokens (N=1024, S=241) must give the decoded token
# at every position whose margin there is at least TF_MARGIN.
# Besides, where both paths decoded from the same tokens (each sequence up
# to its first differing output), no logit may differ by more than
# AR_LOGIT_LIMIT: the kernel path read 0.0142 there, decoder layer 0 cut by
# CONTROL_DROP_BITS 0.135 and the four layers cut by AR_CONTROL_DROP_BITS
# 0.338 (PERF.md); both controls must fail this limit.
AR_MARGIN = 5e-2
AR_CONTROL_DROP_BITS = 4
AR_LOGIT_LIMIT = 5e-2
TF_MARGIN = 5e-2
# Sketchformer's training phase: the icons recipe's loss weights with the KL
# term at its weight after 1,000 of the ramp's 10,000 steps
SF_WEIGHTS = dict(LOSS_WEIGHTS, kl_tolerance=0.1, loss_kl_weight=1.0)
# the float32 phase. K1's float32 form is an exact float32 sum in the plain
# version's order: at most TOL_EMBED_F32 of the largest entry. K5 and K8 in
# float32 (TF32 products against full float32): relative RMS of the loss and
# of the three gradients, about four times the card test's readings (4.4e-5,
# 2.8e-4; PERF.md). K3's float32 ids are held as its bfloat16 ids are, by the
# plain top-2 margin TOL_HEAD_MARGIN; its control, the plain version on the
# states cut to CONTROL_MANTISSA_BITS mantissa bits, must fail. The float32
# step at B=60, dropout 0, kernel path against plain path: each loss term
# within F32_STEP_LOSS (relative), the median leaf's gradient within
# F32_STEP_MEDIAN_LEAF_RMS relative RMS and the worst leaf's within the
# bfloat16 step's TOL_STEP_LEAF_RMS (a few FF units flip between TF32 and
# float32, as in K4). Readings (PERF.md): 9.9e-5, 0.0031 and 0.078; the
# control, the plain path with E1 layer 0's weights cut as the inference
# control cuts them, read 2.5e-3, 0.055 and 0.19, and must fail the loss or
# the median limit.
TOL_EMBED_F32 = 1e-6
CE_F32_RMS, CE_F32_GRAD_RMS = 2e-4, 1e-3
CONTROL_MANTISSA_BITS = 4
F32_STEP_LOSS = 1e-3
F32_STEP_MEDIAN_LEAF_RMS = 1e-2
# The model variants' phase (random weights from VARIANT_SEED: no trained
# one-stage or fonts checkpoint exists; the fonts model's labels are ids
# below N_LABELS_FONTS, its config's n_labels). The one-stage model's
# inference, kernel path against plain path at N=64, is held as
# Sketchformer's decode is: every id whose plain top-2 margin is at least
# AR_MARGIN equal, and no logit (the decoder states through the packed heads)
# off by more than AR_LOGIT_LIMIT; the control, the plain path with the four
# D1 layers' weights cut by AR_CONTROL_DROP_BITS mantissa bits, must fail the
# logit limit. The fonts model runs 16 layers (the one-stage model 8, as
# Sketchformer's decode): its logits, read, differed by up to 0.0479 where
# the one-stage model's read 0.0312 (PERF.md), so it is held by its ids
# alone, and the same control must fail that gate (it read 0.952). Each step
# at B=60 against its plain path at dropout 0 with the recompute phase's gate
# (RC_STEP_*, TOL_STEP_LEAF_RMS); its control (every E1 and D1 layer cut by
# CONTROL_DROP_BITS) must fail it. K7 with the label's injections is held as
# the recipe's K7 cases are (check_stack_train), the fraction of gradient
# elements outside the band with the ReLU units aligned in both types, as
# for the seeded D=128 layers: on random weights more FF units sit near zero
# than on the trained flagship's, and each unit flipped between the two
# forward passes moves a whole row of dW1 (the first card run read 0.0021-
# 0.0039 of dW1 and 0.0044-0.0137 of db1 outside the band as they are, every
# reading with the units aligned within its limit; both are recorded).
# Temperature sampling at
# SAMPLE_LOW_T: the draws equal the greedy ids wherever (one-shot), or before
# the first position where (autoregressive), the greedy decode's margin is
# below AR_MARGIN; at temperature 1 they are valid and differ from it.
VARIANT_SEED = 19
# The LSTM and decoders' phase (random weights from LSTM_SEED). SketchRNN
# runs float32 only (its LSTM decoder does in the JAX package) and its one
# sampler, autoregressive_sample, re-runs the 241-step LSTM decoder at each
# of its 240 steps: some 58,000 cell steps a call, bound by the host, so it
# runs once at N_RNN_SAMPLE icons. Its paths differ from their plain paths
# in K1, K5 and K6 alone (the LSTM is plain PyTorch in both), and its
# inference in K1 alone, float32 and exact to TOL_EMBED_F32: its logits are
# held to RNN_LOGIT_LIMIT; the controls cut the LSTM cells' kernels to
# CONTROL_MANTISSA_BITS (read on the CPU at N=64: logits 0.0186 apart). K7 with
# causal=True and key padding (a two-stage autoregressive decoder at
# max_seq_len <= 15 reaches it through the stack gate) at S=9 and
# B_K7_CAUSAL sequences, the gate's 512 padded rows. The other gates and
# limits are those of the variants' phase.
LSTM_SEED = 20
RNN_LOGIT_LIMIT = 1e-3
N_RNN_SAMPLE = 8
B_K7_CAUSAL = 32
N_LABELS_FONTS = 100
SAMPLE_LOW_T = 1e-4
# The geometry phase: SVG documents held here (relative commands, H/V,
# quadratic and smooth curves, implicit lineto, several subpaths, arcs and
# each primitive) through the port's svglib into the flagship's 8 x 30
# tensors, tiled to N_MAIN rows; the reconstruction metrics on the card held
# to the CPU's on the first N_GEOM_CPU rows (every document among them: the
# CPU's all-pairs distances at N_MAIN would take the host tens of seconds),
# each summed metric within GEOM_METRIC_RTOL of the larger of its value and
# 1; the native engine against the Python fitting
# within GEOM_NATIVE_ATOL; the EMD descent of examples/02 (the unit circle's
# cubics onto GEOM_TARGET, EMD_STEPS steps at EMD_LR, float32) with its
# first step's loss and gradient held to the CPU's within GEOM_EMD_TOL and
# GEOM_EMD_GRAD_TOL (of the gradient's largest entry).
_SVG_HEAD = '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 24 24">'
GEOMETRY_SVGS = {
    "relative": '<path d="m 3 3 l 9 1 l 2 8 l -10 -1 z"/>',
    "hv": '<path d="M 3 3 H 15 V 12 h -4 v 6 H 3 Z"/>',
    "quadratic": '<path d="M 2 12 Q 8 2 14 12 T 22 12 L 22 20 L 2 20 Z"/>',
    "smooth": '<path d="M 2 4 C 4 10 8 10 10 5 S 16 1 20 7 s 2 6 -4 10 L 2 20 Z"/>',
    "implicit": '<path d="M 4 4 10 6 18 4 16 16 6 18 z"/>',
    "subpaths": '<path d="M 2 2 L 10 2 L 10 10 Z M 12 12 L 21 13 L 20 21 L 12 20 Z"/>',
    "arcs": '<path d="M 4 12 A 8 8 0 0 1 20 12 A 6 4 30 1 0 4 12 Z"/>',
    "rect": '<rect x="3" y="4" width="12" height="8"/><rect x="14" y="14" width="7" height="7"/>',
    "circle": '<circle cx="12" cy="12" r="8"/><circle cx="12" cy="12" r="3"/>',
    "primitives": ('<ellipse cx="8" cy="16" rx="5" ry="3"/><polygon points="14 3 22 5 18 11"/>'
                   '<polyline points="2 2 6 1 9 3"/><line x1="3" y1="21" x2="21" y2="22"/>'),
}
GEOM_TARGET = ('<path d="M 12 2 L 14.5 9 L 22 9 L 16 13.5 L 18 21 L 12 16.5 L 6 21 L 8 13.5 '
               'L 2 9 L 9.5 9 Z"/>')
N_GEOM_CPU = 128
GEOM_METRIC_RTOL = 1e-4
GEOM_NATIVE_ATOL = 1e-9
GEOM_EMD_TOL, GEOM_EMD_GRAD_TOL = 1e-5, 1e-4
EMD_STEPS, EMD_LR = 300, 10.0
# The data and apps phase (:func:`data_apps_phase`): the corpus is
# GEOMETRY_SVGS under these zooms and shifts (24-unit viewbox), with pairs,
# subsets and three documents the filters drop; DATA_AUGS augmentations an
# icon in the tensor pickles, drawn from DATA_SEED; DATA_STEPS steps of
# train() on each layout; the session's keyframes (corpus names),
# N_INTERP in-betweens, the encode's relative RMS against the plain path
# (bfloat16 E1, float32 E2), the animation's N_BETWEEN frames and its
# finetune (two keyframes x FINETUNE_AUGS items, at most FINETUNE_STEPS
# steps at B=60), and the web GUI's frames.
DATA_ZOOMS = (1.0, 0.8, 0.6)
DATA_SHIFTS = ((0.0, 0.0), (1.5, -1.0))
DATA_SEED = 22
DATA_AUGS = 4
DATA_STEPS = 8
DATA_KEYFRAMES = ("smooth_z0_s0", "circle_z1_s1")
N_INTERP = 10
DATA_LATENT_RMS = 5e-2
N_BETWEEN = 4
FINETUNE_AUGS = 240
FINETUNE_STEPS = 8
GUI_FRAMES = 4
# K11's gradients: relative RMS, about four times the card test's largest
# reading (1.0e-3, bfloat16)
MHA_GRAD_RMS = 4e-3
# K4's recompute mode (save_residuals=False). Each kernel against its plain
# version with the saved mode's limits above (its probabilities and hidden
# are float32, as the plain version's are), its output equal to the saved
# mode's to the bit. Each step in that mode against its plain path at
# dropout 0, as the float32 step gate: each loss term within RC_STEP_LOSS
# (relative), the median leaf's gradient within RC_STEP_MEDIAN_LEAF_RMS and
# the worst leaf's within TOL_STEP_LEAF_RMS, by activation type. The
# control is the plain path with every layer that the recompute kernels run
# (E1 and D1; Sketchformer's encoder and decoder) at bfloat16 less
# CONTROL_DROP_BITS bits, and must fail the loss or the median limit. Sound
# readings (PERF.md): losses at most 1.5e-3, medians at most 0.0146
# (bfloat16) and 0.0031 (float32), worst leaves at most 0.079; the
# controls' medians 0.053 (Sketchformer, random weights) to 0.143. (E1
# layer 0 alone cut, the control of the float32 phase, moves Sketchformer's
# median to 0.0089 only, under its sound flagship readings.) And each
# step's peak memory in the recompute mode below the saved mode's by at
# least RC_MEMORY_SHARE of what the saved mode keeps from the forward to the
# backward (reckoned from the layers' shapes).
RC_STEP_LOSS = {torch.bfloat16: 1e-2, torch.float32: F32_STEP_LOSS}
RC_STEP_MEDIAN_LEAF_RMS = {torch.bfloat16: 3e-2, torch.float32: F32_STEP_MEDIAN_LEAF_RMS}
RC_MEMORY_SHARE = 0.5


SERVE_BUCKETS = (1, 64)
SERVE_RAGGED = 37              # rows sent through serve_batch: routed to bucket 64
SF_SERVE_BUCKET = 8
SERVE_ITERS = 5                # timed calls of the unrolled 240-step decode
PARALLEL_SEED = 23
PARALLEL_TIMEOUT = 600         # seconds for the child processes of the parallel phase


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


FAILED: list = []


def check_later(ok: bool, what: str) -> None:
    """A tolerance check that lets the run go on, so that one run shows every
    reading; :func:`main` raises at its end if any failed."""
    if not ok:
        print(f"CHECK FAILED: {what}", flush=True)
        FAILED.append(what)


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


def k6_three_runs(emb_ops, *args) -> tuple:
    """K6 run three times on the same inputs: its four table gradients, and
    whether every run gave them equal to the bit (no atomics)."""
    runs = [emb_ops.embedding_backward(*args) for _ in range(3)]
    same = all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
    return runs[0], same


def dev_text(k: dict) -> str:
    """A kernel entry's device time under the profiler, where it has one."""
    return f", device {k['device_ms']:.4f}" if k.get("device_ms") else ""


def rel_rms(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def head_slots(fcn):
    """(offset, width) of the command slot and each argument slot in the
    packed head."""
    from deepsvg_tpu_torch.ops.head import _round_up
    cw, aw = _round_up(fcn.n_commands), _round_up(fcn.args_dim)
    return [(0, fcn.n_commands)] + [(cw + i * aw, fcn.args_dim) for i in range(fcn.n_args)]


def head_library(head_in, slots):
    """K3's library yardstick, a two-call composition: ``F.linear`` over the
    packed head in the operands' type, then an argmax over each slot's view
    of the logits."""
    x, w, b = head_in[:3]

    def run():
        logits = torch.nn.functional.linear(x, w, b)
        return [logits[:, o:o + n].argmax(dim=-1) for o, n in slots]
    return run


@contextlib.contextmanager
def matmul_tf32(allow: bool):
    """Float32 products of PyTorch's matmul in TF32 (``allow``) or in full
    float32 inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def decoder_states(model, commands, args, label=None, dec=(), **kw):
    """One forward with the argmax head (a VAE's latent from the fixed
    generator): the states the head read ``[R, D]``, the ids ``[R, 1 +
    n_args]`` and the forward's result. ``dec``: an autoregressive
    decoder's targets; ``kw`` goes to the forward (``z=``)."""
    from deepsvg_tpu_torch.models import DropoutRng
    fcn = model.decoder.fcn
    seen = {}
    hook = fcn.register_forward_hook(lambda m, i, o: seen.__setitem__("x", i[0]))
    try:
        res = model(commands, args, *dec, label=label, argmax_head=True,
                    rng=DropoutRng.fixed() if model.cfg.use_vae else None, **kw)
    finally:
        hook.remove()
    ids = torch.cat([res["command_ids"].reshape(-1, 1),
                     res["args_ids"].reshape(-1, fcn.n_args)], dim=1)
    return seen["x"].reshape(-1, seen["x"].shape[-1]), ids, res


def head_ids_and_margins(model, commands, args):
    """One forward with the argmax head: ids ``[R, 1 + n_args]``, and the gap
    between the two best float32 logits of each slot, from the decoder
    output that the head read."""
    x, ids, res = decoder_states(model, commands, args)
    return ids, slot_margins(x, model.decoder.fcn), res


def id_agreement(ids, ids_ref, margins_ref, min_margin: float) -> dict:
    """Share of equal ids, commands and arguments apart, over the slots whose
    reference top-2 margin is at least ``min_margin``."""
    same, keep = ids == ids_ref, margins_ref >= min_margin
    return {"commands": same[:, 0][keep[:, 0]].float().mean().item(),
            "args": same[:, 1:][keep[:, 1:]].float().mean().item()}


@contextlib.contextmanager
def truncated_weights(layer, drop_bits: int):
    """Clear the low ``drop_bits`` mantissa bits that the layer's four weight
    matrices keep in bfloat16 (a control: one layer's products in a lower
    precision). The masters are float32; the cut is made on their bfloat16
    values, which is what the layer reads."""
    mats = [layer.qkv.weight, layer.out_proj.weight, layer.ff1.weight, layer.ff2.weight]
    saved = [w.detach().clone() for w in mats]
    with torch.no_grad():
        for w in mats:
            cut = w.to(torch.bfloat16)
            cut.view(torch.int16).bitwise_and_(~((1 << drop_bits) - 1))
            w.copy_(cut.float())
    try:
        yield
    finally:
        with torch.no_grad():
            for w, orig in zip(mats, saved):
                w.copy_(orig)


@contextlib.contextmanager
def plain_path(emb_ops, layer_ops, head_ops, layer_vjp=None, ce_ops=None, stack_vjp=None,
               decode_ops=None):
    """Route the model through the kernels' plain versions, on the card."""
    saved = [(emb_ops, "fused_embedding", emb_ops.embedding_reference),
             (layer_ops, "fused_layer", layer_ops.layer_reference),
             (head_ops, "fused_head_argmax", head_ops.head_argmax_reference)]
    if decode_ops is not None:
        saved += [(decode_ops, "fused_decode_step", decode_ops.decode_step_reference)]
    if layer_vjp is not None:
        saved += [(emb_ops, "fused_embedding_train", emb_ops.embedding_reference),
                  (layer_vjp, "fused_layer_train", layer_vjp.plain_layer_train),
                  (ce_ops, "args_ce", ce_ops.plain_args_ce),
                  (ce_ops, "args_ce_pairwise", ce_ops.plain_args_ce_pairwise)]
    if stack_vjp is not None:
        saved += [(stack_vjp, "fused_stack_train", stack_vjp.plain_stack_train)]
    saved = [(mod, name, getattr(mod, name), plain) for mod, name, plain in saved]
    for mod, name, _, plain in saved:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, kernel, _ in saved:
            setattr(mod, name, kernel)


def layer_args(layer, x, mask, seq_bias=None, causal=False):
    """The arguments of ``fused_layer`` for ``layer`` on ``x``: the weights
    rounded to the compute type, held in ``x``'s type."""
    return (x, seq_bias, *layer.weights(x.dtype), mask, layer.n_heads, causal)


def layer_ops_count(b, s, d, f):
    """Operations of one layer forward: four products and the attention."""
    return 2.0 * b * s * (3 * d * d + d * d + 2 * d * f) + 4.0 * b * s * s * d


def layer_cost(args):
    x, seq_bias, *weights, mask, n_heads, _ = args
    b, s, d = x.shape
    peak = PEAK_TF32 if x.dtype == torch.float32 else PEAK_BF16
    return bound(2 * nbytes(x) + nbytes(seq_bias, mask, *weights),
                 layer_ops_count(b, s, d, weights[6].shape[0]), peak)


def k4_bound(x, sb, f, backward, causal=False, recompute=False):
    """K4's bound, of the function, not of this implementation: x, the mask,
    the injection and the weights as the kernel reads them in, out (forward)
    or g in and dx, dseq_bias and the float32 weight gradients out
    (backward); the products, and the attention over the keys each query
    sees (half of them when causal). What the forward keeps for the backward
    is a choice of the kernel and is reported apart. ``recompute``: the
    recompute mode's backward, whose function includes the forward up to the
    FF hidden (its products but FF2, and the attention)."""
    b, s, d = x.shape
    rows, es = b * s, x.element_size()
    peak = PEAK_TF32 if x.dtype == torch.float32 else PEAK_BF16
    w_elems = 4 * d * d + 2 * d * f + 9 * d + f
    common = rows * d * es + b * s * 4 + w_elems * es
    sb_elems = 0 if sb is None else b * d
    attn = 4.0 * b * s * (s + 1) / 2 * d if causal else 4.0 * b * s * s * d
    products = layer_ops_count(b, s, d, f) - 4.0 * b * s * s * d
    if not backward:
        return bound(common + rows * d * es + sb_elems * es, products + attn, peak)
    again = products - 2.0 * rows * d * f + attn if recompute else 0.0
    return bound(common + 2 * rows * d * es + w_elems * 4 + sb_elems * 4,
                 2 * products + 2 * attn + again, peak)


def k4_saved_bytes(b, s, d, f, n_heads, es):
    """What K4's saved mode keeps from a layer's forward to its backward, at
    B sequences of S rows with ``es`` bytes an activation: QKV, the
    probabilities [B, H, S, S], the context (16-row padded), the float32
    residual after the attention block and the FF hidden."""
    rows = b * s
    return (rows * (3 * d + f) * es + b * n_heads * s * s * es + -(-rows // 16) * 16 * d * es
            + rows * d * 4)


def k4_workspace_bytes(b, s, d, f, es):
    """The recompute backward's workspace, one layer's: QKV, the context
    (16-row padded), the float32 residual and the float32 FF hidden."""
    rows = b * s
    return rows * 3 * d * es + -(-rows // 16) * 16 * d * es + rows * (d + f) * 4


def compare_grad(name, got, want, same_gate, act_dtype, rms_limits=None,
                 outliers_aligned=False, as_is_gated=True, report=None) -> dict:
    """Hold one gradient to TOL_GRAD_*; return its readings. ``want`` is the
    plain version's gradient, ``same_gate`` the plain version's with the
    kernel's ReLU units; ``act_dtype`` the layer's activation type;
    ``rms_limits`` (as it is, aligned) replaces K4's RMS limits.
    ``outliers_aligned``: the fraction of elements outside the band is held
    on the comparison with the ReLU units aligned (both fractions are
    read). ``as_is_gated`` False: the readings as they are (RMS, worst
    element) are read and not held, only those with the units aligned.
    ``report(ok, what)`` takes the verdict (default check_later)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = max(want.abs().max().item(), 1e-30)
    band = TOL_GRAD_ATOL * scale + TOL_GRAD_RTOL * want.abs()
    outliers_as_is = (diff > band).float().mean().item()
    outliers_gate = ((got - same_gate.float()).abs() > band).float().mean().item()
    outliers = outliers_gate if outliers_aligned else outliers_as_is
    worst = diff.max().item() / scale
    rms, rms_gate = rel_rms(got, want), rel_rms(got, same_gate)
    worst_gate = (got - same_gate.float()).abs().max().item() / scale
    lim, lim_gate = rms_limits or (TOL_GRAD_RMS[act_dtype], TOL_GRAD_RMS_SAME_GATE[act_dtype])
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name}: shape or non-finite values")
    allowed = max(TOL_GRAD_OUTLIERS, TOL_GRAD_OUTLIER_COUNT / want.numel())
    as_is_ok = rms <= lim and worst <= TOL_GRAD_WORST
    (report or check_later)(
                (as_is_ok or not as_is_gated) and rms_gate <= lim_gate and outliers <= allowed
                and worst_gate <= TOL_GRAD_WORST_SAME_GATE,
                f"{name}: relative RMS err {rms} (limit {lim}"
                f"{'' if as_is_gated else ', read, not held'}), {rms_gate} with the ReLU "
                f"units aligned (limit {lim_gate}), {outliers} of the elements outside the "
                f"band (limit {allowed}), the worst off by {worst} of the largest entry "
                f"(limit {TOL_GRAD_WORST}{'' if as_is_gated else ', read, not held'}), "
                f"{worst_gate} with the units aligned (limit {TOL_GRAD_WORST_SAME_GATE})")
    return {"rms": rms, "rms_same_gate": rms_gate, "outliers": outliers_as_is,
            "outliers_same_gate": outliers_gate, "worst": worst,
            "worst_same_gate": worst_gate, "max_abs_err": diff.max().item()}


GRAD_NAMES = ("x", "seq_bias", "ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "w1", "b1", "w2", "b2")


def check_layer_train(layer_vjp, what, layer, x, seq_bias, mask, causal, rate, seed=1234,
                      save_residuals=True, narrow=False, outliers_aligned=False):
    """K4 forward and its twelve gradients against autograd through the plain
    version with the same hash masks, as it is and with the kernel's ReLU
    units, in the mode ``save_residuals``. The recompute mode's output must
    equal the saved mode's to the bit (the kernel's ReLU units are read from
    that saved-mode forward), only its own counters may move, and its
    gradients must be the same on a second run. ``narrow``: the layer runs
    the first port's kernels, whose forward of either mode counts under
    ``narrow_launches``. ``outliers_aligned``: the gradients' fraction of
    elements outside the band is held with the ReLU units aligned (both
    fractions are read; see compare_grad). Returns the readings."""
    masters = layer.masters()
    x = x.detach().requires_grad_()
    bias = None if seq_bias is None else seq_bias.detach().requires_grad_()
    g = torch.randn(x.shape, device=x.device).to(x.dtype)
    leaves = [t for t in (x, bias, *masters) if t is not None]
    names = [n for n, t in zip(GRAD_NAMES, (x, bias, *masters)) if t is not None]
    call = (x, bias, *masters, mask, seed, layer.n_heads, causal, rate, layer.compute_dtype)
    forms = (layer_vjp.fused_layer_train, layer_vjp.fused_layer_train_long)
    counters = ("launches", "backward_launches",
                "narrow_launches" if narrow else "recompute_launches",
                "recompute_backward_launches")
    counts = lambda: [getattr(fn, c) for fn in forms for c in counters]  # noqa: E731
    before = counts()
    out = layer_vjp.fused_layer_train(*call, save_residuals=save_residuals)
    gate = layer_vjp.kernel_relu_gate(out) if save_residuals else None
    grads = torch.autograd.grad(out, leaves, g)
    extra = {}
    if not save_residuals:
        moved = [a - b for a, b in zip(counts(), before)]
        check(sorted(moved) == [0] * 6 + [1, 1] and moved[2] == moved[3]
              and moved[6] == moved[7], f"K4 {what}: the counters moved by {moved}")
        saved_out = layer_vjp.fused_layer_train(*call, save_residuals=True)
        extra["out_equals_saved_mode"] = torch.equal(out, saved_out)
        check_later(extra["out_equals_saved_mode"],
                    f"K4 {what}: the recompute mode's output differs from the saved mode's")
        gate = layer_vjp.kernel_relu_gate(saved_out)
        del saved_out
        again = torch.autograd.grad(layer_vjp.fused_layer_train(*call), leaves, g)
        extra["grads_equal_on_rerun"] = all(torch.equal(a, b) for a, b in zip(grads, again))
        check_later(extra["grads_equal_on_rerun"],
                    f"K4 {what}: the recompute mode's gradients differ from run to run")
        del again
    ref = layer_vjp.plain_layer_train(*call)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    gate_grads = torch.autograd.grad(layer_vjp.plain_layer_train(*call, relu_gate=gate),
                                     leaves, g)
    diff = (out.float() - ref.float()).abs()
    f32 = x.dtype == torch.float32
    atol, rtol = (TOL_F32_ATOL, TOL_F32_RTOL) if f32 else (TOL_LAYER_ATOL, TOL_LAYER_RTOL)
    excess = (diff - rtol * ref.float().abs()).max().item()
    rms = rel_rms(out, ref)
    check(bool(torch.isfinite(out).all()), f"K4 {what}: non-finite output")
    check_later(excess <= atol and rms <= TOL_LAYER_RMS,
          f"K4 {what} forward: an element is off by {excess} beyond {rtol} x |out| "
          f"(limit {atol}), relative RMS err {rms}")
    readings = {n: compare_grad(f"K4 {what} d{n}", a, w, wg, x.dtype,
                                outliers_aligned=outliers_aligned)
                for n, a, w, wg in zip(names, grads, ref_grads, gate_grads)}
    worst = max(readings, key=lambda n: readings[n]["rms"])
    worst_gate = max(readings, key=lambda n: readings[n]["rms_same_gate"])
    print(f"K4 {what} rate {rate}: forward max abs err {diff.max().item():.3g}, relative RMS "
          f"{rms:.3g}; gradients' relative RMS err at most {readings[worst]['rms']:.3g} "
          f"(d{worst}; limit {TOL_GRAD_RMS[x.dtype]}), with the ReLU units aligned "
          f"{readings[worst_gate]['rms_same_gate']:.3g} (d{worst_gate}; limit "
          f"{TOL_GRAD_RMS_SAME_GATE[x.dtype]}); at most "
          f"{max(r['outliers'] for r in readings.values()):.3g} of a gradient's elements "
          f"outside the band (limit {TOL_GRAD_OUTLIERS}, or {TOL_GRAD_OUTLIER_COUNT} elements), "
          f"the worst element off by "
          f"{max(r['worst'] for r in readings.values()):.3g} of the largest entry "
          f"(limit {TOL_GRAD_WORST}), with the ReLU units aligned "
          f"{max(r['worst_same_gate'] for r in readings.values()):.3g} (limit "
          f"{TOL_GRAD_WORST_SAME_GATE})", flush=True)
    return {"forward_max_abs_err": diff.max().item(), "forward_rms": rms, "grads": readings,
            **extra}


def k4_f32_excess(layer_vjp, layer, x, seq_bias, mask, seed=1234) -> dict:
    """A reading, no gate: K4's float32 forward on the E2 input against two
    plain versions, one multiplying in full float32 (the comparison of
    check_layer_train) and one in TF32, as the kernel does; each element's
    excess beyond TOL_F32_RTOL x |out|, and the TF32 plain version's own
    excess over the float32 one. Equal excesses say the kernel's is
    TF32's rounding."""
    call = (x, seq_bias, *layer.masters(), mask, seed, layer.n_heads, False)
    out = {}
    for rate in (0.0, DROPOUT):
        with torch.no_grad():
            got = layer_vjp.fused_layer_train(*call, rate, layer.compute_dtype,
                                              save_residuals=True).float()
            allow = torch.backends.cuda.matmul.allow_tf32
            try:
                torch.backends.cuda.matmul.allow_tf32 = False
                ref = layer_vjp.plain_layer_train(*call, rate, layer.compute_dtype).float()
                torch.backends.cuda.matmul.allow_tf32 = True
                ref_tf32 = layer_vjp.plain_layer_train(*call, rate, layer.compute_dtype).float()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = allow
        excess = lambda a, b: ((a - b).abs() - TOL_F32_RTOL * b.abs()).max().item()  # noqa: E731
        out[f"rate {rate}"] = r = {
            "kernel_vs_f32": excess(got, ref), "kernel_vs_tf32": excess(got, ref_tf32),
            "tf32_vs_f32": excess(ref_tf32, ref), "max_abs_out": ref.abs().max().item()}
        print(f"K4 float32 E2 rate {rate}: excess beyond {TOL_F32_RTOL} x |out| against the "
              f"float32 plain version {r['kernel_vs_f32']:.4g}, against the TF32 plain version "
              f"{r['kernel_vs_tf32']:.4g}; the TF32 plain version against the float32 one "
              f"{r['tf32_vs_f32']:.4g} (limit {TOL_F32_ATOL}; |out| up to "
              f"{r['max_abs_out']:.3g})", flush=True)
    return out


def stacked_masters(layers):
    """The ten float32 masters of ``layers`` stacked ``[L, ...]``, leaves."""
    return [torch.stack(ws).detach().requires_grad_()
            for ws in zip(*(layer.masters() for layer in layers))]


def k4_chain(layer_vjp, x, bias, *rest, with_gates: bool = False):
    """What K7 computes, as L successive K4 calls with the per-layer seeds;
    ``with_gates``: also the ReLU units of each of its layers ``[L, B, S, F]``
    (the chain's own units, which the plain version can be made to pass)."""
    from deepsvg_tpu_torch.ops.dropout import stack_layer_seed
    masters, (mask, seed, n_heads, causal, rate, dt) = rest[:10], rest[10:]
    gates = []
    for layer in range(masters[0].shape[0]):
        x = layer_vjp.fused_layer_train(x, bias[layer], *[w[layer] for w in masters], mask,
                                        stack_layer_seed(seed, layer), n_heads, causal, rate, dt,
                                        save_residuals=True)
        if with_gates:
            gates.append(layer_vjp.kernel_relu_gate(x))
    return (x, torch.stack(gates)) if with_gates else x


def check_stack_train(stack_vjp, layer_vjp, what, layers, draw, rate, seed=4321,
                      outliers_aligned=False, control_bits=None, causal=False):
    """K7 against its plain version with the same hash masks, over K7_DRAWS
    draws of inputs: ``draw(gen)`` gives the input, the injections and the
    mask from ``gen``, a generator of the draw's own (seeded K7_SEED + the
    draw), which also draws the output gradient; the dropout seed is
    ``seed`` + the draw. Each draw: the forward layer by layer from the
    kernel's own inputs, then the whole stack; its twelve gradients as they
    are and with the kernel's ReLU units (read), and held against the plain
    version with the kernel's units that also rounds the gradients where
    the kernels round them (``round_grads``); the chain of K4 calls within
    the limits above (the forward against K7, the gradients against the
    plain version with the chain's own units and the roundings; against K7
    read); the gradients on a second run equal to the bit. ``outliers_aligned``: the
    gradients' fraction of elements outside the band is held with the units
    aligned (see TOL_STACK_*). ``control_bits``: a control, one draw, where
    K7 and the chain run on the masters with layer 1's cut to that many
    mantissa bits and the plain versions on the masters as they are; the
    verdicts are returned (``failed``) instead of reported. ``causal``: the
    stack's attention is causal (each layer's too). Returns the readings:
    each draw's, and the worst over the draws."""
    from deepsvg_tpu_torch.ops.dropout import stack_layer_seed
    dt, n_heads = layers[0].compute_dtype, layers[0].n_heads
    masters = stacked_masters(layers)
    kernel_masters = masters
    if control_bits is not None:
        kernel_masters = []
        for w in masters:
            w = w.detach().clone()
            w[1] = cut_mantissa(w[1], control_bits)
            kernel_masters.append(w.requires_grad_())
    failed = []
    report = check_later if control_bits is None else (
        lambda ok, msg: None if ok else failed.append(msg))
    dev = masters[0].device
    draws = []
    for k in range(1 if control_bits is not None else K7_DRAWS):
        gen = torch.Generator(device=dev).manual_seed(K7_SEED + k)
        x_in, biases, mask = draw(gen)
        x = x_in.detach().to(dt).requires_grad_()
        bias = biases[:len(layers)].detach().to(dt).requires_grad_()
        g = torch.randn(x.shape, device=dev, generator=gen).to(dt)
        leaves, k_leaves = [x, bias, *masters], [x, bias, *kernel_masters]
        tail = (mask, seed + k, n_heads, causal, rate, dt)
        call, k_call = (x, bias, *masters, *tail), (x, bias, *kernel_masters, *tail)
        out = stack_vjp.fused_stack_train(*k_call)
        gates = stack_vjp.kernel_relu_gates(out)
        inputs = stack_vjp.kernel_layer_inputs(out)
        grads = torch.autograd.grad(out, k_leaves, g)
        check(bool(torch.isfinite(out).all()), f"K7 {what}: non-finite output")
        name = f"K7 {what} draw {k}"
        layer_rms, layer_excess = [], []
        with torch.no_grad():
            for layer, (x_l, y_l) in enumerate(zip(inputs, inputs[1:] + [out])):
                ref_l = layer_vjp.plain_layer_train(
                    x_l, bias[layer], *[w[layer] for w in masters], mask,
                    stack_layer_seed(seed + k, layer), n_heads, causal, rate, dt).float()
                layer_rms.append(rel_rms(y_l, ref_l))
                layer_excess.append(((y_l.float() - ref_l).abs() - TOL_LAYER_RTOL * ref_l.abs())
                                    .max().item())
        report(max(layer_excess) <= TOL_LAYER_ATOL and max(layer_rms) <= TOL_LAYER_RMS,
               f"{name} forward, layer by layer from the kernel's inputs: an element is off by "
               f"{max(layer_excess)} beyond {TOL_LAYER_RTOL} x |out| (limit {TOL_LAYER_ATOL}), "
               f"relative RMS err {max(layer_rms)} (limit {TOL_LAYER_RMS})")
        ref = stack_vjp.plain_stack_train(*call)
        ref_grads = torch.autograd.grad(ref, leaves, g)
        units_grads = torch.autograd.grad(stack_vjp.plain_stack_train(*call, relu_gates=gates),
                                          leaves, g)
        gate_grads = torch.autograd.grad(
            stack_vjp.plain_stack_train(*call, relu_gates=gates, round_grads=True), leaves, g)
        diff = (out.float() - ref.float()).abs()
        rms = rel_rms(out, ref)
        report(rms <= TOL_STACK_RMS,
               f"{name} whole-stack forward: relative RMS err {rms} (limit {TOL_STACK_RMS})")
        readings = {n: compare_grad(f"{name} d{n}", a, w, wg, dt,
                                    (TOL_STACK_GRAD_RMS, TOL_STACK_GRAD_RMS_SAME_GATE),
                                    outliers_aligned, as_is_gated=False, report=report)
                    for n, a, w, wg in zip(GRAD_NAMES, grads, ref_grads, gate_grads)}
        for n, a, w, wu in zip(GRAD_NAMES, grads, ref_grads, units_grads):
            # read: the units aligned, the roundings not
            readings[n]["rms_units_only"] = rel_rms(a, wu)
            readings[n]["worst_units_only"] = ((a.float() - wu.float()).abs().max()
                                               / w.float().abs().max().clamp_min(1e-30)).item()
        # K4 computes the same function in another summation order (K7's
        # cluster kernels share no block code with K4's forms): K7 against the
        # chain within the limits each meets against the plain version (a
        # layer from K7's own input to it, the stack); the chain's gradients
        # against the plain version with the chain's own ReLU units, as K7's
        # are held with K7's (where the two forward passes put a unit near
        # zero on other sides, K7's gradients and the chain's part by that
        # unit's whole term); K7 against the chain's gradients is read
        chain, chain_gates = k4_chain(layer_vjp, *k_call, with_gates=True)
        chain_grads = torch.autograd.grad(chain, k_leaves, g)
        chain_ref = torch.autograd.grad(
            stack_vjp.plain_stack_train(*call, relu_gates=chain_gates, round_grads=True),
            leaves, g)
        with torch.no_grad():
            chain_layer_rms = [rel_rms(y_l, layer_vjp.fused_layer_train(
                x_l, bias[layer], *[w[layer] for w in kernel_masters], mask,
                stack_layer_seed(seed + k, layer), n_heads, causal, rate, dt,
                save_residuals=True))
                for layer, (x_l, y_l) in enumerate(zip(inputs, inputs[1:] + [out]))]
        chain_rms = rel_rms(out, chain)
        chain_grad_rms = {n: rel_rms(a, c) for n, a, c in zip(GRAD_NAMES, grads, chain_grads)}
        chain_own = {n: rel_rms(c, r) for n, c, r in zip(GRAD_NAMES, chain_grads, chain_ref)}
        worst_chain = max(chain_grad_rms, key=chain_grad_rms.get)
        worst_own = max(chain_own, key=chain_own.get)
        units_flipped = int((chain_gates != gates).sum())
        report(max(chain_layer_rms) <= TOL_LAYER_RMS and chain_rms <= TOL_STACK_RMS,
               f"{name} against the chain of {len(layers)} K4 calls: a layer's relative RMS "
               f"{max(chain_layer_rms)} (limit {TOL_LAYER_RMS}), the stack's {chain_rms} "
               f"(limit {TOL_STACK_RMS})")
        report(chain_own[worst_own] <= TOL_STACK_GRAD_RMS,
               f"{name}: the chain of {len(layers)} K4 calls against the plain version with "
               f"the chain's ReLU units: d{worst_own}'s relative RMS {chain_own[worst_own]} "
               f"(limit {TOL_STACK_GRAD_RMS}); against K7 d{worst_chain}'s "
               f"{chain_grad_rms[worst_chain]}, read ({units_flipped} units flipped)")
        # the gradients again: equal to the bit (no atomics)
        again = torch.autograd.grad(stack_vjp.fused_stack_train(*k_call), k_leaves, g)
        rerun_equal = all(torch.equal(a, c) for a, c in zip(grads, again))
        report(rerun_equal, f"{name}: the gradients of a second run are not equal to the bit")
        draws.append({
            "layer_rms": layer_rms, "layer_excess": layer_excess, "forward_rms": rms,
            "forward_max_abs_err": diff.max().item(), "grads": readings,
            "k4_chain_layer_rms": chain_layer_rms, "k4_chain_rms": chain_rms,
            "k4_chain_grad_rms": chain_grad_rms, "k4_chain_own_units_grad_rms": chain_own,
            "k4_chain_units_flipped": units_flipped, "rerun_equal": rerun_equal})
        del out, grads, ref, ref_grads, units_grads, gate_grads, chain, chain_grads, chain_ref
        del again
    top = lambda key: max(r["grads"][n][key] for r in draws for n in GRAD_NAMES)  # noqa: E731
    worst = {key: top(key) for key in ("rms", "rms_same_gate", "worst", "worst_same_gate",
                                       "outliers", "outliers_same_gate", "max_abs_err",
                                       "rms_units_only", "worst_units_only")}
    worst["chain_vs_k7"] = max(max(r["k4_chain_grad_rms"].values()) for r in draws)
    worst["chain_own_units"] = max(max(r["k4_chain_own_units_grad_rms"].values()) for r in draws)
    label = f"K7 {what} rate {rate}" + (
        f", control (layer 1 cut to {control_bits} mantissa bits)" if control_bits is not None
        else "")
    print(f"{label}, {len(draws)} draws: forward layer by layer relative RMS at most "
          f"{max(max(r['layer_rms']) for r in draws):.3g} (limit {TOL_LAYER_RMS}); whole stack "
          f"{max(r['forward_rms'] for r in draws):.3g} (limit {TOL_STACK_RMS}); gradients with "
          f"the ReLU units aligned: relative RMS at most {worst['rms_same_gate']:.3g} (limit "
          f"{TOL_STACK_GRAD_RMS_SAME_GATE}), worst element {worst['worst_same_gate']:.3g} of the "
          f"largest entry (limit {TOL_GRAD_WORST_SAME_GATE}); units aligned, roundings not "
          f"(read) RMS {worst['rms_units_only']:.3g}, worst {worst['worst_units_only']:.3g}; "
          f"as they are (read) RMS "
          f"{worst['rms']:.3g}, worst {worst['worst']:.3g}; the K4 chain with its own units "
          f"{worst['chain_own_units']:.3g} (limit {TOL_STACK_GRAD_RMS}), against K7 (read) "
          f"{worst['chain_vs_k7']:.3g}; reruns equal to the bit: "
          f"{all(r['rerun_equal'] for r in draws)}"
          + (f"; checks failed: {len(failed)}" if control_bits is not None else ""), flush=True)
    return {"draws": draws, "worst": worst, "failed": failed,
            "forward_max_abs_err": max(r["forward_max_abs_err"] for r in draws),
            "grads": {n: {key: max(r["grads"][n][key] for r in draws)
                          for key in draws[0]["grads"][n]} for n in GRAD_NAMES}}


def run_cli(dev, reset_counts, read_counts, per_step: dict,
            config_name: str = "hierarchical_ordered", timing: bool = True) -> dict:
    """The training CLI's ``train()`` on ``configs/<config_name>.py`` at one
    card (B=60, bfloat16, dropout 0.1), the synthetic dataset resident on the
    card: a first run of CLI_STEPS[0] steps with an asynchronous checkpoint,
    then a resumed run to CLI_STEPS[1]. Checks the step counts, the loss, the
    checkpoint's and the resumed parameters (to the bit) and the launches
    (``per_step`` x steps, counted over the first run). Its console output
    goes to ``cli_train_<config_name>.log`` in OUT_DIR. With ``timing``, also
    times the loop's steps alone. Returns the readings."""
    import tempfile

    from deepsvg_tpu_torch.training import train as train_mod
    from deepsvg_tpu_torch.training.config import load_config
    from deepsvg_tpu_torch.training.trainer import create_train_state

    def config():
        cfg = load_config(f"deepsvg_tpu_torch.configs.{config_name}", 1)
        cfg.dataloader_module = "deepsvg_tpu_torch.data.synthetic"
        cfg.synthetic_size = CLI_ICONS
        cfg.log_every, cfg.ckpt_every, cfg.warmup_steps = CLI_LOG_EVERY, CLI_CKPT_EVERY, CLI_WARMUP
        return cfg

    # the parameters at the moment a background save begins, and those a
    # resumed run starts from
    snapshots, resumed = {}, {}
    begin_save, load_ckpt = train_mod.begin_save, train_mod.load_ckpt

    def spy_begin_save(checkpoint_dir, state, *args, step=None, **kwargs):
        snapshots[step] = [p.detach().clone() for p in state.parameters()]
        return begin_save(checkpoint_dir, state, *args, step=step, **kwargs)

    def spy_load_ckpt(*args, **kwargs):
        state, found = load_ckpt(*args, **kwargs)
        resumed.update(step=state.step, found=found,
                       params=[p.detach().clone() for p in state.parameters()])
        return state, found

    out = {}
    with open(os.path.join(OUT_DIR, f"cli_train_{config_name}.log"), "w") as log, \
            tempfile.TemporaryDirectory() as log_dir:
        ckpt_dir = os.path.join(log_dir, "models", config_name, "smoke")
        train_mod.begin_save, train_mod.load_ckpt = spy_begin_save, spy_load_ckpt
        try:
            with contextlib.redirect_stdout(log):
                reset_counts()
                t0 = time.perf_counter()
                state1, stats1 = train_mod.train(config(), config_name, "smoke",
                                                 log_dir=log_dir, max_steps=CLI_STEPS[0],
                                                 device=dev)
                torch.cuda.synchronize()
                out["first_run_s"] = time.perf_counter() - t0
                counts = read_counts()
                final1 = [p.detach().clone() for p in state1.parameters()]
                files = sorted(os.listdir(ckpt_dir))
                # the background checkpoint, read back into a fresh state
                cfg = config()
                fresh = create_train_state(cfg.make_model().to(dev), cfg.make_optimizer(8))
                fresh, found = load_ckpt(os.path.join(ckpt_dir, f"{CLI_CKPT_EVERY:06d}.ckpt"),
                                         fresh)
                t0 = time.perf_counter()
                state2, stats2 = train_mod.train(config(), config_name, "smoke",
                                                 log_dir=log_dir, resume=True,
                                                 max_steps=CLI_STEPS[1], device=dev)
                torch.cuda.synchronize()
                out["resumed_run_s"] = time.perf_counter() - t0
        finally:
            train_mod.begin_save, train_mod.load_ckpt = begin_save, load_ckpt
    n1 = CLI_STEPS[0]
    expected = {k: v * n1 for k, v in per_step.items()}
    check(counts == expected, f"CLI run ({config_name}): launches over {n1} steps {counts}, "
                              f"expected {expected}")
    check(state1.step == n1 and state2.step == CLI_STEPS[1],
          f"CLI steps {state1.step}, {state2.step}; expected {CLI_STEPS}")
    check(files == [f"{CLI_CKPT_EVERY:06d}.ckpt", f"{n1:06d}.ckpt", "best.ckpt"],
          f"CLI checkpoints {files}")
    snap = snapshots.get(CLI_CKPT_EVERY)
    check(found and snap is not None
          and all(torch.equal(a, b) for a, b in zip(snap, fresh.parameters()))
          and fresh.step == CLI_CKPT_EVERY,
          "the background checkpoint does not hold the parameters of its step")
    check(any(not torch.equal(a, b) for a, b in zip(snap, final1)),
          "the parameters did not move after the background checkpoint")
    check(resumed.get("found") and resumed["step"] == n1
          and all(torch.equal(a, b) for a, b in zip(resumed["params"], final1)),
          f"the resumed run did not start from the saved step {n1} and its parameters")
    losses = list(stats1.stats["train"]["loss"].deque) + list(stats2.stats["train"]["loss"].deque)
    windows = CLI_STEPS[1] // CLI_LOG_EVERY
    check(len(losses) == windows and all(np.isfinite(v) for v in losses),
          f"CLI logged losses {losses}, expected {windows} finite windows")
    check(losses[-1] < losses[0], f"the CLI run's loss did not fall: {losses}")
    out.update(steps=list(CLI_STEPS), launches_first_run=counts, checkpoints=files,
               losses=losses)
    summary = (f"CLI train() {config_name} B={B_RECIPE}, {CLI_ICONS} synthetic icons resident "
               f"on the card: {CLI_STEPS[0]} steps, background checkpoint at {CLI_CKPT_EVERY} "
               f"(its parameters equal those of its step, bit for bit), resumed from "
               f"{resumed['step']} (parameters equal, bit for bit) to {CLI_STEPS[1]}; logged loss "
               f"{losses[0]:.4f} -> {losses[-1]:.4f} over {windows} windows; launches over the "
               f"first run {counts}")
    if not timing:
        print(summary, flush=True)
        return out
    # wall time per step over the resumed run's windows after its first
    # (which holds the set-up): the loop's host clock between log windows.
    # The loop does not synchronise; once the launch queue is full the host
    # keeps the device's pace, or the device waits for the host.
    wall = [1e3 * t for t in list(stats2.stats["train"]["time"].deque)[1:]]
    # the loop's own steps without train()'s threads and cadences:
    # train_resident_multi_step over the same corpus, host clock around
    # 3 x 8 steps that end in a synchronize
    from deepsvg_tpu_torch.data.resident import build_resident_arrays
    from deepsvg_tpu_torch.training.trainer import train_resident_multi_step
    cfg = config()
    data, _, n_augs = build_resident_arrays(train_mod.load_dataset(cfg), cfg.model_args)
    shapes = {k: v.shape[1:] for k, v in data.items()}
    data = {k: torch.from_numpy(np.ascontiguousarray(v.reshape(len(v), -1))).to(dev)
            for k, v in data.items()}
    idx = torch.arange(8 * B_RECIPE, device=dev, dtype=torch.int32).reshape(8, B_RECIPE)
    optimizer = cfg.make_optimizer(8)

    def weights_fn(step):
        return cfg.get_weights(step, 0)
    train_resident_multi_step(state2, data, idx, weights_fn, optimizer, cfg.model_args,
                              n_augs, shapes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        train_resident_multi_step(state2, data, idx, weights_fn, optimizer, cfg.model_args,
                                  n_augs, shapes)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / 24
    out.update(wall_ms_per_step=wall, wall_ms_per_step_mean=statistics.mean(wall),
               resident_multi_step_ms_per_step=loop_ms)
    print(f"{summary}; wall {out['wall_ms_per_step_mean']:.3f} ms/step over the resumed run's windows "
          f"{[round(w, 3) for w in wall]} (checkpoints begin at {CLI_STEPS[0] + 8} and "
          f"{CLI_STEPS[0] + 24}); train_resident_multi_step alone {loop_ms:.3f} ms/step",
          flush=True)
    return out


# K5's kernels by name in a profile: its forward and its two backward kernels
K5_KERNELS = ("ce_fwd_kernel", "ce_bwd_dy_kernel", "ce_bwd_dw_kernel")


def device_busy_ms(fn, iters: int = 5) -> float | None:
    """Device time per call of ``fn`` under ``torch.profiler`` (the sum of
    its kernels' times), or None when the profiler records none."""
    return device_split(fn, iters)[0]


def check_sample(out_c, out_a, n: int, cfg, groups: int | None = None,
                 s_dec: int | None = None) -> float:
    """Validate ``one_shot_sample``'s output for ``n`` inputs (``groups`` x
    ``s_dec`` positions each, by default the two-stage decoder's): shapes,
    ids and values in range, PAD where a command takes no argument. Returns
    the share of valid argument slots (not PAD)."""
    from deepsvg_tpu_torch.svgtensor.constants import CMD_ARGS_MASK
    groups = groups or cfg.max_num_groups
    s_dec = s_dec or cfg.max_seq_len + 1
    check(tuple(out_c.shape) == (n, groups, s_dec)
          and tuple(out_a.shape) == (n, groups, s_dec, cfg.n_args),
          f"output shapes {tuple(out_c.shape)}, {tuple(out_a.shape)}")
    check(bool(torch.isfinite(out_a).all()), "non-finite arguments")
    check(int(out_c.min()) >= 0 and int(out_c.max()) < cfg.n_commands, "command ids out of range")
    check(float(out_a.min()) >= -1 and float(out_a.max()) <= cfg.args_dim - 1,
          "argument values out of range")
    unused = torch.as_tensor(CMD_ARGS_MASK, device=out_c.device)[out_c.long()] == 0
    check(bool((out_a[unused] == -1).all()), "unused arguments are not PAD")
    return (out_a != -1).float().mean().item()


def self_match_model(cfg, dev, seed: int = 5):
    """The self-matching model with the trained flagship's weights wherever
    the two trees share a leaf (all but the bottleneck and E2's position
    table): the VAE's mean head takes the bottleneck's weights, its
    log-variance head the initialisation (normal, std 0.001; zero bias) from
    a numpy seed. Randomly initialised heads give nearly uniform logits, and
    then the matching is all near-ties; this is a fixture of the smoke run."""
    from deepsvg_tpu_torch.models import SVGTransformer, load_flax_params, load_params
    tree = load_params(CHECKPOINT)
    neck = tree["bottleneck"]["bottleneck"]
    rng = np.random.default_rng(seed)
    sigma = {"kernel": (0.001 * rng.normal(size=np.shape(neck["kernel"]))).astype(np.float32),
             "bias": np.zeros(np.shape(neck["bias"]), np.float32)}
    encoder = {k: v for k, v in tree["encoder"].items() if k != "hierarchical_PE"}
    tree = {k: v for k, v in tree.items() if k not in ("bottleneck", "encoder")}
    tree.update(encoder=encoder, vae={"enc_mu_fcn": neck, "enc_sigma_fcn": sigma})
    model = SVGTransformer(cfg)
    load_flax_params(model, tree)
    return model.to(dev)


def matched_forward(model, commands, args, perturb_states: float = 0.0) -> dict:
    """One training forward of the self-matching model (no gradient, the
    VAE's noise from the fixed generator) through its fused matching: the
    cost and visibility the assignment is solved from, the assignment, and
    the inputs of K8 (``args_ce_pairwise`` as the module has it: the kernel,
    or the plain version under :func:`plain_path`). ``perturb_states``: noise
    of that share of the states' RMS added to what K8 reads (a control). The
    spies stand in ``matching``'s namespace; the kernel's wrapper and its
    launch count stay as they are."""
    import types

    from deepsvg_tpu_torch.models import DropoutRng, matching
    seen = {}
    solve, ce_ops = matching.solve_assignment, matching.ce_ops
    pairwise = ce_ops.args_ce_pairwise

    def spy_solve(cost, vis):
        out = solve(cost, vis)
        seen.update(cost=cost, vis=vis, assignment=out)
        return out

    def spy_pairwise(y, *rest):
        if perturb_states:
            gen = torch.Generator(device=y.device).manual_seed(11)
            yf = y.float()
            noise = torch.randn(y.shape, device=y.device, generator=gen)
            y = (yf + perturb_states * yf.pow(2).mean().sqrt() * noise).to(y.dtype)
        seen["k8_inputs"] = (y, *rest)
        return pairwise(y, *rest)
    matching.solve_assignment = spy_solve
    matching.ce_ops = types.SimpleNamespace(args_ce_pairwise=spy_pairwise)
    try:
        with torch.no_grad():
            seen["res"] = model(commands, args, commands, args, return_tgt=True,
                                deterministic=False, fused_ce=True, rng=DropoutRng.fixed())
    finally:
        matching.solve_assignment, matching.ce_ops = solve, ce_ops
    return seen


def sketchformer_model(dev, seed: int = AR_SEED, dropout: float | None = None,
                       compute_dtype: str | None = None):
    """The port's Sketchformer (``configs/sketchformer.py``: the config under
    ``gpu_fast``, at ``dropout`` and ``compute_dtype`` if given) at full
    width, initialised by the port's ``init_parameters`` from a seeded
    generator: no trained Sketchformer checkpoint exists, so its decoded
    icons mean nothing and the checks work step by step and by margin."""
    from deepsvg_tpu_torch.configs.sketchformer import make_model_config
    from deepsvg_tpu_torch.models import SVGTransformer
    from deepsvg_tpu_torch.training.trainer import init_parameters
    cfg = make_model_config()
    if dropout is not None:
        cfg = dataclasses.replace(cfg, dropout=dropout)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = SVGTransformer(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def slot_margins(y, fcn, chunk: int = 32768):
    """The gap between the two best float32 logits of each slot
    ``[R, 1 + n_args]`` for decoder states ``y [R, D]``."""
    w, b = fcn.w_packed.float(), fcn.b_packed.float()
    out = []
    for yc in y.reshape(-1, y.shape[-1]).split(chunk):
        logits = yc.float() @ w.t() + b
        top2 = [logits[:, o:o + n].topk(2, dim=-1).values for o, n in head_slots(fcn)]
        out.append(torch.stack([t[:, 0] - t[:, 1] for t in top2], dim=1))
    return torch.cat(out).reshape(y.shape[:-1] + (-1,))


def position_margin(margins, commands):
    """Per position, the least margin of the command and of the argument
    slots that the decoded ``commands`` use."""
    from deepsvg_tpu_torch.svgtensor.masks import cmd_args_mask
    used = cmd_args_mask(commands.device, torch.bool)[commands.long()]
    args_m = torch.where(used, margins[..., 1:], torch.full_like(margins[..., 1:], float("inf")))
    return torch.minimum(margins[..., 0], args_m.amin(dim=-1))


def traced_decode(model, z, sample_mod, capture: dict | None = None):
    """``autoregressive_sample_fused(model, z)`` as the modules have it (the
    kernels, or their plain versions under :func:`plain_path`), recording
    the decoder states of every step and the raw (relative) decoded ids, and
    into ``capture`` the decode step's operands at the indices of
    AR_INDICES (cloned) and of the last step (``"last"``, as they are).
    Returns ``(out, raw_commands [N, L], raw_args [N, L, n_args], states
    [L, N, D])``. The spies stand in ``sample``'s namespace for the call;
    the wrappers and their launch counts stay as they are."""
    import types
    head_ops, decode_ops = sample_mod.head_ops, sample_mod.decode_ops
    head, decode = head_ops.fused_head_argmax, decode_ops.fused_decode_step
    finalize = sample_mod._finalize_args
    states, raw = [], {}

    def spy_head(y, *rest):
        states.append(y)
        return head(y, *rest)

    def spy_decode(*a):
        if capture is not None:
            index = a[-2]
            if index in AR_INDICES:
                capture[index] = [t.clone() if torch.is_tensor(t) else t for t in a]
            capture["last"] = a
        return decode(*a)

    def keep(cfg, commands, args):
        raw["c"], raw["a"] = commands[:, 0], args[:, 0]
        return finalize(cfg, commands, args)
    sample_mod.head_ops = types.SimpleNamespace(fused_head_argmax=spy_head)
    sample_mod.decode_ops = types.SimpleNamespace(fused_decode_step=spy_decode)
    sample_mod._finalize_args = keep
    try:
        out = sample_mod.autoregressive_sample_fused(model, z)
    finally:
        sample_mod.head_ops, sample_mod.decode_ops = head_ops, decode_ops
        sample_mod._finalize_args = finalize
    return out, raw["c"], raw["a"], torch.stack(states)


def prefix_gate(out, out_ref, margin_ref, min_margin: float):
    """Per sequence, the first position whose reference margin ``[N, L]`` is
    below ``min_margin``; the share of sequences whose decoded commands and
    arguments equal the reference's on every position before it, and the
    number of positions compared."""
    (c, a), (c_r, a_r) = out, out_ref
    length = margin_ref.shape[1]
    low = margin_ref < min_margin
    first = torch.where(low.any(dim=1), low.float().argmax(dim=1),
                        torch.full_like(low[:, 0], length, dtype=torch.long))
    gated = torch.arange(length, device=c.device)[None] < first[:, None]
    same = (c[:, 0] == c_r[:, 0]) & (a[:, 0] == a_r[:, 0]).all(dim=-1)
    return (same | ~gated).all(dim=1).float().mean().item(), int(gated.sum())


def count_plain_calls(modules):
    """Wrap the plain versions ``(module, name)`` to count their calls;
    returns ``(counts, restore)``."""
    counts, saved = {}, []
    for mod, name in modules:
        fn = getattr(mod, name)
        counts[name] = 0

        def spy(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, spy)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return counts, restore


def compare_elementwise(what, got, want, rms_limit, atol=TOL_LAYER_ATOL, rtol=TOL_LAYER_RTOL):
    """Kernel output against its plain version: the largest excess of the
    error over ``rtol`` x |out| (limit ``atol``) and the relative RMS error
    (limit ``rms_limit``); checked later, printed now. Returns the readings."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - rtol * want.float().abs()).max().item()
    rms = rel_rms(got, want)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check_later(excess <= atol and rms <= rms_limit,
                f"{what}: an element is off by {excess} beyond {rtol} x |out| (limit {atol}), "
                f"relative RMS err {rms} (limit {rms_limit})")
    print(f"{what}: max abs err {diff.max().item():.3g}; largest excess over {rtol:.3g} x |out| "
          f"{excess:.3g} (limit {atol}); relative RMS err {rms:.3g} (limit {rms_limit})",
          flush=True)
    return {"max_abs_err": diff.max().item(), "atol_needed": excess, "rms": rms}


def autoregressive_phase(dev, card, kernels, record, yardstick, reset_counts, read_counts,
                         library_layer) -> dict:
    """Sketchformer's greedy encode+decode at N=1024 through K1, the long
    form of K2, K9 and K3: each kernel against its plain version, the counted
    ``greedy_sample``, kernel path against plain path at N=64 with a control,
    the teacher-forced forward over the decoded tokens, and the times.
    Returns the launches of one ``greedy_sample``."""
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import (
        DropoutRng, autoregressive_sample_cached, autoregressive_sample_fused, greedy_sample)
    from deepsvg_tpu_torch.models import sample as sample_mod
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import decode as decode_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.svgtensor.constants import CMD_SOS, PAD_VAL
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    model = sketchformer_model(dev)
    cfg = model.cfg
    fcn, enc, dec = model.decoder.fcn, model.encoder, model.decoder
    batch = generate_batch(np.random.default_rng(0), N_MAIN, cfg.max_num_groups,
                           cfg.max_seq_len)
    commands = torch.from_numpy(batch["commands_grouped"]).to(dev)     # [N, 1, 242]
    args = torch.from_numpy(batch["args_grouped"]).to(dev)
    n, s_enc = commands.shape[0], commands.shape[-1]
    length = cfg.max_total_len + 1
    out: dict = {"N": n, "S_encoder": s_enc, "T": length, "seed": AR_SEED}

    with torch.no_grad():
        z, _, _ = model.encode(commands, args, rng=DropoutRng.fixed())
        # ---- the decode's operands at three positions, from a kernel-path decode
        captured = {}
        fused = decode_ops.fused_decode_step
        (c_k, a_k), raw_c, raw_a, states = traced_decode(model, z, sample_mod, captured)
        # index 240: the caches after the last step (every position before 240 written)
        last = list(captured.pop("last"))
        last[-2] = length - 1
        captured[length - 1] = last
        torch.cuda.synchronize()

        # ---- K9 against its plain version at N=1024, T=241
        k9 = {}
        for index in AR_INDICES:
            ops = captured[index]
            got = fused(*ops)
            want = decode_ops.decode_step_reference(*ops)
            k9[index] = {name: compare_elementwise(f"K9 decode step index {index} {name}", g, w,
                                                   TOL_DECODE_RMS)
                         for name, g, w in zip(("y", "k_new", "v_new"), got, want)}
        # the decode's batch takes the cluster kernel in one wave of this card
        plan = decode_ops.decode_launch_plan(N_MAIN, cfg.d_model, cfg.dim_feedforward,
                                             cfg.n_heads, bf16, decode_ops.cluster_wave(bf16))
        check(plan["takes"] and plan["waves"] == 1,
              f"K9 at N={N_MAIN}: the cluster kernel's launch {plan} is not one wave")
        kernels["decode"] = {
            "max_abs_err": max(r["max_abs_err"] for v in k9.values() for r in v.values()),
            "atol_needed": max(r["atol_needed"] for v in k9.values() for r in v.values()),
            "tolerance": {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL,
                          "rms": TOL_DECODE_RMS},
            "cases": k9, "launch_plan": plan}

        # ---- K2's long form against its plain version: E1 at the path's
        # S=242 (key padding), S=240 (random input, key padding) and the
        # teacher-forced decoder's S=241 (causal, key padding, seq_bias)
        cmd_f, args_f = commands[:, 0], args[:, 0]
        x_e1 = enc.embedding(cmd_f, args_f, M.group_mask(cmd_f))
        kp_e1 = key_padding_to_additive(M.key_padding_mask(cmd_f))
        buf_c = torch.cat([torch.full((n, 1), CMD_SOS, dtype=torch.int32, device=dev), raw_c], 1)
        buf_a = torch.cat([torch.full((n, 1, cfg.n_args), float(PAD_VAL), device=dev), raw_a], 1)
        x_tf = dec.embedding(buf_c, buf_a, M.group_mask(buf_c))
        kp_tf = key_padding_to_additive(M.key_padding_mask(buf_c))

        # ---- K1 against its plain version on the path's own inputs: the
        # encoder's (S=242, group table, 257 argument classes) and the
        # teacher-forced decoder's (S=241, group table, 512 relative classes)
        k1 = {}
        for what, emb, c_in, a_in in (("encoder", enc.embedding, cmd_f, args_f),
                                      ("teacher-forced decoder", dec.embedding, buf_c, buf_a)):
            cmd_table, arg_tables, pos_table = emb.tables()
            e_in = (c_in, a_in, M.group_mask(c_in), cmd_table, arg_tables, emb.group_table(),
                    pos_table[:c_in.shape[1]], emb.use_group)
            err = (emb_ops.fused_embedding(*e_in).float()
                   - emb_ops.embedding_reference(*e_in).float()).abs().max().item()
            print(f"K1 embedding, {what} N={n} S={c_in.shape[1]}: group table "
                  f"{tuple(e_in[5].shape)}, {arg_tables.shape[0] // cfg.n_args} argument classes; "
                  f"max abs err {err:.3g} (tolerance {TOL_EMBED})", flush=True)
            check_later(err <= TOL_EMBED, f"K1 {what}: max abs err {err} > {TOL_EMBED}")
            k1[what] = err
        kernels["embedding"]["max_abs_err"] = max(kernels["embedding"]["max_abs_err"],
                                                  *k1.values())
        kernels["embedding"]["autoregressive_cases"] = k1
        l_e, l_d = enc.encoder.layers[0], dec.decoder.layers[0]
        gen = torch.Generator(device=dev).manual_seed(3)
        x240 = torch.randn(256, 240, cfg.d_model, device=dev, generator=gen).to(bf16)
        kp240 = torch.where(torch.rand(256, 240, device=dev, generator=gen) < 0.2, float("-inf"),
                            0.0)
        kp240[:, 0], kp240[0] = 0.0, float("-inf")          # sequence 0 fully masked
        long_cases = {
            "E1 S=242 key pad": layer_args(l_e, x_e1, kp_e1),
            "encoder S=240 random x, key pad": layer_args(l_e, x240, kp240),
            "decoder S=241 causal, key pad, seq_bias": layer_args(
                l_d, x_tf, kp_tf, l_d.injection(z).to(bf16), True),
        }
        k2l = {what: compare_elementwise(f"K2 long layer {what}", layer_ops.fused_layer(*la),
                                         layer_ops.layer_reference(*la), TOL_LAYER_RMS)
               for what, la in long_cases.items()}
        kernels["layer_long"] = {
            "max_abs_err": max(r["max_abs_err"] for r in k2l.values()),
            "atol_needed": max(r["atol_needed"] for r in k2l.values()),
            "tolerance": {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL, "rms": TOL_LAYER_RMS},
            "cases": k2l}

        # ---- K3 at 512 argument classes, on the decode's states at the middle index
        y_mid = states[AR_INDICES[1]].contiguous()
        head_in = (y_mid, fcn.w_packed, fcn.b_packed, cfg.n_commands, cfg.n_args, fcn.args_dim)
        ids_k = head_ops.fused_head_argmax(*head_in).long()
        ids_p = head_ops.head_argmax_reference(*head_in).long()
        margins = slot_margins(y_mid, fcn)
        differ = ids_k != ids_p
        check(not bool((differ & (margins >= TOL_HEAD_MARGIN)).any()),
              f"K3 at {fcn.args_dim} classes: ids differ where the top-2 gap >= {TOL_HEAD_MARGIN}")
        print(f"K3 head at {fcn.args_dim} argument classes, R={y_mid.shape[0]}: {int(differ.sum())} "
              f"of {differ.numel()} ids differ, all where the top-2 gap < {TOL_HEAD_MARGIN}",
              flush=True)
        out["head_512_ids_differing"] = int(differ.sum())

        # ---- one greedy_sample, counted; no plain version may run
        plain_fns = [(emb_ops, "embedding_reference"), (layer_ops, "layer_reference"),
                     (decode_ops, "decode_step_reference"), (head_ops, "head_argmax_reference")]
        torch.cuda.synchronize()
        calls, restore = count_plain_calls(plain_fns)
        reset_counts()
        try:
            c_g, a_g = greedy_sample(model, commands, args)
            torch.cuda.synchronize()
        finally:
            restore()
        launches = read_counts()
        steps = cfg.max_total_len
        print(f"greedy_sample N={n}: launches {launches}; plain versions called {calls}",
              flush=True)
        check(launches == dict.fromkeys(launches, 0) | {"embedding": 1, "layer_long": 4,
                                                        "decode": steps, "head": steps},
              f"launches per greedy_sample {launches}, expected embedding 1, long layer 4, "
              f"decode {steps}, head {steps}, nothing else")
        check(not any(calls.values()), f"plain versions ran on the kernel path: {calls}")
        check(torch.equal(c_g, c_k) and torch.equal(a_g, a_k),
              "greedy_sample differs from the traced decode of the same latent")
        check(tuple(c_g.shape) == (n, 1, steps) and tuple(a_g.shape) == (n, 1, steps, cfg.n_args)
              and bool(torch.isfinite(a_g).all()) and int(c_g.min()) >= 0
              and int(c_g.max()) < cfg.n_commands, "greedy_sample output shapes or ranges")
        used = M.cmd_args_mask(dev, torch.bool)[c_g.long()]
        check(bool((a_g[~used] == PAD_VAL).all()), "unused arguments are not PAD")
        out["launches"] = launches

        # ---- kernel path vs plain path at N=64, gated by the plain margin; control
        zg = z[:N_AR_GATE]
        out_k, raw_ck, raw_ak, states_k = traced_decode(model, zg, sample_mod)
        with plain_path(emb_ops, layer_ops, head_ops, decode_ops=decode_ops):
            out_p, raw_cp, raw_ap, states_p = traced_decode(model, zg, sample_mod)
            with truncated_weights(dec.decoder.layers[0], CONTROL_DROP_BITS):
                out_c1 = traced_decode(model, zg, sample_mod)
            with contextlib.ExitStack() as cut:
                for layer in dec.decoder.layers:
                    cut.enter_context(truncated_weights(layer, AR_CONTROL_DROP_BITS))
                out_c = traced_decode(model, zg, sample_mod)
        margin_p = position_margin(slot_margins(states_p, fcn), raw_cp.t()).t()   # [N, L]
        w_head = fcn.w_packed.float()

        def against_plain(o, raw_c_o, raw_a_o, states_o):
            """(share of sequences equal before the gate, positions compared,
            largest logit difference where both paths saw the same tokens:
            every step up to each sequence's first differing output)"""
            agree, compared = prefix_gate(o, out_p, margin_p, AR_MARGIN)
            differ = ~((raw_c_o == raw_cp) & (raw_a_o == raw_ap).all(dim=-1))
            first = torch.where(differ.any(1), differ.float().argmax(1),
                                torch.full_like(differ[:, 0], steps - 1, dtype=torch.long))
            shared = torch.arange(steps, device=dev)[:, None] <= first[None]     # [L, N]
            gap = ((states_o[shared].float() - states_p[shared].float()) @ w_head.t()).abs()
            return agree, compared, gap.max().item()
        agree, compared, logit_gap = against_plain(out_k, raw_ck, raw_ak, states_k)
        control1, _, control1_gap = against_plain(*out_c1)
        control, _, control_gap = against_plain(*out_c)
        every = ((out_k[0] == out_p[0]) & (out_k[1] == out_p[1]).all(-1)).float().mean().item()
        print(f"kernel vs plain path N={N_AR_GATE}: sequences equal before their first position "
              f"with plain margin < {AR_MARGIN}: {agree:.4f} ({compared} positions compared of "
              f"{N_AR_GATE * steps}); largest logit difference at shared inputs {logit_gap:.3g} "
              f"(limit {AR_LOGIT_LIMIT}); outputs equal at every position {every:.4f}; controls: "
              f"decoder layer 0 less {CONTROL_DROP_BITS} mantissa bits {control1:.4f} of the "
              f"sequences equal, largest logit difference {control1_gap:.3g}; all decoder "
              f"layers less {AR_CONTROL_DROP_BITS} bits {control:.4f}, {control_gap:.3g}",
              flush=True)
        check_later(agree == 1.0, f"decoded ids differ before the margin gate: {agree}")
        check_later(logit_gap <= AR_LOGIT_LIMIT,
                    f"logits differ by {logit_gap} at shared inputs (limit {AR_LOGIT_LIMIT})")
        check(control1_gap > AR_LOGIT_LIMIT and control_gap > AR_LOGIT_LIMIT,
              f"a control passed the logit limit {AR_LOGIT_LIMIT} ({control1_gap}, {control_gap})"
              f": it cannot see a fault of that size")
        check(control < 1.0, f"the decode gate passed its control ({control}): it cannot see a "
                             f"fault of that size")
        check(compared >= N_AR_GATE, f"only {compared} positions cleared the margin")
        out["gate"] = {"agreement": agree, "positions_compared": compared,
                       "max_logit_diff_shared_inputs": logit_gap, "logit_limit": AR_LOGIT_LIMIT,
                       "every_position": every,
                       "control_layer0": {"agreement": control1, "max_logit_diff": control1_gap},
                       "control": control, "control_max_logit_diff": control_gap}
        del states_k, states_p, out_c, out_c1

        # ---- teacher-forced forward (K1, long K2 causal at S=241, K3) over the
        # kernel path's decoded tokens: the argmax at each position equals the
        # decoded token wherever the margin is at least TF_MARGIN
        seen = {}
        hook = fcn.register_forward_hook(lambda m, i, o: seen.__setitem__("y", i[0]))
        reset_counts()
        try:
            tf = model(commands_dec=buf_c[:, None], args_dec=buf_a[:, None], z=z,
                       argmax_head=True)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        tf_launches = read_counts()
        check(tf_launches == dict.fromkeys(tf_launches, 0) | {"embedding": 1, "layer_long": 4,
                                                              "head": 1},
              f"teacher-forced launches {tf_launches}")
        tf_c = tf["command_ids"][:, 0, :steps]
        tf_a = tf["args_ids"][:, 0, :steps] - 1
        m_tf = position_margin(slot_margins(seen["y"].reshape(n, length, -1)[:, :steps], fcn),
                               raw_c)
        used = M.cmd_args_mask(dev, torch.bool)[raw_c.long()]
        same = (tf_c == raw_c) & ((tf_a == raw_a) | ~used).all(-1)
        gated = m_tf >= TF_MARGIN
        tf_agree = same[gated].float().mean().item()
        print(f"teacher-forced forward N={n} S={length}: launches {tf_launches}; its argmax equals "
              f"the decoded token at {tf_agree:.5f} of the {int(gated.sum())} positions with "
              f"margin >= {TF_MARGIN} (of {gated.numel()}); at every position "
              f"{same.float().mean().item():.4f}", flush=True)
        check_later(tf_agree == 1.0, f"teacher-forced argmax differs from the decode: {tf_agree}")
        out["teacher_forced"] = {"agreement": tf_agree, "positions_compared": int(gated.sum()),
                                 "every_position": same.float().mean().item()}
        del x_tf, tf, seen, x240, kp240, long_cases

        # ---- times at N=1024 (CUDA events, median of 5 after 1)
        times = {
            "encode": cuda_median_ms(lambda: model.encode(commands, args, rng=DropoutRng.fixed()),
                                     iters=5, warmup=1),
            "decode": cuda_median_ms(lambda: autoregressive_sample_fused(model, z), iters=5,
                                     warmup=1),
            "greedy_sample": cuda_median_ms(lambda: greedy_sample(model, commands, args),
                                            iters=5, warmup=1),
            "decode_cached_scan": cuda_median_ms(lambda: autoregressive_sample_cached(model, z),
                                                 iters=5, warmup=1),
        }
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            greedy_sample(model, commands, args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev_ms = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                  if e.device_time_total > 0 and e.device_type.name == "CUDA"}
        busy = sum(dev_ms.values())
        # K9's kernels: the cluster kernel (and the older one, at other widths)
        k9_dev = sum(v for k, v in dev_ms.items()
                     if "decode_cluster_kernel" in k or "decode_kernel" in k)
        out["profile"] = {"wall_ms": wall, "device_busy_ms": busy, "k9_device_ms": k9_dev,
                          "k9_share_of_busy": k9_dev / busy if busy else None,
                          "idle_share": 1 - busy / wall if busy else None,
                          "top": sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]}
        times["k9_device_ms_per_launch"] = k9_dev / steps if busy else None

        # K9 alone at each position, its plain version, its bound: the cache
        # bytes before the index, weights, rows in and out
        per_index = {}
        d, f_ff, n_l = cfg.d_model, cfg.dim_feedforward, cfg.n_layers_decode
        w_elems = n_l * (4 * d * d + 2 * d * f_ff + 3 * d + d + f_ff + d + 4 * d) + 2 * d
        for index in AR_INDICES:
            ops = captured[index]
            n_bytes = (2 * n_l * n * index * d * 2 + w_elems * 2 + n * (index + 1) * 4
                       + n * d * 2 * 2 + n_l * n * d * 2 * 3)
            t_ops = (2.0 * n * n_l * (4 * d * d + 2 * d * f_ff) / PEAK_BF16
                     + 4.0 * n * n_l * (index + 1) * d / PEAK_F32) * 1e3
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            per_index[index] = {
                "ms": cuda_ms(lambda ops=ops: fused(*ops)),
                "plain_ms": cuda_ms(lambda ops=ops: decode_ops.decode_step_reference(*ops),
                                    iters=3, warmup=1),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        mid = per_index[AR_INDICES[1]]
        kernels["decode"].update(ms=mid["ms"], plain_ms=mid["plain_ms"], library_ms=None,
                                 bound_ms=mid["bound_ms"], bound_by=mid["bound_by"],
                                 per_index=per_index)
        # the cached scan's step, K9's yardstick: the decode's time per step
        times["cached_scan_ms_per_step"] = times["decode_cached_scan"] / steps

        # long K2 at E1's shapes; nn.TransformerEncoderLayer (same function,
        # key padding, no seq_bias) as the library call
        la = layer_args(l_e, x_e1, kp_e1)
        rows = n * s_enc
        prod = 2.0 * rows * (4 * d * d + 2 * d * f_ff)
        attn = 4.0 * n * s_enc * s_enc * d
        b_ms, b_by = bound(nbytes(x_e1, kp_e1, *la[2:12]) + nbytes(x_e1), prod + attn, PEAK_BF16)
        lib = library_layer(l_e, bf16)
        pad_bool = M.key_padding_mask(cmd_f)
        lib_run = lambda: lib(x_e1, src_key_padding_mask=pad_bool)  # noqa: E731
        valid = ~pad_bool
        yardstick["layer_long"] = ((lib_run().float() - layer_ops.fused_layer(*la).float())
                                   .abs()[valid].max().item())
        kernels["layer_long"].update(
            ms=cuda_ms(lambda: layer_ops.fused_layer(*la)),
            plain_ms=cuda_ms(lambda: layer_ops.layer_reference(*la), iters=3, warmup=1),
            library_ms=cuda_ms(lib_run), bound_ms=b_ms, bound_by=b_by)
    out["times_ms"] = times
    out["samples_per_s"] = n / times["greedy_sample"] * 1e3
    out["phase_s"] = time.perf_counter() - t_phase
    record["autoregressive"] = out
    k9, k2l = kernels["decode"], kernels["layer_long"]
    print(f"Sketchformer greedy_sample N={n}: {times['greedy_sample']:.3f} ms median of 5, "
          f"{out['samples_per_s']:.1f} samples/s (encode {times['encode']:.3f} ms, decode "
          f"{times['decode']:.3f} ms; the cached scan in PyTorch operations "
          f"{times['decode_cached_scan']:.3f} ms) on {card}", flush=True)
    prof_line = out["profile"]
    print(f"  under the profiler: wall {prof_line['wall_ms']:.3f} ms, device busy "
          f"{prof_line['device_busy_ms']:.3f} ms, K9 {prof_line['k9_device_ms']:.3f} ms "
          f"({times['k9_device_ms_per_launch']} ms per launch; share of busy "
          f"{prof_line['k9_share_of_busy']})", flush=True)
    for index, t in per_index.items():
        print(f"  K9 index {index}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f} by {t['bound_by']})")
    print(f"  K2 long E1 B={n} S={s_enc}: {k2l['ms']:.4f} ms (plain {k2l['plain_ms']:.4f}, "
          f"library {k2l['library_ms']:.4f}, bound {k2l['bound_ms']:.4f} by {k2l['bound_by']}); "
          f"phase {out['phase_s']:.1f} s", flush=True)
    del model, captured, states, z
    torch.cuda.empty_cache()
    return launches

def device_split(fn, iters: int = 5):
    """``fn`` under ``torch.profiler``: (device busy ms per call, {kernel
    name: device ms per call}), or (None, {}) when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.device_time_total / 1e3 / iters for e in prof.key_averages()
           if e.device_time_total > 0 and e.device_type.name == "CUDA"}
    busy = sum(per.values())
    return (busy if busy else None), per


def copy_layer(lib, layer):
    """``layer``'s weights into ``torch.nn.TransformerEncoderLayer`` ``lib``."""
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


def transformer_layer(layer, dtype, dev, train=False):
    """The library call K2 and K4 are timed beside: a pre-LN
    ``torch.nn.TransformerEncoderLayer`` with ``layer``'s weights, dropout 0,
    in training mode for K4."""
    lib = torch.nn.TransformerEncoderLayer(
        layer.qkv.in_features, layer.n_heads, layer.ff1.out_features, dropout=0.0,
        activation="relu", batch_first=True, norm_first=True, device=dev, dtype=dtype)
    copy_layer(lib, layer)
    return lib.train() if train else lib.eval()


def k4_long_row(layer_vjp, layer, x, seq_bias, mask, causal, gen) -> dict:
    """The long K4 timed at one of its paths' shapes, in the saved mode:
    forward, backward (forward + backward less the forward) and the
    recompute forward with CUDA events, the forward's and the backward's
    device time under torch.profiler; the plain version; the bound
    (k4_bound); and the library call on the same rows (no seq_bias, no causal
    mask: the same products and attention), float32 in TF32 and in full
    float32."""
    fwd, both = k4_runs(layer_vjp.fused_layer_train, layer, x, seq_bias, mask, causal, gen=gen)
    rc_fwd, _ = k4_runs(layer_vjp.fused_layer_train, layer, x, seq_bias, mask, causal,
                        save_residuals=False, gen=gen)
    pfwd, pboth = k4_runs(layer_vjp.plain_layer_train, layer, x, seq_bias, mask, causal, gen=gen)
    f_ms, fb_ms, rc_ms = cuda_ms(fwd), cuda_ms(both), cuda_ms(rc_fwd)
    pf_ms, pfb_ms = cuda_ms(pfwd, iters=3, warmup=1), cuda_ms(pboth, iters=3, warmup=1)
    f_ff = layer.ff1.out_features
    (bf_ms, bf_by), (bb_ms, bb_by) = (k4_bound(x, seq_bias, f_ff, bwd, causal)
                                      for bwd in (False, True))
    (dev_f, _), (dev_fb, _) = device_split(fwd, iters=3), device_split(both, iters=3)
    row = {"fwd_ms": f_ms, "bwd_ms": fb_ms - f_ms, "recompute_fwd_ms": rc_ms,
           "device_fwd_ms": dev_f, "device_bwd_ms": None if dev_f is None else dev_fb - dev_f,
           "plain_fwd_ms": pf_ms, "plain_bwd_ms": pfb_ms - pf_ms, "fwd_bound_ms": bf_ms,
           "fwd_bound_by": bf_by, "bwd_bound_ms": bb_ms, "bwd_bound_by": bb_by}
    pad = torch.isneginf(mask)
    f32 = x.dtype == torch.float32
    for name, tf32 in ((("library_tf32", True), ("library", False)) if f32
                       else (("library", False),)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        lib = transformer_layer(layer, x.dtype, x.device, train=True)
        x_lib = x.detach().requires_grad_()
        g_lib = torch.randn(x.shape, device=x.device, generator=gen).to(x.dtype)

        def lib_fwd():
            with torch.no_grad():
                return lib(x_lib, src_key_padding_mask=pad)

        def lib_both():
            return torch.autograd.grad(lib(x_lib, src_key_padding_mask=pad),
                                       [x_lib, *lib.parameters()], g_lib)
        lf, lfb = cuda_ms(lib_fwd), cuda_ms(lib_both)
        row[f"{name}_fwd_ms"], row[f"{name}_bwd_ms"] = lf, lfb - lf
        torch.backends.cuda.matmul.allow_tf32 = False
        del lib
    return row


def grads_twice_equal(layer_vjp, layer, x, seq_bias, mask, causal, rate, seed=99):
    """K4 run twice on the same inputs: the output and the twelve gradients
    equal to the bit (no atomics)."""
    masters = layer.masters()
    x = x.detach().requires_grad_()
    bias = None if seq_bias is None else seq_bias.detach().requires_grad_()
    leaves = [t for t in (x, bias, *masters) if t is not None]
    g = torch.randn(x.shape, device=x.device).to(x.dtype)
    call = (x, bias, *masters, mask, seed, layer.n_heads, causal, rate, layer.compute_dtype)
    runs = []
    for _ in range(2):
        out = layer_vjp.fused_layer_train(*call, save_residuals=True)
        runs.append((out, torch.autograd.grad(out, leaves, g)))
    (o1, g1), (o2, g2) = runs
    return torch.equal(o1, o2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


def k4_runs(fn, layer, x, seq_bias, mask, causal=False, save_residuals=True, gen=None):
    """``fn`` (K4 or its plain version) on ``x`` with ``layer``'s masters
    at dropout DROPOUT, for timing: (the forward alone, forward and
    backward) as callables."""
    x = x.detach().requires_grad_()
    gy = torch.randn(x.shape, device=x.device, generator=gen).to(x.dtype)
    call = (x, seq_bias, *layer.masters(), mask, 7, layer.n_heads, causal, DROPOUT,
            layer.compute_dtype)
    leaves = [x, *layer.masters()]

    def fwd():
        with torch.no_grad():
            return fn(*call, save_residuals=save_residuals)

    def both():
        return torch.autograd.grad(fn(*call, save_residuals=save_residuals), leaves, gy)
    return fwd, both


def sketchformer_train_phase(dev, card, kernels, record, yardstick, reset_counts,
                             read_counts) -> dict:
    """Sketchformer's training at the recipe batch B=60 (encoder S=242,
    causal decoder S=241, 512 relative classes) through K1, the long form of
    K4, K5 and K6: each kernel against its plain version on the path's own
    inputs (the long K4 also with float32 activations, at S=32 and S=242,
    and bit-equal from run to run; K6 with the path's
    group tables), the counted and timed ``train_step``, and the CLI's
    ``train()`` with a resume. Returns the launches of one step."""
    import torch.nn.functional as F

    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import DropoutRng
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import layer_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    model = sketchformer_model(dev)
    cfg = model.cfg
    d, f_ff, n_args = cfg.d_model, cfg.dim_feedforward, cfg.n_args
    enc, dec = model.encoder, model.decoder
    raw = generate_batch(np.random.default_rng(0), B_RECIPE, cfg.max_num_groups,
                         cfg.max_seq_len)
    batch = {k: torch.from_numpy(raw[k]).to(dev)
             for k in ("commands_grouped", "args_grouped", "args_rel_grouped")}
    model_args = cfg.get_model_args()
    cmd_e, args_e = batch["commands_grouped"][:, 0], batch["args_grouped"][:, 0]  # [60, 242]
    cmd_d, args_d = cmd_e[:, :-1], batch["args_rel_grouped"][:, 0, :-1]       # [60, 241]
    out: dict = {"B": B_RECIPE, "S_encoder": cmd_e.shape[1], "S_decoder": cmd_d.shape[1]}
    gen = torch.Generator(device=dev).manual_seed(6)
    l_e, l_d = enc.encoder.layers[0], dec.decoder.layers[0]
    with torch.no_grad():
        x_e1 = enc.embedding(cmd_e, args_e, M.group_mask(cmd_e))
        kp_e1 = key_padding_to_additive(M.key_padding_mask(cmd_e))
        x_d = dec.embedding(cmd_d, args_d, M.group_mask(cmd_d))
        kp_d = key_padding_to_additive(M.key_padding_mask(cmd_d))
        z, _, _ = model.encode(batch["commands_grouped"], batch["args_grouped"],
                               rng=DropoutRng.fixed())
        sb_d = l_d.injection(z).to(bf16)
        # float32 activations at the flagship E1's S=32 (480 sequences, key
        # padding, sequence 0 fully masked), and E1 at S=242 in float32
        x32 = torch.randn(B_RECIPE * 8, 32, d, device=dev, generator=gen)
        kp32 = torch.where(torch.rand(B_RECIPE * 8, 32, device=dev, generator=gen) < 0.2,
                           float("-inf"), 0.0)
        kp32[:, 0], kp32[0] = 0.0, float("-inf")
        # and at D1's S=31, causal, with seq_bias (its key blocks straddle
        # two sequences)
        x31 = torch.randn(B_RECIPE * 8, 31, d, device=dev, generator=gen)
        sb31 = torch.randn(B_RECIPE * 8, d, device=dev, generator=gen)
        kp31 = kp32[:, :31].contiguous()

    # ---- the long K4 against its plain version, the short form's limits
    k4l = {}
    for rate in (0.0, DROPOUT):
        k4l[f"E1 S=242 key pad rate {rate}"] = check_layer_train(
            layer_vjp, "long E1 S=242 key pad", l_e, x_e1, None, kp_e1, False, rate)
        k4l[f"decoder S=241 causal seq_bias rate {rate}"] = check_layer_train(
            layer_vjp, "long decoder S=241 causal, key pad, seq_bias", l_d, x_d, sb_d, kp_d,
            True, rate)
    # the float32 long form (its Hopper kernels, layer_f32.cu and
    # layer_f32_bwd.cu): the flagship's E1 and D1 at B=60, and S=242
    k4f = {
        "float32 S=32 rate 0.1": check_layer_train(
            layer_vjp, "long float32 S=32 key pad", l_e, x32, None, kp32, False, DROPOUT),
        "float32 S=31 causal seq_bias rate 0.1": check_layer_train(
            layer_vjp, "long float32 S=31 causal, key pad, seq_bias", l_e, x31, sb31, kp31, True,
            DROPOUT),
        "float32 S=242 rate 0.1": check_layer_train(
            layer_vjp, "long float32 E1 S=242 key pad", l_e, x_e1.float(), None, kp_e1, False,
            DROPOUT)}
    same_bits = {
        "E1 S=242 bf16": grads_twice_equal(layer_vjp, l_e, x_e1, None, kp_e1, False, DROPOUT),
        "decoder S=241 causal bf16": grads_twice_equal(layer_vjp, l_d, x_d, sb_d, kp_d, True,
                                                       DROPOUT),
        "float32 S=32": grads_twice_equal(layer_vjp, l_e, x32, None, kp32, False, DROPOUT),
        "float32 S=31 causal seq_bias": grads_twice_equal(layer_vjp, l_e, x31, sb31, kp31,
                                                          True, DROPOUT),
        "float32 S=242": grads_twice_equal(layer_vjp, l_e, x_e1.float(), None, kp_e1, False,
                                           DROPOUT)}
    check_later(all(same_bits.values()),
                f"the long K4's output or gradients differ from run to run: {same_bits}")
    print(f"long K4 run twice, output and gradients equal to the bit: {same_bits}", flush=True)
    for suffix, cases, tol in (("", k4l, {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL}),
                               ("_f32", k4f, {"atol": TOL_F32_ATOL, "rtol": TOL_F32_RTOL})):
        all_grads = [r for v in cases.values() for r in v["grads"].values()]
        kernels["layer_train_long_fwd" + suffix] = {
            "max_abs_err": max(v["forward_max_abs_err"] for v in cases.values()),
            "tolerance": {**tol, "rms": TOL_LAYER_RMS}}
        kernels["layer_train_long_bwd" + suffix] = {
            "max_abs_err": max(r["max_abs_err"] for r in all_grads),
            "max_rms": max(r["rms"] for r in all_grads),
            "max_rms_same_gate": max(r["rms_same_gate"] for r in all_grads),
            "bit_identical_runs": {k: v for k, v in same_bits.items()
                                   if ("float32" in k) == (suffix == "_f32")},
            "tolerance": {"rms": {str(k): v for k, v in TOL_GRAD_RMS.items()},
                          "rms_same_gate": {str(k): v for k, v in TOL_GRAD_RMS_SAME_GATE.items()},
                          "worst_of_max": TOL_GRAD_WORST,
                          "worst_of_max_same_gate": TOL_GRAD_WORST_SAME_GATE}}
    out["layer_train_long_cases"] = {**k4l, **k4f}

    # ---- K6 against its plain version on the path's inputs: the encoder's
    # (S=242, 10-row group table, 257 classes) and the decoder's (S=241,
    # 242-row group table, 512 relative classes)
    def k6_inputs(emb, c, a):
        cmd_table, arg_tables, pos_table = emb.tables()
        group_table = emb.group_table()
        return (c, a, M.group_mask(c), cmd_table.shape[0], arg_tables.shape[0] // n_args,
                group_table.shape[0]), (cmd_table, arg_tables, group_table,
                                        pos_table[:c.shape[1]])

    k6 = {}
    k6_cases = {"encoder S=242": (enc.embedding, cmd_e, args_e),
                "decoder S=241": (dec.embedding, cmd_d, args_d)}
    for what, (emb, c, a) in k6_cases.items():
        (c, a, grp, n_cmd, vocab, n_group), tabs = k6_inputs(emb, c, a)
        tables = [t.float().requires_grad_() for t in tabs]
        dy = torch.randn(*c.shape, d, device=dev, generator=gen).to(bf16)
        got, same = k6_three_runs(emb_ops, c, a, grp, dy, n_cmd, vocab, n_group, True)
        check_later(same, f"K6 {what}: three runs not equal to the bit")
        want = torch.autograd.grad(emb_ops.embedding_reference(c, a, grp, *tables, True),
                                   tables, dy.float())
        errs = {name: (g_ - w_).abs().max().item() / max(w_.abs().max().item(), 1e-30)
                for name, g_, w_ in zip(("dcmd", "darg", "dgroup", "dpos"), got, want)}
        err_abs = max((g_ - w_).abs().max().item() for g_, w_ in zip(got, want))
        check_later(max(errs.values()) <= TOL_EMBED_BWD,
                    f"K6 {what}: err {errs} of the largest entry > {TOL_EMBED_BWD}")
        print(f"K6 embedding backward {what}, group table {n_group} rows, {vocab} classes: err "
              f"of the largest entry {max(errs.values()):.3g} (limit {TOL_EMBED_BWD}); three "
              f"runs equal to the bit: {same}", flush=True)
        k6[what] = {"err_of_max": errs, "max_abs_err": err_abs, "three_runs_equal": same}
    kernels["embedding_bwd_long"] = {"max_abs_err": max(v["max_abs_err"] for v in k6.values()),
                                     "tolerance": TOL_EMBED_BWD, "cases": k6}

    # ---- K5 at 512 classes: the decoder's relative-argument head, R = 60 x 241
    fcn = dec.fcn
    wa, ba = fcn.args_fcn.weight, fcn.args_fcn.bias
    tgt = (batch["args_rel_grouped"][:, 0, 1:] + 1).to(torch.int32).reshape(-1, n_args)
    r_ce = tgt.shape[0]
    y_ce = torch.randn(r_ce, d, device=dev, generator=gen).to(bf16).requires_grad_()
    g_ce = torch.rand(r_ce, n_args, device=dev, generator=gen) / r_ce
    ce_k = ce_ops.args_ce(y_ce, wa, ba, tgt, bf16)
    grads_k = torch.autograd.grad(ce_k, [y_ce, wa, ba], g_ce)
    ce_p = ce_ops.plain_args_ce(y_ce, wa, ba, tgt, bf16)
    grads_p = torch.autograd.grad(ce_p, [y_ce, wa, ba], g_ce)
    ce_err = (ce_k - ce_p).abs().max().item()
    ce_rms = {name: rel_rms(a_, w_) for name, a_, w_ in zip(("dy", "dWa", "dba"), grads_k,
                                                          grads_p)}
    check_later(tuple(ce_k.shape) == (r_ce, n_args) and ce_err <= TOL_CE
                and max(ce_rms.values()) <= TOL_CE_GRAD_RMS,
                f"K5 at {fcn.args_dim} classes: ce max abs err {ce_err} (limit {TOL_CE}), "
                f"gradients' relative RMS {ce_rms} (limit {TOL_CE_GRAD_RMS})")
    print(f"K5 args_ce at {fcn.args_dim} classes R={r_ce}: ce max abs err {ce_err:.3g} (limit "
          f"{TOL_CE}); gradients' relative RMS err {ce_rms} (limit {TOL_CE_GRAD_RMS})",
          flush=True)
    kernels["args_ce_fwd_512"] = {"max_abs_err": ce_err, "tolerance": TOL_CE}
    kernels["args_ce_bwd_512"] = {
        "max_abs_err": max((a_.float() - w_.float()).abs().max().item()
                           for a_, w_ in zip(grads_k, grads_p)),
        "rms": ce_rms, "tolerance": TOL_CE_GRAD_RMS}
    del ce_p, grads_p, grads_k, ce_k

    # ---- the step at B=60, counted (no plain version may run), then timed
    def new_state():
        m = sketchformer_model(dev).train()
        optimizer = make_optimizer(constant(LR))
        return create_train_state(m, optimizer, init=False), optimizer

    state, optimizer = new_state()
    plain_fns = [(layer_vjp, "layer_train_reference"), (layer_vjp, "plain_layer_train"),
                 (emb_ops, "embedding_reference"), (ce_ops, "args_ce_reference"),
                 (ce_ops, "plain_args_ce")]
    torch.cuda.synchronize()
    calls, restore = count_plain_calls(plain_fns)
    reset_counts()
    try:
        state, res = train_step(state, batch, SF_WEIGHTS, optimizer, model_args)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = read_counts()
    expected = dict.fromkeys(launches, 0) | {
        "embedding": 2, "layer_train_long_fwd": 8, "layer_train_long_bwd": 8,
        "args_ce_fwd": 1, "args_ce_bwd": 1, "embedding_bwd": 2}
    print(f"Sketchformer train_step B={B_RECIPE}: launches {launches}; plain versions called "
          f"{calls}", flush=True)
    check(launches == expected, f"Sketchformer step launches {launches}, expected {expected}")
    check(not any(calls.values()), f"plain versions ran on the kernel path: {calls}")
    losses = [res]
    events = []
    for i in range(TRAIN_STEPS - 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if i == 2:
            torch.cuda.synchronize()
            t_host = time.perf_counter()
        start.record()
        state, res = train_step(state, batch, SF_WEIGHTS, optimizer, model_args)
        end.record()
        events.append((start, end))
        losses.append(res)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / (TRAIN_STEPS - 3)
    loss_values = [float(r["loss"]) for r in losses]
    check(all(np.isfinite(float(v)) for r in losses for v in r.values()),
          f"a Sketchformer loss or gradient norm is not finite: {loss_values}")
    check(loss_values[-1] < loss_values[0],
          f"the Sketchformer loss did not fall over {TRAIN_STEPS} steps: {loss_values}")
    step_ms = statistics.median(s_.elapsed_time(e_) for s_, e_ in events[2:])
    busy, split = device_split(lambda: train_step(state, batch, SF_WEIGHTS, optimizer,
                                                  model_args), iters=3)
    groups = {"long K4 forward": ("train_long_qkv_kernel", "train_long_attn_kernel",
                                  "train_long_out_ffn_kernel"),
              "long K4 backward, row-local and attention": ("bwd_ff_kernel",
                                                            "bwd_attn_long_kernel",
                                                            "bwd_qkv_kernel"),
              "wgrad and reductions": ("wgrad_hopper_kernel", "reduce_partials"),
              "K5": K5_KERNELS, "K1 + K6": ("embedding",)}
    by_group = {name: sum(v for k, v in split.items() if any(p in k for p in pats))
                for name, pats in groups.items()}
    if busy:
        by_group["other"] = busy - sum(by_group.values())
    out["step"] = {
        "losses": loss_values, "median_ms_per_step": step_ms,
        "samples_per_s": B_RECIPE / step_ms * 1e3, "host_mean_ms_per_step": host_ms,
        "device_busy_ms_per_step": busy,
        "idle_share": None if busy is None else 1 - busy / host_ms,
        "device_ms_by_group": by_group,
        "top": sorted(split.items(), key=lambda kv: -kv[1])[:14], "launches": launches}
    print(f"Sketchformer training B={B_RECIPE} dropout {DROPOUT} bf16: loss {loss_values[0]:.4f} "
          f"-> {loss_values[-1]:.4f} over {TRAIN_STEPS} steps on one batch; {step_ms:.3f} ms/step "
          f"median of {TRAIN_STEPS - 3} (host clock {host_ms:.3f} ms/step mean); device busy "
          f"{busy} ms per step, idle share "
          f"{'not measured' if busy is None else round(1 - busy / host_ms, 4)}; device ms by "
          f"part {({k: round(v, 3) for k, v in by_group.items()})} on {card}", flush=True)
    del state, optimizer
    torch.cuda.empty_cache()

    # ---- the training CLI on configs/sketchformer.py (the icons recipe:
    # its data budget, max_total_len 50, makes the encoder S=52 and the
    # decoder S=51, both in the long form)
    out["cli"] = run_cli(dev, reset_counts, read_counts, expected, "sketchformer")

    # ---- times at the path's shapes: the long K4 at E1 (B=60, S=242) and
    # the causal decoder (S=241, seq_bias), with nn.TransformerEncoderLayer
    # in training mode as the library call (E1's row)
    stage_times = {
        "E1 S=242": k4_long_row(layer_vjp, l_e, x_e1, None, kp_e1, False, gen),
        "decoder S=241 causal": k4_long_row(layer_vjp, l_d, x_d, sb_d, kp_d, True, gen)}
    e1 = stage_times["E1 S=242"]
    kernels["layer_train_long_fwd"].update(
        ms=e1["fwd_ms"], plain_ms=e1["plain_fwd_ms"], library_ms=e1["library_fwd_ms"],
        bound_ms=e1["fwd_bound_ms"], bound_by=e1["fwd_bound_by"], stages=stage_times)
    kernels["layer_train_long_bwd"].update(
        ms=e1["bwd_ms"], plain_ms=e1["plain_bwd_ms"], library_ms=e1["library_bwd_ms"],
        bound_ms=e1["bwd_bound_ms"], bound_by=e1["bwd_bound_by"])

    # K5 at 512 classes; F.linear + F.cross_entropy as the library call
    n_cls = n_args * fcn.args_dim
    tgt_lib = tgt.long().reshape(-1)
    wa16, ba16 = wa.detach().to(bf16).requires_grad_(), ba.detach().to(bf16).requires_grad_()

    def ce_runs(fn):
        def fwd():
            with torch.no_grad():
                return fn(y_ce, wa, ba, tgt, bf16)

        def both():
            return torch.autograd.grad(fn(y_ce, wa, ba, tgt, bf16), [y_ce, wa, ba], g_ce)
        return fwd, both

    def lib_ce(grad):
        with torch.enable_grad() if grad else torch.no_grad():
            logits = F.linear(y_ce, wa16, ba16).reshape(-1, fcn.args_dim)
            ce = F.cross_entropy(logits, tgt_lib, reduction="none").reshape(r_ce, -1)
            if grad:
                return torch.autograd.grad(ce, [y_ce, wa16, ba16], g_ce.to(ce.dtype))
            return ce
    yardstick["args_ce_512"] = (lib_ce(False).float()
                                - ce_ops.args_ce(y_ce, wa, ba, tgt, bf16)).abs().max().item()
    (fwd, both), (pfwd, pboth) = ce_runs(ce_ops.args_ce), ce_runs(ce_ops.plain_args_ce)
    f_ms, fb_ms = cuda_ms(fwd), cuda_ms(both)
    pf_ms, pfb_ms = cuda_ms(pfwd, iters=5, warmup=1), cuda_ms(pboth, iters=5, warmup=1)
    lf_ms, lfb_ms = cuda_ms(lambda: lib_ce(False)), cuda_ms(lambda: lib_ce(True))
    ops_ce = 2.0 * r_ce * d * n_cls
    head_bytes = n_cls * d * 2 + n_cls * 2
    b_ms, b_by = bound(nbytes(y_ce, tgt) + head_bytes + r_ce * n_args * 4, ops_ce, PEAK_BF16)
    kernels["args_ce_fwd_512"].update(ms=f_ms, plain_ms=pf_ms, library_ms=lf_ms, bound_ms=b_ms,
                                      bound_by=b_by)
    b_ms, b_by = bound(2 * nbytes(y_ce) + nbytes(tgt) + head_bytes + 2 * r_ce * n_args * 4
                       + (n_cls * d + n_cls) * 4, 3 * ops_ce, PEAK_BF16)
    kernels["args_ce_bwd_512"].update(ms=fb_ms - f_ms, plain_ms=pfb_ms - pf_ms,
                                      library_ms=lfb_ms - lf_ms, bound_ms=b_ms, bound_by=b_by)

    # K6 at the encoder's S=242; one index_add_ of the expanded dy rows into
    # one stacked table as the library call (the expansion is made
    # beforehand and not timed)
    (c, a, grp, n_cmd, vocab, n_group), tabs = k6_inputs(enc.embedding, cmd_e, args_e)
    s_e = c.shape[1]
    dy = torch.randn(*c.shape, d, device=dev, generator=gen).to(bf16)
    tokens = c.numel()
    idx = torch.cat([
        c.long()[..., None],
        n_cmd + vocab * torch.arange(n_args, device=dev) + a.long() + 1,
        (n_cmd + vocab * n_args + grp.long().clamp(0, n_group - 1))[..., None],
        (n_cmd + vocab * n_args + n_group + torch.arange(s_e, device=dev))
        .expand(c.shape)[..., None]], dim=-1).reshape(-1)
    src = dy.float().reshape(tokens, 1, d).expand(-1, 3 + n_args, -1).reshape(-1, d).contiguous()
    stacked = torch.zeros(n_cmd + vocab * n_args + n_group + s_e, d, device=dev)
    tables32 = [t.float().requires_grad_() for t in tabs]

    def plain_k6():
        return torch.autograd.grad(emb_ops.embedding_reference(c, a, grp, *tables32, True),
                                   tables32, dy.float())
    b_ms, b_by = bound(nbytes(c, grp, dy) + tokens * n_args * 4 + stacked.numel() * 4,
                       tokens * d * (3.0 + n_args), PEAK_F32)
    # timed on int32 ids, as the step's backward gets them
    k6_args = (c, a.to(torch.int32), grp.to(torch.int32), dy, n_cmd, vocab, n_group, True)
    kernels["embedding_bwd_long"].update(
        ms=cuda_ms(lambda: emb_ops.embedding_backward(*k6_args)),
        device_ms=device_busy_ms(lambda: emb_ops.embedding_backward(*k6_args), iters=ITERS),
        plain_ms=cuda_ms(plain_k6, iters=5, warmup=1),
        library_ms=cuda_ms(lambda: stacked.index_add_(0, idx, src)), bound_ms=b_ms,
        bound_by=b_by)
    del idx, src, stacked
    out["phase_s"] = time.perf_counter() - t_phase
    record["sketchformer_train"] = out
    for what, st in stage_times.items():
        print(f"  long K4 {what} B={B_RECIPE}: forward {st['fwd_ms']:.4f} ms (device "
              f"{st['device_fwd_ms']}; recompute mode {st['recompute_fwd_ms']:.4f}; plain "
              f"{st['plain_fwd_ms']:.4f}, bound {st['fwd_bound_ms']:.4f} by "
              f"{st['fwd_bound_by']}), backward {st['bwd_ms']:.4f} ms (device "
              f"{st['device_bwd_ms']}; plain {st['plain_bwd_ms']:.4f}, bound "
              f"{st['bwd_bound_ms']:.4f} by {st['bwd_bound_by']}); nn.TransformerEncoderLayer "
              f"training mode on the same rows {st['library_fwd_ms']:.4f} / "
              f"{st['library_bwd_ms']:.4f} ms")
    for name in ("args_ce_fwd_512", "args_ce_bwd_512", "embedding_bwd_long"):
        k = kernels[name]
        print(f"  {name}: {k['ms']:.4f} ms{dev_text(k)} (plain {k['plain_ms']:.4f}, library "
              f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by {k['bound_by']})")
    print(f"Sketchformer training phase {out['phase_s']:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


def cut_mantissa(t, keep_bits: int):
    """float32 ``t`` with all but its top ``keep_bits`` mantissa bits cleared
    (a control: the values at a lower precision)."""
    return (t.float().contiguous().view(torch.int32) & ~((1 << (23 - keep_bits)) - 1)).view(
        torch.float32)


def step_against_plain(what, res_k, grads_k, res_p, grads_p) -> dict:
    """One training step's loss terms and per-leaf gradients on the kernel
    path against the plain path: relative loss differences, the
    whole-gradient cosine and the worst leaf's relative RMS difference."""
    losses = {k: abs(float(res_k[k]) - float(res_p[k])) / max(abs(float(res_p[k])), 1e-30)
              for k in ("loss", "loss_visibility", "loss_cmd", "loss_args") if k in res_p}
    leaf = {k: rel_rms(grads_k[k], grads_p[k]) for k in grads_p}
    flat_k = torch.cat([grads_k[k].flatten() for k in grads_p]).double()
    flat_p = torch.cat([grads_p[k].flatten() for k in grads_p]).double()
    cosine = float(flat_k @ flat_p / flat_k.norm() / flat_p.norm())
    worst = max(leaf, key=leaf.get)
    check(all(np.isfinite(v) for v in leaf.values()), f"{what}: a gradient is not finite")
    return {"loss_rel_diff": max(losses.values()), "losses": losses, "cosine": cosine,
            "worst_leaf": worst, "worst_leaf_rms": leaf[worst],
            "median_leaf_rms": statistics.median(leaf.values())}


def float32_phase(dev, card, kernels, record, reset_counts, read_counts, library_layer) -> dict:
    """The float32 models (``compute_dtype`` "float32", the configs'
    default) on the card, through the float32 forms of K1, K3, K5, K8 and
    K9 beside the float32 K2, K4 and K7: the flagship's ``one_shot_sample``
    at N=1024 and its ``train_step`` at B=60, the self-match step at B=60 and
    Sketchformer's ``greedy_sample`` at N=1024. Each path once counted, with
    no plain version called; each against its plain path at a cut size,
    gated by margin, with a control that must fail the gate; each float32
    kernel against its plain version at the path's shapes and timed. Returns
    the launches of the counted runs, by kernel name."""
    import torch.nn.functional as F

    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import (
        DropoutRng, greedy_sample, hierarchical_ordered,
        hierarchical_self_matching, load_model, matching, one_shot_sample)
    from deepsvg_tpu_torch.models import sample as sample_mod
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import decode as decode_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)
    t_phase = time.perf_counter()
    f32 = torch.float32
    out: dict = {}
    launches: dict = {}
    no_launch = dict.fromkeys(read_counts(), 0)
    plain_fns = [(emb_ops, "embedding_reference"), (layer_ops, "layer_reference"),
                 (head_ops, "head_argmax_reference"), (decode_ops, "decode_step_reference"),
                 (layer_vjp, "layer_train_reference"), (stack_vjp, "layer_train_reference"),
                 (ce_ops, "args_ce_reference")]

    def counted(what, fn, expected):
        """``fn()`` once, counted, with the plain versions spied: the float32
        forms' launches must be ``expected`` and no plain version may run."""
        torch.cuda.synchronize()
        calls, restore = count_plain_calls(plain_fns)
        reset_counts()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            restore()
        got = read_counts()
        print(f"float32 {what}: launches {got}; plain versions called {calls}", flush=True)
        check(got == no_launch | expected, f"float32 {what}: launches {got}, expected {expected}")
        check(not any(calls.values()), f"float32 {what}: plain versions ran: {calls}")
        return res, got

    def ids_gate(what, x, fcn):
        """K3's float32 form on ``x``: ids equal to the plain version's
        wherever the plain top-2 margin is at least TOL_HEAD_MARGIN; the
        control, the plain version on ``x`` cut to CONTROL_MANTISSA_BITS
        mantissa bits, must fail that gate."""
        head_in = (x, fcn.w_packed, fcn.b_packed, fcn.n_commands, fcn.n_args, fcn.args_dim)
        ids_k = head_ops.fused_head_argmax(*head_in).long()
        ids_p = head_ops.head_argmax_reference(*head_in).long()
        ids_c = head_ops.head_argmax_reference(cut_mantissa(x, CONTROL_MANTISSA_BITS),
                                               *head_in[1:]).long()
        wide = slot_margins(x, fcn) >= TOL_HEAD_MARGIN
        bad, bad_c = int(((ids_k != ids_p) & wide).sum()), int(((ids_c != ids_p) & wide).sum())
        # the largest logit gap between the two choices, over the rows that differ
        rows = (ids_k != ids_p).any(dim=1)
        offsets = torch.tensor([o for o, _ in head_slots(fcn)], device=x.device)
        logits = x[rows].float() @ fcn.w_packed.float().t() + fcn.b_packed.float()
        gap = (logits.gather(1, offsets + ids_p[rows]) - logits.gather(1, offsets + ids_k[rows]))
        gap = gap.abs().max().item() if gap.numel() else 0.0
        print(f"K3 float32 {what} R={x.shape[0]}: {int((ids_k != ids_p).sum())} of "
              f"{ids_k.numel()} ids differ (largest logit gap {gap:.3g}), {bad} where the plain "
              f"top-2 margin >= {TOL_HEAD_MARGIN} ({int(wide.sum())} such ids); control (x at "
              f"{CONTROL_MANTISSA_BITS} mantissa bits) {bad_c}", flush=True)
        check(bool(wide.any()), f"K3 float32 {what}: no id clears the margin")
        check_later(bad == 0, f"K3 float32 {what}: {bad} ids differ above the margin")
        check(bad_c > 0, f"K3 float32 {what}: the gate passed its control")
        return {"ids_differing": int((ids_k != ids_p).sum()), "above_margin": bad,
                "control_above_margin": bad_c, "max_abs_err": gap}, head_in

    # ================= (1) the flagship, float32, one_shot_sample at N=1024
    cfg = hierarchical_ordered()
    check(cfg.compute_dtype == "float32", f"the flagship config computes in {cfg.compute_dtype}")
    model = load_model(CHECKPOINT, cfg, device=dev)
    fcn, emb = model.decoder.fcn, model.encoder.embedding
    batch = generate_batch(np.random.default_rng(0), N_MAIN, cfg.max_num_groups, cfg.max_seq_len)
    commands = torch.from_numpy(batch["commands"]).to(dev)
    args = torch.from_numpy(batch["args"]).to(dev)
    with torch.no_grad():
        (c_out, a_out), launches["inference"] = counted(
            f"one_shot_sample N={N_MAIN}", lambda: one_shot_sample(model, commands, args),
            {"embedding_f32": 1, "layer_f32": 16, "head_f32": 1})
        check_sample(c_out, a_out, N_MAIN, cfg)
        # kernel path against plain path at N=64 by the ids' margin; control
        c64, a64 = commands[:N_AGREE], args[:N_AGREE]
        ids_k, _, _ = head_ids_and_margins(model, c64, a64)
        with plain_path(emb_ops, layer_ops, head_ops):
            ids_p, margins_p, _ = head_ids_and_margins(model, c64, a64)
            with truncated_weights(model.encoder.encoder.layers[0], CONTROL_DROP_BITS):
                ids_c, _, _ = head_ids_and_margins(model, c64, a64)
        agree = id_agreement(ids_k, ids_p, margins_p, AGREE_MARGIN)
        control = id_agreement(ids_c, ids_p, margins_p, AGREE_MARGIN)
        print(f"float32 flagship, kernel vs plain path N={N_AGREE}: head ids {agree} where the "
              f"plain margin >= {AGREE_MARGIN} (limit {AGREEMENT_MIN}); control (E1 layer 0 "
              f"weights at bfloat16 less {CONTROL_DROP_BITS} bits) {control}", flush=True)
        check_later(min(agree.values()) >= AGREEMENT_MIN, f"float32 id agreement {agree}")
        check(min(control.values()) < AGREEMENT_MIN, f"float32 gate passed its control {control}")
        out["inference_gate"] = {"agreement": agree, "control": control}

        # K1 and K3 in float32 at the path's shapes
        n, g, s_enc = commands.shape
        cmd_f, args_f = commands.reshape(n * g, s_enc), args.reshape(n * g, s_enc, -1)
        cmd_table, arg_tables, pos_table = emb.tables()
        check(cmd_table.dtype == f32, "the float32 model's tables are not float32")
        emb_in = (cmd_f, args_f, None, cmd_table, arg_tables, None, pos_table[:s_enc])
        x_e1 = emb_ops.fused_embedding(*emb_in)
        ref = emb_ops.embedding_reference(*emb_in)
        k1_err = (x_e1 - ref).abs().max().item()
        check(x_e1.dtype == f32, "K1 float32: the output is not float32")
        check_later(k1_err <= TOL_EMBED_F32 * ref.abs().max().item(),
                    f"K1 float32: max abs err {k1_err} above {TOL_EMBED_F32} of the largest entry")
        n_cmd, vocab = cmd_table.shape[0], arg_tables.shape[0] // emb.n_args
        table_all = torch.cat([cmd_table, arg_tables, pos_table[:s_enc]])
        idx = torch.cat([
            cmd_f.long()[..., None],
            n_cmd + vocab * torch.arange(emb.n_args, device=dev) + args_f.long() + 1,
            (n_cmd + vocab * emb.n_args + torch.arange(s_enc, device=dev))
            .expand(cmd_f.shape)[..., None]], dim=-1).reshape(-1, 2 + emb.n_args)
        rows = cmd_f.numel()
        b_ms, b_by = bound(nbytes(cmd_f, args_f, cmd_table, arg_tables, pos_table[:s_enc], x_e1),
                           rows * x_e1.shape[-1] * (1.0 + emb.n_args), PEAK_F32)
        kernels["embedding_f32"] = {
            "max_abs_err": k1_err, "tolerance": f"{TOL_EMBED_F32} of max |out|",
            "ms": cuda_ms(lambda: emb_ops.fused_embedding(*emb_in)),
            "device_ms": device_busy_ms(lambda: emb_ops.fused_embedding(*emb_in), iters=ITERS),
            "plain_ms": cuda_ms(lambda: emb_ops.embedding_reference(*emb_in)),
            "library_ms": cuda_ms(lambda: F.embedding_bag(idx, table_all, mode="sum")),
            "bound_ms": b_ms, "bound_by": b_by}
        del idx, table_all, ref
        seen = {}
        hook = fcn.register_forward_hook(lambda m, i, o: seen.__setitem__("x", i[0]))
        try:
            model(commands, args, argmax_head=True)
        finally:
            hook.remove()
        x_head = seen.pop("x").reshape(-1, cfg.d_model).contiguous()
        k3, head_in = ids_gate(f"at D1's output N={N_MAIN}", x_head, fcn)
        r, d = x_head.shape
        n_cls = fcn.n_commands + fcn.n_args * fcn.args_dim
        b_ms, b_by = bound(nbytes(x_head) + n_cls * d * 4 + n_cls * 4 + r * (1 + fcn.n_args) * 4,
                           2.0 * r * d * n_cls, PEAK_TF32)
        dec_in = (x_head[:N_MAIN], *head_in[1:])
        slots = head_slots(fcn)
        with matmul_tf32(True):  # the library in TF32, as the kernel
            lib_ms, lib_dec_ms = (cuda_ms(head_library(head_in, slots)),
                                  cuda_ms(head_library(dec_in, slots)))
        kernels["head_f32"] = dict(
            k3, tolerance=TOL_HEAD_MARGIN,
            ms=cuda_ms(lambda: head_ops.fused_head_argmax(*head_in)),
            plain_ms=cuda_ms(lambda: head_ops.head_argmax_reference(*head_in), iters=5),
            library_ms=lib_ms, library_full_float32_ms=cuda_ms(head_library(head_in, slots)),
            bound_ms=b_ms, bound_by=b_by,
            decode_ms=cuda_ms(lambda: head_ops.fused_head_argmax(*dec_in)),
            decode_library_ms=lib_dec_ms)
        del x_head, head_in, seen, dec_in

        # K2's float32 form at E1 and D1 (8,192 sequences of 32 and 31) of the
        # float32 flagship against its plain version, timed beside
        # nn.TransformerEncoderLayer in full float32 (key padding at E1; no
        # seq_bias, which it has not, at D1)
        enc, dec = model.encoder, model.decoder
        l_e1, l_d1 = enc.encoder.layers[0], dec.decoder.layers[0]
        z, _, _ = model.encode(commands, args)
        _, z_groups = dec.hierarchical_fcn(dec.hierarchical_decoder(dec.hierarchical_embedding(n),
                                                                    z))
        bias_d1 = F.linear(z_groups.reshape(n * g, -1), l_d1.glob.weight, l_d1.glob.bias)
        x_d1 = dec.embedding(n * g)
        pad_e1 = M.key_padding_mask(cmd_f)
        for name, layer, la, pad in (
                ("layer_f32_e1", l_e1, layer_args(l_e1, x_e1, key_padding_to_additive(pad_e1)),
                 pad_e1),
                ("layer_f32_d1", l_d1, layer_args(l_d1, x_d1, torch.zeros(
                    x_d1.shape[:2], device=dev), bias_d1), None)):
            check(x_d1.dtype == f32, "D1's float32 input is not float32")
            k2 = compare_elementwise(f"K2 float32 {name[-2:].upper()} S={la[0].shape[1]}",
                                     layer_ops.fused_layer(*la), layer_ops.layer_reference(*la),
                                     TOL_LAYER_RMS, TOL_F32_ATOL, TOL_F32_RTOL)
            lib = library_layer(layer, f32)
            b_ms, b_by = layer_cost(la)
            kernels[name] = {
                **k2, "tolerance": {"atol": TOL_F32_ATOL, "rtol": TOL_F32_RTOL,
                                    "rms": TOL_LAYER_RMS},
                "ms": cuda_ms(lambda la=la: layer_ops.fused_layer(*la)),
                "plain_ms": cuda_ms(lambda la=la: layer_ops.layer_reference(*la), iters=5),
                "library_ms": cuda_ms(lambda lib=lib, x=la[0], pad=pad: lib(
                    x, src_key_padding_mask=pad)),
                "bound_ms": b_ms, "bound_by": b_by}
        del lib, la, x_d1, bias_d1, z, z_groups
        inf_ms = cuda_median_ms(lambda: one_shot_sample(model, commands, args), iters=5,
                                warmup=1)
    out["inference"] = {"N": N_MAIN, "median_ms": inf_ms, "samples_per_s": N_MAIN / inf_ms * 1e3}
    print(f"float32 flagship one_shot_sample N={N_MAIN}: {inf_ms:.3f} ms median of 5, "
          f"{N_MAIN / inf_ms * 1e3:.1f} samples/s on {card}", flush=True)

    # ================= (2) the flagship's training step in float32, B=60
    tb = generate_batch(np.random.default_rng(0), B_RECIPE, cfg.max_num_groups, cfg.max_seq_len)
    batch60 = {k: torch.from_numpy(tb[k]).to(dev) for k in ("commands", "args")}

    def step_state(make_model, dropout):
        optimizer = make_optimizer(constant(LR))
        return create_train_state(make_model(dropout), optimizer, init=False), optimizer

    def grads_of(make_model, weights, control=None):
        """One step at dropout 0: its loss terms and each leaf's gradient."""
        state, optimizer = step_state(make_model, 0.0)
        with control(state.model) if control else contextlib.nullcontext():
            state, res = train_step(state, batch60, weights, optimizer, MODEL_ARGS)
        names = [k for k, _ in state.model.named_parameters()]
        return res, dict(zip(names, [p.grad.detach().clone() for p in state.parameters()]))

    def flagship(dropout):
        return load_model(CHECKPOINT, dataclasses.replace(cfg, dropout=dropout), device=dev)

    def cut_e1(m):
        return truncated_weights(m.encoder.encoder.layers[0], CONTROL_DROP_BITS)

    step_launches = {"embedding_f32": 1, "layer_train_long_fwd_f32": 8,
                     "layer_train_long_bwd_f32": 8, "stack_fwd": 2, "stack_bwd": 2,
                     "args_ce_fwd_f32": 1, "args_ce_bwd_f32": 1, "embedding_bwd": 1}
    state, optimizer = step_state(flagship, DROPOUT)
    _, launches["train_step"] = counted(
        f"train_step B={B_RECIPE}",
        lambda: train_step(state, batch60, LOSS_WEIGHTS, optimizer, MODEL_ARGS), step_launches)

    def one_step():
        train_step(state, batch60, LOSS_WEIGHTS, optimizer, MODEL_ARGS)
    step_ms = cuda_median_ms(one_step, iters=10, warmup=2)
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    for _ in range(10):
        one_step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / 10
    # where the step's device time goes (torch.profiler, 3 steps), as
    # Sketchformer's phase reads it
    busy, split_ms = device_split(one_step, iters=3)
    groups = {"long K4 forward": ("train_qkv_kernel", "train_attn_kernel",
                                  "train_out_ffn_kernel"),
              "long K4 backward, row-local and attention":
                  ("layer_f32_bwd::(anonymous namespace)::bwd_",),
              "weight products (K4's TF32, K7's) and reductions":
                  ("wgrad_tf32_kernel", "wgrad_kernel", "reduce_partials"),
              "K7": ("stack_fwd_kernel", "stack_bwd_kernel"), "K5": K5_KERNELS,
              "K1 + K6": ("embedding",)}
    by_group = {name: sum(v for k, v in split_ms.items() if any(p in k for p in pats))
                for name, pats in groups.items()}
    if busy:
        by_group["other"] = busy - sum(by_group.values())
    out["train_step_device"] = {
        "host_mean_ms_per_step": host_ms, "device_busy_ms_per_step": busy,
        "idle_share": None if busy is None else 1 - busy / host_ms,
        "device_ms_by_group": by_group,
        "top": sorted(split_ms.items(), key=lambda kv: -kv[1])[:14]}
    print(f"float32 flagship train_step B={B_RECIPE} dropout {DROPOUT}: host clock "
          f"{host_ms:.3f} ms/step mean of 10; device busy {busy} ms per step, idle share "
          f"{'not measured' if busy is None else round(1 - busy / host_ms, 4)}; device ms by "
          f"part {({k: round(v, 3) for k, v in by_group.items()})} on {card}", flush=True)
    del state, optimizer
    # K6 on the step's float32 dy (B=60: 480 sequences of 32 tokens, the ids
    # as int32, as the step's backward gets them; dy from a generator of its
    # own): against its plain version, three runs equal to the bit, timed
    # beside its bound, its plain version and one index_add_ of the expanded
    # dy rows into one stacked table (the expansion made beforehand, untimed)
    c6 = batch60["commands"].flatten(0, 1)
    a6 = batch60["args"].flatten(0, 1).to(torch.int32)
    n_cmd6, vocab6, n_args6, s6 = cfg.n_commands, cfg.args_dim + 1, cfg.n_args, c6.shape[1]
    d6 = cfg.d_model
    dy6 = torch.randn(*c6.shape, d6, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(60))
    k6_args = (c6, a6, None, dy6, n_cmd6, vocab6, 0, False)
    got6, same6 = k6_three_runs(emb_ops, *k6_args)
    tables6 = [torch.zeros(n, d6, device=dev, requires_grad=True)
               for n in (n_cmd6, n_args6 * vocab6, s6)]

    def plain_k6():
        return torch.autograd.grad(emb_ops.embedding_reference(
            c6, a6, None, tables6[0], tables6[1], None, tables6[2]), tables6, dy6)
    err6 = max((x - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
               for x, w in zip((got6[0], got6[1], got6[3]), plain_k6()))
    check_later(err6 <= TOL_EMBED_BWD and same6,
                f"K6 float32 dy B={B_RECIPE}: err {err6} of the largest entry (limit "
                f"{TOL_EMBED_BWD}), three runs equal to the bit {same6}")
    tokens6 = c6.numel()
    idx6 = torch.cat([
        c6.long()[..., None],
        n_cmd6 + vocab6 * torch.arange(n_args6, device=dev) + a6.long() + 1,
        (n_cmd6 + vocab6 * n_args6 + torch.arange(s6, device=dev))
        .expand(c6.shape)[..., None]], dim=-1).reshape(-1)
    src6 = dy6.reshape(tokens6, 1, d6).expand(-1, 2 + n_args6, -1).reshape(-1, d6).contiguous()
    stacked6 = torch.zeros(n_cmd6 + vocab6 * n_args6 + s6, d6, device=dev)
    b_ms, b_by = bound(nbytes(c6, a6, dy6) + stacked6.numel() * 4,
                       tokens6 * d6 * (2.0 + n_args6), PEAK_F32)
    kernels["embedding_bwd_f32"] = {
        "max_abs_err": max((x - w).abs().max().item()
                           for x, w in zip((got6[0], got6[1], got6[3]), plain_k6())),
        "err_of_largest": err6, "tolerance": TOL_EMBED_BWD, "three_runs_equal": same6,
        "ms": cuda_ms(lambda: emb_ops.embedding_backward(*k6_args)),
        "device_ms": device_busy_ms(lambda: emb_ops.embedding_backward(*k6_args), iters=ITERS),
        "plain_ms": cuda_ms(plain_k6, iters=5, warmup=1),
        "library_ms": cuda_ms(lambda: stacked6.index_add_(0, idx6, src6)),
        "bound_ms": b_ms, "bound_by": b_by}
    k = kernels["embedding_bwd_f32"]
    print(f"K6 float32 dy B={B_RECIPE} x {s6}: err {err6:.3g} of the largest entry (limit "
          f"{TOL_EMBED_BWD}), three runs equal to the bit {same6}; {k['ms']:.4f} ms, device "
          f"{k['device_ms']} ms (plain {k['plain_ms']:.4f}, index_add_ {k['library_ms']:.4f}, "
          f"bound {k['bound_ms']:.5f} by {k['bound_by']}) on {card}", flush=True)
    del got6, idx6, src6, stacked6, dy6
    res_k, grads_k = grads_of(flagship, LOSS_WEIGHTS)
    with plain_path(emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp):
        res_p, grads_p = grads_of(flagship, LOSS_WEIGHTS)
        res_c, grads_c = grads_of(flagship, LOSS_WEIGHTS, cut_e1)
    gate = step_against_plain("float32 step", res_k, grads_k, res_p, grads_p)
    ctrl = step_against_plain("float32 step control", res_c, grads_c, res_p, grads_p)
    del grads_k, grads_p, grads_c
    print(f"float32 flagship step B={B_RECIPE} dropout 0, kernel vs plain path: {gate}; "
          f"control (plain path, E1 layer 0 weights at bfloat16 less {CONTROL_DROP_BITS} "
          f"bits): {ctrl}", flush=True)
    check_later(gate["loss_rel_diff"] <= F32_STEP_LOSS
                and gate["median_leaf_rms"] <= F32_STEP_MEDIAN_LEAF_RMS
                and gate["worst_leaf_rms"] <= TOL_STEP_LEAF_RMS,
                f"float32 step: loss rel diff {gate['loss_rel_diff']} (limit {F32_STEP_LOSS}), "
                f"median leaf {gate['median_leaf_rms']} (limit {F32_STEP_MEDIAN_LEAF_RMS}), "
                f"worst leaf {gate['worst_leaf_rms']} (limit {TOL_STEP_LEAF_RMS})")
    check(ctrl["loss_rel_diff"] > F32_STEP_LOSS
          or ctrl["median_leaf_rms"] > F32_STEP_MEDIAN_LEAF_RMS,
          f"the float32 step gate passed its control {ctrl}")
    out["train_step"] = {"B": B_RECIPE, "median_ms": step_ms,
                         "samples_per_s": B_RECIPE / step_ms * 1e3, "gate": gate,
                         "control": ctrl}
    print(f"float32 flagship train_step B={B_RECIPE} dropout {DROPOUT}: {step_ms:.3f} ms/step "
          f"median of 10, {B_RECIPE / step_ms * 1e3:.1f} samples/s on {card}", flush=True)

    # K4's float32 long form at the step's shapes, the trained layers: E1
    # and D1 at B=60 (480 sequences of 32, key-padded; of 31 with seq_bias),
    # and S=242 (60 sequences) on E1's layer; beside nn.TransformerEncoderLayer
    k4m = flagship(DROPOUT)
    gen = torch.Generator(device=dev).manual_seed(13)
    cmd60 = batch60["commands"].flatten(0, 1)
    d_m = cfg.d_model
    with torch.no_grad():
        x_e1f = torch.randn(*cmd60.shape, d_m, device=dev, generator=gen)
        kp_e1f = key_padding_to_additive(M.key_padding_mask(cmd60))
        x_d1f = torch.randn(cmd60.shape[0], cmd60.shape[1] - 1, d_m, device=dev, generator=gen)
        sb_d1f = torch.randn(cmd60.shape[0], d_m, device=dev, generator=gen)
        x_242 = torch.randn(B_RECIPE, 242, d_m, device=dev, generator=gen)
        kp_242 = torch.where(torch.arange(242, device=dev)[None] < torch.randint(
            100, 243, (B_RECIPE, 1), device=dev, generator=gen), 0.0, float("-inf"))
    l_e1f, l_d1f = k4m.encoder.encoder.layers[0], k4m.decoder.decoder.layers[0]
    k4_rows = {
        f"E1 {tuple(x_e1f.shape[:2])}": k4_long_row(layer_vjp, l_e1f, x_e1f, None, kp_e1f,
                                                    False, gen),
        f"D1 {tuple(x_d1f.shape[:2])} seq_bias": k4_long_row(
            layer_vjp, l_d1f, x_d1f, sb_d1f, torch.zeros(x_d1f.shape[:2], device=dev), False,
            gen),
        f"S=242 {tuple(x_242.shape[:2])}": k4_long_row(layer_vjp, l_e1f, x_242, None, kp_242,
                                                       False, gen)}
    e1 = next(iter(k4_rows.values()))
    kernels["layer_train_long_fwd_f32"].update(
        ms=e1["fwd_ms"], plain_ms=e1["plain_fwd_ms"], library_ms=e1["library_tf32_fwd_ms"],
        library_full_f32_ms=e1["library_fwd_ms"], bound_ms=e1["fwd_bound_ms"],
        bound_by=e1["fwd_bound_by"], stages=k4_rows)
    kernels["layer_train_long_bwd_f32"].update(
        ms=e1["bwd_ms"], plain_ms=e1["plain_bwd_ms"], library_ms=e1["library_tf32_bwd_ms"],
        library_full_f32_ms=e1["library_bwd_ms"], bound_ms=e1["bwd_bound_ms"],
        bound_by=e1["bwd_bound_by"])
    for what, r in k4_rows.items():
        print(f"  long K4 float32 {what}: forward {r['fwd_ms']:.4f} ms (device "
              f"{r['device_fwd_ms']}; recompute mode {r['recompute_fwd_ms']:.4f}), backward "
              f"{r['bwd_ms']:.4f} (device {r['device_bwd_ms']}); plain {r['plain_fwd_ms']:.4f} / "
              f"{r['plain_bwd_ms']:.4f}; bound {r['fwd_bound_ms']:.4f} / {r['bwd_bound_ms']:.4f}; "
              f"library TF32 {r['library_tf32_fwd_ms']:.4f} / {r['library_tf32_bwd_ms']:.4f}, "
              f"full float32 {r['library_fwd_ms']:.4f} / {r['library_bwd_ms']:.4f} on {card}",
              flush=True)
    del k4m, x_e1f, x_d1f, x_242
    torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()

    # K5's float32 form at the step's shapes (R = 60 x 8 x 31), F.linear +
    # F.cross_entropy in float32 as the library call
    r_ce = B_RECIPE * cfg.max_num_groups * (cfg.max_seq_len + 1)
    randn = lambda *shape: torch.randn(*shape, device=dev)  # noqa: E731
    k5_cases = {}
    for vocab_ce in (fcn.args_dim, 512):
        n_cls = fcn.n_args * vocab_ce
        y_ce = randn(r_ce, cfg.d_model).requires_grad_()
        wa = (randn(n_cls, cfg.d_model) * cfg.d_model ** -0.5).requires_grad_()
        ba = randn(n_cls).requires_grad_()
        tgt = torch.randint(0, vocab_ce, (r_ce, fcn.n_args), device=dev, dtype=torch.int32)
        g_ce = torch.rand(r_ce, fcn.n_args, device=dev) / r_ce
        ce_k = ce_ops.args_ce(y_ce, wa, ba, tgt, f32)
        grads = torch.autograd.grad(ce_k, [y_ce, wa, ba], g_ce)
        ce_p = ce_ops.args_ce_reference(y_ce, wa, ba, tgt, fcn.n_args)
        grads_p = torch.autograd.grad(ce_p, [y_ce, wa, ba], g_ce)
        rms = {"ce": rel_rms(ce_k, ce_p), **{k: rel_rms(a, b) for k, a, b in
                                             zip(("dy", "dWa", "dba"), grads, grads_p)}}
        check_later(rms["ce"] <= CE_F32_RMS and max(rms["dy"], rms["dWa"], rms["dba"])
                    <= CE_F32_GRAD_RMS, f"K5 float32 at {vocab_ce} classes: {rms}")
        tgt_l = tgt.long().reshape(-1)

        def lib(grad):
            with torch.enable_grad() if grad else torch.no_grad():
                lce = F.cross_entropy(F.linear(y_ce, wa, ba).reshape(-1, vocab_ce), tgt_l,
                                      reduction="none").reshape(r_ce, -1)
                return torch.autograd.grad(lce, [y_ce, wa, ba], g_ce) if grad else lce

        def runs(fn):
            def fwd():
                with torch.no_grad():
                    return fn(y_ce, wa, ba, tgt, f32)
            return fwd, lambda: torch.autograd.grad(fn(y_ce, wa, ba, tgt, f32), [y_ce, wa, ba],
                                                    g_ce)
        (fwd, both), (pfwd, pboth) = runs(ce_ops.args_ce), runs(ce_ops.plain_args_ce)
        f_ms, fb_ms = cuda_ms(fwd), cuda_ms(both)
        pf_ms, pfb_ms = cuda_ms(pfwd, iters=5, warmup=1), cuda_ms(pboth, iters=5, warmup=1)
        lf_ms, lfb_ms = cuda_ms(lambda: lib(False)), cuda_ms(lambda: lib(True))
        ops_ce = 2.0 * r_ce * cfg.d_model * n_cls
        head_bytes = (n_cls * cfg.d_model + n_cls) * 4
        fb = bound(nbytes(y_ce, tgt) + head_bytes + r_ce * fcn.n_args * 4, ops_ce, PEAK_TF32)
        bb = bound(2 * nbytes(y_ce) + nbytes(tgt) + 2 * head_bytes + 2 * r_ce * fcn.n_args * 4,
                   3 * ops_ce, PEAK_TF32)
        k5_cases[vocab_ce] = {
            "R": r_ce, "rms": rms,
            "fwd": {"ms": f_ms, "plain_ms": pf_ms, "library_ms": lf_ms, "bound_ms": fb[0],
                    "bound_by": fb[1]},
            "bwd": {"ms": fb_ms - f_ms, "plain_ms": pfb_ms - pf_ms, "library_ms": lfb_ms - lf_ms,
                    "bound_ms": bb[0], "bound_by": bb[1]}}
        print(f"K5 float32 at {vocab_ce} classes R={r_ce}: relative RMS {rms} (limits "
              f"{CE_F32_RMS}, {CE_F32_GRAD_RMS}); forward {k5_cases[vocab_ce]['fwd']}, "
              f"backward {k5_cases[vocab_ce]['bwd']}", flush=True)
        del y_ce, wa, ba, grads, grads_p
    k257 = k5_cases[fcn.args_dim]
    for name, part in (("args_ce_fwd_f32", "fwd"), ("args_ce_bwd_f32", "bwd")):
        kernels[name] = dict(k257[part], max_abs_err=k257["rms"]["ce" if part == "fwd" else "dy"],
                             tolerance={"rms": CE_F32_RMS, "grad_rms": CE_F32_GRAD_RMS},
                             at_512_classes=k5_cases[512][part])
    out["k5_f32"] = k5_cases

    # ================= (3) the self-match step in float32, B=60
    sm_cfg = hierarchical_self_matching()
    sm_model = self_match_model(dataclasses.replace(sm_cfg, dropout=0.0), dev)
    c60, a60 = batch60["commands"], batch60["args"]
    fwd_k = matched_forward(sm_model, c60, a60)
    with plain_path(emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp):
        fwd_p = matched_forward(sm_model, c60, a60)
        fwd_c = matched_forward(sm_model, c60, a60, perturb_states=MATCH_CONTROL_NOISE)
    margin = matching.assignment_margin(fwd_p["cost"], fwd_p["vis"])
    gated = margin >= MATCH_MARGIN

    def agreement(other):
        same = (other["assignment"] == fwd_p["assignment"]).all(dim=-1)
        return same[gated].float().mean().item()
    sm_agree, sm_control = agreement(fwd_k), agreement(fwd_c)
    print(f"float32 self-match assignment B={B_RECIPE}, kernel vs plain path: equal on "
          f"{sm_agree:.4f} of the {int(gated.sum())} samples whose margin >= {MATCH_MARGIN}; "
          f"control (states + {MATCH_CONTROL_NOISE} RMS noise) {sm_control:.4f}", flush=True)
    check(int(gated.sum()) >= B_RECIPE // 2, f"only {int(gated.sum())} samples clear the margin")
    check_later(sm_agree == 1.0, f"float32 self-match assignments differ: {sm_agree}")
    check(sm_control < 1.0, f"the float32 matching gate passed its control ({sm_control})")
    out["selfmatch_gate"] = {"agreement": sm_agree, "control": sm_control,
                             "gated": int(gated.sum())}
    y8, wa8, ba8, t8, g8, _ = fwd_k["k8_inputs"]
    with torch.no_grad():
        check(y8.dtype == f32, "K8's states are not float32")
        ce8_k = ce_ops.args_ce_pairwise(y8, wa8, ba8, t8, g8, f32)
        ce8_p = ce_ops.plain_args_ce_pairwise(y8, wa8, ba8, t8, g8, f32)
        r8, k8w = ce8_k.numel() // ce8_k.shape[-1], ce8_k.shape[-1]
        n_args8 = k8w // g8
        yf8, tf8, cf8 = y8.reshape(r8, -1), t8.reshape(r8, k8w), ce8_k.reshape(r8, k8w)
        k5_equal = all(torch.equal(cf8[:, i * n_args8:(i + 1) * n_args8], ce_ops.args_ce(
            yf8, wa8, ba8, tf8[:, i * n_args8:(i + 1) * n_args8].contiguous(), f32))
            for i in range(g8))
    k8_rms = rel_rms(ce8_k, ce8_p)
    check_later(k8_rms <= CE_F32_RMS and k5_equal,
                f"K8 float32: relative RMS {k8_rms}, columns equal to K5's forward {k5_equal}")
    t8l = tf8.reshape(r8, g8, n_args8).long()

    def lib_pair():
        with torch.no_grad():
            lp = F.log_softmax(F.linear(yf8, wa8, ba8).reshape(r8, 1, n_args8, -1), dim=-1)
            return -lp.expand(r8, g8, n_args8, lp.shape[-1]).gather(-1, t8l[..., None])[..., 0]
    n_cls8 = wa8.shape[0]
    b_ms, b_by = bound(nbytes(y8, t8) + (n_cls8 * yf8.shape[1] + n_cls8) * 4 + r8 * k8w * 4,
                       2.0 * r8 * yf8.shape[1] * n_cls8, PEAK_TF32)
    kernels["args_ce_pairwise_f32"] = {
        "max_abs_err": (ce8_k - ce8_p).abs().max().item(), "rms": k8_rms,
        "tolerance": CE_F32_RMS, "equals_k5_per_variant": k5_equal,
        "ms": cuda_ms(lambda: ce_ops.args_ce_pairwise(y8, wa8, ba8, t8, g8, f32)),
        "plain_ms": cuda_ms(lambda: ce_ops.plain_args_ce_pairwise(y8, wa8, ba8, t8, g8, f32),
                            iters=5, warmup=1),
        "library_ms": cuda_ms(lib_pair), "bound_ms": b_ms, "bound_by": b_by}
    print(f"K8 float32 R={r8} G={g8}: relative RMS {k8_rms:.3g} (limit {CE_F32_RMS}); each "
          f"variant's columns equal to K5's float32 forward: {k5_equal}", flush=True)
    del fwd_k, fwd_p, fwd_c, sm_model
    state, optimizer = step_state(
        lambda dropout: self_match_model(dataclasses.replace(sm_cfg, dropout=dropout), dev),
        DROPOUT)
    _, launches["selfmatch_step"] = counted(
        f"self-match train_step B={B_RECIPE}",
        lambda: train_step(state, batch60, SM_WEIGHTS, optimizer, MODEL_ARGS),
        step_launches | {"args_ce_pairwise_f32": 1})
    sm_ms = cuda_median_ms(lambda: train_step(state, batch60, SM_WEIGHTS, optimizer, MODEL_ARGS),
                           iters=5, warmup=1)
    out["selfmatch_step"] = {"B": B_RECIPE, "median_ms": sm_ms}
    print(f"float32 self-match train_step B={B_RECIPE}: {sm_ms:.3f} ms/step median of 5",
          flush=True)
    del state, optimizer
    torch.cuda.empty_cache()

    # ================= (4) Sketchformer, float32, greedy_sample at N=1024
    sf = sketchformer_model(dev, compute_dtype="float32")
    sf_cfg = sf.cfg
    sf_fcn = sf.decoder.fcn
    sb = generate_batch(np.random.default_rng(0), N_MAIN, sf_cfg.max_num_groups,
                        sf_cfg.max_seq_len)
    sc = torch.from_numpy(sb["commands_grouped"]).to(dev)
    sa = torch.from_numpy(sb["args_grouped"]).to(dev)
    steps = sf_cfg.max_total_len
    with torch.no_grad():
        (c_g, a_g), launches["greedy_sample"] = counted(
            f"Sketchformer greedy_sample N={N_MAIN}", lambda: greedy_sample(sf, sc, sa),
            {"embedding_f32": 1, "layer_long_f32": 4, "decode_f32": steps, "head_f32": steps})
        check(tuple(c_g.shape) == (N_MAIN, 1, steps) and bool(torch.isfinite(a_g).all()),
              "float32 greedy_sample output")
        z, _, _ = sf.encode(sc, sa, rng=DropoutRng.fixed())
        captured = {}
        states_all = traced_decode(sf, z, sample_mod, captured)[3]
        last = list(captured.pop("last"))
        last[-2] = steps
        captured[steps] = last
        k9 = {}
        for index in AR_INDICES:
            ops = captured[index]
            got, want = decode_ops.fused_decode_step(*ops), decode_ops.decode_step_reference(*ops)
            k9[index] = {name: compare_elementwise(f"K9 float32 index {index} {name}", a_, b_,
                                                   TOL_DECODE_RMS, TOL_F32_ATOL, TOL_F32_RTOL)
                         for name, a_, b_ in zip(("y", "k_new", "v_new"), got, want)}
        zg = z[:N_AR_GATE]
        out_k, raw_ck, _, states_k = traced_decode(sf, zg, sample_mod)
        with plain_path(emb_ops, layer_ops, head_ops, decode_ops=decode_ops):
            out_p, raw_cp, _, states_p = traced_decode(sf, zg, sample_mod)
            with contextlib.ExitStack() as cut:
                for layer in sf.decoder.decoder.layers:
                    cut.enter_context(truncated_weights(layer, AR_CONTROL_DROP_BITS))
                out_c = traced_decode(sf, zg, sample_mod)[0]
        margin_p = position_margin(slot_margins(states_p, sf_fcn), raw_cp.t()).t()
        ar_agree, compared = prefix_gate(out_k, out_p, margin_p, AR_MARGIN)
        ar_control, _ = prefix_gate(out_c, out_p, margin_p, AR_MARGIN)
        print(f"float32 Sketchformer, kernel vs plain path N={N_AR_GATE}: sequences equal "
              f"before their first position with plain margin < {AR_MARGIN}: {ar_agree:.4f} "
              f"({compared} positions compared); control (decoder layers at bfloat16 less "
              f"{AR_CONTROL_DROP_BITS} bits) {ar_control:.4f}", flush=True)
        check_later(ar_agree == 1.0, f"float32 decode differs before the margin gate {ar_agree}")
        check(ar_control < 1.0, f"the float32 decode gate passed its control ({ar_control})")
        check(compared >= N_AR_GATE, f"only {compared} positions cleared the margin")
        k3_ar, _ = ids_gate(f"at the decode's states (index {AR_INDICES[1]})",
                            states_all[AR_INDICES[1]].contiguous(), sf_fcn)
        kernels["head_f32"]["decode_case"] = k3_ar
        out["decode_gate"] = {"agreement": ar_agree, "control": ar_control,
                              "positions_compared": compared}
        del states_k, states_p, states_all
        # K9 alone at each position, its plain version, its bound (the cache
        # bytes before the index, weights, rows in and out), as the bf16 form's
        mid = captured[AR_INDICES[1]]
        d, f_ff, n_l = sf_cfg.d_model, sf_cfg.dim_feedforward, sf_cfg.n_layers_decode
        w_elems = n_l * (4 * d * d + 2 * d * f_ff + 3 * d + d + f_ff + d + 4 * d) + 2 * d
        per_index = {}
        for index in AR_INDICES:
            ops = captured[index]
            n_bytes = (2 * n_l * N_MAIN * index * d * 4 + w_elems * 4 + N_MAIN * (index + 1) * 4
                       + N_MAIN * d * 4 * 2 + n_l * N_MAIN * d * 4 * 3)
            t_ops = (2.0 * N_MAIN * n_l * (4 * d * d + 2 * d * f_ff) / PEAK_TF32
                     + 4.0 * N_MAIN * n_l * (index + 1) * d / PEAK_F32) * 1e3
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            per_index[index] = {
                "ms": cuda_ms(lambda ops=ops: decode_ops.fused_decode_step(*ops)),
                "plain_ms": cuda_ms(lambda ops=ops: decode_ops.decode_step_reference(*ops),
                                    iters=3, warmup=1),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        index = AR_INDICES[1]
        kernels["decode_f32"] = {
            "max_abs_err": max(r["max_abs_err"] for v in k9.values() for r in v.values()),
            "tolerance": {"atol": TOL_F32_ATOL, "rtol": TOL_F32_RTOL, "rms": TOL_DECODE_RMS},
            "cases": k9, "library_ms": None, "per_index": per_index,
            **{k: per_index[index][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
        for i, r in per_index.items():
            print(f"  K9 float32 index {i}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']})")
        # the float32 long K2 at the encoder's S=242 against its plain version,
        # timed beside nn.TransformerEncoderLayer in float32 (key padding)
        cmd_f, args_f = sc[:, 0], sa[:, 0]
        l_e = sf.encoder.encoder.layers[0]
        x_e1 = sf.encoder.embedding(cmd_f, args_f, M.group_mask(cmd_f))
        check(x_e1.dtype == f32, "Sketchformer's float32 encoder input is not float32")
        la = layer_args(l_e, x_e1, key_padding_to_additive(M.key_padding_mask(cmd_f)))
        k2l = compare_elementwise(f"K2 float32 long layer E1 S={x_e1.shape[1]} key pad",
                                  layer_ops.fused_layer(*la), layer_ops.layer_reference(*la),
                                  TOL_LAYER_RMS, TOL_F32_ATOL, TOL_F32_RTOL)
        lib = library_layer(l_e, f32)
        pad_bool = M.key_padding_mask(cmd_f)
        b_ms, b_by = layer_cost(la)
        kernels["layer_long_f32"] = {
            **k2l, "tolerance": {"atol": TOL_F32_ATOL, "rtol": TOL_F32_RTOL, "rms": TOL_LAYER_RMS},
            "ms": cuda_ms(lambda: layer_ops.fused_layer(*la)),
            "plain_ms": cuda_ms(lambda: layer_ops.layer_reference(*la), iters=3, warmup=1),
            "library_ms": cuda_ms(lambda: lib(x_e1, src_key_padding_mask=pad_bool)),
            "bound_ms": b_ms, "bound_by": b_by}
        del lib, la, x_e1
        gs_ms = cuda_median_ms(lambda: greedy_sample(sf, sc, sa), iters=3, warmup=1)
    out["greedy_sample"] = {"N": N_MAIN, "median_ms": gs_ms, "samples_per_s": N_MAIN / gs_ms * 1e3}
    print(f"float32 Sketchformer greedy_sample N={N_MAIN}: {gs_ms:.3f} ms median of 3, "
          f"{N_MAIN / gs_ms * 1e3:.1f} samples/s; K9 float32 at index {index}: "
          f"{kernels['decode_f32']['ms']:.4f} ms (plain {kernels['decode_f32']['plain_ms']:.4f}, "
          f"bound {kernels['decode_f32']['bound_ms']:.4f}) on {card}", flush=True)
    for name in ("embedding_f32", "head_f32", "layer_f32_e1", "layer_f32_d1", "args_ce_fwd_f32",
                 "args_ce_bwd_f32", "args_ce_pairwise_f32", "decode_f32", "layer_long_f32"):
        k = kernels[name]
        print(f"  {name}: {k['ms']:.4f} ms{dev_text(k)} (plain {k['plain_ms']:.4f}, library "
              f"{k['library_ms']}, bound {k['bound_ms']:.4f} by {k['bound_by']})")
    del sf, captured, z, mid
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"float32 phase: {out['phase_s']:.1f} s", flush=True)
    record["float32"] = out
    # the counts each float32 form's row reports: the path that runs it
    return {"embedding_f32": launches["inference"]["embedding_f32"],
            "head_f32": launches["inference"]["head_f32"],
            "layer_f32_e1": launches["inference"]["layer_f32"],
            "layer_f32_d1": launches["inference"]["layer_f32"],
            "args_ce_fwd_f32": launches["train_step"]["args_ce_fwd_f32"],
            "args_ce_bwd_f32": launches["train_step"]["args_ce_bwd_f32"],
            "args_ce_pairwise_f32": launches["selfmatch_step"]["args_ce_pairwise_f32"],
            "decode_f32": launches["greedy_sample"]["decode_f32"],
            "layer_long_f32": launches["greedy_sample"]["layer_long_f32"],
            "layer_train_long_fwd_f32": launches["train_step"]["layer_train_long_fwd_f32"],
            "layer_train_long_bwd_f32": launches["train_step"]["layer_train_long_bwd_f32"],
            "stack_fwd_f32": launches["train_step"]["stack_fwd"],
            "stack_bwd_f32": launches["train_step"]["stack_bwd"],
            "embedding_bwd_f32": launches["train_step"]["embedding_bwd"]}


def attention_phase(dev, card, kernels, record, reset_counts, read_counts) -> dict:
    """The attention block alone, the JAX package's public ops ``fused_mha``
    and ``fused_mha_train``, through K10 and K11 at the model's width (D=256,
    8 heads of 32) with the trained flagship's E1 layer 0 attention weights
    (``models/weights.py: attention_operands``): K10 at the flagship's E1
    inference shape (N=1024: 8,192 sequences of 32, key-padded as the
    inputs pad them) and at Sketchformer's encoder shape (1,024 x 242); K11
    at the flagship step's E1 (B=128: 1,024 x 32) and at Sketchformer's
    encoder (60 x 242) and causal decoder (60 x 241), dropout 0 and 0.1. Each
    against its plain version (K11 forward elementwise with dropout on, and
    its five gradients against autograd of the plain version and against the
    plain backward ``mha_backward_reference``), K11 bit-equal from run to
    run, each op counted once (K11's backward under ``mha_train_bwd``), and
    timed beside its bound, its plain version and F.linear ->
    F.scaled_dot_product_attention -> F.linear (under autograd with
    ``dropout_p`` for K11; the backward as forward and backward less the
    forward, at 60 x 242 and 1,024 x 32). Then the float32 forms (TF32
    products): K10 at both shapes and K11 at 60 x 242 and 1,024 x 32 (rate
    0.1), the same checks, the library call in TF32 and in full float32
    (K11's backward under ``mha_train_bwd_f32``); one D=128 case (4
    heads, seeded weights) through the first port's kernels, K10 and K11
    (rate 0.1, forward and backward, its gradients against both
    yardsticks), counted under ``narrow_launches`` and
    ``narrow_backward_launches``. (``scripts/profile_port_slice.py --mha``
    gives the device time of each launch.) Returns the launches per call of each
    op."""
    import torch.nn.functional as F

    from deepsvg_tpu_torch.configs.sketchformer import make_model_config
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import hierarchical_ordered, load_params
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.models.weights import attention_operands
    from deepsvg_tpu_torch.ops import attention as attn_ops
    from deepsvg_tpu_torch.ops import attention_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    layer0 = load_params(CHECKPOINT)["encoder"]["encoder"]["layer_0"]
    w = attention_operands(layer0["wqkv"], layer0["bqkv"], layer0["wo"], layer0["bo"], dev, bf16)
    w32 = [t.float() for t in w]
    d = w[0].shape[1]
    heads = d // 32
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg, sf_cfg = hierarchical_ordered(), make_model_config()
    fb = generate_batch(np.random.default_rng(0), N_MAIN, cfg.max_num_groups, cfg.max_seq_len)
    f_cmd = torch.from_numpy(fb["commands"]).to(dev).reshape(-1, fb["commands"].shape[-1])
    sb = generate_batch(np.random.default_rng(0), N_MAIN, sf_cfg.max_num_groups,
                        sf_cfg.max_seq_len)
    s_cmd = torch.from_numpy(sb["commands_grouped"]).to(dev)[:, 0]
    mask_of = lambda c: key_padding_to_additive(M.key_padding_mask(c))  # noqa: E731
    x_of = lambda b, s: torch.randn(b, s, d, device=dev, generator=gen).to(bf16)  # noqa: E731
    out: dict = {}

    def mha_ops(b, s, causal, ws=w):
        """(operations, weight bytes) of one forward: the two projections
        and the scores and P V over the keys each query sees."""
        keys = s * (s + 1) / 2 if causal else s * s
        return 2.0 * b * s * d * 4 * d + 4.0 * b * keys * d, nbytes(*ws) + b * s * 4

    def lib_mha(x, mask, causal, rate=0.0, ws=w):
        b, s, _ = x.shape
        qkv = F.linear(x, ws[0], ws[1]).reshape(b, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        am = mask[:, None, None, :]
        if causal:
            am = am + torch.full((s, s), float("-inf"), device=dev).triu(1)
        ctx = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=am.to(x.dtype),
                                             dropout_p=rate)
        return F.linear(ctx.transpose(1, 2).reshape(b, s, d), ws[2], ws[3])

    def hold(what, got, want, f32):
        """The output against the plain version with the layer's limits. In
        float32 the absolute term is TOL_F32_ATOL times the plain output's
        RMS: the block has no LayerNorm and no residual, and on these weights
        its outputs reach |out| ~25 at an RMS of ~2.2, where TF32's rounding
        moves the largest of 8M elements 0.02-0.04 from the float32 plain
        version (PERF.md §6; K10 prints the plain version in PyTorch's
        TF32 beside)."""
        if not f32:
            return compare_elementwise(what, got, want, TOL_LAYER_RMS)
        atol = TOL_F32_ATOL * want.float().pow(2).mean().sqrt().item()
        return dict(compare_elementwise(what, got, want, TOL_LAYER_RMS, atol, TOL_F32_RTOL),
                    atol=atol)

    def excess(a, b):
        return ((a.float() - b.float()).abs() - TOL_F32_RTOL * b.float().abs()).max().item()

    # ---- K10, bfloat16 then float32
    k10_cases = {"flagship E1 N=1024": (x_of(f_cmd.shape[0], f_cmd.shape[1]), mask_of(f_cmd),
                                        False),
                 "Sketchformer encoder N=1024": (x_of(N_MAIN, s_cmd.shape[1]), mask_of(s_cmd),
                                                 False)}
    for dtype, name, ws in ((bf16, "mha", w), (torch.float32, "mha_f32", w32)):
        f32 = dtype == torch.float32
        k10 = {}
        with torch.no_grad():
            for i, (what, (x, mask, causal)) in enumerate(k10_cases.items()):
                x = x.to(dtype)
                if i == 0:
                    reset_counts()
                    got = attn_ops.fused_mha(x, *ws, mask, heads, causal)
                    torch.cuda.synchronize()
                    counts = read_counts()
                    check(counts == dict.fromkeys(counts, 0) | {name: 1},
                          f"K10 {dtype} launches {counts}")
                else:
                    got = attn_ops.fused_mha(x, *ws, mask, heads, causal)
                want = attn_ops.mha_reference(x, *ws, mask, heads, causal)
                b, s, _ = x.shape
                ops, w_bytes = mha_ops(b, s, causal, ws)
                b_ms, b_by = bound(2 * nbytes(x) + w_bytes, ops, PEAK_TF32 if f32 else PEAK_BF16)
                case = dict(
                    hold(f"K10 {name} {what} ({b} x {s})", got, want, f32),
                    B=b, S=s, ms=cuda_ms(lambda: attn_ops.fused_mha(x, *ws, mask, heads, causal)),
                    plain_ms=cuda_ms(lambda: attn_ops.mha_reference(x, *ws, mask, heads, causal),
                                     iters=3, warmup=1),
                    bound_ms=b_ms, bound_by=b_by)
                if f32:
                    # a reading: the plain version in TF32 against the float32 one
                    with matmul_tf32(True):
                        want_tf32 = attn_ops.mha_reference(x, *ws, mask, heads, causal)
                    case["excess_vs_tf32_plain"] = excess(got, want_tf32)
                    case["tf32_plain_excess"] = excess(want_tf32, want)
                    print(f"  excess beyond {TOL_F32_RTOL} x |out| against the TF32 plain version "
                          f"{case['excess_vs_tf32_plain']:.4g}; the TF32 plain version's against "
                          f"the float32 one {case['tf32_plain_excess']:.4g}", flush=True)
                    del want_tf32
                    with matmul_tf32(True):
                        case["library_tf32_ms"] = cuda_ms(lambda: lib_mha(x, mask, causal, ws=ws))
                    with matmul_tf32(False):
                        case["library_ms"] = cuda_ms(lambda: lib_mha(x, mask, causal, ws=ws))
                else:
                    case["library_ms"] = cuda_ms(lambda: lib_mha(x, mask, causal))
                print(f"K10 {name} {what} ({b} x {s}): {case['ms']:.4f} ms (plain "
                      f"{case['plain_ms']:.4f}, library {case['library_ms']:.4f}"
                      + (f", library in TF32 {case['library_tf32_ms']:.4f}" if f32 else "")
                      + f", bound {b_ms:.4f} by {b_by}) on {card}", flush=True)
                k10[what] = case
                del got, want
        kernels[name] = dict(k10["flagship E1 N=1024"], cases=k10,
                             max_abs_err=max(c["max_abs_err"] for c in k10.values()),
                             tolerance=({"atol_per_rms": TOL_F32_ATOL,
                                         "rtol": TOL_F32_RTOL, "rms": TOL_LAYER_RMS} if f32 else
                                        {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL,
                                         "rms": TOL_LAYER_RMS}))
    del k10_cases
    torch.cuda.empty_cache()

    # ---- K10 at D=128 (4 heads): the first port's kernels, counted apart
    rng = np.random.default_rng(128)
    dn = 128
    wn = [torch.from_numpy((sc * rng.normal(size=sh)).astype(np.float32)).to(dev, bf16)
          for sh, sc in (((3 * dn, dn), dn ** -0.5), ((3 * dn,), 0.1), ((dn, dn), dn ** -0.5),
                         ((dn,), 0.1))]
    mask = mask_of(f_cmd[:128 * cfg.max_num_groups])
    x = torch.randn(*mask.shape, dn, device=dev, generator=gen).to(bf16)
    reset_counts()
    with torch.no_grad():
        got = attn_ops.fused_mha(x, *wn, mask, dn // 32)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == dict.fromkeys(counts, 0) | {"mha_narrow": 1}, f"K10 D=128 launches {counts}")
    out["narrow_d128"] = compare_elementwise(
        f"K10 D=128, 4 heads ({x.shape[0]} x {x.shape[1]}), first port's kernels", got,
        attn_ops.mha_reference(x, *wn, mask, dn // 32), TOL_LAYER_RMS)
    # K11 there too (rate 0.1): the first port's forward and backward
    # kernels, the five gradients against autograd of the plain version and
    # against the plain backward
    leaves = [t.clone().requires_grad_() for t in (x, *wn)]
    g = torch.randn(x.shape, device=dev, generator=gen).to(bf16)
    call = (*leaves, mask, 2024, dn // 32, False, DROPOUT)
    reset_counts()
    got = attention_vjp.fused_mha_train(*call)
    grads = torch.autograd.grad(got, leaves, g)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == dict.fromkeys(counts, 0) | {"mha_train_narrow_fwd": 1,
                                                "mha_train_narrow_bwd": 1},
          f"K11 D=128 launches {counts}")
    want = attn_ops.mha_reference(*leaves, mask, dn // 32, False, DROPOUT, 2024)
    case = compare_elementwise(
        f"K11 D=128, 4 heads ({x.shape[0]} x {x.shape[1]}) rate {DROPOUT}, first port's kernels",
        got, want, TOL_LAYER_RMS)
    grads_b = attention_vjp.mha_backward_reference(
        x, g, *wn[:3], mask, dn // 32, False, DROPOUT, 2024)
    case["grad_rms"] = {n: rel_rms(a, c) for n, a, c in zip(
        ("x", "wqkv", "bqkv", "wo", "bo"), grads, torch.autograd.grad(want, leaves, g))}
    case["grad_rms_plain_backward"] = {n: rel_rms(a, c.to(bf16)) for n, a, c in zip(
        ("x", "wqkv", "bqkv", "wo", "bo"), grads, grads_b)}
    worst = max(*case["grad_rms"].values(), *case["grad_rms_plain_backward"].values())
    print(f"  gradients: relative RMS {case['grad_rms']}, against the plain backward "
          f"{case['grad_rms_plain_backward']} (limit {MHA_GRAD_RMS})", flush=True)
    check_later(worst <= MHA_GRAD_RMS, f"K11 D=128 rate {DROPOUT}: gradient RMS {worst}")
    out["narrow_d128_train"] = case
    del got, grads, want, grads_b, leaves, x, wn

    # ---- K11
    k11_cases = {"flagship step E1 B=128": (x_of(128 * cfg.max_num_groups, f_cmd.shape[1]),
                                            mask_of(f_cmd[:128 * cfg.max_num_groups]), False),
                 "Sketchformer encoder B=60": (x_of(B_RECIPE, s_cmd.shape[1]),
                                               mask_of(s_cmd[:B_RECIPE]), False),
                 "Sketchformer decoder B=60 causal": (x_of(B_RECIPE, s_cmd.shape[1] - 1),
                                                      mask_of(s_cmd[:B_RECIPE, :-1]), True)}
    seed = 2024
    k11 = {}
    counted = {}
    # bfloat16: every case at rates 0 and 0.1; float32: the two timed ones at 0.1
    runs = [(bf16, what, rates) for what in k11_cases for rates in ((0.0, DROPOUT),)]
    runs += [(torch.float32, what, (DROPOUT,)) for what in ("Sketchformer encoder B=60",
                                                           "flagship step E1 B=128")]
    for dtype, what, rates in runs:
        f32 = dtype == torch.float32
        tag = " float32" if f32 else ""
        fwd_name = "mha_train_fwd_f32" if f32 else "mha_train_fwd"
        bwd_name = "mha_train_bwd_f32" if f32 else "mha_train_bwd"
        x0, mask, causal = k11_cases[what]
        x = x0.to(dtype).requires_grad_()
        leaves = [t.clone().to(dtype).requires_grad_() for t in w]
        g = torch.randn(x.shape, device=dev, generator=gen).to(bf16).to(dtype)
        b, s, _ = x.shape
        for rate in rates:
            call = (x, *leaves, mask, seed, heads, causal, rate)
            first = fwd_name not in counted
            if first:
                reset_counts()
            got = attention_vjp.fused_mha_train(*call)
            grads = torch.autograd.grad(got, [x, *leaves], g)
            if first:
                torch.cuda.synchronize()
                counts = read_counts()
                check(counts == dict.fromkeys(counts, 0) | {fwd_name: 1, bwd_name: 1},
                      f"K11{tag} launches {counts}")
                counted[fwd_name] = counts
            want = attn_ops.mha_reference(x, *leaves, mask, heads, causal, rate, seed)
            grads_p = torch.autograd.grad(want, [x, *leaves], g)
            # the plain backward, step by step (its weight gradients rounded
            # to the weights' type, as the op returns them)
            grads_b = attention_vjp.mha_backward_reference(
                x.detach(), g, *[t.detach() for t in leaves[:3]], mask, heads, causal, rate, seed)
            case = hold(f"K11 mha_train{tag} {what} ({b} x {s}) rate {rate}", got, want, f32)
            case["grad_rms"] = {n: rel_rms(a, c) for n, a, c in
                                zip(("x", "wqkv", "bqkv", "wo", "bo"), grads, grads_p)}
            case["grad_rms_plain_backward"] = {
                n: rel_rms(a, c.to(dtype)) for n, a, c in
                zip(("x", "wqkv", "bqkv", "wo", "bo"), grads, grads_b)}
            again = attention_vjp.fused_mha_train(*call)
            case["bit_equal_rerun"] = bool(torch.equal(again, got) and all(
                torch.equal(a, c) for a, c in zip(grads, torch.autograd.grad(again, [x, *leaves],
                                                                             g))))
            worst = max(*case["grad_rms"].values(), *case["grad_rms_plain_backward"].values())
            print(f"  gradients: relative RMS {case['grad_rms']}, against the plain backward "
                  f"{case['grad_rms_plain_backward']} (limit {MHA_GRAD_RMS}); rerun bit-equal "
                  f"{case['bit_equal_rerun']}", flush=True)
            check_later(worst <= MHA_GRAD_RMS, f"K11{tag} {what} rate {rate}: gradient RMS {worst}")
            check_later(case["bit_equal_rerun"], f"K11{tag} {what} rate {rate}: rerun differs")
            k11[f"{what}{tag} rate {rate}"] = case
            del got, grads, want, grads_p, grads_b, again
        # times at dropout 0.1: forward alone, forward and backward
        ops, w_bytes = mha_ops(b, s, causal, leaves)
        keys = s * (s + 1) / 2 if causal else s * s
        call = (x, *leaves, mask, seed, heads, causal, DROPOUT)

        def both(fn, *a):
            return torch.autograd.grad(fn(*a), [x, *leaves], g)

        def fwd(fn, *a):
            with torch.no_grad():
                return fn(*a)
        ref_call = (x, *leaves, mask, heads, causal, DROPOUT, seed)
        times = {"fwd": cuda_ms(lambda: fwd(attention_vjp.fused_mha_train, *call)),
                 "both": cuda_ms(lambda: both(attention_vjp.fused_mha_train, *call)),
                 "plain_fwd": cuda_ms(lambda: fwd(attn_ops.mha_reference, *ref_call), iters=3,
                                      warmup=1),
                 "plain_both": cuda_ms(lambda: both(attn_ops.mha_reference, *ref_call), iters=3,
                                       warmup=1)}
        with matmul_tf32(False):
            times["lib_fwd"] = cuda_ms(lambda: fwd(lib_mha, x, mask, causal, DROPOUT, leaves))
            times["lib_both"] = cuda_ms(lambda: both(lib_mha, x, mask, causal, DROPOUT, leaves))
        if f32:
            with matmul_tf32(True):
                times["lib_tf32_fwd"] = cuda_ms(lambda: fwd(lib_mha, x, mask, causal, DROPOUT,
                                                            leaves))
                times["lib_tf32_both"] = cuda_ms(lambda: both(lib_mha, x, mask, causal, DROPOUT,
                                                              leaves))
        peak = PEAK_TF32 if f32 else PEAK_BF16
        fb = bound(2 * nbytes(x) + w_bytes, ops, peak)
        bb = bound(3 * nbytes(x) + 2 * w_bytes, 22.0 * b * s * d * d + 12.0 * b * keys * d, peak)
        k11[what + tag] = {"B": b, "S": s, "times_ms": times, "fwd_bound": fb, "bwd_bound": bb}
        print(f"K11{tag} {what} ({b} x {s}) rate {DROPOUT}: forward {times['fwd']:.4f} ms "
              f"(plain {times['plain_fwd']:.4f}, library {times['lib_fwd']:.4f}"
              + (f", library in TF32 {times['lib_tf32_fwd']:.4f}" if f32 else "")
              + f", bound {fb[0]:.4f} by {fb[1]}); backward {times['both'] - times['fwd']:.4f} ms "
              f"(plain {times['plain_both'] - times['plain_fwd']:.4f}, library "
              f"{times['lib_both'] - times['lib_fwd']:.4f}"
              + (f", library in TF32 {times['lib_tf32_both'] - times['lib_tf32_fwd']:.4f}"
                 if f32 else "")
              + f", bound {bb[0]:.4f} by {bb[1]}) on {card}", flush=True)
        del leaves
    for name, tag in (("mha_train_fwd", ""), ("mha_train_fwd_f32", " float32")):
        row = k11["Sketchformer encoder B=60" + tag]
        t = row["times_ms"]
        errs = [c["max_abs_err"] for k, c in k11.items()
                if "rate" in k and ("float32" in k) == bool(tag)]
        kernels[name] = {
            "max_abs_err": max(errs), "ms": t["fwd"], "plain_ms": t["plain_fwd"],
            "library_ms": t["lib_fwd"], "bound_ms": row["fwd_bound"][0],
            "bound_by": row["fwd_bound"][1], "cases": {k: c for k, c in k11.items()
                                                        if ("float32" in k) == bool(tag)},
            "tolerance": ({"atol_per_rms": TOL_F32_ATOL, "rtol": TOL_F32_RTOL,
                           "rms": TOL_LAYER_RMS}
                          if tag else {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL,
                                       "rms": TOL_LAYER_RMS})}
        if tag:
            kernels[name]["library_tf32_ms"] = t["lib_tf32_fwd"]
    for name, tag in (("mha_train_bwd", ""), ("mha_train_bwd_f32", " float32")):
        # the backward alone, forward and backward less the forward, at both
        # timed shapes (the row: Sketchformer's encoder)
        cases = {}
        for what in ("Sketchformer encoder B=60", "flagship step E1 B=128"):
            row = k11[what + tag]
            t = row["times_ms"]
            cases[what] = {"B": row["B"], "S": row["S"], "ms": t["both"] - t["fwd"],
                           "plain_ms": t["plain_both"] - t["plain_fwd"],
                           "library_ms": t["lib_both"] - t["lib_fwd"],
                           "bound_ms": row["bwd_bound"][0], "bound_by": row["bwd_bound"][1]}
            if tag:
                cases[what]["library_tf32_ms"] = t["lib_tf32_both"] - t["lib_tf32_fwd"]
        kernels[name] = dict(
            cases["Sketchformer encoder B=60"], cases=cases,
            max_abs_err=max(max(*c["grad_rms"].values(), *c["grad_rms_plain_backward"].values())
                            for k, c in k11.items()
                            if "rate" in k and ("float32" in k) == bool(tag)),
            tolerance={"grad_rms": MHA_GRAD_RMS})
    for name in ("mha", "mha_f32", "mha_train_fwd", "mha_train_fwd_f32", "mha_train_bwd",
                 "mha_train_bwd_f32"):
        k = kernels[name]
        print(f"  {name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library "
              f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by {k['bound_by']}; "
              f"{k['ms'] / k['library_ms']:.3f} x the library call) on {card}")
    del k11_cases
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"attention ops phase: {out['phase_s']:.1f} s on {card}", flush=True)
    record["attention_ops"] = out
    return {"mha": 1, "mha_f32": 1,
            "mha_train_fwd": counted["mha_train_fwd"]["mha_train_fwd"],
            "mha_train_fwd_f32": counted["mha_train_fwd_f32"]["mha_train_fwd_f32"],
            "mha_train_bwd": counted["mha_train_fwd"]["mha_train_bwd"],
            "mha_train_bwd_f32": counted["mha_train_fwd_f32"]["mha_train_bwd_f32"]}


def recompute_phase(dev, card, kernels, record, reset_counts, read_counts,
                    library_layer) -> dict:
    """K4's recompute mode (``save_residuals=False``, the JAX op's default):
    its four entries (the short and the long form's forward and backward)
    against their plain versions at the paths' shapes, each output equal to
    the saved mode's to the bit, gradients bit-equal from run to run; then
    the training steps that reach it, with ``layer_vjp.SAVE_RESIDUALS_DEFAULT``
    off: (a) the flagship at B=60 (E1/D1 short form, E2/D2 on K7), (b) at
    B=128 (E2/D2 too, in float32), (c) Sketchformer at B=60 (long form), (d)
    the float32 flagship at B=60 (long form in float32). Each step counted
    (recompute launches alone, no plain version), gated against its plain
    path at dropout 0 with a control that must fail, timed in both modes
    (median of 20 after 3) with each mode's peak memory. Each entry timed
    beside its bound, its plain version, the saved mode and
    ``torch.utils.checkpoint`` around ``nn.TransformerEncoderLayer``
    (PyTorch's own recompute). Returns the launches of the counted steps that
    the kernels line reports ((b) for the short form, (c) for the long)."""
    from torch.utils.checkpoint import checkpoint

    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, load_model
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)
    t_phase = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    out: dict = {}
    no_launch = dict.fromkeys(read_counts(), 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    randn = lambda *shape: torch.randn(*shape, device=dev, generator=gen)  # noqa: E731
    cfg, cfg32 = gpu_fast(hierarchical_ordered()), hierarchical_ordered()

    def flagship(c, dropout):
        return load_model(CHECKPOINT, dataclasses.replace(c, dropout=dropout), device=dev)

    def flagship_batch(b):
        raw = generate_batch(np.random.default_rng(0), b, cfg.max_num_groups, cfg.max_seq_len)
        return {k: torch.from_numpy(raw[k]).to(dev) for k in ("commands", "args")}

    def sf_batch():
        raw = generate_batch(np.random.default_rng(0), B_RECIPE, sf.cfg.max_num_groups,
                             sf.cfg.max_seq_len)
        return {k: torch.from_numpy(raw[k]).to(dev)
                for k in ("commands_grouped", "args_grouped", "args_rel_grouped")}

    # ---- the paths' inputs
    model, model32, sf = flagship(cfg, 0.0), flagship(cfg32, 0.0), sketchformer_model(dev)
    batches = {b: flagship_batch(b) for b in (B_RECIPE, B_TRAIN)}
    sf_data = sf_batch()
    with torch.no_grad():
        e1 = {}
        for b, bt in batches.items():
            n_seq = b * cfg.max_num_groups
            c = bt["commands"].reshape(n_seq, -1)
            kp = key_padding_to_additive(M.key_padding_mask(c))
            x = model.encoder.embedding(c, bt["args"].reshape(n_seq, c.shape[1], -1))
            if b == B_TRAIN:
                # E2's input as the path makes it: E1's output pooled over
                # each path's tokens, with E2's position table
                memory = model.encoder.encoder(x, kp)
                pad = M.padding_mask(c)[..., None]
                pooled = (memory.float() * pad).sum(1) / pad.sum(1).clamp_min(1.0)
                x_e2 = model.encoder.hierarchical_PE(pooled.reshape(b, cfg.max_num_groups, -1))
            kp = kp.clone()
            kp[0] = float("-inf")                               # one fully masked sequence
            e1[b] = (x, kp)
        kp_e2 = key_padding_to_additive(~M.visibility_mask(batches[B_TRAIN]["commands"]))
        cmd_e, args_e = sf_data["commands_grouped"][:, 0], sf_data["args_grouped"][:, 0]
        cmd_d, args_d = cmd_e[:, :-1], sf_data["args_rel_grouped"][:, 0, :-1]
        x_sf = sf.encoder.embedding(cmd_e, args_e, M.group_mask(cmd_e))
        kp_sf = key_padding_to_additive(M.key_padding_mask(cmd_e))
        x_sfd = sf.decoder.embedding(cmd_d, args_d, M.group_mask(cmd_d))
        kp_sfd = key_padding_to_additive(M.key_padding_mask(cmd_d))
        l_sfd = sf.decoder.decoder.layers[0]
        sb_sfd = l_sfd.injection(0.5 * randn(B_RECIPE, sf.cfg.dim_z)).to(bf16)
    l_e1, l_e1_32 = model.encoder.encoder.layers[0], model32.encoder.encoder.layers[0]
    l_e2, l_sf = model.encoder.hierarchical_encoder.layers[0], sf.encoder.encoder.layers[0]

    # ---- each entry against its plain version at the paths' shapes
    short_cases = {
        "E1 B=60 (480 x 32) key pad": (l_e1, *e1[B_RECIPE], None, False, (0.0, DROPOUT)),
        "E1 B=128 (1,024 x 32) key pad": (l_e1, *e1[B_TRAIN], None, False, (DROPOUT,)),
        "E2 float32 B=128 (1,024 x 8), pooled E1 output, visibility mask":
            (l_e2, x_e2, kp_e2, None, False, (DROPOUT,))}
    long_cases = {
        "Sketchformer E1 (60 x 242) key pad": (l_sf, x_sf, kp_sf, None, False, (0.0, DROPOUT)),
        "Sketchformer decoder (60 x 241) causal seq_bias": (l_sfd, x_sfd, kp_sfd, sb_sfd, True,
                                                            (DROPOUT,)),
        "float32 E1 B=60 (480 x 32) key pad": (l_e1_32, e1[B_RECIPE][0].float(), e1[B_RECIPE][1],
                                               None, False, (DROPOUT,))}
    checks = {}
    for form, cases in (("short", short_cases), ("long", long_cases)):
        for what, (layer, x, mask, sb, causal, rates) in cases.items():
            for rate in rates:
                checks[form, f"{what} rate {rate}"] = check_layer_train(
                    layer_vjp, f"recompute {what}", layer, x, sb, mask, causal, rate,
                    save_residuals=False)
    for form, prefix in (("short", "layer_train_recompute"),
                         ("long", "layer_train_long_recompute")):
        cases = {k: v for (f_, k), v in checks.items() if f_ == form}
        grads = [r for v in cases.values() for r in v["grads"].values()]
        kernels[f"{prefix}_fwd"] = {
            "max_abs_err": max(v["forward_max_abs_err"] for v in cases.values()),
            "out_equals_saved_mode": all(v["out_equals_saved_mode"] for v in cases.values()),
            "tolerance": {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL, "rms": TOL_LAYER_RMS,
                          "float32": {"atol": TOL_F32_ATOL, "rtol": TOL_F32_RTOL}}}
        kernels[f"{prefix}_bwd"] = {
            "max_abs_err": max(r["max_abs_err"] for r in grads),
            "max_rms": max(r["rms"] for r in grads),
            "max_rms_same_gate": max(r["rms_same_gate"] for r in grads),
            "bit_identical_runs": all(v["grads_equal_on_rerun"] for v in cases.values()),
            "tolerance": {"rms": {str(k): v for k, v in TOL_GRAD_RMS.items()},
                          "rms_same_gate": {str(k): v for k, v in TOL_GRAD_RMS_SAME_GATE.items()},
                          "worst_of_max": TOL_GRAD_WORST,
                          "worst_of_max_same_gate": TOL_GRAD_WORST_SAME_GATE}}
    out["kernel_cases"] = {f"{form}: {k}": v for (form, k), v in checks.items()}
    print(f"K4 recompute mode: {len(checks)} cases, every output equal to the saved mode's to "
          f"the bit: {all(v['out_equals_saved_mode'] for v in checks.values())}; gradients "
          f"equal from run to run: {all(v['grads_equal_on_rerun'] for v in checks.values())}",
          flush=True)

    # ---- the steps, counted, gated, timed and read for memory in both modes
    def state_of(make_model, dropout):
        optimizer = make_optimizer(constant(LR))
        return create_train_state(make_model(dropout), optimizer, init=False), optimizer

    plain_fns = [(emb_ops, "embedding_reference"), (layer_vjp, "layer_train_reference"),
                 (stack_vjp, "layer_train_reference"), (ce_ops, "args_ce_reference"),
                 (ce_ops, "plain_args_ce")]

    @contextlib.contextmanager
    def mode(save: bool):
        saved = layer_vjp.SAVE_RESIDUALS_DEFAULT
        layer_vjp.SAVE_RESIDUALS_DEFAULT = save
        try:
            yield
        finally:
            layer_vjp.SAVE_RESIDUALS_DEFAULT = saved

    def step_case(what, make_model, batch, weights, model_args, dtype, expected, expected_saved,
                  saves, workspace):
        """One step's case; ``saves``: the bytes the saved mode keeps from
        the forward to the backward, ``workspace``: the recompute
        backward's largest one-layer workspace."""
        res = {"saved_bytes": saves, "workspace_bytes": workspace}
        state, optimizer = state_of(make_model, DROPOUT)
        step = lambda: train_step(state, batch, weights, optimizer, model_args)  # noqa: E731
        for save, want in ((False, expected), (True, expected_saved)):
            with mode(save):
                torch.cuda.synchronize()
                calls, restore = count_plain_calls(plain_fns)
                reset_counts()
                try:
                    step()
                    torch.cuda.synchronize()
                finally:
                    restore()
                got = read_counts()
            check(got == no_launch | want, f"recompute {what}, save_residuals={save}: launches "
                                           f"{got}, expected {want}")
            check(not any(calls.values()), f"recompute {what}: plain versions ran: {calls}")
            res["launches_saved" if save else "launches"] = got
        # both modes back to back on the same state: 3 steps, then 20 timed
        # (CUDA events, median), each mode's peak memory over its 20
        for save in (True, False):
            with mode(save):
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                events = []
                for _ in range(ITERS):
                    start, end = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                    start.record()
                    _, r = step()
                    end.record()
                    events.append((start, end))
                torch.cuda.synchronize()
                key = "saved" if save else "recompute"
                res[f"{key}_ms"] = statistics.median(a.elapsed_time(b) for a, b in events)
                res[f"{key}_peak_bytes"] = torch.cuda.max_memory_allocated()
                res[f"{key}_base_bytes"] = base
                check(np.isfinite(float(r["loss"])), f"recompute {what}: the loss is not finite")
                # the device's share, which a host-bound step time hides, and
                # K5's part of it (its forward, dy and dW kernels)
                busy, split = device_split(step, iters=3)
                res[f"{key}_device_busy_ms"] = busy
                res[f"{key}_k5_device_ms"] = sum(v for k, v in split.items()
                                                 if any(n in k for n in K5_KERNELS))
        del state, optimizer
        torch.cuda.empty_cache()
        drop = res["saved_peak_bytes"] - res["recompute_peak_bytes"]
        res["peak_drop_bytes"] = drop
        check_later(drop >= RC_MEMORY_SHARE * saves,
                    f"recompute {what}: peak memory {res['recompute_peak_bytes'] / 2**30:.3f} GiB "
                    f"against the saved mode's {res['saved_peak_bytes'] / 2**30:.3f}, a drop of "
                    f"{drop / 2**30:.3f} GiB, below {RC_MEMORY_SHARE} of the saves "
                    f"({saves / 2**30:.3f} GiB)")

        # the gate at dropout 0, the recompute kernel path against the plain
        # path, and the control
        def grads_of(control=False):
            st, opt = state_of(make_model, 0.0)
            layers = ([*st.model.encoder.encoder.layers, *st.model.decoder.decoder.layers]
                      if control else [])
            with contextlib.ExitStack() as cut:
                for layer in layers:
                    cut.enter_context(truncated_weights(layer, CONTROL_DROP_BITS))
                st, r = train_step(st, batch, weights, opt, model_args)
            names = [k for k, _ in st.model.named_parameters()]
            return r, dict(zip(names, [p.grad.detach().clone() for p in st.parameters()]))

        with mode(False):
            res_k, grads_k = grads_of()
            with plain_path(emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp):
                res_p, grads_p = grads_of()
                res_c, grads_c = grads_of(control=True)
        gate = step_against_plain(f"recompute {what}", res_k, grads_k, res_p, grads_p)
        ctrl = step_against_plain(f"recompute {what} control", res_c, grads_c, res_p, grads_p)
        del grads_k, grads_p, grads_c
        torch.cuda.empty_cache()
        lim_loss, lim_med = RC_STEP_LOSS[dtype], RC_STEP_MEDIAN_LEAF_RMS[dtype]
        check_later(gate["loss_rel_diff"] <= lim_loss and gate["median_leaf_rms"] <= lim_med
                    and gate["worst_leaf_rms"] <= TOL_STEP_LEAF_RMS,
                    f"recompute {what} gate: loss rel diff {gate['loss_rel_diff']} (limit "
                    f"{lim_loss}), median leaf {gate['median_leaf_rms']} (limit {lim_med}), "
                    f"worst leaf {gate['worst_leaf_rms']} (limit {TOL_STEP_LEAF_RMS})")
        check_later(ctrl["loss_rel_diff"] > lim_loss or ctrl["median_leaf_rms"] > lim_med,
                    f"recompute {what}: the gate passed its control {ctrl}")
        res.update(gate=gate, control=ctrl)
        print(f"recompute {what}: launches {res['launches']}, no plain version; "
              f"{res['recompute_ms']:.3f} ms/step against the saved mode's "
              f"{res['saved_ms']:.3f} (medians of {ITERS}); device busy "
              f"{res['recompute_device_busy_ms']} against {res['saved_device_busy_ms']} ms a step "
              f"(torch.profiler, 3 steps), K5's kernels {res['recompute_k5_device_ms']:.4f} and "
              f"{res['saved_k5_device_ms']:.4f} ms of it; peak memory "
              f"{res['recompute_peak_bytes'] / 2**30:.3f} GiB against "
              f"{res['saved_peak_bytes'] / 2**30:.3f} (a drop of {drop / 2**30:.3f} GiB; the "
              f"saved mode keeps {saves / 2**30:.3f} GiB, the largest workspace "
              f"{workspace / 2**30:.3f}; state and batch {res['saved_base_bytes'] / 2**30:.3f}); "
              f"gate at dropout 0 against the plain path: loss rel diff "
              f"{gate['loss_rel_diff']:.3g}, median leaf {gate['median_leaf_rms']:.3g}, worst "
              f"{gate['worst_leaf_rms']:.3g} ({gate['worst_leaf']}), cosine "
              f"{gate['cosine']:.6f}; control (the recompute-run layers less "
              f"{CONTROL_DROP_BITS} bits) {ctrl['loss_rel_diff']:.3g}, "
              f"{ctrl['median_leaf_rms']:.3g}, {ctrl['worst_leaf_rms']:.3g}, cosine "
              f"{ctrl['cosine']:.6f} on {card}",
              flush=True)
        return res

    d, f_ff, n_heads, g = cfg.d_model, cfg.dim_feedforward, cfg.n_heads, cfg.max_num_groups
    s_e1 = batches[B_RECIPE]["commands"].shape[-1]            # E1's S; D1's is one less

    def flagship_saves(b, es, e2_layers):
        """What the saved mode keeps in E1 and D1, 4 + 4 layers (and in E2
        and D2, float32, where they go layer by layer), of a flagship step at
        B=b with ``es`` bytes an activation; and the largest workspace."""
        saves = 4 * (k4_saved_bytes(b * g, s_e1, d, f_ff, n_heads, es)
                     + k4_saved_bytes(b * g, s_e1 - 1, d, f_ff, n_heads, es))
        if e2_layers:
            saves += 8 * k4_saved_bytes(b, g, d, f_ff, n_heads, 4)
        return saves, k4_workspace_bytes(b * g, s_e1, d, f_ff, es)

    short_launches = {"layer_train_recompute_fwd": 8, "layer_train_recompute_bwd": 8}
    steps = {}
    steps["a"] = step_case(
        f"(a) flagship B={B_RECIPE}", lambda d: flagship(cfg, d), batches[B_RECIPE],
        LOSS_WEIGHTS, MODEL_ARGS, bf16,
        {"embedding": 1, **short_launches, "stack_fwd": 2, "stack_bwd": 2, "args_ce_fwd": 1,
         "args_ce_bwd": 1, "embedding_bwd": 1},
        {"embedding": 1, "layer_train_fwd": 8, "layer_train_bwd": 8, "stack_fwd": 2,
         "stack_bwd": 2, "args_ce_fwd": 1, "args_ce_bwd": 1, "embedding_bwd": 1},
        *flagship_saves(B_RECIPE, 2, False))
    steps["b"] = step_case(
        f"(b) flagship B={B_TRAIN}", lambda d: flagship(cfg, d), batches[B_TRAIN],
        LOSS_WEIGHTS, MODEL_ARGS, bf16,
        {"embedding": 1, "layer_train_recompute_fwd": 16, "layer_train_recompute_bwd": 16,
         "args_ce_fwd": 1, "args_ce_bwd": 1, "embedding_bwd": 1},
        {"embedding": 1, "layer_train_fwd": 16, "layer_train_bwd": 16,
         "layer_train_fwd_f32": 4, "layer_train_bwd_f32": 4, "args_ce_fwd": 1,
         "args_ce_bwd": 1, "embedding_bwd": 1},
        *flagship_saves(B_TRAIN, 2, True))
    sf_shape = (sf.cfg.d_model, sf.cfg.dim_feedforward)
    sf_saves = 4 * sum(k4_saved_bytes(B_RECIPE, s_, *sf_shape, sf.cfg.n_heads, 2)
                       for s_ in (cmd_e.shape[1], cmd_d.shape[1]))
    steps["c"] = step_case(
        f"(c) Sketchformer B={B_RECIPE}", lambda d: sketchformer_model(dev, dropout=d).train(),
        sf_data, SF_WEIGHTS, sf.cfg.get_model_args(), bf16,
        {"embedding": 2, "layer_train_long_recompute_fwd": 8,
         "layer_train_long_recompute_bwd": 8, "args_ce_fwd": 1, "args_ce_bwd": 1,
         "embedding_bwd": 2},
        {"embedding": 2, "layer_train_long_fwd": 8, "layer_train_long_bwd": 8, "args_ce_fwd": 1,
         "args_ce_bwd": 1, "embedding_bwd": 2},
        sf_saves, k4_workspace_bytes(B_RECIPE, cmd_e.shape[1], *sf_shape, 2))
    steps["d"] = step_case(
        f"(d) float32 flagship B={B_RECIPE}", lambda d: flagship(cfg32, d), batches[B_RECIPE],
        LOSS_WEIGHTS, MODEL_ARGS, f32,
        {"embedding_f32": 1, "layer_train_long_recompute_fwd": 8,
         "layer_train_long_recompute_bwd": 8, "stack_fwd": 2, "stack_bwd": 2,
         "args_ce_fwd_f32": 1, "args_ce_bwd_f32": 1, "embedding_bwd": 1},
        {"embedding_f32": 1, "layer_train_long_fwd_f32": 8, "layer_train_long_bwd_f32": 8,
         "stack_fwd": 2, "stack_bwd": 2, "args_ce_fwd_f32": 1, "args_ce_bwd_f32": 1,
         "embedding_bwd": 1},
        *flagship_saves(B_RECIPE, 4, False))
    out["steps"] = steps
    del model, model32
    torch.cuda.empty_cache()

    # ---- each entry timed: the short form at E1 B=128, the long form at
    # Sketchformer's E1, beside the saved mode, the plain version, the bound
    # and PyTorch's own recompute (torch.utils.checkpoint around
    # nn.TransformerEncoderLayer in training mode, rate 0)
    times = {}
    for prefix, (layer, x, mask) in (
            ("layer_train_recompute", (l_e1, *e1[B_TRAIN])),
            ("layer_train_long_recompute", (l_sf, x_sf, kp_sf))):
        rc, sv = ([cuda_ms(f) for f in k4_runs(layer_vjp.fused_layer_train, layer, x, None, mask,
                                              save_residuals=save, gen=gen)]
                  for save in (False, True))
        pl = [cuda_ms(f, iters=5, warmup=1)
              for f in k4_runs(layer_vjp.plain_layer_train, layer, x, None, mask, gen=gen)]
        lib = library_layer(layer, x.dtype, train=True)
        x_lib = x.detach().requires_grad_()
        g_lib = torch.randn(x.shape, device=dev, generator=gen).to(x.dtype)
        pad = torch.isinf(mask)

        def lib_fwd():
            with torch.no_grad():
                return lib(x_lib, src_key_padding_mask=pad)

        def lib_both():
            y = checkpoint(lib, x_lib, None, pad, use_reentrant=False)
            return torch.autograd.grad(y, [x_lib, *lib.parameters()], g_lib)
        lf_ms, lfb_ms = cuda_ms(lib_fwd), cuda_ms(lib_both)
        f_ff_l = layer.ff1.out_features
        bf_ms, bf_by = k4_bound(x, None, f_ff_l, False)
        bb_ms, bb_by = k4_bound(x, None, f_ff_l, True, recompute=True)
        kernels[f"{prefix}_fwd"].update(ms=rc[0], plain_ms=pl[0], library_ms=lf_ms,
                                        bound_ms=bf_ms, bound_by=bf_by)
        kernels[f"{prefix}_bwd"].update(ms=rc[1] - rc[0], plain_ms=pl[1] - pl[0],
                                        library_ms=lfb_ms - lf_ms, bound_ms=bb_ms,
                                        bound_by=bb_by)
        times[prefix] = {"shape": list(x.shape), "fwd_ms": rc[0], "bwd_ms": rc[1] - rc[0],
                         "saved_fwd_ms": sv[0], "saved_bwd_ms": sv[1] - sv[0],
                         "plain_fwd_ms": pl[0], "plain_bwd_ms": pl[1] - pl[0],
                         "library_fwd_ms": lf_ms, "library_bwd_ms": lfb_ms - lf_ms,
                         "fwd_bound_ms": bf_ms, "bwd_bound_ms": bb_ms}
        print(f"  {prefix} {tuple(x.shape[:2])}: forward {rc[0]:.4f} ms (saved mode "
              f"{sv[0]:.4f}, plain {pl[0]:.4f}, library {lf_ms:.4f}, bound {bf_ms:.4f} by "
              f"{bf_by}), backward {rc[1] - rc[0]:.4f} ms (saved mode {sv[1] - sv[0]:.4f}, "
              f"plain {pl[1] - pl[0]:.4f}, checkpointed library {lfb_ms - lf_ms:.4f}, bound "
              f"{bb_ms:.4f} by {bb_by}) on {card}", flush=True)
    out["times"] = times
    del sf
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"recompute phase: {out['phase_s']:.1f} s on {card}", flush=True)
    record["recompute"] = out
    return {**{k: steps["b"]["launches"][k] for k in ("layer_train_recompute_fwd",
                                                       "layer_train_recompute_bwd")},
            **{k: steps["c"]["launches"][k] for k in ("layer_train_long_recompute_fwd",
                                                       "layer_train_long_recompute_bwd")}}


def variant_model(name: str, dev, compute_dtype: str | None = None, dropout: float | None = None,
                  seed: int = VARIANT_SEED):
    """The port's model of ``configs/<name>.py`` (its config under
    ``gpu_fast``, at ``compute_dtype`` and ``dropout`` if given) at full
    width, initialised by ``init_parameters`` from a seeded generator: no
    trained checkpoint of the one-stage or the fonts model exists. The
    masters do not depend on ``compute_dtype``."""
    import importlib

    from deepsvg_tpu_torch.models import SVGTransformer
    from deepsvg_tpu_torch.training.trainer import init_parameters
    cfg = importlib.import_module(f"deepsvg_tpu_torch.configs.{name}").make_model_config()
    if dropout is not None:
        cfg = dataclasses.replace(cfg, dropout=dropout)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = SVGTransformer(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def variants_phase(dev, card, record, reset_counts, read_counts) -> dict:
    """The one-stage one-shot model (bfloat16, then float32) and the
    label-conditioned fonts model on the card, with random weights from
    VARIANT_SEED: each path counted with no plain version called, each
    kernel against its plain version at the path's shapes (the long K2 at
    D1's S=241, not causal, with ``seq_bias``; K3 at R = N x 241; K7 with
    the label's injections), kernel path against plain path with a control,
    the steps at B=60, the CLI, and temperature sampling on the fonts model
    and on Sketchformer's (K9). Returns the launches of the counted runs."""
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import DropoutRng, greedy_sample, one_shot_sample
    from deepsvg_tpu_torch.models import sample as sample_mod
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import decode as decode_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)
    t_phase = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    out: dict = {}
    launches: dict = {}
    no_launch = dict.fromkeys(read_counts(), 0)
    plain_fns = [(emb_ops, "embedding_reference"), (layer_ops, "layer_reference"),
                 (head_ops, "head_argmax_reference"), (decode_ops, "decode_step_reference"),
                 (layer_vjp, "layer_train_reference"), (stack_vjp, "layer_train_reference"),
                 (ce_ops, "args_ce_reference")]
    ops = (emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp)

    def counted(what, fn, expected):
        """``fn()`` once, counted, with the plain versions spied."""
        torch.cuda.synchronize()
        calls, restore = count_plain_calls(plain_fns)
        reset_counts()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            restore()
        got = read_counts()
        print(f"{what}: launches {got}; plain versions called {calls}", flush=True)
        check(got == no_launch | expected, f"{what}: launches {got}, expected {expected}")
        check(not any(calls.values()), f"{what}: plain versions ran: {calls}")
        launches[what] = {k: v for k, v in got.items() if v}
        return res

    def walls(what, fn, iters=5):
        """Median wall (CUDA events) of ``fn``, its device busy time under
        the profiler and the idle share."""
        ms = cuda_median_ms(fn, iters=iters, warmup=1)
        busy, split = device_split(fn, iters=3)
        row = {"median_ms": ms, "device_busy_ms": busy,
               "idle_share": None if not busy else 1 - busy / ms,
               "top": sorted(split.items(), key=lambda kv: -kv[1])[:8]}
        print(f"{what}: {ms:.3f} ms median of {iters}, device busy {busy} ms, idle share "
              f"{'not measured' if not busy else round(1 - busy / ms, 4)} on {card}", flush=True)
        return row

    def step_gate(what, make_model, batch, weights, model_args, cut_layers, dtype):
        """One step at dropout 0, kernel path against plain path, with the
        recompute phase's gate; the control (the plain path with the layers
        ``cut_layers(model)`` cut by CONTROL_DROP_BITS) must fail it."""
        def grads_of(control=False):
            opt = make_optimizer(constant(LR))
            st = create_train_state(make_model(0.0), opt, init=False)
            with contextlib.ExitStack() as cut:
                for layer in (cut_layers(st.model) if control else []):
                    cut.enter_context(truncated_weights(layer, CONTROL_DROP_BITS))
                st, r = train_step(st, batch, weights, opt, model_args)
            names = [k for k, _ in st.model.named_parameters()]
            return r, dict(zip(names, [p.grad.detach().clone() for p in st.parameters()]))
        res_k, grads_k = grads_of()
        with plain_path(emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp):
            res_p, grads_p = grads_of()
            res_c, grads_c = grads_of(control=True)
        gate = step_against_plain(what, res_k, grads_k, res_p, grads_p)
        ctrl = step_against_plain(f"{what} control", res_c, grads_c, res_p, grads_p)
        glob2 = {k: rel_rms(grads_k[k], grads_p[k]) for k in grads_p if "glob2" in k}
        del grads_k, grads_p, grads_c
        torch.cuda.empty_cache()
        lim_loss, lim_med = RC_STEP_LOSS[dtype], RC_STEP_MEDIAN_LEAF_RMS[dtype]
        print(f"{what} at dropout 0, kernel vs plain path: {gate}; control: {ctrl}"
              + (f"; glob2 leaves' relative RMS at most {max(glob2.values()):.3g}"
                 if glob2 else ""), flush=True)
        check_later(gate["loss_rel_diff"] <= lim_loss and gate["median_leaf_rms"] <= lim_med
                    and gate["worst_leaf_rms"] <= TOL_STEP_LEAF_RMS,
                    f"{what} gate: loss rel diff {gate['loss_rel_diff']} (limit {lim_loss}), "
                    f"median leaf {gate['median_leaf_rms']} (limit {lim_med}), worst leaf "
                    f"{gate['worst_leaf_rms']} (limit {TOL_STEP_LEAF_RMS})")
        check(ctrl["loss_rel_diff"] > lim_loss or ctrl["median_leaf_rms"] > lim_med,
              f"{what}: the gate passed its control {ctrl}")
        return {"gate": gate, "control": ctrl, "glob2_rms": glob2}

    def step_run(what, make_model, batch, weights, model_args, expected):
        """The step at dropout 0.1 counted, then timed (CUDA events, median of
        ITERS after 3; the host clock over 10 to a synchronize; device busy
        under the profiler)."""
        optimizer = make_optimizer(constant(LR))
        state = create_train_state(make_model(DROPOUT), optimizer, init=False)
        _, res = counted(what, lambda: train_step(state, batch, weights, optimizer, model_args),
                         expected)

        def one_step():
            return train_step(state, batch, weights, optimizer, model_args)
        ms = cuda_median_ms(one_step, iters=ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            _, r = one_step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        busy, split = device_split(one_step, iters=3)
        check(all(bool(torch.isfinite(v)) for v in r.values()), f"{what}: a loss is not finite")
        row = {"B": B_RECIPE, "median_ms": ms, "host_mean_ms_per_step": host_ms,
               "device_busy_ms_per_step": busy,
               "idle_share": None if not busy else 1 - busy / host_ms,
               "launches": launches[what], "losses": {k: float(v) for k, v in r.items()},
               "top": sorted(split.items(), key=lambda kv: -kv[1])[:10]}
        print(f"{what} dropout {DROPOUT}: {ms:.3f} ms/step median of {ITERS} (host clock "
              f"{host_ms:.3f} ms/step mean of 10), device busy {busy} ms per step, idle share "
              f"{'not measured' if not busy else round(1 - busy / host_ms, 4)} on {card}",
              flush=True)
        del state, optimizer
        torch.cuda.empty_cache()
        return row

    def sample_checks(c, a, n, cfg):
        s_dec = cfg.max_total_len + 1 if cfg.decode_stages == 1 else cfg.max_seq_len + 1
        groups = 1 if cfg.decode_stages == 1 else cfg.max_num_groups
        return check_sample(c, a, n, cfg, groups, s_dec)

    # ======================= (1) one-stage one-shot, bfloat16 then float32
    ob = generate_batch(np.random.default_rng(0), N_MAIN, 8, 30)
    oc = torch.from_numpy(ob["commands_grouped"]).to(dev)              # [N, 1, 242]
    oa = torch.from_numpy(ob["args_grouped"]).to(dev)
    os_args = ["commands_grouped", "args_grouped"] * 2
    os_batch = {k: torch.from_numpy(ob[k][:B_RECIPE]).to(dev)
                for k in ("commands_grouped", "args_grouped")}
    one_stage: dict = {}
    gen = torch.Generator(device=dev).manual_seed(19)
    for dt, tag in ((bf16, ""), (f32, "_f32")):
        dname = "bfloat16" if dt == bf16 else "float32"
        model = variant_model("one_stage_one_shot", dev, dname)
        cfg = model.cfg
        dt = getattr(torch, cfg.compute_dtype)
        enc, dec, fcn = model.encoder, model.decoder, model.decoder.fcn
        res: dict = {}
        with torch.no_grad():
            c_o, a_o = counted(
                f"one-stage one_shot_sample {dname} N={N_MAIN}",
                lambda: one_shot_sample(model, oc, oa),
                {f"embedding{tag}": 1, f"layer_long{tag}": 2 * cfg.n_layers, f"head{tag}": 1})
            res["valid_share"] = sample_checks(c_o, a_o, N_MAIN, cfg)
            res["inference"] = walls(f"one-stage one_shot_sample {dname} N={N_MAIN}",
                                     lambda: one_shot_sample(model, oc, oa))
            # each kernel against its plain version on the path's operands
            cmd_f, args_f = oc[:, 0], oa[:, 0]
            cmd_table, arg_tables, pos_table = enc.embedding.tables()
            e_in = (cmd_f, args_f, M.group_mask(cmd_f), cmd_table, arg_tables,
                    enc.embedding.group_table(), pos_table[:cmd_f.shape[1]], True)
            x_e1 = emb_ops.fused_embedding(*e_in)
            k1_err = (x_e1.float() - emb_ops.embedding_reference(*e_in).float()).abs().max()
            k1_err = k1_err.item()
            k1_tol = TOL_EMBED if dt == bf16 else TOL_EMBED_F32 * x_e1.abs().max().item()
            check_later(k1_err <= k1_tol, f"K1 one-stage {dname}: max abs err {k1_err}")
            z, _, _ = model.encode(oc, oa, rng=DropoutRng.fixed())
            l_e, l_d = enc.encoder.layers[0], dec.decoder.layers[0]
            x_d1 = dec.embedding(N_MAIN)                                    # [N, 241, D]
            sb_d1 = l_d.injection(z).to(dt)
            kp_e1 = key_padding_to_additive(M.key_padding_mask(cmd_f))
            zero_d1 = torch.zeros(x_d1.shape[:2], device=dev)
            atol, rtol = (TOL_LAYER_ATOL, TOL_LAYER_RTOL) if dt == bf16 else (TOL_F32_ATOL,
                                                                             TOL_F32_RTOL)
            cases = {"E1 S=242 key pad": layer_args(l_e, x_e1, kp_e1),
                     "D1 S=241 not causal, seq_bias": layer_args(l_d, x_d1, zero_d1, sb_d1)}
            k2 = {w: compare_elementwise(f"K2 long {dname} one-stage {w}",
                                         layer_ops.fused_layer(*la),
                                         layer_ops.layer_reference(*la), TOL_LAYER_RMS, atol,
                                         rtol)
                  for w, la in cases.items()}
            # the D1 layer per launch, beside nn.TransformerEncoderLayer on the
            # same rows (no seq_bias: the same products and attention)
            la = cases["D1 S=241 not causal, seq_bias"]
            b_ms, b_by = layer_cost(la)
            lib = transformer_layer(l_d, dt, dev)
            with matmul_tf32(dt == f32):
                lib_ms = cuda_ms(lambda: lib(x_d1))
            k2["D1 S=241 not causal, seq_bias"].update(
                ms=cuda_ms(lambda: layer_ops.fused_layer(*la)),
                plain_ms=cuda_ms(lambda: layer_ops.layer_reference(*la), iters=3, warmup=1),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            del lib
            # K3 at R = N x 241 on D1's output
            y = dec.decoder(x_d1, z).reshape(-1, cfg.d_model).contiguous()
            head_in = (y, fcn.w_packed, fcn.b_packed, cfg.n_commands, cfg.n_args, fcn.args_dim)
            ids_k = head_ops.fused_head_argmax(*head_in).long()
            ids_p = head_ops.head_argmax_reference(*head_in).long()
            differ = ids_k != ids_p
            wide = slot_margins(y, fcn) >= TOL_HEAD_MARGIN
            check_later(not bool((differ & wide).any()),
                        f"K3 {dname} at R={y.shape[0]}: ids differ where the top-2 gap >= "
                        f"{TOL_HEAD_MARGIN}")
            r, d = y.shape
            n_cls = fcn.n_commands + fcn.n_args * fcn.args_dim
            es = y.element_size()
            hb_ms, hb_by = bound(nbytes(y) + n_cls * d * es + n_cls * es
                                 + r * (1 + fcn.n_args) * 4, 2.0 * r * d * n_cls,
                                 PEAK_BF16 if dt == bf16 else PEAK_TF32)
            with matmul_tf32(dt == f32):
                head_lib_ms = cuda_ms(head_library(head_in, head_slots(fcn)))
            k3 = {"R": r, "ids_differing": int(differ.sum()), "of": differ.numel(),
                  "ms": cuda_ms(lambda: head_ops.fused_head_argmax(*head_in)),
                  "plain_ms": cuda_ms(lambda: head_ops.head_argmax_reference(*head_in),
                                      iters=3, warmup=1),
                  "library_ms": head_lib_ms, "bound_ms": hb_ms, "bound_by": hb_by}
            print(f"K3 {dname} one-stage R={r}: {k3['ids_differing']} of {k3['of']} ids differ, "
                  f"all where the top-2 gap < {TOL_HEAD_MARGIN}; {k3['ms']:.4f} ms (plain "
                  f"{k3['plain_ms']:.4f}, library {head_lib_ms:.4f}, bound {hb_ms:.4f} by "
                  f"{hb_by}); K2 long D1 {k2['D1 S=241 not causal, seq_bias']['ms']:.4f} ms "
                  f"(plain {k2['D1 S=241 not causal, seq_bias']['plain_ms']:.4f}, library "
                  f"{lib_ms:.4f}, bound {b_ms:.4f} by {b_by}); K1 max abs err {k1_err:.3g} on "
                  f"{card}", flush=True)
            res.update(k1_max_abs_err=k1_err, k2=k2, k3=k3)
            del y, head_in, ids_k, ids_p, differ, wide, x_e1, cases, la
            # kernel path against plain path at N=64, and the control
            layers = list(dec.decoder.layers)
            res["gate"] = path_gate(f"one-stage {dname} N={N_AR_GATE}", model, ops,
                                    lambda: cut_layers(layers, AR_CONTROL_DROP_BITS),
                                    commands=oc[:N_AR_GATE], args=oa[:N_AR_GATE])
        # the long K4 at D1's shape, S=241, not causal, with seq_bias (B=60)
        res["k4_d1"] = k4_long_row(layer_vjp, l_d, x_d1[:B_RECIPE], sb_d1[:B_RECIPE],
                                   zero_d1[:B_RECIPE], False, gen)
        k4 = res["k4_d1"]
        print(f"  long K4 {dname} one-stage D1 B={B_RECIPE} S=241 not causal, seq_bias: forward "
              f"{k4['fwd_ms']:.4f} ms (device {k4['device_fwd_ms']}, plain "
              f"{k4['plain_fwd_ms']:.4f}, bound {k4['fwd_bound_ms']:.4f}), backward "
              f"{k4['bwd_ms']:.4f} (device {k4['device_bwd_ms']}, plain {k4['plain_bwd_ms']:.4f}, "
              f"bound {k4['bwd_bound_ms']:.4f}) on {card}", flush=True)
        del model, z, x_d1, sb_d1, zero_d1
        torch.cuda.empty_cache()

        # the training step at B=60, counted and timed, then gated
        def make_model(dropout, dname=dname):
            return variant_model("one_stage_one_shot", dev, dname, dropout)
        step_expected = {f"embedding{tag}": 1, f"layer_train_long_fwd{tag}": 8,
                         f"layer_train_long_bwd{tag}": 8, f"args_ce_fwd{tag}": 1,
                         f"args_ce_bwd{tag}": 1, "embedding_bwd": 1}
        res["step"] = step_run(f"one-stage train_step {dname} B={B_RECIPE}", make_model,
                               os_batch, SF_WEIGHTS, os_args, step_expected)
        check("loss_visibility" not in res["step"]["losses"],
              "the one-stage loss has a visibility term")
        res["step"].update(step_gate(
            f"one-stage step {dname} B={B_RECIPE}", make_model, os_batch, SF_WEIGHTS, os_args,
            lambda m: [*m.encoder.encoder.layers, *m.decoder.decoder.layers], dt))
        if dt == bf16:
            res["cli"] = run_cli(dev, reset_counts, read_counts, no_launch | step_expected,
                                 "one_stage_one_shot", timing=False)
        one_stage[dname] = res
    out["one_stage"] = one_stage

    # ================================== (2) the label-conditioned fonts model
    fb = generate_batch(np.random.default_rng(0), N_MAIN, 8, 30, label_range=N_LABELS_FONTS)
    fc = torch.from_numpy(fb["commands"]).to(dev)
    fa = torch.from_numpy(fb["args"]).to(dev)
    fl = torch.from_numpy(fb["label"]).to(dev)
    fonts: dict = {}
    model = variant_model("hierarchical_ordered_fonts", dev)
    cfg = model.cfg
    enc, dec = model.encoder, model.decoder
    g, d_model = cfg.max_num_groups, cfg.d_model
    with torch.no_grad():
        c_f, a_f = counted(f"fonts one_shot_sample N={N_MAIN}",
                           lambda: one_shot_sample(model, fc, fa, label=fl),
                           {"embedding": 1, "layer": 12, "layer_f32": 4, "head": 1})
        fonts["valid_share"] = sample_checks(c_f, a_f, N_MAIN, cfg)
        other = one_shot_sample(model, fc[:64], fa[:64], label=(fl[:64] + 1) % N_LABELS_FONTS)
        check(not (torch.equal(other[0], c_f[:64]) and torch.equal(other[1], a_f[:64])),
              "the fonts model decodes the same icons under other labels")
        fonts["inference"] = walls(f"fonts one_shot_sample N={N_MAIN}",
                                   lambda: one_shot_sample(model, fc, fa, label=fl))
        layers = list(dec.decoder.layers)
        fonts["gate"] = path_gate(f"fonts N={N_AR_GATE}", model, ops,
                                  lambda: cut_layers(layers, AR_CONTROL_DROP_BITS),
                                  hold_logits=False, commands=fc[:N_AR_GATE],
                                  args=fa[:N_AR_GATE], label=fl[:N_AR_GATE])

        # temperature sampling: at SAMPLE_LOW_T the greedy ids wherever the
        # greedy margin is at least AR_MARGIN; at 1, valid draws
        x_g, _, _ = decoder_states(model, fc, fa, fl)
        margins = slot_margins(x_g, dec.fcn).reshape(N_MAIN, g, cfg.max_seq_len + 1, -1)
        del x_g
        sampled = {}
        for t in (SAMPLE_LOW_T, 1.0):
            gen_t = torch.Generator(device=dev).manual_seed(23)
            sampled[t] = counted(
                f"fonts greedy_sample with a generator at temperature {t} N={N_MAIN}",
                lambda gen_t=gen_t, t=t: greedy_sample(model, fc, fa, label=fl, temperature=t,
                                                       generator=gen_t),
                {"embedding": 1, "layer": 12, "layer_f32": 4})
            sample_checks(*sampled[t], N_MAIN, cfg)
        wide = position_margin(margins, c_f) >= AR_MARGIN
        same = (sampled[SAMPLE_LOW_T][0] == c_f) & (sampled[SAMPLE_LOW_T][1] == a_f).all(-1)
        low_agree = same[wide].float().mean().item()
        hot_same = (sampled[1.0][0] == c_f).float().mean().item()
        print(f"fonts temperature {SAMPLE_LOW_T}: equal to the greedy sample on {low_agree:.5f} "
              f"of the {int(wide.sum())} positions with greedy margin >= {AR_MARGIN}; "
              f"temperature 1: commands equal to the greedy ones on {hot_same:.4f}",
              flush=True)
        check_later(low_agree == 1.0, f"fonts draws at {SAMPLE_LOW_T} differ from the greedy "
                                      f"ids above the margin: {low_agree}")
        check(hot_same < 1.0, "fonts draws at temperature 1 equal the greedy sample")
        fonts["sampling"] = {"low_t_agreement": low_agree, "positions": int(wide.sum()),
                             "t1_commands_equal_greedy": hot_same}
        del sampled, margins, same, wide, c_f, a_f, other

    # K7 against its plain version with the label's injections: E2 (the
    # label's alone, non-zero) and D2 (z's plus the label's), B=60, rates 0
    # and 0.1, bfloat16 and float32 (the same masters), over K7_DRAWS draws
    model32 = variant_model("hierarchical_ordered_fonts", dev, "float32")

    def fonts_draw(stage, m):
        e, dd = m.encoder, m.decoder

        def draw(gen_d):
            with torch.no_grad():
                lab = torch.randint(0, N_LABELS_FONTS, (B_RECIPE,), device=dev, generator=gen_d)
                if stage == "E2":
                    le = e.label_embedding(lab)
                    x = e.hierarchical_PE(torch.randn(B_RECIPE, g, d_model, device=dev,
                                                      generator=gen_d))
                    visible = torch.randint(1, g + 1, (B_RECIPE, 1), device=dev, generator=gen_d)
                    mask = torch.where(torch.arange(g, device=dev)[None] < visible, 0.0,
                                       float("-inf"))
                    mask[0] = float("-inf")                       # one fully masked sequence
                    biases = torch.stack([lay.label_injection(le)
                                          for lay in e.hierarchical_encoder.layers])
                    return x, biases, mask
                le = dd.label_embedding(lab)
                zz = 0.5 * torch.randn(B_RECIPE, cfg.dim_z, device=dev, generator=gen_d)
                biases = torch.stack([lay.injection(zz) + lay.label_injection(le)
                                      for lay in dd.hierarchical_decoder.layers])
                return (dd.hierarchical_embedding(B_RECIPE), biases,
                        torch.zeros(B_RECIPE, g, device=dev))
        return draw
    k7 = {}
    for m, dname in ((model, "bfloat16"), (model32, "float32")):
        for stage, layers in (("E2", list(m.encoder.hierarchical_encoder.layers)),
                              ("D2", list(m.decoder.hierarchical_decoder.layers))):
            for rate in (0.0, DROPOUT):
                k7[f"{stage} {dname} B={B_RECIPE} rate {rate}"] = check_stack_train(
                    stack_vjp, layer_vjp, f"fonts {stage} {dname} B={B_RECIPE} labels",
                    layers, fonts_draw(stage, m), rate, outliers_aligned=True)
    fonts["k7"] = {k: {"worst": v["worst"], "forward_max_abs_err": v["forward_max_abs_err"]}
                   for k, v in k7.items()}
    del model32, k7

    # the step at B=60, counted, timed and gated; the CLI with a resume
    f_batch = {"commands": fc[:B_RECIPE], "args": fa[:B_RECIPE], "label": fl[:B_RECIPE]}
    f_args = cfg.get_model_args()

    def fonts_model(dropout):
        return variant_model("hierarchical_ordered_fonts", dev, None, dropout)
    fonts_expected = {"embedding": 1, "layer_train_fwd": 8, "layer_train_bwd": 8,
                      "stack_fwd": 2, "stack_bwd": 2, "args_ce_fwd": 1, "args_ce_bwd": 1,
                      "embedding_bwd": 1}
    fonts["step"] = step_run(f"fonts train_step B={B_RECIPE}", fonts_model, f_batch, SF_WEIGHTS,
                             f_args, fonts_expected)
    fonts["step"].update(step_gate(
        f"fonts step B={B_RECIPE}", fonts_model, f_batch, SF_WEIGHTS, f_args,
        lambda m: [*m.encoder.encoder.layers, *m.decoder.decoder.layers], bf16))
    fonts["cli"] = run_cli(dev, reset_counts, read_counts, no_launch | fonts_expected,
                           "hierarchical_ordered_fonts", timing=False)
    del model
    torch.cuda.empty_cache()
    out["fonts"] = fonts

    # ==================== (3) Sketchformer's decode with a generator (K9)
    sf = sketchformer_model(dev)
    sb = generate_batch(np.random.default_rng(0), N_MAIN, 8, 30)
    sc = torch.from_numpy(sb["commands_grouped"]).to(dev)
    sa = torch.from_numpy(sb["args_grouped"]).to(dev)
    steps = sf.cfg.max_total_len
    with torch.no_grad():
        z, _, _ = sf.encode(sc, sa, rng=DropoutRng.fixed())
        greedy, raw_c, _, states = traced_decode(sf, z, sample_mod)
        margin = position_margin(slot_margins(states, sf.decoder.fcn), raw_c.t()).t()
        del states
        drawn = {}
        for t in (SAMPLE_LOW_T, 1.0):
            gen_t = torch.Generator(device=dev).manual_seed(29)
            drawn[t] = counted(
                f"Sketchformer greedy_sample with a generator at temperature {t} N={N_MAIN}",
                lambda gen_t=gen_t, t=t: greedy_sample(sf, sc, sa, temperature=t,
                                                       generator=gen_t),
                {"embedding": 1, "layer_long": 4, "decode": steps})
            c_t, a_t = drawn[t]
            used = M.cmd_args_mask(dev, torch.bool)[c_t.long()]
            check(tuple(c_t.shape) == (N_MAIN, 1, steps) and int(c_t.min()) >= 0
                  and int(c_t.max()) < sf.cfg.n_commands and bool(torch.isfinite(a_t).all())
                  and bool((a_t[~used] == -1).all()),
                  f"Sketchformer draws at temperature {t}: shapes or ranges")
        agree, compared = prefix_gate(drawn[SAMPLE_LOW_T], greedy, margin, AR_MARGIN)
        hot_same = (drawn[1.0][0] == greedy[0]).float().mean().item()
        print(f"Sketchformer temperature {SAMPLE_LOW_T}: {agree:.4f} of the sequences equal to "
              f"the greedy decode before their first position with margin < {AR_MARGIN} "
              f"({compared} positions compared); temperature 1: commands equal to the greedy "
              f"ones on {hot_same:.4f}", flush=True)
        check_later(agree == 1.0, f"Sketchformer draws at {SAMPLE_LOW_T} differ from the greedy "
                                  f"decode before the margin gate: {agree}")
        check(compared >= N_AR_GATE, f"only {compared} positions cleared the margin")
        check(hot_same < 1.0, "Sketchformer draws at temperature 1 equal the greedy decode")
        out["sketchformer_sampling"] = {
            "low_t_agreement": agree, "positions_compared": compared,
            "t1_commands_equal_greedy": hot_same,
            "t1": walls(f"Sketchformer greedy_sample at temperature 1 N={N_MAIN}",
                        lambda: greedy_sample(sf, sc, sa, temperature=1.0,
                                              generator=torch.Generator(device=dev)
                                              .manual_seed(31)), iters=3)}
    del sf, z, greedy, drawn, margin
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"variants phase: {out['phase_s']:.1f} s", flush=True)
    record["variants"] = out
    return launches


@contextlib.contextmanager
def cut_layers(layers, drop_bits: int):
    """:func:`truncated_weights` on every layer of ``layers`` inside the
    block."""
    with contextlib.ExitStack() as cut:
        for layer in layers:
            cut.enter_context(truncated_weights(layer, drop_bits))
        yield


@contextlib.contextmanager
def cut_params(params, keep_bits: int):
    """The float32 ``params`` cut to ``keep_bits`` mantissa bits inside the
    block (a control for paths with no transformer layer to cut)."""
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.copy_(cut_mantissa(p, keep_bits))
    try:
        yield
    finally:
        with torch.no_grad():
            for p, orig in zip(params, saved):
                p.copy_(orig)


def path_gate(what, model, ops, control, hold_logits=True, limit=AR_LOGIT_LIMIT,
              **inputs) -> dict:
    """Kernel path against plain path on the states the heads read
    (:func:`decoder_states` with ``inputs``): every id whose plain top-2
    margin is at least AR_MARGIN equal, and, with ``hold_logits``, the
    largest logit difference within ``limit``; the control (the plain path
    inside ``control()``) must fail the logit limit, or without
    ``hold_logits`` the ids' gate."""
    fcn = model.decoder.fcn
    w = fcn.w_packed.float()
    x_k, ids_k, _ = decoder_states(model, **inputs)
    with plain_path(*ops):
        x_p, ids_p, _ = decoder_states(model, **inputs)
        with control():
            x_c, ids_c, _ = decoder_states(model, **inputs)
    wide = slot_margins(x_p, fcn) >= AR_MARGIN
    agree = (ids_k == ids_p)[wide].float().mean().item()
    agree_c = (ids_c == ids_p)[wide].float().mean().item()
    gap = ((x_k.float() - x_p.float()) @ w.t()).abs().max().item()
    gap_c = ((x_c.float() - x_p.float()) @ w.t()).abs().max().item()
    print(f"{what} kernel vs plain path: ids equal on {agree:.5f} of the {int(wide.sum())} slots "
          f"with plain margin >= {AR_MARGIN} (of {wide.numel()}); largest logit difference "
          f"{gap:.3g} (limit {limit}{'' if hold_logits else ', read'}); control: ids "
          f"{agree_c:.5f}, logits {gap_c:.3g}", flush=True)
    check_later(agree == 1.0, f"{what}: ids differ above the margin: {agree}")
    if hold_logits:
        check_later(gap <= limit, f"{what}: logits differ by {gap} (limit {limit})")
    check_later(gap_c > limit if hold_logits else agree_c < 1.0,
                f"{what}: the gate passed its control (ids {agree_c}, logits {gap_c})")
    return {"agreement": agree, "slots_compared": int(wide.sum()), "max_logit_diff": gap,
            "control_agreement": agree_c, "control_max_logit_diff": gap_c}


def decoders_phase(dev, card, record, reset_counts, read_counts) -> dict:
    """The variants ported last, at full width with random weights from
    LSTM_SEED: SketchRNN in float32 (encode at N=1024; its one sampler,
    ``autoregressive_sample``, at N_RNN_SAMPLE; the step at B=60); the LSTM
    encoder with the flagship's one-shot decoder in bfloat16 (N=1024); the
    two-stage autoregressive model in bfloat16 and float32 (the
    teacher-forced forward at N=1024, the step at B=60); K7 causal with key
    padding at S=9; the decode-only models from a latent (one-shot at one
    and two stages, and the autoregressive form's ``greedy_sample`` through
    K9 and K3). Each path counted (launch counts held by ``check_later``, so
    that one run prints every count) with no plain version called, and held
    against its plain path with a control. Returns the launches of the
    counted runs."""
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import (
        DropoutRng, SVGTransformer, autoregressive_sample, gpu_fast, greedy_sample,
        hierarchical_ordered, one_shot_sample, one_stage_one_shot, sketchformer, sketchrnn)
    from deepsvg_tpu_torch.models import sample as sample_mod
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import decode as decode_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.svgtensor.constants import CMD_SOS, PAD_VAL
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)
    from deepsvg_tpu_torch.training.trainer import init_parameters
    t_phase = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    ops = (emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp, decode_ops)
    out: dict = {}
    launches: dict = {}
    no_launch = dict.fromkeys(read_counts(), 0)
    plain_fns = [(emb_ops, "embedding_reference"), (layer_ops, "layer_reference"),
                 (head_ops, "head_argmax_reference"), (decode_ops, "decode_step_reference"),
                 (layer_vjp, "layer_train_reference"), (stack_vjp, "layer_train_reference"),
                 (ce_ops, "args_ce_reference")]

    def build(cfg, dropout=None):
        if dropout is not None:
            cfg = dataclasses.replace(cfg, dropout=dropout)
        model = SVGTransformer(cfg)
        init_parameters(model, torch.Generator().manual_seed(LSTM_SEED))
        return model.to(dev).eval()

    def counted(what, fn, expected):
        """``fn()`` once, counted, with the plain versions spied; the counts
        are held later, so that a run prints them all."""
        torch.cuda.synchronize()
        calls, restore = count_plain_calls(plain_fns)
        reset_counts()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            restore()
        got = read_counts()
        print(f"{what}: launches {got}; plain versions called {calls}", flush=True)
        check_later(got == no_launch | expected, f"{what}: launches {got}, expected {expected}")
        check(not any(calls.values()), f"{what}: plain versions ran: {calls}")
        launches[what] = {k: v for k, v in got.items() if v}
        return res

    def walls(what, fn, iters=5):
        ms = cuda_median_ms(fn, iters=iters, warmup=1)
        busy, split = device_split(fn, iters=2)
        print(f"{what}: {ms:.3f} ms median of {iters}, device busy {busy} ms, idle share "
              f"{'not measured' if not busy else round(1 - busy / ms, 4)} on {card}", flush=True)
        return {"median_ms": ms, "device_busy_ms": busy,
                "idle_share": None if not busy else 1 - busy / ms,
                "top": sorted(split.items(), key=lambda kv: -kv[1])[:8]}

    def step(what, cfg, batch, model_args, expected, control, dtype):
        """The step at B=60: counted and timed at dropout 0.1, then at
        dropout 0 against its plain path with the recompute phase's gate; the
        control (the plain path inside ``control(model)``) must fail it."""
        opt = make_optimizer(constant(LR))
        state = create_train_state(build(cfg, DROPOUT), opt, init=False)
        _, res = counted(what, lambda: train_step(state, batch, SF_WEIGHTS, opt, model_args),
                         expected)
        ms = cuda_median_ms(lambda: train_step(state, batch, SF_WEIGHTS, opt, model_args),
                            iters=10)
        busy, split = device_split(lambda: train_step(state, batch, SF_WEIGHTS, opt, model_args),
                                   iters=2)
        _, r = train_step(state, batch, SF_WEIGHTS, opt, model_args)
        check(all(bool(torch.isfinite(v)) for v in r.values()), f"{what}: a loss is not finite")
        del state, opt

        def grads_of(control_cut=False):
            o = make_optimizer(constant(LR))
            st = create_train_state(build(cfg, 0.0), o, init=False)
            with control(st.model) if control_cut else contextlib.nullcontext():
                st, rr = train_step(st, batch, SF_WEIGHTS, o, model_args)
            names = [k for k, _ in st.model.named_parameters()]
            return rr, dict(zip(names, [p.grad.detach().clone() for p in st.parameters()]))
        res_k, grads_k = grads_of()
        with plain_path(*ops[:6]):
            res_p, grads_p = grads_of()
            res_c, grads_c = grads_of(control_cut=True)
        gate = step_against_plain(what, res_k, grads_k, res_p, grads_p)
        ctrl = step_against_plain(f"{what} control", res_c, grads_c, res_p, grads_p)
        del grads_k, grads_p, grads_c
        torch.cuda.empty_cache()
        lim_loss, lim_med = RC_STEP_LOSS[dtype], RC_STEP_MEDIAN_LEAF_RMS[dtype]
        print(f"{what} dropout {DROPOUT}: {ms:.3f} ms/step median of 10, device busy {busy} ms "
              f"per step on {card}; at dropout 0, kernel vs plain path: {gate}; control: {ctrl}",
              flush=True)
        check_later(gate["loss_rel_diff"] <= lim_loss and gate["median_leaf_rms"] <= lim_med
                    and gate["worst_leaf_rms"] <= TOL_STEP_LEAF_RMS,
                    f"{what} gate: loss rel diff {gate['loss_rel_diff']} (limit {lim_loss}), "
                    f"median leaf {gate['median_leaf_rms']} (limit {lim_med}), worst leaf "
                    f"{gate['worst_leaf_rms']} (limit {TOL_STEP_LEAF_RMS})")
        check_later(ctrl["loss_rel_diff"] > lim_loss or ctrl["median_leaf_rms"] > lim_med,
                    f"{what}: the gate passed its control {ctrl}")
        return {"B": B_RECIPE, "median_ms": ms, "device_busy_ms_per_step": busy,
                "idle_share": None if not busy else 1 - busy / ms, "launches": launches[what],
                "losses": {k: float(v) for k, v in r.items()}, "gate": gate, "control": ctrl,
                "top": sorted(split.items(), key=lambda kv: -kv[1])[:10]}

    # ======================================= (1) SketchRNN, float32 (its only type)
    cfg = sketchrnn()
    model = build(cfg)
    enc, dec, fcn = model.encoder, model.decoder, model.decoder.fcn
    sb = generate_batch(np.random.default_rng(0), N_MAIN, 8, 30)
    sc = torch.from_numpy(sb["commands_grouped"]).to(dev)               # [N, 1, 242]
    sa = torch.from_numpy(sb["args_grouped"]).to(dev)
    sr = torch.from_numpy(sb["args_rel_grouped"]).to(dev)
    rnn: dict = {}
    with torch.no_grad():
        z = counted(f"SketchRNN encode N={N_MAIN}",
                    lambda: model.encode(sc, sa, rng=DropoutRng.fixed())[0], {"embedding_f32": 1})
        check(tuple(z.shape) == (N_MAIN, cfg.dim_z) and bool(torch.isfinite(z).all()),
              "SketchRNN latent: shape or values")
        rnn["encode"] = walls(f"SketchRNN encode N={N_MAIN}",
                              lambda: model.encode(sc, sa, rng=DropoutRng.fixed()))
        # K1 on the encoder's operands against its plain version
        cmd_f, args_f = sc[:, 0], sa[:, 0]
        cmd_table, arg_tables, pos_table = enc.embedding.tables()
        e_in = (cmd_f, args_f, M.group_mask(cmd_f), cmd_table, arg_tables,
                enc.embedding.group_table(), pos_table[:cmd_f.shape[1]], True)
        x_k = emb_ops.fused_embedding(*e_in)
        k1_err = (x_k - emb_ops.embedding_reference(*e_in)).abs().max().item()
        check_later(k1_err <= TOL_EMBED_F32 * x_k.abs().max().item(),
                    f"K1 SketchRNN encoder float32: max abs err {k1_err}")
        with plain_path(*ops[:3]):
            z_p = model.encode(sc, sa, rng=DropoutRng.fixed())[0]
        z_err = (z - z_p).abs().max().item()
        print(f"SketchRNN encoder: K1 max abs err {k1_err:.3g}; latent kernel vs plain path max "
              f"abs err {z_err:.3g}", flush=True)
        check_later(z_err <= TOL_F32_ATOL, f"SketchRNN latent, kernel vs plain path: {z_err}")
        rnn["encoder"] = {"k1_max_abs_err": k1_err, "latent_max_abs_err": z_err}
        del x_k, z_p, e_in

        # the teacher-forced forward at N=64 against its plain path; the
        # control cuts the LSTM decoder's kernels to CONTROL_MANTISSA_BITS
        cells = [*enc.encoder.parameters(), *dec.decoder.cell.parameters()]
        rnn["gate"] = path_gate(
            "SketchRNN teacher-forced N=64", model, ops[:6],
            lambda: cut_params(cells, CONTROL_MANTISSA_BITS), limit=RNN_LOGIT_LIMIT,
            commands=sc[:N_AR_GATE], args=sa[:N_AR_GATE], dec=(sc[:N_AR_GATE], sr[:N_AR_GATE]))

        # autoregressive_sample (the full re-forward at each step), counted
        # and timed once; then the teacher-forced forward over its raw tokens:
        # the argmax at each position is the decoded token wherever the
        # margin is at least TF_MARGIN
        steps, n_s = cfg.max_total_len, N_RNN_SAMPLE
        raw = {}
        finalize = sample_mod._finalize_args

        def keep(cfg_, commands, args):
            raw["c"], raw["a"] = commands[:, 0], args[:, 0]
            return finalize(cfg_, commands, args)
        sample_mod._finalize_args = keep
        try:
            t0 = time.perf_counter()
            c_s, a_s = counted(f"SketchRNN autoregressive_sample N={n_s}",
                               lambda: autoregressive_sample(model, z[:n_s]),
                               {"embedding_f32": steps})
            sample_s = time.perf_counter() - t0
        finally:
            sample_mod._finalize_args = finalize
        used = M.cmd_args_mask(dev, torch.bool)[c_s.long()]
        check(tuple(c_s.shape) == (n_s, 1, steps) and int(c_s.min()) >= 0
              and int(c_s.max()) < cfg.n_commands and bool(torch.isfinite(a_s).all())
              and bool((a_s[~used] == PAD_VAL).all()), "SketchRNN sample: shapes or ranges")
        buf_c = torch.cat([torch.full((n_s, 1), CMD_SOS, dtype=torch.int32, device=dev),
                           raw["c"]], dim=1)[:, None]
        buf_a = torch.cat([torch.full((n_s, 1, cfg.n_args), float(PAD_VAL), device=dev),
                           raw["a"]], dim=1)[:, None]
        x_tf, ids_tf, _ = decoder_states(model, None, None, dec=(buf_c, buf_a), z=z[:n_s])
        ids_tf = ids_tf.reshape(n_s, steps + 1, -1)[:, :steps]
        m_tf = position_margin(slot_margins(x_tf, fcn).reshape(n_s, steps + 1, -1)[:, :steps],
                               raw["c"])
        used = M.cmd_args_mask(dev, torch.bool)[raw["c"].long()]
        same = (ids_tf[..., 0] == raw["c"]) & ((ids_tf[..., 1:] - 1 == raw["a"]) | ~used).all(-1)
        gated = m_tf >= TF_MARGIN
        tf_agree = same[gated].float().mean().item()
        print(f"SketchRNN autoregressive_sample N={n_s}: {sample_s:.2f} s (host clock, "
              f"{steps} steps of a {steps + 1}-step LSTM decoder) on {card}; the teacher-forced "
              f"argmax equals the decoded token at {tf_agree:.5f} of the {int(gated.sum())} "
              f"positions with margin >= {TF_MARGIN}; at every position "
              f"{same.float().mean().item():.4f}", flush=True)
        check_later(tf_agree == 1.0, f"SketchRNN: teacher-forced argmax differs from the "
                                     f"decode: {tf_agree}")
        check_later(int(gated.sum()) >= n_s,
                    f"only {int(gated.sum())} positions cleared the margin")
        rnn["sample"] = {"N": n_s, "seconds": sample_s, "teacher_forced_agreement": tf_agree,
                         "positions_compared": int(gated.sum()),
                         "launches": launches[f"SketchRNN autoregressive_sample N={n_s}"]}
        del x_tf, ids_tf, buf_c, buf_a, z
    del model
    torch.cuda.empty_cache()
    rnn_batch = {"commands_grouped": sc[:B_RECIPE], "args_grouped": sa[:B_RECIPE],
                 "args_rel_grouped": sr[:B_RECIPE]}
    rnn["step"] = step(
        f"SketchRNN train_step B={B_RECIPE}", cfg, rnn_batch, cfg.get_model_args(),
        {"embedding_f32": 2, "embedding_bwd": 2, "args_ce_fwd_f32": 1, "args_ce_bwd_f32": 1},
        lambda m: cut_params(list(m.decoder.decoder.cell.parameters()), CONTROL_MANTISSA_BITS),
        f32)
    out["sketchrnn"] = rnn
    del sc, sa, sr, rnn_batch

    # ======= (2) the LSTM encoder with the flagship's one-shot decoder, bfloat16
    fb = generate_batch(np.random.default_rng(0), N_MAIN, 8, 30)
    fc = torch.from_numpy(fb["commands"]).to(dev)
    fa = torch.from_numpy(fb["args"]).to(dev)
    cfg = gpu_fast(dataclasses.replace(hierarchical_ordered(), model_type="lstm"))
    model = build(cfg)
    lstm_os: dict = {}
    with torch.no_grad():
        c_o, a_o = counted(f"LSTM encoder + one-shot decoder bfloat16 one_shot_sample "
                           f"N={N_MAIN}", lambda: one_shot_sample(model, fc, fa),
                           {"embedding": 1, "layer": 8, "layer_f32": 4, "head": 1})
        lstm_os["valid_share"] = check_sample(c_o, a_o, N_MAIN, cfg)
        lstm_os["inference"] = walls(f"LSTM encoder + one-shot decoder one_shot_sample "
                                     f"N={N_MAIN}", lambda: one_shot_sample(model, fc, fa))
        layers = list(model.decoder.decoder.layers)
        lstm_os["gate"] = path_gate(
            "LSTM encoder + one-shot decoder N=64", model, ops[:6],
            lambda: cut_layers(layers, AR_CONTROL_DROP_BITS), hold_logits=False,
            commands=fc[:N_AR_GATE], args=fa[:N_AR_GATE])
    del model
    torch.cuda.empty_cache()
    out["lstm_one_shot"] = lstm_os

    # ======= (3) two-stage autoregressive decoding, bfloat16 then float32
    two: dict = {}
    t_batch = {"commands": fc[:B_RECIPE], "args": fa[:B_RECIPE]}
    for dt, tag in ((bf16, ""), (f32, "_f32")):
        dname = "bfloat16" if dt == bf16 else "float32"
        cfg = dataclasses.replace(hierarchical_ordered(), pred_mode="autoregressive")
        cfg = gpu_fast(cfg) if dt == bf16 else cfg
        model = build(cfg)
        res: dict = {}
        with torch.no_grad():
            fwd = counted(f"two-stage AR {dname} teacher-forced forward N={N_MAIN}",
                          lambda: model(fc, fa, fc, fa, return_tgt=True),
                          {f"embedding{tag}": 2, "layer_f32": 4 if dt == bf16 else 16,
                           **({"layer": 12} if dt == bf16 else {})})
            check(tuple(fwd["command_logits"].shape[:3]) == (N_MAIN, 8, 31)
                  and all(bool(torch.isfinite(v).all()) for k, v in fwd.items()
                          if k.endswith("logits")), "two-stage AR forward: shapes or values")
            del fwd
            res["forward"] = walls(f"two-stage AR {dname} teacher-forced forward N={N_MAIN}",
                                   lambda: model(fc, fa, fc, fa, return_tgt=True))
            layers = list(model.decoder.decoder.layers)
            res["gate"] = path_gate(
                f"two-stage AR {dname} N=64", model, ops[:6],
                lambda: cut_layers(layers, AR_CONTROL_DROP_BITS), hold_logits=False,
                commands=fc[:N_AR_GATE], args=fa[:N_AR_GATE],
                dec=(fc[:N_AR_GATE], fa[:N_AR_GATE]))
        # K7 causal with key padding at S=9 (a two-stage AR decoder at
        # max_seq_len 8 takes the stack gate at D1): the model's D1 layers,
        # random inputs, the injections of a random latent, rates 0 and 0.1
        def causal_draw(gen, layers=layers):
            with torch.no_grad():
                x = torch.randn(B_K7_CAUSAL, 9, cfg.d_model, device=dev, generator=gen)
                zz = 0.5 * torch.randn(B_K7_CAUSAL, cfg.dim_z, device=dev, generator=gen)
                biases = torch.stack([lay.injection(zz) for lay in layers])
                lengths = torch.randint(1, 10, (B_K7_CAUSAL, 1), device=dev, generator=gen)
                mask = torch.where(torch.arange(9, device=dev)[None] < lengths, 0.0,
                                   float("-inf"))
                return x, biases, mask
        res["k7_causal"] = {}
        for rate in (0.0, DROPOUT):
            r7 = check_stack_train(stack_vjp, layer_vjp, f"causal S=9 {dname} B={B_K7_CAUSAL}",
                                   layers, causal_draw, rate, outliers_aligned=True, causal=True)
            res["k7_causal"][f"rate {rate}"] = {"worst": r7["worst"],
                                                "forward_max_abs_err": r7["forward_max_abs_err"]}
        del model
        torch.cuda.empty_cache()
        expected = ({"embedding": 2, "layer_train_fwd": 8, "layer_train_bwd": 8, "stack_fwd": 2,
                     "stack_bwd": 2, "args_ce_fwd": 1, "args_ce_bwd": 1, "embedding_bwd": 2}
                    if dt == bf16 else
                    {"embedding_f32": 2, "layer_train_long_fwd_f32": 8,
                     "layer_train_long_bwd_f32": 8, "stack_fwd": 2, "stack_bwd": 2,
                     "args_ce_fwd_f32": 1, "args_ce_bwd_f32": 1, "embedding_bwd": 2})
        res["step"] = step(
            f"two-stage AR train_step {dname} B={B_RECIPE}", cfg, t_batch,
            cfg.get_model_args(), expected,
            lambda m: cut_layers([*m.encoder.encoder.layers, *m.decoder.decoder.layers],
                                 CONTROL_DROP_BITS), dt)
        two[dname] = res
    out["two_stage_ar"] = two
    del fc, fa, t_batch

    # ======= (4) the decode-only models from a latent, bfloat16
    dec_only: dict = {}
    zg = torch.Generator(device=dev).manual_seed(LSTM_SEED)
    z = torch.randn(N_MAIN, 256, device=dev, generator=zg)
    for name, base, expected in (
            ("one-shot 1 stage", one_stage_one_shot(), {"layer_long": 4, "head": 1}),
            ("one-shot 2 stages", hierarchical_ordered(), {"layer": 8, "head": 1})):
        cfg = gpu_fast(dataclasses.replace(base, encode_stages=0))
        model = build(cfg)
        with torch.no_grad():
            c_d, a_d = counted(f"decode-only {name} one_shot_sample N={N_MAIN}",
                               lambda: one_shot_sample(model, z=z), expected)
            groups, s_dec = ((1, cfg.max_total_len + 1) if cfg.decode_stages == 1
                             else (cfg.max_num_groups, cfg.max_seq_len + 1))
            row = {"valid_share": check_sample(c_d, a_d, N_MAIN, cfg, groups, s_dec),
                   "inference": walls(f"decode-only {name} one_shot_sample N={N_MAIN}",
                                      lambda: one_shot_sample(model, z=z))}
            layers = list(model.decoder.decoder.layers)
            row["gate"] = path_gate(f"decode-only {name} N=64", model, ops[:6],
                                    lambda: cut_layers(layers, AR_CONTROL_DROP_BITS),
                                    commands=None, args=None, z=z[:N_AR_GATE])
        dec_only[name] = row
        del model
    cfg = gpu_fast(dataclasses.replace(sketchformer(), encode_stages=0))
    model = build(cfg)
    steps = cfg.max_total_len
    with torch.no_grad():
        c_g, a_g = counted(f"decode-only autoregressive greedy_sample N={N_MAIN}",
                           lambda: greedy_sample(model, z=z), {"decode": steps, "head": steps})
        used = M.cmd_args_mask(dev, torch.bool)[c_g.long()]
        check(tuple(c_g.shape) == (N_MAIN, 1, steps) and int(c_g.min()) >= 0
              and int(c_g.max()) < cfg.n_commands and bool(torch.isfinite(a_g).all())
              and bool((a_g[~used] == PAD_VAL).all()), "decode-only AR: shapes or ranges")
        row = {"inference": walls(f"decode-only autoregressive greedy_sample N={N_MAIN}",
                                  lambda: greedy_sample(model, z=z), iters=3)}
        zg_ = z[:N_AR_GATE]
        out_k, raw_ck, raw_ak, states_k = traced_decode(model, zg_, sample_mod)
        with plain_path(emb_ops, layer_ops, head_ops, decode_ops=decode_ops):
            out_p, raw_cp, raw_ap, states_p = traced_decode(model, zg_, sample_mod)
            with cut_layers(list(model.decoder.decoder.layers), AR_CONTROL_DROP_BITS):
                out_c = traced_decode(model, zg_, sample_mod)
        margin_p = position_margin(slot_margins(states_p, model.decoder.fcn), raw_cp.t()).t()
        w_head = model.decoder.fcn.w_packed.float()

        def against_plain(o, raw_c_o, raw_a_o, states_o):
            """(share of sequences equal before the gate, positions compared,
            largest logit difference at the steps where both paths had seen
            the same tokens)"""
            agree_o, compared_o = prefix_gate(o, out_p, margin_p, AR_MARGIN)
            differ = ~((raw_c_o == raw_cp) & (raw_a_o == raw_ap).all(dim=-1))
            first = torch.where(differ.any(1), differ.float().argmax(1),
                                torch.full_like(differ[:, 0], steps - 1, dtype=torch.long))
            shared = torch.arange(steps, device=dev)[:, None] <= first[None]
            gap_o = ((states_o[shared].float() - states_p[shared].float()) @ w_head.t()).abs()
            return agree_o, compared_o, gap_o.max().item()
        agree, compared, gap = against_plain(out_k, raw_ck, raw_ak, states_k)
        control, _, control_gap = against_plain(*out_c)
        print(f"decode-only autoregressive kernel vs plain path N={N_AR_GATE}: {agree:.4f} of "
              f"the sequences equal before their first position with plain margin < "
              f"{AR_MARGIN} ({compared} positions compared); largest logit difference at shared "
              f"inputs {gap:.3g} (limit {AR_LOGIT_LIMIT}); control (every decoder layer less "
              f"{AR_CONTROL_DROP_BITS} bits) {control:.4f}, {control_gap:.3g}", flush=True)
        check_later(agree == 1.0, f"decode-only AR: ids differ before the margin gate: {agree}")
        check_later(gap <= AR_LOGIT_LIMIT, f"decode-only AR: logits differ by {gap} at shared "
                                           f"inputs (limit {AR_LOGIT_LIMIT})")
        check_later(control < 1.0 or control_gap > AR_LOGIT_LIMIT,
                    f"decode-only AR: the gate passed its control ({control}, {control_gap})")
        check_later(compared >= N_AR_GATE, f"only {compared} positions cleared the margin")
        row["gate"] = {"agreement": agree, "positions_compared": compared,
                       "max_logit_diff_shared_inputs": gap, "control": control,
                       "control_max_logit_diff": control_gap}
        dec_only["autoregressive"] = row
    del model, z, states_k, states_p, out_c
    torch.cuda.empty_cache()
    out["decode_only"] = dec_only
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"LSTM and decoders phase: {out['phase_s']:.1f} s", flush=True)
    record["lstm_decoders"] = out
    return launches


def geometry_phase(dev, card, record, reset_counts, read_counts) -> dict:
    """SVGs in and out of the trained flagship on the card, and the geometry
    on the device. (1) The native fitting engine built with ``g++`` and held
    to the Python fitting. (2) The held documents through the port's svglib
    (canonicalize, simplify, numericalize, to_tensor), packed to 8 x 30 and
    tiled to N_MAIN rows, through ``evaluation.reconstruct`` in bfloat16
    (counted: K1 1, K2 12 + 4 float32, K3 1), its states held against the
    plain path's with ``path_gate`` and a control, its outputs turned back
    into SVG text that must parse again. (3) ``recon_metrics`` on the card
    in both group modes, held to the CPU's on N_GEOM_CPU rows, no kernel
    launched. (4) The EMD descent of ``examples/02`` in float32 on the card
    against the CPU's first step. Returns the launches of the counted run."""
    from deepsvg_tpu_torch import evaluation, native
    from deepsvg_tpu_torch.difflib import sample_points_padded, svg_emd_loss
    from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, load_model
    from deepsvg_tpu_torch.models.sample import flatten_groups_np
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.svglib import SVG, Bbox
    from deepsvg_tpu_torch.svglib import path_fitting
    from deepsvg_tpu_torch.svgtensor import (
        CMD_C, CMD_L, cmd_args_to_data14, data14_to_cmd_args, pack_groups)
    t_phase = time.perf_counter()
    out: dict = {}
    no_launch = dict.fromkeys(read_counts(), 0)

    # ======================================= (1) the native fitting engine
    t0 = time.perf_counter()
    check(native.available(), "the native fitting engine did not build (g++)")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, 2000)
    contour = np.stack([10 + 5 * np.cos(t), 10 + 5 * np.sin(t)], -1) \
        + rng.normal(0, 0.01, (2000, 2))
    polyline = rng.random((1500, 2)) * np.array([100, 3])
    nat: dict = {"build_s": build_s}
    for name, args_ in (("fit_cubics", (contour, 0.01)), ("rdp", (polyline, 1.0))):
        t0 = time.perf_counter()
        py = getattr(path_fitting, name)(*args_)
        py_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cc = getattr(native, name)(*args_)
        cc_ms = (time.perf_counter() - t0) * 1e3
        err = max((float(np.abs(np.asarray(va) - np.asarray(vb)).max())
                   for a, b in zip(py, cc) for va, vb in zip(a[1:], b[1:])), default=0.0)
        check(len(py) == len(cc) and all(a[0] == b[0] for a, b in zip(py, cc))
              and err <= GEOM_NATIVE_ATOL,
              f"native {name}: {len(cc)} pieces against {len(py)}, max abs err {err}")
        nat[name] = {"pieces": len(cc), "max_abs_err": err, "python_ms": py_ms, "native_ms": cc_ms}
    print(f"native engine: built in {build_s:.2f} s; fit_cubics {nat['fit_cubics']['pieces']} "
          f"pieces, {nat['fit_cubics']['native_ms']:.2f} ms against Python's "
          f"{nat['fit_cubics']['python_ms']:.1f} ms; rdp {nat['rdp']['native_ms']:.2f} ms against "
          f"{nat['rdp']['python_ms']:.1f} ms (host clock); max abs err "
          f"{max(nat['fit_cubics']['max_abs_err'], nat['rdp']['max_abs_err']):.3g}", flush=True)
    out["native"] = nat

    # =================== (2) SVG text -> svglib -> the flagship -> SVG text
    cfg = gpu_fast(hierarchical_ordered())
    model = load_model(CHECKPOINT, cfg, device=dev)
    t0 = time.perf_counter()
    packed = []
    for name, body in GEOMETRY_SVGS.items():
        svg = SVG.from_str(_SVG_HEAD + body + "</svg>").canonicalize(normalize=True)
        svg = svg.simplify_heuristic()
        svg.numericalize(256)
        groups = svg.to_tensor(concat_groups=False)
        check(0 < len(groups) <= cfg.max_num_groups
              and all(len(g) <= cfg.max_seq_len for g in groups),
              f"SVG {name}: {[len(g) for g in groups]} commands a path")
        packed.append(pack_groups(groups, cfg.max_num_groups, cfg.max_seq_len,
                                  cfg.max_total_len))
    svg_in_s = time.perf_counter() - t0
    reps = -(-N_MAIN // len(packed))
    gt_c = torch.from_numpy(np.concatenate([np.stack([p["commands"] for p in packed])] * reps)
                            [:N_MAIN]).to(dev)
    gt_a = torch.from_numpy(np.concatenate([np.stack([p["args"] for p in packed])] * reps)
                            [:N_MAIN]).to(dev)
    plain_fns = [(emb_ops, "embedding_reference"), (layer_ops, "layer_reference"),
                 (head_ops, "head_argmax_reference")]
    torch.cuda.synchronize()
    calls, restore = count_plain_calls(plain_fns)
    reset_counts()
    try:
        pr_c, pr_a = evaluation.reconstruct(model, gt_c, gt_a)
        torch.cuda.synchronize()
    finally:
        restore()
    got = read_counts()
    expected = {"embedding": 1, "layer": 12, "layer_f32": 4, "head": 1}
    launches = {k: v for k, v in got.items() if v}
    print(f"geometry reconstruct N={N_MAIN}: launches {got}; plain versions called {calls}",
          flush=True)
    check_later(got == no_launch | expected, f"geometry reconstruct: launches {got}, "
                                             f"expected {expected}")
    check(not any(calls.values()), f"geometry reconstruct: plain versions ran: {calls}")
    valid_share = check_sample(pr_c, pr_a, N_MAIN, cfg)
    recon_ms = cuda_median_ms(lambda: evaluation.reconstruct(model, gt_c, gt_a), iters=5,
                              warmup=1)
    recon_busy, _ = device_split(lambda: evaluation.reconstruct(model, gt_c, gt_a), iters=2)
    layers = list(model.decoder.decoder.layers)
    ops = (emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp)
    with torch.no_grad():
        gate = path_gate(f"geometry reconstruct N={N_AR_GATE}", model, ops,
                         lambda: cut_layers(layers, AR_CONTROL_DROP_BITS), hold_logits=False,
                         commands=gt_c[:N_AR_GATE], args=gt_a[:N_AR_GATE])
    # back to SVG text, and that text parsed again
    t0 = time.perf_counter()
    n_paths = []
    for c, a in flatten_groups_np(pr_c, pr_a):
        text = SVG.from_tensor(cmd_args_to_data14(c, a), viewbox=Bbox(256),
                               allow_empty=True).to_str()
        n_paths.append(len(list(SVG.from_str(text).paths)))
    svg_out_s = time.perf_counter() - t0
    check(len(n_paths) == N_MAIN and sum(n_paths) > 0, "no reconstruction has a path")
    print(f"geometry: {len(GEOMETRY_SVGS)} documents through svglib in {svg_in_s * 1e3:.1f} ms, "
          f"tiled to N={N_MAIN}; reconstruct {recon_ms:.3f} ms median of 5, device busy "
          f"{recon_busy} ms on {card}; valid argument share {valid_share:.4f}; {N_MAIN} outputs "
          f"to SVG text and parsed again in {svg_out_s:.2f} s (host), "
          f"{sum(n_paths) / N_MAIN:.2f} subpaths each", flush=True)
    out["reconstruct"] = {"N": N_MAIN, "documents": list(GEOMETRY_SVGS), "launches": launches,
                          "median_ms": recon_ms, "device_busy_ms": recon_busy,
                          "svg_in_ms": svg_in_s * 1e3, "svg_out_s": svg_out_s,
                          "valid_share": valid_share, "subpaths_per_output": sum(n_paths) / N_MAIN,
                          "gate": gate}
    del model
    torch.cuda.empty_cache()

    # ===================================== (3) the metrics on the device
    gt = (gt_c[..., 1:], gt_a[..., 1:, :])
    metrics: dict = {}
    for match in (False, True):
        reset_counts()
        acc = evaluation.recon_metrics(*gt, pr_c, pr_a, match_groups=match)
        torch.cuda.synchronize()
        check(read_counts() == no_launch, f"recon_metrics launched a kernel: {read_counts()}")
        ratios = evaluation._ratios(acc)
        rows = slice(0, N_GEOM_CPU)
        card_rows = evaluation.recon_metrics(gt[0][rows], gt[1][rows], pr_c[rows], pr_a[rows],
                                             match_groups=match)
        t0 = time.perf_counter()
        cpu_rows = evaluation.recon_metrics(gt[0][rows].cpu(), gt[1][rows].cpu(),
                                            pr_c[rows].cpu(), pr_a[rows].cpu(),
                                            match_groups=match)
        cpu_s = time.perf_counter() - t0
        worst = max(abs(float(card_rows[k]) - float(cpu_rows[k]))
                    / max(abs(float(cpu_rows[k])), 1.0) for k in cpu_rows)
        fn = lambda m=match: evaluation.recon_metrics(*gt, pr_c, pr_a, match_groups=m)  # noqa: E731
        ms = cuda_median_ms(fn, iters=5, warmup=1)
        busy, _ = device_split(fn, iters=2)
        tag = "matched groups" if match else "groups by index"
        print(f"recon_metrics N={N_MAIN} ({tag}): {json.dumps(ratios)}; {ms:.3f} ms median of 5, "
              f"device busy {busy} ms on {card}; card against CPU on the first {N_GEOM_CPU} rows: "
              f"largest relative difference {worst:.3g} (limit {GEOM_METRIC_RTOL}; the CPU took "
              f"{cpu_s:.2f} s)", flush=True)
        check_later(worst <= GEOM_METRIC_RTOL,
                    f"recon_metrics ({tag}): card against CPU {worst} (limit {GEOM_METRIC_RTOL})")
        metrics["match_groups" if match else "by_index"] = {
            "ratios": ratios, "sums": {k: float(v) for k, v in acc.items()},
            "median_ms": ms, "device_busy_ms": busy, "cpu_rows": N_GEOM_CPU,
            "card_vs_cpu_rel": worst, "cpu_s": cpu_s}
    out["metrics"] = metrics

    # ======== (4) differentiable geometry: examples/02's EMD descent, float32
    target_svg = SVG.from_str(_SVG_HEAD + GEOM_TARGET + "</svg>").canonicalize(normalize=True)
    target_np = np.concatenate([p.sample_points(0.3) for p in target_svg.paths]).astype(np.float32)
    cmds_np, args_np = data14_to_cmd_args(SVG.unit_circle().normalize().to_tensor())
    valid_np = (cmds_np == CMD_L) | (cmds_np == CMD_C)

    def loss_and_grad(args_, cmds_, target_, valid_):
        args_ = args_.detach().requires_grad_()
        points, _ = sample_points_padded(cmds_, args_, n=8)
        loss = svg_emd_loss(points[valid_].reshape(-1, 2), target_)
        loss.backward()
        return loss.detach(), args_.grad

    inputs = [torch.from_numpy(x) for x in (args_np, cmds_np, target_np, valid_np)]
    loss_cpu, grad_cpu = loss_and_grad(*inputs)
    args_d, cmds_d, target_d, valid_d = (x.to(dev) for x in inputs)
    reset_counts()
    loss0, grad0 = loss_and_grad(args_d, cmds_d, target_d, valid_d)
    loss_err = abs(float(loss0) - float(loss_cpu))
    grad_err = float((grad0.cpu() - grad_cpu).abs().max() / grad_cpu.abs().max())
    losses = [float(loss0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args_k = args_d
    for step in range(EMD_STEPS):
        loss, grad = loss_and_grad(args_k, cmds_d, target_d, valid_d)
        args_k = args_k - EMD_LR * grad
        if step % 50 == 0 or step == EMD_STEPS - 1:
            losses.append(float(loss))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / EMD_STEPS
    check(read_counts() == no_launch, f"the EMD descent launched a kernel: {read_counts()}")
    print(f"EMD descent (float32, {EMD_STEPS} steps at lr {EMD_LR}): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; {step_ms:.3f} ms a step (host clock, a loss read every 50 steps) on "
          f"{card}; step 0 against the CPU: loss {loss_err:.3g} (limit {GEOM_EMD_TOL}), gradient "
          f"{grad_err:.3g} of its largest entry (limit {GEOM_EMD_GRAD_TOL})", flush=True)
    check_later(loss_err <= GEOM_EMD_TOL and grad_err <= GEOM_EMD_GRAD_TOL,
                f"EMD step 0, card against CPU: loss {loss_err}, gradient {grad_err}")
    check(np.isfinite(losses[-1]) and losses[-1] < losses[0],
          f"the EMD descent did not fall: {losses}")
    out["emd_descent"] = {"steps": EMD_STEPS, "lr": EMD_LR, "losses": losses,
                          "ms_per_step": step_ms, "step0_loss_err": loss_err,
                          "step0_grad_err": grad_err}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"geometry phase: {out['phase_s']:.1f} s", flush=True)
    record["geometry"] = out
    return launches


def write_svg_corpus(folder: str) -> dict:
    """The data phase's SVG corpus, written to ``folder``: the documents of
    GEOMETRY_SVGS under DATA_ZOOMS x DATA_SHIFTS, each beside the next one
    (their paths together), and subsets of the four-path document; then
    three documents that the flagship config's filters drop (DATA_DROPPED:
    more than 8 paths, a path of more than 30 commands, more than 50
    commands in all) and one that does not parse. Returns ``{name: kind}``."""
    from deepsvg_tpu_torch.svglib import SVG, Point

    def doc(body):
        svg = SVG.from_str(_SVG_HEAD + body + "</svg>")
        return svg.to_path()

    def zigzag(x0, y0, n, dx, amp):
        pts = " ".join(f"L {x0 + dx * (i + 1):.2f} {y0 + (amp if i % 2 else -amp):.2f}"
                       for i in range(n))
        return f'<path d="M {x0} {y0} {pts} Z"/>'

    kinds: dict = {}

    def save(name, svg, kind="kept"):
        svg.save_svg(os.path.join(folder, f"{name}.svg"))
        kinds[name] = kind

    names = list(GEOMETRY_SVGS)
    for i, name in enumerate(names):
        for zi, zoom in enumerate(DATA_ZOOMS):
            for si, (dx, dy) in enumerate(DATA_SHIFTS):
                save(f"{name}_z{zi}_s{si}", doc(GEOMETRY_SVGS[name]).zoom(zoom).translate(
                    Point(dx, dy)))
        nxt = names[(i + 1) % len(names)]
        both = doc(GEOMETRY_SVGS[name])
        both.svg_path_groups += doc(GEOMETRY_SVGS[nxt]).zoom(0.5).svg_path_groups
        save(f"{name}_and_{nxt}", both)
    four = doc(GEOMETRY_SVGS["primitives"])
    for lo, hi in ((0, 2), (1, 3), (2, 4)):
        save(f"primitives_{lo}{hi}", SVG(four.svg_path_groups[lo:hi], four.viewbox))
    many = "".join(f'<path d="M {1 + 2 * i} 2 L {2 + 2 * i} 2 L {1.5 + 2 * i} 4 Z"/>'
                   for i in range(10))
    total = "".join(zigzag(1, 2 + 3 * i, 9, 2.4, 1) for i in range(7))
    for name, text, kind in (("many_paths", _SVG_HEAD + many + "</svg>", "dropped"),
                             ("long_path", _SVG_HEAD + zigzag(1, 12, 40, 0.55, 6) + "</svg>",
                              "dropped"),
                             ("long_total", _SVG_HEAD + total + "</svg>", "dropped"),
                             ("broken", "<svg><path d='M 1 1 L 2", "broken")):
        with open(os.path.join(folder, f"{name}.svg"), "w") as f:
            f.write(text)
        kinds[name] = kind
    return kinds


def data_apps_phase(dev, card, record, reset_counts, read_counts) -> dict:
    """The real-data loaders, the preprocessing CLI and the apps on the card,
    with the flagship config (B=60, bfloat16). (1) An SVG corpus of
    :func:`write_svg_corpus` through ``python -m
    deepsvg_tpu_torch.data.preprocess --workers 4``: one meta row per parsed
    file. (2) The survivors as tensor pickles of DATA_AUGS augmentations.
    (3) ``training/train.py:train`` in process through
    ``load_dataset(cfg)``: on the pickles (device-resident) and on the
    simplified SVGs (streamed, augmented on the fly), DATA_STEPS steps each,
    counted (the recipe step's launches a step, no plain version called),
    finite losses, a checkpoint written and read back by ``load_session``.
    (4) ``inference.load_session`` of the trained flagship on the card:
    ``encode_svg`` and ``interpolate_svg`` counted, the decode of the
    interpolation held to the plain path's by ``path_gate`` (ids, a control
    that must fail), every frame back to SVG text that parses again, encode
    and decode timed. (5) ``animate.compute_interpolation`` with the
    flagship config: the finetune on the card (counted), the in-betweens,
    the live session unchanged. (6) The web GUI on a thread over HTTP: two
    pencil keyframes, ``/api/interpolate`` (counted), every frame filled.
    Returns the launches."""
    import csv
    import io
    import pickle
    import random
    import tempfile
    import threading
    import urllib.request

    from deepsvg_tpu_torch import animate, inference
    from deepsvg_tpu_torch.data.dataset import SVGDataset, SVGTensorDataset
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import decode as decode_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.svglib import SVG
    from deepsvg_tpu_torch.training import train as train_mod
    from deepsvg_tpu_torch.training.config import load_config
    from deepsvg_tpu_torch.webgui import make_server

    t_phase = time.perf_counter()
    out: dict = {}
    launches: dict = {}
    no_launch = dict.fromkeys(read_counts(), 0)
    step_launches = {"embedding": 1, "layer_train_fwd": 8, "layer_train_bwd": 8,
                     "stack_fwd": 2, "stack_bwd": 2, "args_ce_fwd": 1, "args_ce_bwd": 1,
                     "embedding_bwd": 1}
    encode_launches = {"embedding": 1, "layer": 4, "layer_f32": 4}
    decode_launches = {"layer": 8, "head": 1}
    plain_fns = [(emb_ops, "embedding_reference"), (layer_ops, "layer_reference"),
                 (head_ops, "head_argmax_reference"), (decode_ops, "decode_step_reference"),
                 (layer_vjp, "layer_train_reference"), (stack_vjp, "layer_train_reference"),
                 (ce_ops, "args_ce_reference")]
    ops = (emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp)
    config = "deepsvg_tpu_torch.configs.hierarchical_ordered"

    def counted(what, fn, expected):
        """``fn()`` once, counted, with the plain versions spied."""
        torch.cuda.synchronize()
        calls, restore = count_plain_calls(plain_fns)
        reset_counts()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            restore()
        got = read_counts()
        want = no_launch | {k: v for k, v in expected.items() if v}
        print(f"{what}: launches {({k: v for k, v in got.items() if v})}; plain versions "
              f"called {calls}", flush=True)
        check(got == want, f"{what}: launches {got}, expected {want}")
        check(not any(calls.values()), f"{what}: plain versions ran: {calls}")
        launches[what] = {k: v for k, v in got.items() if v}
        return res

    def times(n, per):
        return {k: n * v for k, v in per.items()}

    def added(*dicts):
        total: dict = {}
        for d in dicts:
            for k, v in d.items():
                total[k] = total.get(k, 0) + v
        return total

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    raw, simplified, tensors = (os.path.join(root, d) for d in ("raw", "simplified", "tensors"))
    for d in (raw, tensors):
        os.makedirs(d)

    # ============================== (1) the corpus and the preprocess CLI
    kinds = write_svg_corpus(raw)
    meta = os.path.join(root, "meta.csv")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deepsvg_tpu_torch.data.preprocess", "--data_folder", raw,
         "--output_folder", simplified, "--output_meta_file", meta, "--workers", "4"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    pre_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the preprocess CLI failed: {proc.stderr[-2000:]}")
    failures = [ln for ln in proc.stderr.splitlines() if "failed on" in ln]
    with open(meta) as f:
        rows = list(csv.DictReader(f))
    produced = sorted(os.listdir(simplified))
    print(f"data: {len(kinds)} SVG files written, preprocessed by the CLI (4 workers) in "
          f"{pre_s:.2f} s (host clock, on the machine of {card}): {len(rows)} meta rows, "
          f"{len(failures)} failures {failures}", flush=True)
    check(len(rows) + len(failures) == len(kinds) and len(produced) == len(rows)
          and sorted(r["id"] + ".svg" for r in rows) == produced,
          f"preprocess: {len(rows)} rows and {len(failures)} failures for {len(kinds)} files")
    check([k for k, v in kinds.items() if v == "broken"] ==
          [os.path.splitext(os.path.basename(ln.split("failed on ")[1].split(":")[0]))[0]
           for ln in failures], f"preprocess failures {failures}")

    cfg = load_config(config, 1)
    keep = [r for r in rows if int(r["nb_groups"]) <= cfg.max_num_groups
            and int(r["max_len_group"]) <= cfg.max_seq_len
            and int(r["total_len"]) <= cfg.max_total_len]
    dropped = sorted(r["id"] for r in rows if r not in keep)
    check(dropped == sorted(k for k, v in kinds.items() if v == "dropped"),
          f"the config's filters drop {dropped}")

    # ======================================== (2) the tensor pickles
    rng = random.Random(DATA_SEED)
    t0 = time.perf_counter()
    for r in keep:
        svg = SVG.load_svg(os.path.join(simplified, r["id"] + ".svg"))
        variants = [np.concatenate(SVGTensorDataset.preprocess(svg.copy(), rng=rng)
                                   .to_tensor(concat_groups=False), axis=0)
                    for _ in range(DATA_AUGS)]
        with open(os.path.join(tensors, r["id"] + ".pkl"), "wb") as f:
            pickle.dump({"tensors": variants, "fillings": svg.to_fillings()}, f)
    tensor_s = time.perf_counter() - t0
    print(f"data: {len(keep)} icons pass the config's filters ({dropped} dropped), written as "
          f"tensor pickles of {DATA_AUGS} augmentations in {tensor_s:.2f} s (host clock)",
          flush=True)
    out["corpus"] = {"files": len(kinds), "meta_rows": len(rows), "failures": failures,
                     "dropped_by_filters": dropped, "icons": len(keep), "augmentations": DATA_AUGS,
                     "preprocess_s": pre_s, "tensor_pickles_s": tensor_s}

    # ============================ (3) train() on the real-data module, twice
    def train_on(what, data_dir, resident):
        c = load_config(config, 1)
        check(c.dataloader_module == "deepsvg_tpu_torch.data.dataset",
              f"the flagship config reads {c.dataloader_module}")
        c.data_dir, c.meta_filepath = data_dir, meta
        c.nb_augmentations = DATA_AUGS
        c.log_every = DATA_STEPS // 2
        log = io.StringIO()

        def run():
            with contextlib.redirect_stdout(log):
                return train_mod.train(c, "hierarchical_ordered", what,
                                       log_dir=os.path.join(root, "logs"),
                                       max_steps=DATA_STEPS, device=dev)
        t0 = time.perf_counter()
        state, stats = counted(f"train() {what}", run, times(DATA_STEPS, step_launches))
        wall = time.perf_counter() - t0
        text = log.getvalue()
        with open(os.path.join(OUT_DIR, f"data_train_{what}.log"), "w") as f:
            f.write(text)
        line = [ln for ln in text.splitlines() if ln.startswith("device-resident dataset")]
        check(bool(line) == resident, f"train() {what}: device-resident line {line}")
        losses = list(stats.stats["train"]["loss"].deque)
        ms = [1e3 * t for t in stats.stats["train"]["time"].deque]
        ckpt = os.path.join(root, "logs", "models", "hierarchical_ordered", what,
                            f"{DATA_STEPS:06d}.ckpt")
        check(state.step == DATA_STEPS and len(losses) == 2
              and all(np.isfinite(v) for v in losses) and os.path.exists(ckpt),
              f"train() {what}: step {state.step}, losses {losses}, checkpoint {ckpt}")
        print(f"train() {what} B={c.batch_size}: {DATA_STEPS} steps, {line[0] if line else 'streamed'}"
              f"; losses by window {[round(v, 4) for v in losses]}; ms/step by window "
              f"{[round(v, 3) for v in ms]} (host clock, the first window holds the set-up); "
              f"{wall:.2f} s in all on {card}", flush=True)
        return state, ckpt, {"steps": DATA_STEPS, "losses": losses, "ms_per_step_windows": ms,
                             "wall_s": wall, "resident_line": line[0] if line else None}

    state, ckpt, out["train_resident"] = train_on("tensor_pickles", tensors, True)
    trained = [p.detach().clone() for p in state.parameters()]
    del state
    _, _, out["train_streamed"] = train_on("raw_svgs", simplified, False)
    # the training checkpoint through load_session
    restored = inference.load_session(config, ckpt, device=dev)
    check(all(torch.equal(a, b) for a, b in zip(restored.model.parameters(), trained)),
          "load_session of the training checkpoint does not hold its parameters")
    del restored, trained
    torch.cuda.empty_cache()

    # ========================================== (4) the session on the card
    svg_ds = SVGDataset(simplified, meta, cfg.model_args, cfg.max_num_groups, cfg.max_seq_len,
                        cfg.max_total_len, seed=DATA_SEED)
    session = inference.load_session(config, CHECKPOINT, dataset=svg_ds, device=dev)
    check(session.device.type == "cuda", f"the session is on {session.device}")
    first, second = (SVG.load_svg(os.path.join(simplified, n + ".svg")).numericalize(256)
                     for n in DATA_KEYFRAMES)
    with torch.no_grad():
        z1 = counted("session encode_svg", lambda: session.encode_svg(first), encode_launches)
        z2 = session.encode_svg(second)
        frames = counted(f"session interpolate_svg n={N_INTERP}",
                         lambda: session.interpolate_svg(first, second, n=N_INTERP),
                         added(times(2, encode_launches), decode_launches))
        zs = session.interpolation_latents(z1, z2, n=N_INTERP)
        ids = session.decode_ids(zs)
        # the encode against the plain path's
        with plain_path(*ops):
            z1_plain = session.encode_svg(first)
        z_rms = rel_rms(z1, z1_plain)
        layers = list(session.model.decoder.decoder.layers)
        z_gate = session.interpolation_latents(z1, z2, n=N_AR_GATE)
        gate = path_gate(f"session decode of {N_AR_GATE} interpolation latents",
                         session.model, ops, lambda: cut_layers(layers, AR_CONTROL_DROP_BITS),
                         hold_logits=False, commands=None, args=None, z=z_gate)
    check_later(z_rms <= DATA_LATENT_RMS,
                f"session encode: kernel path against plain path, relative RMS {z_rms}")
    valid_share = check_sample(*ids, N_INTERP, session.model.cfg)
    texts = [svg.to_str() for svg in frames]
    reparsed = [len(list(SVG.from_str(t).paths)) for t in texts]
    check(len(frames) == N_INTERP and all(n > 0 for n in reparsed),
          f"interpolation frames back to SVG text and parsed again: {reparsed} paths")
    with torch.no_grad():
        enc_ms = cuda_median_ms(lambda: session.encode_svg(first), iters=10, warmup=2)
        dec_ms = cuda_median_ms(lambda: session.decode_ids(zs), iters=10, warmup=2)
    t0 = time.perf_counter()
    session.interpolate_svg(first, second, n=N_INTERP)
    interp_s = time.perf_counter() - t0
    print(f"session on {card}: encode_svg {enc_ms:.3f} ms (CUDA events, median of 10, the "
          f"host's packing included), decode of {N_INTERP} latents {dec_ms:.3f} ms; "
          f"interpolate_svg n={N_INTERP} to SVG documents {interp_s * 1e3:.1f} ms (host clock); "
          f"encode against the plain path: relative RMS {z_rms:.3g} (limit {DATA_LATENT_RMS}); "
          f"valid argument share {valid_share:.4f}; frames reparsed with {reparsed} paths",
          flush=True)
    out["session"] = {"encode_svg_ms": enc_ms, "decode_ms": dec_ms, "interpolate_svg_s": interp_s,
                      "n": N_INTERP, "encode_vs_plain_rel_rms": z_rms, "gate": gate,
                      "valid_share": valid_share, "reparsed_paths": reparsed}

    # =========================== (5) the animation: finetune, in-betweens
    project = animate.DeepSVGProject(root_dir=root)
    project.frames = [animate.Frame(0, keyframe=True, svg=first)] + \
        [animate.Frame(i) for i in range(1, N_BETWEEN + 1)] + \
        [animate.Frame(N_BETWEEN + 1, keyframe=True, svg=second)]
    params = [p.detach().clone() for p in session.model.parameters()]
    z_before = session.encode_svg(first)
    acfg = load_config(config, 1)
    n_steps = min(FINETUNE_STEPS, -(-2 * FINETUNE_AUGS // acfg.batch_size))
    log = io.StringIO()

    def animation():
        with contextlib.redirect_stdout(log):
            return animate.compute_interpolation(session, project, cfg=acfg,
                                                 nb_augmentations=FINETUNE_AUGS,
                                                 max_steps=FINETUNE_STEPS)
    t0 = time.perf_counter()
    tuned = counted("compute_interpolation (finetune + in-betweens)", animation,
                    added(times(n_steps, step_launches), times(2, encode_launches),
                          decode_launches))
    anim_s = time.perf_counter() - t0
    check(tuned is not session and all(f.svg.svg_path_groups for f in project.frames),
          "compute_interpolation did not fill the frames from a new session")
    check(all(torch.equal(a, b) for a, b in zip(params, session.model.parameters()))
          and torch.equal(session.encode_svg(first), z_before),
          "the finetune changed the live session")
    check(any(not torch.equal(a, b) for a, b in zip(params, tuned.model.parameters())),
          "the finetune did not move the parameters")
    print(f"compute_interpolation on {card}: finetune of {n_steps} steps at B={acfg.batch_size} "
          f"on 2 keyframes x {FINETUNE_AUGS}, then {N_BETWEEN} in-betweens, in {anim_s:.2f} s "
          f"(host clock); the live session unchanged; {log.getvalue().strip().splitlines()}",
          flush=True)
    out["animation"] = {"finetune_steps": n_steps, "in_betweens": N_BETWEEN, "wall_s": anim_s}
    del tuned
    torch.cuda.empty_cache()

    # ============================================= (6) the web GUI over HTTP
    server = make_server(port=0, session=session, train_cfg=None)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(route, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + route, data=data, method="GET" if data is None
                                     else "POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as res:
            return json.loads(res.read())

    def stroke(cx, cy, r):
        pts = [[cx + r * np.cos(2 * np.pi * t / 40), cy + r * np.sin(2 * np.pi * t / 40)]
               for t in range(41)]
        call("/api/pointer", {"type": "down", "pos": pts[0]})
        for p in pts[1:]:
            call("/api/pointer", {"type": "move", "pos": p})
        return call("/api/pointer", {"type": "up"})

    try:
        t0 = time.perf_counter()
        call("/api/tool", {"tool": 2})
        stroke(128, 128, 60)
        for _ in range(GUI_FRAMES - 1):
            call("/api/frame/add", {})
        res = stroke(160, 100, 35)
        check(res["state"]["timeline"]["frames"] == [True] + [False] * (GUI_FRAMES - 2) + [True],
              f"web GUI keyframes {res['state']['timeline']}")
        counted("web GUI /api/interpolate", lambda: call("/api/interpolate", {}),
                added(times(2, encode_launches), decode_launches))
        filled = []
        for i in range(GUI_FRAMES):
            st = call("/api/frame/select", {"index": i})["state"]
            filled.append(sum(len(p["segments"]) for p in st["paths"]))
        state = call("/api/state")
        gui_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    check(all(n > 0 for n in filled) and state["has_session"],
          f"web GUI frames' segments after /api/interpolate: {filled}")
    print(f"web GUI on a thread: {GUI_FRAMES} frames, 2 pencil keyframes, /api/interpolate from "
          f"the card; segments by frame {filled}; {gui_s:.2f} s (host clock)", flush=True)
    out["webgui"] = {"frames": GUI_FRAMES, "segments": filled, "wall_s": gui_s}
    tmp.cleanup()
    del session
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"data and apps phase: {out['phase_s']:.1f} s on {card}", flush=True)
    record["data_apps"] = out
    return launches


SERVED_CHILD = """
import sys, torch
from deepsvg_tpu_torch.serving import load_session_exports
from deepsvg_tpu_torch.ops import embedding, head, layer
out_dir, inputs, result = sys.argv[1:4]
fns = load_session_exports(out_dir)
ops = torch.load(inputs)
kernels = (embedding.fused_embedding, layer.fused_layer, head.fused_head_argmax)
def counts():
    c = {f.__name__: f.launches for f in kernels}
    c.update({f.__name__ + "_f32": f.float32_launches for f in kernels})
    for f in kernels:
        f.launches = f.float32_launches = 0
    return c
counts()
z = fns["encode"][64](ops["commands"], ops["args"])
enc = counts()
cmds, args = fns["decode"][64](z.float())
dec = counts()
if z.is_cuda:
    torch.cuda.synchronize()
loaded = sorted(m for m in sys.modules if m.startswith(("deepsvg_tpu_torch.models",
    "deepsvg_tpu_torch.configs", "deepsvg_tpu_torch.training", "deepsvg_tpu_torch.data",
    "jax", "flax", "deepsvg_tpu.")))
ours = sorted(m for m in sys.modules if m.startswith("deepsvg_tpu_torch"))
torch.save({"z": z.cpu(), "cmds": cmds.cpu(), "args": args.cpu(), "enc": enc, "dec": dec,
            "forbidden": loaded, "modules": ours}, result)
"""


def serving_phase(dev, card, record, reset_counts, read_counts):
    """The serving export on the card (see the module docstring). Returns
    the parallel phase's gloo workers, started before Sketchformer's export
    (:func:`start_parallel_workers`)."""
    import shutil
    import tempfile

    from deepsvg_tpu_torch import serving
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import (
        gpu_fast, greedy_sample, hierarchical_ordered, load_model)
    from deepsvg_tpu_torch.models import SVGTransformer
    from deepsvg_tpu_torch.training.trainer import init_parameters
    t_phase = time.perf_counter()
    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="served_")
    try:
        def live(model, c, a):
            with torch.no_grad():
                z = model.encode(c, a)[0]
            return z, greedy_sample(model, z=z.float())

        def served_counts(fn, *ops):
            reset_counts()
            res = fn(*ops)
            return res, {k: v for k, v in read_counts().items() if v}

        def inputs(cfg, n, seed, grouped=False):
            b = generate_batch(np.random.default_rng(seed), n, cfg.max_num_groups,
                               cfg.max_seq_len)
            c = b["commands_grouped" if grouped else "commands"]
            a = b["args_grouped" if grouped else "args"]
            return (torch.from_numpy(c.astype(np.int32)).to(dev),
                    torch.from_numpy(a.astype(np.float32)).to(dev))

        for name, cfg, buckets, expect in (
                ("bf16", gpu_fast(hierarchical_ordered()), SERVE_BUCKETS,
                 ({"embedding": 1, "layer": 4, "layer_f32": 4}, {"layer": 8, "head": 1})),
                ("float32", hierarchical_ordered(), SERVE_BUCKETS[-1:],
                 ({"embedding_f32": 1, "layer_f32": 8}, {"layer_f32": 8, "head_f32": 1}))):
            model = load_model(CHECKPOINT, cfg, device=dev)
            folder = os.path.join(tmp, name)
            t0 = time.perf_counter()
            serving.export_session(model, folder, batch_sizes=buckets)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fns = serving.load_session_exports(folder)
            load_s = time.perf_counter() - t0
            r = {"export_s": export_s, "load_s": load_s, "buckets": list(buckets)}
            c, a = inputs(cfg, 64, 30)
            z_live, (cmd_live, args_live) = live(model, c, a)
            z, enc_counts = served_counts(fns["encode"][64], c, a)
            (cmds, args), dec_counts = served_counts(fns["decode"][64], z.float())
            r["z_max_abs_diff"] = float((z.float() - z_live.float()).abs().max())
            r["ids_equal"] = bool(torch.equal(cmds, cmd_live) and torch.equal(args, args_live))
            r["encode_launches"], r["decode_launches"] = enc_counts, dec_counts
            check(r["ids_equal"], f"served {name} decode: ids differ from the live decode")
            check(enc_counts == expect[0] and dec_counts == expect[1],
                  f"served {name} launches {enc_counts}, {dec_counts}; expected {expect}")
            check(torch.isfinite(z.float()).all().item(), f"served {name}: z not finite")
            r["ms"] = {
                "encode": served_and_live(lambda: fns["encode"][64](c, a),
                                          lambda: live_encode(model, c, a), ITERS),
                "decode": served_and_live(lambda: fns["decode"][64](z.float()),
                                          lambda: greedy_sample(model, z=z.float()), ITERS)}
            if name == "bf16":
                # bucket 1, and a ragged batch routed to bucket 64
                z1 = fns["encode"][1](c[:1], a[:1])
                r["z_b1_max_abs_diff"] = float((z1.float() - z_live[:1].float()).abs().max())
                zr = serving.serve_batch(fns, "encode", c[:SERVE_RAGGED], a[:SERVE_RAGGED])
                cr, ar = serving.serve_batch(fns, "decode", zr.float())
                check(zr.shape[0] == cr.shape[0] == SERVE_RAGGED,
                      f"serve_batch of {SERVE_RAGGED} rows came back with {zr.shape[0]}")
                zl_r, (cl_r, al_r) = live(model, c[:SERVE_RAGGED], a[:SERVE_RAGGED])
                r["ragged"] = {"rows": SERVE_RAGGED, "bucket": 64,
                               "z_max_abs_diff": float((zr.float() - zl_r.float()).abs().max()),
                               "ids_equal": bool(torch.equal(cr, cl_r) and torch.equal(ar, al_r))}
                check(r["ragged"]["ids_equal"], "served ragged batch: ids differ from live")
                # the artifacts in a process with no model code: it runs while
                # Sketchformer exports, and is read after
                ops_path = os.path.join(tmp, "ops.pt")
                torch.save({"commands": c, "args": a}, ops_path)
                child = (time.perf_counter(), os.path.join(tmp, "child.pt"), subprocess.Popen(
                    [sys.executable, "-c", SERVED_CHILD, folder, ops_path,
                     os.path.join(tmp, "child.pt")], cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True, env=dict(os.environ, PYTHONPATH=ROOT)))
                child_ref = (z_live.float().cpu(), cmd_live.cpu(), args_live.cpu())
            out[name] = r
            print(f"served {name} at buckets {list(buckets)}: export {export_s:.1f} s, load "
                  f"{load_s:.1f} s; z max abs diff {r['z_max_abs_diff']:.3g}, ids equal "
                  f"{r['ids_equal']}; launches encode {enc_counts}, decode {dec_counts}; "
                  + serve_times(r["ms"]) + f" on {card}", flush=True)
            if name == "bf16":
                print(f"  bucket 1 z diff {r['z_b1_max_abs_diff']:.3g}; ragged {r['ragged']}",
                      flush=True)
            del model, fns
            torch.cuda.empty_cache()

        # Sketchformer's decoder, unrolled over its 240 steps: its export runs on
        # the host while the card runs the parallel phase's gloo workers
        workers = start_parallel_workers(dev)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    try:
        from deepsvg_tpu_torch.configs.sketchformer import make_model_config
        cfg = dataclasses.replace(make_model_config(), use_vae=False)
        model = SVGTransformer(cfg)
        init_parameters(model, torch.Generator().manual_seed(AR_SEED))
        model = model.to(dev).eval()
        folder = os.path.join(tmp, "sketchformer")
        t0 = time.perf_counter()
        serving.export_session(model, folder, batch_sizes=(SF_SERVE_BUCKET,))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fns = serving.load_session_exports(folder)
        load_s = time.perf_counter() - t0
        t0, res_path, proc = child
        log, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"serving child failed:\n{log[-3000:]}")
        got = torch.load(res_path)
        z_ref, cmd_ref, args_ref = child_ref
        out["bf16"]["child"] = r = {
            "s": time.perf_counter() - t0, "modules": got["modules"],
            "forbidden": got["forbidden"], "encode": got["enc"], "decode": got["dec"],
            "z_max_abs_diff": float((got["z"].float() - z_ref).abs().max()),
            "ids_equal": bool(torch.equal(got["cmds"], cmd_ref)
                              and torch.equal(got["args"], args_ref))}
        check(not got["forbidden"], f"the serving child imported {got['forbidden']}")
        check(r["ids_equal"], "the serving child's ids differ from live")
        check(got["enc"]["fused_embedding"] == 1 and got["dec"]["fused_head_argmax"] == 1,
              f"the serving child's launches {got['enc']}, {got['dec']}")
        print(f"  serving child (beside the export): {r['s']:.1f} s, modules {r['modules']}, "
              f"launches {r['encode']}, {r['decode']}, ids equal {r['ids_equal']}, z diff "
              f"{r['z_max_abs_diff']:.3g}", flush=True)
        c, a = inputs(cfg, SF_SERVE_BUCKET, 31, grouped=True)
        z_live, (cmd_live, args_live) = live(model, c, a)
        z, enc_counts = served_counts(fns["encode"][SF_SERVE_BUCKET], c, a)
        (cmds, args), dec_counts = served_counts(fns["decode"][SF_SERVE_BUCKET], z.float())
        r = {"export_s": export_s, "load_s": load_s, "bucket": SF_SERVE_BUCKET,
             "z_max_abs_diff": float((z.float() - z_live.float()).abs().max()),
             "ids_equal": bool(torch.equal(cmds, cmd_live) and torch.equal(args, args_live)),
             "encode_launches": enc_counts, "decode_launches": dec_counts}
        check(r["ids_equal"], "served Sketchformer decode: ids differ from the live sampler")
        check(dec_counts == {"decode": cfg.max_total_len, "head": cfg.max_total_len},
              f"served Sketchformer decode launches {dec_counts}")
        r["ms"] = {"decode": served_and_live(
            lambda: fns["decode"][SF_SERVE_BUCKET](z.float()),
            lambda: greedy_sample(model, z=z.float()), SERVE_ITERS, warmup=1, busy_iters=1)}
        out["sketchformer"] = r
        print(f"served Sketchformer decode at bucket {SF_SERVE_BUCKET}: export {export_s:.1f} s "
              f"(encode and the unrolled decode), load {load_s:.1f} s; ids equal "
              f"{r['ids_equal']}; launches encode {enc_counts}, decode {dec_counts}; "
              + serve_times(r["ms"]) + f" on {card}", flush=True)
        del model, fns
    except BaseException:
        for p in [child[2]] + [p for _, _, p in workers[2]]:
            p.kill()
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    record["serving"] = out
    torch.cuda.empty_cache()
    return workers


def served_and_live(served, live, iters: int, warmup: int = 3, busy_iters: int = 5) -> dict:
    """A served call and the live call it stands for, timed in turns
    (served, live, live, served): the median of each turn's CUDA-event
    times, and each call's device busy time under the profiler."""
    turns = [cuda_median_ms(fn, iters, warmup) for fn in (served, live, live, served)]
    return {"served_ms": [turns[0], turns[3]], "live_ms": [turns[1], turns[2]],
            "served_busy_ms": device_busy_ms(served, busy_iters),
            "live_busy_ms": device_busy_ms(live, busy_iters)}


def serve_times(ms: dict) -> str:
    def busy(v):
        return "not measured" if v is None else f"{v:.3f}"
    return "; ".join(
        f"{name} served {t['served_ms'][0]:.3f} / {t['served_ms'][1]:.3f} ms (busy "
        f"{busy(t['served_busy_ms'])}), live {t['live_ms'][0]:.3f} / {t['live_ms'][1]:.3f} "
        f"(busy {busy(t['live_busy_ms'])})" for name, t in ms.items())


def live_encode(model, c, a):
    with torch.no_grad():
        return model.encode(c, a)[0]


def parallel_batch(cfg, dev):
    from deepsvg_tpu_torch.data import generate_batch
    b = generate_batch(np.random.default_rng(PARALLEL_SEED), B_RECIPE, cfg.max_num_groups,
                       cfg.max_seq_len)
    return {k: torch.from_numpy(b[k]).to(dev) for k in ("commands", "args")}


def parallel_model(compute_dtype: str, dev):
    """The trained flagship at dropout 0, its optimizer and a fresh state."""
    from deepsvg_tpu_torch.models import hierarchical_ordered, load_model
    from deepsvg_tpu_torch.training import constant, create_train_state, make_optimizer
    cfg = dataclasses.replace(hierarchical_ordered(), dropout=0.0, compute_dtype=compute_dtype)
    model = load_model(CHECKPOINT, cfg, device=dev)
    optimizer = make_optimizer(constant(LR))
    return model, optimizer, create_train_state(model, optimizer, init=False)


def step_record(res, state) -> dict:
    """A step's results, parameters and, from Adam's first moment after one
    step (``(1 - b1)`` times the clipped gradient), its gradients' direction."""
    names = [k for k, _ in state.model.named_parameters()]
    return {"res": {k: float(v) for k, v in res.items()},
            "params": {k: v.detach().float().cpu() for k, v in state.model.named_parameters()},
            "mu": dict(zip(names, (m.float().cpu() for m in state.opt_state["mu"])))}


def parallel_worker(spec_path: str, rank: int) -> int:
    """One rank of the parallel phase's gloo runs on the one card: the
    float32 flagship's data-parallel step (``dp``) or tensor-parallel step
    (``tp``) at B=60; rank 0 writes the step's results and parameters."""
    import torch.distributed as dist

    from deepsvg_tpu_torch.parallel import (
        gather_params_tp, make_mesh, make_parallel_train_step, make_tp_train_step,
        shard_batch, shard_state_tp)
    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}", rank=rank,
                            world_size=spec["world"])
    try:
        model, optimizer, state = parallel_model("float32", dev)
        batch = parallel_batch(model.cfg, dev)
        if spec["kind"] == "dp":
            mesh = make_mesh(spec["world"])
            step = make_parallel_train_step(model, optimizer, MODEL_ARGS, mesh)
            local = shard_batch(batch, mesh)
            reset_counts()
            state, res = step(state, local, LOSS_WEIGHTS)
            out = step_record(res, state)
            out["launches"] = {k: v for k, v in read_counts().items() if v}
            out["rows"] = int(local["commands"].shape[0])
        else:
            mesh = make_mesh(spec["world"], model_axis="model", n_model=spec["world"])
            tp_state = shard_state_tp(state, mesh)
            step = make_tp_train_step(model, optimizer, MODEL_ARGS, mesh, tp_state)
            tp_state, res = step(tp_state, shard_batch(batch, mesh), LOSS_WEIGHTS)
            out = {"res": {k: float(v) for k, v in res.items()},
                   "params": {k: v.float().cpu() for k, v in gather_params_tp(tp_state).items()},
                   "mu": {},
                   "local_qkv": [tuple(v.shape) for k, v in tp_state.model.named_parameters()
                                 if k.endswith("qkv.weight")]}
        if rank == 0:
            torch.save(out, spec["out"])
    finally:
        dist.destroy_process_group()
    return 0


def against_single(what, got, ref, before) -> dict:
    """A parallel step's results and parameters against a single-process
    step's: the loss terms (F32_STEP_LOSS), the gradient norm
    (TOL_STEP_NORM), the parameters' update (cosine TOL_STEP_COSINE) and,
    where the run kept them, the gradients read from Adam's first moment
    (cosine TOL_STEP_COSINE, median leaf RMS F32_STEP_MEDIAN_LEAF_RMS)."""
    losses = {k: abs(got["res"][k] - ref["res"][k]) / max(abs(ref["res"][k]), 1e-30)
              for k in ("loss", "loss_visibility", "loss_cmd", "loss_args")}
    norm = abs(got["res"]["grad_norm"] - ref["res"]["grad_norm"]) / ref["res"]["grad_norm"]

    def cosine(a, b):
        a = torch.cat([t.flatten() for t in a]).double()
        b = torch.cat([t.flatten() for t in b]).double()
        return float(a @ b / a.norm() / b.norm())

    update = cosine([got["params"][k] - before[k] for k in before],
                    [ref["params"][k] - before[k] for k in before])
    out = {"loss_rel_diff": max(losses.values()), "losses": losses, "grad_norm_rel_diff": norm,
           "update_cosine": update,
           "max_abs_param_diff": float(max((got["params"][k] - ref["params"][k]).abs().max()
                                           for k in before))}
    check_later(out["loss_rel_diff"] <= F32_STEP_LOSS,
                f"{what}: loss terms {losses} against the single step (limit {F32_STEP_LOSS})")
    check_later(norm <= TOL_STEP_NORM, f"{what}: grad_norm off by {norm:.3g}")
    check_later(update >= TOL_STEP_COSINE, f"{what}: update cosine {update:.6f}")
    if got["mu"]:
        out["grad_cosine"] = cosine([got["mu"][k] for k in before], [ref["mu"][k] for k in before])
        out["grad_median_leaf_rms"] = statistics.median(
            rel_rms(got["mu"][k], ref["mu"][k]) for k in before)
        check_later(out["grad_cosine"] >= TOL_STEP_COSINE,
                    f"{what}: gradient cosine {out['grad_cosine']:.6f}")
        check_later(out["grad_median_leaf_rms"] <= F32_STEP_MEDIAN_LEAF_RMS,
                    f"{what}: median leaf RMS {out['grad_median_leaf_rms']:.3g}")
    return out


def start_parallel_workers(dev):
    """Start the parallel phase's gloo runs, two ranks each of the
    data-parallel and the tensor-parallel step (``--parallel-worker``):
    ``(folder, result paths, processes)``."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="parallel_")
    children, results = [], {}
    for kind in ("dp", "tp"):
        results[kind] = os.path.join(tmp, f"{kind}.pt")
        spec = os.path.join(tmp, f"{kind}.json")
        with open(spec, "w") as f:
            json.dump({"kind": kind, "world": 2, "store": os.path.join(tmp, f"{kind}_store"),
                       "out": results[kind], "device": str(dev)}, f)
        children += [(kind, rank, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker", spec, str(rank)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for rank in range(2)]
    return tmp, results, children


def parallel_phase(dev, card, record, reset_counts, read_counts, workers) -> None:
    """Data and tensor parallelism on the card (see the module docstring);
    ``workers`` from :func:`start_parallel_workers`."""
    import shutil

    import torch.distributed as dist

    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.parallel import make_mesh, make_parallel_train_step, shard_batch
    from deepsvg_tpu_torch.training import train_step
    t_phase = time.perf_counter()
    out: dict = {}
    tmp, results, children = workers
    try:
        # ---- one rank on NCCL, in this process: the recipe's bf16 step at B=60
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
                                rank=0, world_size=1)
        try:
            model, optimizer, state = parallel_model("bfloat16", dev)
            batch = parallel_batch(model.cfg, dev)
            state, res = train_step(state, batch, LOSS_WEIGHTS, optimizer, MODEL_ARGS)
            single = step_record(res, state)
            model, optimizer, state = parallel_model("bfloat16", dev)
            mesh = make_mesh(1)
            step = make_parallel_train_step(model, optimizer, MODEL_ARGS, mesh)
            local = shard_batch(batch, mesh)
            reset_counts()
            state, res = step(state, local, LOSS_WEIGHTS)
            dp1 = step_record(res, state)
            launches = {k: v for k, v in read_counts().items() if v}
        finally:
            dist.destroy_process_group()
        expect = {"embedding": 1, "layer_train_fwd": 8, "layer_train_bwd": 8, "stack_fwd": 2,
                  "stack_bwd": 2, "args_ce_fwd": 1, "args_ce_bwd": 1, "embedding_bwd": 1}
        equal = dp1["res"] == single["res"] and all(
            torch.equal(dp1["params"][k], v) for k, v in single["params"].items())
        out["nccl_1"] = {"launches": launches, "equal_to_single": equal,
                         "loss": dp1["res"]["loss"]}
        check(launches == expect, f"DP step at one rank: launches {launches}, expected {expect}")
        check(equal, "DP step at one rank on NCCL differs from the single-process step")
        print(f"DP step B={B_RECIPE} at 1 rank (NCCL): launches {launches}; equal to the "
              f"single-process step: {equal}", flush=True)
        del model, state, step
        torch.cuda.empty_cache()

        # ---- the references of the gloo runs: float32 at B=60, the kernel
        # path's step and the plain path's
        model, optimizer, state = parallel_model("float32", dev)
        before = {k: v.detach().float().cpu().clone() for k, v in model.named_parameters()}
        batch = parallel_batch(model.cfg, dev)
        state, res = train_step(state, batch, LOSS_WEIGHTS, optimizer, MODEL_ARGS)
        ref_kernel = step_record(res, state)
        model, optimizer, state = parallel_model("float32", dev)
        with matmul_tf32(False), plain_path(emb_ops, layer_ops, head_ops, layer_vjp, ce_ops,
                                            stack_vjp):
            state, res = train_step(state, batch, LOSS_WEIGHTS, optimizer, MODEL_ARGS)
        ref_plain = step_record(res, state)
        del model, state
        torch.cuda.empty_cache()
    finally:
        logs = {}
        for kind, rank, p in children:
            try:
                logs[(kind, rank)], _ = p.communicate(timeout=PARALLEL_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                logs[(kind, rank)], _ = p.communicate()
    for kind, rank, p in children:
        check(p.returncode == 0, f"parallel {kind} rank {rank} failed ({p.returncode}):\n"
                                 f"{logs[(kind, rank)][-3000:]}")
    dp2, tp = torch.load(results["dp"]), torch.load(results["tp"])
    out["gloo_dp_2"] = dict(against_single("DP at 2 ranks (gloo, float32)", dp2, ref_kernel,
                                           before), launches_per_rank=dp2["launches"],
                            rows_per_rank=dp2["rows"])
    out["gloo_tp_1x2"] = dict(against_single("TP at 1 x 2 (gloo, float32)", tp, ref_plain,
                                             before), local_qkv=tp["local_qkv"])
    expect = {"embedding_f32": 1, "layer_train_long_fwd_f32": 8,
              "layer_train_long_bwd_f32": 8, "stack_fwd": 2, "stack_bwd": 2,
              "args_ce_fwd_f32": 1, "args_ce_bwd_f32": 1, "embedding_bwd": 1}
    check_later(dp2["launches"] == expect,
                f"DP at 2 ranks: launches a rank {dp2['launches']}, expected {expect}")
    for key in ("gloo_dp_2", "gloo_tp_1x2"):
        r = out[key]
        print(f"{key} B={B_RECIPE}: loss terms rel diff {r['loss_rel_diff']:.3g} (limit "
              f"{F32_STEP_LOSS}), grad_norm {r['grad_norm_rel_diff']:.3g} (limit "
              f"{TOL_STEP_NORM}), update cosine {r['update_cosine']:.6f} (limit "
              f"{TOL_STEP_COSINE}), largest parameter difference "
              f"{r['max_abs_param_diff']:.3g}"
              + (f"; gradients (Adam's first moment) cosine {r['grad_cosine']:.6f}, median "
                 f"leaf RMS {r['grad_median_leaf_rms']:.3g} (limit {F32_STEP_MEDIAN_LEAF_RMS})"
                 if "grad_cosine" in r else ""), flush=True)
    print(f"  DP launches a rank: {dp2['launches']}; TP local qkv {tp['local_qkv'][0]}",
          flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    record["parallel"] = out


# The head dims of the first port's kernels (head_dims_phase). Every kernel
# that ran at head dim 32 alone below the Hopper forms' widths (K2, K4, K7,
# K9, K10, K11) runs at head dim 8 (D=32, 4 heads, FF 64: configs/test_tiny.py
# and the JAX tests' SMALL model) and 16 (D=64, 4 heads, FF 128: the JAX
# tests' K10 width), in both types, against its plain version with the
# limits its D=256 checks use above (K9: TOL_DECODE_RMS; K11's gradients:
# MHA_GRAD_RMS; K7: check_stack_train's); a control, the plain version on the
# weights cut to CONTROL_MANTISSA_BITS mantissa bits, must fail each gate.
# K4's gradients hold their fraction of elements outside the band with the
# ReLU units aligned, as K7's seeded D=128 layers do: on random weights at
# these widths a unit flipped between the two forward passes (TF32 against
# full float32) moves a whole row of dW1, 1/F of its elements (1.6% at F=64),
# over TOL_GRAD_OUTLIERS; the first card run read up to 0.0166 of dW1 as they
# are and at most 0.0007 relative RMS with the units aligned (PERF.md).
# Then the tiny configs' paths through the model code, counted with no plain
# version called: test_tiny's one_shot_sample, its CLI steps and one served
# bucket, SMALL's step at dropout 0.1 (E2 and D2 through K7, in both of K4's
# modes) and the one-stage autoregressive SMALL model's greedy_sample (K9).
HD_SHAPES = {8: (32, 4, 64), 16: (64, 4, 128)}   # head dim: D, heads, F
HD_SEED = 24
# the other widths the routing rules send to the first port's kernels, each
# family held there too (untimed): D=128 with 4 heads of 32 (bfloat16 K2 and
# K4 at this width were refused before) and D=256 with 16 heads of 16
HD_WIDE = ((128, 4, 512), (256, 16, 512))   # D, heads, F
HD_B = 512                 # sequences of a layer check: hundreds of blocks of every form
# the JAX tests' K10 widths (head dims 16, 16, 8); each head dim's timed
# width (HD_SHAPES) comes last
HD_MHA_WIDTHS = ((32, 2), (64, 4), (32, 4))
HD_MHA_S = (8, 16, 31, 32, 40)                # their S, and one long case
HD_DECODE = (1024, 41, 2)  # K9: rows, cache length, layers (index 1 and the last)
HD_N = 1024                # the tiny paths' inference batch
HD_SMALL_B = 16            # SMALL's step: E1, D1 over the stack gate, E2 and D2 under it
HD_CLI_STEPS = 8
HD_SERVE_BUCKET = 8
# the JAX tests' SMALL model (tests/test_model.py) and its one-stage
# autoregressive variant (tests/test_ops.py, TestFusedDecodeStep)
HD_SMALL = dict(max_num_groups=4, max_seq_len=8, d_model=32, dim_feedforward=64, dim_z=16,
                n_layers=2, n_layers_decode=2, n_heads=4, dropout=0.1)
HD_AR = dict(HD_SMALL, dropout=0.0, max_num_groups=2, max_seq_len=5, encode_stages=1,
             decode_stages=1, pred_mode="autoregressive", rel_targets=False)
# each family's source and the TPU kernel it replaces, by entry name prefix
HD_FAMILIES = {
    "layer": ("layer_fwd.cuh", "deepsvg_tpu/ops/layer.py:108"),
    "layer_long": ("layer_long.cuh", "deepsvg_tpu/ops/layer.py:108"),
    "layer_train_fwd": ("layer_fwd.cuh", "deepsvg_tpu/ops/layer_vjp.py:179"),
    "layer_train_bwd": ("layer_bwd.cuh", "deepsvg_tpu/ops/layer_vjp.py:281"),
    "layer_train_long_fwd": ("layer_long.cuh", "deepsvg_tpu/ops/layer_vjp.py:179"),
    "layer_train_long_bwd": ("layer_long_train.cu", "deepsvg_tpu/ops/layer_vjp.py:281"),
    "stack_fwd": ("stack.cu", "deepsvg_tpu/ops/stack_vjp.py:87"),
    "stack_bwd": ("stack.cu", "deepsvg_tpu/ops/stack_vjp.py:159"),
    "decode": ("decode.cu", "deepsvg_tpu/ops/decode.py:43"),
    "mha": ("attention.cu", "deepsvg_tpu/ops/attention.py:31"),
    "mha_train_fwd": ("attention.cu", "deepsvg_tpu/ops/attention_vjp.py:60"),
    "mha_train_bwd": ("attention.cu", "deepsvg_tpu/ops/attention_vjp.py:100"),
}


def hd_name(family: str, hd: int, dtype) -> str:
    """The kernels line's name of a family's form at head dim ``hd``."""
    return f"{family}_hd{hd}" + ("_f32" if dtype == torch.float32 else "")


def hd_sources() -> dict:
    """Every head-dims entry's (source, replaces), for the kernels line."""
    return {hd_name(fam, hd, dt): ("deepsvg_tpu_torch/ops/csrc/" + src, rep)
            for fam, (src, rep) in HD_FAMILIES.items() for hd in HD_SHAPES
            for dt in (torch.bfloat16, torch.float32)}


def seeded_layers(n: int, d: int, heads: int, f: int, dtype, dev, gen) -> list:
    """``n`` encoder layers at these widths with random masters from
    ``gen`` (LayerNorms near 1 and 0, weights at 1/sqrt(fan-in))."""
    from deepsvg_tpu_torch.models.layers import EncoderLayerImproved
    layers = []
    for _ in range(n):
        layer = EncoderLayerImproved(d, heads, f, 0.0, dtype).to(dev)
        with torch.no_grad():
            for w in layer.masters():
                noise = torch.randn(w.shape, device=dev, generator=gen)
                if w.dim() == 2 and w.shape[0] == 2:        # LayerNorm: scale, bias
                    w.copy_(0.1 * noise + torch.tensor([[1.0], [0.0]], device=dev))
                else:
                    w.copy_(noise * (w.shape[1] ** -0.5 if w.dim() == 2 else 0.1))
        layers.append(layer)
    return layers


def head_dims_phase(dev, card, kernels, record, reset_counts, read_counts) -> dict:
    """The first port's kernels at head dims 8 and 16 (see HD_SHAPES), each
    against its plain version with a control, timed beside its bound, its
    plain version and its library call; the same checks, untimed, at
    HD_WIDE; then the tiny configs' paths, counted. Adds the ``*_hd8`` /
    ``*_hd16`` entries to ``kernels`` and returns their launches: of the
    path that runs each at head dim 8, else as its own counted call read
    them."""
    import shutil
    import tempfile

    import torch.nn.functional as F

    from deepsvg_tpu_torch import serving
    from deepsvg_tpu_torch.configs.test_tiny import make_model_config as tiny_config
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import SVGTransformer, greedy_sample, one_shot_sample
    from deepsvg_tpu_torch.models.config import hierarchical
    from deepsvg_tpu_torch.ops import attention as attn_ops
    from deepsvg_tpu_torch.ops import attention_vjp
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import decode as decode_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)
    from deepsvg_tpu_torch.training import train as train_mod
    from deepsvg_tpu_torch.training.config import load_config
    from deepsvg_tpu_torch.training.trainer import init_parameters
    t_phase = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(HD_SEED)
    no_launch = dict.fromkeys(read_counts(), 0)
    own, path_launches, out = {}, {}, {}

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)

    def key_mask(b, s):
        """Additive [B, S]: random lengths, sequence 0 with every key masked."""
        lens = torch.randint(1, s + 1, (b,), device=dev, generator=gen)
        mask = torch.zeros(b, s, device=dev).masked_fill(
            torch.arange(s, device=dev)[None] >= lens[:, None], float("-inf"))
        mask[0] = float("-inf")
        return mask

    seen = {}     # the launches that each counted call read, by counter

    def counted(what, fn, expected):
        """``fn()`` once with the counters from 0; they must read ``expected``
        (kept in ``seen``, for the kernels line)."""
        torch.cuda.synchronize()
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        got = read_counts()
        check(got == no_launch | expected, f"{what}: launches {got}, expected {expected}")
        seen.update({k: got[k] for k in expected})
        return res

    def suffix(dtype):
        return "_f32" if dtype == f32 else ""

    def limits(dtype):
        return (TOL_F32_ATOL, TOL_F32_RTOL) if dtype == f32 else (TOL_LAYER_ATOL,
                                                                 TOL_LAYER_RTOL)

    def hold(what, got, want, want_cut, dtype, rms_limit=TOL_LAYER_RMS, atol_scale=1.0):
        """``got`` against the plain version ``want`` (check_later), and the
        same gate against ``want_cut``, the control, which must fail."""
        atol, rtol = limits(dtype)
        atol *= atol_scale
        res = compare_elementwise(what, got, want, rms_limit, atol, rtol)
        diff = (got.float() - want_cut.float()).abs()
        c_excess = (diff - rtol * want_cut.float().abs()).max().item()
        c_rms = rel_rms(got, want_cut)
        res["control_failed"] = not (c_excess <= atol and c_rms <= rms_limit)
        check(res["control_failed"], f"{what}: the gate passed its control (excess "
                                     f"{c_excess}, relative RMS {c_rms})")
        return res

    def cut(t):
        return cut_mantissa(t.detach(), CONTROL_MANTISSA_BITS).to(t.dtype)

    def cut_weights(ws, idx=(1, 3, 6, 8)):
        """A layer's ten weights with wqkv, wo, w1 and w2 cut."""
        return [cut(w) if i in idx else w for i, w in enumerate(ws)]

    def entry(name, cases, ms, plain_ms, library_ms, b_ms_by, max_abs_err, launches):
        kernels[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=b_ms_by[0], bound_by=b_ms_by[1], max_abs_err=max_abs_err,
                             cases=cases)
        own[name] = launches
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f}, library "
              f"{'none' if library_ms is None else f'{library_ms:.4f}'}, bound "
              f"{b_ms_by[0]:.5f} by {b_ms_by[1]}); max abs err {max_abs_err:.3g} on {card}",
              flush=True)

    def lib_layer(layer, dtype, train=False):
        return transformer_layer(layer, dtype, dev, train)

    # ---- each family's check at one width and type, against its plain
    # version with a control; ``label`` names the width in the messages

    def check_k2(layer, d, dtype, shapes, label):
        """K2 at each (S, B, causal, seq_bias) of ``shapes``: one counted
        call each, under the short form's counter (S <= 32) or the long's."""
        heads = layer.n_heads
        ws = layer.weights(dtype)
        cases = {}
        for s, b, causal, with_bias in shapes:
            x = randn(b, s, d).to(dtype)
            sb = randn(b, d, scale=0.3).to(dtype) if with_bias else None
            mask = key_mask(b, s)
            args = (x, sb, *ws, mask, heads, causal)
            key = ("layer_narrow" if s <= 32 else "layer_long_narrow") + suffix(dtype)
            with torch.no_grad():
                got = counted(f"K2 {label} S={s}", lambda: layer_ops.fused_layer(*args),
                              {key: 1})
                want = layer_ops.layer_reference(*args)
                want_cut = layer_ops.layer_reference(x, sb, *cut_weights(ws), mask, heads,
                                                     causal)
            cases[f"S={s}"] = hold(f"K2 {label} B={b} S={s}" + (" causal" if causal else ""),
                                   got, want, want_cut, dtype)
        return cases

    def check_k4(layer, d, dtype, fam, s, b, causal, label):
        """K4 (``fam``: the short or the long form) at rate 0.1 with seq_bias,
        saved mode counted, then the recompute mode; a control on the
        forward and the gradients."""
        heads = layer.n_heads
        sfx = suffix(dtype)
        x = randn(b, s, d).to(dtype)
        sb = randn(b, d, scale=0.3).to(dtype)
        mask = key_mask(b, s)
        res = {"saved": counted(
            f"K4 {label} S={s}",
            lambda: check_layer_train(layer_vjp, f"{label} S={s}", layer, x, sb, mask, causal,
                                      DROPOUT, outliers_aligned=True),
            {f"{fam}_narrow_fwd{sfx}": 1, f"{fam}_narrow_bwd{sfx}": 1})}
        res["recompute"] = check_layer_train(
            layer_vjp, f"{label} S={s} recompute", layer, x, sb, mask, causal, DROPOUT,
            save_residuals=False, narrow=True, outliers_aligned=True)
        # the control: the kernel's forward and gradients against the plain
        # version on the cut weights
        masters = [w.detach().requires_grad_() for w in layer.masters()]
        xl = x.detach().requires_grad_()
        g = randn(*x.shape).to(dtype)
        call = (xl, sb, *masters, mask, 1234, heads, causal, DROPOUT, dtype)
        kout = layer_vjp.fused_layer_train(*call, save_residuals=True)
        kgrads = torch.autograd.grad(kout, [xl, *masters], g)
        cut_masters = [w.requires_grad_() if w is not m else w
                       for w, m in zip(cut_weights(masters), masters)]
        cref = layer_vjp.plain_layer_train(xl, sb, *cut_masters, mask, 1234, heads, causal,
                                           DROPOUT, dtype)
        cgrads = torch.autograd.grad(cref, [xl, *cut_masters], g)
        atol, rtol = limits(dtype)
        c_excess = ((kout.float() - cref.float()).abs() - rtol * cref.float().abs()).max().item()
        c_rms = rel_rms(kout, cref)
        verdicts = []
        for n_, a_, c_ in zip(("x", "wqkv"), (kgrads[0], kgrads[2]), (cgrads[0], cgrads[2])):
            compare_grad(f"K4 {label} S={s} control d{n_}", a_, c_, c_, dtype,
                         report=lambda ok, what: verdicts.append(ok))
        check((c_excess > atol or c_rms > TOL_LAYER_RMS) and not all(verdicts),
              f"K4 {label} S={s}: a gate passed its control (forward excess {c_excess}, RMS "
              f"{c_rms}; gradient verdicts {verdicts})")
        res["control"] = {"forward_excess": c_excess, "forward_rms": c_rms,
                          "gradient_verdicts": verdicts}
        return res

    def check_k7(d, heads, f, dtype, label):
        """K7 at two layers, B=60, S=8, rate 0.1 over K7_DRAWS draws, and
        its control; then one forward and backward, counted. Returns the
        readings and that call's operands."""
        sfx = suffix(dtype)
        layers = seeded_layers(2, d, heads, f, dtype, dev, gen)
        mask60 = key_mask(B_RECIPE, 8)
        mask60[0] = 0.0                   # every sequence with a key

        def draw(g_):
            with torch.no_grad():
                return (torch.randn(B_RECIPE, 8, d, device=dev, generator=g_),
                        0.3 * torch.randn(2, B_RECIPE, d, device=dev, generator=g_), mask60)
        torch.cuda.synchronize()
        reset_counts()
        k7 = check_stack_train(stack_vjp, layer_vjp, f"{label} B=60 L=2", layers, draw, DROPOUT,
                               outliers_aligned=True)
        torch.cuda.synchronize()
        got_counts = read_counts()
        check(got_counts["stack_fwd"] == 0 and got_counts["stack_bwd"] == 0
              and got_counts[f"stack_narrow_fwd{sfx}"] > 0
              and got_counts[f"stack_narrow_bwd{sfx}"] > 0, f"K7 {label}: launches {got_counts}")
        control = check_stack_train(stack_vjp, layer_vjp, f"{label} B=60 L=2", layers, draw,
                                    DROPOUT, outliers_aligned=True,
                                    control_bits=CONTROL_MANTISSA_BITS)
        check(any("with the ReLU units aligned" in m for m in control["failed"]),
              f"K7 {label}: the gradient gate passed its control")
        masters = stacked_masters(layers)
        x7, bias7, _ = draw(gen)
        x7 = x7.to(dtype).requires_grad_()
        g7 = randn(*x7.shape).to(dtype)
        call7 = (x7, bias7, *masters, mask60, 4321, heads, False, DROPOUT, dtype)
        counted(f"K7 {label} one call",
                lambda: torch.autograd.grad(stack_vjp.fused_stack_train(*call7), [x7, *masters],
                                            g7),
                {f"stack_narrow_fwd{sfx}": 1, f"stack_narrow_bwd{sfx}": 1})
        return ({"worst": k7["worst"], "forward_max_abs_err": k7["forward_max_abs_err"],
                 "control": control["failed"]},
                dict(layers=layers, mask=mask60, x=x7, g=g7, masters=masters, call=call7))

    def check_k9(d, heads, f, dtype, label):
        """K9 on HD_DECODE's rows and layers at index 1 and the last; returns
        the cases and the last index's operands."""
        sfx = suffix(dtype)
        r, t_len, n_l = HD_DECODE
        stacks = [torch.stack(ws_) for ws_ in zip(*(
            l_.weights(dtype) for l_ in seeded_layers(n_l, d, heads, f, dtype, dev, gen)))]
        lnf = torch.stack([1 + randn(d, scale=0.1), randn(d, scale=0.1)]).to(dtype)
        kc, vc = randn(n_l, r, t_len, d).to(dtype), randn(n_l, r, t_len, d).to(dtype)
        kpad = torch.zeros(r, t_len, device=dev)
        kpad[:, 3] = float("-inf")
        xd = randn(r, d).to(dtype)
        sbd = randn(n_l, r, d, scale=0.3).to(dtype)
        cases = {}
        for index in (1, t_len - 1):
            dargs = (xd, sbd, *stacks, lnf, kc, vc, kpad, index, heads)
            with torch.no_grad():
                y, kn, vn = counted(f"K9 {label} index {index}",
                                    lambda: decode_ops.fused_decode_step(*dargs),
                                    {"decode" + sfx: 1, "decode_narrow" + sfx: 1})
                want = decode_ops.decode_step_reference(*dargs)
                want_cut = decode_ops.decode_step_reference(xd, sbd, *cut_weights(stacks), lnf,
                                                            kc, vc, kpad, index, heads)
            check(torch.equal(kn, want[1]) or rel_rms(kn, want[1]) <= TOL_DECODE_RMS,
                  f"K9 {label} index {index}: the token's keys")
            cases[f"index {index}"] = hold(f"K9 {label} R={r} index {index}", y, want[0],
                                           want_cut[0], dtype, TOL_DECODE_RMS)
        return cases, dargs

    def mha_weights(dm, dtype):
        wm = [(randn(3 * dm, dm, scale=dm ** -0.5)).to(dtype), randn(3 * dm, scale=0.1).to(dtype),
              randn(dm, dm, scale=dm ** -0.5).to(dtype), randn(dm, scale=0.1).to(dtype)]
        return wm, [cut(wm[0]), wm[1], cut(wm[2]), wm[3]]

    def check_k10(dm, hm, dtype, wm, wm_cut, lengths, label):
        """K10 at B=16 and each S of ``lengths`` (S=16 causal)."""
        cases = {}
        for s in lengths:
            causal = s == 16
            x = randn(16, s, dm).to(dtype)
            mask = key_mask(16, s)
            mask[0] = 0.0
            with torch.no_grad():
                got = counted(f"K10 {label} S={s}",
                              lambda: attn_ops.fused_mha(x, *wm, mask, hm, causal),
                              {"mha_narrow" + suffix(dtype): 1})
                want = attn_ops.mha_reference(x, *wm, mask, hm, causal)
                want_cut = attn_ops.mha_reference(x, *wm_cut, mask, hm, causal)
            scale = want.float().pow(2).mean().sqrt().item() if dtype == f32 else 1.0
            cases[f"D={dm} heads={hm} S={s}"] = hold(
                f"K10 {label} S={s}" + (" causal" if causal else ""), got, want, want_cut, dtype,
                atol_scale=scale)
        return cases

    def check_k11(dm, hm, dtype, wm, wm_cut, lengths, label):
        """K11 at B=16, rate 0.1 and each S of ``lengths``: the forward, and
        its five gradients against autograd and the plain backward."""
        sfx = suffix(dtype)
        cases = {}
        for s in lengths:
            x = randn(16, s, dm).to(dtype)
            mask = key_mask(16, s)
            mask[0] = 0.0
            leaves = [t.clone().requires_grad_() for t in (x, *wm)]
            g = randn(16, s, dm).to(dtype)

            def k11():
                o = attention_vjp.fused_mha_train(*leaves, mask, 2024, hm, False, DROPOUT)
                return o, torch.autograd.grad(o, leaves, g)
            got, grads = counted(f"K11 {label} S={s}", k11,
                                 {"mha_train_narrow_fwd" + sfx: 1,
                                  "mha_train_narrow_bwd" + sfx: 1})
            want = attn_ops.mha_reference(*leaves, mask, hm, False, DROPOUT, 2024)
            scale = want.float().pow(2).mean().sqrt().item() if dtype == f32 else 1.0
            want_cut = attn_ops.mha_reference(x, *wm_cut, mask, hm, False, DROPOUT, 2024)
            case = hold(f"K11 {label} S={s} rate {DROPOUT}", got, want.detach(), want_cut, dtype,
                        atol_scale=scale)
            names = ("x", "wqkv", "bqkv", "wo", "bo")
            auto = torch.autograd.grad(want, leaves, g)
            plain_b = attention_vjp.mha_backward_reference(x, g, *wm[:3], mask, hm, False,
                                                           DROPOUT, 2024)
            cut_b = attention_vjp.mha_backward_reference(x, g, *wm_cut[:3], mask, hm, False,
                                                         DROPOUT, 2024)
            case["grad_rms"] = {n: rel_rms(a, c) for n, a, c in zip(names, grads, auto)}
            case["grad_rms_plain_backward"] = {
                n: rel_rms(a, c.to(a.dtype)) for n, a, c in zip(names, grads, plain_b)}
            case["grad_rms_control"] = {
                n: rel_rms(a, c.to(a.dtype)) for n, a, c in zip(names, grads, cut_b)}
            case["grad_max_abs_err"] = max((a.float() - c.float()).abs().max().item()
                                           for a, c in zip(grads, plain_b))
            worst_g = max(*case["grad_rms"].values(), *case["grad_rms_plain_backward"].values())
            print(f"  gradients: relative RMS {case['grad_rms']}, against the plain backward "
                  f"{case['grad_rms_plain_backward']} (limit {MHA_GRAD_RMS}); control "
                  f"{case['grad_rms_control']}", flush=True)
            check_later(worst_g <= MHA_GRAD_RMS, f"K11 {label} S={s}: gradient RMS {worst_g}")
            check(max(case["grad_rms_control"].values()) > MHA_GRAD_RMS,
                  f"K11 {label} S={s}: the gradient gate passed its control")
            cases[f"D={dm} heads={hm} S={s}"] = case
        return cases

    for hd, (d, heads, f) in HD_SHAPES.items():
        for dtype in (bf16, f32):
            sfx = suffix(dtype)
            label = f"head dim {hd} {dtype}"
            peak = PEAK_TF32 if dtype == f32 else PEAK_BF16
            layer = seeded_layers(1, d, heads, f, dtype, dev, gen)[0]
            ws = layer.weights(dtype)

            # ---- K2, short (S=1, 17, 32) and long (S=40; S=241 causal with seq_bias)
            cases = check_k2(layer, d, dtype, ((1, HD_B, False, False), (17, HD_B, False, True),
                                            (32, HD_B, False, False), (40, HD_B, False, False),
                                            (241, 16, True, True)), label)
            for fam, s in (("layer", 32), ("layer_long", 40)):
                x = randn(HD_B, s, d).to(dtype)
                mask = key_mask(HD_B, s)
                mask[0] = 0.0
                args = (x, None, *ws, mask, heads, False)
                lib = lib_layer(layer, dtype)
                pad = torch.isinf(mask)
                with torch.no_grad():
                    ms = cuda_ms(lambda: layer_ops.fused_layer(*args))
                    plain_ms = cuda_ms(lambda: layer_ops.layer_reference(*args), iters=5,
                                       warmup=1)
                    lib_ms = cuda_ms(lambda: lib(x, src_key_padding_mask=pad))
                part = {k: v for k, v in cases.items()
                        if (int(k[2:]) <= 32) == (fam == "layer")}
                entry(hd_name(fam, hd, dtype), part, ms, plain_ms, lib_ms, layer_cost(args),
                      max(c["max_abs_err"] for c in part.values()),
                      seen[f"{fam}_narrow{sfx}"])

            # ---- K4: short (S=8, seq_bias) and long (S=40, causal, seq_bias),
            # rate 0.1, both modes; a control on the forward and the gradients
            k4 = {}
            for fam, s, b, causal in (("layer_train", 8, 128, False),
                                      ("layer_train_long", 40, 32, True)):
                k4[fam] = check_k4(layer, d, dtype, fam, s, b, causal, label)
                readings = [k4[fam]["saved"], k4[fam]["recompute"]]
                # timed at B=HD_B (short) or 64 (long)
                bt = HD_B if fam == "layer_train" else 64
                xt = randn(bt, s, d).to(dtype)
                maskt = key_mask(bt, s)
                maskt[0] = 0.0
                fwd, both = k4_runs(layer_vjp.fused_layer_train, layer, xt, None, maskt, causal,
                                    gen=gen)
                pfwd, pboth = k4_runs(layer_vjp.plain_layer_train, layer, xt, None, maskt, causal,
                                      gen=gen)
                lib = lib_layer(layer, dtype, train=True)
                xlib = xt.detach().requires_grad_()
                glib = torch.randn_like(xlib)
                attn_mask = torch.full((s, s), float("-inf"), device=dev).triu(1) if causal \
                    else None

                def lib_fwd():
                    with torch.no_grad():
                        return lib(xlib, src_mask=attn_mask, is_causal=causal)

                def lib_both():
                    return torch.autograd.grad(lib(xlib, src_mask=attn_mask, is_causal=causal),
                                               [xlib, *lib.parameters()], glib)
                f_ms, fb_ms = cuda_ms(fwd), cuda_ms(both)
                pf_ms = cuda_ms(pfwd, iters=5, warmup=1)
                pfb_ms = cuda_ms(pboth, iters=5, warmup=1)
                lf_ms, lfb_ms = cuda_ms(lib_fwd), cuda_ms(lib_both)
                entry(hd_name(f"{fam}_fwd", hd, dtype),
                      {m: r["forward_rms"] for m, r in zip(("saved", "recompute"), readings)},
                      f_ms, pf_ms, lf_ms, k4_bound(xt, None, f, False, causal),
                      max(r["forward_max_abs_err"] for r in readings),
                      seen[f"{fam}_narrow_fwd{sfx}"])
                entry(hd_name(f"{fam}_bwd", hd, dtype),
                      {m: max(v["rms"] for v in r["grads"].values())
                       for m, r in zip(("saved", "recompute"), readings)},
                      fb_ms - f_ms, pfb_ms - pf_ms, lfb_ms - lf_ms,
                      k4_bound(xt, None, f, True, causal),
                      max(v["max_abs_err"] for r in readings for v in r["grads"].values()),
                      seen[f"{fam}_narrow_bwd{sfx}"])
            out[f"k4 {label}"] = k4

            # ---- K7: two layers at B=60, S=8, rate 0.1, over K7_DRAWS draws; its control
            k7, k7_ops = check_k7(d, heads, f, dtype, label)
            out[f"k7 {label}"] = {"worst": k7["worst"], "control": k7["control"]}
            layers, mask60 = k7_ops["layers"], k7_ops["mask"]
            x7, g7, masters, call7 = k7_ops["x"], k7_ops["g"], k7_ops["masters"], k7_ops["call"]

            def stack_fns(fn):
                def fwd():
                    with torch.no_grad():
                        return fn(*call7)

                def both():
                    return torch.autograd.grad(fn(*call7), [x7, *masters], g7)
                return fwd, both
            kf, kb = stack_fns(stack_vjp.fused_stack_train)
            pf, pb = stack_fns(stack_vjp.plain_stack_train)
            lib = torch.nn.TransformerEncoder(lib_layer(layers[0], dtype, train=True), 2,
                                              enable_nested_tensor=False)
            for lib_l, l_ in zip(lib.layers, layers):
                copy_layer(lib_l, l_)
            lib.train()
            xlib = x7.detach().requires_grad_()

            def lib_fwd7():
                with torch.no_grad():
                    return lib(xlib)

            def lib_both7():
                return torch.autograd.grad(lib(xlib), [xlib, *lib.parameters()], g7)
            f_ms, fb_ms = cuda_ms(kf), cuda_ms(kb)
            pf_ms, pfb_ms = cuda_ms(pf, iters=5, warmup=1), cuda_ms(pb, iters=5, warmup=1)
            lf_ms, lfb_ms = cuda_ms(lib_fwd7), cuda_ms(lib_both7)
            # the bound of two layers: x in and out (forward) or g in and dx
            # out (backward) once, both layers' weights (and their float32
            # gradients) and injections, twice one layer's operations
            es, rows7 = x7.element_size(), B_RECIPE * 8
            w_elems = 4 * d * d + 2 * d * f + 9 * d + f
            ops7 = 2 * (layer_ops_count(B_RECIPE, 8, d, f))
            fb_ = bound(2 * rows7 * d * es + 2 * (w_elems + B_RECIPE * d) * es + nbytes(mask60),
                        ops7, peak)
            bb_ = bound(3 * rows7 * d * es + 2 * (w_elems * (es + 4) + B_RECIPE * d * 4)
                        + nbytes(mask60), 2 * ops7, peak)
            entry(hd_name("stack_fwd", hd, dtype), {"worst": k7["worst"]}, f_ms, pf_ms, lf_ms,
                  fb_, k7["forward_max_abs_err"], seen[f"stack_narrow_fwd{sfx}"])
            entry(hd_name("stack_bwd", hd, dtype), {"worst": k7["worst"]}, fb_ms - f_ms,
                  pfb_ms - pf_ms, lfb_ms - lf_ms, bb_, k7["worst"]["max_abs_err"],
                  seen[f"stack_narrow_bwd{sfx}"])

            # ---- K9: R rows, two layers, at index 1 and the last
            dec_cases, dargs = check_k9(d, heads, f, dtype, label)
            xd, sbd, stacks, lnf, kpad = dargs[0], dargs[1], dargs[2:12], dargs[12], dargs[15]
            r, t_len, n_l = HD_DECODE
            index = t_len - 1
            with torch.no_grad():
                ms = cuda_ms(lambda: decode_ops.fused_decode_step(*dargs))
                plain_ms = cuda_ms(lambda: decode_ops.decode_step_reference(*dargs), iters=5,
                                   warmup=1)
            es = xd.element_size()
            d_bytes = (2 * n_l * r * index * d * es + nbytes(*stacks, lnf, xd, sbd, kpad)
                       + 2 * n_l * r * d * es + r * d * es)
            d_ops = 2.0 * r * n_l * (4 * d * d + 2 * d * f) + 4.0 * r * n_l * (index + 1) * d
            entry(hd_name("decode", hd, dtype), dec_cases, ms, plain_ms, None,
                  bound(d_bytes, d_ops, peak), max(c["max_abs_err"] for c in dec_cases.values()),
                  seen["decode_narrow" + sfx])

            # ---- K10 and K11 at the JAX tests' widths of this head dim
            mha_k10, mha_k11 = {}, {}
            for dm, hm in HD_MHA_WIDTHS:
                if dm // hm != hd:
                    continue
                wm, wm_cut = mha_weights(dm, dtype)
                mha_label = f"D={dm} heads {hm} {dtype}"
                mha_k10.update(check_k10(dm, hm, dtype, wm, wm_cut, HD_MHA_S, mha_label))
                mha_k11.update(check_k11(dm, hm, dtype, wm, wm_cut, (8, 40), mha_label))
                if dm != d:
                    continue
                # timed at B=1024, S=32, beside F.linear -> SDPA -> F.linear;
                # the launches of the last counted call at this width
                launches_k10 = seen["mha_narrow" + sfx]
                launches_k11 = (seen["mha_train_narrow_fwd" + sfx],
                                seen["mha_train_narrow_bwd" + sfx])
                bt, s = 1024, 32
                x = randn(bt, s, dm).to(dtype)
                mask = key_mask(bt, s)
                mask[0] = 0.0

                def lib_mha(x_, ws_=wm):
                    qkv = F.linear(x_, ws_[0], ws_[1]).reshape(bt, s, 3, hm, dm // hm).permute(
                        2, 0, 3, 1, 4)
                    ctx = F.scaled_dot_product_attention(
                        qkv[0], qkv[1], qkv[2], attn_mask=mask[:, None, None, :].to(x_.dtype),
                        dropout_p=0.0)
                    return F.linear(ctx.transpose(1, 2).reshape(bt, s, dm), ws_[2], ws_[3])
                ops_m = 2.0 * bt * s * dm * 4 * dm + 4.0 * bt * s * s * dm
                with torch.no_grad():
                    ms = cuda_ms(lambda: attn_ops.fused_mha(x, *wm, mask, hm))
                    plain_ms = cuda_ms(lambda: attn_ops.mha_reference(x, *wm, mask, hm), iters=5,
                                       warmup=1)
                    lib_ms = cuda_ms(lambda: lib_mha(x))
                entry(hd_name("mha", hd, dtype), mha_k10, ms, plain_ms, lib_ms,
                      bound(2 * nbytes(x) + nbytes(*wm, mask), ops_m, peak),
                      max(c["max_abs_err"] for c in mha_k10.values()), launches_k10)
                leaves = [t.clone().requires_grad_() for t in (x, *wm)]
                g = randn(bt, s, dm).to(dtype)

                def k11_fwd():
                    with torch.no_grad():
                        return attention_vjp.fused_mha_train(*leaves, mask, 7, hm, False, DROPOUT)

                def k11_both():
                    o = attention_vjp.fused_mha_train(*leaves, mask, 7, hm, False, DROPOUT)
                    return torch.autograd.grad(o, leaves, g)

                def p11_fwd():
                    with torch.no_grad():
                        return attn_ops.mha_reference(*leaves, mask, hm, False, DROPOUT, 7)

                def p11_both():
                    o = attn_ops.mha_reference(*leaves, mask, hm, False, DROPOUT, 7)
                    return torch.autograd.grad(o, leaves, g)

                def l11_fwd():
                    with torch.no_grad():
                        return lib_mha(leaves[0], leaves[1:])

                def l11_both():
                    return torch.autograd.grad(lib_mha(leaves[0], leaves[1:]), leaves, g)
                f_ms, fb_ms = cuda_ms(k11_fwd), cuda_ms(k11_both)
                pf_ms, pfb_ms = cuda_ms(p11_fwd, iters=5, warmup=1), cuda_ms(p11_both, iters=5,
                                                                             warmup=1)
                lf_ms, lfb_ms = cuda_ms(l11_fwd), cuda_ms(l11_both)
                w_bytes = nbytes(*wm, mask)
                entry(hd_name("mha_train_fwd", hd, dtype), mha_k11, f_ms, pf_ms, lf_ms,
                      bound(2 * nbytes(x) + w_bytes, ops_m, peak),
                      max(c["max_abs_err"] for c in mha_k11.values()), launches_k11[0])
                entry(hd_name("mha_train_bwd", hd, dtype), mha_k11, fb_ms - f_ms,
                      pfb_ms - pf_ms, lfb_ms - lf_ms,
                      bound(3 * nbytes(x) + w_bytes + 4 * nbytes(*wm), 2 * ops_m, peak),
                      max(c["grad_max_abs_err"] for c in mha_k11.values()), launches_k11[1])
            del layer, layers, stacks, dargs, k7_ops
            torch.cuda.empty_cache()

    # ---- the other widths the rules send to these kernels (HD_WIDE): each
    # family against its plain version with its control, counted, untimed
    wide = {}
    for d, heads, f in HD_WIDE:
        for dtype in (bf16, f32):
            label = f"D={d} heads {heads} {dtype}"
            layer = seeded_layers(1, d, heads, f, dtype, dev, gen)[0]
            row = {"K2": check_k2(layer, d, dtype, ((8, HD_B, False, True),
                                                    (32, HD_B, False, False),
                                                    (40, 64, True, True)), label)}
            for fam, s, b, causal in (("layer_train", 8, 128, False),
                                      ("layer_train_long", 40, 32, True)):
                row[fam] = check_k4(layer, d, dtype, fam, s, b, causal, label)
            if stack_vjp.stack_form(B_RECIPE, 8, d, f, heads, dtype) == "narrow":
                row["K7"] = check_k7(d, heads, f, dtype, label)[0]
            row["K9"] = check_k9(d, heads, f, dtype, label)[0]
            wm, wm_cut = mha_weights(d, dtype)
            row["K10"] = check_k10(d, heads, dtype, wm, wm_cut, (8, 16, 40), label)
            row["K11"] = check_k11(d, heads, dtype, wm, wm_cut, (8, 40), label)
            wide[label] = row
            del layer, wm, wm_cut
            torch.cuda.empty_cache()
    out["wide"] = wide

    # ================= the tiny configs' paths, counted, no plain version called
    plain_fns = [(emb_ops, "embedding_reference"), (layer_ops, "layer_reference"),
                 (head_ops, "head_argmax_reference"), (decode_ops, "decode_step_reference"),
                 (layer_vjp, "layer_train_reference"), (stack_vjp, "layer_train_reference"),
                 (ce_ops, "args_ce_reference")]

    def path(what, fn, expected):
        torch.cuda.synchronize()
        calls, restore = count_plain_calls(plain_fns)
        reset_counts()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            restore()
        got = read_counts()
        print(f"{what}: launches { {k: v for k, v in got.items() if v} }; plain versions "
              f"called {calls}", flush=True)
        check(got == no_launch | expected, f"{what}: launches {got}, expected {expected}")
        check(not any(calls.values()), f"{what}: plain versions ran: {calls}")
        path_launches[what] = {k: v for k, v in got.items() if v}
        return res

    def model_of(cfg, seed=HD_SEED):
        model = SVGTransformer(cfg)
        init_parameters(model, torch.Generator().manual_seed(seed))
        return model.to(dev)

    def batch_of(cfg, n, keys=("commands", "args"), seed=0):
        raw = generate_batch(np.random.default_rng(seed), n, cfg.max_num_groups, cfg.max_seq_len)
        return {k: torch.from_numpy(raw[k]).to(dev) for k in keys}

    def emb(sfx):
        return {"embedding" + sfx: 1, "embedding_narrow": 1}
    paths = {}
    tiny = {bf16: dataclasses.replace(tiny_config(), compute_dtype="bfloat16"),
            f32: tiny_config()}
    expect_infer = {bf16: emb("") | {"layer_narrow": 3, "layer_narrow_f32": 1, "head": 1},
                    f32: emb("_f32") | {"layer_narrow_f32": 4, "head_f32": 1}}
    expect_step = {bf16: emb("") | {"layer_train_narrow_fwd": 3, "layer_train_narrow_bwd": 3,
                                    "layer_train_narrow_fwd_f32": 1,
                                    "layer_train_narrow_bwd_f32": 1, "args_ce_fwd": 1,
                                    "args_ce_bwd": 1, "embedding_bwd": 1},
                   f32: emb("_f32") | {"layer_train_narrow_fwd_f32": 4,
                                       "layer_train_narrow_bwd_f32": 4, "args_ce_fwd_f32": 1,
                                       "args_ce_bwd_f32": 1, "embedding_bwd": 1}}
    for dtype, cfg in tiny.items():
        sfx = suffix(dtype)
        model = model_of(cfg).eval()
        inp = batch_of(cfg, HD_N)
        with torch.no_grad():
            c, a = path(f"test_tiny {dtype} one_shot_sample N={HD_N}",
                        lambda: one_shot_sample(model, inp["commands"], inp["args"]),
                        expect_infer[dtype])
            share = check_sample(c, a, HD_N, cfg)
            again = one_shot_sample(model, inp["commands"][:8], inp["args"][:8])
            check(torch.equal(again[0], c[:8]) and torch.equal(again[1], a[:8]),
                  f"test_tiny {dtype}: sampling differs from call to call")
            with plain_path(emb_ops, layer_ops, head_ops):
                pc, pa = one_shot_sample(model, inp["commands"][:64], inp["args"][:64])
            agree = (c[:64] == pc).float().mean().item()
        paths[f"test_tiny {dtype} inference"] = {
            "argument_share": share, "command_ids_equal_plain_path_share": agree,
            "ms": cuda_median_ms(lambda: one_shot_sample(model, inp["commands"], inp["args"]),
                                 iters=5, warmup=1)}
        print(f"test_tiny {dtype} one_shot_sample N={HD_N}: valid, {share:.4f} of the argument "
              f"slots set; command ids equal to the plain path's on {agree:.4f} of the first "
              f"64 icons' slots; {paths[f'test_tiny {dtype} inference']['ms']:.3f} ms on {card}",
              flush=True)
        # the training CLI, HD_CLI_STEPS steps on the synthetic data
        conf = load_config("deepsvg_tpu_torch.configs.test_tiny", 1)
        conf.model_cfg = cfg
        conf.model_args = cfg.get_model_args()
        conf.val_every = conf.ckpt_every = 10 ** 9
        conf.log_every = HD_CLI_STEPS // 2
        with tempfile.TemporaryDirectory() as log_dir, \
                open(os.path.join(OUT_DIR, f"cli_train_test_tiny{sfx}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            state, stats = path(
                f"test_tiny {dtype} CLI {HD_CLI_STEPS} steps",
                lambda: train_mod.train(conf, "test_tiny", "smoke", log_dir=log_dir, debug=True,
                                        max_steps=HD_CLI_STEPS, device=dev),
                {k: v * HD_CLI_STEPS for k, v in expect_step[dtype].items()})
        losses = list(stats.stats["train"]["loss"].deque)
        check(state.step == HD_CLI_STEPS and losses and all(np.isfinite(v) for v in losses),
              f"test_tiny {dtype} CLI: step {state.step}, losses {losses}")
        paths[f"test_tiny {dtype} CLI"] = {"steps": state.step, "losses": losses}
        print(f"test_tiny {dtype} CLI: {state.step} steps, logged losses {losses}", flush=True)
        del model, state
    # one bucket of the bfloat16 tiny model, exported and served
    tmp = tempfile.mkdtemp(prefix="served_tiny_")
    try:
        model = model_of(tiny[bf16]).eval()
        serving.export_session(model, tmp, batch_sizes=(HD_SERVE_BUCKET,))
        fns = serving.load_session_exports(tmp)
        inp = batch_of(tiny[bf16], HD_SERVE_BUCKET, seed=30)
        c_in, a_in = inp["commands"].to(torch.int32), inp["args"].float()
        with torch.no_grad():
            z_live = model.encode(c_in, a_in)[0]
            cmd_live, args_live = greedy_sample(model, z=z_live.float())
        z = path("served test_tiny bf16 encode", lambda: fns["encode"][HD_SERVE_BUCKET](c_in, a_in),
                 emb("") | {"layer_narrow": 1, "layer_narrow_f32": 1})
        cmds, args_s = path("served test_tiny bf16 decode",
                            lambda: fns["decode"][HD_SERVE_BUCKET](z.float()),
                            {"layer_narrow": 2, "head": 1})
        served_equal = bool(torch.equal(cmds, cmd_live) and torch.equal(args_s, args_live))
        check(served_equal, "served test_tiny bucket: ids differ from the live call's")
        paths["served test_tiny bf16"] = {
            "bucket": HD_SERVE_BUCKET, "ids_equal": served_equal,
            "z_max_abs_diff": float((z.float() - z_live.float()).abs().max())}
        print(f"served test_tiny bf16 bucket {HD_SERVE_BUCKET}: ids equal to the live call's; z "
              f"within {paths['served test_tiny bf16']['z_max_abs_diff']:.3g}", flush=True)
        del model, fns
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # SMALL at dropout 0.1, B=HD_SMALL_B: E1 and D1 through K4 (both modes),
    # E2 and D2 through K7
    weights = dict(LOSS_WEIGHTS)
    for dtype in (bf16, f32):
        sfx = suffix(dtype)
        cfg = dataclasses.replace(hierarchical(), use_vae=False,
                                  compute_dtype="bfloat16" if dtype == bf16 else "float32",
                                  **HD_SMALL)
        batch = batch_of(cfg, HD_SMALL_B)
        stack = {"stack_narrow_fwd" + sfx: 2, "stack_narrow_bwd" + sfx: 2}
        common = emb(sfx) | stack | {"args_ce_fwd" + sfx: 1, "args_ce_bwd" + sfx: 1,
                                     "embedding_bwd": 1}
        for save in (True, False):
            optimizer = make_optimizer(constant(LR))
            state = create_train_state(model_of(cfg).train(), optimizer, init=False)
            saved_default = layer_vjp.SAVE_RESIDUALS_DEFAULT
            layer_vjp.SAVE_RESIDUALS_DEFAULT = save
            try:
                k4 = ({"layer_train_narrow_fwd" + sfx: 4, "layer_train_narrow_bwd" + sfx: 4}
                      if save else {"layer_train_narrow_fwd" + sfx: 4,
                                    "layer_train_recompute_bwd": 4})
                what = f"SMALL {dtype} step B={HD_SMALL_B} dropout {DROPOUT}" + (
                    "" if save else " recompute")
                _, res = path(what, lambda: train_step(state, batch, weights, optimizer,
                                                       MODEL_ARGS), common | k4)
                ms = cuda_median_ms(lambda: train_step(state, batch, weights, optimizer,
                                                       MODEL_ARGS), iters=5, warmup=1)
            finally:
                layer_vjp.SAVE_RESIDUALS_DEFAULT = saved_default
            check(all(bool(torch.isfinite(v)) for v in res.values()), f"{what}: a loss")
            paths[what] = {"losses": {k: float(v) for k, v in res.items()}, "ms": ms}
            print(f"{what}: losses {paths[what]['losses']}; {ms:.3f} ms/step on {card}",
                  flush=True)
            del state, optimizer

    # the one-stage autoregressive SMALL model: greedy_sample through K9
    for dtype in (bf16, f32):
        sfx = suffix(dtype)
        cfg = dataclasses.replace(hierarchical(), use_vae=False,
                                  compute_dtype="bfloat16" if dtype == bf16 else "float32",
                                  **HD_AR)
        model = model_of(cfg).eval()
        inp = batch_of(cfg, HD_N, ("commands_grouped", "args_grouped"))
        steps = cfg.max_total_len
        with torch.no_grad():
            c, a = path(f"SMALL autoregressive {dtype} greedy_sample N={HD_N}",
                        lambda: greedy_sample(model, inp["commands_grouped"],
                                              inp["args_grouped"]),
                        emb(sfx) | {"layer_narrow" + sfx: 2, "decode" + sfx: steps,
                                    "decode_narrow" + sfx: steps, "head" + sfx: steps})
            check(bool(torch.isfinite(a.float()).all()) and int(c.min()) >= 0
                  and int(c.max()) < cfg.n_commands, f"autoregressive {dtype}: output")
            again = greedy_sample(model, inp["commands_grouped"][:8], inp["args_grouped"][:8])
            check(torch.equal(again[0], c[:8]), f"autoregressive {dtype}: differs from call "
                                                f"to call")
        paths[f"SMALL autoregressive {dtype}"] = {
            "ms": cuda_median_ms(lambda: greedy_sample(model, inp["commands_grouped"],
                                                       inp["args_grouped"]), iters=3, warmup=1)}
        print(f"SMALL autoregressive {dtype} greedy_sample N={HD_N}: {steps} steps, "
              f"{paths[f'SMALL autoregressive {dtype}']['ms']:.3f} ms on {card}", flush=True)
        del model

    # the kernels line's launches: of the path that runs each form at head
    # dim 8, else of its own counted call
    on_path = {
        ("layer", bf16): ("test_tiny torch.bfloat16 one_shot_sample", "layer_narrow"),
        ("layer", f32): ("test_tiny torch.float32 one_shot_sample", "layer_narrow_f32"),
        ("layer_train_fwd", bf16): ("test_tiny torch.bfloat16 CLI", "layer_train_narrow_fwd"),
        ("layer_train_fwd", f32): ("test_tiny torch.float32 CLI", "layer_train_narrow_fwd_f32"),
        ("layer_train_bwd", bf16): ("test_tiny torch.bfloat16 CLI", "layer_train_narrow_bwd"),
        ("layer_train_bwd", f32): ("test_tiny torch.float32 CLI", "layer_train_narrow_bwd_f32"),
        ("stack_fwd", bf16): ("SMALL torch.bfloat16 step", "stack_narrow_fwd"),
        ("stack_fwd", f32): ("SMALL torch.float32 step", "stack_narrow_fwd_f32"),
        ("stack_bwd", bf16): ("SMALL torch.bfloat16 step", "stack_narrow_bwd"),
        ("stack_bwd", f32): ("SMALL torch.float32 step", "stack_narrow_bwd_f32"),
        ("decode", bf16): ("SMALL autoregressive torch.bfloat16", "decode_narrow"),
        ("decode", f32): ("SMALL autoregressive torch.float32", "decode_narrow_f32")}
    launches = dict(own)
    for (fam, dtype), (prefix, key) in on_path.items():
        run = next(v for k, v in path_launches.items() if k.startswith(prefix))
        launches[hd_name(fam, 8, dtype)] = run[key]
    record["head_dims"] = {"checks": out, "paths": paths, "path_launches": path_launches,
                           "phase_s": time.perf_counter() - t_phase}
    print(f"head-dims phase: {record['head_dims']['phase_s']:.1f} s", flush=True)
    return launches


def reset_counts():
    """Every kernel wrapper's launch counters to 0."""
    from deepsvg_tpu_torch.ops import attention as attn_ops
    from deepsvg_tpu_torch.ops import attention_vjp
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import decode as decode_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    layer_ops.fused_layer_long.launches = layer_ops.fused_layer_long.float32_launches = 0
    decode_ops.fused_decode_step.launches = 0
    emb_ops.fused_embedding.launches = emb_ops.fused_embedding.narrow_launches = 0
    emb_ops.embedding_backward.launches = 0
    layer_ops.fused_layer.launches = layer_ops.fused_layer.float32_launches = 0
    layer_ops.fused_layer.narrow_launches = layer_ops.fused_layer_long.narrow_launches = 0
    for fn in (layer_ops.fused_layer, layer_ops.fused_layer_long, decode_ops.fused_decode_step,
               attn_ops.fused_mha, attention_vjp.fused_mha_train, layer_vjp.fused_layer_train,
               layer_vjp.fused_layer_train_long, stack_vjp.fused_stack_train):
        fn.narrow_float32_launches = 0
    for fn in (attention_vjp.fused_mha_train, layer_vjp.fused_layer_train,
               layer_vjp.fused_layer_train_long, stack_vjp.fused_stack_train):
        fn.narrow_float32_backward_launches = 0
    head_ops.fused_head_argmax.launches = 0
    layer_vjp.fused_layer_train.launches = 0
    layer_vjp.fused_layer_train.backward_launches = 0
    layer_vjp.fused_layer_train.float32_launches = 0
    layer_vjp.fused_layer_train.float32_backward_launches = 0
    decode_ops.fused_decode_step.cluster_launches = 0
    decode_ops.fused_decode_step.narrow_launches = 0
    layer_vjp.fused_layer_train_long.launches = 0
    layer_vjp.fused_layer_train_long.backward_launches = 0
    layer_vjp.fused_layer_train_long.float32_launches = 0
    layer_vjp.fused_layer_train_long.float32_backward_launches = 0
    for fn in (layer_vjp.fused_layer_train, layer_vjp.fused_layer_train_long):
        fn.recompute_launches = fn.recompute_backward_launches = 0
        fn.narrow_launches = fn.narrow_backward_launches = 0
    ce_ops.args_ce.launches = ce_ops.args_ce.backward_launches = 0
    stack_vjp.fused_stack_train.launches = 0
    stack_vjp.fused_stack_train.backward_launches = 0
    stack_vjp.fused_stack_train.narrow_launches = 0
    stack_vjp.fused_stack_train.narrow_backward_launches = 0
    ce_ops.args_ce_pairwise.launches = 0
    for fn in (emb_ops.fused_embedding, head_ops.fused_head_argmax, ce_ops.args_ce,
               ce_ops.args_ce_pairwise, decode_ops.fused_decode_step):
        fn.float32_launches = 0
    ce_ops.args_ce.float32_backward_launches = 0
    for fn in (attn_ops.fused_mha, attention_vjp.fused_mha_train):
        fn.launches = fn.float32_launches = fn.narrow_launches = 0
    attention_vjp.fused_mha_train.backward_launches = 0
    attention_vjp.fused_mha_train.float32_backward_launches = 0
    attention_vjp.fused_mha_train.narrow_backward_launches = 0

def read_counts() -> dict:
    """Launches by kernel; a float32 form under its own name (``_f32``)."""
    from deepsvg_tpu_torch.ops import attention as attn_ops
    from deepsvg_tpu_torch.ops import attention_vjp
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import decode as decode_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    def split(fn, name, total="launches", f32="float32_launches"):
        return {name: getattr(fn, total) - getattr(fn, f32), f"{name}_f32": getattr(fn, f32)}

    def narrow_split(fn, name, direction=""):
        # the first port's kernels (narrow_launches), bfloat16 and float32
        return split(fn, name, f"narrow_{direction}launches",
                     f"narrow_float32_{direction}launches")
    return {**split(emb_ops.fused_embedding, "embedding"),
            # K1 on its first kernel (widths the Hopper kernel does not
            # take; none on any path here: every count expected 0)
            "embedding_narrow": emb_ops.fused_embedding.narrow_launches,
            **split(layer_ops.fused_layer, "layer"),
            **split(head_ops.fused_head_argmax, "head"),
            "layer_train_fwd": layer_vjp.fused_layer_train.launches,
            "layer_train_bwd": layer_vjp.fused_layer_train.backward_launches,
            # of those, K4's float32 short form on the TF32 wgmma launches
            "layer_train_fwd_f32": layer_vjp.fused_layer_train.float32_launches,
            "layer_train_bwd_f32": layer_vjp.fused_layer_train.float32_backward_launches,
            **split(ce_ops.args_ce, "args_ce_fwd"),
            **split(ce_ops.args_ce, "args_ce_bwd", "backward_launches",
                    "float32_backward_launches"),
            "embedding_bwd": emb_ops.embedding_backward.launches,
            "stack_fwd": (stack_vjp.fused_stack_train.launches
                          - stack_vjp.fused_stack_train.narrow_launches),
            "stack_bwd": (stack_vjp.fused_stack_train.backward_launches
                          - stack_vjp.fused_stack_train.narrow_backward_launches),
            **split(ce_ops.args_ce_pairwise, "args_ce_pairwise"),
            **split(layer_ops.fused_layer_long, "layer_long"),
            **split(decode_ops.fused_decode_step, "decode"),
            # K9 on the older kernel (widths the cluster kernel does not
            # take: head dims 8 and 16, the head-dims phase alone), by type
            **narrow_split(decode_ops.fused_decode_step, "decode_narrow"),
            **split(layer_vjp.fused_layer_train_long, "layer_train_long_fwd"),
            **split(layer_vjp.fused_layer_train_long, "layer_train_long_bwd",
                    "backward_launches", "float32_backward_launches"),
            # K10 and K11's forward on their Hopper forms (bf16, float32);
            # at widths below D=256 the first port's kernels, apart
            "mha": (attn_ops.fused_mha.launches - attn_ops.fused_mha.float32_launches
                    - attn_ops.fused_mha.narrow_launches),
            "mha_f32": attn_ops.fused_mha.float32_launches,
            **narrow_split(attn_ops.fused_mha, "mha_narrow"),
            "mha_train_fwd": (attention_vjp.fused_mha_train.launches
                              - attention_vjp.fused_mha_train.float32_launches
                              - attention_vjp.fused_mha_train.narrow_launches),
            "mha_train_fwd_f32": attention_vjp.fused_mha_train.float32_launches,
            **narrow_split(attention_vjp.fused_mha_train, "mha_train_narrow_fwd"),
            "mha_train_bwd": (attention_vjp.fused_mha_train.backward_launches
                              - attention_vjp.fused_mha_train.float32_backward_launches
                              - attention_vjp.fused_mha_train.narrow_backward_launches),
            "mha_train_bwd_f32": attention_vjp.fused_mha_train.float32_backward_launches,
            **narrow_split(attention_vjp.fused_mha_train, "mha_train_narrow_bwd", "backward_"),
            "layer_train_recompute_fwd": layer_vjp.fused_layer_train.recompute_launches,
            "layer_train_recompute_bwd":
                layer_vjp.fused_layer_train.recompute_backward_launches,
            "layer_train_long_recompute_fwd":
                layer_vjp.fused_layer_train_long.recompute_launches,
            "layer_train_long_recompute_bwd":
                layer_vjp.fused_layer_train_long.recompute_backward_launches,
            # K4 at widths below its Hopper forms' (head dims 8 and 16: the
            # head-dims phase alone), by type
            **narrow_split(layer_vjp.fused_layer_train, "layer_train_narrow_fwd"),
            **narrow_split(layer_vjp.fused_layer_train, "layer_train_narrow_bwd", "backward_"),
            **narrow_split(layer_vjp.fused_layer_train_long, "layer_train_long_narrow_fwd"),
            **narrow_split(layer_vjp.fused_layer_train_long, "layer_train_long_narrow_bwd",
                           "backward_"),
            # K7 at widths its cluster kernels do not take (likewise)
            **narrow_split(stack_vjp.fused_stack_train, "stack_narrow_fwd"),
            **narrow_split(stack_vjp.fused_stack_train, "stack_narrow_bwd", "backward_"),
            # K2 at widths below its wgmma kernels' (likewise), short and long
            **narrow_split(layer_ops.fused_layer, "layer_narrow"),
            **narrow_split(layer_ops.fused_layer_long, "layer_long_narrow")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.models import (
        gpu_fast, hierarchical_ordered, load_model, one_shot_sample, svg_loss)
    from deepsvg_tpu_torch.models.layers import key_padding_to_additive
    from deepsvg_tpu_torch.ops import _build
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import embedding as emb_ops
    from deepsvg_tpu_torch.ops import head as head_ops
    from deepsvg_tpu_torch.ops import layer as layer_ops
    from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
    from deepsvg_tpu_torch.svgtensor import masks as M
    from deepsvg_tpu_torch.svgtensor.constants import PAD_VAL
    from deepsvg_tpu_torch.training import (
        constant, create_train_state, make_optimizer, train_step)

    os.makedirs(OUT_DIR, exist_ok=True)
    record: dict = {}
    card = card_line()
    print(card, flush=True)
    record["card"] = card
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    torch.manual_seed(0)             # every random input of the checks, run after run
    t_start = time.perf_counter()

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
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "the parameters are not float32 masters")
    batch = generate_batch(np.random.default_rng(0), N_MAIN, cfg.max_num_groups,
                           cfg.max_seq_len)
    commands = torch.from_numpy(batch["commands"]).to(dev)
    args = torch.from_numpy(batch["args"]).to(dev)
    n, g, s_enc = commands.shape
    cmd_f, args_f = commands.reshape(n * g, s_enc), args.reshape(n * g, s_enc, -1)
    emb = model.encoder.embedding
    enc, dec = model.encoder, model.decoder
    fcn = dec.fcn
    d_model = cfg.d_model
    zeros = lambda b, s: torch.zeros((b, s), dtype=torch.float32, device=dev)  # noqa: E731
    l_e1, l_e2 = enc.encoder.layers[0], enc.hierarchical_encoder.layers[0]
    l_d1, l_d2 = dec.decoder.layers[0], dec.hierarchical_decoder.layers[0]

    def glob_bias(layer, z):
        return F.linear(z.to(bf16), layer.glob.weight.to(bf16), layer.glob.bias.to(bf16))

    kernels = {}
    with torch.no_grad():
        cmd_table, arg_tables, pos_table = emb.tables()
        emb_in = (cmd_f, args_f, None, cmd_table, arg_tables, None, pos_table[:s_enc])
        x_e1 = emb_ops.fused_embedding(*emb_in)
        key_pad = key_padding_to_additive(M.key_padding_mask(cmd_f))
        vis = M.visibility_mask(commands)
        memory = enc.encoder(x_e1, key_pad)
        pooled = (memory.float() * M.padding_mask(cmd_f)[..., None]).sum(1) \
            / M.padding_mask(cmd_f).sum(1, keepdim=True).clamp_min(1.0)
        x_e2 = enc.hierarchical_PE(pooled.reshape(n, g, -1))          # float32
        check(x_e2.dtype == torch.float32, "E2's input is not float32")
        mask_e2 = key_padding_to_additive(~vis)
        z, _, _ = model.encode(commands, args)
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
        group_table = torch.randn(12, d_model, device=dev).to(bf16)
        small = (small_c, small_a, groups, cmd_table, arg_tables, group_table,
                 pos_table[:s_enc], True)
        err_small = (emb_ops.fused_embedding(*small).float()
                     - emb_ops.embedding_reference(*small).float()).abs().max().item()
        check(err_small <= TOL_EMBED, f"embedding (groups, bad ids) err {err_small}")
        print(f"K1 embedding: max abs err {err:.3g} (E1 shapes), {err_small:.3g} "
              f"(use_group, out-of-range ids); tolerance {TOL_EMBED}", flush=True)
        kernels["embedding"] = {"max_abs_err": max(err, err_small), "tolerance": TOL_EMBED}

        # ---- K2: kernel vs plain at the main path's shapes
        mask_e1 = key_pad.clone()
        mask_e1[0] = float("-inf")                       # one fully masked sequence
        bias_d1, bias_d2 = glob_bias(l_d1, zb), glob_bias(l_d2, z)
        x_causal = torch.randn(64, 31, d_model, device=dev).to(bf16)
        x_rand8 = torch.randn(n, 8, d_model, device=dev).to(bf16)
        mask_rand8 = torch.where(torch.rand(n, 8, device=dev) < 0.3, float("-inf"), 0.0)
        mask_rand8[:, 0], mask_rand8[0] = 0.0, float("-inf")   # the first sequence fully masked
        # S=1 (128 sequences a tile of the bfloat16 kernel) and S=17 (7 a tile,
        # query blocks spanning two sequences), at batches where every
        # persistent block takes several tiles, as E1 (2,048 tiles) does; from
        # their own generator, so that every later check draws what it drew
        # before these cases existed
        gen = torch.Generator(device=dev).manual_seed(17)
        x_s1 = torch.randn(B_S1, 1, d_model, device=dev, generator=gen).to(bf16)
        mask_s1 = zeros(B_S1, 1)
        mask_s1[0] = float("-inf")
        x_s17 = torch.randn(B_S17, 17, d_model, device=dev, generator=gen).to(bf16)
        lengths = torch.randint(1, 18, (B_S17, 1), device=dev, generator=gen)
        mask_s17 = torch.where(torch.arange(17, device=dev)[None] < lengths, 0.0, float("-inf"))
        mask_s17[0] = float("-inf")
        sb_s1, sb_s17 = ((0.3 * torch.randn(b, d_model, device=dev, generator=gen)).to(bf16)
                         for b in (B_S1, B_S17))
        layer_cases = {
            "E1 encoder S=32, key pad": layer_args(l_e1, x_e1, mask_e1),
            "D1 decoder S=31, seq_bias": layer_args(l_d1, x_d1, zeros(n * g, 31), bias_d1),
            "D2 decoder S=8, seq_bias": layer_args(l_d2, dec.hierarchical_embedding(n),
                                                   zeros(n, 8), bias_d2),
            "encoder S=8, random x, key pad": layer_args(l_e2, x_rand8, mask_rand8),
            "causal S=31": layer_args(l_d1, x_causal, zeros(64, 31), bias_d1[:64], True),
            f"encoder S=1 B={B_S1}, random x, seq_bias": layer_args(l_e1, x_s1, mask_s1, sb_s1),
            f"decoder S=17 B={B_S17} causal, random x, key pad, seq_bias": layer_args(
                l_d1, x_s17, mask_s17, sb_s17, True),
        }
        layer_err = 0.0
        layer_atol = 0.0
        k2_sha256 = {}
        for what, la in layer_cases.items():
            out_k = layer_ops.fused_layer(*la)
            # the output's bytes, so that two trees' K2 can be held equal to the bit
            k2_sha256[what] = hashlib.sha256(
                out_k.contiguous().view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            out_k = out_k.float()
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
        record["k2_sha256"] = k2_sha256
        print(f"K2 outputs' SHA-256: {k2_sha256}", flush=True)

        # ---- K2, float32 form: E2 on the float32 pooled E1 output, and a
        # fully masked sequence, a seq_bias and S=31 causal beside it
        mask_e2m = mask_e2.clone()
        mask_e2m[0] = float("-inf")
        f32_cases = {
            "E2 encoder S=8, key pad": layer_args(l_e2, x_e2, mask_e2m),
            "S=31 causal, seq_bias": layer_args(l_d1, x_causal.float() * 1.001, zeros(64, 31),
                                                bias_d1[:64].float(), True),
        }
        f32_err, f32_excess = 0.0, 0.0
        for what, la in f32_cases.items():
            out_k = layer_ops.fused_layer(*la)
            out_p = layer_ops.layer_reference(*la)
            diff = (out_k - out_p).abs()
            excess = (diff - TOL_F32_RTOL * out_p.abs()).max().item()
            rms = rel_rms(out_k, out_p)
            check(out_k.dtype == torch.float32 and bool(torch.isfinite(out_k).all()),
                  f"float32 layer {what}: dtype or non-finite output")
            check(excess <= TOL_F32_ATOL and rms <= TOL_LAYER_RMS,
                  f"float32 layer {what}: an element is off by {excess} beyond "
                  f"{TOL_F32_RTOL} x |out|, relative RMS err {rms}")
            f32_err, f32_excess = max(f32_err, diff.max().item()), max(f32_excess, excess)
            print(f"K2 float32 layer {what}: max abs err {diff.max().item():.3g}; largest "
                  f"excess over {TOL_F32_RTOL} x |out| {excess:.3g} (limit {TOL_F32_ATOL}); "
                  f"relative RMS err {rms:.3g} (limit {TOL_LAYER_RMS})", flush=True)
        kernels["layer_f32"] = {"max_abs_err": f32_err, "atol_needed": f32_excess,
                                "tolerance": {"atol": TOL_F32_ATOL, "rtol": TOL_F32_RTOL,
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

        # ---- the inference path: one run, counted
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out_c, out_a = one_shot_sample(model, commands, args)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"inference path N={N_MAIN}: launches {launches}", flush=True)
        check(launches == dict.fromkeys(launches, 0) | {"embedding": 1, "layer": 12,
                                                        "layer_f32": 4, "head": 1},
              f"launches per forward {launches}, expected embedding 1, layer 12 bfloat16 + 4 "
              f"float32, head 1, and no training kernel")
        record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        check_sample(out_c, out_a, N_MAIN, cfg)
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
            with truncated_weights(l_e1, CONTROL_DROP_BITS):
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

        # ---- timing at the inference path's shapes
        yardstick = {}
        # K1, and one embedding_bag call over the same rows of one stacked table
        n_cmd, vocab = cmd_table.shape[0], arg_tables.shape[0] // emb.n_args
        table_all = torch.cat([cmd_table, arg_tables, pos_table[:s_enc]])
        idx = torch.cat([
            cmd_f.long()[..., None],
            n_cmd + vocab * torch.arange(emb.n_args, device=dev) + args_f.long() + 1,
            (n_cmd + vocab * emb.n_args + torch.arange(s_enc, device=dev))
            .expand(cmd_f.shape)[..., None]], dim=-1).reshape(-1, 2 + emb.n_args)
        bag = lambda: F.embedding_bag(idx, table_all, mode="sum")  # noqa: E731
        yardstick["embedding"] = (bag().float().reshape(x_e1.shape)
                                  - x_e1.float()).abs().max().item()
        rows = cmd_f.numel()
        kernels["embedding"].update(
            ms=cuda_ms(lambda: emb_ops.fused_embedding(*emb_in)),
            device_ms=device_busy_ms(lambda: emb_ops.fused_embedding(*emb_in), iters=ITERS),
            plain_ms=cuda_ms(lambda: emb_ops.embedding_reference(*emb_in)),
            library_ms=cuda_ms(bag))
        b_ms, b_by = bound(nbytes(cmd_f, args_f, cmd_table, arg_tables, pos_table[:s_enc], x_e1),
                           rows * x_e1.shape[-1] * (1.0 + emb.n_args), PEAK_F32)
        kernels["embedding"].update(bound_ms=b_ms, bound_by=b_by)
        k = kernels["embedding"]
        print(f"  embedding N={N_MAIN}: {k['ms']:.4f} ms{dev_text(k)} (plain "
              f"{k['plain_ms']:.4f}, embedding_bag {k['library_ms']:.4f}, bound "
              f"{k['bound_ms']:.5f} by {k['bound_by']}) on {card}", flush=True)
        del idx, table_all

        # K2 at each stage's shapes; the E1 layer is the bfloat16 kernel's row,
        # with torch.nn.TransformerEncoderLayer (same function, no seq_bias) as
        # yardstick; the E2 layer is the float32 form's row
        stages = {
            "E1": (layer_args(l_e1, x_e1, key_pad), 4),
            "E2 (float32)": (layer_args(l_e2, x_e2, mask_e2), 4),
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

        def library_layer(layer, dtype, train=False):
            return transformer_layer(layer, dtype, dev, train)

        def library_stack(layers, dtype):
            """torch.nn.TransformerEncoder of ``layers`` (no final norm),
            training mode at rate 0."""
            lib = torch.nn.TransformerEncoder(library_layer(layers[0], dtype, train=True),
                                              len(layers), enable_nested_tensor=False)
            for lib_layer, layer in zip(lib.layers, layers):
                copy_layer(lib_layer, layer)
            return lib.train()

        lib = library_layer(l_e1, bf16)
        pad_bool = M.key_padding_mask(cmd_f)
        lib_run = lambda: lib(x_e1, src_key_padding_mask=pad_bool)  # noqa: E731
        valid = ~pad_bool
        yardstick["layer"] = ((lib_run().float() - layer_ops.fused_layer(
            *stages["E1"][0]).float()).abs()[valid].max().item())
        e1 = per_stage["E1"]
        kernels["layer"].update(ms=e1["ms"], plain_ms=e1["plain_ms"],
                                library_ms=cuda_ms(lib_run), bound_ms=e1["bound_ms"],
                                bound_by=e1["bound_by"], stages=per_stage)
        lib32 = library_layer(l_e2, torch.float32)
        pad_e2 = ~vis
        lib32_run = lambda: lib32(x_e2, src_key_padding_mask=pad_e2)  # noqa: E731
        yardstick["layer_f32"] = ((lib32_run() - layer_ops.fused_layer(
            *stages["E2 (float32)"][0])).abs()[vis].max().item())
        e2 = per_stage["E2 (float32)"]
        kernels["layer_f32"].update(ms=e2["ms"], plain_ms=e2["plain_ms"],
                                    library_ms=cuda_ms(lib32_run), bound_ms=e2["bound_ms"],
                                    bound_by=e2["bound_by"])

        # K3
        r, d = x_head.shape
        n_cls = fcn.n_commands + fcn.n_args * fcn.args_dim
        b_ms, b_by = bound(nbytes(x_head) + n_cls * d * 2 + n_cls * 2 + r * (1 + fcn.n_args) * 4,
                           2.0 * r * d * n_cls, PEAK_BF16)
        # and at the autoregressive decode's R = N rows a step
        dec_in = (x_head[:N_MAIN], *head_in[1:])
        kernels["head"].update(
            ms=cuda_ms(lambda: head_ops.fused_head_argmax(*head_in)),
            plain_ms=cuda_ms(lambda: head_ops.head_argmax_reference(*head_in), iters=5),
            library_ms=cuda_ms(head_library(head_in, head_slots(fcn))),
            bound_ms=b_ms, bound_by=b_by,
            decode_ms=cuda_ms(lambda: head_ops.fused_head_argmax(*dec_in)),
            decode_library_ms=cuda_ms(head_library(dec_in, head_slots(fcn))))

        # the inference path, end to end
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
    record["inference_launches"] = launches
    record["inference_s"] = time.perf_counter() - t_start
    del x_e1, memory, pooled, x_d1, y_d1, x_head, out_d2, zb, z_groups, layer_cases, stages
    del bias_d1, out_k, out_p, diff, ids_k, ids_p
    torch.cuda.empty_cache()

    # =================================================================== training
    tb = generate_batch(np.random.default_rng(0), B_TRAIN, cfg.max_num_groups, cfg.max_seq_len)
    t_commands = torch.from_numpy(tb["commands"]).to(dev)
    t_args = torch.from_numpy(tb["args"]).to(dev)
    nb = B_TRAIN * g                                           # sequences of E1 and D1
    tc_f, ta_f = t_commands.reshape(nb, s_enc), t_args.reshape(nb, s_enc, -1)
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *shape: torch.randn(shape, device=dev, generator=gen)  # noqa: E731

    # ---- K4 against its plain version at the four stacks' shapes (B=128)
    with torch.no_grad():
        xt_e1 = emb_ops.fused_embedding(tc_f, ta_f, None, cmd_table, arg_tables, None,
                                        pos_table[:s_enc])
        kp_e1 = key_padding_to_additive(M.key_padding_mask(tc_f))
        kp_e1[0] = float("-inf")                               # one fully masked sequence
        t_vis = M.visibility_mask(t_commands)
        kp_e2 = key_padding_to_additive(~t_vis)
        kp_e2[0] = float("-inf")
        xt_e2 = enc.hierarchical_PE(randn(B_TRAIN, g, d_model))          # float32
        xt_d1, xt_d2 = dec.embedding(nb), dec.hierarchical_embedding(B_TRAIN)
        sb_d1 = glob_bias(l_d1, 0.5 * randn(nb, cfg.dim_z))
        sb_d2 = glob_bias(l_d2, 0.5 * randn(B_TRAIN, cfg.dim_z))
    train_cases = {
        "E1 S=32 key pad": (l_e1, xt_e1, None, kp_e1, False),
        "D1 S=31 seq_bias": (l_d1, xt_d1, sb_d1, zeros(nb, 31), False),
        "E2 S=8 float32 key pad": (l_e2, xt_e2, None, kp_e2, False),
        "D2 S=8 seq_bias": (l_d2, xt_d2, sb_d2, zeros(B_TRAIN, 8), False),
    }
    k4 = {}
    for what, (layer, x, sb, mask, causal) in train_cases.items():
        for rate in (0.0, DROPOUT):
            k4[f"{what} rate {rate}"] = check_layer_train(layer_vjp, what, layer, x, sb, mask,
                                                          causal, rate)
    k4["causal S=31 rate 0.1"] = check_layer_train(
        layer_vjp, "causal S=31 seq_bias", l_d1, randn(64, 31, d_model).to(bf16), sb_d1[:64],
        zeros(64, 31), True, DROPOUT)
    record["k4_f32_excess"] = k4_f32_excess(layer_vjp, *train_cases["E2 S=8 float32 key pad"][:4])
    # a fully masked sequence: zero attention output forward, and the rows'
    # gradient is the residual's alone (checked through the comparisons above,
    # which include sequence 0 of E1 and E2); here, that it stays finite
    kernels["layer_train_fwd"] = {
        "max_abs_err": max(v["forward_max_abs_err"] for v in k4.values()),
        "tolerance": {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL, "rms": TOL_LAYER_RMS}}
    kernels["layer_train_bwd"] = {
        "max_abs_err": max(r["max_abs_err"] for v in k4.values() for r in v["grads"].values()),
        "max_rms": max(r["rms"] for v in k4.values() for r in v["grads"].values()),
        "max_rms_same_gate": max(r["rms_same_gate"] for v in k4.values()
                                 for r in v["grads"].values()),
        "max_outliers": max(r["outliers"] for v in k4.values() for r in v["grads"].values()),
        "max_worst": max(r["worst"] for v in k4.values() for r in v["grads"].values()),
        "tolerance": {"rms": {str(k): v for k, v in TOL_GRAD_RMS.items()},
                      "rms_same_gate": {str(k): v for k, v in TOL_GRAD_RMS_SAME_GATE.items()},
                      "atol_of_max": TOL_GRAD_ATOL, "rtol": TOL_GRAD_RTOL,
                      "outliers": TOL_GRAD_OUTLIERS, "worst_of_max": TOL_GRAD_WORST,
                      "worst_of_max_same_gate": TOL_GRAD_WORST_SAME_GATE}}
    record["layer_train_cases"] = k4

    # ---- K5 against its plain version at the training path's shape
    r_ce = nb * 31
    wa, ba = fcn.args_fcn.weight, fcn.args_fcn.bias
    y_ce = randn(r_ce, d_model).to(bf16).requires_grad_()
    tgt_ce = (t_args[..., 1:, :] + 1).to(torch.int32).reshape(r_ce, -1)
    g_ce = (torch.rand(r_ce, fcn.n_args, device=dev, generator=gen) / r_ce)
    ce_k = ce_ops.args_ce(y_ce, wa, ba, tgt_ce, bf16)
    grads_k = torch.autograd.grad(ce_k, [y_ce, wa, ba], g_ce)
    ce_p = ce_ops.plain_args_ce(y_ce, wa, ba, tgt_ce, bf16)
    grads_p = torch.autograd.grad(ce_p, [y_ce, wa, ba], g_ce)
    ce_err = (ce_k - ce_p).abs().max().item()
    check(tuple(ce_k.shape) == (r_ce, fcn.n_args) and ce_err <= TOL_CE,
          f"K5 cross-entropy max abs err {ce_err} > {TOL_CE}")
    ce_rms = {}
    for name, a, w in zip(("dy", "dWa", "dba"), grads_k, grads_p):
        ce_rms[name] = rel_rms(a, w)
        check_later(a.shape == w.shape and bool(torch.isfinite(a).all())
                    and ce_rms[name] <= TOL_CE_GRAD_RMS,
              f"K5 {name}: relative RMS err {ce_rms[name]} > {TOL_CE_GRAD_RMS}")
    ce_grad_err = max((a.float() - w.float()).abs().max().item()
                      for a, w in zip(grads_k, grads_p))
    print(f"K5 args_ce R={r_ce}: ce max abs err {ce_err:.3g} (limit {TOL_CE}); gradients' "
          f"relative RMS err {ce_rms} (limit {TOL_CE_GRAD_RMS})", flush=True)
    kernels["args_ce_fwd"] = {"max_abs_err": ce_err, "tolerance": TOL_CE}
    kernels["args_ce_bwd"] = {"max_abs_err": ce_grad_err, "rms": ce_rms,
                              "tolerance": TOL_CE_GRAD_RMS}
    del ce_p, grads_p, grads_k, ce_k

    # ---- K6 against its plain version: the batch's tokens (mostly PAD
    # arguments), then groups and out-of-range ids
    def check_embedding_bwd(what, c, a, grp, use_group):
        tables = [t.float().requires_grad_() for t in
                  (cmd_table, arg_tables, torch.zeros(12, d_model, device=dev),
                   pos_table[:c.shape[1]])]
        dy = randn(*c.shape, d_model).to(bf16)
        got, same = k6_three_runs(emb_ops, c, a, grp, dy, n_cmd, vocab, 12, use_group)
        check_later(same, f"K6 {what}: three runs not equal to the bit")
        ref = emb_ops.embedding_reference(c, a, grp, tables[0], tables[1], tables[2],
                                          tables[3], use_group)
        want = torch.autograd.grad(ref, tables, dy.float(), allow_unused=True)
        worst, err_abs = 0.0, 0.0
        for name, a_, w_ in zip(("dcmd", "darg", "dgroup", "dpos"), got, want):
            if w_ is None:
                check(not bool(a_.any()), f"K6 {what} {name}: not zero without groups")
                continue
            err = (a_ - w_).abs().max().item()
            worst = max(worst, err / max(w_.abs().max().item(), 1e-30))
            err_abs = max(err_abs, err)
        check_later(worst <= TOL_EMBED_BWD,
                    f"K6 {what}: err {worst} of the largest entry > {TOL_EMBED_BWD}")
        return worst, err_abs, same

    pad_share = (ta_f < 0).float().mean().item()
    k6_main = check_embedding_bwd("B=128", tc_f, ta_f, None, False)
    bad_c, bad_a = tc_f[:8].clone(), ta_f[:8].clone()
    bad_c[0, 3], bad_a[1, 2, 4], bad_a[2, 5, 0] = 9, 300.0, -3.0
    bad_g = M.group_mask(bad_c)
    bad_g[3, 5] = 12
    k6_small = check_embedding_bwd("groups, out-of-range ids", bad_c, bad_a, bad_g, True)
    print(f"K6 embedding backward: largest err {k6_main[0]:.3g} of the table gradient's "
          f"largest entry at B={B_TRAIN} ({pad_share:.3f} of the arguments are PAD), "
          f"{k6_small[0]:.3g} with groups and out-of-range ids (limit {TOL_EMBED_BWD}); "
          f"three runs equal to the bit: {k6_main[2]}, {k6_small[2]}", flush=True)
    kernels["embedding_bwd"] = {"max_abs_err": max(k6_main[1], k6_small[1]),
                                "tolerance": TOL_EMBED_BWD,
                                "three_runs_equal": k6_main[2] and k6_small[2]}

    # ---- (a) one step, kernel path against plain path, B=16, dropout 0
    def new_state(dropout):
        m = load_model(CHECKPOINT, dataclasses.replace(cfg, dropout=dropout), device=dev)
        optimizer = make_optimizer(constant(LR))
        return create_train_state(m, optimizer, init=False), optimizer

    def batch_of(b):
        return {"commands": t_commands[:b], "args": t_args[:b]}

    def one_step(dropout, b):
        state, optimizer = new_state(dropout)
        state, res = train_step(state, batch_of(b), LOSS_WEIGHTS, optimizer, MODEL_ARGS)
        names = [k for k, _ in state.model.named_parameters()]
        return res, dict(zip(names, [p.grad.detach().clone() for p in state.parameters()]))

    res_k, grads_k = one_step(0.0, B_STEP_CHECK)
    with plain_path(emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp):
        res_p, grads_p = one_step(0.0, B_STEP_CHECK)
    step_cmp = {}
    for k in ("loss", "loss_visibility", "loss_cmd", "loss_args"):
        a, b_ = float(res_k[k]), float(res_p[k])
        step_cmp[k] = (a, b_)
        check_later(np.isfinite(a) and abs(a - b_) <= TOL_STEP_LOSS * abs(b_) + 1e-4,
              f"step {k}: kernel path {a}, plain path {b_}")
    norm_k, norm_p = float(res_k["grad_norm"]), float(res_p["grad_norm"])
    check_later(abs(norm_k - norm_p) <= TOL_STEP_NORM * norm_p,
          f"step grad_norm: kernel path {norm_k}, plain path {norm_p}")
    leaf_rms = {k: rel_rms(grads_k[k], grads_p[k]) for k in grads_p}
    flat_k = torch.cat([grads_k[k].flatten() for k in grads_p]).double()
    flat_p = torch.cat([grads_p[k].flatten() for k in grads_p]).double()
    cosine = float(flat_k @ flat_p / flat_k.norm() / flat_p.norm())
    worst_leaf = max(leaf_rms, key=leaf_rms.get)
    check(len(leaf_rms) == 210 and all(np.isfinite(v) for v in leaf_rms.values()),
          "a leaf's gradient is missing or not finite")
    check_later(cosine >= TOL_STEP_COSINE and leaf_rms[worst_leaf] <= TOL_STEP_LEAF_RMS,
          f"step gradients: cosine {cosine} (limit {TOL_STEP_COSINE}), worst leaf "
          f"{worst_leaf} relative RMS err {leaf_rms[worst_leaf]} (limit {TOL_STEP_LEAF_RMS})")
    print(f"one step B={B_STEP_CHECK} dropout 0 (E2 and D2 through K7 on the kernel path), "
          f"kernel path vs plain path: losses (kernel, "
          f"plain) {step_cmp}; grad norm {norm_k:.5g} vs {norm_p:.5g}; whole-gradient cosine "
          f"{cosine:.6f}; per-leaf relative RMS err median "
          f"{statistics.median(leaf_rms.values()):.3g}, worst {leaf_rms[worst_leaf]:.3g} "
          f"({worst_leaf}) over {len(leaf_rms)} leaves", flush=True)
    record["step_vs_plain"] = {"losses": step_cmp, "grad_norm": (norm_k, norm_p),
                               "cosine": cosine, "leaf_rms_worst": leaf_rms[worst_leaf],
                               "leaf_rms_worst_leaf": worst_leaf,
                               "leaf_rms_median": statistics.median(leaf_rms.values())}
    del grads_k, grads_p, flat_k, flat_p
    torch.cuda.empty_cache()

    # ---- (b), (c), (d): the training path at B=128, dropout 0.1
    def train_loop(b: int, expected: dict, make_state=None, weights=LOSS_WEIGHTS,
                   what: str = "") -> dict:
        """TRAIN_STEPS steps on one batch of ``b``, dropout 0.1: the first
        counted (``expected`` launches), the loss finite and falling, every
        leaf moved, the last TRAIN_STEPS - 3 timed by CUDA events (median of
        the steps) and by the host clock (their mean, to a synchronize).
        ``make_state(dropout)`` gives another model's state (default: the
        flagship checkpoint's)."""
        state, optimizer = (make_state or new_state)(DROPOUT)
        full = batch_of(b)
        before = [p.detach().clone() for p in state.parameters()]
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        events, losses = [], []
        for i in range(TRAIN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, res = train_step(state, full, weights, optimizer, MODEL_ARGS)
            end.record()
            events.append((start, end))
            losses.append(res)
            if i == 0:
                torch.cuda.synchronize()
                counted = read_counts()
            if i == 2:
                torch.cuda.synchronize()
                t_host = time.perf_counter()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / (TRAIN_STEPS - 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"training path{what} B={b}: launches in one step {counted}", flush=True)
        check(counted == expected, f"launches per training step at B={b} {counted}, "
                                   f"expected {expected}")
        loss_values = [float(r["loss"]) for r in losses]
        check(all(np.isfinite(float(v)) for r in losses for v in r.values()),
              f"a training loss or gradient norm is not finite: {loss_values}")
        check(loss_values[-1] < loss_values[0],
              f"the loss did not fall over {TRAIN_STEPS} steps on one batch: {loss_values}")
        moved = sum(not torch.equal(p, old) for p, old in zip(state.parameters(), before))
        check(moved == len(before) and state.step == TRAIN_STEPS
              and all(p.dtype == torch.float32 for p in state.parameters()),
              f"{moved} of {len(before)} leaves moved; step {state.step}")
        per_step = [s.elapsed_time(e) for s, e in events[3:]]
        step_ms = statistics.median(per_step)
        print(f"training{what} B={b} dropout {DROPOUT} bf16, lr {LR}: loss {loss_values[0]:.4f} -> "
              f"{loss_values[-1]:.4f} over {TRAIN_STEPS} steps on one batch, all finite; "
              f"{step_ms:.3f} ms/step median of {TRAIN_STEPS - 3} (range {min(per_step):.3f}-"
              f"{max(per_step):.3f}), {b / step_ms * 1e3:.1f} "
              f"samples/s (host clock: {host_ms:.3f} ms/step mean), peak memory {peak:.2f} "
              f"GiB on {card}", flush=True)
        return {"B": b, "steps": TRAIN_STEPS, "losses": loss_values,
                "grad_norms": [float(r["grad_norm"]) for r in losses],
                "median_ms_per_step": step_ms, "samples_per_s": b / step_ms * 1e3,
                "ms_per_step_range": (min(per_step), max(per_step)),
                "host_mean_ms_per_step": host_ms,
                "peak_memory_gib": peak, "launches_per_step": counted}

    def loop_checksums(b: int) -> tuple:
        """train_loop's TRAIN_STEPS steps at ``b`` from a fresh state,
        untimed: the leaves' names, per step and leaf an exact checksum of
        the gradient (the sum of its bits as int64) ``[steps, leaves]``, and
        the gradient norms."""
        state, optimizer = new_state(DROPOUT)
        full = batch_of(b)
        sums, norms = [], []
        for _ in range(TRAIN_STEPS):
            state, res = train_step(state, full, LOSS_WEIGHTS, optimizer, MODEL_ARGS)
            sums.append(torch.stack([p.grad.view(torch.int32).sum(dtype=torch.int64)
                                     for p in state.parameters()]))
            norms.append(res["grad_norm"])
        names = [n for n, _ in state.model.named_parameters()]
        return names, torch.stack(sums).cpu(), torch.stack(norms).tolist()

    no_launch = dict.fromkeys(read_counts(), 0)
    # B=128: 1,024 rows at E2 and D2, over the stack gate, so layer by layer
    record["train"] = train_loop(B_TRAIN, no_launch | {
        "embedding": 1, "layer_train_fwd": 16, "layer_train_bwd": 16, "layer_train_fwd_f32": 4,
        "layer_train_bwd_f32": 4, "args_ce_fwd": 1, "args_ce_bwd": 1, "embedding_bwd": 1})
    train_launches = record["train"]["launches_per_step"]
    torch.cuda.empty_cache()

    # ---- timing at the training path's shapes
    train_stages = {}
    for what, (layer, x, sb, mask, _) in train_cases.items():
        fwd, both = k4_runs(layer_vjp.fused_layer_train, layer, x, sb, mask)
        pfwd, pboth = k4_runs(layer_vjp.plain_layer_train, layer, x, sb, mask)
        f_ms, fb_ms = cuda_ms(fwd), cuda_ms(both)
        pf_ms, pfb_ms = cuda_ms(pfwd, iters=5, warmup=1), cuda_ms(pboth, iters=5, warmup=1)
        ffn = layer.ff1.out_features
        bf_ms, bf_by = k4_bound(x, sb, ffn, False)
        bb_ms, bb_by = k4_bound(x, sb, ffn, True)
        saved = k4_saved_bytes(*x.shape, ffn, layer.n_heads, x.element_size())
        train_stages[what] = {
            "B": x.shape[0], "S": x.shape[1], "launches_per_step": 4,
            "fwd_ms": f_ms, "bwd_ms": fb_ms - f_ms, "plain_fwd_ms": pf_ms,
            "plain_bwd_ms": pfb_ms - pf_ms, "fwd_bound_ms": bf_ms, "fwd_bound_by": bf_by,
            "bwd_bound_ms": bb_ms, "bwd_bound_by": bb_by, "saved_bytes": saved}
    # the yardstick: torch.nn.TransformerEncoderLayer, training mode at rate 0
    # (its dropout is not this one), forward and backward on the E1 inputs
    lib_t = library_layer(l_e1, bf16, train=True)
    x_lib = xt_e1.detach().requires_grad_()
    g_lib = torch.randn_like(x_lib)
    pad_t = M.key_padding_mask(tc_f)

    def lib_fwd():
        with torch.no_grad():
            return lib_t(x_lib, src_key_padding_mask=pad_t)

    def lib_both():
        return torch.autograd.grad(lib_t(x_lib, src_key_padding_mask=pad_t),
                                   [x_lib, *lib_t.parameters()], g_lib)
    lib_f_ms, lib_fb_ms = cuda_ms(lib_fwd), cuda_ms(lib_both)
    e1t = train_stages["E1 S=32 key pad"]
    kernels["layer_train_fwd"].update(
        ms=e1t["fwd_ms"], plain_ms=e1t["plain_fwd_ms"], library_ms=lib_f_ms,
        bound_ms=e1t["fwd_bound_ms"], bound_by=e1t["fwd_bound_by"], stages=train_stages)
    kernels["layer_train_bwd"].update(
        ms=e1t["bwd_ms"], plain_ms=e1t["plain_bwd_ms"], library_ms=lib_fb_ms - lib_f_ms,
        bound_ms=e1t["bwd_bound_ms"], bound_by=e1t["bwd_bound_by"])
    # K4's float32 short form (E2 at B=128) on the TF32 wgmma launches: its own
    # entries, timed beside nn.TransformerEncoderLayer in float32 (full float32
    # products, the library's default)
    e2t = train_stages["E2 S=8 float32 key pad"]
    e2_cases = [v for k, v in k4.items() if k.startswith("E2 S=8 float32")]
    # the library layer's initialisation and its gradient draw from the
    # default generators, which the checks after this read: forked, so that
    # they read the same draws with or without this timing (K7's checks
    # below do not pass on every draw: scripts/k7_seed_sweep.py reads their
    # spread over many)
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        lib32_t = library_layer(l_e2, torch.float32, train=True)
        x_lib32 = xt_e2.detach().requires_grad_()
        g_lib32 = torch.randn_like(x_lib32)

        def lib32_fwd():
            with torch.no_grad():
                return lib32_t(x_lib32, src_key_padding_mask=~t_vis)

        def lib32_both():
            return torch.autograd.grad(lib32_t(x_lib32, src_key_padding_mask=~t_vis),
                                       [x_lib32, *lib32_t.parameters()], g_lib32)
        lib32_f_ms, lib32_fb_ms = cuda_ms(lib32_fwd), cuda_ms(lib32_both)
    kernels["layer_train_fwd_f32"] = {
        "max_abs_err": max(v["forward_max_abs_err"] for v in e2_cases),
        "tolerance": {"atol": TOL_F32_ATOL, "rtol": TOL_F32_RTOL, "rms": TOL_LAYER_RMS},
        "ms": e2t["fwd_ms"], "plain_ms": e2t["plain_fwd_ms"], "library_ms": lib32_f_ms,
        "bound_ms": e2t["fwd_bound_ms"], "bound_by": e2t["fwd_bound_by"]}
    kernels["layer_train_bwd_f32"] = {
        "max_abs_err": max(r["max_abs_err"] for v in e2_cases for r in v["grads"].values()),
        "max_rms": max(r["rms"] for v in e2_cases for r in v["grads"].values()),
        "tolerance": kernels["layer_train_bwd"]["tolerance"],
        "ms": e2t["bwd_ms"], "plain_ms": e2t["plain_bwd_ms"],
        "library_ms": lib32_fb_ms - lib32_f_ms, "bound_ms": e2t["bwd_bound_ms"],
        "bound_by": e2t["bwd_bound_by"]}
    del lib32_t, x_lib32, g_lib32

    # K5, and F.linear + F.cross_entropy as its yardstick
    n_cls = fcn.n_args * fcn.args_dim
    tgt_lib = tgt_ce.long().reshape(-1)

    def ce_runs(fn):
        def fwd():
            with torch.no_grad():
                return fn(y_ce, wa, ba, tgt_ce, bf16)

        def both():
            return torch.autograd.grad(fn(y_ce, wa, ba, tgt_ce, bf16), [y_ce, wa, ba], g_ce)
        return fwd, both

    wa16, ba16 = wa.detach().to(bf16).requires_grad_(), ba.detach().to(bf16).requires_grad_()

    def lib_ce(grad):
        with torch.enable_grad() if grad else torch.no_grad():
            logits = F.linear(y_ce, wa16, ba16).reshape(-1, fcn.args_dim)
            ce = F.cross_entropy(logits, tgt_lib, reduction="none").reshape(r_ce, -1)
            if grad:
                return torch.autograd.grad(ce, [y_ce, wa16, ba16], g_ce.to(ce.dtype))
            return ce
    yardstick["args_ce"] = (lib_ce(False).float()
                            - ce_ops.args_ce(y_ce, wa, ba, tgt_ce, bf16)).abs().max().item()
    (fwd, both), (pfwd, pboth) = ce_runs(ce_ops.args_ce), ce_runs(ce_ops.plain_args_ce)
    f_ms, fb_ms = cuda_ms(fwd), cuda_ms(both)
    pf_ms, pfb_ms = cuda_ms(pfwd, iters=5, warmup=1), cuda_ms(pboth, iters=5, warmup=1)
    lf_ms, lfb_ms = cuda_ms(lambda: lib_ce(False)), cuda_ms(lambda: lib_ce(True))
    ops_ce = 2.0 * r_ce * d_model * n_cls
    head_bytes = n_cls * d_model * 2 + n_cls * 2
    b_ms, b_by = bound(nbytes(y_ce, tgt_ce) + head_bytes + r_ce * fcn.n_args * 4, ops_ce,
                       PEAK_BF16)
    kernels["args_ce_fwd"].update(ms=f_ms, plain_ms=pf_ms, library_ms=lf_ms, bound_ms=b_ms,
                                  bound_by=b_by)
    b_ms, b_by = bound(2 * nbytes(y_ce) + nbytes(tgt_ce) + head_bytes + 2 * r_ce * fcn.n_args * 4
                       + (n_cls * d_model + n_cls) * 4, 3 * ops_ce, PEAK_BF16)
    kernels["args_ce_bwd"].update(ms=fb_ms - f_ms, plain_ms=pfb_ms - pf_ms,
                                  library_ms=lfb_ms - lf_ms, bound_ms=b_ms, bound_by=b_by)

    # K6, and one index_add_ of the expanded dy rows into one stacked table as
    # its yardstick (the expansion is made beforehand and not timed)
    dy = randn(nb, s_enc, d_model).to(bf16)
    tokens = nb * s_enc
    idx = torch.cat([
        tc_f.long()[..., None],
        n_cmd + vocab * torch.arange(emb.n_args, device=dev) + ta_f.long() + 1,
        (n_cmd + vocab * emb.n_args + torch.arange(s_enc, device=dev))
        .expand(tc_f.shape)[..., None]], dim=-1).reshape(-1)
    src = dy.float().reshape(tokens, 1, d_model).expand(-1, 2 + emb.n_args, -1) \
        .reshape(-1, d_model).contiguous()
    stacked = torch.zeros(n_cmd + vocab * emb.n_args + s_enc, d_model, device=dev)
    tables32 = [t.float().requires_grad_() for t in (cmd_table, arg_tables, pos_table[:s_enc])]

    def plain_k6():
        out = emb_ops.embedding_reference(tc_f, ta_f, None, tables32[0], tables32[1], None,
                                          tables32[2])
        return torch.autograd.grad(out, tables32, dy.float())
    b_ms, b_by = bound(nbytes(tc_f, dy) + tokens * emb.n_args * 4 + stacked.numel() * 4,
                       tokens * d_model * (2.0 + emb.n_args), PEAK_F32)
    # timed on int32 ids, as the step's backward gets them
    k6_args = (tc_f, ta_f.to(torch.int32), None, dy, n_cmd, vocab, 0, False)
    kernels["embedding_bwd"].update(
        ms=cuda_ms(lambda: emb_ops.embedding_backward(*k6_args)),
        device_ms=device_busy_ms(lambda: emb_ops.embedding_backward(*k6_args), iters=ITERS),
        plain_ms=cuda_ms(plain_k6, iters=5, warmup=1),
        library_ms=cuda_ms(lambda: stacked.index_add_(0, idx, src)), bound_ms=b_ms,
        bound_by=b_by)
    print(f"yardstick agreement (max abs diff vs the kernel): {yardstick}", flush=True)
    record["yardstick_max_abs_diff"] = yardstick
    for what, st in train_stages.items():
        print(f"  layer_train {what} B={st['B']}: forward {st['fwd_ms']:.4f} ms (plain "
              f"{st['plain_fwd_ms']:.4f}, bound {st['fwd_bound_ms']:.4f} by "
              f"{st['fwd_bound_by']}), backward {st['bwd_ms']:.4f} ms (plain "
              f"{st['plain_bwd_ms']:.4f}, bound {st['bwd_bound_ms']:.4f} by "
              f"{st['bwd_bound_by']}), saved for the backward {st['saved_bytes'] / 2**20:.1f} "
              f"MiB, x 4 per step")
    for name in ("args_ce_fwd", "args_ce_bwd", "embedding_bwd"):
        k = kernels[name]
        print(f"  {name}: {k['ms']:.4f} ms{dev_text(k)} (plain {k['plain_ms']:.4f}, library "
              f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by {k['bound_by']})")

    # ======================================= the recipe's training run (B=60)
    e2_layers = list(enc.hierarchical_encoder.layers)
    d2_layers = list(dec.hierarchical_decoder.layers)
    n_stack = len(e2_layers)
    with torch.no_grad():
        stack_inputs = {}
        for b in (B_RECIPE, B_GATE_EDGE, B_TRAIN):
            # E2: the pooled E1 output (float32) with its position table,
            # the visibility mask (sequence 0 fully masked), no injection
            stack_inputs["E2", b] = (enc.hierarchical_PE(randn(b, g, d_model)),
                                     torch.zeros(n_stack, b, d_model, device=dev), kp_e2[:b])
            # D2: the group queries, each layer's glob(z), no mask
            z_d2 = 0.5 * randn(b, cfg.dim_z)
            stack_inputs["D2", b] = (dec.hierarchical_embedding(b),
                                     torch.stack([glob_bias(layer, z_d2) for layer in d2_layers]),
                                     zeros(b, g))
    stack_layers = {"E2": e2_layers, "D2": d2_layers}

    # K7's float32 form on the same masters (float32 layers), and a narrower
    # width: D=128, 4 heads, FF 512, random layers from a seed of their own
    from deepsvg_tpu_torch.models.layers import EncoderLayerImproved

    def stack_twins(layers, dtype):
        twins = []
        for layer in layers:
            twin = EncoderLayerImproved(d_model, layer.n_heads, cfg.dim_feedforward, 0.0,
                                        dtype).to(dev)
            with torch.no_grad():
                for dst, src in zip(twin.masters(), layer.masters()):
                    dst.copy_(src)
            twins.append(twin)
        return twins
    stack_layers["E2 float32"] = stack_twins(e2_layers, torch.float32)
    stack_layers["D2 float32"] = stack_twins(d2_layers, torch.float32)
    gen_narrow = torch.Generator(device=dev).manual_seed(14)

    def narrow_layers(dtype, d=128, heads=4, f=512):
        layers = []
        for _ in range(n_stack):
            layer = EncoderLayerImproved(d, heads, f, 0.0, dtype).to(dev)
            with torch.no_grad():
                for w in layer.masters():
                    noise = torch.randn(w.shape, device=dev, generator=gen_narrow)
                    if w.dim() == 2 and w.shape[0] == 2:        # LayerNorm: scale, bias
                        w.copy_(0.1 * noise + torch.tensor([[1.0], [0.0]], device=dev))
                    else:
                        w.copy_(noise * (w.shape[1] ** -0.5 if w.dim() == 2 else 0.1))
            layers.append(layer)
        return layers
    with torch.no_grad():
        stack_inputs["D=128", B_RECIPE] = (
            torch.randn(B_RECIPE, g, 128, device=dev, generator=gen_narrow),
            0.3 * torch.randn(n_stack, B_RECIPE, 128, device=dev, generator=gen_narrow),
            kp_e2[:B_RECIPE])
    stack_layers["D=128"] = narrow_layers(bf16)
    stack_layers["D=128 float32"] = narrow_layers(torch.float32)

    # ---- K7 against its plain version and against the chain of K4 calls:
    # E2 and D2 at B=60 and the gate edge B=64, four layers and two, rates 0
    # and 0.1, in bfloat16 and float32, and the narrower width; each case
    # over K7_DRAWS draws of the inputs that stack_inputs holds one of
    def k7_draw(stage, b):
        def draw(gen):
            with torch.no_grad():
                if stage == "E2":
                    return (enc.hierarchical_PE(
                        torch.randn(b, g, d_model, device=dev, generator=gen)),
                        torch.zeros(n_stack, b, d_model, device=dev), kp_e2[:b])
                if stage == "D2":
                    z_d = 0.5 * torch.randn(b, cfg.dim_z, device=dev, generator=gen)
                    return (dec.hierarchical_embedding(b),
                            torch.stack([glob_bias(layer, z_d) for layer in d2_layers]),
                            zeros(b, g))
                return (torch.randn(b, g, 128, device=dev, generator=gen),
                        0.3 * torch.randn(n_stack, b, 128, device=dev, generator=gen),
                        kp_e2[:b])
        return draw
    k7 = {}
    for stage, b, rate, n_layers in (
            ("E2", B_RECIPE, 0.0, 4), ("E2", B_RECIPE, DROPOUT, 4), ("D2", B_RECIPE, 0.0, 4),
            ("D2", B_RECIPE, DROPOUT, 4), ("E2", B_GATE_EDGE, DROPOUT, 4),
            ("D2", B_GATE_EDGE, DROPOUT, 4), ("D2", B_RECIPE, DROPOUT, 2),
            ("E2 float32", B_RECIPE, 0.0, 4), ("E2 float32", B_RECIPE, DROPOUT, 4),
            ("D2 float32", B_RECIPE, 0.0, 4), ("D2 float32", B_RECIPE, DROPOUT, 4),
            ("E2 float32", B_GATE_EDGE, DROPOUT, 4), ("D2 float32", B_GATE_EDGE, DROPOUT, 4),
            ("E2 float32", B_RECIPE, DROPOUT, 2), ("D=128", B_RECIPE, DROPOUT, 4),
            ("D=128 float32", B_RECIPE, DROPOUT, 2)):
        k7[f"{stage} B={b} L={n_layers} rate {rate}"] = check_stack_train(
            stack_vjp, layer_vjp, f"{stage} B={b} L={n_layers}",
            stack_layers[stage][:n_layers], k7_draw(stage.split(" float32")[0], b), rate,
            outliers_aligned="float32" in stage or stage.startswith("D="))
        # the default generator advances as when each case drew its output
        # gradient from it, so that every later check draws what it drew
        torch.randn(stack_inputs[stage.split(" float32")[0], b][0].shape, device=dev)
    # the controls: each gradient gate (K7's with its units, the chain's
    # with its own) must fail where layer 1's weights are cut
    k7_controls = {}
    for stage in ("E2", "E2 float32"):
        res = check_stack_train(stack_vjp, layer_vjp, f"{stage} B={B_RECIPE} L=4",
                                stack_layers[stage], k7_draw("E2", B_RECIPE), DROPOUT,
                                outliers_aligned="float32" in stage,
                                control_bits=CONTROL_MANTISSA_BITS)
        grads_failed = any("with the ReLU units aligned" in m for m in res["failed"])
        chain_failed = any("with the chain's ReLU units" in m for m in res["failed"])
        k7_controls[stage] = {"failed": res["failed"], "worst": res["worst"],
                              "gradient_gate_failed": grads_failed,
                              "chain_gate_failed": chain_failed}
        check(grads_failed and chain_failed,
              f"K7 {stage}: a gradient gate passed its control (layer 1 cut to "
              f"{CONTROL_MANTISSA_BITS} mantissa bits): K7's failed {grads_failed}, the "
              f"chain's {chain_failed}")
    record["stack_train_controls"] = k7_controls
    for suffix, is_f32 in (("", False), ("_f32", True)):
        cases = [v for name, v in k7.items() if ("float32" in name) == is_f32]
        all_grads = [r for v in cases for r in v["grads"].values()]
        kernels["stack_fwd" + suffix] = {
            "max_abs_err": max(v["forward_max_abs_err"] for v in cases),
            "tolerance": {"layer_atol": TOL_LAYER_ATOL, "layer_rtol": TOL_LAYER_RTOL,
                          "layer_rms": TOL_LAYER_RMS, "stack_rms": TOL_STACK_RMS}}
        kernels["stack_bwd" + suffix] = {
            "max_abs_err": max(r["max_abs_err"] for r in all_grads),
            "max_rms": max(r["rms"] for r in all_grads),
            "max_rms_same_gate": max(r["rms_same_gate"] for r in all_grads),
            "tolerance": {"rms": TOL_STACK_GRAD_RMS,
                          "rms_same_gate": TOL_STACK_GRAD_RMS_SAME_GATE,
                          "worst_of_max": TOL_GRAD_WORST,
                          "worst_of_max_same_gate": TOL_GRAD_WORST_SAME_GATE}}
    record["stack_train_cases"] = k7

    # ---- the step at the recipe batch: E2 and D2 through K7
    recipe_launches = no_launch | {
        "embedding": 1, "layer_train_fwd": 8, "layer_train_bwd": 8, "stack_fwd": 2,
        "stack_bwd": 2, "args_ce_fwd": 1, "args_ce_bwd": 1, "embedding_bwd": 1}
    record["train_recipe"] = train_loop(B_RECIPE, recipe_launches)
    state60, optimizer60 = new_state(DROPOUT)
    recipe_batch = batch_of(B_RECIPE)
    busy60 = device_busy_ms(lambda: train_step(state60, recipe_batch, LOSS_WEIGHTS, optimizer60,
                                               MODEL_ARGS))
    del state60, optimizer60
    torch.cuda.empty_cache()

    # ---- the B=128 loop twice more, after every phase since its first run
    # has churned the allocator and the card, untimed, checksums of every
    # leaf's gradient at every step. No kernel of the step sums with atomics
    # (K6 in a fixed order since it has none), so the two runs must be equal
    # in every leaf at every step.
    leaves, sums_a, norms_a = loop_checksums(B_TRAIN)
    _, sums_b, norms_b = loop_checksums(B_TRAIN)
    differ = sums_a != sums_b
    parted = int(differ.any(1).nonzero()[0]) if bool(differ.any()) else None
    first_leaves = ([] if parted is None
                    else [leaves[j] for j in differ[parted].nonzero().flatten().tolist()])
    record["train_rerun"] = {"parts_at_step": parted, "first_leaves": first_leaves,
                             "norms_equal": norms_a == norms_b}
    print(f"the B={B_TRAIN} loop run twice more: "
          + ("equal to the bit at every step and leaf" if parted is None else
             f"parts at step {parted}, first in {first_leaves}"), flush=True)
    check(parted is None and norms_a == norms_b,
          f"the B={B_TRAIN} loop run twice parts at step {parted} in leaves {first_leaves}")

    # ---- would a wider stack gate pay on this card? The step at B=128 (E2
    # and D2 at 1,024 rows), the gate as it is and at 1,024 rows in turns,
    # step by step (the host's pace drifts within a call): host clock around
    # each step, which ends in a synchronize
    from deepsvg_tpu_torch.models import layers as model_layers
    narrow_gate = model_layers.use_stack_fused

    def wide_gate(deterministic, n_layers, b, s):
        s_pad = -(-s // 8) * 8
        return not deterministic and n_layers > 1 and s_pad <= 16 and b * s_pad <= 1024
    state_g, optimizer_g = new_state(DROPOUT)
    batch_g = batch_of(B_TRAIN)
    gate_ms = {"narrow": [], "wide": []}
    try:
        for i in range(2 + 2 * ITERS):
            which = ("narrow", "wide")[i % 2]
            model_layers.use_stack_fused = narrow_gate if which == "narrow" else wide_gate
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            train_step(state_g, batch_g, LOSS_WEIGHTS, optimizer_g, MODEL_ARGS)
            torch.cuda.synchronize()
            if i >= 2:
                gate_ms[which].append((time.perf_counter() - t0) * 1e3)
            if i == 1:
                check(read_counts() == recipe_launches,
                      f"B={B_TRAIN} with the gate at 1,024 rows: launches {read_counts()}")
    finally:
        model_layers.use_stack_fused = narrow_gate
    record["gate_at_1024_rows"] = {k: v for k, v in gate_ms.items()}
    print(f"stack gate at B={B_TRAIN}, steps in turns, host clock to a synchronize: through K7 "
          f"median {statistics.median(gate_ms['wide']):.3f} ms (range "
          f"{min(gate_ms['wide']):.3f}-{max(gate_ms['wide']):.3f}), layer by layer "
          f"{statistics.median(gate_ms['narrow']):.3f} ms ({min(gate_ms['narrow']):.3f}-"
          f"{max(gate_ms['narrow']):.3f}), {ITERS} steps each", flush=True)
    del state_g, optimizer_g
    torch.cuda.empty_cache()

    # ---- the training CLI, the recipe's entry point
    cli = run_cli(dev, reset_counts, read_counts, recipe_launches)
    cli_launches = cli["launches_first_run"]
    cli["device_busy_ms_per_step"] = busy60
    cli["idle_share"] = None if busy60 is None else 1 - busy60 / cli["wall_ms_per_step_mean"]
    record["cli"] = cli
    print(f"CLI loop B={B_RECIPE}: wall {cli['wall_ms_per_step_mean']:.3f} ms/step, "
          f"{B_RECIPE / cli['wall_ms_per_step_mean'] * 1e3:.1f} samples/s; device busy "
          f"{busy60 if busy60 is None else round(busy60, 3)} ms per step (train_step under "
          f"torch.profiler); idle share "
          f"{'not measured' if busy60 is None else round(cli['idle_share'], 4)} on {card}",
          flush=True)

    # ---- K7 and the chain of K4 calls timed, at 480, 512 and 1,024 rows
    def stack_runs(stage, b, fn):
        layers = stack_layers[stage]
        x, biases, mask = stack_inputs[stage.split(" float32")[0], b]
        dt = layers[0].compute_dtype
        masters = stacked_masters(layers)
        x = x.detach().to(dt).requires_grad_()
        bias = biases.detach().to(dt).requires_grad_()
        gy = torch.randn(x.shape, device=dev).to(dt)
        call = (x, bias, *masters, mask, 7, layers[0].n_heads, False, DROPOUT, dt)
        leaves = [x, bias, *masters]

        def fwd():
            with torch.no_grad():
                return fn(*call)

        def both():
            return torch.autograd.grad(fn(*call), leaves, gy)
        return fwd, both

    def chain_fn(*call):
        return k4_chain(layer_vjp, *call)

    def k7_bound(b, backward, es=2, peak=PEAK_BF16):
        """The bound of the function: x, the mask, the injections and the
        four layers' weights as the kernel reads them in, out (forward), or
        g in and dx, dseq_bias and the float32 weight gradients out
        (backward); the products and attention of four layers. ``es``: the
        bytes of an activation (bfloat16 2, float32 4), ``peak`` the rate of
        its products (float32's run as TF32)."""
        s, f = g, cfg.dim_feedforward
        rows = b * s
        w_elems = n_stack * (4 * d_model * d_model + 2 * d_model * f + 9 * d_model + f)
        common = rows * d_model * es + rows * 4 + w_elems * es + n_stack * b * d_model * es
        fwd_ops = n_stack * layer_ops_count(b, s, d_model, f)
        if not backward:
            return bound(common + rows * d_model * es, fwd_ops, peak)
        attn = n_stack * 4.0 * b * s * s * d_model
        return bound(common + 2 * rows * d_model * es + w_elems * 4 + n_stack * b * d_model * 4,
                     2 * (fwd_ops - attn) + 2 * attn, peak)

    stack_times = {}
    for stage in ("E2", "D2"):
        for b in (B_RECIPE, B_GATE_EDGE, B_TRAIN):
            fwd, both = stack_runs(stage, b, stack_vjp.fused_stack_train)
            cfwd, cboth = stack_runs(stage, b, chain_fn)
            f_ms, fb_ms, cf_ms, cfb_ms = cuda_ms(fwd), cuda_ms(both), cuda_ms(cfwd), cuda_ms(cboth)
            stack_times[f"{stage} B={b}"] = {
                "rows": b * g, "fwd_ms": f_ms, "bwd_ms": fb_ms - f_ms, "k4_chain_fwd_ms": cf_ms,
                "k4_chain_bwd_ms": cfb_ms - cf_ms}
    pfwd, pboth = stack_runs("E2", B_RECIPE, stack_vjp.plain_stack_train)
    pf_ms, pfb_ms = cuda_ms(pfwd, iters=5, warmup=1), cuda_ms(pboth, iters=5, warmup=1)
    lib_stack = library_stack(e2_layers, bf16)
    x_lib = stack_inputs["E2", B_RECIPE][0].detach().to(bf16).requires_grad_()
    g_lib = torch.randn_like(x_lib)
    pad_lib = ~t_vis[:B_RECIPE]

    def lib_stack_fwd():
        with torch.no_grad():
            return lib_stack(x_lib, src_key_padding_mask=pad_lib)

    def lib_stack_both():
        return torch.autograd.grad(lib_stack(x_lib, src_key_padding_mask=pad_lib),
                                   [x_lib, *lib_stack.parameters()], g_lib)
    lf_ms, lfb_ms = cuda_ms(lib_stack_fwd), cuda_ms(lib_stack_both)
    e2s = stack_times[f"E2 B={B_RECIPE}"]
    bf_ms, bf_by = k7_bound(B_RECIPE, False)
    bb_ms, bb_by = k7_bound(B_RECIPE, True)
    kernels["stack_fwd"].update(ms=e2s["fwd_ms"], plain_ms=pf_ms, library_ms=lf_ms,
                                bound_ms=bf_ms, bound_by=bf_by, stages=stack_times)
    kernels["stack_bwd"].update(ms=e2s["bwd_ms"], plain_ms=pfb_ms - pf_ms,
                                library_ms=lfb_ms - lf_ms, bound_ms=bb_ms, bound_by=bb_by)
    # K7's float32 form at E2, B=60, beside nn.TransformerEncoder in float32
    # with TF32 products (the library_ms) and in full float32
    stack_times_f32 = {}
    for stage in ("E2 float32", "D2 float32"):
        fwd, both = stack_runs(stage, B_RECIPE, stack_vjp.fused_stack_train)
        f_ms, fb_ms = cuda_ms(fwd), cuda_ms(both)
        stack_times_f32[f"{stage} B={B_RECIPE}"] = {"fwd_ms": f_ms, "bwd_ms": fb_ms - f_ms}
    pfwd32, pboth32 = stack_runs("E2 float32", B_RECIPE, stack_vjp.plain_stack_train)
    pf32, pfb32 = cuda_ms(pfwd32, iters=5, warmup=1), cuda_ms(pboth32, iters=5, warmup=1)
    lib32_stack = library_stack(stack_layers["E2 float32"], torch.float32)
    x_lib32 = stack_inputs["E2", B_RECIPE][0].detach().float().requires_grad_()
    g_lib32 = g_lib.float()
    lib32_ms = {}
    for lib_name, tf32 in (("tf32", True), ("float32", False)):
        torch.backends.cuda.matmul.allow_tf32 = tf32

        def lib32_fwd():
            with torch.no_grad():
                return lib32_stack(x_lib32, src_key_padding_mask=pad_lib)

        def lib32_both():
            return torch.autograd.grad(lib32_stack(x_lib32, src_key_padding_mask=pad_lib),
                                       [x_lib32, *lib32_stack.parameters()], g_lib32)
        lf32, lfb32 = cuda_ms(lib32_fwd), cuda_ms(lib32_both)
        lib32_ms[lib_name] = {"fwd_ms": lf32, "bwd_ms": lfb32 - lf32}
    torch.backends.cuda.matmul.allow_tf32 = False
    e2s32 = stack_times_f32[f"E2 float32 B={B_RECIPE}"]
    (bf32_ms, bf32_by), (bb32_ms, bb32_by) = (k7_bound(B_RECIPE, bwd, 4, PEAK_TF32)
                                              for bwd in (False, True))
    kernels["stack_fwd_f32"].update(ms=e2s32["fwd_ms"], plain_ms=pf32,
                                    library_ms=lib32_ms["tf32"]["fwd_ms"], bound_ms=bf32_ms,
                                    bound_by=bf32_by, stages=stack_times_f32,
                                    library_full_float32_ms=lib32_ms["float32"]["fwd_ms"])
    kernels["stack_bwd_f32"].update(ms=e2s32["bwd_ms"], plain_ms=pfb32 - pf32,
                                    library_ms=lib32_ms["tf32"]["bwd_ms"], bound_ms=bb32_ms,
                                    bound_by=bb32_by,
                                    library_full_float32_ms=lib32_ms["float32"]["bwd_ms"])
    del lib32_stack
    for what, st in stack_times_f32.items():
        print(f"  stack {what}: K7 forward {st['fwd_ms']:.4f} ms, backward {st['bwd_ms']:.4f} ms",
              flush=True)
    print(f"  stack_fwd_f32 E2 B={B_RECIPE}: {e2s32['fwd_ms']:.4f} ms (plain {pf32:.4f}, library "
          f"TF32 {lib32_ms['tf32']['fwd_ms']:.4f}, full float32 "
          f"{lib32_ms['float32']['fwd_ms']:.4f}, bound {bf32_ms:.4f} by {bf32_by}); "
          f"stack_bwd_f32 {e2s32['bwd_ms']:.4f} ms (plain {pfb32 - pf32:.4f}, library TF32 "
          f"{lib32_ms['tf32']['bwd_ms']:.4f}, full float32 {lib32_ms['float32']['bwd_ms']:.4f}, "
          f"bound {bb32_ms:.4f} by {bb32_by}) on {card}", flush=True)
    bounds64 = (k7_bound(B_GATE_EDGE, False)[0], k7_bound(B_GATE_EDGE, True)[0])
    for what, st in stack_times.items():
        print(f"  stack {what} ({st['rows']} rows): K7 forward {st['fwd_ms']:.4f} ms, backward "
              f"{st['bwd_ms']:.4f} ms; the chain of {n_stack} K4 calls {st['k4_chain_fwd_ms']:.4f} "
              f"and {st['k4_chain_bwd_ms']:.4f} ms")
    print(f"  stack_fwd E2 B={B_RECIPE}: {e2s['fwd_ms']:.4f} ms (plain {pf_ms:.4f}, library "
          f"{lf_ms:.4f}, bound {bf_ms:.4f} by {bf_by}); stack_bwd {e2s['bwd_ms']:.4f} ms (plain "
          f"{pfb_ms - pf_ms:.4f}, library {lfb_ms - lf_ms:.4f}, bound {bb_ms:.4f} by {bb_by}); "
          f"bounds at B={B_GATE_EDGE} {bounds64[0]:.4f} and {bounds64[1]:.4f} ms")
    for b in (B_RECIPE, B_TRAIN):
        k7_total = sum(stack_times[f"{st} B={b}"][k] for st in ("E2", "D2")
                       for k in ("fwd_ms", "bwd_ms"))
        chain_total = sum(stack_times[f"{st} B={b}"][k] for st in ("E2", "D2")
                          for k in ("k4_chain_fwd_ms", "k4_chain_bwd_ms"))
        print(f"  E2 + D2 forward and backward at {b * g} rows: K7 {k7_total:.4f} ms, the K4 "
              f"chain {chain_total:.4f} ms")
    record["stack_bounds_b64_ms"] = bounds64

    # =========================== the Hungarian self-matching model (B=60)
    from deepsvg_tpu_torch.models import hierarchical_self_matching, matching
    sm_cfg = gpu_fast(hierarchical_self_matching())
    sm_model = self_match_model(dataclasses.replace(sm_cfg, dropout=0.0), dev)
    c60, a60 = t_commands[:B_RECIPE], t_args[:B_RECIPE]
    fwd_k = matched_forward(sm_model, c60, a60)
    with plain_path(emb_ops, layer_ops, head_ops, layer_vjp, ce_ops, stack_vjp):
        fwd_p = matched_forward(sm_model, c60, a60)
        fwd_c = matched_forward(sm_model, c60, a60, perturb_states=MATCH_CONTROL_NOISE)

    # ---- K8 against its plain version on the inputs the path gave it, and
    # each variant's columns against K5's forward on that variant's targets
    y8, wa8, ba8, t8, g8, _ = fwd_k["k8_inputs"]
    with torch.no_grad():
        ce8_k = ce_ops.args_ce_pairwise(y8, wa8, ba8, t8, g8, bf16)
        ce8_p = ce_ops.plain_args_ce_pairwise(y8, wa8, ba8, t8, g8, bf16)
        r8, k8w = ce8_k.numel() // ce8_k.shape[-1], ce8_k.shape[-1]
        n_args8 = k8w // g8
        yf8, tf8, cf8 = y8.reshape(r8, -1), t8.reshape(r8, k8w), ce8_k.reshape(r8, k8w)
        k8_err = (ce8_k - ce8_p).abs().max().item()
        k5_equal = all(torch.equal(cf8[:, i * n_args8:(i + 1) * n_args8], ce_ops.args_ce(
            yf8, wa8, ba8, tf8[:, i * n_args8:(i + 1) * n_args8].contiguous(), bf16))
            for i in range(g8))
    check(tuple(ce8_k.shape) == tuple(t8.shape) and ce8_k.dtype == torch.float32
          and bool(torch.isfinite(ce8_k).all()), "K8: shape, dtype or non-finite values")
    check_later(k8_err <= TOL_PAIR, f"K8 max abs err {k8_err} > {TOL_PAIR}")
    check_later(k5_equal, "K8's columns of a variant differ from K5's forward on its targets")
    print(f"K8 args_ce_pairwise R={r8} G={g8} (B={B_RECIPE}): max abs err {k8_err:.3g} (limit "
          f"{TOL_PAIR}); each variant's columns equal to K5's forward on its targets, to the "
          f"bit: {k5_equal}", flush=True)
    kernels["args_ce_pairwise"] = {"max_abs_err": k8_err, "tolerance": TOL_PAIR,
                                   "equals_k5_per_variant": k5_equal}

    # ---- the kernel path's assignment against the plain path's, gated by
    # the visible-row margin, and the control that must fail the gate
    margin = matching.assignment_margin(fwd_p["cost"], fwd_p["vis"])
    gated = margin >= MATCH_MARGIN

    def agreement(other):
        same = (other["assignment"] == fwd_p["assignment"]).all(dim=-1)
        return same[gated].float().mean().item(), int((~same).sum())
    agree, differ_all = agreement(fwd_k)
    control, differ_control = agreement(fwd_c)
    vis_rows = fwd_p["vis"][..., None]
    cost_err = ((fwd_k["cost"] - fwd_p["cost"]).abs() * vis_rows).max().item()
    control_err = ((fwd_c["cost"] - fwd_p["cost"]).abs() * vis_rows).max().item()
    n_gated = int(gated.sum())
    finite = margin[torch.isfinite(margin)]
    print(f"self-match assignment at B={B_RECIPE}, kernel path vs plain path: equal on "
          f"{agree:.4f} of the {n_gated} samples whose visible-row margin >= {MATCH_MARGIN} "
          f"({B_RECIPE - n_gated} excluded; {differ_all} of {B_RECIPE} differ in all); costs' "
          f"largest difference over visible rows {cost_err:.3g}; margins min "
          f"{finite.min().item():.3g}, median {finite.median().item():.3g}; control (states "
          f"+ {MATCH_CONTROL_NOISE} RMS noise): equal on {control:.4f} ({differ_control} "
          f"differ; largest cost difference {control_err:.3g})", flush=True)
    check(n_gated >= B_RECIPE // 2, f"only {n_gated} of {B_RECIPE} samples clear the margin")
    check_later(agree == 1.0, f"the assignments differ on gated samples: {agree}")
    check(control < 1.0, f"the matching gate passed its control ({control}): it cannot see a "
                         f"fault of that size")
    loss_k = {k: float(v) for k, v in svg_loss(fwd_k["res"], SM_WEIGHTS, sm_cfg).items()}
    loss_p = {k: float(v) for k, v in svg_loss(fwd_p["res"], SM_WEIGHTS, sm_cfg).items()}
    record["selfmatch_matching"] = {
        "gated_samples": n_gated, "agreement": agree, "differ_all": differ_all,
        "cost_max_abs_diff": cost_err, "margins": margin.tolist(), "control": control,
        "control_cost_max_abs_diff": control_err, "losses_kernel": loss_k,
        "losses_plain": loss_p}
    print(f"  losses of that forward (kernel, plain): "
          f"{ {k: (loss_k[k], loss_p[k]) for k in loss_k} }", flush=True)
    cost60, vis60 = fwd_k["cost"], fwd_k["vis"]
    assign_ms = cuda_ms(lambda: matching.assign_bruteforce(cost60, vis60))
    del fwd_k, fwd_p, fwd_c

    # ---- the step at B=60, counted and timed
    def sm_state(dropout):
        m = self_match_model(dataclasses.replace(sm_cfg, dropout=dropout), dev)
        optimizer = make_optimizer(constant(LR))
        return create_train_state(m, optimizer, init=False), optimizer

    sm_launches = recipe_launches | {"args_ce_pairwise": 1}
    record["train_selfmatch"] = train_loop(B_RECIPE, sm_launches, sm_state, SM_WEIGHTS,
                                           " self-match")
    sm_step_launches = record["train_selfmatch"]["launches_per_step"]
    state_sm, optimizer_sm = sm_state(DROPOUT)
    busy_sm = device_busy_ms(lambda: train_step(state_sm, recipe_batch, SM_WEIGHTS, optimizer_sm,
                                                MODEL_ARGS))
    # the self-match step beside the ordered step, in turns step by step
    # (the host sets the pace, and it drifts within a call): host clock
    # around each step, which ends in a synchronize
    state_or, optimizer_or = new_state(DROPOUT)
    turns = {"ordered": [], "self_match": []}
    for i in range(2 + 2 * ITERS):
        ordered = i % 2 == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if ordered:
            train_step(state_or, recipe_batch, LOSS_WEIGHTS, optimizer_or, MODEL_ARGS)
        else:
            train_step(state_sm, recipe_batch, SM_WEIGHTS, optimizer_sm, MODEL_ARGS)
        torch.cuda.synchronize()
        if i >= 2:
            turns["ordered" if ordered else "self_match"].append((time.perf_counter() - t0) * 1e3)
    del state_sm, optimizer_sm, state_or, optimizer_or
    torch.cuda.empty_cache()
    record["train_selfmatch"].update(device_busy_ms_per_step=busy_sm, in_turns_ms=turns)
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"self-match step B={B_RECIPE}: {record['train_selfmatch']['median_ms_per_step']:.3f} "
          f"ms/step median (ordered step {record['train_recipe']['median_ms_per_step']:.3f}, "
          f"timed earlier); in turns with the ordered step, host clock to a synchronize: "
          f"{med['self_match']:.3f} ms (range {min(turns['self_match']):.3f}-"
          f"{max(turns['self_match']):.3f}) against {med['ordered']:.3f} ms "
          f"({min(turns['ordered']):.3f}-{max(turns['ordered']):.3f}), {ITERS} steps each; "
          f"device busy {busy_sm if busy_sm is None else round(busy_sm, 3)} ms per step "
          f"(ordered {busy60 if busy60 is None else round(busy60, 3)}); brute-force "
          f"assignment {assign_ms:.4f} ms on {card}", flush=True)

    # ---- the training CLI on the self-matching config
    record["cli_selfmatch"] = run_cli(dev, reset_counts, read_counts, sm_launches,
                                      "hierarchical_self_matching", timing=False)

    # ---- one-shot inference of the VAE model at N=1024, counted
    with torch.no_grad():
        reset_counts()
        sm_c, sm_a = one_shot_sample(sm_model, commands, args)
        torch.cuda.synchronize()
        sm_inference = read_counts()
        check(sm_inference == dict.fromkeys(sm_inference, 0) | {
            "embedding": 1, "layer": 12, "layer_f32": 4, "head": 1},
            f"self-match inference launches {sm_inference}")
        valid_share = check_sample(sm_c, sm_a, N_MAIN, sm_cfg)
        again = one_shot_sample(sm_model, commands[:8], args[:8])
        check(torch.equal(again[0], sm_c[:8]) and torch.equal(again[1], sm_a[:8]),
              "the VAE's sampling is not the same from call to call")
    print(f"self-match one_shot_sample N={N_MAIN}: launches {sm_inference}; output valid, "
          f"{valid_share:.4f} of the argument slots set; the same from call to call",
          flush=True)
    record["selfmatch_inference_launches"] = sm_inference

    # ---- K8 timed at the step's shapes, its plain version, and F.linear +
    # log_softmax + gather as the yardstick
    wa16_8, ba16_8 = wa8.detach().to(bf16), ba8.detach().to(bf16)
    t8l = tf8.reshape(r8, g8, n_args8).long()

    def lib_pair():
        with torch.no_grad():
            lp = F.log_softmax(F.linear(yf8, wa16_8, ba16_8).float().reshape(r8, 1, n_args8, -1),
                               dim=-1)
            return -lp.expand(r8, g8, n_args8, lp.shape[-1]).gather(-1, t8l[..., None])[..., 0]
    yardstick["args_ce_pairwise"] = (lib_pair().reshape(r8, k8w) - cf8).abs().max().item()
    n_cls8 = wa8.shape[0]
    b_ms, b_by = bound(nbytes(y8, t8) + n_cls8 * yf8.shape[1] * 2 + n_cls8 * 2 + r8 * k8w * 4,
                       2.0 * r8 * yf8.shape[1] * n_cls8, PEAK_BF16)
    kernels["args_ce_pairwise"].update(
        ms=cuda_ms(lambda: ce_ops.args_ce_pairwise(y8, wa8, ba8, t8, g8, bf16)),
        plain_ms=cuda_ms(lambda: ce_ops.plain_args_ce_pairwise(y8, wa8, ba8, t8, g8, bf16),
                         iters=5, warmup=1),
        library_ms=cuda_ms(lib_pair), bound_ms=b_ms, bound_by=b_by, assign_ms=assign_ms)
    k = kernels["args_ce_pairwise"]
    print(f"  args_ce_pairwise R={r8} G={g8}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
          f"library {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by {k['bound_by']}); "
          f"yardstick max abs diff {yardstick['args_ce_pairwise']:.3g}", flush=True)
    del sm_model
    torch.cuda.empty_cache()

    # ====================================================== the autoregressive phase
    ar_launches = autoregressive_phase(dev, card, kernels, record, yardstick, reset_counts,
                                       read_counts, library_layer)

    # ============================================ Sketchformer's training phase
    sf_launches = sketchformer_train_phase(dev, card, kernels, record, yardstick, reset_counts,
                                           read_counts)

    # ============================================ the float32 models
    f32_launches = float32_phase(dev, card, kernels, record, reset_counts, read_counts,
                                 library_layer)

    # ================================== the attention ops (K10, K11)
    attn_launches = attention_phase(dev, card, kernels, record, reset_counts, read_counts)

    # ================================== K4's recompute mode and its steps
    rc_launches = recompute_phase(dev, card, kernels, record, reset_counts, read_counts,
                                  library_layer)

    # ================ the one-stage one-shot and label-conditioned models
    variants_phase(dev, card, record, reset_counts, read_counts)

    # ======= the LSTM, two-stage autoregressive decoding, the decode-only model
    decoders_phase(dev, card, record, reset_counts, read_counts)

    # ======= SVGs in and out of the flagship, the geometry on the device
    # (its float32 products in full float32, as on the CPU it is held to)
    with matmul_tf32(False):
        geometry_phase(dev, card, record, reset_counts, read_counts)

    # ======= the real-data loaders, the preprocessing CLI and the apps
    with matmul_tf32(False):
        data_apps_phase(dev, card, record, reset_counts, read_counts)

    # ======= serving: torch.export artifacts through the inference kernels
    workers = serving_phase(dev, card, record, reset_counts, read_counts)

    # ======= data and tensor parallelism on torch.distributed (its gloo
    # workers started during the serving phase)
    parallel_phase(dev, card, record, reset_counts, read_counts, workers)

    # ======= head dims 8 and 16 on the first port's kernels, and the tiny
    # configs' paths (their float32 products in TF32, as the model's)
    hd_launches = head_dims_phase(dev, card, kernels, record, reset_counts, read_counts)

    # K5's forms and K8 beside their library calls and bounds
    forms = {n: kernels[n] for n in ("args_ce_fwd", "args_ce_bwd", "args_ce_fwd_512",
                                     "args_ce_bwd_512", "args_ce_fwd_f32", "args_ce_bwd_f32",
                                     "args_ce_pairwise", "args_ce_pairwise_f32")}
    for n in ("args_ce_fwd_f32", "args_ce_bwd_f32"):
        forms[n + "_at_512"] = kernels[n]["at_512_classes"]
    record["k5_forms"] = {}
    for name, k in forms.items():
        ratio = {"of_library": k["ms"] / k["library_ms"], "of_bound": k["ms"] / k["bound_ms"]}
        record["k5_forms"][name] = dict(ms=k["ms"], library_ms=k["library_ms"],
                                        bound_ms=k["bound_ms"], **ratio)
        print(f"{name}: {k['ms']:.4f} ms, {ratio['of_library']:.3f} x the library call's "
              f"{k['library_ms']:.4f}, {ratio['of_bound']:.2f} x its bound {k['bound_ms']:.5f} "
              f"(by {k['bound_by']}) on {card}", flush=True)

    # K2's forms beside their library calls and bounds
    record["k2_forms"] = {}
    for name in ("layer", "layer_long", "layer_f32", "layer_f32_e1", "layer_f32_d1",
                 "layer_long_f32"):
        k = kernels[name]
        ratio = {"of_library": k["ms"] / k["library_ms"], "of_bound": k["ms"] / k["bound_ms"]}
        record["k2_forms"][name] = dict(ms=k["ms"], library_ms=k["library_ms"],
                                        bound_ms=k["bound_ms"], **ratio)
        print(f"{name}: {k['ms']:.4f} ms, {ratio['of_library']:.3f} x the library call's "
              f"{k['library_ms']:.4f}, {ratio['of_bound']:.2f} x its bound {k['bound_ms']:.5f} "
              f"(by {k['bound_by']}) on {card}", flush=True)

    csrc = "deepsvg_tpu_torch/ops/csrc/"
    source = {
        "embedding": (csrc + "embedding.cu", "deepsvg_tpu/ops/embedding.py:34"),
        "layer": (csrc + "layer_infer.cuh", "deepsvg_tpu/ops/layer.py:108"),
        "layer_f32": (csrc + "layer_f32.cu", "deepsvg_tpu/ops/layer.py:108"),
        "layer_f32_e1": (csrc + "layer_f32.cu", "deepsvg_tpu/ops/layer.py:108"),
        "layer_f32_d1": (csrc + "layer_f32.cu", "deepsvg_tpu/ops/layer.py:108"),
        "head": (csrc + "head.cu", "deepsvg_tpu/ops/head.py:32"),
        "layer_train_fwd": (csrc + "layer_train.cuh", "deepsvg_tpu/ops/layer_vjp.py:179"),
        "layer_train_bwd": (csrc + "layer_train.cuh", "deepsvg_tpu/ops/layer_vjp.py:281"),
        "args_ce_fwd": (csrc + "ce.cu", "deepsvg_tpu/ops/ce.py:30"),
        "args_ce_bwd": (csrc + "ce.cu", "deepsvg_tpu/ops/ce.py:81"),
        "embedding_bwd": (csrc + "embedding_bwd.cu", "deepsvg_tpu/ops/embedding.py:133"),
        "stack_fwd": (csrc + "stack_cluster.cu", "deepsvg_tpu/ops/stack_vjp.py:87"),
        "stack_bwd": (csrc + "stack_cluster.cu", "deepsvg_tpu/ops/stack_vjp.py:159"),
        "stack_fwd_f32": (csrc + "stack_cluster.cu", "deepsvg_tpu/ops/stack_vjp.py:87"),
        "stack_bwd_f32": (csrc + "stack_cluster.cu", "deepsvg_tpu/ops/stack_vjp.py:159"),
        "args_ce_pairwise": (csrc + "ce.cu", "deepsvg_tpu/ops/ce.py:54"),
        "layer_long": (csrc + "layer_infer.cuh", "deepsvg_tpu/ops/layer.py:108"),
        "layer_long_f32": (csrc + "layer_f32.cu", "deepsvg_tpu/ops/layer.py:108"),
        "decode": (csrc + "decode_cluster.cu", "deepsvg_tpu/ops/decode.py:43"),
        "layer_train_long_fwd": (csrc + "layer_long.cu", "deepsvg_tpu/ops/layer_vjp.py:179"),
        "layer_train_long_bwd": (csrc + "layer_bwd.cu", "deepsvg_tpu/ops/layer_vjp.py:281"),
        "layer_train_long_fwd_f32": (csrc + "layer_f32.cu", "deepsvg_tpu/ops/layer_vjp.py:179"),
        "layer_train_long_bwd_f32": (csrc + "layer_f32_bwd.cu",
                                     "deepsvg_tpu/ops/layer_vjp.py:281"),
        "args_ce_fwd_512": (csrc + "ce.cu", "deepsvg_tpu/ops/ce.py:30"),
        "args_ce_bwd_512": (csrc + "ce.cu", "deepsvg_tpu/ops/ce.py:81"),
        "embedding_bwd_long": (csrc + "embedding_bwd.cu", "deepsvg_tpu/ops/embedding.py:133"),
        "embedding_bwd_f32": (csrc + "embedding_bwd.cu", "deepsvg_tpu/ops/embedding.py:133"),
        "embedding_f32": (csrc + "embedding.cu", "deepsvg_tpu/ops/embedding.py:34"),
        "head_f32": (csrc + "head.cu", "deepsvg_tpu/ops/head.py:32"),
        "args_ce_fwd_f32": (csrc + "ce.cu", "deepsvg_tpu/ops/ce.py:30"),
        "args_ce_bwd_f32": (csrc + "ce.cu", "deepsvg_tpu/ops/ce.py:81"),
        "args_ce_pairwise_f32": (csrc + "ce.cu", "deepsvg_tpu/ops/ce.py:54"),
        "decode_f32": (csrc + "decode_cluster.cu", "deepsvg_tpu/ops/decode.py:43"),
        "layer_train_fwd_f32": (csrc + "layer_f32.cu", "deepsvg_tpu/ops/layer_vjp.py:179"),
        "layer_train_bwd_f32": (csrc + "layer_f32_bwd.cu", "deepsvg_tpu/ops/layer_vjp.py:281"),
        "mha": (csrc + "layer_long.cu", "deepsvg_tpu/ops/attention.py:31"),
        "mha_f32": (csrc + "layer_f32.cu", "deepsvg_tpu/ops/attention.py:31"),
        "mha_train_fwd": (csrc + "layer_long.cu", "deepsvg_tpu/ops/attention_vjp.py:60"),
        "mha_train_fwd_f32": (csrc + "layer_f32.cu", "deepsvg_tpu/ops/attention_vjp.py:60"),
        "mha_train_bwd": (csrc + "layer_bwd.cu", "deepsvg_tpu/ops/attention_vjp.py:100"),
        "mha_train_bwd_f32": (csrc + "layer_f32_bwd.cu", "deepsvg_tpu/ops/attention_vjp.py:100"),
        "layer_train_recompute_fwd": (csrc + "layer_train.cuh",
                                      "deepsvg_tpu/ops/layer_vjp.py:179"),
        "layer_train_recompute_bwd": (csrc + "layer_bwd.cu", "deepsvg_tpu/ops/layer_vjp.py:298"),
        "layer_train_long_recompute_fwd": (csrc + "layer_long.cu",
                                           "deepsvg_tpu/ops/layer_vjp.py:179"),
        "layer_train_long_recompute_bwd": (csrc + "layer_long_train.cu",
                                           "deepsvg_tpu/ops/layer_vjp.py:298"),
    }
    source.update(hd_sources())
    # the entries of a kernel at another path's shapes count that path's launches
    counter = {"args_ce_fwd_512": "args_ce_fwd", "args_ce_bwd_512": "args_ce_bwd",
               "embedding_bwd_long": "embedding_bwd"}
    line = []
    for name, k in kernels.items():
        src_file, replaces = source[name]
        # the count of the path that runs the kernel: inference, the step at
        # B=128, (K7) the first CLI run at B=60, (K8) the self-match step,
        # (long K2, K9) Sketchformer's greedy_sample, or (long K4, and K5 and
        # K6 at Sketchformer's shapes) Sketchformer's training step
        if name in hd_launches:
            # (head dims 8 and 16) the tiny configs' path that runs it, or its own call
            count = hd_launches[name]
        elif name in counter:
            count = sf_launches[counter[name]]
        elif name in rc_launches:
            # (K4's recompute mode) the step at B=128 (short form) or
            # Sketchformer's (long form), switched to it
            count = rc_launches[name]
        elif name in f32_launches or name in attn_launches:
            # (float32 forms) the float32 path that runs it; (K10, K11) one call of the op
            count = f32_launches.get(name) or attn_launches[name]
        else:
            count = (launches[name] or train_launches[name] or cli_launches[name]
                     or sm_step_launches[name] or ar_launches[name] or sf_launches[name])
        line.append({
            "name": name, "route": "cuda", "source": src_file, "replaces": replaces,
            "launches": count, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t_start
    print(f"chip_smoke: {record['total_s']:.1f} s after the card line", flush=True)
    record["failed_checks"] = FAILED
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    check(not FAILED, f"{len(FAILED)} tolerance checks failed: {FAILED}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
