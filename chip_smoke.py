"""Run the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

In order: print the card and its power limit; build the port's CUDA kernels
from ``deepsvg_tpu_torch/ops/csrc``; load the trained flagship checkpoint;
then five paths in bfloat16, the float32 models, the attention ops and K4's
recompute mode. Every earlier phase runs K4 in its saved mode, the model's
default (``layer_vjp.SAVE_RESIDUALS_DEFAULT``).

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
the model's width with the trained E1 layer 0 weights, against their plain
versions (K11 elementwise with dropout on, bit-equal from run to run) and
timed beside ``F.linear`` -> ``F.scaled_dot_product_attention`` ->
``F.linear``.

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
                      save_residuals=True):
    """K4 forward and its twelve gradients against autograd through the plain
    version with the same hash masks, as it is and with the kernel's ReLU
    units, in the mode ``save_residuals``. The recompute mode's output must
    equal the saved mode's to the bit (the kernel's ReLU units are read from
    that saved-mode forward), only its own counters may move, and its
    gradients must be the same on a second run. Returns the readings."""
    masters = layer.masters()
    x = x.detach().requires_grad_()
    bias = None if seq_bias is None else seq_bias.detach().requires_grad_()
    g = torch.randn(x.shape, device=x.device).to(x.dtype)
    leaves = [t for t in (x, bias, *masters) if t is not None]
    names = [n for n, t in zip(GRAD_NAMES, (x, bias, *masters)) if t is not None]
    call = (x, bias, *masters, mask, seed, layer.n_heads, causal, rate, layer.compute_dtype)
    forms = (layer_vjp.fused_layer_train, layer_vjp.fused_layer_train_long)
    counters = ("launches", "backward_launches", "recompute_launches",
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
    readings = {n: compare_grad(f"K4 {what} d{n}", a, w, wg, x.dtype)
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
                      outliers_aligned=False, control_bits=None):
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
    verdicts are returned (``failed``) instead of reported. Returns the
    readings: each draw's, and the worst over the draws."""
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
        tail = (mask, seed + k, n_heads, False, rate, dt)
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
                    stack_layer_seed(seed + k, layer), n_heads, False, rate, dt).float()
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
                stack_layer_seed(seed + k, layer), n_heads, False, rate, dt,
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


def check_sample(out_c, out_a, n: int, cfg) -> float:
    """Validate ``one_shot_sample``'s output for ``n`` inputs: shapes, ids
    and values in range, PAD where a command takes no argument. Returns the
    share of valid argument slots (not PAD)."""
    from deepsvg_tpu_torch.svgtensor.constants import CMD_ARGS_MASK
    s_dec = cfg.max_seq_len + 1
    check(tuple(out_c.shape) == (n, cfg.max_num_groups, s_dec)
          and tuple(out_a.shape) == (n, cfg.max_num_groups, s_dec, cfg.n_args),
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
    its five gradients), K11 bit-equal from run to run, each op counted once,
    and timed beside its bound, its plain version and F.linear ->
    F.scaled_dot_product_attention -> F.linear (under autograd with
    ``dropout_p`` for K11). Returns the launches per call of each op."""
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

    def mha_ops(b, s, causal):
        """(operations, bytes) of one forward: the two projections and the
        scores and P V over the keys each query sees."""
        keys = s * (s + 1) / 2 if causal else s * s
        return 2.0 * b * s * d * 4 * d + 4.0 * b * keys * d, nbytes(*w) + b * s * 4

    def lib_mha(x, mask, causal, rate=0.0, ws=w):
        b, s, _ = x.shape
        qkv = F.linear(x, ws[0], ws[1]).reshape(b, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        am = mask[:, None, None, :]
        if causal:
            am = am + torch.full((s, s), float("-inf"), device=dev).triu(1)
        ctx = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=am.to(x.dtype),
                                             dropout_p=rate)
        return F.linear(ctx.transpose(1, 2).reshape(b, s, d), ws[2], ws[3])

    # ---- K10
    k10_cases = {"flagship E1 N=1024": (x_of(f_cmd.shape[0], f_cmd.shape[1]), mask_of(f_cmd),
                                        False),
                 "Sketchformer encoder N=1024": (x_of(N_MAIN, s_cmd.shape[1]), mask_of(s_cmd),
                                                 False)}
    k10 = {}
    with torch.no_grad():
        for i, (what, (x, mask, causal)) in enumerate(k10_cases.items()):
            if i == 0:
                reset_counts()
                got = attn_ops.fused_mha(x, *w, mask, heads, causal)
                torch.cuda.synchronize()
                counts = read_counts()
                check(counts == dict.fromkeys(counts, 0) | {"mha": 1}, f"K10 launches {counts}")
            else:
                got = attn_ops.fused_mha(x, *w, mask, heads, causal)
            want = attn_ops.mha_reference(x, *w, mask, heads, causal)
            b, s, _ = x.shape
            ops, w_bytes = mha_ops(b, s, causal)
            b_ms, b_by = bound(2 * nbytes(x) + w_bytes, ops, PEAK_BF16)
            k10[what] = dict(
                compare_elementwise(f"K10 mha {what} ({b} x {s})", got, want, TOL_LAYER_RMS),
                B=b, S=s, ms=cuda_ms(lambda: attn_ops.fused_mha(x, *w, mask, heads, causal)),
                plain_ms=cuda_ms(lambda: attn_ops.mha_reference(x, *w, mask, heads, causal),
                                 iters=3, warmup=1),
                library_ms=cuda_ms(lambda: lib_mha(x, mask, causal)), bound_ms=b_ms,
                bound_by=b_by)
            del got, want
    main_case = k10["flagship E1 N=1024"]
    kernels["mha"] = dict(main_case, cases=k10,
                          max_abs_err=max(c["max_abs_err"] for c in k10.values()),
                          tolerance={"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL,
                                     "rms": TOL_LAYER_RMS})
    del k10_cases
    torch.cuda.empty_cache()

    # ---- K11
    k11_cases = {"flagship step E1 B=128": (x_of(128 * cfg.max_num_groups, f_cmd.shape[1]),
                                            mask_of(f_cmd[:128 * cfg.max_num_groups]), False),
                 "Sketchformer encoder B=60": (x_of(B_RECIPE, s_cmd.shape[1]),
                                               mask_of(s_cmd[:B_RECIPE]), False),
                 "Sketchformer decoder B=60 causal": (x_of(B_RECIPE, s_cmd.shape[1] - 1),
                                                      mask_of(s_cmd[:B_RECIPE, :-1]), True)}
    leaves = [t.clone().requires_grad_() for t in w]
    seed = 2024
    k11 = {}
    counts = None
    for what, (x, mask, causal) in k11_cases.items():
        x = x.requires_grad_()
        g = torch.randn(x.shape, device=dev, generator=gen).to(bf16)
        b, s, _ = x.shape
        for rate in (0.0, DROPOUT):
            call = (x, *leaves, mask, seed, heads, causal, rate)
            if counts is None:
                reset_counts()
            got = attention_vjp.fused_mha_train(*call)
            grads = torch.autograd.grad(got, [x, *leaves], g)
            if counts is None:
                torch.cuda.synchronize()
                counts = read_counts()
                check(counts == dict.fromkeys(counts, 0) | {"mha_train_fwd": 1,
                                                            "mha_train_bwd": 1},
                      f"K11 launches {counts}")
            want = attn_ops.mha_reference(x, *leaves, mask, heads, causal, rate, seed)
            grads_p = torch.autograd.grad(want, [x, *leaves], g)
            case = compare_elementwise(f"K11 mha_train {what} ({b} x {s}) rate {rate}", got,
                                       want, TOL_LAYER_RMS)
            case["grad_rms"] = {n: rel_rms(a, c) for n, a, c in
                                zip(("x", "wqkv", "bqkv", "wo", "bo"), grads, grads_p)}
            again = attention_vjp.fused_mha_train(*call)
            case["bit_equal_rerun"] = bool(torch.equal(again, got) and all(
                torch.equal(a, c) for a, c in zip(grads, torch.autograd.grad(again, [x, *leaves],
                                                                             g))))
            worst = max(case["grad_rms"].values())
            print(f"  gradients: relative RMS {case['grad_rms']} (limit "
                  f"{MHA_GRAD_RMS}); rerun bit-equal {case['bit_equal_rerun']}", flush=True)
            check_later(worst <= MHA_GRAD_RMS, f"K11 {what} rate {rate}: gradient RMS {worst}")
            check_later(case["bit_equal_rerun"], f"K11 {what} rate {rate}: rerun differs")
            k11[f"{what} rate {rate}"] = case
            del got, grads, want, grads_p, again
        # times at dropout 0.1: forward alone, forward and backward
        ops, w_bytes = mha_ops(b, s, causal)
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
                                       warmup=1),
                 "lib_fwd": cuda_ms(lambda: fwd(lib_mha, x, mask, causal, DROPOUT, leaves)),
                 "lib_both": cuda_ms(lambda: both(lib_mha, x, mask, causal, DROPOUT, leaves))}
        fb = bound(2 * nbytes(x) + w_bytes, ops, PEAK_BF16)
        bb = bound(3 * nbytes(x) + 2 * w_bytes, 22.0 * b * s * d * d + 12.0 * b * keys * d,
                   PEAK_BF16)
        k11[what] = {"B": b, "S": s, "times_ms": times, "fwd_bound": fb, "bwd_bound": bb}
        print(f"K11 {what} ({b} x {s}) rate {DROPOUT}: forward {times['fwd']:.4f} ms (plain "
              f"{times['plain_fwd']:.4f}, library {times['lib_fwd']:.4f}, bound {fb[0]:.4f} by "
              f"{fb[1]}); backward {times['both'] - times['fwd']:.4f} ms (plain "
              f"{times['plain_both'] - times['plain_fwd']:.4f}, library "
              f"{times['lib_both'] - times['lib_fwd']:.4f}, bound {bb[0]:.4f} by {bb[1]})",
              flush=True)
    row = k11["Sketchformer encoder B=60"]
    t = row["times_ms"]
    errs = [c["max_abs_err"] for k, c in k11.items() if "rate" in k]
    kernels["mha_train_fwd"] = {
        "max_abs_err": max(errs), "ms": t["fwd"], "plain_ms": t["plain_fwd"],
        "library_ms": t["lib_fwd"], "bound_ms": row["fwd_bound"][0],
        "bound_by": row["fwd_bound"][1], "cases": k11,
        "tolerance": {"atol": TOL_LAYER_ATOL, "rtol": TOL_LAYER_RTOL, "rms": TOL_LAYER_RMS}}
    kernels["mha_train_bwd"] = {
        "max_abs_err": max(max(c["grad_rms"].values()) for k, c in k11.items() if "rate" in k),
        "ms": t["both"] - t["fwd"], "plain_ms": t["plain_both"] - t["plain_fwd"],
        "library_ms": t["lib_both"] - t["lib_fwd"], "bound_ms": row["bwd_bound"][0],
        "bound_by": row["bwd_bound"][1], "tolerance": {"grad_rms": MHA_GRAD_RMS}}
    for name in ("mha", "mha_train_fwd", "mha_train_bwd"):
        k = kernels[name]
        print(f"  {name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library "
              f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by {k['bound_by']})")
    del k11_cases, leaves
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"attention ops phase: {out['phase_s']:.1f} s on {card}", flush=True)
    record["attention_ops"] = out
    return {"mha": 1, "mha_train_fwd": counts["mha_train_fwd"],
            "mha_train_bwd": counts["mha_train_bwd"]}


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
    from deepsvg_tpu_torch.ops import attention as attn_ops
    from deepsvg_tpu_torch.ops import attention_vjp
    from deepsvg_tpu_torch.ops import ce as ce_ops
    from deepsvg_tpu_torch.ops import decode as decode_ops
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

    def reset_counts():
        layer_ops.fused_layer_long.launches = layer_ops.fused_layer_long.float32_launches = 0
        decode_ops.fused_decode_step.launches = 0
        emb_ops.fused_embedding.launches = emb_ops.fused_embedding.narrow_launches = 0
        emb_ops.embedding_backward.launches = 0
        layer_ops.fused_layer.launches = layer_ops.fused_layer.float32_launches = 0
        layer_ops.fused_layer.narrow_launches = layer_ops.fused_layer_long.narrow_launches = 0
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
        attn_ops.fused_mha.launches = 0
        attention_vjp.fused_mha_train.launches = 0
        attention_vjp.fused_mha_train.backward_launches = 0

    def read_counts() -> dict:
        """Launches by kernel; a float32 form under its own name (``_f32``)."""
        def split(fn, name, total="launches", f32="float32_launches"):
            return {name: getattr(fn, total) - getattr(fn, f32), f"{name}_f32": getattr(fn, f32)}
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
                # take; none on any path here: every count expected 0)
                "decode_narrow": decode_ops.fused_decode_step.narrow_launches,
                **split(layer_vjp.fused_layer_train_long, "layer_train_long_fwd"),
                **split(layer_vjp.fused_layer_train_long, "layer_train_long_bwd",
                        "backward_launches", "float32_backward_launches"),
                "mha": attn_ops.fused_mha.launches,
                "mha_train_fwd": attention_vjp.fused_mha_train.launches,
                "mha_train_bwd": attention_vjp.fused_mha_train.backward_launches,
                "layer_train_recompute_fwd": layer_vjp.fused_layer_train.recompute_launches,
                "layer_train_recompute_bwd":
                    layer_vjp.fused_layer_train.recompute_backward_launches,
                "layer_train_long_recompute_fwd":
                    layer_vjp.fused_layer_train_long.recompute_launches,
                "layer_train_long_recompute_bwd":
                    layer_vjp.fused_layer_train_long.recompute_backward_launches,
                # K4's bfloat16 short form at widths below its wgmma kernels'
                # (none on any path here: every count expected 0)
                "layer_train_narrow_fwd": layer_vjp.fused_layer_train.narrow_launches,
                "layer_train_narrow_bwd": layer_vjp.fused_layer_train.narrow_backward_launches,
                # K4's float32 long form at widths below its Hopper kernels' (none here)
                "layer_train_long_narrow_fwd": layer_vjp.fused_layer_train_long.narrow_launches,
                "layer_train_long_narrow_bwd":
                    layer_vjp.fused_layer_train_long.narrow_backward_launches,
                # K7 at widths its cluster kernels do not take (none here)
                "stack_narrow_fwd": stack_vjp.fused_stack_train.narrow_launches,
                "stack_narrow_bwd": stack_vjp.fused_stack_train.narrow_backward_launches,
                # K2's float32 form at widths below its wgmma kernels' (none here)
                "layer_narrow_f32": (layer_ops.fused_layer.narrow_launches
                                     + layer_ops.fused_layer_long.narrow_launches)}

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
        "mha": (csrc + "attention.cu", "deepsvg_tpu/ops/attention.py:31"),
        "mha_train_fwd": (csrc + "attention.cu", "deepsvg_tpu/ops/attention_vjp.py:60"),
        "mha_train_bwd": (csrc + "attention.cu", "deepsvg_tpu/ops/attention_vjp.py:100"),
        "layer_train_recompute_fwd": (csrc + "layer_train.cuh",
                                      "deepsvg_tpu/ops/layer_vjp.py:179"),
        "layer_train_recompute_bwd": (csrc + "layer_bwd.cu", "deepsvg_tpu/ops/layer_vjp.py:298"),
        "layer_train_long_recompute_fwd": (csrc + "layer_long.cu",
                                           "deepsvg_tpu/ops/layer_vjp.py:179"),
        "layer_train_long_recompute_bwd": (csrc + "layer_long_train.cu",
                                           "deepsvg_tpu/ops/layer_vjp.py:298"),
    }
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
        if name in counter:
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
    sys.exit(main())
