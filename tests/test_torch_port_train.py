"""The port's training step against the JAX package's, on the CPU, on the
trained checkpoint in the repo at N=2.

Dropout is 0 on both sides (JAX's masks are not part of the contract), the
batch comes from the port's generator with a numpy seed, and the port's
kernels run as their plain versions (CPU tensors). Held against JAX's
``train_step`` on the XLA path and, once, on the Pallas path (the training
kernels in interpret mode): the three loss terms, the gradient of every one of
the 210 leaves, the global norm, and the parameters after 1 and 3 steps of
clip + AdamW at a constant learning rate. The gradients come out of JAX's own
step through an optax transformation that remembers what it was given, so
each reference costs one compilation. Then ``eval_step``, and one
bfloat16 step with statistical limits.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models.loss import svg_loss as jax_svg_loss
from deepsvg_tpu.training import schedulers as jax_schedulers
from deepsvg_tpu.training import trainer as jax_trainer
from deepsvg_tpu_torch.data import decompress_batch, generate_batch
from deepsvg_tpu_torch.models import (
    gpu_fast, hierarchical_ordered, load_model, to_flax_params)
from deepsvg_tpu_torch.training import (
    constant, create_train_state, eval_step, make_optimizer, train_step)

ARTIFACT = "docs/artifacts/full_run_final_params.msgpack"
N = 2
LR = 1e-3
MODEL_ARGS = ["commands", "args", "commands", "args"]
WEIGHTS = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_visibility_weight=1.0,
               loss_cmd_weight=1.0, loss_args_weight=2.0)
LOSS_TOL = 1e-5          # each loss term, absolute and relative
OUTLIERS = 1e-5          # from the third step on, this share of the signal entries may
                         # exceed PARAM_TOL: a step of lr = 1e-3 on every entry moves
                         # the trained model far enough that a ReLU unit or an Adam
                         # ratio at a tipping point lands on the other side in one
                         # package (read: 19 of 4,740,581 entries after step 3)
GRAD_TOL = 1e-3          # each leaf's gradient, relative to the leaf's largest entry
PARAM_TOL = 2e-5         # parameters after a step, where the gradient is signal
NOISE = 1e-3             # Adam normalises each entry: a gradient entry that is all
                         # rounding noise (the key bias, whose true gradient is zero)
                         # becomes a step of up to lr in either package. Entries whose
                         # reference gradient was below NOISE of their leaf's largest at
                         # any step so far are held only to that bound, 2 * lr a step;
                         # the others to PARAM_TOL a step


@pytest.fixture(scope="module")
def batch():
    b = generate_batch(np.random.default_rng(0), N)
    return b["commands"], b["args"]


@pytest.fixture(scope="module")
def params():
    with open(ARTIFACT, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _jax_cfg(impl, dtype="float32"):
    return JaxModelConfig(encode_stages=2, decode_stages=2, use_vae=False,
                          label_condition=False, attention_impl=impl, dropout=0.0,
                          compute_dtype=dtype)


def _remember_gradients():
    """An optax transformation that changes nothing and keeps the gradients it
    was given as its state. Chained before the optimizer, it brings the
    gradients of the JAX package's own ``train_step`` out with the new state,
    so one compiled step gives the losses, the gradients and the parameters."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


def _jax_run(impl, params, batch, steps, dtype="float32"):
    """Loss terms and gradients at the checkpoint, and the parameters after
    each of ``steps`` steps, from the JAX package's own train_step."""
    model = JaxSVGTransformer(_jax_cfg(impl, dtype))
    data = {"commands": jnp.asarray(batch[0]), "args": jnp.asarray(batch[1])}
    optimizer = optax.chain(_remember_gradients(),
                            jax_trainer.make_optimizer(jax_schedulers.constant(LR)))
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=optimizer.init(params),
                                   rng=jax.random.PRNGKey(0))
    step = jax_trainer.jit_train_step(model, optimizer, MODEL_ARGS, donate=False)
    to_np = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    first, after, signal = None, [], None
    for _ in range(steps):
        state, res = step(state, data, WEIGHTS)
        grads = state.opt_state[0]
        first = first or (to_np(res), to_np(grads))
        # the entries whose gradient has been signal, not rounding noise, at
        # every step so far
        now = {k: np.abs(g) >= NOISE * np.abs(g).max() for k, g in _leaves(grads).items()}
        signal = now if signal is None else {k: signal[k] & now[k] for k in now}
        after.append((jax.tree_util.tree_map(np.asarray, state.params), signal))
    return *first, after


def _port_state(cfg):
    model = load_model(ARTIFACT, dataclasses.replace(cfg, dropout=0.0), device="cpu")
    optimizer = make_optimizer(constant(LR))
    return create_train_state(model, optimizer, init=False), optimizer


def _port_batch(batch):
    return {"commands": torch.from_numpy(batch[0]), "args": torch.from_numpy(batch[1])}


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _worst(ours, theirs, relative_to_leaf_max=True, where=None):
    """(largest error over all leaves, the leaf it is in); each leaf's error
    relative to its largest reference entry. ``where``: a tree of bool arrays,
    the entries to look at."""
    ours, theirs = _leaves(ours), _leaves(theirs)
    assert set(ours) == set(theirs) and len(ours) == 210
    worst = (0.0, None)
    for k, ref in theirs.items():
        assert ours[k].shape == ref.shape, k
        scale = max(float(np.abs(ref).max()), 1e-12) if relative_to_leaf_max else 1.0
        err = np.abs(ours[k] - ref)
        if where is not None:
            err = err[where[k]]
        worst = max(worst, (float(err.max(initial=0.0)) / scale, k))
    return worst


@pytest.mark.parametrize("impl,steps", [("xla", 3), ("pallas", 1)])
def test_train_step_matches_jax(batch, params, impl, steps):
    ref_res, ref_grads, ref_after = _jax_run(impl, params, batch, steps)
    state, optimizer = _port_state(hierarchical_ordered())
    for i in range(steps):
        state, res = train_step(state, _port_batch(batch), WEIGHTS, optimizer, MODEL_ARGS)
        if i == 0:
            for k in ("loss", "loss_cmd", "loss_args", "loss_visibility"):
                np.testing.assert_allclose(float(res[k]), float(ref_res[k]), rtol=LOSS_TOL,
                                           atol=LOSS_TOL, err_msg=k)
            grads = to_flax_params(state.model, grads=True)
            err, leaf = _worst(grads, ref_grads)
            print(f"{impl}: worst gradient leaf {leaf}: {err:.3g} of its largest entry")
            assert err <= GRAD_TOL, (leaf, err)
            ref_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                   for g in _leaves(ref_grads).values()))
            np.testing.assert_allclose(float(res["grad_norm"]), ref_norm, rtol=1e-4)
        ref_params, signal = ref_after[i]
        share = sum(int(m.sum()) for m in signal.values()) / sum(m.size for m in signal.values())
        ours = to_flax_params(state.model)
        err, leaf = _worst(ours, ref_params, False, signal)
        err_any, leaf_any = _worst(ours, ref_params, False)
        ours_l, ref_l = _leaves(ours), _leaves(ref_params)
        over = sum(int((np.abs(ours_l[k] - ref_l[k])[signal[k]] > PARAM_TOL * (i + 1)).sum())
                   for k in ref_l)
        count = sum(int(m.sum()) for m in signal.values())
        print(f"{impl}: parameters after step {i + 1}: worst leaf {leaf}, max abs err "
              f"{err:.3g} over the {share:.4f} of entries with a gradient above noise; "
              f"anywhere {err_any:.3g} ({leaf_any}); {over} of {count} over the limit")
        assert over <= (0 if i < 2 else OUTLIERS * count), (leaf, err, over)
        assert err_any <= 2.02 * LR * (i + 1), (leaf_any, err_any)
    assert state.step == steps and state.opt_state["count"] == steps


def test_eval_step_matches_jax(batch, params):
    model = JaxSVGTransformer(_jax_cfg("xla"))
    data = {"commands": jnp.asarray(batch[0]), "args": jnp.asarray(batch[1])}
    state = jax_trainer.TrainState(step=0, params=params, opt_state=None,
                                   rng=jax.random.PRNGKey(0))
    ref = jax.jit(partial(jax_trainer.eval_step, model=model, model_args=MODEL_ARGS))(
        state, data, WEIGHTS)
    ours_state, _ = _port_state(hierarchical_ordered())
    for fused in (True, False):
        res = eval_step(ours_state, _port_batch(batch), WEIGHTS, MODEL_ARGS, fused_ce=fused)
        for k in ref:
            np.testing.assert_allclose(float(res[k]), float(ref[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    assert not any(p.grad is not None for p in ours_state.model.parameters())


def test_train_step_takes_the_wire_format_and_moves_every_leaf(batch):
    """uint8 arguments and int8 commands on the wire decode to the canonical
    batch exactly and give the same step; one step changes all 210 leaves
    (weight decay alone would) and leaves them float32. The parameters are
    held to 1e-6, not to the bit: the CPU's scatter-add of the embedding
    tables' gradient sums in an order that changes from run to run."""
    state_a, opt_a = _port_state(hierarchical_ordered())
    state_b, opt_b = _port_state(hierarchical_ordered())
    wire = {"commands": torch.from_numpy(batch[0].astype(np.int8)),
            "args": torch.from_numpy(np.maximum(batch[1], 0).astype(np.uint8))}
    decoded, canonical = decompress_batch(wire), _port_batch(batch)
    for k, v in canonical.items():
        assert decoded[k].dtype == v.dtype and torch.equal(decoded[k], v), k
    before = [p.detach().clone() for p in state_a.parameters()]
    _, res_a = train_step(state_a, canonical, WEIGHTS, opt_a, MODEL_ARGS)
    _, res_b = train_step(state_b, wire, WEIGHTS, opt_b, MODEL_ARGS)
    assert float(res_a["loss"]) == float(res_b["loss"])
    for p, q, old in zip(state_a.parameters(), state_b.parameters(), before):
        assert p.dtype == torch.float32 and not torch.equal(p, old)
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6)


def test_bfloat16_train_step_is_close_to_jax_bfloat16(batch, params):
    """One step in the card's profile (bfloat16 compute, float32 masters)
    against JAX's bfloat16 step (its XLA path: the Pallas path in interpret
    mode takes twice as long to compile and reads the same, cosine 0.9992).
    The packages round at different points, so the limits are statistical,
    about twice the readings: each loss term within 1% (read 0.2%), the
    global gradient norm within 2% (read 0.5%), and the cosine between the
    two whole gradients at least 0.998 (read 0.9995)."""
    ref_res, ref_grads, _ = _jax_run("xla", params, batch, 1, "bfloat16")
    state, optimizer = _port_state(gpu_fast(hierarchical_ordered()))
    state, res = train_step(state, _port_batch(batch), WEIGHTS, optimizer, MODEL_ARGS)
    assert all(p.dtype == torch.float32 for p in state.parameters())
    for k in ("loss", "loss_cmd", "loss_args"):
        np.testing.assert_allclose(float(res[k]), float(ref_res[k]), rtol=1e-2, err_msg=k)
    ours, theirs = _leaves(to_flax_params(state.model, grads=True)), _leaves(ref_grads)
    a = np.concatenate([ours[k].ravel() for k in sorted(ours)]).astype(np.float64)
    b = np.concatenate([theirs[k].ravel() for k in sorted(ours)]).astype(np.float64)
    cosine = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    print(f"bf16 step: losses {[(k, float(res[k]), float(ref_res[k])) for k in ref_res]}, "
          f"|g| {np.linalg.norm(a):.4g} vs {np.linalg.norm(b):.4g}, cosine {cosine:.4f}")
    np.testing.assert_allclose(np.linalg.norm(a), np.linalg.norm(b), rtol=2e-2)
    assert cosine >= 0.998
