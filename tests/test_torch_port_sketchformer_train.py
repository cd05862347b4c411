"""Sketchformer's training step (one-stage encoder with the group embedding,
ResNet + VAE, causal teacher-forced decoder with relative targets over 512
argument classes) against the JAX package's, on the CPU.

A small model (d_model 64, 2 heads of 32, FF 128, dim_z 64, two layers per
stack, dropout 0) with the JAX package's own initialisation from a seed, its
VAE kernels scaled so that the KL term lies above ``kl_tolerance`` and its
gradient is held too; a batch of N=3 synthetic icons from a numpy seed. Two
sizes: 2 paths x 5 commands (encoder S=12, decoder S=11), and 4 x 8, whose
encoder (S=34) and decoder (S=33) run beyond the 32 rows of the layer
kernels' short form, so the port's step takes the plain version of the long
form's path. The port's kernels run as their plain versions (CPU tensors).
JAX's VAE noise cannot be the port's bits: before each of JAX's steps the
test reads the noise that step's VAE draws (``capture_intermediates``) and
hands it to the port's VAE (``DropoutRng.normal``, replaced for the test).

Held, float32, against JAX's ``train_step`` on its XLA path, 3 steps of clip
+ AdamW at a constant learning rate: each loss term (``loss_kl``,
``loss_cmd``, ``loss_args``, ``loss``) within LOSS_TOL, each leaf's gradient
within GRAD_TOL of its largest entry, the global norm within 1e-4, and the
parameters after each step as ``test_torch_port_train.py`` holds the
flagship's (PARAM_TOL where the gradient is signal, 2 lr a step anywhere).
bfloat16 (the card's profile: bfloat16 compute, float32 masters), one step
against JAX's bfloat16 step on its Pallas path (the training kernels, K5 and
the embedding's backward in interpret mode) at the long size, with the
statistical limits of the flagship's bfloat16 test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.training import schedulers as jax_schedulers
from deepsvg_tpu.training import trainer as jax_trainer
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    DropoutRng, ModelConfig, SVGTransformer, load_flax_params, to_flax_params)
from deepsvg_tpu_torch.training import constant, create_train_state, make_optimizer, train_step

N = 3
SIZES = {"short": (2, 5), "long": (4, 8)}      # (paths, commands): S = 12 / 11 and 34 / 33
LR = 1e-3
MODEL_ARGS = ["commands_grouped", "args_grouped", "commands_grouped", "args_rel_grouped"]
WEIGHTS = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_cmd_weight=1.0, loss_args_weight=2.0)
LOSS_TOL = 1e-5          # each loss term, absolute and relative
GRAD_TOL = 1e-3          # each leaf's gradient, of the leaf's largest entry
PARAM_TOL = 2e-5         # parameters after a step, where the gradient is signal
NOISE = 1e-3             # entries whose reference gradient was below this share of their
                         # leaf's largest at any step so far are rounding noise that Adam
                         # turns into a step of up to lr: held to 2 lr a step only
VAE_SCALE = 100.0        # the VAE's kernels, times this (std 0.1 instead of 0.001)


def _kw(size, dtype="float32"):
    g, s = SIZES[size]
    return dict(encode_stages=1, decode_stages=1, pred_mode="autoregressive",
                rel_targets=True, use_vae=True, d_model=64, n_heads=2, dim_feedforward=128,
                dim_z=64, n_layers=2, n_layers_decode=2, dropout=0.0, max_num_groups=g,
                max_seq_len=s, compute_dtype=dtype)


def _batch(size):
    g, s = SIZES[size]
    b = generate_batch(np.random.default_rng(1), N, g, s)
    return {k: b[k] for k in ("commands_grouped", "args_grouped", "args_rel_grouped")}


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tree(size, batch):
    """JAX's initialisation, the VAE's kernels times VAE_SCALE."""
    c, a, a_rel = (jnp.asarray(batch[k]) for k in
                   ("commands_grouped", "args_grouped", "args_rel_grouped"))
    tree = jax.jit(JaxSVGTransformer(JaxModelConfig(**_kw(size))).init)(
        {"params": jax.random.key(0), "vae": jax.random.key(1)}, c, a, c, a_rel)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    vae = {k: dict(v, kernel=v["kernel"] * VAE_SCALE) for k, v in tree["vae"].items()}
    return dict(tree, vae=vae)


def _remember_gradients():
    """An optax transformation that changes nothing and keeps the gradients
    it was given as its state (chained before the optimizer)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


def _jax_run(size, tree, batch, steps, impl="xla", dtype="float32"):
    """JAX's own train_step from PRNGKey(0), ``steps`` times: per step the
    loss terms, the gradients, the parameters after it and the VAE noise
    it drew."""
    model = JaxSVGTransformer(JaxModelConfig(**_kw(size, dtype), attention_impl=impl))
    optimizer = optax.chain(_remember_gradients(),
                            jax_trainer.make_optimizer(jax_schedulers.constant(LR)))
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                                   opt_state=optimizer.init(tree), rng=jax.random.PRNGKey(0))
    data = {k: jnp.asarray(v) for k, v in batch.items()}
    args = [data[k] for k in MODEL_ARGS]

    @jax.jit
    def vae_noise(params, key):
        _, inter = model.apply({"params": params}, *args, deterministic=False,
                               rngs={"vae": key, "dropout": key},
                               capture_intermediates=lambda mdl, _: mdl.name == "vae",
                               mutable=["intermediates"])
        z, mu, logsigma = (x.astype(jnp.float32)
                           for x in inter["intermediates"]["vae"]["__call__"][0])
        return (z - mu) / jnp.exp(logsigma / 2.0)

    step = jax_trainer.jit_train_step(model, optimizer, MODEL_ARGS, donate=False)
    to_np = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    out = []
    for _ in range(steps):
        _, _, vae_rng = jax.random.split(state.rng, 3)
        eps = np.asarray(vae_noise(state.params, vae_rng))
        state, res = step(state, data, WEIGHTS)
        out.append((to_np(res), to_np(state.opt_state[0]), to_np(state.params), eps))
    return out


@pytest.fixture
def noise(monkeypatch):
    """``noise(list)``: the port's VAE draws these, one a step, in order."""
    queue = []

    def normal(self, shape, dtype, device):
        eps = torch.from_numpy(queue.pop(0))
        assert tuple(shape) == tuple(eps.shape)
        return eps.to(device=device, dtype=dtype)
    monkeypatch.setattr(DropoutRng, "normal", normal)
    return queue.extend


def _port_state(size, tree, dtype="float32"):
    model = SVGTransformer(ModelConfig(**_kw(size, dtype)))
    load_flax_params(model, tree)
    optimizer = make_optimizer(constant(LR))
    return create_train_state(model, optimizer, init=False), optimizer


def _flat(tree_a, tree_b):
    a, b = _leaves(tree_a), _leaves(tree_b)
    assert set(a) == set(b)
    keys = sorted(a)
    return (np.concatenate([a[k].ravel() for k in keys]).astype(np.float64),
            np.concatenate([b[k].ravel() for k in keys]).astype(np.float64))


@pytest.mark.parametrize("size", list(SIZES))
def test_train_step_matches_jax(noise, size):
    batch = _batch(size)
    tree = _tree(size, batch)
    ref = _jax_run(size, tree, batch, 3)
    noise([eps for *_, eps in ref])
    state, optimizer = _port_state(size, tree)
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    signal = None
    for i, (ref_res, ref_grads, ref_params, _) in enumerate(ref):
        state, res = train_step(state, data, WEIGHTS, optimizer, MODEL_ARGS)
        assert set(res) == set(ref_res)
        if i == 0:
            assert float(res["loss_kl"]) > WEIGHTS["kl_tolerance"]
        for k in ("loss", "loss_kl", "loss_cmd", "loss_args"):
            np.testing.assert_allclose(float(res[k]), float(ref_res[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=f"step {i + 1} {k}")
        np.testing.assert_allclose(float(res["grad_norm"]), float(ref_res["grad_norm"]),
                                   rtol=1e-4)
        ours, theirs = _leaves(to_flax_params(state.model, grads=True)), _leaves(ref_grads)
        assert set(ours) == set(theirs)
        errs = {k: np.abs(ours[k] - g).max() / max(np.abs(g).max(), 1e-12)
                for k, g in theirs.items()}
        worst = max(errs, key=errs.get)
        # the entries whose gradient has been signal at every step so far
        now = {k: np.abs(g) >= NOISE * np.abs(g).max() for k, g in theirs.items()}
        signal = now if signal is None else {k: signal[k] & now[k] for k in now}
        p_ours, p_ref = _leaves(to_flax_params(state.model)), _leaves(ref_params)
        err_signal = max(float(np.abs(p_ours[k] - p_ref[k])[signal[k]].max(initial=0.0))
                         for k in p_ref)
        err_any = max(float(np.abs(p_ours[k] - p_ref[k]).max()) for k in p_ref)
        print(f"{size} step {i + 1}: losses {({k: float(res[k]) for k in ref_res})}; worst "
              f"gradient leaf {worst}: {errs[worst]:.3g} of its largest entry; parameters "
              f"max abs err {err_signal:.3g} where the gradient is signal, {err_any:.3g} "
              f"anywhere")
        assert errs[worst] <= GRAD_TOL, (i, worst, errs[worst])
        assert err_signal <= PARAM_TOL * (i + 1), (i, err_signal)
        assert err_any <= 2.02 * LR * (i + 1), (i, err_any)
    assert state.step == 3 and state.opt_state["count"] == 3


def test_bfloat16_step_matches_jax_pallas(noise):
    """One step in the card's profile against JAX's bfloat16 step on its
    Pallas path, at S = 34 / 33. The packages round at different points, so
    the limits are statistical, those of the flagship's bfloat16 test: each
    loss term within 1%, the global gradient norm within 2%, and the cosine
    between the two whole gradients at least 0.998."""
    batch = _batch("long")
    tree = _tree("long", batch)
    ((ref_res, ref_grads, _, eps),) = _jax_run("long", tree, batch, 1, "pallas", "bfloat16")
    noise([eps])
    state, optimizer = _port_state("long", tree, "bfloat16")
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, res = train_step(state, data, WEIGHTS, optimizer, MODEL_ARGS)
    assert all(p.dtype == torch.float32 for p in state.parameters())
    losses = {k: abs(float(res[k]) - float(ref_res[k])) / abs(float(ref_res[k]))
              for k in ("loss", "loss_kl", "loss_cmd", "loss_args")}
    a, b = _flat(to_flax_params(state.model, grads=True), ref_grads)
    norm_rel = abs(np.linalg.norm(a) - np.linalg.norm(b)) / np.linalg.norm(b)
    cosine = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    print(f"bf16 step vs JAX's Pallas step: relative loss differences {losses}, norm "
          f"{norm_rel:.3g}, cosine {cosine:.5f}")
    assert max(losses.values()) <= 1e-2, losses
    assert norm_rel <= 2e-2
    assert cosine >= 0.998


def test_train_cli_sketchformer_resumes_bit_exact(tmp_path):
    """``train()`` on the Sketchformer config (``configs/sketchformer.py``,
    cut to the long size, dropout 0.1): the losses are finite and the KL
    term is logged; 4 steps, save, resume to 6 equals 6 steps without a
    stop, to the bit."""
    import dataclasses

    import test_torch_port_runtime as runtime_test

    from deepsvg_tpu_torch.configs.sketchformer import Config
    from deepsvg_tpu_torch.training.train import train

    def cfg():
        c = Config(1)
        model_cfg = dataclasses.replace(c.model_cfg, **dict(_kw("long"), dropout=0.1))
        return runtime_test._configure(c, model_cfg, None)
    torch.use_deterministic_algorithms(True)
    try:
        ds = runtime_test._port_dataset(cfg())
        train(cfg(), "cli", "split", log_dir=str(tmp_path), dataset=ds, max_steps=4,
              device="cpu")
        resumed, _ = train(cfg(), "cli", "split", log_dir=str(tmp_path), dataset=ds,
                           max_steps=6, resume=True, device="cpu")
        whole, stats = train(cfg(), "cli", "whole", log_dir=str(tmp_path), dataset=ds,
                             max_steps=6, device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    logged = stats.stats["train"]
    assert np.isfinite(list(logged["loss"].deque)).all()
    assert len(logged["loss_kl"].deque) == len(logged["loss"].deque) > 0
    assert resumed.step == whole.step == 6
    for a, b in zip(runtime_test._state_tensors(resumed), runtime_test._state_tensors(whole),
                    strict=True):
        assert torch.equal(a, b)
