"""K4's recompute mode (``save_residuals=False``) against the JAX package's,
on the CPU.

The JAX op ``fused_layer_train(..., save_residuals=False)`` runs its Pallas
kernels in interpret mode, as the JAX package's own tests run them: a forward
that writes the output alone and a backward that recomputes every
intermediate, the attention probabilities and the FF hidden in float32. On
CPU tensors the port's ``fused_layer_train`` takes its plain version in
either mode (autograd keeps what it needs, the probabilities and hidden in
float32), which is what the card's recompute kernels are held to.

Held: the op in float32 at S = 8, 32 and 40, causal and not, with key
padding, one fully masked sequence and ``seq_bias`` (the tolerances of
``test_torch_port_train_ops.py::test_layer_train_matches_pallas``); one
bfloat16 case; the slice as a whole, a cut Sketchformer's bfloat16 training
step at S = 34 / 33 with the switch off in both packages; and that the port's
model layers hand their switch to the op. Inputs are made from a seed with
numpy; dropout is 0 where the packages are compared (JAX's masks are not
part of the contract).

    python -m pytest tests/test_torch_port_recompute.py -q
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.ops import layer_vjp as jax_layer_vjp
from deepsvg_tpu.ops.attention import pick_tile_b
from deepsvg_tpu.training import schedulers as jax_schedulers
from deepsvg_tpu.training import trainer as jax_trainer
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    DropoutRng, ModelConfig, SVGTransformer, load_flax_params, to_flax_params)
from deepsvg_tpu_torch.models import layers as port_layers
from deepsvg_tpu_torch.ops import layer_vjp as port_layer_vjp
from deepsvg_tpu_torch.training import constant, create_train_state, make_optimizer, train_step

D, H, FF = 64, 2, 128
NAMES = ("x", "seq_bias", "ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "w1", "b1", "w2", "b2")
TRANSPOSED = {"wqkv", "wo", "w1", "w2"}      # stored [out, in] in the port (nn.Linear)


def _layer_inputs(rng, b, s):
    """JAX-layout inputs of the fused layer (kernels ``[in, out]``), key
    padding with sequence 0 fully masked, and an output gradient."""
    n = lambda *shape, scale=1.0: (scale * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    ln = lambda: np.stack([1 + n(D, scale=0.1), n(D, scale=0.1)])  # noqa: E731
    vals = dict(x=n(b, s, D), seq_bias=n(b, D), ln1=ln(), wqkv=n(D, 3 * D, scale=D ** -0.5),
                bqkv=n(3 * D, scale=0.1), wo=n(D, D, scale=D ** -0.5), bo=n(D, scale=0.1),
                ln2=ln(), w1=n(D, FF, scale=D ** -0.5), b1=n(FF, scale=0.1),
                w2=n(FF, D, scale=FF ** -0.5), b2=n(D, scale=0.1))
    lengths = rng.integers(1, s + 1, b)
    lengths[0] = 0
    mask = np.where(np.arange(s)[None] < lengths[:, None], 0.0, -np.inf).astype(np.float32)
    return vals, mask, n(b, s, D)


def _jax_layer(vals, mask, g, causal, dtype):
    """JAX's op in its recompute mode: the output and the twelve gradients,
    as float32 numpy arrays."""
    b, s, _ = vals["x"].shape

    def run(*args):
        return jax_layer_vjp.fused_layer_train(
            *args, jnp.asarray(mask), jnp.zeros((1,), jnp.int32), H, pick_tile_b(b, s), causal,
            0.0, None, False, False)

    @jax.jit
    def value_and_grads(args, gy):
        out, vjp = jax.vjp(run, *args)
        return out, vjp(gy)

    out, grads = value_and_grads([jnp.asarray(vals[k], dtype) for k in NAMES],
                                 jnp.asarray(g, dtype))
    as_np = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return as_np(out), {k: as_np(gr) for k, gr in zip(NAMES, grads)}


def _port_layer(vals, mask, g, causal, dtype):
    """The port's op in its recompute mode: activations in ``dtype``, the
    weights as float32 masters used in ``dtype``."""
    def leaf(k):
        a = torch.from_numpy(np.ascontiguousarray(vals[k].T if k in TRANSPOSED else vals[k]))
        return (a.to(dtype) if k in ("x", "seq_bias") else a).requires_grad_()
    ts = [leaf(k) for k in NAMES]
    out = port_layer_vjp.fused_layer_train(*ts, torch.from_numpy(mask), 0, H, causal, 0.0,
                                           dtype, save_residuals=False)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g).to(dtype))
    as_np = lambda t: t.detach().float().numpy()  # noqa: E731
    return as_np(out), {k: (as_np(gr).T if k in TRANSPOSED else as_np(gr))
                        for k, gr in zip(NAMES, grads)}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [8, 32, 40])
def test_recompute_layer_matches_pallas(s, causal):
    """float32: the output within rtol 1e-4 / atol 1e-5, each of the twelve
    gradients within rtol 1e-4 / atol 1e-5 x max(1, its largest entry),
    float32 rounding with the sums in another order. S=40 is beyond the
    short form's 32 rows (the card's long form)."""
    vals, mask, g = _layer_inputs(np.random.default_rng(100 + s + causal), 4, s)
    ref, ref_grads = _jax_layer(vals, mask, g, causal, jnp.float32)
    out, grads = _port_layer(vals, mask, g, causal, torch.float32)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    for k in NAMES:
        scale = max(1.0, float(np.abs(ref_grads[k]).max()))
        np.testing.assert_allclose(grads[k], ref_grads[k].reshape(grads[k].shape), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-30))


def test_recompute_layer_bfloat16_matches_pallas():
    """bfloat16 activations and weights at S=32, causal, against JAX's
    recompute mode. Both keep the probabilities and the FF hidden in float32
    and round the products' operands to bfloat16, but JAX also rounds df,
    dhpre, da, dctx, ds and dqkv before their products, which the plain
    version's autograd does not (the card's kernels do). Relative RMS
    readings: the output equal, the gradients at most 0.0044 (dwqkv; dw1,
    dw2 and db2 equal); limits: output 1e-3, gradients 1e-2."""
    rng = np.random.default_rng(7)
    vals, mask, g = _layer_inputs(rng, 4, 32)
    # the values both packages read: bfloat16 numbers (float32 masters that
    # hold them exactly on the port's side)
    vals = {k: v.astype(ml_dtypes.bfloat16).astype(np.float32) for k, v in vals.items()}
    g = g.astype(ml_dtypes.bfloat16).astype(np.float32)
    ref, ref_grads = _jax_layer(vals, mask, g, True, jnp.bfloat16)
    out, grads = _port_layer(vals, mask, g, True, torch.bfloat16)
    readings = {k: _rel_rms(grads[k], ref_grads[k].reshape(grads[k].shape)) for k in NAMES}
    print(f"bf16 recompute layer vs JAX: output {_rel_rms(out, ref):.3g}, gradients "
          f"{ {k: round(v, 5) for k, v in readings.items()} }")
    assert _rel_rms(out, ref) <= 1e-3
    assert max(readings.values()) <= 1e-2, readings


# ---------------------------------------------------------------- the slice

N_ICONS = 3
PATHS, COMMANDS = 4, 8                # encoder S=34, decoder S=33: JAX pads them to 40
LR = 1e-3
MODEL_ARGS = ["commands_grouped", "args_grouped", "commands_grouped", "args_rel_grouped"]
WEIGHTS = dict(loss_cmd_weight=1.0, loss_args_weight=2.0)


def _sketchformer_kw(dtype):
    return dict(encode_stages=1, decode_stages=1, pred_mode="autoregressive", rel_targets=True,
                use_vae=False, d_model=64, n_heads=2, dim_feedforward=128, dim_z=64, n_layers=1,
                n_layers_decode=1, dropout=0.0, max_num_groups=PATHS, max_seq_len=COMMANDS,
                compute_dtype=dtype)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_step(tree, batch):
    """One of JAX's bfloat16 ``train_step``s on its Pallas path from
    PRNGKey(0): the loss terms and the gradients (kept by an optax stage
    chained before the optimizer)."""
    model = JaxSVGTransformer(JaxModelConfig(**_sketchformer_kw("bfloat16"),
                                             attention_impl="pallas"))
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    optimizer = optax.chain(keep, jax_trainer.make_optimizer(jax_schedulers.constant(LR)))
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                                   opt_state=optimizer.init(tree), rng=jax.random.PRNGKey(0))
    data = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax_trainer.jit_train_step(model, optimizer, MODEL_ARGS, donate=False)
    state, res = step(state, data, WEIGHTS)
    return {k: float(v) for k, v in res.items()}, _leaves(state.opt_state[0])


def test_recompute_step_matches_jax_pallas(monkeypatch):
    """Sketchformer's bfloat16 training step with the switch off in both
    packages, cut to d_model 64, one layer a stack and no VAE (the VAE does
    not reach K4, and its noise cannot be JAX's bits): S = 34 / 33. JAX's
    Pallas step, traced after the switch is set, runs the recompute backward
    (a spy on its backward call says so); the port's step hands
    save_residuals=False to every layer. The packages round at different
    points, so the limits are those of the saved mode's bfloat16 step test:
    each loss term within 1%, the global gradient norm within 2%, the cosine
    between the whole gradients at least 0.998, and each leaf's gradient
    within 0.1 relative RMS (readings: losses at most 1.4e-7, norm 3.5e-4,
    cosine 0.999992, the worst leaf 0.011)."""
    raw = generate_batch(np.random.default_rng(1), N_ICONS, PATHS, COMMANDS)
    batch = {k: raw[k] for k in ("commands_grouped", "args_grouped", "args_rel_grouped")}
    c, a, a_rel = (jnp.asarray(batch[k]) for k in
                   ("commands_grouped", "args_grouped", "args_rel_grouped"))
    tree = jax.jit(JaxSVGTransformer(JaxModelConfig(**_sketchformer_kw("float32"))).init)(
        {"params": jax.random.key(0), "vae": jax.random.key(1)}, c, a, c, a_rel)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)

    jax_modes, port_modes = [], []
    bwd_call = jax_layer_vjp._layer_bwd_call

    def jax_bwd_spy(*args, saved=None, **kw):
        jax_modes.append(saved is None)
        return bwd_call(*args, saved=saved, **kw)
    monkeypatch.setattr(jax_layer_vjp, "SAVE_RESIDUALS_DEFAULT", False)
    monkeypatch.setattr(jax_layer_vjp, "_layer_bwd_call", jax_bwd_spy)
    ref_res, ref_grads = _jax_step(tree, batch)
    assert jax_modes and all(jax_modes)          # traced: every layer's backward recomputes

    port_fn = port_layer_vjp.fused_layer_train

    def port_spy(*args, **kw):
        port_modes.append(kw.get("save_residuals"))
        return port_fn(*args, **kw)
    monkeypatch.setattr(port_layer_vjp, "SAVE_RESIDUALS_DEFAULT", False)
    monkeypatch.setattr(port_layer_vjp, "fused_layer_train", port_spy)
    model = SVGTransformer(ModelConfig(**_sketchformer_kw("bfloat16")))
    load_flax_params(model, tree)
    optimizer = make_optimizer(constant(LR))
    state = create_train_state(model, optimizer, init=False)
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, res = train_step(state, data, WEIGHTS, optimizer, MODEL_ARGS)
    assert port_modes == [False] * 2             # the encoder's layer and the decoder's

    losses = {k: abs(float(res[k]) - ref_res[k]) / abs(ref_res[k])
              for k in ("loss", "loss_cmd", "loss_args")}
    ours = _leaves(to_flax_params(state.model, grads=True))
    assert set(ours) == set(ref_grads)
    keys = sorted(ours)
    flat_a = np.concatenate([ours[k].ravel() for k in keys]).astype(np.float64)
    flat_b = np.concatenate([ref_grads[k].ravel() for k in keys]).astype(np.float64)
    norm_rel = abs(np.linalg.norm(flat_a) - np.linalg.norm(flat_b)) / np.linalg.norm(flat_b)
    cosine = float(flat_a @ flat_b / np.linalg.norm(flat_a) / np.linalg.norm(flat_b))
    leaf = {k: _rel_rms(ours[k], ref_grads[k]) for k in keys}
    worst = max(leaf, key=leaf.get)
    print(f"recompute step vs JAX's Pallas recompute step: relative loss differences {losses}, "
          f"norm {norm_rel:.3g}, cosine {cosine:.6f}, worst leaf {worst} {leaf[worst]:.3g}")
    assert max(losses.values()) <= 1e-2, losses
    assert norm_rel <= 2e-2
    assert cosine >= 0.998
    assert leaf[worst] <= 0.1, (worst, leaf[worst])


@pytest.mark.parametrize("switch", [True, False], ids=["saved", "recompute"])
def test_model_layers_pass_the_switch(monkeypatch, switch):
    """Every layer the model trains layer by layer (encoder and decoder,
    S=33, beyond the stack gate) calls the op with ``save_residuals`` equal
    to ``layer_vjp.SAVE_RESIDUALS_DEFAULT``, read at the call."""
    seen = []
    fn = port_layer_vjp.fused_layer_train

    def spy(*args, **kw):
        seen.append(kw.get("save_residuals"))
        return fn(*args, **kw)
    monkeypatch.setattr(port_layer_vjp, "fused_layer_train", spy)
    monkeypatch.setattr(port_layer_vjp, "SAVE_RESIDUALS_DEFAULT", switch)
    torch.manual_seed(0)
    b, s = 2, 33
    assert not port_layers.use_stack_fused(False, 2, b, s)
    enc = port_layers.EncoderStack(2, D, H, FF, dropout=0.1)
    dec = port_layers.DecoderStack(2, D, H, FF, dim_z=16, dropout=0.1)
    x, mask = torch.randn(b, s, D), torch.zeros(b, s)
    rng = DropoutRng(torch.Generator().manual_seed(0))
    y = enc(x, mask, False, rng)
    y = dec(y, torch.randn(b, 16), False, rng, key_pad=mask, causal=True)
    y.float().sum().backward()
    assert seen == [switch] * 4
