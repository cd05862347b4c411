"""The Hungarian self-matching model with its VAE, and the VAE ordered model
of the icons config, against the JAX package, on the CPU.

A small model (d_model 64, 2 heads, FF 128, dim_z 64, two layers per stack,
G = P = 8 paths of 6 commands, dropout 0) with the JAX package's own
initialisation from a seed, a batch of N=4 synthetic icons from a numpy seed
with 4-8 visible paths each. The port's kernels run as their plain versions
(CPU tensors); the JAX package's Pallas kernels in interpret mode. The VAE's
noise cannot be JAX's bits: each comparison reads JAX's ``(z, mu,
logsigma)`` from the VAE (``capture_intermediates``), sets ``eps = (z - mu) /
exp(logsigma / 2)`` and hands it to the port's VAE through its generator
(``DropoutRng.normal``, replaced for the test). Held:

- (a) K8's plain version against ``args_ce_pairwise``, float32, 1e-5;
- (b) ``assign_bruteforce`` against the JAX package's, with invisible rows
  and exact ties, and ``_assign_host`` at P=9;
- (c) the float32 forward, fused and unfused, against JAX's XLA path:
  logits and argument CE within 1e-4, the same assignment, ``mu`` and
  ``logsigma`` within 1e-5;
- (d, h) one float32 training step at dropout 0 against JAX's
  ``train_step``, for the self-match model and the VAE ordered model: each
  loss term (``loss_kl`` too) within 1e-5, each leaf's gradient within 1e-3
  of its largest entry, as in ``test_torch_port_train.py``;
- (e) one bfloat16 step against JAX's Pallas step, limits of
  ``test_torch_port_train.py``: loss terms 1%, gradient norm 2%, cosine >=
  0.998, samples whose assignment lies within the margin excluded;
- (f) the weight bridge of the self-match + VAE tree;
- (g) ``train()`` on a self-match config: runs, resumes to the bit;
- the two paths of the port (targets permuted with K8, logits permuted)
  against each other, the KL term against JAX's in both types, and the
  VAE's fixed generator at evaluation and sampling.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models import matching as jax_matching
from deepsvg_tpu.models.loss import svg_loss as jax_svg_loss
from deepsvg_tpu.ops.ce import args_ce_pairwise as jax_args_ce_pairwise
from deepsvg_tpu.training import schedulers as jax_schedulers
from deepsvg_tpu.training import trainer as jax_trainer
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    DropoutRng, ModelConfig, SVGTransformer, load_flax_params, one_shot_sample, svg_loss,
    to_flax_params)
from deepsvg_tpu_torch.models import matching
from deepsvg_tpu_torch.ops import ce as ce_ops
from deepsvg_tpu_torch.training import (
    constant, create_train_state, eval_step, make_optimizer, train_step)

N, G, S = 4, 8, 6
LR = 1e-3
MODEL_ARGS = ["commands", "args", "commands", "args"]
WEIGHTS = dict(kl_tolerance=0.1, loss_kl_weight=1.0, loss_visibility_weight=1.0,
               loss_cmd_weight=1.0, loss_args_weight=2.0)
KW = dict(encode_stages=2, decode_stages=2, label_condition=False, d_model=64, n_heads=2,
          dim_feedforward=128, dim_z=64, n_layers=2, n_layers_decode=2, dropout=0.0,
          max_num_groups=G, max_seq_len=S)
VARIANTS = {"self_match": dict(use_vae=True, self_match=True),
            "ordered_vae": dict(use_vae=True, self_match=False)}
LOSS_TOL = 1e-5          # each loss term, absolute and relative
GRAD_TOL = 1e-3          # each leaf's gradient, of the leaf's largest entry
LOGIT_TOL = 1e-4         # float32 logits and cross-entropies, absolute
LATENT_TOL = 1e-5        # mu, logsigma
MARGIN_BF16 = 0.05       # visible-row margin below which a bf16 sample is excluded
SHARPEN = 4.0            # the bf16 step's decoder heads and path queries, times this
VAE_SCALE = 100.0        # the steps' VAE kernels, times this (std 0.1): a KL term above
                         # kl_tolerance, so that its gradient is held too


def _jax_cfg(variant, impl="xla", dtype="float32"):
    return JaxModelConfig(**KW, **VARIANTS[variant], attention_impl=impl, compute_dtype=dtype)


def _port_cfg(variant, dtype="float32"):
    return ModelConfig(**KW, **VARIANTS[variant], compute_dtype=dtype)


@pytest.fixture(scope="module")
def batch():
    b = generate_batch(np.random.default_rng(0), 8, G, S)
    return b["commands"][4:], b["args"][4:]              # 5, 6, 4 and 8 visible paths


@pytest.fixture(scope="module")
def params(batch):
    """Each variant's tree from the JAX package's own initialisation."""
    out = {}
    for variant in VARIANTS:
        model = JaxSVGTransformer(_jax_cfg(variant))
        tree = jax.jit(model.init)({"params": jax.random.key(0), "vae": jax.random.key(1)},
                                   *batch, *batch)["params"]
        out[variant] = jax.tree_util.tree_map(np.asarray, tree)
    return out


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_model(variant, tree, dtype="float32"):
    model = SVGTransformer(_port_cfg(variant, dtype))
    load_flax_params(model, tree)
    return model


def _tensors(batch):
    return [torch.from_numpy(x) for x in batch] * 2


def _apply_capturing_vae(model, tree, batch, vae_key, deterministic):
    """JAX's forward with the VAE's output ``(z, mu, logsigma)`` captured."""
    return model.apply({"params": tree}, *[jnp.asarray(x) for x in batch * 2],
                       deterministic=deterministic, rngs={"vae": vae_key, "dropout": vae_key},
                       capture_intermediates=lambda mdl, _: mdl.name == "vae",
                       mutable=["intermediates"])


def _vae_outputs(inter):
    """``(z, mu, logsigma, eps)`` in float32, ``eps = (z - mu) / exp(logsigma
    / 2)``: the noise JAX's VAE drew."""
    z, mu, logsigma = (np.asarray(t, np.float32)
                       for t in inter["intermediates"]["vae"]["__call__"][0])
    return z, mu, logsigma, (z - mu) / np.exp(logsigma / 2.0)


@pytest.fixture
def eps_hook(monkeypatch):
    """``set(eps)``: the port's VAE draws ``eps`` (rounded to its type)."""
    given = {}

    def normal(self, shape, dtype, device):
        assert tuple(shape) == given["eps"].shape
        return given["eps"].to(device=device, dtype=dtype)
    monkeypatch.setattr(DropoutRng, "normal", normal)
    return lambda eps: given.__setitem__("eps", torch.from_numpy(np.asarray(eps, np.float32)))


def _record(monkeypatch, module):
    """Record what ``module.solve_assignment`` returns (and is given)."""
    seen = []
    fn = module.solve_assignment

    def spy(cost, vis):
        out = fn(cost, vis)
        seen.append((cost, vis, out))
        return out
    monkeypatch.setattr(module, "solve_assignment", spy)
    return seen


def _ce(logits, labels):
    logits = torch.as_tensor(np.asarray(logits, np.float32))
    return torch.logsumexp(logits, -1) - logits.gather(
        -1, torch.as_tensor(np.asarray(labels)).long()[..., None])[..., 0]


# ----------------------------------------------------------------- (a) K8 plain

@pytest.mark.parametrize("n_variants,d", [(8, 64), (3, 32)])
def test_pairwise_plain_matches_jax(n_variants, d):
    rng = np.random.default_rng(n_variants)
    r, n_args, vocab = 70, 11, 257
    y = rng.normal(size=(2, r // 2, d)).astype(np.float32)
    wa = (rng.normal(size=(d, n_args * vocab)) * d ** -0.5).astype(np.float32)  # flax layout
    ba = rng.normal(size=(n_args * vocab,)).astype(np.float32)
    tgt = rng.integers(0, vocab, (2, r // 2, n_variants * n_args)).astype(np.int32)
    ref = np.asarray(jax_args_ce_pairwise(jnp.asarray(y), jnp.asarray(wa), jnp.asarray(ba),
                                          jnp.asarray(tgt), n_variants))
    y_t, wa_t, ba_t = torch.from_numpy(y), torch.from_numpy(wa.T.copy()), torch.from_numpy(ba)
    ours = ce_ops.args_ce_pairwise(y_t, wa_t, ba_t, torch.from_numpy(tgt), n_variants)
    plain = ce_ops.args_ce_pairwise_reference(y_t.reshape(r, d), wa_t, ba_t,
                                              torch.from_numpy(tgt).reshape(r, -1), n_variants)
    err = np.abs(ours.numpy() - ref).max()
    print(f"K8 plain vs JAX args_ce_pairwise: max abs err {err:.3g} (values up to "
          f"{np.abs(ref).max():.3g})")
    assert ours.shape == ref.shape and ours.dtype == torch.float32 and err <= 1e-5
    assert torch.equal(plain.reshape(ours.shape), ours)
    # each variant's columns are K5's plain forward against that variant's targets
    for g in range(n_variants):
        cols = slice(g * n_args, (g + 1) * n_args)
        one = ce_ops.args_ce_reference(y_t.reshape(r, d), wa_t, ba_t,
                                       torch.from_numpy(tgt).reshape(r, -1)[:, cols], n_args)
        np.testing.assert_allclose(ours.reshape(r, -1)[:, cols].numpy(), one.detach().numpy(),
                                   rtol=0, atol=1e-6)


# ------------------------------------------------------------- (b) assignment

def _cost_and_vis(rng, n, p, ties):
    cost = (rng.integers(0, 3, (n, p, p)) if ties else rng.random((n, p, p))).astype(np.float32)
    n_vis = rng.integers(0, p + 1, n)
    n_vis[:3] = (0, p, 1)
    vis = np.arange(p)[None] < n_vis[:, None]
    return cost, vis


@pytest.mark.parametrize("p,ties", [(3, True), (8, True), (8, False)])
def test_assign_bruteforce_matches_jax(p, ties):
    """Integer costs make exact ties between visible assignments common:
    both packages take the lexicographically first optimum. Invisible rows
    get the remaining proposals in ascending order."""
    cost, vis = _cost_and_vis(np.random.default_rng(p), 24, p, ties)
    ref = np.asarray(jax_matching.assign_bruteforce(jnp.asarray(cost), jnp.asarray(vis)))
    ours = matching.assign_bruteforce(torch.from_numpy(cost), torch.from_numpy(vis))
    assert ours.dtype == torch.int32 and np.array_equal(ours.numpy(), ref)
    assert np.array_equal(matching.solve_assignment(torch.from_numpy(cost),
                                                    torch.from_numpy(vis)).numpy(), ref)
    for i in range(len(cost)):
        v = int(vis[i].sum())
        assert list(ref[i, v:]) == sorted(set(range(p)) - set(ref[i, :v]))


def test_assign_host_matches_jax_above_eight():
    cost, vis = _cost_and_vis(np.random.default_rng(9), 12, 9, False)
    ref = jax_matching._assign_host(cost, vis)
    assert np.array_equal(matching._assign_host(cost, vis), ref)
    ours = matching.solve_assignment(torch.from_numpy(cost), torch.from_numpy(vis))
    assert ours.dtype == torch.int32 and np.array_equal(ours.numpy(), ref)


def test_assignment_margin_counts_visible_rows_only():
    """Invisible rows tie exactly (margin over all permutations 0); the
    margin is the gap to the best assignment that moves a visible row."""
    cost = torch.tensor([[[1.0, 5.0, 9.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                         [[1.0, 5.0, 9.0], [4.0, 2.0, 9.0], [9.0, 9.0, 9.0]],
                         [[0.0] * 3] * 3])
    vis = torch.tensor([[True, False, False], [True, True, False], [False] * 3])
    margin = matching.assignment_margin(cost, vis)
    # sample 1: best (0, 1, 2) = 3; next moving a visible row: (1, 0, 2) = 9
    assert margin.tolist() == [4.0, 6.0, float("inf")]


# --------------------------------------------------------- (c) float32 forward

@pytest.fixture(scope="module")
def jax_forward(batch, params):
    """JAX's XLA forward of the self-match model (logits permuted to the
    targets), its assignment and its VAE noise."""
    model = JaxSVGTransformer(_jax_cfg("self_match"))
    seen = []
    fn = jax_matching.solve_assignment

    def spy(cost, vis):
        seen.append(fn(cost, vis))
        return seen[-1]
    jax_matching.solve_assignment = spy
    try:
        out, inter, assignment = jax.jit(lambda p: (*_apply_capturing_vae(
            model, p, batch, jax.random.key(7), True), seen[-1]))(params["self_match"])
    finally:
        jax_matching.solve_assignment = fn
    _, mu, logsigma, eps = _vae_outputs(inter)
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(assignment), mu, logsigma, eps


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_forward_matches_jax(monkeypatch, eps_hook, batch, params, jax_forward, fused):
    ref, ref_assign, mu, logsigma, eps = jax_forward
    eps_hook(eps)
    seen = _record(monkeypatch, matching)
    model = _port_model("self_match", params["self_match"])
    with torch.no_grad():
        out = model(*_tensors(batch), return_tgt=True, fused_ce=fused, rng=DropoutRng.fixed())
    (_, _, assignment), = seen
    assert np.array_equal(assignment.numpy(), ref_assign)
    np.testing.assert_allclose(out["mu"].numpy(), mu, rtol=0, atol=LATENT_TOL)
    np.testing.assert_allclose(out["logsigma"].numpy(), logsigma, rtol=0, atol=LATENT_TOL)
    tgt_a = ref["tgt_args"][..., 1:, :] + 1
    ref_ce = _ce(ref["args_logits"], tgt_a)                         # [N, G, S, n_args]
    if fused:
        # unpermuted logits, the CE against the permuted targets: reorder by
        # the assignment to the targets' order
        cmd, vis_logits, ce = matching.apply_assignment(
            assignment, out["command_logits"], out["visibility_logits"], out["args_ce"])
        inv = np.argsort(ref_assign, axis=1)
        np.testing.assert_array_equal(
            out["tgt_commands"].numpy(), np.take_along_axis(ref["tgt_commands"],
                                                            inv[:, :, None], 1))
    else:
        cmd, vis_logits = out["command_logits"], out["visibility_logits"]
        np.testing.assert_allclose(out["args_logits"].numpy(), ref["args_logits"], rtol=0,
                                   atol=LOGIT_TOL)
        ce = _ce(out["args_logits"].numpy(), tgt_a)
        np.testing.assert_array_equal(out["tgt_commands"].numpy(), ref["tgt_commands"])
    errs = {"command_logits": np.abs(cmd.numpy() - ref["command_logits"]).max(),
            "visibility_logits": np.abs(vis_logits.numpy() - ref["visibility_logits"]).max(),
            "args_ce": np.abs(ce.numpy() - ref_ce.numpy()).max()}
    print(f"forward, {'fused' if fused else 'unfused'}: max abs errors {errs}")
    assert max(errs.values()) <= LOGIT_TOL, errs
    ref_loss = jax_svg_loss({k: jnp.asarray(v) for k, v in ref.items()}, WEIGHTS,
                            _jax_cfg("self_match"))
    res = svg_loss(out, WEIGHTS, model.cfg)
    assert set(res) == set(ref_loss)
    for k in ref_loss:
        np.testing.assert_allclose(float(res[k]), float(ref_loss[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)


# ------------------------------------------------------- (d, h) float32 step

def _remember_gradients():
    """An optax transformation that changes nothing and keeps the gradients
    it was given as its state (chained before the optimizer)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


def _jax_step(variant, tree, batch, impl="xla", dtype="float32"):
    """JAX's train_step from PRNGKey(0): the loss terms, the gradients and
    the noise its VAE drew in that step."""
    model = JaxSVGTransformer(_jax_cfg(variant, impl, dtype))
    optimizer = optax.chain(_remember_gradients(),
                            jax_trainer.make_optimizer(jax_schedulers.constant(LR)))
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                                   opt_state=optimizer.init(tree), rng=jax.random.PRNGKey(0))
    _, _, vae_rng = jax.random.split(state.rng, 3)
    _, inter = jax.jit(lambda p: _apply_capturing_vae(model, p, batch, vae_rng, False))(tree)
    eps = _vae_outputs(inter)[3]
    step = jax_trainer.jit_train_step(model, optimizer, MODEL_ARGS, donate=False)
    state, res = step(state, {"commands": jnp.asarray(batch[0]),
                              "args": jnp.asarray(batch[1])}, WEIGHTS)
    return ({k: float(v) for k, v in res.items()},
            jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), state.opt_state[0]), eps)


def _with_kl(tree):
    """The VAE's kernels (std 0.001 at initialisation, which puts the KL
    term far below ``kl_tolerance``, where it has no gradient) times
    VAE_SCALE."""
    vae = {k: dict(v, kernel=v["kernel"] * VAE_SCALE) for k, v in tree["vae"].items()}
    return dict(tree, vae=vae)


def _port_step(variant, tree, batch, dtype="float32"):
    model = _port_model(variant, tree, dtype)
    optimizer = make_optimizer(constant(LR))
    state = create_train_state(model, optimizer, init=False)
    b = {"commands": torch.from_numpy(batch[0]), "args": torch.from_numpy(batch[1])}
    state, res = train_step(state, b, WEIGHTS, optimizer, MODEL_ARGS)
    return {k: float(v) for k, v in res.items()}, to_flax_params(state.model, grads=True)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax(eps_hook, batch, params, variant):
    """(d) the self-match model, (h) the icons config's VAE ordered model.
    JAX's step on its XLA path matches by permuting the logits; the port's
    step permutes the targets (K8's plain version)."""
    tree = _with_kl(params[variant])
    ref_res, ref_grads, eps = _jax_step(variant, tree, batch)
    eps_hook(eps)
    res, grads = _port_step(variant, tree, batch)
    assert res["loss_kl"] > WEIGHTS["kl_tolerance"]
    for k in ("loss", "loss_kl", "loss_cmd", "loss_args", "loss_visibility"):
        np.testing.assert_allclose(res[k], ref_res[k], rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    ours, theirs = _leaves(grads), _leaves(ref_grads)
    assert set(ours) == set(theirs)
    errs = {k: np.abs(ours[k] - ref).max() / max(np.abs(ref).max(), 1e-12)
            for k, ref in theirs.items()}
    worst = max(errs, key=errs.get)
    print(f"{variant}: losses {res}; worst gradient leaf {worst}: {errs[worst]:.3g} of its "
          f"largest entry")
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    np.testing.assert_allclose(res["grad_norm"], ref_res["grad_norm"], rtol=1e-4)


def test_fused_and_unfused_paths_agree(eps_hook, batch, params):
    """Permuting the targets (K8, K5) or the logits gives the same loss
    (1e-5) and gradients (1e-4 of each leaf's largest), as the JAX package's
    own test holds its two paths."""
    eps_hook(np.random.default_rng(3).normal(size=(N, KW["dim_z"])))
    got = []
    for fused in (True, False):
        model = _port_model("self_match", params["self_match"])
        out = model(*_tensors(batch), return_tgt=True, deterministic=False, fused_ce=fused,
                    rng=DropoutRng.fixed())
        res = svg_loss(out, WEIGHTS, model.cfg)
        res["loss"].backward()
        got.append(({k: float(v.detach()) for k, v in res.items()},
                    _leaves(to_flax_params(model, grads=True))))
    (a, ga), (b, gb) = got
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ga:
        assert np.abs(ga[k] - gb[k]).max() <= 1e-4 * max(np.abs(gb[k]).max(), 1e-12), k


# ------------------------------------------------------------ (e) bf16 step

def _sharpen(tree):
    """At initialisation the proposals' logits are nearly alike and the
    visible-row margins are of the order of bfloat16's rounding (read
    0.010-0.096 at N=4): the decoder's heads and its path queries scaled by
    SHARPEN make the proposals distinct."""
    dec = tree["decoder"]
    fcn = {k: v * SHARPEN if k.endswith("kernel") else v for k, v in dec["fcn"].items()}
    pe = {"PE": {"pos_embed": dec["hierarchical_embedding"]["PE"]["pos_embed"] * SHARPEN}}
    return dict(tree, decoder=dict(dec, fcn=fcn, hierarchical_embedding=pe))


def test_bfloat16_step_matches_jax_pallas(monkeypatch, eps_hook, batch, params):
    """The card's profile (bfloat16 compute, float32 masters) against JAX's
    bfloat16 step on its Pallas path (K8, K5 and the training kernels in
    interpret mode). The KL term is a bfloat16 number in both packages,
    whose elementwise terms round at other points (XLA fuses them): it is
    held to two bfloat16 steps (read 1.27%, 2 steps at 9.0). A sample whose
    bfloat16 assignment has a visible-row
    margin below MARGIN_BF16 could be matched otherwise by the other
    package's rounding; it is left out of the batch and counted."""
    tree = _with_kl(_sharpen(params["self_match"]))
    seen = _record(monkeypatch, matching)
    model = _port_model("self_match", tree, "bfloat16")
    eps_hook(np.zeros((N, KW["dim_z"])))
    with torch.no_grad():
        model(*_tensors(batch), return_tgt=True, fused_ce=True, rng=DropoutRng.fixed())
    cost, vis, _ = seen[0]
    margin = matching.assignment_margin(cost, vis)
    keep = (margin >= MARGIN_BF16).numpy()
    print(f"bf16 visible-row margins {margin.tolist()}: {int((~keep).sum())} of {N} "
          f"samples excluded")
    assert keep.sum() >= N // 2
    sub = tuple(x[keep] for x in batch)
    ref_res, ref_grads, eps = _jax_step("self_match", tree, sub, "pallas", "bfloat16")
    eps_hook(eps)
    res, grads = _port_step("self_match", tree, sub, "bfloat16")
    losses = {k: abs(res[k] - ref_res[k]) / abs(ref_res[k])
              for k in ("loss", "loss_kl", "loss_cmd", "loss_args")}
    kl = losses.pop("loss_kl")
    ours, theirs = _leaves(grads), _leaves(ref_grads)
    a = np.concatenate([ours[k].ravel() for k in sorted(ours)]).astype(np.float64)
    b = np.concatenate([theirs[k].ravel() for k in sorted(ours)]).astype(np.float64)
    norm_rel = abs(np.linalg.norm(a) - np.linalg.norm(b)) / np.linalg.norm(b)
    cosine = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    print(f"bf16 step vs JAX's Pallas step: relative loss differences {losses}, loss_kl "
          f"{kl:.3g}, norm {norm_rel:.3g}, cosine {cosine:.5f}")
    assert max(losses.values()) <= 1e-2, losses
    assert kl <= 2.0 ** -6                               # two bfloat16 steps
    assert norm_rel <= 2e-2
    assert cosine >= 0.998


# ------------------------------------------------------- (f) weight bridge

def test_weight_bridge_round_trip(params):
    """The JAX tree in and out again to the bit, every leaf used once; a
    tree with the ordered model's position table or without the VAE's
    sigma head raises."""
    tree = params["self_match"]
    model = _port_model("self_match", tree)
    back, ref = _leaves(to_flax_params(model)), _leaves(tree)
    assert set(back) == set(ref)
    assert not any(k.startswith(("bottleneck", "encoder/hierarchical_PE")) for k in back)
    for k in ref:
        assert back[k].dtype == np.float32 and np.array_equal(back[k], ref[k]), k
    extra = dict(tree, encoder=dict(tree["encoder"],
                                    hierarchical_PE=params["ordered_vae"]["encoder"]
                                    ["hierarchical_PE"]))
    with pytest.raises(ValueError, match="unused"):
        load_flax_params(SVGTransformer(_port_cfg("self_match")), extra)
    missing = dict(tree, vae={"enc_mu_fcn": tree["vae"]["enc_mu_fcn"]})
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(SVGTransformer(_port_cfg("self_match")), missing)
    ordered = _port_model("ordered_vae", params["ordered_vae"])
    assert set(_leaves(to_flax_params(ordered))) == set(_leaves(params["ordered_vae"]))


# ----------------------------------------------------- KL term, VAE, config

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kl_term_matches_jax(dtype):
    """The KL term keeps the VAE's type, as in the JAX package: elementwise
    in ``dtype``, the mean summed in float32 and rounded back, then the
    clip. bfloat16 read: within one bfloat16 step of JAX's."""
    rng = np.random.default_rng(11)
    out = {"tgt_commands": rng.integers(0, 7, (2, G, S + 1)).astype(np.int32),
           "tgt_args": rng.integers(-1, 256, (2, G, S + 1, 11)).astype(np.int32),
           "command_logits": rng.normal(size=(2, G, S, 7)).astype(np.float32),
           "visibility_logits": rng.normal(size=(2, G, 2)).astype(np.float32),
           "args_ce": rng.random((2, G, S, 11)).astype(np.float32),
           "mu": (0.5 * rng.normal(size=(2, 64))).astype(np.float32),
           "logsigma": (0.5 * rng.normal(size=(2, 64))).astype(np.float32)}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    cfg = _jax_cfg("self_match", dtype=dtype)
    for tol in (0.1, 0.5):
        w = dict(WEIGHTS, kl_tolerance=tol)
        ref = jax_svg_loss({k: jnp.asarray(v).astype(jdt) if k in ("mu", "logsigma")
                            else jnp.asarray(v) for k, v in out.items()}, w, cfg)
        res = svg_loss({k: torch.from_numpy(v).to(tdt) if k in ("mu", "logsigma")
                        else torch.from_numpy(v) for k, v in out.items()}, w,
                       _port_cfg("self_match", dtype))
        assert res["loss_kl"].dtype == tdt
        step = 2.0 ** -7 * abs(float(ref["loss_kl"])) if dtype == "bfloat16" else 1e-6
        print(f"{dtype} kl_tolerance {tol}: loss_kl {float(res['loss_kl'])} vs "
              f"{float(ref['loss_kl'])}")
        for k in ref:
            np.testing.assert_allclose(float(res[k]), float(ref[k]), rtol=1e-5,
                                       atol=step if k in ("loss", "loss_kl") else 1e-6,
                                       err_msg=k)


def test_vae_configs_build_and_initialise():
    from deepsvg_tpu_torch.configs import default_icons, hierarchical_self_matching
    from deepsvg_tpu_torch.training.config import load_config
    cfg = load_config("deepsvg_tpu_torch.configs.hierarchical_self_matching", 1)
    assert isinstance(cfg, hierarchical_self_matching.Config)
    m = cfg.model_cfg
    assert (cfg.batch_size, cfg.learning_rate, m.compute_dtype) == (60, 1e-3, "bfloat16")
    assert m.self_match and m.use_vae and m.n_groups_prop == G and m.dropout == 0.1
    assert cfg.get_weights(5000, 0)["loss_kl_weight"] == pytest.approx(5.0)
    assert default_icons.make_model_config().use_vae
    model = SVGTransformer(dataclasses.replace(m, d_model=64, dim_feedforward=128, dim_z=64,
                                               n_layers=1, n_layers_decode=1))
    assert model.encoder.hierarchical_PE is None and not hasattr(model, "bottleneck")
    create_train_state(model, make_optimizer(constant(LR)), seed=3)
    for head in (model.vae.enc_mu_fcn, model.vae.enc_sigma_fcn):
        assert 0.0005 < float(head.weight.std()) < 0.0015 and not head.bias.any()
    assert float(model.resnet.linears[0].weight.std()) > 0.1     # LeCun: 1 / sqrt(64)


def test_vae_noise_is_fixed_at_evaluation_and_sampling(batch, params):
    """eval_step and one_shot_sample draw the VAE's noise from a fixed
    generator: the result does not depend on the step generator; training
    draws from the state's generator, so two steps differ."""
    model = _port_model("self_match", params["self_match"])
    state = create_train_state(model, make_optimizer(constant(LR)), init=False)
    b = {"commands": torch.from_numpy(batch[0]), "args": torch.from_numpy(batch[1])}
    first = eval_step(state, b, WEIGHTS, MODEL_ARGS)
    state.generator.manual_seed(99)
    again = eval_step(state, b, WEIGHTS, MODEL_ARGS)
    assert all(torch.equal(first[k], again[k]) for k in first)
    c1, a1 = one_shot_sample(model, *_tensors(batch)[:2])
    c2, a2 = one_shot_sample(model, *_tensors(batch)[:2])
    assert torch.equal(c1, c2) and torch.equal(a1, a2) and c1.shape == (N, G, S + 1)
    with torch.no_grad():
        z_mu, mu, _ = model.encode(*_tensors(batch)[:2], sample_vae=False)
        z, _, _ = model.encode(*_tensors(batch)[:2], rng=DropoutRng.fixed())
    assert torch.equal(z_mu, mu) and not torch.equal(z, mu)
    with pytest.raises(ValueError, match="rng"):
        model.encode(*_tensors(batch)[:2])


# ------------------------------------------------------------ (g) the CLI

def test_train_cli_self_match_resumes_bit_exact(tmp_path):
    """``train()`` on a small self-match config with dropout 0.1 (the VAE's
    noise and the dropout masks both from the step generator): the losses
    are finite and the KL term is logged; 4 steps, save, resume to 6 equals
    6 steps without a stop, to the bit."""
    import test_torch_port_runtime as runtime_test

    from deepsvg_tpu_torch.training.config import TrainConfig
    from deepsvg_tpu_torch.training.train import train

    def cfg():
        kw = dict(runtime_test._model_kwargs(dropout=0.1), **VARIANTS["self_match"])
        return runtime_test._configure(TrainConfig(1), ModelConfig(**kw), None)
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
