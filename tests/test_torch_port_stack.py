"""K7 (the fused training stack) and the stack path of the port's model,
against the JAX package, on the CPU.

The port's kernels run as their plain versions here (CPU tensors). Held:

- the plain version of K7 against the JAX package's ``fused_stack_train``
  (its Pallas kernels in interpret mode), float32, rate 0: forward within
  1e-5 absolute, each of the twelve gradients within 1e-4 of its leaf's
  largest entry (float32 sums in another order through two or three layers);
- with dropout on, K7 against the chain of the port's own K4 with the
  per-layer seeds, to the bit (the contract the card's comparison rests on);
- the gate: the port's stacks take K7 exactly where the JAX package's
  ``_use_stack_fused`` is true;
- the bfloat16 training step at N=2 against the JAX package's bfloat16 step
  on its Pallas path, which takes the stack at that batch;
- the launch plan of K7's cluster kernels (``stack_launch_plan``, pure
  Python): at the recipe batch at least half of the H100's SMs, and over the
  whole contract no block over the shared memory a block can use;
- the plain version's ``round_grads`` switch (the reference chip_smoke holds
  K7's gradients to): the forward and float32 gradients unchanged to the
  bit, bfloat16 gradients moved by about one rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu.models import layers as jax_layers
from deepsvg_tpu.ops.stack_vjp import fused_stack_train as jax_fused_stack_train
from deepsvg_tpu_torch.models import layers as port_layers
from deepsvg_tpu_torch.ops import layer_vjp, stack_vjp
from deepsvg_tpu_torch.ops.dropout import stack_layer_seed

D, H, FF, B, S = 64, 2, 128, 4, 8
FWD_TOL = 1e-5           # absolute, outputs of order 1
GRAD_TOL = 1e-4          # of each leaf's largest entry
NAMES = ("x", "seq_bias", "ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "w1", "b1", "w2", "b2")


def _inputs(rng, n_layers):
    """x, bias [L, B, D], the ten stacked weights in the port's layout, a key
    mask with one fully masked sequence, and the output gradient."""
    f = lambda *shape, scale=1.0: (scale * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    ln = lambda: np.stack([1 + f(n_layers, D, scale=0.1), f(n_layers, D, scale=0.1)], 1)  # noqa: E731
    weights = [ln(), f(n_layers, 3 * D, D, scale=D ** -0.5), f(n_layers, 3 * D, scale=0.1),
               f(n_layers, D, D, scale=D ** -0.5), f(n_layers, D, scale=0.1), ln(),
               f(n_layers, FF, D, scale=D ** -0.5), f(n_layers, FF, scale=0.1),
               f(n_layers, D, FF, scale=FF ** -0.5), f(n_layers, D, scale=0.1)]
    lengths = rng.integers(1, S + 1, B)
    lengths[0] = 0
    mask = np.where(np.arange(S)[None] < lengths[:, None], 0.0, -np.inf).astype(np.float32)
    return f(B, S, D), f(n_layers, B, D), weights, mask, f(B, S, D)


def _to_jax_layout(weights):
    """nn.Linear [out, in] -> flax [in, out]; biases [L, 1, n]."""
    ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2 = weights
    t = lambda w: np.ascontiguousarray(np.swapaxes(w, 1, 2))  # noqa: E731
    return [ln1, t(wqkv), bqkv[:, None], t(wo), bo[:, None], ln2, t(w1), b1[:, None], t(w2),
            b2[:, None]]


def _from_jax_layout(grads):
    ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2 = grads
    t = lambda w: np.swapaxes(w, 1, 2)  # noqa: E731
    return [ln1, t(wqkv), bqkv[:, 0], t(wo), bo[:, 0], ln2, t(w1), b1[:, 0], t(w2), b2[:, 0]]


@pytest.mark.parametrize("n_layers,causal", [(2, False), (3, True)])
def test_stack_plain_matches_jax_pallas(n_layers, causal):
    rng = np.random.default_rng(n_layers)
    x, bias, weights, mask, g = _inputs(rng, n_layers)

    def jax_fn(x, bias, *ws):
        return jax_fused_stack_train(x, bias, *ws, jnp.asarray(mask), jnp.zeros((1,), jnp.int32),
                                     H, causal, 0.0)
    jax_args = [jnp.asarray(a) for a in (x, bias, *_to_jax_layout(weights))]
    ref, vjp = jax.vjp(jax.jit(jax_fn), *jax_args)
    (ref_dx, ref_dbias, *ref_dw) = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    ref_grads = [ref_dx, ref_dbias, *_from_jax_layout(ref_dw)]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, bias, *weights)]
    out = stack_vjp.fused_stack_train(*leaves, torch.from_numpy(mask), 0, H, causal, 0.0)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)
    for name, got, want in zip(NAMES, grads, ref_grads):
        assert got.shape == want.shape, name
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_TOL, (name, err)


def test_stack_with_dropout_is_the_k4_chain():
    """Layer l of the stack is K4 with the seed stack_layer_seed(seed, l):
    forward and every gradient equal to the bit, dropout 0.1; the layers'
    seeds differ, and so do their masks."""
    n_layers, seed, rate = 3, 987, 0.1
    x, bias, weights, mask, g = _inputs(np.random.default_rng(9), n_layers)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, bias, *weights)]
    mask_t = torch.from_numpy(mask)
    out = stack_vjp.fused_stack_train(*leaves, mask_t, seed, H, False, rate)
    y = leaves[0]
    for layer in range(n_layers):
        y = layer_vjp.fused_layer_train(y, leaves[1][layer], *[w[layer] for w in leaves[2:]],
                                        mask_t, stack_layer_seed(seed, layer), H, False, rate)
    assert torch.equal(out, y)
    for name, a, b in zip(NAMES, torch.autograd.grad(out, leaves, torch.from_numpy(g)),
                          torch.autograd.grad(y, leaves, torch.from_numpy(g))):
        assert torch.equal(a, b), name
    seeds = [stack_layer_seed(seed, layer) for layer in range(n_layers)]
    assert len(set(seeds)) == n_layers and all(0 <= s < 2 ** 31 for s in seeds)
    no_drop = stack_vjp.fused_stack_train(*leaves, mask_t, seed, H, False, 0.0)
    assert not torch.equal(out, no_drop)


class _Spy:
    """Counts the calls of a module-level function that models/layers.py
    reaches through its module."""

    def __init__(self, monkeypatch, module, name):
        self.calls, fn = 0, getattr(module, name)

        def spy(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("b,s,n_layers,deterministic", [
    (64, 8, 2, False), (65, 8, 2, False), (64, 8, 2, True), (64, 8, 1, False),
    (32, 16, 2, False), (33, 16, 2, False), (16, 17, 2, False), (2, 8, 4, False)])
def test_stacks_take_k7_where_jax_does(monkeypatch, b, s, n_layers, deterministic):
    """B x 8 = 512 rows: the stack; 520: layer by layer; at inference and
    for one layer, never. Counted on CPU tensors by spying on the two
    training entry points."""
    expected = jax_layers._use_stack_fused("pallas", deterministic, n_layers, b, s)
    assert port_layers.use_stack_fused(deterministic, n_layers, b, s) == expected
    stack = _Spy(monkeypatch, port_layers.stack_vjp, "fused_stack_train")
    layer = _Spy(monkeypatch, port_layers.layer_vjp, "fused_layer_train")
    torch.manual_seed(0)
    enc = port_layers.EncoderStack(n_layers, D, H, FF, dropout=0.0)
    dec = port_layers.DecoderStack(n_layers, D, H, FF, dim_z=16, dropout=0.0)
    x = torch.randn(b, s, D)
    mask = torch.zeros(b, s)
    with torch.set_grad_enabled(not deterministic):
        enc(x, mask, deterministic)
        dec(x, torch.randn(b, 16), deterministic)
    if deterministic:
        assert (stack.calls, layer.calls) == (0, 0)
    else:
        assert (stack.calls, layer.calls) == ((2, 0) if expected else (0, 2 * n_layers))


def test_stack_path_runs_e2_in_the_compute_dtype(monkeypatch):
    """Where the gate is true the stack takes bfloat16 activations even when
    its input is float32 (E2's pooled input), and gives back float32."""
    torch.manual_seed(0)
    enc = port_layers.EncoderStack(2, D, H, FF, dropout=0.0, compute_dtype=torch.bfloat16)
    seen = []
    fn = stack_vjp.fused_stack_train

    def spy(x, *args):
        out = fn(x, *args)
        seen.append((x.dtype, out.dtype))
        return out
    monkeypatch.setattr(stack_vjp, "fused_stack_train", spy)
    y = enc(torch.randn(4, S, D), torch.zeros(4, S), deterministic=False)
    assert seen == [(torch.bfloat16, torch.bfloat16)] and y.dtype == torch.bfloat16
    y = port_layers.stacked_train(enc.layers, torch.randn(4, S, D), None, torch.zeros(4, S),
                                  False, None)
    assert y.dtype == torch.float32


SMEM_LIMIT = 232448   # the shared memory an H100 block can use


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stack_launch_plan_fills_the_card_at_the_recipe_batch(dtype):
    """At the flagship's E2 and D2 (B=60, S=8, D=256, F=512, 8 heads) the
    cluster kernels take the stack: a cluster of one block a head for each
    tile of whole sequences (32 rows in bfloat16, 16 in float32), at least 64
    blocks, half of the H100's 132 SMs; at the gate's edge B=64 still one
    wave of 128 blocks in bfloat16."""
    plan = stack_vjp.stack_launch_plan(60, 8, 256, 512, 8, dtype)
    rows = {torch.bfloat16: 32, torch.float32: 16}[dtype]
    assert plan["takes"] and plan["cluster"] == 8 and plan["tile_rows"] == rows
    assert plan["seqs_per_tile"] == rows // 8 and plan["tiles"] == -(-60 // (rows // 8))
    assert plan["grid"] == 8 * plan["tiles"] >= 64
    assert max(plan["fwd_smem"], plan["bwd_smem"]) <= SMEM_LIMIT
    if dtype == torch.bfloat16:
        assert stack_vjp.stack_launch_plan(64, 8, 256, 512, 8, dtype)["grid"] == 128


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_stack_launch_plan_over_the_contract(dtype, d):
    """Over K7's contract (D a multiple of 64 up to 256, heads of 32, F a
    multiple of 64 up to 2,048, S up to 32 in bfloat16 and 16 in float32, B
    from 1 to 128): no block of the plan exceeds 232,448 bytes of shared
    memory; a tile holds whole sequences and the tiles cover the batch once;
    the cluster is one block a head (2 to 8, the portable size); the grid is
    tiles x cluster; the cluster kernels take exactly the widths whose F is a
    multiple of D, whose blocks fit and whose layer vectors (LayerNorms and a
    block's bias columns) take at most 6 values a thread (the older kernels
    run the rest), the
    shipped widths at F=512 among them (D=256, and D=128 as the card tests
    run it)."""
    heads = d // 32
    max_seq = 32 if dtype == torch.bfloat16 else 16
    for f in range(64, 2049, 64):
        for s in range(1, max_seq + 1):
            for b in (1, 7, 60, 64, 128):
                plan = stack_vjp.stack_launch_plan(b, s, d, f, heads, dtype)
                smem = max(plan["fwd_smem"], plan["bwd_smem"])
                assert plan["fwd_smem"] % 128 == 0 and plan["bwd_smem"] % 128 == 0
                vectors = 4 * d + 5 * 32 + f // heads   # a layer's LN and bias columns
                assert plan["takes"] == (f % d == 0 and smem <= SMEM_LIMIT
                                         and vectors <= 6 * 256), (f, s, b)
                assert plan["cluster"] == heads and 2 <= heads <= 8
                seqs = plan["seqs_per_tile"]
                assert seqs >= 1 and seqs * s <= plan["tile_rows"]
                assert (plan["tiles"] - 1) * seqs < b <= plan["tiles"] * seqs
                assert plan["grid"] == plan["tiles"] * heads
    assert stack_vjp.stack_launch_plan(60, 8, d, 512, heads, dtype)["takes"] == (512 % d == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_round_grads_rounds_the_backward_only(dtype):
    """``round_grads`` (chip_smoke's reference for K7's gradients) leaves the
    forward as it is and, in float32, the gradients to the bit; in bfloat16
    it rounds df, dhpre, da and ds before their products, which moves the
    gradients by about a bfloat16 rounding and no more."""
    rng = np.random.default_rng(16)
    x, bias, weights, mask, g = _inputs(rng, 2)
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, bias)]
    masters = [torch.from_numpy(w).requires_grad_() for w in weights]
    call = (*leaves, *masters, torch.from_numpy(mask), 7, H, False, 0.1, dtype)
    out = stack_vjp.plain_stack_train(*call)
    out_r = stack_vjp.plain_stack_train(*call, round_grads=True)
    assert torch.equal(out, out_r)
    gy = torch.from_numpy(g).to(dtype)
    grads = torch.autograd.grad(out, leaves + masters, gy)
    grads_r = torch.autograd.grad(out_r, leaves + masters, gy)
    for name, a, r in zip(NAMES, grads, grads_r):
        if dtype == torch.float32:
            assert torch.equal(a, r), name
        else:
            rms = ((a.float() - r.float()).norm() / a.float().norm()).item()
            assert rms <= 2.0 ** -6, (name, rms)
    if dtype == torch.bfloat16:
        assert not all(torch.equal(a, r) for a, r in zip(grads, grads_r))


@pytest.fixture(scope="module")
def trained():
    from flax import serialization

    from deepsvg_tpu_torch.data import generate_batch
    batch = generate_batch(np.random.default_rng(0), 2)
    with open("docs/artifacts/full_run_final_params.msgpack", "rb") as f:
        params = serialization.msgpack_restore(f.read())
    return (batch["commands"], batch["args"]), params


def _bf16_step_readings(train_test, batch, ref_res, ref_grads):
    """The port's bfloat16 step against the JAX package's: each loss term's
    relative difference, the gradient norms' and the whole-gradient cosine."""
    from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, to_flax_params
    from deepsvg_tpu_torch.training import train_step
    state, optimizer = train_test._port_state(gpu_fast(hierarchical_ordered()))
    state, res = train_step(state, train_test._port_batch(batch), train_test.WEIGHTS,
                            optimizer, train_test.MODEL_ARGS)
    ours = train_test._leaves(to_flax_params(state.model, grads=True))
    theirs = train_test._leaves(ref_grads)
    a = np.concatenate([ours[k].ravel() for k in sorted(ours)]).astype(np.float64)
    b = np.concatenate([theirs[k].ravel() for k in sorted(ours)]).astype(np.float64)
    losses = {k: abs(float(res[k]) - float(ref_res[k])) / abs(float(ref_res[k]))
              for k in ("loss", "loss_cmd", "loss_args")}
    return (losses, abs(np.linalg.norm(a) - np.linalg.norm(b)) / np.linalg.norm(b),
            float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)))


def test_bfloat16_step_matches_jax_pallas_stack_path(monkeypatch, trained):
    """One step in the card's profile at N=2, where both packages' E2 and D2
    take the stack (2 x 8 rows), against the JAX package's bfloat16 step on
    its Pallas path (kernels in interpret mode), with the limits of the
    bfloat16 step test in test_torch_port_train.py: each loss term within 1%,
    the global gradient norm within 2%, whole-gradient cosine at least 0.998.

    The step is also taken as the port took it before its stack path ran E2
    in the compute type (the gate forced false: E2 on float32 activations),
    and both readings are printed. Read: before, the loss terms within 0.41%
    (loss_cmd), the norm 0.18%, cosine 0.99915; after, 0.09% (loss_args),
    0.26%, 0.99926."""
    import test_torch_port_train as train_test
    batch, params = trained
    ref_res, ref_grads, _ = train_test._jax_run("pallas", params, batch, 1, "bfloat16")
    with monkeypatch.context() as m:
        m.setattr(port_layers, "use_stack_fused", lambda *args: False)
        before = _bf16_step_readings(train_test, batch, ref_res, ref_grads)
    seen = []
    fn = stack_vjp.fused_stack_train

    def spy(x, *args):
        seen.append(x.dtype)
        return fn(x, *args)
    monkeypatch.setattr(stack_vjp, "fused_stack_train", spy)
    losses, norm_rel, cosine = _bf16_step_readings(train_test, batch, ref_res, ref_grads)
    print(f"bf16 step vs JAX's Pallas stack path: E2 in float32 (before) losses "
          f"{before[0]}, norm {before[1]:.3g}, cosine {before[2]:.5f}; through the stack "
          f"(after) losses {losses}, norm {norm_rel:.3g}, cosine {cosine:.5f}")
    assert seen == [torch.bfloat16] * 2                    # E2 and D2
    assert max(losses.values()) <= 1e-2, losses
    assert norm_rel <= 2e-2
    assert cosine >= 0.998
