"""The port at head dims 8 and 16 against the JAX package, on the CPU.

The JAX kernels take any ``d_model // n_heads``, and the JAX package's own
tests run them at head dims 8 and 16: K2 and K4 at D=32 with 4 heads and FF
64 (``tests/test_ops.py``), K7 at D=32 with 4 heads (``tests/test_stack_fused.py``),
K9 on the two-layer D=32 model, K10 and K11 at D=64 with 4 heads and D=32
with 2 heads. Here the port's plain versions (what a wrapper runs for a CPU
tensor) are held against those Pallas kernels in interpret mode at the same
shapes, float32 inputs made from a numpy seed. Stated tolerances: 2e-5
absolute for float32 forwards (outputs of order 1), 1e-4 of each gradient's
largest entry, float32 sums in another order.

Also here: each kernel family's routing rule (``layer_form``,
``layer_train_form``, ``stack_form``, ``decode_form``, ``mha_form``,
``mha_train_form``) names a kernel for every one of these shapes, and the
softmax scale every launch passes is ``(D // n_heads) ** -0.5``. The tiny
config's whole model at this width (D=32, 4 heads of 8, FF 64, 1 + 1
layers) is held against the JAX package elsewhere: its encode and decode in
``test_torch_port_apps.py`` and ``test_torch_port_serving.py``, its step in
``test_torch_port_parallel.py`` (``make_parallel_train_step``).
"""
import ast
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu.ops import layer as jax_layer
from deepsvg_tpu.ops import layer_vjp as jax_layer_vjp
from deepsvg_tpu.ops.attention import fused_mha as jax_fused_mha
from deepsvg_tpu.ops.attention_vjp import fused_mha_train as jax_fused_mha_train
from deepsvg_tpu.ops.decode import fused_decode_step as jax_fused_decode_step
from deepsvg_tpu.ops.stack_vjp import fused_stack_train as jax_fused_stack_train
from deepsvg_tpu_torch.models.weights import attention_operands
from deepsvg_tpu_torch.ops import attention as port_attention
from deepsvg_tpu_torch.ops import attention_vjp as port_attention_vjp
from deepsvg_tpu_torch.ops import decode as port_decode
from deepsvg_tpu_torch.ops import layer as port_layer
from deepsvg_tpu_torch.ops import layer_vjp as port_layer_vjp
from deepsvg_tpu_torch.ops import stack_vjp as port_stack_vjp

D, H, FF = 32, 4, 64          # head dim 8: the JAX tests' K2, K4, K7 and K9 width
FWD_TOL = 2e-5                # float32 forwards, absolute
GRAD_TOL = 1e-4               # gradients, of each one's largest entry
NAMES = ("x", "seq_bias", "ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "w1", "b1", "w2", "b2")
TRANSPOSED = {"wqkv", "wo", "w1", "w2"}     # stored [out, in] in the port
MHA_WIDTHS = [(64, 4), (32, 2)]             # head dim 16, as tests/test_ops.py's K10 and K11


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _n(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _key_mask(rng, b, s, masked_seq=True):
    lengths = rng.integers(1, s + 1, b)
    if masked_seq:
        lengths[0] = 0                          # one sequence with every key masked
    return np.where(np.arange(s)[None] < lengths[:, None], 0.0, -np.inf).astype(np.float32)


def _layer_vals(rng, b, s):
    """The fused layer's operands in the JAX layout (kernels ``[in, out]``)."""
    ln = lambda: np.stack([1 + _n(rng, D, scale=0.1), _n(rng, D, scale=0.1)])  # noqa: E731
    return dict(x=_n(rng, b, s, D), seq_bias=_n(rng, b, D, scale=0.3), ln1=ln(),
                wqkv=_n(rng, D, 3 * D, scale=D ** -0.5), bqkv=_n(rng, 3 * D, scale=0.1),
                wo=_n(rng, D, D, scale=D ** -0.5), bo=_n(rng, D, scale=0.1), ln2=ln(),
                w1=_n(rng, D, FF, scale=D ** -0.5), b1=_n(rng, FF, scale=0.1),
                w2=_n(rng, FF, D, scale=FF ** -0.5), b2=_n(rng, D, scale=0.1))


def _port(vals, grad=False):
    return [_t(vals[k].T if k in TRANSPOSED else vals[k], grad) for k in NAMES]


def _close_grads(got, want, what=""):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w).reshape(g.shape)
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max()) / scale
        assert err <= GRAD_TOL, (what, name, err)


# ------------------------------------------------------------------ K2, K4

@pytest.mark.parametrize("s,causal", [(8, False), (40, True)])
def test_layer_matches_pallas_at_head_dim_8(s, causal):
    """K2's plain version against the Pallas kernel at D=32, 4 heads, FF 64,
    with seq_bias, key padding and a fully masked sequence; S=40 (causal) is
    a length of the long form."""
    rng = np.random.default_rng(s)
    vals = _layer_vals(rng, 4, s)
    mask = _key_mask(rng, 4, s)
    run = jax.jit(lambda *a: jax_layer.fused_layer(*a, n_heads=H, tile_b=2, causal=causal))
    ref = run(*(jnp.asarray(vals[k]) for k in NAMES), jnp.asarray(mask))
    out = port_layer.fused_layer(*_port(vals), _t(mask), H, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("s,causal", [(8, False), (40, True)])
def test_layer_train_matches_pallas_at_head_dim_8(s, causal):
    """K4's plain version, forward and its twelve gradients at dropout 0,
    against the Pallas kernel (the JAX test's D=32, 4 heads, FF 64)."""
    rng = np.random.default_rng(10 + s + causal)
    b = 8
    vals = _layer_vals(rng, b, s)
    mask = _key_mask(rng, b, s)
    g = _n(rng, b, s, D)

    def run(*args):
        return jax_layer_vjp.fused_layer_train(
            *args, jnp.asarray(mask), jnp.zeros((1,), jnp.int32), H, 4, causal, 0.0, None,
            False, True)
    ref, vjp = jax.vjp(jax.jit(run), *(jnp.asarray(vals[k]) for k in NAMES))
    ref_grads = vjp(jnp.asarray(g))
    leaves = _port(vals, grad=True)
    out = port_layer_vjp.fused_layer_train(*leaves, _t(mask), 0, H, causal, 0.0)
    grads = torch.autograd.grad(out, leaves, _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)
    _close_grads([gr.T if k in TRANSPOSED else gr for k, gr in zip(NAMES, grads)], ref_grads)


# ------------------------------------------------------------------------ K7

@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_stack_matches_pallas_at_head_dim_8(causal):
    """K7's plain version at L=2 (D=32, 4 heads: tests/test_stack_fused.py's
    width), forward and twelve gradients at dropout 0."""
    rng = np.random.default_rng(20 + causal)
    n_layers, b, s = 2, 8, 8
    layer_vals = [_layer_vals(rng, b, s) for _ in range(n_layers)]
    x = _n(rng, b, s, D)
    bias = _n(rng, n_layers, b, D, scale=0.1)
    mask = _key_mask(rng, b, s)
    g = _n(rng, b, s, D)
    stacked = {k: np.stack([v[k] for v in layer_vals]) for k in NAMES[2:]}
    jax_w = [stacked[k][:, None] if k in ("bqkv", "bo", "b1", "b2") else stacked[k]
             for k in NAMES[2:]]

    def run(x_, bias_, *ws):
        return jax_fused_stack_train(x_, bias_, *ws, jnp.asarray(mask),
                                     jnp.zeros((1,), jnp.int32), H, causal, 0.0)
    ref, vjp = jax.vjp(jax.jit(run), *(jnp.asarray(a) for a in (x, bias, *jax_w)))
    ref_grads = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    ref_grads = ref_grads[:2] + [r[:, 0] if k in ("bqkv", "bo", "b1", "b2") else r
                                 for k, r in zip(NAMES[2:], ref_grads[2:])]
    leaves = [_t(x, True), _t(bias, True)] + [
        _t(np.swapaxes(stacked[k], 1, 2) if k in TRANSPOSED else stacked[k], True)
        for k in NAMES[2:]]
    out = port_stack_vjp.fused_stack_train(*leaves, _t(mask), 0, H, causal, 0.0)
    grads = torch.autograd.grad(out, leaves, _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)
    _close_grads([np.swapaxes(gr.numpy(), 1, 2) if k in TRANSPOSED else gr
                  for k, gr in zip(NAMES, grads)], ref_grads)


# ------------------------------------------------------------------------ K9

# one compile for both indices (the index is an operand)
_jax_decode_step = jax.jit(lambda *a: jax_fused_decode_step(*a, n_heads=H, tile_r=8))


@pytest.mark.parametrize("index", [1, 10])
def test_decode_step_matches_pallas_at_head_dim_8(index):
    """K9's plain version on the two-layer D=32, 4-head stack (the JAX test's
    SMALL decoder) at index 1 and at the cache's last position."""
    rng = np.random.default_rng(30 + index)
    n_layers, r, t = 2, 8, 11
    ln = lambda: np.stack([1 + _n(rng, n_layers, D, scale=0.1),  # noqa: E731
                           _n(rng, n_layers, D, scale=0.1)], 1)
    x, seq_bias = _n(rng, r, D), _n(rng, n_layers, r, D, scale=0.3)
    ln1, ln2, lnf = ln(), ln(), np.stack([1 + _n(rng, D, scale=0.1), _n(rng, D, scale=0.1)])
    wqkv, bqkv = _n(rng, n_layers, D, 3 * D, scale=D ** -0.5), _n(rng, n_layers, 3 * D, scale=0.1)
    wo, bo = _n(rng, n_layers, D, D, scale=D ** -0.5), _n(rng, n_layers, D, scale=0.1)
    w1, b1 = _n(rng, n_layers, D, FF, scale=D ** -0.5), _n(rng, n_layers, FF, scale=0.1)
    w2, b2 = _n(rng, n_layers, FF, D, scale=FF ** -0.5), _n(rng, n_layers, D, scale=0.1)
    kc, vc = _n(rng, n_layers, r, t, D), _n(rng, n_layers, r, t, D)
    key_pad = np.zeros((r, t), np.float32)
    key_pad[1, 3:] = -np.inf
    ref = _jax_decode_step(*(jnp.asarray(v) for v in (x, seq_bias, ln1, wqkv, bqkv[:, None], wo, bo[:, None],
                                          ln2, w1, b1[:, None], w2, b2[:, None], lnf, kc, vc,
                                          key_pad)), jnp.asarray([index], jnp.int32))
    tr = lambda v: _t(v.transpose(0, 2, 1))  # noqa: E731
    ours = port_decode.fused_decode_step(
        _t(x), _t(seq_bias), _t(ln1), tr(wqkv), _t(bqkv), tr(wo), _t(bo), _t(ln2), tr(w1),
        _t(b1), tr(w2), _t(b2), _t(lnf), _t(kc), _t(vc), _t(key_pad), index, H)
    for name, o, rf in zip(("y", "k_new", "v_new"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(rf), atol=FWD_TOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------- K10, K11

def _mha_inputs(seed, b, s, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = [(rng.standard_normal(shape) * 0.05).astype(np.float32)
         for shape in ((d, 3 * d), (3 * d,), (d, d), (d,))]
    mask = np.zeros((b, s), np.float32)
    mask[:, max(s - 6, 1):] = -np.inf
    return x, w, mask


@pytest.mark.parametrize("d,heads", MHA_WIDTHS)
@pytest.mark.parametrize("s", [31])
def test_mha_matches_pallas_at_head_dim_16(d, heads, s):
    """K10's plain version against the Pallas kernel at the JAX tests'
    widths (head dim 16), trailing key padding, float32."""
    x, w, mask = _mha_inputs(s + d, 16, s, d)
    run = jax.jit(lambda *a: jax_fused_mha(*a, n_heads=heads, tile_b=4))
    ref = run(*(jnp.asarray(a) for a in (x, *w, mask)))
    got = port_attention.fused_mha(_t(x), *attention_operands(*w), _t(mask), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("d,heads", MHA_WIDTHS)
def test_mha_train_matches_pallas_at_head_dim_16(d, heads):
    """K11's plain version, forward and its five gradients (of ``sum(out **
    2)``) at dropout 0, against the Pallas forward and backward."""
    x, w, mask = _mha_inputs(40 + d, 8, 8, d)
    seed = jnp.asarray([0], jnp.int32)

    def f(*a):
        return jax_fused_mha_train(*a, jnp.asarray(mask), seed, heads, 4, False, 0.0)
    ref, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a) for a in (x, *w)))
    ref_grads = vjp(2 * ref)                    # the gradients of sum(out ** 2)
    xt = _t(x, True)
    ops = [t.requires_grad_() for t in attention_operands(*w)]
    out = port_attention_vjp.fused_mha_train(xt, *ops, _t(mask), 0, heads, False, 0.0)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)
    got = [xt.grad.numpy(), ops[0].grad.numpy().T, ops[1].grad.numpy(), ops[2].grad.numpy().T,
           ops[3].grad.numpy()]
    for name, g, r in zip(("x", "wqkv", "bqkv", "wo", "bo"), got, ref_grads):
        r = np.asarray(r)
        assert float(np.abs(g - r).max()) <= GRAD_TOL * float(np.abs(r).max()), name


# ------------------------------------------------------------- the routing rules

# (D, heads, F) at head dims 8, 16 and 32 below the Hopper forms' widths
NARROW_WIDTHS = [(32, 4, 64), (64, 4, 128), (32, 2, 64), (128, 4, 512), (256, 16, 512)]


@pytest.mark.parametrize("d,heads,f", NARROW_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_every_family_names_a_kernel_and_the_scale(dtype, d, heads, f):
    """Each kernel family's rule names a CUDA form for these shapes before any
    launch (the first port's kernels, ``narrow``), and the softmax scale its
    launches pass is ``(D // n_heads) ** -0.5``."""
    hd = d // heads
    assert port_layer.softmax_scale(d, heads) == hd ** -0.5
    for s, form in ((1, "narrow"), (8, "narrow"), (32, "narrow"), (40, "narrow_long"),
                    (241, "narrow_long")):
        assert port_layer.layer_form(dtype, d, f, heads, s) == form, s
    short = 16 if dtype == torch.float32 else 32
    for s in (1, 8, short):
        assert port_layer_vjp.layer_train_form(dtype, d, f, heads, s) == "narrow", s
    for s in (short + 1, 40, 241):
        assert port_layer_vjp.layer_train_form(dtype, d, f, heads, s) == "narrow_long", s
    assert port_stack_vjp.stack_form(60, 8, d, f, heads, dtype) == (
        "cluster" if hd == 32 and f % d == 0 else "narrow")
    assert port_decode.decode_form(d, f, heads, dtype) == "narrow"
    for s in (8, 16, 31, 32, 40):
        assert port_attention.mha_form(dtype, d, heads, s) == "narrow"
        assert port_attention_vjp.mha_train_form(dtype, d, heads, s) == "narrow"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_hopper_widths_keep_their_forms(dtype):
    """D=256 with 8 heads of 32 keeps the Hopper forms in every family."""
    bf = dtype == torch.bfloat16
    assert port_layer.layer_form(dtype, 256, 512, 8, 32) == ("bf16" if bf else "f32")
    assert port_layer.layer_form(dtype, 256, 512, 8, 242) == ("bf16_long" if bf else "f32_long")
    assert port_layer_vjp.layer_train_form(dtype, 256, 512, 8, 8) == (
        "hopper" if bf else "hopper_long")
    assert port_layer_vjp.layer_train_form(dtype, 256, 512, 8, 242) == "hopper_long"
    assert port_stack_vjp.stack_form(60, 8, 256, 512, 8, dtype) == "cluster"
    assert port_decode.decode_form(256, 512, 8, dtype) == "cluster"
    assert port_attention.mha_form(dtype, 256, 8, 32) == ("bf16_short" if bf else "f32")


@pytest.mark.parametrize("rule", ["layer", "layer_train", "stack", "decode", "mha"])
def test_shapes_no_kernel_takes_raise_naming_the_limit(rule):
    """Head dims other than 32, 16 and 8 raise in every family, the message
    naming the head dims the kernels take; so do the widths' other limits."""
    bf16 = torch.bfloat16
    calls = {"layer": lambda d, h: port_layer.layer_form(bf16, d, 2 * d, h, 8),
             "layer_train": lambda d, h: port_layer_vjp.layer_train_form(bf16, d, 2 * d, h, 8),
             "stack": lambda d, h: port_stack_vjp.stack_form(60, 8, d, 2 * d, h, bf16),
             "decode": lambda d, h: port_decode.decode_form(d, 2 * d, h, bf16),
             "mha": lambda d, h: port_attention_vjp.mha_train_form(bf16, d, h, 8)}
    for d, heads in ((256, 4), (32, 8)):           # head dims 64 and 4
        with pytest.raises(ValueError, match="head dim 32, 16 or 8"):
            calls[rule](d, heads)
    # D=48 with 3 heads of 16: K2 takes it (D a multiple of 16); the families
    # whose weight products take warp tiles of 32 columns do not
    if rule == "layer":
        assert calls[rule](48, 3) == "narrow"
    else:
        with pytest.raises(ValueError, match="multiples? of 32"):
            calls[rule](48, 3)
    with pytest.raises(ValueError, match="bfloat16 layer kernels take D=256"):
        port_layer.layer_form(bf16, 256, 96, 8, 8)


def test_no_launch_passes_the_hopper_head_dim():
    """The fault the widening repaired: a launch that passed ``HEAD_DIM **
    -0.5`` (0.177 at head dim 32 where the JAX kernels use 0.354 at head dim
    8) or sized a saved tensor from ``3 * HEAD_DIM`` gives wrong attention
    at other head dims without crashing. No module of ``ops`` does either:
    the scale is ``softmax_scale(D, n_heads)`` and the widths ``head_dim``."""
    ops_dir = os.path.dirname(port_layer.__file__)
    for path in sorted(glob.glob(os.path.join(ops_dir, "*.py"))):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if not isinstance(node, ast.BinOp):
                continue
            operands = (node.left, node.right)
            head_dim = any(isinstance(n, ast.Name) and n.id == "HEAD_DIM" for n in operands)
            three = any(isinstance(n, ast.Constant) and n.value == 3 for n in operands)
            assert not (head_dim and (isinstance(node.op, ast.Pow) or three)), (
                os.path.basename(path), node.lineno)
