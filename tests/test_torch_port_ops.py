"""The PyTorch port's kernel modules against the JAX package, on the CPU.

Each plain PyTorch version (what a kernel wrapper runs for a CPU tensor) is
held against the JAX Pallas kernel it replaces (run in interpret mode, as
the JAX package's own tests run it on the CPU) and, for the layer, against
the JAX XLA layer. Inputs are float32 and made from a seed with numpy; the
tolerances are float32 rounding with the sums taken in another order.

Also here: the port's masks, synthetic data and msgpack reader against
their JAX-package counterparts, the device rule of the wrappers, and the
import purity of the port.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from deepsvg_tpu.data import synthetic as jax_synthetic
from deepsvg_tpu.models.layers import DecoderLayerGlobalImproved, EncoderLayerImproved
from deepsvg_tpu.ops import embedding as jax_embedding
from deepsvg_tpu.ops import head as jax_head
from deepsvg_tpu.ops import layer as jax_layer
from deepsvg_tpu.svgtensor import masks as jax_masks
from deepsvg_tpu_torch.data import synthetic as port_synthetic
from deepsvg_tpu_torch.models import checkpoint as port_checkpoint
from deepsvg_tpu_torch.ops import embedding as port_embedding
from deepsvg_tpu_torch.ops import head as port_head
from deepsvg_tpu_torch.ops import layer as port_layer
from deepsvg_tpu_torch.svgtensor import masks as port_masks

ARTIFACT = "docs/artifacts/full_run_final_params.msgpack"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- K1 embedding

@pytest.mark.parametrize("use_group", [False, True])
def test_embedding_matches_pallas(use_group):
    rng = np.random.default_rng(0)
    b, s, d, n_args, vocab, n_cmd, n_group = 4, 8, 32, 11, 257, 7, 10
    commands = rng.integers(0, n_cmd, (b, s)).astype(np.int32)
    args = rng.integers(-1, vocab - 1, (b, s, n_args)).astype(np.float32)
    groups = rng.integers(0, n_group, (b, s)).astype(np.int32)
    args[0, 0, :] = -1.0                        # PAD row -> table row 0
    commands[1, 2] = n_cmd + 2                  # out-of-range ids contribute zero
    args[1, 3, 4] = vocab + 5
    args[2, 1, 0] = -3.0
    groups[3, 5] = n_group
    cmd_t, grp_t, pos_t = (rng.normal(size=(n, d)).astype(np.float32)
                           for n in (n_cmd, n_group, s))
    arg_t = rng.normal(size=(n_args * vocab, d)).astype(np.float32)

    ref = jax_embedding.fused_embedding(
        jnp.asarray(commands), jnp.asarray(args), jnp.asarray(groups),
        jnp.asarray(cmd_t), jnp.asarray(arg_t), jnp.asarray(grp_t), jnp.asarray(pos_t),
        tile_b=2, use_group=use_group, out_dtype=jnp.float32)
    out = port_embedding.fused_embedding(
        _t(commands), _t(args), _t(groups), _t(cmd_t), _t(arg_t), _t(grp_t),
        _t(pos_t), use_group)
    assert out.dtype == torch.float32 and out.shape == (b, s, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_fold_arg_tables_matches_jax():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(257, 64)).astype(np.float32)
    kernel = rng.normal(size=(64 * 11, 32)).astype(np.float32)   # flax [in, out]
    bias = rng.normal(size=(32,)).astype(np.float32)
    ref = jax_embedding.fold_arg_tables(jnp.asarray(emb), jnp.asarray(kernel),
                                        jnp.asarray(bias), 11)
    out = port_embedding.fold_arg_tables(_t(emb), _t(kernel.T), _t(bias), 11)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


# -------------------------------------------------------------------- K2 layer

D, H, F_FF, DZ = 64, 2, 128, 48      # head dim 32, as the flagship's
LAYER_CASES = [  # (variant, S, causal)
    ("encoder", 32, False),
    ("encoder", 8, False),
    ("decoder", 31, False),
    ("decoder", 8, False),
    ("decoder", 31, True),
    ("decoder", 32, True),
    ("encoder", 1, False),
    ("encoder", 17, False),
    ("decoder", 17, True),
    ("decoder", 64, True),
    ("encoder", 242, False),    # the long form's lengths (Sketchformer's E1 and
    ("decoder", 241, True),     # its teacher-forced decoder)
]


def _layer_inputs(s, seed):
    """Weights in flax layout, x, z and an additive key-pad mask whose first
    sequence is fully masked."""
    rng = np.random.default_rng(seed)
    b = 4
    w = lambda *shape: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)  # noqa: E731
    vec = lambda n: (0.1 * rng.normal(size=(n,))).astype(np.float32)  # noqa: E731
    ln = lambda: np.stack([1 + 0.1 * rng.normal(size=D), 0.1 * rng.normal(size=D)]).astype(np.float32)  # noqa: E731
    p = {"norm1": ln(), "wqkv": w(D, 3 * D), "bqkv": vec(3 * D), "wo": w(D, D),
         "bo": vec(D), "norm2": ln(), "ff1_kernel": w(D, F_FF), "ff1_bias": vec(F_FF),
         "ff2_kernel": w(F_FF, D), "ff2_bias": vec(D),
         "glob_kernel": w(DZ, D), "glob_bias": vec(D)}
    x = rng.normal(size=(b, s, D)).astype(np.float32)
    z = rng.normal(size=(b, DZ)).astype(np.float32)
    lengths = np.array([0, s, max(1, s // 2), 3])
    mask = np.where(np.arange(s)[None, :] < lengths[:, None], 0.0, -np.inf).astype(np.float32)
    return p, x, z, mask


def _port_layer(variant, p, x, z, mask, causal):
    """The port's wrapper on CPU tensors (its plain version)."""
    weights = dict(ln1=_t(p["norm1"]), wqkv=_t(p["wqkv"].T), bqkv=_t(p["bqkv"]),
                   wo=_t(p["wo"].T), bo=_t(p["bo"]), ln2=_t(p["norm2"]),
                   w1=_t(p["ff1_kernel"].T), b1=_t(p["ff1_bias"]),
                   w2=_t(p["ff2_kernel"].T), b2=_t(p["ff2_bias"]))
    if variant == "encoder":
        return port_layer.fused_encoder_layer(_t(x), mask=_t(mask), n_heads=H,
                                              causal=causal, **weights).numpy()
    return port_layer.fused_decoder_layer(
        _t(x), _t(z), wg=_t(p["glob_kernel"].T), bg=_t(p["glob_bias"]),
        mask=_t(mask), n_heads=H, causal=causal, **weights).numpy()


@pytest.mark.parametrize("variant,s,causal", LAYER_CASES)
def test_layer_matches_pallas(variant, s, causal):
    p, x, z, mask = _layer_inputs(s, seed=s + causal)
    seq_bias = None if variant == "encoder" else jnp.asarray(z @ p["glob_kernel"] + p["glob_bias"])
    ref = jax_layer.fused_layer(
        jnp.asarray(x), seq_bias, *(jnp.asarray(p[k]) for k in (
            "norm1", "wqkv", "bqkv", "wo", "bo", "norm2", "ff1_kernel", "ff1_bias",
            "ff2_kernel", "ff2_bias")),
        jnp.asarray(mask), n_heads=H, tile_b=2, causal=causal)
    out = _port_layer(variant, p, x, z, mask, causal)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=5e-5, rtol=0)


def test_layer_fully_masked_sequence_attends_to_nothing():
    """A query whose keys are all masked gets zero probabilities: the layer
    adds only the out-projection bias in place of attention."""
    p, x, z, mask = _layer_inputs(8, seed=3)
    out = _port_layer("encoder", p, x, z, mask, False)[0]
    nl = port_layer._layer_norm_f32
    x0 = _t(x[0]) + _t(p["bo"])
    h = torch.relu(nl(x0, _t(p["norm2"])) @ _t(p["ff1_kernel"]) + _t(p["ff1_bias"]))
    want = x0 + h @ _t(p["ff2_kernel"]) + _t(p["ff2_bias"])
    np.testing.assert_allclose(out, want.numpy(), atol=5e-5, rtol=0)


@pytest.mark.parametrize("variant,s,causal", LAYER_CASES)
def test_layer_matches_xla(variant, s, causal):
    p, x, z, mask = _layer_inputs(s, seed=s + causal)
    if variant == "encoder":
        mod = EncoderLayerImproved(D, H, F_FF, 0.0, attn_impl="xla")
        params = {k: v for k, v in p.items() if not k.startswith("glob")}
        ref = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    else:
        mod = DecoderLayerGlobalImproved(D, H, F_FF, 0.0, attn_impl="xla", dim_z=DZ)
        ref = mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(z),
                        key_pad=jnp.asarray(mask), causal=causal)
    out = _port_layer(variant, p, x, z, mask, causal)
    # the XLA softmax gives NaN for the fully masked first sequence
    np.testing.assert_allclose(out[1:], np.asarray(ref)[1:], atol=5e-5, rtol=0)


# --------------------------------------------------------------------- K3 head

HEAD_CASES = ["ties", "chunk_edge_ties", "below_minus_1e30", "sketchformer_512"]


def _head_inputs(case):
    """Heads in flax layout and the states: random (seed 4) with exact ties,
    ties straddling the kernel's column-chunk edges, a slot whose valid
    logits all lie below -1e30, or Sketchformer's 512-class argument head."""
    rng = np.random.default_rng(4)
    r, d, n_cmd, n_args, vocab = 64, 32, 7, 11, 257
    if case == "sketchformer_512":
        vocab = 512
    x = rng.normal(size=(r, d)).astype(np.float32)
    wc = rng.normal(size=(d, n_cmd)).astype(np.float32)
    bc = rng.normal(size=(n_cmd,)).astype(np.float32)
    wa = rng.normal(size=(d, n_args * vocab)).astype(np.float32)
    ba = rng.normal(size=(n_args * vocab,)).astype(np.float32)
    # exact ties: duplicated columns must resolve to the first index
    wc[:, 5], bc[5] = wc[:, 2], bc[2]
    wa[:, 3 * vocab + 200], ba[3 * vocab + 200] = wa[:, 3 * vocab + 17], ba[3 * vocab + 17]
    wa[:, vocab - 1], ba[vocab - 1] = wa[:, 0], ba[0]
    if case == "chunk_edge_ties":
        # the winning pair of slot i straddles columns (63, 64), (127, 128),
        # (255, 256): the first of the two must win in every row
        for slot, (lo, hi) in zip((1, 4, 9), ((63, 64), (127, 128), (255, 256))):
            o = slot * vocab
            ba[o + lo] = ba[o + hi] = 50.0
            wa[:, o + hi] = wa[:, o + lo]
    if case == "below_minus_1e30":
        # every valid logit of slot 6 below -1e30; the packed padding (zero
        # weights, zero bias) would win if it were not masked
        o = 6 * vocab
        ba[o:o + vocab] = -2e30 - 1e29 * rng.random(vocab).astype(np.float32)
    return x, wc, bc, wa, ba, n_cmd, n_args, vocab


@pytest.mark.parametrize("case", HEAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_argmax_matches_pallas(case, dtype):
    x, wc, bc, wa, ba, n_cmd, n_args, vocab = _head_inputs(case)
    if dtype == "bfloat16":  # both packages on the same bf16-rounded inputs
        jt = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        tt = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    else:
        jt, tt = jnp.asarray, _t
    ref = jax_head.fused_head_argmax(jt(x), jt(wc), jt(bc), jt(wa), jt(ba),
                                     n_commands=n_cmd, n_args=n_args, tile_rows=16)
    w_packed, b_packed = port_head.pack_head(tt(wc.T), tt(bc), tt(wa.T), tt(ba), n_args)
    ids = port_head.fused_head_argmax(tt(x), w_packed, b_packed, n_cmd, n_args, vocab)
    assert ids.dtype == torch.int32 and ids.shape == (x.shape[0], 1 + n_args)
    assert int(ids[:, 1:].max()) < vocab
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref))
    if case == "chunk_edge_ties":
        assert (ids[:, [2, 5, 10]].numpy() == [63, 127, 255]).all()


def test_tf32_rounding_matches_numpy():
    """The float32 kernels' operand rounding (``layer.to_tf32``, cvt.rna.tf32's
    rule: to nearest of the 10-bit mantissas, ties away from zero), bit for
    bit against the nearer of the two TF32 neighbours found in float64; it
    differs from round-to-nearest-even only on exact ties."""
    from deepsvg_tpu_torch.ops.layer import to_tf32
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2 ** 31 - 2 ** 24, 20000, dtype=np.int64).astype(np.uint32)
    bits[:8] = [0x3F801000, 0x3F803000, 0x3F800FFF, 0x3F801001,  # ties, near ties
                0x00000000, 0x00001000, 0x00003000, 0x00800000]  # zero, denormal ties
    sign = (rng.random(bits.size) < 0.5).astype(np.uint32) << 31
    x = (bits | sign).view(np.float32)
    trunc = bits & ~np.uint32(0x1FFF)                  # the TF32 value toward zero
    lo = (trunc | sign).view(np.float32).astype(np.float64)
    hi = ((trunc + np.uint32(0x2000)) | sign).view(np.float32).astype(np.float64)
    xd = x.astype(np.float64)
    away = np.abs(hi - xd) <= np.abs(xd - lo)
    want = np.where(away, hi, lo).astype(np.float32)
    got = to_tf32(_t(x)).numpy()
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    # round-to-nearest-even differs where a tie sits above an even mantissa
    ties = np.abs(hi - xd) == np.abs(xd - lo)
    lo_even = (lo.astype(np.float32).view(np.uint32) >> 13) % 2 == 0
    even = np.where(ties & lo_even, lo, want).astype(np.float32)
    assert ((even != want) == (ties & lo_even)).all() and (ties & lo_even).any()


# -------------------------------------------------------- wrappers and purity

def test_wrappers_dispatch_on_device():
    """A tensor on neither the CPU nor a CUDA card is refused, not run."""
    x = torch.empty((2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no layer kernel"):
        port_layer.fused_layer(x, None, *([x] * 11), n_heads=2)
    with pytest.raises(ValueError, match="no head kernel"):
        port_head.fused_head_argmax(x[0], x[0], x[0, 0], 7, 11, 257)
    with pytest.raises(ValueError, match="no embedding kernel"):
        port_embedding.fused_embedding(x[..., 0], x, None, x, x, None, x)


def test_port_imports_no_jax():
    """Importing every module of the port loads neither JAX, flax nor the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepsvg_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'msgpack', 'deepsvg_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('deepsvg_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


# ------------------------------------------------- masks, data, msgpack reader

@pytest.mark.parametrize("name,kwargs", [
    ("padding_mask", {}), ("padding_mask", {"extended": True}),
    ("key_padding_mask", {}), ("group_mask", {}), ("visibility_mask", {}),
])
def test_masks_match_jax(name, kwargs):
    rng = np.random.default_rng(5)
    commands = rng.integers(0, 7, (3, 8, 12)).astype(np.int32)
    commands[0, 1] = [5] + [4] * 11             # an empty (all-EOS) group
    commands[1, 2, :] = 4
    ref = getattr(jax_masks, name)(jnp.asarray(commands), **kwargs)
    out = getattr(port_masks, name)(_t(commands), **kwargs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generate_batch_matches_jax():
    ref = jax_synthetic.generate_batch(np.random.default_rng(7), 6, label_range=10)
    out = port_synthetic.generate_batch(np.random.default_rng(7), 6, label_range=10)
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(out[key], ref[key])


def test_msgpack_reader_matches_flax_on_checkpoint():
    with open(ARTIFACT, "rb") as f:
        raw = f.read()
    ref = serialization.msgpack_restore(raw)
    out = port_checkpoint.msgpack_restore(raw)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    out_leaves = dict(jax.tree_util.tree_flatten_with_path(out)[0])
    assert len(ref_leaves) == len(out_leaves) == 210
    for path, leaf in ref_leaves:
        got = out_leaves[path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        assert got.tobytes() == np.asarray(leaf).tobytes(), path


def test_msgpack_reader_matches_flax_on_mixed_tree():
    tree = {
        "a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
              "i": np.array([-3, 7], np.int64), "h": np.ones((2, 2), np.float16)},
        "scalar": np.float32(2.5), "n": 300, "neg": -70000, "f": 0.25,
        "s": "x" * 40, "flag": True, "empty": np.zeros((0, 5), np.int32),
        "big": np.random.default_rng(0).normal(size=(70, 300)).astype(np.float32),
    }
    raw = serialization.msgpack_serialize(tree)
    ref, out = serialization.msgpack_restore(raw), port_checkpoint.msgpack_restore(raw)
    assert sorted(out) == sorted(ref)
    for key in ref:
        a, b = ref[key], out[key]
        if isinstance(a, dict):
            for k in a:
                assert b[k].dtype == a[k].dtype and b[k].tobytes() == a[k].tobytes()
        elif isinstance(a, np.ndarray | np.generic):
            assert b.dtype == a.dtype and np.asarray(b).tobytes() == np.asarray(a).tobytes()
        else:
            assert b == a and type(b) is type(a), key
