"""The port's ``SVGTensor``, torch ``relative_args``, ``difflib`` and
``evaluation`` against the JAX package, on the CPU.

Inputs come from a numpy seed: random polylines for the point-set functions
(no two points coincide, so no ``argmin`` meets a tie and every norm has a
gradient), synthetic icons of ``generate_batch`` for the tensors and the
reconstruction metrics (N=4, G=8, S=30, the predictions a perturbed and
group-permuted copy). Values within 1e-5 (relative for the summed metrics),
gradients of ``svg_emd_loss`` and ``chamfer_loss`` within 1e-4 of
``jax.grad``. At an exact zero distance both packages' EMD gradient is NaN
(the norm is the square root of a sum of squares in both), and the case is
held as such.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepsvg_tpu.difflib as jax_difflib
import deepsvg_tpu.evaluation as jax_eval
import deepsvg_tpu.svgtensor as jax_svgtensor
import deepsvg_tpu.svgtensor.tensor as jax_tensor
import deepsvg_tpu_torch.difflib as port_difflib
import deepsvg_tpu_torch.evaluation as port_eval
import deepsvg_tpu_torch.svgtensor as port_svgtensor
import deepsvg_tpu_torch.svgtensor.tensor as port_tensor
from deepsvg_tpu_torch.data import generate_batch

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4
N, G, S = 4, 8, 30


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=VALUE_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _icons(seed=0, n=N):
    """Synthetic icons ``[n, G, S+2]`` from a numpy seed."""
    return generate_batch(np.random.default_rng(seed), n, G, S)


def _predictions(commands, args, seed):
    """A perturbed copy of the post-SOS ground truth: arguments moved by up
    to 6 grid units, a few commands changed, the groups permuted."""
    rng = np.random.default_rng(seed)
    pa = np.where(args >= 0, np.clip(args + rng.integers(-6, 7, args.shape), 0, 255), args)
    pc = commands.copy()
    flip = (rng.random(pc.shape) < 0.05) & (pc < 4)
    pc[flip] = rng.choice([0, 1, 2], size=int(flip.sum()))
    perm = rng.permutation(commands.shape[1])
    return pc[:, perm].astype(np.int32), pa[:, perm].astype(np.float32)


def _polylines(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape + (2,)).astype(np.float32) * 5


# ------------------------------------------------------------------ SVGTensor

def _svgtensor_sequence():
    """One icon's first group without SOS and padding: commands (float32, as
    ``SVGTensor`` holds them) and arguments."""
    b = _icons(3, 1)
    c, a = b["commands"][0, 0], b["args"][0, 0]
    n = int((c < 4).sum()) + 1                    # SOS and the content
    return c[1:n].astype(np.float32), a[1:n]


def test_svgtensor_matches_jax():
    """The object API over one group: views, sequence ops, the relative
    encoding and both samplers (the port's through its torch difflib)."""
    c, a = _svgtensor_sequence()
    outs = []
    for mod in (jax_svgtensor, port_svgtensor):
        st = mod.SVGTensor.from_cmd_args(c, a)
        d = mod.SVGTensor.from_data(st.data)
        seq = st.copy().add_sos().add_eos().pad(40)
        outs.append([st.data, st.cmds(), st.args(), st.args(with_start_pos=True), d.data,
                     seq.cmds(), seq.args(), seq.copy().unpad().cmds(),
                     seq.copy().drop_sos().cmds(), st.get_relative_args(),
                     st.sample_points(n=7), st.sample_uniform_points(n=30),
                     len(seq), seq.seq_len, repr(seq)])
    for i, (got, want) in enumerate(zip(*outs[::-1])):
        if isinstance(want, np.ndarray):
            _close(got, want, what=f"item {i}")
        else:
            assert got == want, i


def _jax_relative(c, a):
    return jax_tensor.relative_args(c, a), jax_tensor._prev_real_end_pos(c, a[..., 9:11])


def test_relative_args_matches_jax():
    """Torch ``relative_args`` (and its helpers) against JAX's on packed
    batches with SOS, EOS and padding, and against the host encoding."""
    b = _icons(4)
    for key in ("commands", "commands_grouped"):
        c = b[key]
        a = b["args" if key == "commands" else "args_grouped"]
        want, (start_j, has_j) = jax.jit(_jax_relative)(jnp.asarray(c), jnp.asarray(a))
        got = port_tensor.relative_args(_t(c), _t(a))
        _close(got, want, what=key)
        flat_c, flat_a = c.reshape(-1, c.shape[-1]), a.reshape(-1, *a.shape[-2:])
        host = np.stack([port_tensor.relative_args_np(x, y) for x, y in zip(flat_c, flat_a)])
        _close(got.reshape(host.shape), host, what=f"{key} host")
        start_p, has_p = port_tensor._prev_real_end_pos(_t(c), _t(a[..., 9:11]))
        _close(start_p, start_j, what=f"{key} start")
        _close(has_p, has_j, what=f"{key} has_prev")
    x = np.random.default_rng(0).integers(-5, 50, (3, 17)).astype(np.int32)
    _close(port_tensor.jax_cummax(_t(x)), jax.jit(jax_tensor.jax_cummax)(jnp.asarray(x)))


# ------------------------------------------------------------------ difflib

def _per_contour(lib, name, **kw):
    """``lib``'s function over a batch of contours: the JAX package's
    single-contour functions under ``jax.vmap``, the port's as they are."""
    fn = getattr(lib, name)
    return jax.vmap(lambda *a: fn(*a, **kw)) if lib is jax_difflib else \
        (lambda *a: fn(*a, **kw))


# each case maps (package, inputs as that package's arrays) to its outputs
CASES = {
    "is_clockwise": lambda lib, x: lib.is_clockwise(x["p"]),
    "make_clockwise": lambda lib, x: lib.make_clockwise(x["p"]),
    "reorder": lambda lib, x: (_per_contour(lib, "reorder")(x["p"], x["shifts"]),
                               lib.reorder(x["p"], 5)),
    "get_length": lambda lib, x: lib.get_length(x["q"]),
    "command_positions": lambda lib, x: lib.command_positions(x["c"], x["a"]),
    "sample_points_padded": lambda lib, x: lib.sample_points_padded(x["c"], x["a"], n=6),
    "get_length_distribution": lambda lib, x: (lib.get_length_distribution(x["q"]),
                                               lib.get_length_distribution(x["q"], False)),
    "resample_uniform": lambda lib, x: lib.resample_uniform(x["q"][0], 10),
    "cdist": lambda lib, x: lib.cdist(x["p"], x["q"]),
    "chamfer_loss": lambda lib, x: lib.chamfer_loss(x["p"], x["q"]),
    "continuity_loss": lambda lib, x: lib.continuity_loss(x["q"]),
    "svg_length_loss": lambda lib, x: lib.svg_length_loss(x["p"], x["q"]),
    "svg_emd_loss": lambda lib, x: (
        _per_contour(lib, "svg_emd_loss")(x["p"], x["q"]),
        _per_contour(lib, "svg_emd_loss", first_point_weight=True)(x["p"], x["q"])),
    "svg_emd_loss_matching": lambda lib, x: _per_contour(
        lib, "svg_emd_loss", return_matching=True)(x["p"], x["q"]),
}
# the ragged samplers (data-dependent shapes: eager in both packages), on the
# sequence and at the sizes of test_svgtensor_matches_jax
RAGGED = {
    "sample_points": lambda lib, x: lib.sample_points(x["c1"], x["a1"], n=7),
    "sample_uniform_points": lambda lib, x: lib.sample_uniform_points(x["c1"], x["a1"], n=30),
}


def _inputs():
    b, seq = _icons(5, 2), _svgtensor_sequence()
    return {"p": _polylines(1, 3, 12), "q": _polylines(2, 3, 17),
            "shifts": np.array([0, 3, 11], np.int32), "c": b["commands"], "a": b["args"],
            "c1": seq[0].astype(np.int32), "a1": seq[1]}


@functools.lru_cache(maxsize=None)
def _jax_references():
    """Every case's JAX outputs: one ``jax.jit`` over all the fixed-shape
    cases (one compilation), the ragged ones eager."""
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    out = jax.jit(lambda x: {k: fn(jax_difflib, x) for k, fn in CASES.items()})(x)
    out.update({k: fn(jax_difflib, x) for k, fn in RAGGED.items()})
    return out


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for item in x for y in _flat(item)]
    return [x]


@pytest.mark.parametrize("name", sorted({**CASES, **RAGGED}))
def test_difflib_values_match_jax(name):
    """Each function over a batch within 1e-5."""
    want = _flat(_jax_references()[name])
    got = _flat({**CASES, **RAGGED}[name](port_difflib,
                                         {k: _t(v) for k, v in _inputs().items()}))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"{name}[{i}]")


def test_viz_matches_jax():
    """The matplotlib helpers (a copy): the same images."""
    p1, p2 = _polylines(3, 40), _polylines(4, 40)
    matching = np.random.default_rng(0).integers(0, 40, 40)
    for fn, args in (("plot_points", (p1,)), ("plot_matching", (p1, p2, matching))):
        imgs = [np.asarray(getattr(lib, fn)(*args, return_img=True))
                for lib in (jax_difflib, port_difflib)]
        np.testing.assert_array_equal(imgs[1], imgs[0], err_msg=fn)


GRAD_INPUTS = (_polylines(7, 4, 16), _polylines(8, 4, 23))
ZERO_INPUT = _polylines(9, 12)           # pred = target: every best distance is 0


@functools.lru_cache(maxsize=None)
def _jax_gradients():
    """``jax.grad`` of both losses summed over a batch, and of the EMD of a
    contour against itself: one compilation."""
    def grads(x, y, z):
        out = {name: jax.grad(lambda x, y: jnp.sum(jax.vmap(getattr(jax_difflib, name))(x, y)),
                              argnums=(0, 1))(x, y)
               for name in ("svg_emd_loss", "chamfer_loss")}
        out["zero"] = jax.grad(jax_difflib.svg_emd_loss)(z, z)
        return out
    return jax.jit(grads)(*map(jnp.asarray, (*GRAD_INPUTS, ZERO_INPUT)))


@pytest.mark.parametrize("loss", ["svg_emd_loss", "chamfer_loss"])
def test_loss_gradients_match_jax(loss):
    """d loss / d (pred, target) against ``jax.grad`` within 1e-4 of the
    largest entry, on points with no coincident pair."""
    x, y = (_t(v).requires_grad_() for v in GRAD_INPUTS)
    getattr(port_difflib, loss)(x, y).sum().backward()
    for got, want in zip((x.grad, y.grad), _jax_gradients()[loss]):
        scale = float(np.abs(np.asarray(want)).max())
        assert scale > 0
        _close(got / scale, np.asarray(want) / scale, GRAD_TOL, loss)


def test_emd_gradient_at_an_exact_zero_is_nan_in_both():
    """A predicted point on a resampled target point: the norm's gradient at
    0 is NaN in JAX, and the port computes it as JAX does."""
    want = np.asarray(_jax_gradients()["zero"])
    x = _t(ZERO_INPUT.copy()).requires_grad_()
    port_difflib.svg_emd_loss(x, _t(ZERO_INPUT)).backward()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(x.grad.numpy()), np.isnan(want))
    finite = ~np.isnan(want)
    _close(x.grad.numpy()[finite], want[finite], GRAD_TOL, "finite entries")


# ---------------------------------------------------------------- evaluation

def _jax_helpers(c, a, x, xv, y, yv):
    contour = jax.vmap(jax.vmap(lambda c, a: jax_eval._group_contour(c, a, 5, 48)))(c, a)
    return contour, jax.vmap(jax_eval._masked_chamfer)(x, xv, y, yv)


def test_evaluation_helpers_match_jax():
    """``_group_contour`` and ``_masked_chamfer`` batched against JAX's
    under ``jax.vmap``, and ``_ratios``."""
    b = _icons(1)
    c, a = b["commands"][..., 1:], b["args"][..., 1:, :]
    rng = np.random.default_rng(2)
    x, y = _polylines(10, 3, 30), _polylines(11, 3, 25)
    xv, yv = rng.random((3, 30)) < 0.7, rng.random((3, 25)) < 0.6
    yv[2] = False                                  # an empty cloud
    contour, chamfer = jax.jit(_jax_helpers)(*map(jnp.asarray, (c, a, x, xv, y, yv)))
    got = port_eval._group_contour(_t(c).long(), _t(a), 5, 48)
    _close(got[0], contour[0], what="contour")
    _close(got[1], np.asarray(contour[1]).astype(np.int64), what="count")
    got = port_eval._masked_chamfer(*map(_t, (x, xv, y, yv)))
    _close(got[0], chamfer[0], what="chamfer")
    _close(got[1], chamfer[1], what="ok")
    acc = dict(zip(["vis_hit", "vis_cnt", "cmd_hit", "cmd_cnt", "mae_sum", "mae_cnt",
                    "chamfer_sum", "chamfer_cnt", "emd_sum", "emd_cnt"],
                   np.random.default_rng(3).random(10) * 100))
    acc["emd_cnt"] = 0.0
    assert port_eval._ratios(acc) == jax_eval._ratios(acc)


@pytest.mark.parametrize("match_groups", [False, True])
def test_recon_metrics_matches_jax(match_groups):
    """Every summed metric at N=4, G=8, S=30 within 1e-5 relative."""
    b = _icons(2)
    c, a = b["commands"][..., 1:], b["args"][..., 1:, :]
    pc, pa = _predictions(c, a, 9)
    want = jax_eval.recon_metrics(*map(jnp.asarray, (c, a, pc, pa)), match_groups=match_groups)
    got = port_eval.recon_metrics(*map(_t, (c, a, pc, pa)), match_groups=match_groups)
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= VALUE_TOL * max(abs(w), 1.0), (k, float(got[k]), w)
    assert float(want["emd_cnt"]) > 0 and float(want["chamfer_cnt"]) == N
