"""The port's embedding (K1 and K6) against the JAX package, on the CPU.

The plain versions that the wrappers run for a CPU tensor (the gather-sum
``embedding_reference`` and autograd through it) are held against the JAX
Pallas kernels ``fused_embedding`` / ``fused_embedding_train``, run in
interpret mode as the JAX package's own tests run them on the CPU, at
Sketchformer's shapes (S=242 and the teacher-forced 241, a 242-row group
table, 512 relative classes) and at the ids where a gather-sum and a one-hot
matmul could part: S=1, sequences all PAD, one argument row hit by every
token, ids outside their tables. Float32 to 1e-5; bfloat16 tables to one
rounding of the float32 sum. Inputs are made from a seed with numpy.

Also here: the host-side plans of the Hopper kernels (``k1_plan``,
``k6_plan``) against numpy: K1's shared-memory budget, and K6's workspace
and its counting sort, emulated in numpy on the plan's layout (each token
block's entries ordered by table row, in token order), whose segment sums
must give the tables' gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu.ops import embedding as jax_embedding
from deepsvg_tpu_torch.ops import embedding as port_embedding

D, N_ARGS, N_CMD = 32, 11, 7


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _ids(rng, b, s, vocab, n_group, pad=0.5):
    commands = rng.integers(0, N_CMD, (b, s)).astype(np.int32)
    args = rng.integers(-1, vocab - 1, (b, s, N_ARGS)).astype(np.float32)
    args[rng.random(args.shape) < pad] = -1.0
    groups = rng.integers(0, max(n_group, 1), (b, s)).astype(np.int32)
    return commands, args, groups


def _tables(rng, vocab, n_group, s, dtype=np.float32):
    return [rng.normal(size=(n, D)).astype(dtype)
            for n in (N_CMD, N_ARGS * vocab, max(n_group, 1), s)]


def _jax_forward(ids, tables, use_group, out_dtype=jnp.float32):
    commands, args, groups = ids
    tile_b = 1 if commands.shape[1] > 32 else commands.shape[0]
    return np.asarray(jax_embedding.fused_embedding(
        jnp.asarray(commands), jnp.asarray(args), jnp.asarray(groups),
        *map(jnp.asarray, tables), tile_b=tile_b, use_group=use_group,
        out_dtype=out_dtype)).astype(np.float32)


def _jax_grads(ids, tables, dy, use_group):
    commands, args, groups = ids
    tile_b = 1 if commands.shape[1] > 32 else commands.shape[0]

    def run(*ts):
        return jax_embedding.fused_embedding_train(
            jnp.asarray(commands), jnp.asarray(args), jnp.asarray(groups), *ts, tile_b,
            use_group, jnp.float32, True)
    out, vjp = jax.vjp(run, *map(jnp.asarray, tables))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _port_grads(ids, tables, dy, use_group):
    ts = [_t(t, True) for t in tables]
    out = port_embedding.fused_embedding_train(*map(_t, ids), *ts, use_group)
    grads = torch.autograd.grad(out, ts, _t(dy), allow_unused=True)
    return out.detach().numpy(), [np.zeros_like(t) if g is None else g.numpy()
                                  for t, g in zip(tables, grads)]


def _assert_grads(got, want):
    for name, g, w in zip(("dcmd", "darg", "dgroup", "dpos"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


# ------------------------------------------------ K1 and K6 against JAX

@pytest.mark.parametrize("s", [242, 241])
@pytest.mark.parametrize("use_group", [False, True])
def test_embedding_matches_jax_at_sketchformer_shapes(s, use_group):
    """The encoder's S=242 and the teacher-forced decoder's 241, 512
    relative classes, a group table of 242 rows."""
    rng = np.random.default_rng(s + use_group)
    vocab, n_group = 512, 242
    ids = _ids(rng, 2, s, vocab, n_group)
    tables = _tables(rng, vocab, n_group, s)
    want = _jax_forward(ids, tables, use_group)
    got = port_embedding.fused_embedding(*map(_t, ids), *map(_t, tables), use_group)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [242, 241])
def test_embedding_gradients_match_jax_at_sketchformer_shapes(s):
    rng = np.random.default_rng(10 + s)
    vocab, n_group = 512, 242
    ids = _ids(rng, 2, s, vocab, n_group)
    tables = _tables(rng, vocab, n_group, s)
    dy = rng.normal(size=(2, s, D)).astype(np.float32)
    out_j, want = _jax_grads(ids, tables, dy, True)
    out_p, got = _port_grads(ids, tables, dy, True)
    np.testing.assert_allclose(out_p, out_j, rtol=1e-5, atol=1e-5)
    _assert_grads(got, want)


def _edge_case(case):
    """(ids, vocab, n_group, s) where the lookups are at their edges."""
    rng = np.random.default_rng(len(case))
    vocab, n_group = 257, 10
    s = 1 if case == "S=1" else 32
    commands, args, groups = _ids(rng, 6, s, vocab, n_group)
    if case == "all_pad":
        args[1:4] = -1.0                               # whole sequences of PAD
        args[0, :, 2:] = -1.0
    elif case == "skewed":
        args[..., 6] = 17.0                            # every token on one row
        groups[:] = 3
    elif case == "out_of_range":
        commands[0, 0], commands[1, -1] = N_CMD, -1
        args[0, 0, 0], args[2, -1, 10], args[3, 0, 5] = vocab - 1, vocab + 40, -2.0
        groups[4, 0], groups[5, -1] = n_group, -1
    return (commands, args, groups), vocab, n_group, s


EDGE_CASES = ["S=1", "all_pad", "skewed", "out_of_range"]


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("use_group", [False, True])
def test_embedding_edge_ids_match_jax(case, use_group):
    """Forward and the four tables' gradients: an id outside its table adds
    nothing; a PAD argument reads (and its gradient lands on) its slot's row
    0."""
    ids, vocab, n_group, s = _edge_case(case)
    rng = np.random.default_rng(7)
    tables = _tables(rng, vocab, n_group, s)
    dy = rng.normal(size=(ids[0].shape[0], s, D)).astype(np.float32)
    out_j, want = _jax_grads(ids, tables, dy, use_group)
    out_p, got = _port_grads(ids, tables, dy, use_group)
    np.testing.assert_allclose(out_p, out_j, rtol=1e-5, atol=1e-5)
    _assert_grads(got, want)


@pytest.mark.parametrize("s,use_group", [(32, False), (242, True)])
def test_embedding_bf16_tables_match_jax_one_rounding(s, use_group):
    """bfloat16 tables: both sum the exact table values in float32 in one
    order and round once, so they agree to one bfloat16 rounding."""
    rng = np.random.default_rng(s)
    vocab, n_group = (512, 242) if s > 32 else (257, 10)
    ids = _ids(rng, 2, s, vocab, n_group)
    tables = _tables(rng, vocab, n_group, s)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in tables]
    want = _jax_forward(ids, [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf],
                        use_group, out_dtype=jnp.bfloat16)
    got = port_embedding.fused_embedding(*map(_t, ids), *bf, use_group)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-6)


# ------------------------------------------------------ the kernels' plans

@pytest.mark.parametrize("s", [1, 32, 174, 175, 241, 242])
@pytest.mark.parametrize("d,itemsize", [(256, 2), (256, 4), (128, 2), (200, 2), (64, 4)])
def test_k1_plan_against_numpy(s, d, itemsize):
    """The Hopper K1 takes D a multiple of 64 and 11 slots; its blocks hold
    three float32 prefix sums a command, the command and PAD rows, and the
    position rows where all fit in 96 KB (at least two blocks an SM)."""
    plan = port_embedding.k1_plan(N_CMD, N_ARGS, s, d, itemsize)
    if d % 64:
        assert plan is None
        return
    rows = np.array([N_CMD + N_ARGS, N_CMD + N_ARGS + s])
    nbytes = N_CMD * 3 * d * 4 + rows * d * itemsize
    fits = nbytes <= 96 * 1024
    assert plan == ((True, int(nbytes[1])) if fits[1] else (False, int(nbytes[0])))
    assert port_embedding.k1_plan(N_CMD, 10, s, d, itemsize) is None


def _k6_emulate(plan, commands, args, groups, dy, n_cmd, vocab, n_group, use_group):
    """K6's phases in numpy, on the plan's layout: per block of 128 tokens
    the hot rows' sums and the cold entries' counting sort (``lp`` and
    ``list``); then each cold row summed over the blocks' lists in block
    order (each segment in token order), each hot row over the blocks' sums.
    Returns dcmd, darg and dgroup."""
    tb_size, per, r_cold = plan["tb"], plan["per"], plan["R"]
    rows, d = dy.shape
    n_args = args.shape[1]
    arg_rows = n_args * vocab
    keys = np.full((rows, per), -1)
    for j in range(n_args):
        a = args[:, j]
        ok = (a >= 0) & (a + 1 < vocab)
        keys[ok, j] = j * vocab + a[ok] + 1
    if use_group:
        ok = (groups >= 0) & (groups < n_group)
        keys[ok, n_args] = arg_rows + groups[ok]
    hot = np.zeros((plan["ntb"], n_cmd + n_args, d))
    lp = np.zeros((plan["ntb"], r_cold + 1), np.int64)
    lists = []
    for tb in range(plan["ntb"]):
        t0, t1 = tb * tb_size, min(rows, (tb + 1) * tb_size)
        for t in range(t0, t1):
            if 0 <= commands[t] < n_cmd:
                hot[tb, commands[t]] += dy[t]
            for j in np.nonzero(args[t] == -1)[0]:
                hot[tb, n_cmd + j] += dy[t]
        k = keys[t0:t1].reshape(-1)
        tok = np.repeat(np.arange(t0, t1), per)
        counts = np.bincount(k[k >= 0], minlength=r_cold + 1)
        lp[tb] = np.concatenate([[0], np.cumsum(counts)[:-1]])
        order = np.argsort(k[k >= 0], kind="stable")        # by row, in token order
        lists.append(tok[k >= 0][order])
        assert len(lists[-1]) <= tb_size * per               # the block's list slice
        assert lp[tb, r_cold] == len(lists[-1])
        # a segment of at least K6_LONG entries is summed in phase 1 in
        # chunks of 32 (the last takes the rest), each into the slot
        # start // K6_LONG of the block's part of ``seg``: one each
        long_ = np.nonzero(counts[:r_cold] >= port_embedding.K6_LONG)[0]
        starts = [lp[tb, r] + 32 * j for r in long_
                  for j in range(max(1, counts[r] // 32))]
        slots = np.array(starts, dtype=np.int64) // port_embedding.K6_LONG
        assert len(set(slots.tolist())) == len(slots)
        assert np.all(slots < tb_size * per // port_embedding.K6_LONG)
    dcmd, darg = np.zeros((n_cmd, d)), np.zeros((arg_rows, d))
    dgroup = np.zeros((n_group, d))
    for r in range(r_cold):
        if r < arg_rows and r % vocab == 0:
            continue
        acc = np.zeros(d)
        for tb in range(plan["ntb"]):
            segment = lists[tb][lp[tb, r]:lp[tb, r + 1]]
            assert np.all(np.diff(segment) > 0)              # in token order
            for t in segment:
                assert r in keys[t]
                acc += dy[t]
        if r < arg_rows:
            darg[r] = acc
        else:
            dgroup[r - arg_rows] = acc
    sums = hot.sum(0)
    dcmd[:] = sums[:n_cmd]
    for j in range(n_args):
        darg[j * vocab] = sums[n_cmd + j]
    return dcmd, darg, dgroup


@pytest.mark.parametrize("b,s,vocab,n_group,use_group,skewed", [
    (9, 32, 257, 0, False, False),     # the flagship's rows, a ragged last block
    (3, 242, 512, 242, True, False),   # Sketchformer's encoder and its group table
    (5, 1, 257, 10, True, False),      # S=1
    (9, 32, 257, 10, True, True),      # long segments: one row per slot 3, few groups
    (540, 32, 257, 0, False, True),    # over 132 x 128 tokens: blocks of 256
])
def test_k6_plan_and_counting_sort_against_numpy(b, s, vocab, n_group, use_group, skewed):
    """The plan's sizes and offsets (aligned, disjoint, the list slices large
    enough for every block), and the counting sort it lays out: each cold
    row's entries in token order, whose sums with the hot rows' give the
    scatter-add of ``dy`` that autograd through the plain version gives."""
    rng = np.random.default_rng(b * s)
    commands, args, groups = _ids(rng, b, s, vocab, n_group, pad=0.7)
    if skewed:
        args[..., 3] = 7.0
        groups[:] = rng.integers(0, 3, groups.shape)
    args[0, 0, 3], commands[-1, -1], groups[0, -1] = vocab + 3, N_CMD, n_group
    rows = b * s
    plan = port_embedding.k6_plan(rows, 256, N_ARGS, vocab, N_CMD, n_group, use_group)
    assert plan["tb"] == (256 if rows > 132 * 128 else 128)
    assert plan["ntb"] == -(-rows // plan["tb"])
    assert plan["R"] == N_ARGS * vocab + n_group and plan["per"] == N_ARGS + use_group
    assert plan["smem"] <= port_embedding.K6_SMEM_MAX
    parts = sorted(plan[k] for k in ("part", "lp", "list", "seg"))
    assert parts[0][0] == 0 and all(o % 256 == 0 for o, _ in parts)
    assert all(o + n <= o2 for (o, n), (o2, _) in zip(parts, parts[1:]))
    assert plan["workspace"] >= parts[-1][0] + parts[-1][1]
    assert plan["part"][1] == plan["ntb"] * (N_CMD + N_ARGS) * 256 * 4
    assert plan["lp"][1] == plan["ntb"] * (plan["R"] + 1) * 4
    assert plan["list"][1] == plan["ntb"] * plan["tb"] * plan["per"] * 4
    assert plan["seg"][1] == plan["ntb"] * plan["tb"] * plan["per"] // 8 * 256 * 4
    d = 8
    dy = rng.normal(size=(rows, d)).astype(np.float32)
    flat_args = args.reshape(rows, N_ARGS).astype(np.int64)
    dcmd, darg, dgroup = _k6_emulate(
        plan, commands.reshape(-1), flat_args, groups.reshape(-1), dy, N_CMD, vocab, n_group,
        use_group)
    tables = [torch.zeros(n, d, requires_grad=True)
              for n in (N_CMD, N_ARGS * vocab, max(n_group, 1), s)]
    out = port_embedding.embedding_reference(_t(commands), _t(args), _t(groups), *tables,
                                             use_group)
    want = torch.autograd.grad(out, tables, _t(dy.reshape(b, s, d)), allow_unused=True)
    # float32 sums of up to 17,280 rows in the plain version: 1e-5 of the
    # table's largest entry, as the card holds K6
    for got, ref in ((dcmd, want[0]), (darg, want[1])) + (
            ((dgroup, want[2][:n_group]),) if use_group else ()):
        ref = ref.numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_k6_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 8"):
        port_embedding.k6_plan(64, 250, N_ARGS, 257, N_CMD, 0, False)
    with pytest.raises(ValueError, match="hot rows"):
        port_embedding.k6_plan(64, 256, 30, 257, N_CMD, 0, False)
    with pytest.raises(ValueError, match="table rows"):
        port_embedding.k6_plan(64, 256, N_ARGS, 5000, N_CMD, 0, False)
