"""The one-stage autoregressive model (Sketchformer: one-stage encoder with the
group embedding, ResNet + VAE, causal decoder with relative targets) against
the JAX package, on the CPU.

A small model (d_model 64, 2 heads of 32, FF 128, dim_z 64, two layers per
stack, 2 paths x 5 commands: ``max_total_len`` 10, 512 argument classes)
with the JAX package's own initialisation from a seed, a batch of N=4
synthetic icons from a numpy seed. The port's kernels run as their plain
versions (CPU tensors); the JAX package's Pallas kernels in interpret mode.
The VAE is read at its mean (``sample_vae=False``) and that latent is handed
to both decoders. Held:

- K9's plain version against JAX's ``fused_decode_step`` (float32, 1e-5), at
  several positions, with rows whose keys are masked from some position on;
- the plain layer (``layer_reference``) at 33 <= S <= 41, causal and
  key-padded, against the JAX package's XLA layer (float32, 1e-5);
- the one-stage encoder's output and the VAE's mean and log-variance, and
  the teacher-forced logits, against JAX's XLA path (float32, 1e-4);
- the port's three samplers against JAX's ``autoregressive_sample_cached``:
  ids equal, arguments within 1e-5;
- within the port: the decode step's logits at each position equal the
  teacher-forced logits there (float32, 1e-4);
- ``make_absolute`` against JAX's, and the weight bridge of the tree;
- one bfloat16 decode against JAX's fused path (Pallas kernels in interpret
  mode): per sequence, the ids equal up to the first position where JAX's
  top-2 margin falls below ``MARGIN_BF16``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models import layers as jax_layers
from deepsvg_tpu.models import sample as jax_sample
from deepsvg_tpu.ops.decode import fused_decode_step as jax_fused_decode_step
from deepsvg_tpu.svgtensor.tensor import make_absolute as jax_make_absolute
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    DropoutRng, ModelConfig, SVGTransformer, autoregressive_sample, autoregressive_sample_cached,
    autoregressive_sample_fused, greedy_sample, load_flax_params, sketchformer, to_flax_params)
from deepsvg_tpu_torch.ops import decode as decode_ops
from deepsvg_tpu_torch.ops import layer as layer_ops
from deepsvg_tpu_torch.svgtensor import CMD_ARGS_MASK, CMD_EOS, make_absolute

N, G, S = 4, 2, 5                       # max_total_len 10: buffers of 11 positions
KW = dict(encode_stages=1, decode_stages=1, pred_mode="autoregressive", rel_targets=True,
          use_vae=True, d_model=64, n_heads=2, dim_feedforward=128, dim_z=64, n_layers=2,
          n_layers_decode=2, dropout=0.0, max_num_groups=G, max_seq_len=S)
LOGIT_TOL = 1e-4
ARGS_TOL = 1e-5
# the bfloat16 decode: JAX's fused path (Pallas interpret) and the port's
# (plain K9 and K3) round at the same points but sum in another order, and
# JAX's margins come from its teacher-forced XLA forward in bfloat16 on its
# own decoded tokens, which rounds elsewhere again. A sequence is compared up
# to its first position whose command, or an argument its command uses, has
# two best logits closer than this (the logits are of order 1).
MARGIN_BF16 = 0.05


def _jax_cfg(impl="xla", dtype="float32"):
    return JaxModelConfig(**KW, attention_impl=impl, compute_dtype=dtype)


def _port_model(tree, dtype="float32"):
    model = SVGTransformer(ModelConfig(**KW, compute_dtype=dtype))
    load_flax_params(model, tree)
    return model


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def batch():
    """Encoder inputs (absolute arguments) and decoder targets (relative)."""
    b = generate_batch(np.random.default_rng(0), N, G, S)
    return b["commands_grouped"], b["args_grouped"], b["args_rel_grouped"]


@pytest.fixture(scope="module")
def tree(batch):
    c, a, a_rel = (jnp.asarray(x) for x in batch)
    params = jax.jit(JaxSVGTransformer(_jax_cfg()).init)(
        {"params": jax.random.key(0), "vae": jax.random.key(1)}, c, a, c, a_rel)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def latent(batch, tree):
    """The VAE's mean through JAX's encoder: the decoders' common ``z``."""
    c, a, _ = (jnp.asarray(x) for x in batch)
    z, _, _ = JaxSVGTransformer(_jax_cfg()).apply(
        {"params": tree}, c, a, method=JaxSVGTransformer.encode, sample_vae=False)
    return np.asarray(z)


@pytest.fixture(scope="module")
def jax_decoded(tree, latent):
    c, a = jax_sample.autoregressive_sample_cached(
        JaxSVGTransformer(_jax_cfg()), {"params": tree}, jnp.asarray(latent))
    return np.asarray(c), np.asarray(a)


def _variant_matches_jax(change):
    """Sketchformer's small config with ``change``: the port's teacher-forced
    logits from the encoder's latent (the VAE's mean) against JAX's XLA path,
    float32, within LOGIT_TOL, with weights of the JAX model's shapes drawn
    from a numpy seed."""
    kw = {**KW, **change}
    cfg = ModelConfig(**kw)
    jm = JaxSVGTransformer(JaxModelConfig(**kw, attention_impl="xla"))
    b = generate_batch(np.random.default_rng(0), N, G, S)
    data = [jnp.asarray(b[k]) for k in cfg.get_model_args()]
    shapes = jax.eval_shape(lambda *a: jm.init({"params": jax.random.key(0),
                                                "vae": jax.random.key(1)}, *a), *data)
    rng = np.random.default_rng(0)

    def leaf(path, shape):
        name, n = path[-1].key, rng.standard_normal(shape.shape).astype(np.float32)
        if name in ("norm1", "norm2"):
            return np.stack([1 + 0.1 * n[0], 0.1 * n[1]])
        if name == "scale":
            return 1 + 0.1 * n
        return 0.1 * n if n.ndim == 1 else n / np.float32(np.sqrt(shape.shape[0]))
    params = jax.tree_util.tree_map_with_path(leaf, shapes["params"])

    @jax.jit
    def run(p, data):
        z = jm.apply({"params": p}, *data[:2], method=JaxSVGTransformer.encode,
                     sample_vae=False)[0]
        return jm.apply({"params": p}, None, None, *data[2:], z=z, return_tgt=False)
    ref = run(params, data)
    model = SVGTransformer(cfg).eval()
    load_flax_params(model, params)
    port = [torch.from_numpy(b[k]) for k in cfg.get_model_args()]
    with torch.no_grad():
        z = model.encode(*port[:2], sample_vae=False)[0]
        res = model(None, None, *port[2:], z=z)
    assert set(res) == set(ref)
    for key in ref:
        assert res[key].shape == ref[key].shape, key
        np.testing.assert_allclose(res[key].numpy(), np.asarray(ref[key]), atol=LOGIT_TOL,
                                   rtol=0, err_msg=key)


def test_config_and_supported_variants():
    cfg = sketchformer()
    assert (cfg.encode_stages, cfg.decode_stages, cfg.pred_mode, cfg.rel_targets,
            cfg.use_vae, cfg.args_dim_out) == (1, 1, "autoregressive", True, True, 512)
    assert cfg.get_model_args() == ["commands_grouped", "args_grouped", "commands_grouped",
                                    "args_rel_grouped"]
    # the LSTM in place of both transformer stacks (SketchRNN at this size)
    # and a two-stage autoregressive decoder, which raised before they were
    # ported, build and give JAX's teacher-forced logits
    for variant in (dict(model_type="lstm"), dict(decode_stages=2)):
        _variant_matches_jax(variant)
    # a label-conditioned Sketchformer and the one-stage one-shot model build
    for good in (dict(label_condition=True), dict(pred_mode="one_shot")):
        SVGTransformer(ModelConfig(**{**KW, **good}))


def test_weight_bridge_round_trip(tree):
    """Every leaf of the Sketchformer tree is used once and comes back to the
    bit: the two ``SVGEmbedding`` trees with their group tables (10 and 12
    rows), the 512-class argument vocabulary of the decoder, no
    ``hierarchical_*``."""
    model = SVGTransformer(ModelConfig(**KW))
    assert load_flax_params(model, tree) == len(_leaves(tree))
    back, ref = _leaves(to_flax_params(model)), _leaves(tree)
    assert set(back) == set(ref)
    assert ref["encoder/embedding/group_embed"].shape == (G + 2, 64)
    assert ref["decoder/embedding/group_embed"].shape == (G * S + 2, 64)
    assert ref["decoder/embedding/arg_embed"].shape == (512, 64)
    assert not any("hierarchical" in k for k in back)
    for k in ref:
        assert np.array_equal(back[k], ref[k]), k
    with pytest.raises(ValueError, match="unused"):
        load_flax_params(SVGTransformer(ModelConfig(**KW)),
                         dict(tree, extra={"kernel": np.zeros(1, np.float32)}))


def test_make_absolute_matches_jax():
    rng = np.random.default_rng(3)
    commands = rng.integers(0, 7, (3, 2, 12)).astype(np.int32)
    commands[0, 0, 5:] = CMD_EOS
    args = rng.integers(-40, 40, (3, 2, 12, 11)).astype(np.float32)
    args[~CMD_ARGS_MASK.astype(bool)[commands]] = -1.0
    ref = np.asarray(jax_make_absolute(jnp.asarray(commands), jnp.asarray(args)))
    ours = make_absolute(torch.from_numpy(commands), torch.from_numpy(args)).numpy()
    assert np.array_equal(ours, ref)


def test_encoder_matches_jax(batch, tree):
    """The one-stage encoder's pooled output and the VAE's mean and
    log-variance, float32."""
    c, a, _ = batch
    jmodel = JaxSVGTransformer(_jax_cfg())
    enc = jmodel.apply({"params": tree}, jnp.asarray(c), jnp.asarray(a),
                       method=lambda m, c, a: m.encoder(c, a))
    _, mu, logsigma = jmodel.apply({"params": tree}, jnp.asarray(c), jnp.asarray(a),
                                   method=JaxSVGTransformer.encode, sample_vae=False)
    model = _port_model(tree)
    with torch.no_grad():
        enc_p = model.encoder(torch.from_numpy(c), torch.from_numpy(a))
        _, mu_p, logsigma_p = model.encode(torch.from_numpy(c), torch.from_numpy(a),
                                           sample_vae=False)
    for name, ours, ref in (("encoder", enc_p, enc), ("mu", mu_p, mu),
                            ("logsigma", logsigma_p, logsigma)):
        err = np.abs(ours.numpy() - np.asarray(ref)).max()
        print(f"one-stage {name} vs JAX's XLA path: max abs err {err:.3g}")
        assert ours.shape == ref.shape and err <= LOGIT_TOL, (name, err)


def test_teacher_forced_logits_match_jax(batch, tree, latent):
    """The causal decoder over the targets without their last position
    (S = 11), 512 argument classes, float32."""
    c, a, a_rel = batch
    ref = JaxSVGTransformer(_jax_cfg()).apply(
        {"params": tree}, None, None, jnp.asarray(c), jnp.asarray(a_rel),
        z=jnp.asarray(latent))
    with torch.no_grad():
        ours = _port_model(tree)(commands_dec=torch.from_numpy(c),
                                 args_dec=torch.from_numpy(a_rel),
                                 z=torch.from_numpy(latent), return_tgt=True)
    assert "visibility_logits" not in ours and ours["mu"] is None    # z given
    assert ours["args_logits"].shape == (N, 1, G * S + 1, 11, 512)
    for key in ("command_logits", "args_logits"):
        err = np.abs(ours[key].numpy() - np.asarray(ref[key])).max()
        print(f"teacher-forced {key} vs JAX's XLA path: max abs err {err:.3g}")
        assert ours[key].shape == ref[key].shape and err <= LOGIT_TOL, (key, err)


@pytest.mark.parametrize("sampler", ["cached", "fused", "full"])
def test_samplers_match_jax_cached(tree, latent, jax_decoded, sampler):
    fn = {"cached": autoregressive_sample_cached, "fused": autoregressive_sample_fused,
          "full": autoregressive_sample}[sampler]
    c, a = fn(_port_model(tree), torch.from_numpy(latent))
    c_ref, a_ref = jax_decoded
    assert c.shape == c_ref.shape == (N, 1, G * S) and a.shape == a_ref.shape
    assert np.array_equal(c.numpy(), c_ref)
    print(f"{sampler} sampler vs JAX's cached scan: ids equal, arguments max abs err "
          f"{np.abs(a.numpy() - a_ref).max():.3g}")
    assert np.abs(a.numpy() - a_ref).max() <= ARGS_TOL


def test_greedy_sample_encodes_and_takes_the_cached_scan_on_cpu(batch, tree, monkeypatch):
    """On CPU tensors ``greedy_sample`` encodes with the VAE's fixed noise and
    decodes through the cached scan, never through K9's wrapper."""
    c, a, _ = (torch.from_numpy(x) for x in batch)
    model = _port_model(tree)
    with torch.no_grad():
        z, _, _ = model.encode(c, a, rng=DropoutRng.fixed())
    calls = []
    monkeypatch.setattr(decode_ops, "fused_decode_step", lambda *args: calls.append(args))
    out = greedy_sample(model, c, a)
    ref = autoregressive_sample_cached(model, z)
    assert not calls
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_decode_step_logits_equal_teacher_forced(tree, latent, jax_decoded):
    """Feed the decoded buffer back: the logits of the cached step at each
    position equal the teacher-forced forward's there."""
    from deepsvg_tpu_torch.svgtensor import CMD_M, CMD_SOS
    model = _port_model(tree)
    z = torch.from_numpy(latent)
    length = G * S + 1
    raw = {}

    def keep(cfg, commands, args):
        raw["c"], raw["a"] = commands, args
        return commands, args
    from deepsvg_tpu_torch.models import sample as port_sample
    finalize = port_sample._finalize_args
    port_sample._finalize_args = keep
    try:
        autoregressive_sample_cached(model, z)
    finally:
        port_sample._finalize_args = finalize
    cmds = torch.cat([torch.full((N, 1, 1), CMD_SOS, dtype=torch.int32), raw["c"]], dim=-1)
    args = torch.cat([torch.full((N, 1, 1, 11), -1.0), raw["a"]], dim=-2)
    with torch.no_grad():
        tf = model(commands_dec=cmds, args_dec=args, z=z)
        caches = [(torch.zeros(N, length, 64), torch.zeros(N, length, 64)) for _ in range(2)]
        key_pad = torch.zeros(N, length)
        groups = torch.zeros(N, dtype=torch.int32)
        worst = 0.0
        for i in range(length - 1):
            groups += cmds[:, 0, i] == CMD_M
            key_pad[:, i] = torch.where((cmds[:, 0, :i + 1] == CMD_EOS).any(-1), float("-inf"),
                                        0.0)
            cl, al = model.decode_step(z, cmds[:, 0, i], args[:, 0, i], groups, i, caches,
                                       key_pad)
            worst = max(worst, (cl - tf["command_logits"][:, 0, i]).abs().max().item(),
                        (al - tf["args_logits"][:, 0, i]).abs().max().item())
    print(f"decode step vs teacher-forced logits: max abs err {worst:.3g}")
    assert worst <= LOGIT_TOL


@pytest.mark.parametrize("index", [0, 1, 6, 10])
def test_decode_step_plain_matches_jax_fused(index):
    """K9's plain version against the Pallas kernel in interpret mode, float32.
    The JAX kernel clamps its scores to +-75; these scores stay within a few
    units, so the clamp is idle and the two softmaxes compute the same
    function. Rows 1 and 5 have their keys masked from positions 3 and 1 on,
    EOS-padded tails; position 0 stays open, as SOS does in a decode (a row
    masked everywhere would give NaN in JAX)."""
    rng = np.random.default_rng(index)
    n_layers, r, t, d, f, h = 2, 8, 11, 64, 128, 2
    nrm = lambda *shape, s=1.0: (s * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    ln = lambda: np.stack([1 + nrm(n_layers, d, s=0.1), nrm(n_layers, d, s=0.1)], 1)  # noqa: E731
    x, seq_bias = nrm(r, d), nrm(n_layers, r, d, s=0.3)
    ln1, ln2, lnf = ln(), ln(), np.stack([1 + nrm(d, s=0.1), nrm(d, s=0.1)])
    wqkv, bqkv = nrm(n_layers, d, 3 * d, s=d ** -0.5), nrm(n_layers, 3 * d, s=0.1)
    wo, bo = nrm(n_layers, d, d, s=d ** -0.5), nrm(n_layers, d, s=0.1)
    w1, b1 = nrm(n_layers, d, f, s=d ** -0.5), nrm(n_layers, f, s=0.1)
    w2, b2 = nrm(n_layers, f, d, s=f ** -0.5), nrm(n_layers, d, s=0.1)
    kc, vc = nrm(n_layers, r, t, d), nrm(n_layers, r, t, d)
    key_pad = np.zeros((r, t), np.float32)
    key_pad[1, 3:] = -np.inf
    key_pad[5, 1:] = -np.inf
    ref = jax_fused_decode_step(
        *(jnp.asarray(v) for v in (x, seq_bias, ln1, wqkv, bqkv[:, None], wo, bo[:, None], ln2,
                                   w1, b1[:, None], w2, b2[:, None], lnf, kc, vc, key_pad)),
        jnp.asarray([index], jnp.int32), n_heads=h, tile_r=8)
    tr = lambda v: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 2, 1)))  # noqa: E731
    t_ = torch.from_numpy
    ours = decode_ops.fused_decode_step(
        t_(x), t_(seq_bias), t_(ln1), tr(wqkv), t_(bqkv), tr(wo), t_(bo), t_(ln2), tr(w1),
        t_(b1), tr(w2), t_(b2), t_(lnf), t_(kc), t_(vc), t_(key_pad), index, h)
    for name, o, rf in zip(("y", "k_new", "v_new"), ours, ref):
        err = np.abs(o.numpy() - np.asarray(rf)).max()
        print(f"K9 plain vs JAX's kernel, index {index}, {name}: max abs err {err:.3g}")
        assert o.shape == rf.shape and np.isfinite(o.numpy()).all() and err <= 1e-5, (name, err)


@pytest.mark.parametrize("s,causal", [(33, False), (35, True), (37, False), (41, True),
                                      (41, False)])
def test_layer_reference_long_matches_jax(s, causal):
    """``layer_reference`` at the long form's lengths against the JAX
    package's XLA layer (an encoder layer with key padding; a decoder layer,
    causal and key-padded, with the latent injection), float32."""
    rng = np.random.default_rng(s + causal)
    b, d, f, h = 3, 64, 128, 2
    nrm = lambda *shape, sc=1.0: (sc * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    p = {"norm1": np.stack([1 + nrm(d, sc=0.1), nrm(d, sc=0.1)]),
         "wqkv": nrm(d, 3 * d, sc=d ** -0.5), "bqkv": nrm(3 * d, sc=0.1),
         "wo": nrm(d, d, sc=d ** -0.5), "bo": nrm(d, sc=0.1),
         "norm2": np.stack([1 + nrm(d, sc=0.1), nrm(d, sc=0.1)]),
         "ff1_kernel": nrm(d, f, sc=d ** -0.5), "ff1_bias": nrm(f, sc=0.1),
         "ff2_kernel": nrm(f, d, sc=f ** -0.5), "ff2_bias": nrm(d, sc=0.1)}
    x = nrm(b, s, d)
    lengths = np.array([s, s - 7, 1])
    key_pad = np.where(np.arange(s)[None] < lengths[:, None], 0.0, -np.inf).astype(np.float32)
    seq_bias = None
    if causal:
        p.update(glob_kernel=nrm(d, d, sc=d ** -0.5), glob_bias=nrm(d, sc=0.1))
        z = nrm(b, d)
        ref = jax_layers.DecoderLayerGlobalImproved(d, h, f, 0.0).apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(z), key_pad=jnp.asarray(key_pad),
            causal=True)
        seq_bias = torch.from_numpy(z @ p["glob_kernel"] + p["glob_bias"])
    else:
        ref = jax_layers.EncoderLayerImproved(d, h, f, 0.0).apply(
            {"params": p}, jnp.asarray(x), key_pad=jnp.asarray(key_pad))
    t_ = lambda k: torch.from_numpy(np.ascontiguousarray(p[k]))  # noqa: E731
    tt = lambda k: torch.from_numpy(np.ascontiguousarray(p[k].T))  # noqa: E731
    ours = layer_ops.fused_layer(
        torch.from_numpy(x), seq_bias, t_("norm1"), tt("wqkv"), t_("bqkv"), tt("wo"), t_("bo"),
        t_("norm2"), tt("ff1_kernel"), t_("ff1_bias"), tt("ff2_kernel"), t_("ff2_bias"),
        torch.from_numpy(key_pad), h, causal)
    valid = key_pad == 0                     # JAX gives NaN rows for a padded query
    err = np.abs(ours.numpy() - np.asarray(ref))[valid].max()
    print(f"layer_reference S={s} causal={causal} vs JAX's XLA layer: max abs err {err:.3g}")
    assert ours.shape == ref.shape and err <= 1e-5, err


def test_bf16_decode_matches_jax_fused(batch, tree, latent, monkeypatch):
    """bfloat16: the port's fused decode (plain K9 and K3 on the CPU) against
    JAX's (Pallas K9 and head kernels in interpret mode) on the same latent.
    Per sequence, the outputs are equal up to the first position where JAX's
    top-2 margin (from its teacher-forced bfloat16 forward over its own
    decoded tokens) is below ``MARGIN_BF16`` for the command or an argument
    the command uses."""
    z = jnp.asarray(latent).astype(jnp.bfloat16)
    raw = {}
    finalize = jax_sample._finalize_args

    def keep(cfg, commands, args):
        raw["c"], raw["a"] = np.asarray(commands), np.asarray(args)
        return finalize(cfg, commands, args)
    monkeypatch.setattr(jax_sample, "_finalize_args", keep)
    c_ref, a_ref = (np.asarray(v) for v in jax_sample.autoregressive_sample_fused(
        JaxSVGTransformer(_jax_cfg("pallas", "bfloat16")), {"params": tree}, z))
    cmds = np.concatenate([np.full((N, 1, 1), 5, np.int32), raw["c"]], -1)      # SOS
    args = np.concatenate([np.full((N, 1, 1, 11), -1.0, np.float32), raw["a"]], -2)
    tf = JaxSVGTransformer(_jax_cfg("xla", "bfloat16")).apply(
        {"params": tree}, None, None, jnp.asarray(cmds), jnp.asarray(args), z=z)
    top2 = lambda lg: np.diff(np.sort(np.asarray(lg, np.float32), -1)[..., -2:], axis=-1)[..., 0]  # noqa: E731
    m_cmd = top2(tf["command_logits"])[:, 0]          # [N, L]: the buffer less its last
    m_args = top2(tf["args_logits"])[:, 0]            # [N, L, 11]  position (return_tgt)
    used = CMD_ARGS_MASK.astype(bool)[raw["c"][:, 0]]
    margin = np.minimum(m_cmd, np.where(used, m_args, np.inf).min(-1))

    c, a = autoregressive_sample_fused(_port_model(tree, "bfloat16"),
                                       torch.from_numpy(latent).to(torch.bfloat16))
    compared = 0
    for i in range(N):
        low = np.flatnonzero(margin[i] < MARGIN_BF16)
        upto = low[0] if len(low) else margin.shape[1]
        assert np.array_equal(c.numpy()[i, 0, :upto], c_ref[i, 0, :upto]), i
        assert np.array_equal(a.numpy()[i, 0, :upto], a_ref[i, 0, :upto]), i
        compared += upto
    print(f"bf16 decode vs JAX's fused path: {compared} of {margin.size} positions compared "
          f"(margin >= {MARGIN_BF16})")
    assert compared >= N


# ---- K9's launch plan (pure: no card). On the H100 one wave holds 66
# clusters of 2 blocks at one block an SM (cudaOccupancyMaxActiveClusters);
# a block can use 232,448 bytes.
H100_WAVE = 66
SMEM_LIMIT = 232448


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decode_launch_plan_fits_the_card_at_the_decode_batch(dtype):
    """At Sketchformer's decode (R = 1,024 rows, D=256, 8 heads, F=512) the
    cluster kernel takes the step in one wave: blocks of 8 rows with every
    head, 64 clusters of 2 blocks splitting each product's columns (128
    blocks, one an SM), each block within the card's shared memory; R = 1,000 and the
    card tests' smaller batches likewise, their last cluster padded."""
    plan = decode_ops.decode_launch_plan(1024, 256, 512, 8, dtype, H100_WAVE)
    assert plan["takes"] and plan["waves"] == 1 and plan["smem"] <= SMEM_LIMIT
    assert (plan["block_rows"], plan["cluster"], plan["clusters"], plan["grid"]) == (8, 2, 64, 128)
    for r, clusters in ((1, 1), (13, 1), (64, 4), (65, 5), (1000, 63)):
        small = decode_ops.decode_launch_plan(r, 256, 512, 8, dtype, H100_WAVE)
        assert small["takes"] and small["waves"] == 1 and small["smem"] <= SMEM_LIMIT, r
        assert small["clusters"] == clusters and small["grid"] == 2 * clusters, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_launch_plan_over_the_contract(dtype, d):
    """Over K9's contract (heads of 32, D up to 256, F a multiple of 32 up to
    1,024, R from 1 to 4,099, a wave of 1 to 66 clusters): the cluster kernel
    takes exactly D=256 with 8 heads and an F that is a multiple of 256 (its
    weight slabs' rows) whose block fits the card's shared memory (up to
    1,024 in bfloat16, 768 in float32; every width it refuses runs the older
    kernel); the blocks of 8 rows cover the rows once, in whole clusters of
    two; the waves are the clusters over the wave."""
    heads = d // 32
    widest = {torch.bfloat16: 1024, torch.float32: 768}[dtype]
    for f in range(32, 1025, 32):
        for r in (1, 13, 80, 81, 1024, 4099):
            for wave in (1, 15, 66):
                plan = decode_ops.decode_launch_plan(r, d, f, heads, dtype, wave)
                assert plan["takes"] == (d == 256 and f % 256 == 0 and f <= widest), (f, r)
                assert plan["smem"] <= SMEM_LIMIT or not plan["takes"], (f, r)
                rows = plan["block_rows"] * plan["cluster"]
                assert (plan["clusters"] - 1) * rows < r <= plan["clusters"] * rows
                assert plan["grid"] == plan["clusters"] * plan["cluster"]
                assert plan["waves"] == -(-plan["clusters"] // wave)
