"""Temperature sampling in the port against the JAX package, on the CPU.

JAX keys and PyTorch generators cannot draw the same samples, so the draws
are held by what both must give: at temperature 1e-4 the ids of the greedy
decode (wherever the two best logits are not a near-tie), at temperature 1
the softmax's frequencies. Held:

- ``sample_categorical``: at 1e-4 the argmax wherever the top-2 gap is at
  least GAP; at 1, over DRAWS draws from a seeded generator on a fixed small
  logit table, each class's frequency within 4 standard errors of the
  softmax and of JAX's ``sample_categorical`` frequencies (DRAWS draws from
  a key); the same generator state gives the same draws;
- ``threshold_sample``'s temperature against JAX's;
- ``one_shot_sample`` of the trained flagship (the checkpoint in the repo)
  with a generator: at 1e-4 the greedy ids where JAX's margin allows, and
  JAX's own draws at 1e-4 with a key the same; at 1 valid output that
  differs from the greedy one; the one-stage model's draws (no visibility
  threshold);
- the autoregressive samplers of a small Sketchformer (the cached scan, the
  decode through K9's and K3's plain versions, the full re-forward, and
  ``greedy_sample``) with a generator: at 1e-4 the greedy decode, at 1 valid
  output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models import sample as jax_sample
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import (
    ModelConfig, SVGTransformer, autoregressive_sample, autoregressive_sample_cached,
    autoregressive_sample_fused, greedy_sample, hierarchical_ordered, load_flax_params,
    one_shot_sample, sample_categorical, threshold_sample)
from deepsvg_tpu_torch.svgtensor import CMD_ARGS_MASK
from deepsvg_tpu_torch.training.trainer import init_parameters

ARTIFACT = "docs/artifacts/full_run_final_params.msgpack"
DRAWS = 20_000
SIGMAS = 4.0
GAP = 1e-2               # at T = 1e-4, ids may differ from the argmax only below this gap
LOW_T = 1e-4
TABLE = np.array([[2.0, 1.0, 0.5, -1.0, 0.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0],
                  [-3.0, 4.0, 3.5, 0.0, 1.0]], np.float32)


def _top2_gap(logits):
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _frequencies(ids, k):
    return np.stack([np.bincount(row, minlength=k) for row in ids]) / ids.shape[1]


# --------------------------------------------------------- the draws themselves

def test_low_temperature_draws_the_argmax():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(4000, 9)).astype(np.float32))
    ids = sample_categorical(logits, LOW_T, _gen())
    greedy = sample_categorical(logits, LOW_T)           # no generator: the argmax
    assert torch.equal(greedy, logits.argmax(-1))
    differ = (ids != greedy).numpy()
    assert not (differ & (_top2_gap(logits) >= GAP)).any()
    assert differ.mean() < 1e-3


def test_draws_follow_the_softmax_and_jax():
    """Per row of TABLE, DRAWS draws at temperature 1 (and the second row at
    2): each class's frequency within SIGMAS standard errors of the softmax,
    and of JAX's frequencies from DRAWS draws of its own."""
    k = TABLE.shape[1]
    for temperature in (1.0, 2.0):
        logits = np.repeat(TABLE[:, None], DRAWS, axis=1)               # [3, DRAWS, k]
        ours = sample_categorical(torch.from_numpy(logits), temperature, _gen(1)).numpy()
        theirs = np.asarray(jax_sample.sample_categorical(jax.random.key(1), jnp.asarray(logits),
                                                          temperature))
        assert ours.shape == theirs.shape == (3, DRAWS)
        p = np.asarray(jax.nn.softmax(TABLE / temperature, axis=-1), np.float64)
        f_ours, f_theirs = _frequencies(ours, k), _frequencies(theirs, k)
        se = np.sqrt(p * (1 - p) / DRAWS)
        print(f"T={temperature}: softmax {np.round(p, 4).tolist()}\n ours {f_ours.tolist()}\n"
              f" JAX's {f_theirs.tolist()}")
        assert (np.abs(f_ours - p) <= SIGMAS * se).all()
        assert (np.abs(f_ours - f_theirs) <= SIGMAS * np.sqrt(2) * se).all()


def test_a_generator_state_gives_the_same_draws():
    logits = torch.from_numpy(np.repeat(TABLE[:1], 64, axis=0))
    a = sample_categorical(logits, 1.0, _gen(5))
    assert torch.equal(a, sample_categorical(logits, 1.0, _gen(5)))
    assert not torch.equal(a, sample_categorical(logits, 1.0, _gen(6)))


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_threshold_sample_temperature_matches_jax(temperature):
    logits = np.random.default_rng(3).normal(size=(64, 8, 2)).astype(np.float32)
    ref = np.asarray(jax_sample.threshold_sample(jnp.asarray(logits), 0.7, temperature))
    ours = threshold_sample(torch.from_numpy(logits), 0.7, temperature).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ref.any() and not ref.all()


# --------------------------------------------------------------- one-shot models

@pytest.fixture(scope="module")
def flagship():
    """The trained flagship, its batch, and JAX's logits, greedy sample and
    draws at 1e-4 with a key."""
    with open(ARTIFACT, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    b = generate_batch(np.random.default_rng(0), 4)
    c, a = jnp.asarray(b["commands"]), jnp.asarray(b["args"])
    jm = JaxSVGTransformer(JaxModelConfig(encode_stages=2, decode_stages=2, use_vae=False))
    variables = {"params": params}
    model = SVGTransformer(hierarchical_ordered()).eval()
    load_flax_params(model, params)
    return dict(
        model=model, c=torch.from_numpy(b["commands"]), a=torch.from_numpy(b["args"]),
        logits=jm.apply(variables, c, a, None, None, return_tgt=False),
        greedy=jax_sample.one_shot_sample(jm, variables, commands_enc=c, args_enc=a),
        drawn=jax_sample.one_shot_sample(jm, variables, commands_enc=c, args_enc=a,
                                         temperature=LOW_T, key=jax.random.key(7)))


def _slots_close(logits):
    """Per position: its command's, and per slot its argument's, top-2 gap
    below GAP."""
    cmd = _top2_gap(logits["command_logits"]) < GAP
    return cmd, cmd[..., None] | (_top2_gap(logits["args_logits"]) < GAP)


def test_one_shot_low_temperature_is_greedy(flagship):
    """The port's draws at 1e-4 equal its greedy sample, and JAX's greedy
    sample and JAX's draws at 1e-4, wherever the logits are not a near-tie
    (visibility is the same threshold in all four)."""
    model, c, a = flagship["model"], flagship["c"], flagship["a"]
    greedy = one_shot_sample(model, c, a)
    drawn = one_shot_sample(model, c, a, temperature=LOW_T, generator=_gen(2))
    cmd_close, args_close = _slots_close(flagship["logits"])
    for ref in (greedy, (torch.from_numpy(np.asarray(x)) for x in flagship["greedy"]),
                (torch.from_numpy(np.asarray(x)) for x in flagship["drawn"])):
        ref_c, ref_a = ref
        assert drawn[0].shape == ref_c.shape and drawn[1].shape == ref_a.shape
        assert not ((drawn[0] != ref_c).numpy() & ~cmd_close).any()
        assert not ((drawn[1] != ref_a).numpy() & ~args_close).any()
    assert drawn[0].dtype == torch.int32 and drawn[1].dtype == torch.float32


def _valid(c, a, cfg):
    used = torch.as_tensor(CMD_ARGS_MASK)[c.long()] > 0
    return (int(c.min()) >= 0 and int(c.max()) < cfg.n_commands and float(a.min()) >= -1
            and float(a.max()) <= cfg.args_dim - 1 and bool((a[~used] == -1).all()))


def test_one_shot_temperature_one_draws_valid_output(flagship):
    model, c, a = flagship["model"], flagship["c"], flagship["a"]
    drawn = one_shot_sample(model, c, a, temperature=1.0, generator=_gen(3))
    greedy = one_shot_sample(model, c, a)
    assert _valid(*drawn, model.cfg)
    assert not torch.equal(drawn[1], greedy[1])
    again = one_shot_sample(model, c, a, temperature=1.0, generator=_gen(3))
    assert torch.equal(again[0], drawn[0]) and torch.equal(again[1], drawn[1])


def test_one_stage_one_shot_draws():
    """The one-stage model (no visibility head): at 1e-4 its greedy ids where
    its logits allow; at 1, valid output of ``[N, 1, max_total_len + 1]``."""
    cfg = ModelConfig(encode_stages=1, decode_stages=1, use_vae=False, d_model=64, n_heads=2,
                      dim_feedforward=128, dim_z=48, n_layers=2, n_layers_decode=2,
                      dropout=0.0, max_num_groups=2, max_seq_len=6)
    model = SVGTransformer(cfg).eval()
    init_parameters(model, _gen(4))
    b = generate_batch(np.random.default_rng(4), 5, 2, 6)
    c, a = torch.from_numpy(b["commands_grouped"]), torch.from_numpy(b["args_grouped"])
    with torch.no_grad():
        logits = model(c, a)
    greedy = greedy_sample(model, c, a)
    drawn = greedy_sample(model, c, a, temperature=LOW_T, generator=_gen(5))
    assert greedy[0].shape == drawn[0].shape == (5, 1, 13)
    cmd_close, args_close = _slots_close({k: v.numpy() for k, v in logits.items()})
    assert not ((drawn[0] != greedy[0]).numpy() & ~cmd_close).any()
    assert not ((drawn[1] != greedy[1]).numpy() & ~args_close).any()
    hot = greedy_sample(model, c, a, temperature=1.0, generator=_gen(5))
    assert _valid(*hot, cfg) and not torch.equal(hot[0], greedy[0])


# ----------------------------------------------------------- autoregressive models

@pytest.fixture(scope="module")
def sketchformer():
    cfg = ModelConfig(pred_mode="autoregressive", rel_targets=True, d_model=64, n_heads=2,
                      dim_feedforward=128, dim_z=48, n_layers=2, n_layers_decode=2,
                      dropout=0.0, max_num_groups=2, max_seq_len=5)
    model = SVGTransformer(cfg).eval()
    init_parameters(model, _gen(6))
    # larger heads than the initialisation's: logits of order 1, so that the
    # greedy decode has margins to hold the low-temperature draws to
    with torch.no_grad():
        model.decoder.fcn.command_fcn.weight.mul_(8.0)
        model.decoder.fcn.args_fcn.weight.mul_(8.0)
    b = generate_batch(np.random.default_rng(6), 6, 2, 5)
    c, a = torch.from_numpy(b["commands_grouped"]), torch.from_numpy(b["args_grouped"])
    z, _, _ = model.encode(c, a, sample_vae=False)
    return model, z.detach(), c, a


@pytest.fixture(scope="module")
def greedy_margins(sketchformer, monkeypatch_module):
    """The greedy cached decode, and per sequence its first position whose
    command logits, or the logits of any argument slot, have two best values
    closer than GAP (read from the decode's own logits)."""
    from deepsvg_tpu_torch.models import sample as sample_mod
    model, z, _, _ = sketchformer
    seen = []
    draw = sample_mod.sample_categorical

    def spy(logits, *rest):
        seen.append(logits.detach().numpy())
        return draw(logits, *rest)
    monkeypatch_module.setattr(sample_mod, "sample_categorical", spy)
    greedy = autoregressive_sample_cached(model, z)
    monkeypatch_module.undo()
    gap_c = np.stack([_top2_gap(x) for x in seen[0::2]], 1)             # [N, steps]
    gap_a = np.stack([_top2_gap(x).min(-1) for x in seen[1::2]], 1)
    close = (gap_c < GAP) | (gap_a < GAP)
    first = np.where(close.any(1), close.argmax(1), close.shape[1])
    return greedy, first


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("sampler", [autoregressive_sample_cached, autoregressive_sample_fused,
                                     autoregressive_sample])
def test_autoregressive_low_temperature_is_greedy(sketchformer, greedy_margins, sampler):
    """At 1e-4 each sampler's draws are the greedy decode: each sequence's
    ids equal before its first position whose greedy logits are a near-tie
    (below GAP); the greedy decodes of the three samplers are one."""
    model, z, _, _ = sketchformer
    (ref_c, ref_a), first = greedy_margins
    greedy = sampler(model, z)
    assert torch.equal(greedy[0], ref_c) and torch.allclose(greedy[1], ref_a, atol=1e-5)
    drawn = sampler(model, z, temperature=LOW_T, generator=_gen(8))
    same = ((drawn[0] == ref_c)[:, 0] & (drawn[1] == ref_a)[:, 0].all(-1)).numpy()
    for i, f in enumerate(first):
        assert same[i, :f].all(), (i, f)
    assert first.sum() >= model.cfg.max_total_len        # positions compared


def test_autoregressive_temperature_one_draws_valid_output(sketchformer):
    model, z, c, a = sketchformer
    greedy = greedy_sample(model, c, a)
    drawn = greedy_sample(model, c, a, temperature=1.0, generator=_gen(9))
    again = greedy_sample(model, c, a, temperature=1.0, generator=_gen(9))
    assert drawn[0].shape == greedy[0].shape == (6, 1, model.cfg.max_total_len)
    assert torch.equal(drawn[0], again[0]) and torch.equal(drawn[1], again[1])
    assert not torch.equal(drawn[0], greedy[0])
    used = torch.as_tensor(CMD_ARGS_MASK)[drawn[0].long()] > 0
    assert int(drawn[0].min()) >= 0 and int(drawn[0].max()) < model.cfg.n_commands
    assert bool((drawn[1][~used] == -1).all())
