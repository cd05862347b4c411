"""The port's reconstruction evaluation and the icons config's
``visualize`` hook against the JAX package's, on the CPU.

One small model of the flagship's architecture (two-stage one-shot, with
the VAE: d_model 32, 4 heads, one layer a stack, G=8 paths of S=30
commands), initialised in the port from a seed and handed to the JAX model
through the weight bridge (``to_flax_params``). JAX's side runs its XLA path
with its samplers jitted (its hooks call them eagerly, which dispatches op
by op: the same arithmetic, compiled once).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepsvg_tpu.evaluation as jax_eval
import deepsvg_tpu.models.sample as jax_sample
import deepsvg_tpu_torch.evaluation as port_eval
from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import ModelConfig, SVGTransformer, to_flax_params
from deepsvg_tpu_torch.training.trainer import init_parameters

VALUE_TOL = 1e-5
N, G, S = 4, 8, 30
SMALL = dict(encode_stages=2, decode_stages=2, max_num_groups=G, max_seq_len=S, d_model=32,
             dim_feedforward=64, dim_z=16, n_layers=1, n_layers_decode=1, n_heads=4,
             dropout=0.0, use_vae=True)


def _icons(seed, n=N):
    return generate_batch(np.random.default_rng(seed), n, G, S)


@functools.lru_cache(maxsize=None)
def _models(use_vae: bool):
    """The port's model (seeded) and the JAX model with the same weights."""
    kw = dict(SMALL, use_vae=use_vae)
    model = SVGTransformer(ModelConfig(**kw))
    with torch.no_grad():
        init_parameters(model, torch.Generator().manual_seed(21))
    jm = JaxSVGTransformer(JaxModelConfig(**kw, attention_impl="xla"))
    return model.eval(), jm, {"params": to_flax_params(model)}


@pytest.fixture(scope="module")
def models():
    return _models(True)


@pytest.fixture(scope="module")
def jax_reconstruct():
    return jax.jit(jax_eval.reconstruct, static_argnums=0)


def test_reconstruct_matches_jax(models, jax_reconstruct):
    """Encode to the VAE's mean, greedy one-shot decode: the ids equal to
    JAX's, aligned to the post-SOS layout ``[N, G, S+1]``."""
    model, jm, variables = models
    b = _icons(11)
    want = jax_reconstruct(jm, variables, jnp.asarray(b["commands"]), jnp.asarray(b["args"]))
    got = port_eval.reconstruct(model, torch.from_numpy(b["commands"]),
                                torch.from_numpy(b["args"]))
    assert got[0].shape == (N, G, S + 1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_evaluate_batches_matches_jax(models, jax_reconstruct, monkeypatch):
    """Two batches through both packages' ``evaluate_batches`` with the
    groups matched: every ratio within 1e-5 relative, and the sample
    count."""
    model, jm, variables = models
    batches = [_icons(11), _icons(12)]
    monkeypatch.setattr(jax_eval, "reconstruct", jax_reconstruct)
    want = jax_eval.evaluate_batches(jm, variables, batches, match_groups=True)
    got = port_eval.evaluate_batches(model, batches, match_groups=True)
    assert set(got) == set(want) and got["n_samples"] == 2 * N
    for k, w in want.items():
        assert abs(got[k] - w) <= VALUE_TOL * max(abs(w), 1.0), (k, got[k], w)


class _Writer:
    """A summary writer that records what it is given."""

    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step):
        self.images.append((tag, np.asarray(img), step))


def test_icons_visualize_matches_jax(monkeypatch):
    """The icons config's hook: one batched ``greedy_sample``, each decode
    beside its input rendered; the recorded images equal to the JAX hook's,
    pixel for pixel, on the same weights and items. The model has no VAE:
    the two packages draw a VAE's noise from different generators."""
    from configs_tpu.default_icons import Config as JaxConfig
    from deepsvg_tpu_torch.configs.default_icons import Config as PortConfig
    from deepsvg_tpu_torch.data.synthetic import SyntheticIconDataset

    model, jm, variables = _models(False)
    dataset = SyntheticIconDataset(n=6, seed=3, max_num_groups=G, max_seq_len=S)

    class TrainVars:
        x_inputs_train = [dataset.get(i, ["commands", "args", "tensor"]) for i in range(6)]

    monkeypatch.setattr(jax_sample, "greedy_sample",
                        jax.jit(jax_sample.greedy_sample, static_argnums=0))
    writers = [_Writer(), _Writer()]
    JaxConfig().visualize(jm, variables, TrainVars, 7, 0, writers[0], None)
    PortConfig().visualize(model, TrainVars, 7, 0, writers[1], None)
    want, got = writers[0].images, writers[1].images
    assert len(want) > 0 and [t for t, _, _ in got] == [t for t, _, _ in want]
    for (tag, img, step), (_, img_ref, step_ref) in zip(got, want):
        assert step == step_ref == 7 and img.shape == (3, 200, 200)
        np.testing.assert_array_equal(img, img_ref, err_msg=tag)
