"""The port's serving export (``deepsvg_tpu_torch/serving.py``) against the
JAX package's (``deepsvg_tpu/serving.py``), on the CPU.

Small models of the JAX serving tests' configs (``tests/test_inference.py``:
the two-stage one-shot model of the flagship's architecture, its
label-conditioned twin, the one-stage autoregressive model), initialised in
the port from a seed and carried to the JAX package by the weight bridge
(``to_flax_params``); inputs from the port's synthetic generator with a
numpy seed. On the CPU the exported graphs call the ``deepsvg::`` operators,
which run their plain versions. Held:

- the round trip: the port's artifacts against its live model, z to 1e-6
  and the ids equal; against the JAX package's artifacts (its
  ``export_session``, here alone), the ids equal and z and the args within
  the port's float32 forward parity, 1e-4;
- the label-conditioned and the autoregressive exports against the port's
  live decode and JAX's (jitted once each), the ids equal;
- ``serve_batch``: 3 rows to bucket 4, 1 row to bucket 2 (outputs cut back,
  equal to the exact-size calls), 5 rows refused as JAX refuses them, a pad
  spec that does not match the operands refused, a manifest written before
  the pad fills loaded with the contract's;
- the CLI (``python -m deepsvg_tpu_torch.serving``) on
  ``deepsvg_tpu_torch.configs.test_tiny`` in a subprocess;
- an artifact loaded in a process that imports no model code;
- a VAE model: the JAX package's export fails on it (flax's
  ``InvalidRngError``), the port's refuses it with a ValueError;
- the six operators (``torch.library.opcheck``: schema, fake tensors,
  autograd registration, AOT dispatch), each equal to its plain version on
  the CPU, and autograd through a wrapper's plain version on CPU tensors
  that need it (the operators have no backward).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu.models import sample as jax_sample
from deepsvg_tpu.serving import export_session as jax_export_session
from deepsvg_tpu.serving import load_session_exports as jax_load_session_exports
from deepsvg_tpu_torch import serving
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import ModelConfig, SVGTransformer, greedy_sample, to_flax_params
from deepsvg_tpu_torch.models.checkpoint import save_params
from deepsvg_tpu_torch.ops import decode as decode_ops
from deepsvg_tpu_torch.ops import embedding as embedding_ops
from deepsvg_tpu_torch.ops import head as head_ops
from deepsvg_tpu_torch.ops import layer as layer_ops
from deepsvg_tpu_torch.training.trainer import init_parameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(encode_stages=2, decode_stages=2, use_vae=False, max_num_groups=3, max_seq_len=6,
             d_model=32, dim_feedforward=64, dim_z=16, n_layers=1, n_layers_decode=1,
             n_heads=4, dropout=0.0)
# the JAX layers declare glob2 at 64 inputs whatever dim_label is
LABELLED = dict(SMALL, label_condition=True, n_labels=5, dim_label=64)
AUTOREGRESSIVE = dict(encode_stages=1, decode_stages=1, pred_mode="autoregressive",
                      use_vae=False, max_num_groups=2, max_seq_len=5, d_model=32,
                      dim_feedforward=64, dim_z=16, n_layers=1, n_layers_decode=1, n_heads=4,
                      dropout=0.0)
SELF_TOL = 1e-6       # the artifact against the live model: the same operations
PARITY_TOL = 1e-4     # the port against the JAX package: its float32 forward parity


def _model(kw, seed=0):
    model = SVGTransformer(ModelConfig(**kw))
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _jax(kw, model):
    return (JaxSVGTransformer(JaxModelConfig(**kw, attention_impl="xla")),
            {"params": jax.tree_util.tree_map(jnp.asarray, to_flax_params(model))})


def _inputs(kw, n, seed=1):
    """Encoder operands at the export's dtypes: ``[n, G, S+2]`` (one-stage:
    the packed ``[n, 1, T+2]``) int32 commands, float32 args, int32 labels."""
    cfg = ModelConfig(**kw)
    b = generate_batch(np.random.default_rng(seed), n, cfg.max_num_groups, cfg.max_seq_len,
                       label_range=cfg.n_labels if cfg.label_condition else None)
    grouped = cfg.encode_stages <= 1
    ops = [b["commands_grouped" if grouped else "commands"].astype(np.int32),
           b["args_grouped" if grouped else "args"].astype(np.float32)]
    if cfg.label_condition:
        ops.append(b["label"].astype(np.int32))
    return ops


def _live(model, ops):
    t = [torch.from_numpy(x) for x in ops]
    with torch.no_grad():
        z = model.encode(*t)[0]
    return z, greedy_sample(model, z=z.float(), label=t[2] if len(t) > 2 else None)


def _graph_ops(out_dir, name, b):
    program = torch.export.load(os.path.join(out_dir, f"{name}_b{b}.pt2"))
    return {str(n.target).rsplit(".", 1)[0] for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("deepsvg.")}


LOADER = (
    "import sys, numpy as np\n"
    "from deepsvg_tpu_torch.serving import load_session_exports, serve_batch\n"
    "fns = load_session_exports(sys.argv[1])\n"
    "z = serve_batch(fns, 'decode', np.zeros((3, 16), np.float32))\n"
    "bad = [m for m in sys.modules if m.startswith(('deepsvg_tpu_torch.models', "
    "'deepsvg_tpu_torch.configs', 'deepsvg_tpu_torch.training', 'jax', 'deepsvg_tpu.'))]\n"
    "assert not bad, bad\n"
    "print(tuple(z[0].shape))\n")


def _start(*argv):
    """A subprocess of this interpreter with the repository on its path."""
    return subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT))


@pytest.fixture(scope="module", autouse=True)
def cli_run(tmp_path_factory):
    """``python -m deepsvg_tpu_torch.serving`` on ``configs.test_tiny`` and
    flax msgpack weights, started with the module's first test so that it
    runs beside the others: ``(model, out_dir, process)``."""
    from deepsvg_tpu_torch.configs import test_tiny

    tmp = tmp_path_factory.mktemp("served_cli")
    model = _model(dataclass_kw(test_tiny.make_model_config()), seed=8)
    save_params(str(tmp / "weights.msgpack"), to_flax_params(model))
    out = str(tmp / "out")
    proc = _start("-m", "deepsvg_tpu_torch.serving", "--config-module",
                  "deepsvg_tpu_torch.configs.test_tiny", "--checkpoint",
                  str(tmp / "weights.msgpack"), "--out-dir", out, "--batch-sizes", "2",
                  "--device", "cpu")
    yield model, out, proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small model's artifacts at buckets 2 and 4, and a process that
    loads them with no model code, started at once: ``(model, out_dir,
    paths, process)``."""
    model = _model(SMALL)
    out = str(tmp_path_factory.mktemp("served"))
    paths = serving.export_session(model, out, batch_sizes=(2, 4))
    proc = _start("-c", LOADER, out)
    yield model, out, paths, proc
    proc.kill()
    proc.communicate()


def test_round_trip_matches_live_and_jax(small, tmp_path):
    model, out, paths, _ = small
    assert set(paths) == {"encode", "decode"} and set(paths["encode"]) == {2, 4}
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest == {"batch_sizes": [2, 4], "with_label": False,
                        "pad": {"encode": [4, -1.0], "decode": [0.0]},
                        "entries": {"encode:2": "encode_b2.pt2", "encode:4": "encode_b4.pt2",
                                    "decode:2": "decode_b2.pt2", "decode:4": "decode_b4.pt2"}}
    # the graphs call the operators (on the CPU their plain versions)
    assert {"deepsvg.embedding", "deepsvg.layer"} <= _graph_ops(out, "encode", 2)
    assert {"deepsvg.layer", "deepsvg.head_argmax"} <= _graph_ops(out, "decode", 2)

    fns = serving.load_session_exports(out)
    ops = _inputs(SMALL, 2)
    z = fns["encode"][2](*ops)
    cmds, args = fns["decode"][2](z.float())
    z_live, (cmds_live, args_live) = _live(model, ops)
    np.testing.assert_allclose(z.numpy(), z_live.numpy(), rtol=0, atol=SELF_TOL)
    assert torch.equal(cmds, cmds_live) and torch.equal(args, args_live)

    # the JAX package's artifacts from the same weights
    jax_model, variables = _jax(SMALL, model)
    jax_out = str(tmp_path / "jax")
    jax_export_session(jax_model, variables, jax_out, batch_sizes=(2,))
    jax_fns = jax_load_session_exports(jax_out)
    z_jax = np.asarray(jax_fns["encode"][2](*ops))
    cmds_jax, args_jax = jax_fns["decode"][2](np.asarray(z_jax, np.float32))
    np.testing.assert_allclose(z.numpy(), z_jax, rtol=0, atol=PARITY_TOL)
    np.testing.assert_array_equal(cmds.numpy(), np.asarray(cmds_jax))
    np.testing.assert_allclose(args.numpy(), np.asarray(args_jax), rtol=0, atol=PARITY_TOL)


def test_label_conditioned_export(tmp_path):
    model = _model(LABELLED, seed=3)
    out = str(tmp_path / "served_fonts")
    serving.export_session(model, out, batch_sizes=(2,))
    fns = serving.load_session_exports(out)
    assert fns["__pad__"] == {"encode": [4, -1.0, 0], "decode": [0.0, 0]}
    ops = _inputs(LABELLED, 2, seed=4)
    z = fns["encode"][2](*ops)
    cmds, args = fns["decode"][2](z.float(), ops[2])
    z_live, (cmds_live, args_live) = _live(model, ops)
    np.testing.assert_allclose(z.numpy(), z_live.numpy(), rtol=0, atol=SELF_TOL)
    assert torch.equal(cmds, cmds_live) and torch.equal(args, args_live)

    jax_model, variables = _jax(LABELLED, model)

    @jax.jit
    def jax_encode_decode(c, a, label):
        z = jax_model.apply(variables, c, a, None, None, label=label, encode_mode=True,
                            deterministic=True)
        return (z,) + tuple(jax_sample.greedy_sample(jax_model, variables, z=z, label=label))

    z_jax, cmds_jax, _ = jax_encode_decode(*ops)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jax), rtol=0, atol=PARITY_TOL)
    np.testing.assert_array_equal(cmds.numpy(), np.asarray(cmds_jax))


def test_autoregressive_export(tmp_path):
    """The one-stage autoregressive model: the packed [B, 1, T+2] encoder
    operands, the decode unrolled over max_total_len steps (on the CPU the
    cached scan in plain operations, as ``greedy_sample`` dispatches)."""
    model = _model(AUTOREGRESSIVE, seed=5)
    out = str(tmp_path / "served_ar")
    serving.export_session(model, out, batch_sizes=(2,))
    fns = serving.load_session_exports(out)
    ops = _inputs(AUTOREGRESSIVE, 2, seed=5)
    assert ops[0].shape == (2, 1, ModelConfig(**AUTOREGRESSIVE).max_total_len + 2)
    z = fns["encode"][2](*ops)
    cmds, args = fns["decode"][2](z.float())
    z_live, (cmds_live, args_live) = _live(model, ops)
    np.testing.assert_allclose(z.numpy(), z_live.numpy(), rtol=0, atol=SELF_TOL)
    assert torch.equal(cmds, cmds_live) and torch.equal(args, args_live)

    jax_model, variables = _jax(AUTOREGRESSIVE, model)
    cmds_jax, args_jax = jax.jit(lambda z: jax_sample.greedy_sample(
        jax_model, variables, z=z))(z.float().numpy())
    np.testing.assert_array_equal(cmds.numpy(), np.asarray(cmds_jax))
    np.testing.assert_allclose(args.numpy(), np.asarray(args_jax), rtol=0, atol=PARITY_TOL)


def test_serve_batch_bucket_routing(small, tmp_path):
    model, out, _, _ = small
    fns = serving.load_session_exports(out)
    c, a = _inputs(SMALL, 3, seed=6)
    # 3 rows -> bucket 4, cut back to 3
    z = serving.serve_batch(fns, "encode", c, a)
    assert z.shape[0] == 3
    pad_c = np.concatenate([c, np.full((1,) + c.shape[1:], 4, np.int32)])
    pad_a = np.concatenate([a, np.full((1,) + a.shape[1:], -1, np.float32)])
    assert torch.equal(z, fns["encode"][4](pad_c, pad_a)[:3])
    cmds, args = serving.serve_batch(fns, "decode", z.float())
    assert cmds.shape[0] == 3 and args.shape[0] == 3
    # 1 row -> bucket 2
    z1 = serving.serve_batch(fns, "encode", c[:1], a[:1])
    np.testing.assert_allclose(z1.numpy(), z[:1].numpy(), rtol=0, atol=SELF_TOL)
    # over the largest bucket, and operands the pad spec does not match
    big_c, big_a = np.repeat(c[:1], 5, axis=0), np.repeat(a[:1], 5, axis=0)
    with pytest.raises(ValueError, match="largest exported bucket"):
        serving.serve_batch(fns, "encode", big_c, big_a)
    with pytest.raises(ValueError, match="no pad spec"):
        serving.serve_batch(fns, "encode", c, a, np.zeros(3, np.int32))
    # a manifest written before the pad fills: the contract's
    old = tmp_path / "old"
    old.mkdir()
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    del manifest["pad"]
    manifest["entries"] = {"decode:2": os.path.join(out, "decode_b2.pt2")}
    (old / "manifest.json").write_text(json.dumps(manifest))
    assert serving.load_session_exports(str(old))["__pad__"] == {
        "encode": [4, -1.0], "decode": [0.0]}


def test_cli_round_trip(cli_run):
    """The CLI's artifacts reproduce the session of its config and weights."""
    from deepsvg_tpu_torch.configs import test_tiny

    model, out, proc = cli_run
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    assert "exported 2 entries" in stdout
    fns = serving.load_session_exports(out)
    ops = _inputs(dataclass_kw(test_tiny.make_model_config()), 2, seed=9)
    z = fns["encode"][2](*ops)
    z_live, (cmds_live, _) = _live(model, ops)
    np.testing.assert_allclose(z.numpy(), z_live.numpy(), rtol=0, atol=SELF_TOL)
    assert torch.equal(fns["decode"][2](z.float())[0], cmds_live)


def dataclass_kw(cfg) -> dict:
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_artifact_loads_without_model_code(small):
    """A process that imports ``deepsvg_tpu_torch.serving`` alone loads the
    artifacts and serves a batch, with no model, config or training module
    (and no JAX) imported."""
    proc = small[3]
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    assert stdout.strip() == "(3, 3, 7)"


def test_vae_export_refused(tmp_path):
    """The JAX package's served encode (``serving._encode_fn``) samples the
    VAE's latent from a "vae" stream that it is not given, so its
    ``export_session`` fails at the trace; the port refuses the model."""
    import flax

    from deepsvg_tpu.serving import _encode_fn as jax_encode_fn

    kw = dict(SMALL, use_vae=True)
    model = _model(kw, seed=10)
    jax_model, variables = _jax(kw, model)
    with pytest.raises(flax.errors.InvalidRngError, match="vae"):
        jax.eval_shape(jax_encode_fn(jax_model, variables, False), *_inputs(kw, 2))
    with pytest.raises(ValueError, match="VAE model cannot be exported"):
        serving.export_session(model, str(tmp_path / "vae"), batch_sizes=(2,))


def _operator_cases():
    """Each operator's CPU operands at small widths and its plain version."""
    g = torch.Generator().manual_seed(11)
    r = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    d, f, n = 32, 64, 2
    layer = (r(2, 5, d), r(2, d), r(2, d), r(3 * d, d), r(3 * d), r(d, d), r(d), r(2, d),
             r(f, d), r(f), r(d, f), r(d), torch.zeros(2, 5))
    w, b = head_ops.pack_head(r(7, d), r(7), r(11 * 9, d), r(11 * 9), 11)
    stack = (r(3, d), r(n, 3, d), r(n, 2, d), r(n, 3 * d, d), r(n, 3 * d), r(n, d, d),
             r(n, d), r(n, 2, d), r(n, f, d), r(n, f), r(n, d, f), r(n, d), r(2, d),
             r(n, 3, 6, d), r(n, 3, 6, d), torch.zeros(3, 6))
    embed = (torch.randint(0, 7, (2, 5), generator=g),
             torch.randint(-1, 8, (2, 5, 11), generator=g).float(), None, r(7, 16), r(99, 16),
             None, r(5, 16))
    return {
        "embedding": ((*embed, False), lambda: embedding_ops.embedding_reference(*embed)),
        "layer": ((*layer, 4, False), lambda: layer_ops.layer_reference(*layer, 4, False)),
        "layer_f32": ((*layer, 4, False, True),
                      lambda: layer_ops.layer_reference(*layer, 4, False)),
        "layer_long": ((*layer, 4, True), lambda: layer_ops.layer_reference(*layer, 4, True)),
        "head_argmax": ((r(6, d), w, b, 7, 11, 9), None),
        "decode_step": ((*stack, 3, 4), lambda: decode_ops.decode_step_reference(*stack, 3, 4)),
    }


@pytest.mark.parametrize("name", ["embedding", "layer", "layer_f32", "layer_long",
                                  "head_argmax", "decode_step"])
def test_operator_contract(name):
    args, plain = _operator_cases()[name]
    op = getattr(torch.ops.deepsvg, name).default
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = op(*args)
    want = plain() if plain else head_ops.head_argmax_reference(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


def test_wrappers_keep_autograd_on_the_cpu():
    """A CPU tensor that autograd differentiates through takes the plain
    version directly (a latent optimised through the decoder, say); the
    gradients are the plain version's."""
    args, _ = _operator_cases()["layer"]
    x = args[0].clone().requires_grad_()
    bias = args[1].clone().requires_grad_()
    layer_ops.fused_layer(x, bias, *args[2:13], 4).square().sum().backward()
    x2 = args[0].clone().requires_grad_()
    bias2 = args[1].clone().requires_grad_()
    layer_ops.layer_reference(x2, bias2, *args[2:13], 4).square().sum().backward()
    assert torch.equal(x.grad, x2.grad) and torch.equal(bias.grad, bias2.grad)
