"""The port's bfloat16 path against the JAX package's bfloat16 path, on the
CPU, with the trained checkpoint in the repo.

The port serves in bfloat16 (``gpu_fast``); here its plain versions run that
profile on CPU tensors and are held against JAX's bfloat16 forward on the
Pallas path (the kernels ``tpu_fast`` selects, in interpret mode) and on the
XLA path, on the same batch. The packages round at different points, so the
limits are statistical: the RMS and largest difference of the logits, and
the agreement of the greedy ids wherever JAX's two best logits differ by at
least ``MARGIN``. Known differences (ROADMAP.md, "Faults"): the port runs
E2 with a bfloat16 input and residual stream where JAX keeps them in
float32, and it keeps the stacks' final LayerNorm parameters in bfloat16
where flax keeps them in float32. For scale, JAX's own float32 forward
differs from its bfloat16 one by an argument-logit RMS of about 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from deepsvg_tpu.models import ModelConfig as JaxModelConfig
from deepsvg_tpu.models import SVGTransformer as JaxSVGTransformer
from deepsvg_tpu_torch.data import generate_batch
from deepsvg_tpu_torch.models import gpu_fast, hierarchical_ordered, load_model

ARTIFACT = "docs/artifacts/full_run_final_params.msgpack"
N = 4
MARGIN = 0.1
MAX_ABS = 1.0          # largest logit difference, any head
ARGS_RMS = 0.05        # RMS of the argument-logit difference
ID_AGREEMENT = 0.98    # ids equal where JAX's top-2 margin >= MARGIN


def _top2_margin(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _ids(logits):
    return np.concatenate([logits["command_logits"].argmax(-1)[..., None],
                           logits["args_logits"].argmax(-1)], -1)


@pytest.fixture(scope="module")
def batch():
    b = generate_batch(np.random.default_rng(0), N)
    return b["commands"], b["args"]


@pytest.fixture(scope="module")
def port_logits(batch):
    model = load_model(ARTIFACT, gpu_fast(hierarchical_ordered()), device="cpu")
    assert next(model.parameters()).dtype == torch.bfloat16
    with torch.no_grad():
        res = model(torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))
    return {k: v.float().numpy() for k, v in res.items()}


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_bf16_logits_and_ids_match_jax_bf16(batch, port_logits, impl):
    with open(ARTIFACT, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    cfg = JaxModelConfig(encode_stages=2, decode_stages=2, use_vae=False,
                         label_condition=False, attention_impl=impl,
                         compute_dtype="bfloat16")
    ref = JaxSVGTransformer(cfg).apply({"params": params}, jnp.asarray(batch[0]),
                                       jnp.asarray(batch[1]), None, None,
                                       return_tgt=False)
    ref = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), ref)
    max_abs = {k: float(np.abs(port_logits[k] - ref[k]).max()) for k in ref}
    rms = float(np.sqrt(((port_logits["args_logits"] - ref["args_logits"]) ** 2).mean()))
    margin = np.concatenate([_top2_margin(ref["command_logits"])[..., None],
                             _top2_margin(ref["args_logits"])], -1)
    agree = float((_ids(port_logits) == _ids(ref))[margin >= MARGIN].mean())
    print(f"{impl}: max |diff| {max_abs}, args RMS {rms:.4g}, id agreement {agree:.4f}")
    assert max(max_abs.values()) <= MAX_ABS, max_abs
    assert rms <= ARGS_RMS, rms
    assert agree >= ID_AGREEMENT, agree
