"""The port's ``utils/flops.py`` against the JAX package's, on the CPU.

``flops_per_sample`` reads the port's ``ModelConfig``; for the flagship, the
tiny config and Sketchformer it must give the JAX module's integers exactly,
on the JAX package's own config modules (``configs_tpu``), for the whole
model and for its encoder and decoder alone. ``peak_flops_per_chip`` knows
the H100 by the name ``torch.cuda.get_device_name`` gives, and no TPU.
"""
import importlib

import pytest

from deepsvg_tpu.utils import flops as jax_flops
from deepsvg_tpu_torch.utils import flops as port_flops

CONFIGS = ["hierarchical_ordered", "test_tiny", "sketchformer"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("encode,decode", [(True, True), (True, False), (False, True)],
                         ids=["model", "encoder", "decoder"])
def test_flops_per_sample_matches_jax(name, encode, decode):
    port_cfg = importlib.import_module(f"deepsvg_tpu_torch.configs.{name}").make_model_config()
    jax_cfg = importlib.import_module(f"configs_tpu.{name}").make_model_config()
    got = port_flops.flops_per_sample(port_cfg, decode=decode, encode=encode)
    want = jax_flops.flops_per_sample(jax_cfg, decode=decode, encode=encode)
    assert isinstance(got, int) and got == want > 0


def test_peak_flops_per_chip_knows_the_h100_and_no_tpu():
    assert port_flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert port_flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3", "float32") == 495e12
    assert port_flops.peak_flops_per_chip("NVIDIA H100 PCIe") == 756e12
    for kind in ("TPU v4", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        assert port_flops.peak_flops_per_chip(kind) is None
