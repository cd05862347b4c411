"""The Sketchformer baseline, counterpart of ``configs_tpu/sketchformer.py``:
a one-stage autoregressive transformer with relative targets, trained with
the icons config's recipe. Greedy decoding runs through the KV-cached decode
kernel K9 on the card (``models/sample.py:greedy_sample``)."""
from deepsvg_tpu_torch.models.config import gpu_fast, sketchformer

from .default_icons import Config as IconsConfig


def make_model_config():
    return gpu_fast(sketchformer())


class Config(IconsConfig):
    def __init__(self, num_devices=1):
        super().__init__(num_devices=num_devices)
        self.model_cfg = make_model_config()
        self.model_args = self.model_cfg.get_model_args()
