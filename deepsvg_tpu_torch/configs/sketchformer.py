"""The Sketchformer baseline, counterpart of ``configs_tpu/sketchformer.py``:
a one-stage autoregressive transformer with relative targets, trained with
the icons config's recipe (B=60, lr 1e-3, the KL ramp; its data budget,
``max_total_len`` 50, packs each icon into 52 positions). On the card the
step runs its encoder and causal teacher-forced decoder through the long form
of the training layer kernel K4 (33 <= S <= 256; 242 and 241 at the model's
own ``max_total_len`` of 240), the embedding through K1 and K6, and the
512-class argument loss through K5; greedy decoding runs through the
KV-cached decode kernel K9 (``models/sample.py:greedy_sample``)."""
from deepsvg_tpu_torch.models.config import gpu_fast, sketchformer

from .default_icons import Config as IconsConfig


def make_model_config():
    return gpu_fast(sketchformer())


class Config(IconsConfig):
    def __init__(self, num_devices=1):
        super().__init__(num_devices=num_devices)
        self.model_cfg = make_model_config()
        self.model_args = self.model_cfg.get_model_args()
