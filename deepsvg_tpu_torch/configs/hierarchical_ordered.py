"""The flagship config, counterpart of ``configs_tpu/hierarchical_ordered.py``:
the hierarchical ordered model with a deterministic linear bottleneck (no
VAE, no labels), batch 60 and lr 1e-3 per device. The training CLI passes
the card count (1), which gives the recipe batch B=60."""
import dataclasses

from deepsvg_tpu_torch.models.config import gpu_fast, hierarchical

from .default_icons import Config as IconsConfig


def make_model_config():
    return gpu_fast(dataclasses.replace(hierarchical(), label_condition=False, use_vae=False))


class Config(IconsConfig):
    def __init__(self, num_devices=2):
        super().__init__(num_devices=num_devices)

        self.model_cfg = make_model_config()
        self.model_args = self.model_cfg.get_model_args()

        self.filter_category = None

        self.learning_rate = 1e-3 * num_devices
        self.batch_size = 60 * num_devices

        self.val_every = 2000
