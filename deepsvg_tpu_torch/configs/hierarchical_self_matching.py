"""The Hungarian self-matching config, counterpart of
``configs_tpu/hierarchical_self_matching.py``: the icons config's two-stage
VAE model whose predicted paths are matched to the target paths, batch 60 and
lr 1e-3 per device. On the card its step matches through kernel K8 and scores
the permuted targets through K5."""
from deepsvg_tpu_torch.models.config import gpu_fast, hierarchical_self_matching

from .default_icons import Config as IconsConfig


def make_model_config():
    return gpu_fast(hierarchical_self_matching())


class Config(IconsConfig):
    def __init__(self, num_devices=1):
        super().__init__(num_devices=num_devices)
        self.model_cfg = make_model_config()
        self.model_args = self.model_cfg.get_model_args()
