"""Tiny smoke-test config, counterpart of ``configs_tpu/test_tiny.py``: small
model dims and the synthetic dataset, for quick CLI runs with ``--device
cpu``. Its head dim (8) is below the card kernels' 32, so on the card it
raises at the first layer."""
import dataclasses

from deepsvg_tpu_torch.models.config import hierarchical
from deepsvg_tpu_torch.training.config import TrainConfig


def make_model_config():
    return dataclasses.replace(
        hierarchical(), use_vae=False,
        max_num_groups=3, max_seq_len=6,
        d_model=32, dim_feedforward=64, dim_z=16,
        n_layers=1, n_layers_decode=1, n_heads=4, dropout=0.0,
    )


class Config(TrainConfig):
    def __init__(self, num_devices=1):
        super().__init__(num_devices=num_devices)
        self.model_cfg = make_model_config()
        self.model_args = self.model_cfg.get_model_args()
        self.max_num_groups = self.model_cfg.max_num_groups
        self.max_seq_len = self.model_cfg.max_seq_len
        self.max_total_len = self.model_cfg.max_total_len
        self.dataloader_module = "deepsvg_tpu_torch.data.synthetic"
        self.synthetic_size = 64
        self.loader_num_workers = 0
        self.num_epochs = 1
        self.batch_size = 8 * num_devices
        self.learning_rate = 1e-3
        self.val_every = 8
        self.ckpt_every = 8
        self.log_every = 4
