"""Tiny smoke-test config, counterpart of ``configs_tpu/test_tiny.py``: small
model dims (d_model 32, 4 heads of 8, FF 64, one layer a stack) and the
synthetic dataset, for quick CLI runs on the card or with ``--device cpu``.
On the card its layers run the first port's kernels at head dim 8 (in
bfloat16 under ``gpu_fast``, in float32 as it stands), counted under the
wrappers' ``narrow_launches``. It gives the loss the icons config's weights:
the JAX package's config gives none (``TrainConfig.get_weights`` returns an
empty dict), so its CLI fails at the first step on the missing
``loss_visibility_weight``."""
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

    def get_weights(self, step, epoch):
        return {"kl_tolerance": 0.1, "loss_kl_weight": 1.0, "loss_cmd_weight": 1.0,
                "loss_args_weight": 2.0, "loss_visibility_weight": 1.0}
