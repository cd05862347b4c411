"""Icons training config, counterpart of ``configs_tpu/default_icons.py``.

Hierarchical two-stage VAE model in the card's profile (``gpu_fast``), 50
epochs, batch 60 x devices, lr 1e-3 x devices, KL ramp 0 -> 10 over 10k
steps. ``hierarchical_ordered`` (no VAE) and ``hierarchical_self_matching``
derive from it.
"""
import random

from deepsvg_tpu_torch.models.config import gpu_fast, hierarchical
from deepsvg_tpu_torch.training.config import TrainConfig
from deepsvg_tpu_torch.training.schedulers import linear_ramp


def make_model_config():
    return gpu_fast(hierarchical())


class Config(TrainConfig):
    def __init__(self, num_devices=1):
        super().__init__(num_devices=num_devices)

        # model
        self.model_cfg = make_model_config()
        self.model_args = self.model_cfg.get_model_args()

        # dataset
        self.filter_category = None
        self.train_ratio = 1.0
        self.max_num_groups = 8
        self.max_total_len = 50

        # dataloader
        self.loader_num_workers = 4 * num_devices

        # training
        self.num_epochs = 50
        self.val_every = 1000

        # optimization (scaled by the device count, as the reference does)
        self.learning_rate = 1e-3 * num_devices
        self.batch_size = 60 * num_devices
        self.grad_clip = 1.0

    def get_weights(self, step, epoch):
        return {
            "kl_tolerance": 0.1,
            "loss_kl_weight": linear_ramp(0, 10000, 0.0, 10.0)(step),
            "loss_hierarch_weight": 1.0,
            "loss_cmd_weight": 1.0,
            "loss_args_weight": 2.0,
            "loss_visibility_weight": 1.0,
        }

    def set_train_vars(self, train_vars, dataset):
        ids = random.sample(range(len(dataset)), k=min(10, len(dataset)))
        train_vars.x_inputs_train = [
            dataset.get(idx, [*self.model_args, "tensor"]) for idx in ids
        ]

    def visualize(self, model, train_vars, step, epoch, summary_writer, visualization_dir):
        """The reconstruction grids need the SVG library's renderer, which the
        port does not have yet (ROADMAP.md, queue 1, items 7 and 9): nothing
        is drawn."""
