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
        """Reconstruction grids to TensorBoard: one batched ``greedy_sample``
        of the sample icons on the model's device, then per icon its
        decode beside its input, each normalized, split into paths and
        coloured, rendered at 200 pixels. An icon that fails to convert or
        render is left out, as the JAX package's hook does."""
        import numpy as np
        import torch

        from deepsvg_tpu_torch.models.sample import flatten_groups_np, greedy_sample
        from deepsvg_tpu_torch.svglib.geom import Bbox
        from deepsvg_tpu_torch.svglib.svg import SVG
        from deepsvg_tpu_torch.svglib.utils import make_grid
        from deepsvg_tpu_torch.svgtensor import cmd_args_to_data14

        items = [d for d in train_vars.x_inputs_train
                 if all(k in d for k in self.model_args[:2])]
        if not items:
            return
        dev = next(model.parameters()).device
        stacked = [torch.as_tensor(np.stack([np.asarray(d[k]) for d in items]), device=dev)
                   for k in self.model_args[:2]]
        kw = {}
        if "label" in self.model_args and all("label" in d for d in items):
            # a label-conditioned model cannot encode without its labels
            kw["label"] = torch.as_tensor(np.stack([np.asarray(d["label"]) for d in items]),
                                          device=dev)
        commands_y, args_y = greedy_sample(model, *stacked, **kw)
        flat = flatten_groups_np(commands_y, args_y)
        for i, (data, (c, a)) in enumerate(zip(items, flat)):
            try:
                data14 = cmd_args_to_data14(c, a)
                svg_sample = (
                    SVG.from_tensor(data14, viewbox=Bbox(256), allow_empty=True)
                    .normalize().split_paths().set_color("random")
                )
            except Exception:
                continue
            try:
                gt14 = np.concatenate([np.asarray(t) for t in data["tensor"]], axis=0)
                svg_gt = (
                    SVG.from_tensor(gt14, viewbox=Bbox(256))
                    .normalize().split_paths().set_color("random")
                )
                img = make_grid([svg_sample, svg_gt]).render(width=200)
                summary_writer.add_image(
                    f"reconstructions_train/{i}", np.asarray(img).transpose(2, 0, 1), step)
            except Exception:
                continue
