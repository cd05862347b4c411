"""Training configuration with the hooks the training CLI calls, counterpart
of ``deepsvg_tpu/training/config.py``.

An experiment subclasses :class:`TrainConfig`, overrides the hooks
(``make_model``, ``make_lr_schedule``, ``make_optimizer``, ``get_weights``,
``set_train_vars``, ``visualize``) and is selected by module path on the
command line. ``num_devices`` scales the batch and the learning rate in the
configs that say so; the port trains on one card.
"""
from __future__ import annotations

from typing import Optional

from ..models.config import ModelConfig
from .schedulers import warmup_step_decay

# the module of the real icons and fonts datasets; it is not ported yet
REAL_DATA_MODULE = "deepsvg_tpu_torch.data.dataset"


class TrainConfig:
    def __init__(self, num_devices: int = 1):
        self.num_devices = num_devices

        # dataset selection
        self.dataloader_module = REAL_DATA_MODULE
        self.data_dir = "./dataset/icons_tensor/"
        self.meta_filepath = "./dataset/icons_meta.csv"
        self.loader_num_workers = 4 * num_devices
        # "thread" for pre-tensorized data (numpy packing releases the GIL);
        # "process" for Python-heavy per-item work
        self.loader_worker_mode = "thread"
        # K > 1: K optimization steps per loop iteration, whose results are
        # read only at a cadence
        self.steps_per_dispatch = 1
        # keep the whole wire-format dataset on the card and gather batches
        # there: "auto" (when the dataset allows it and fits the byte
        # budget), True, or False (stream through the loader)
        self.device_resident = "auto"
        self.device_resident_max_bytes = 4 << 30

        self.pretrained_path: Optional[str] = None

        self.model_cfg: Optional[ModelConfig] = None

        # optimization
        self.num_epochs: Optional[int] = None
        self.num_steps: Optional[int] = None
        self.learning_rate = 1e-3
        self.batch_size = 100
        self.warmup_steps = 500
        self.grad_clip: Optional[float] = None

        # dataset filters
        self.train_ratio = 1.0
        self.nb_augmentations = 1
        self.max_num_groups = 15
        self.max_seq_len = 30
        self.max_total_len: Optional[int] = None
        self.filter_uni = None
        self.filter_category = None
        self.filter_platform = None
        self.filter_labels = None

        # cadences
        self.log_every = 20
        self.val_every = 1000
        self.ckpt_every = 1000
        # retention: the newest ckpt_keep_last step checkpoints and the first
        # of every ckpt_keep_every steps; None keeps all
        self.ckpt_keep_last: Optional[int] = None
        self.ckpt_keep_every: Optional[int] = None
        # exit with code 3 when the loop makes no progress for this many
        # seconds (an orchestrator resumes from the latest checkpoint); None
        # disables it
        self.stall_watchdog_s: Optional[float] = None
        # run the log, checkpoint and visualize hooks on background workers
        # (debug runs run them inline)
        self.async_host_io: bool = True

        self.stats_to_print = {"train": ["lr", "time"]}

        self.model_args: list[str] = []

    # --- overridable hooks -----------------------------------------------
    def make_model(self):
        from ..models.model import SVGTransformer

        return SVGTransformer(self.model_cfg)

    def make_lr_schedule(self, steps_per_epoch: int):
        """Warm-up, then a staircase decay by 0.9 every 2.5 epochs."""
        return warmup_step_decay(
            self.learning_rate,
            warmup_steps=self.warmup_steps,
            decay_every=max(int(2.5 * steps_per_epoch), 1),
            gamma=0.9,
        )

    def make_optimizer(self, steps_per_epoch: int):
        from .trainer import make_optimizer

        return make_optimizer(
            self.make_lr_schedule(steps_per_epoch),
            grad_clip=self.grad_clip if self.grad_clip is not None else 1e9,
            start_step=getattr(self, "optimizer_start", 0),
        )

    def get_params(self, step, epoch) -> dict:
        return {}

    def get_weights(self, step, epoch) -> dict:
        return {}

    def set_train_vars(self, train_vars, dataset):
        pass

    def visualize(self, model, train_vars, step, epoch, summary_writer, visualization_dir):
        pass

    # --- serialization ----------------------------------------------------
    def values(self):
        for key in sorted(dir(self)):
            if key.startswith("__"):
                continue
            val = getattr(self, key)
            if callable(val):
                continue
            yield key, val

    def to_dict(self) -> dict:
        import dataclasses
        import json

        out = {}
        for key, val in self.values():
            if dataclasses.is_dataclass(val):
                out[key] = dataclasses.asdict(val)
            else:
                try:
                    json.dumps(val)
                    out[key] = val
                except (TypeError, ValueError):
                    out[key] = repr(val)
        return out

    def load_dict(self, d: dict):
        import dataclasses

        for key, val in d.items():
            cur = getattr(self, key, None)
            if dataclasses.is_dataclass(cur) and isinstance(val, dict):
                setattr(self, key, type(cur)(**val))
            elif isinstance(val, (int, float, str, bool, list, dict, type(None))):
                setattr(self, key, val)

    def print_params(self):
        for key, val in self.values():
            print(f"  {key} = {val}")


def load_config(config_module: str, num_devices: int = 1) -> TrainConfig:
    """Import an experiment config by module path."""
    import importlib

    module = importlib.import_module(config_module)
    return module.Config(num_devices)


def load_dataset(cfg: TrainConfig):
    """The dataset of ``cfg.dataloader_module``'s ``load_dataset`` hook. The
    real icons and fonts datasets are not ported yet: their module raises."""
    import importlib

    try:
        module = importlib.import_module(cfg.dataloader_module)
    except ModuleNotFoundError as e:
        if cfg.dataloader_module != REAL_DATA_MODULE:
            raise
        raise ModuleNotFoundError(
            f"{REAL_DATA_MODULE} (the real icons and fonts datasets) is not ported yet "
            "(ROADMAP.md, queue 1, item 8); train on the synthetic dataset with "
            "--dataset-module deepsvg_tpu_torch.data.synthetic") from e
    return module.load_dataset(cfg)
