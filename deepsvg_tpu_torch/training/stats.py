"""Training statistics, smoothing and timing: a copy of
``deepsvg_tpu/training/stats.py`` (pure Python; the port keeps its own)."""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque


class SmoothedValue:
    """Median/avg over a sliding window + global average
    (reference stats.py:7-36)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        mid = n // 2
        return d[mid] if n % 2 else 0.5 * (d[mid - 1] + d[mid])

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0


class Stats:
    """Per-split smoothed stats with console/TensorBoard output
    (reference stats.py:39-93)."""

    def __init__(self, num_steps=None, num_epochs=None, steps_per_epoch=None,
                 stats_to_print=None):
        self.num_steps = num_steps
        self.num_epochs = num_epochs
        self.steps_per_epoch = steps_per_epoch
        if num_steps is None and num_epochs is not None and steps_per_epoch is not None:
            self.num_steps = num_epochs * steps_per_epoch

        self.stats = defaultdict(lambda: defaultdict(SmoothedValue))
        self.stats_to_print = {
            k: set(v) for k, v in (stats_to_print or {}).items()
        }

        self.step = 0
        self.epoch = 0

    def to_dict(self) -> dict:
        return {
            "num_steps": self.num_steps,
            "step": self.step,
            "epoch": self.epoch,
        }

    def load_dict(self, d: dict):
        self.num_steps = d.get("num_steps", self.num_steps)
        self.step = d.get("step", 0)
        self.epoch = d.get("epoch", 0)

    def update(self, split: str, step: int, epoch: int, dic: dict):
        self.step, self.epoch = step, epoch
        for k, v in dic.items():
            self.stats[split][k].update(float(v))

    def update_stats_to_print(self, split: str, keys):
        self.stats_to_print.setdefault(split, set()).update(keys)

    def get_summary(self, split: str) -> str:
        if split == "train" and self.num_steps:
            done = self.step / self.num_steps
            percent = f"{100 * done:.1f}%"
            t = self.stats[split].get("time", None)
            if t is not None and t.count > 0:
                remaining = int(t.global_avg * (self.num_steps - self.step))
                eta = str(datetime.timedelta(seconds=remaining))
            else:
                eta = "?"
            header = f"[{split}] step {self.step}/{self.num_steps} ({percent}, eta {eta}) | "
        else:
            header = f"[{split}] step {self.step} | "
        keys = self.stats_to_print.get(split) or self.stats[split].keys()
        parts = [
            f"{k}: {self.stats[split][k].median:.5f}"
            for k in keys if k in self.stats[split]
        ]
        return header + " ".join(parts)

    def write_tensorboard(self, summary_writer, split: str):
        summary_writer.add_scalar(f"{split}/epoch", self.epoch + 1, self.step)
        keys = self.stats_to_print.get(split) or self.stats[split].keys()
        for k in keys:
            if k in self.stats[split]:
                summary_writer.add_scalar(
                    f"{split}/{k}", self.stats[split][k].median, self.step
                )

    def is_best(self) -> bool:
        # the reference always reports best (stats.py:92); kept for parity
        return True


class TrainVars:
    """Free-form mutable training variables, checkpointable
    (reference train_vars.py)."""

    def __init__(self):
        self._vars = {}

    def __getattr__(self, k):
        if k.startswith("_"):
            raise AttributeError(k)
        return self._vars.get(k)

    def __setattr__(self, k, v):
        if k.startswith("_"):
            super().__setattr__(k, v)
        else:
            self._vars[k] = v

    def to_dict(self):
        return dict(self._vars)

    def load_dict(self, d):
        self._vars.update(d)


class Timer:
    """Wall-clock interval timer (reference timer.py)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t = time.time()

    def get_elapsed_time(self) -> float:
        elapsed = time.time() - self._t
        self.reset()
        return elapsed
