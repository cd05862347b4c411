"""Learning-rate and loss-weight schedules as plain functions of the step,
counterparts of ``deepsvg_tpu/training/schedulers.py``."""
from __future__ import annotations


def warmup_step_decay(base_lr: float, warmup_steps: int, decay_every: int,
                      gamma: float = 0.9):
    """Linear warm-up, then staircase exponential decay.

    Two quirks of the schedule this reproduces are kept on purpose: the
    warm-up value at step ``s`` is ``base_lr * s / warmup_steps``, so the first
    step runs at 0; and after the warm-up the decay counter advances twice per
    step, so the exponent is
    ``floor((warmup + 2 * (s - warmup) - 1) / decay_every)``.
    """

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        eff_epoch = max(2 * (step - warmup_steps) + warmup_steps - 1, 0)
        return base_lr * gamma ** (eff_epoch // max(decay_every, 1))

    return schedule


def constant(base_lr: float):
    return lambda step: base_lr


def linear_ramp(start_step: int, end_step: int, start_val: float, end_val: float):
    """Clamped linear interpolation in the step (loss-weight ramps)."""

    def f(step: int) -> float:
        t = min(max((step - start_step) / max(end_step - start_step, 1), 0.0), 1.0)
        return start_val + t * (end_val - start_val)

    return f
