"""The flagship training step in PyTorch: schedules, optimizer, train state."""
from .schedulers import constant, linear_ramp, warmup_step_decay
from .trainer import (
    Optimizer, TrainState, create_train_state, delayed_start, eval_step, init_parameters,
    make_optimizer, make_optimizers, train_step)

__all__ = [
    "Optimizer", "TrainState", "constant", "create_train_state", "delayed_start", "eval_step",
    "init_parameters", "linear_ramp", "make_optimizer", "make_optimizers", "train_step",
    "warmup_step_decay",
]
