"""Small shared utilities, counterpart of ``deepsvg_tpu/utils/__init__.py``
(the analytic FLOP count for MFU reports is ``utils/flops.py``)."""
from __future__ import annotations

import contextlib
import os
import random
from typing import Iterator

import numpy as np
import torch


def set_seed(seed: int = 42):
    """Seed Python's ``random``, NumPy's global state and PyTorch's default
    generators. The port's model randomness comes from explicit generators,
    seeded separately."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def count_parameters(params) -> int:
    """Total parameter count of an ``nn.Module`` or of a (nested) dict of
    tensors or arrays."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_parameters(v) for v in params.values())
    return int(np.prod(tuple(params.shape)))


def linear(v0: float, v1: float, x: float, x0: float, x1: float) -> float:
    """Clamped linear ramp."""
    if x <= x0:
        return v0
    if x >= x1:
        return v1
    return v0 + (v1 - v0) * (x - x0) / (x1 - x0)


def infinite_range(start: int = 0) -> Iterator[int]:
    i = start
    while True:
        yield i
        i += 1


def batchify(arrays, device=None):
    """Each array as a tensor with a leading batch axis, on ``device``: the
    CUDA card when None (raises without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu'")
        device = "cuda"
    return tuple(torch.as_tensor(np.asarray(a), device=device)[None] for a in arrays)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block (the CPU, and the card when there is
    one); on exit a Chrome trace ``trace.json`` is written into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
