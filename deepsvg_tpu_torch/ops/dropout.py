"""Dropout masks shared by the training kernels and their plain versions.

A mask element is a counter-based hash of ``(seed, site, row, column)``:
``site`` names the dropout site within a layer, ``row`` and ``column`` are the
element's coordinates in the whole batch (for the attention probabilities,
row ``(b * H + h) * S + i`` and column ``j``). The same 32-bit integer
arithmetic is written once in CUDA (``csrc/common.cuh``: ``fmix32``,
``site_key``, ``keep_elem``) and once here, bit for bit. So forward and
backward regenerate a mask from its coordinates with nothing saved, the mask
does not depend on how a kernel tiles the batch, and a kernel and its plain
version drop the same elements and can be compared element by element with
dropout on.

A fused stack of layers (K7, ``ops/stack_vjp.py``) gives layer ``l`` the
seed :func:`stack_layer_seed` ``(seed, l)`` (``stack_layer_seed`` in
``csrc/common.cuh``, the same mix), so each of its layers drops what one
layer (K4) run with that seed drops.

An element is kept where the hash's top 24 bits are at least
``floor(rate * 2**24)``; kept values are scaled by ``1 / (1 - rate)``.
"""
from __future__ import annotations

import numpy as np
import torch

SITE_ATTN_PROB, SITE_ATTN_OUT, SITE_FF_HIDDEN, SITE_FF_OUT = 0, 1, 2, 3
_M32 = 0xFFFFFFFF


def _fmix32(x):
    """The 32-bit mixer on a Python int or an int64 tensor holding uint32."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def site_key(seed: int, site: int) -> int:
    return _fmix32((int(seed) & _M32) ^ (((site + 1) * 0x9E3779B9) & _M32))


def stack_layer_seed(seed: int, layer: int) -> int:
    """The seed of layer ``layer`` of a fused stack, below 2**31."""
    return _fmix32((int(seed) & _M32) ^ (((layer + 1) * 0x85EBCA6B) & _M32)) & 0x7FFFFFFF


def drop_threshold(rate: float) -> int:
    return int(rate * (1 << 24))


def keep_scale(rate: float) -> float:
    """The keep scale as the float32 the kernels multiply by."""
    return float(np.float32(1.0 / (1.0 - rate)))


def keep_mask(seed: int, site: int, rows: torch.Tensor, cols: torch.Tensor,
              rate: float) -> torch.Tensor:
    """Bool mask (True = kept) for int64 ``rows`` and ``cols`` (broadcast
    against each other)."""
    key = site_key(seed, site)
    h = _fmix32((_fmix32((rows & _M32) ^ key) + cols) & _M32)
    return (h >> 8) >= drop_threshold(rate)


def dropout_factor(seed: int, site: int, rows: torch.Tensor, cols: torch.Tensor,
                   rate: float) -> torch.Tensor:
    """float32 factor: ``1 / (1 - rate)`` where kept, 0 where dropped."""
    keep = keep_mask(seed, site, rows, cols, rate)
    return keep.to(torch.float32) * keep_scale(rate)
