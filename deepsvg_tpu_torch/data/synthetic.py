"""Synthetic icon-like SVG tensor data (numpy), for tests and ``chip_smoke.py``.

A copy of ``generate_batch`` / ``generate_icon`` / ``_random_path`` from
``deepsvg_tpu/data/synthetic.py``: the same seed gives the same batch in both
packages, so the two can be held against each other.
"""
from __future__ import annotations

import numpy as np

from ..svgtensor.constants import ARGS_DIM, CMD_C, CMD_L, CMD_M, Index
from ..svgtensor.tensor import pack_groups


def _random_path(rng: np.random.Generator, n_cmds: int, use_curves: bool = True) -> np.ndarray:
    """One path: moveto + (n_cmds-1) line/cubic commands tracing a noisy
    closed-ish contour, coordinates on the 8-bit grid."""
    center = rng.uniform(64, 192, size=2)
    radius = rng.uniform(20, 60)
    angles = np.sort(rng.uniform(0, 2 * np.pi, size=n_cmds))
    pts = center + radius * np.stack([np.cos(angles), np.sin(angles)], -1)
    pts += rng.normal(0, 4, pts.shape)
    pts = np.clip(np.round(pts), 0, ARGS_DIM - 1)

    # canonical 14-column rows: every unused slot is PAD_VAL=-1
    rows = np.full((n_cmds, 14), -1.0, np.float32)
    rows[0, Index.COMMAND] = CMD_M
    rows[0, Index.END_POS] = pts[0]
    for i in range(1, n_cmds):
        start, end = pts[i - 1], pts[i]
        if use_curves and rng.random() < 0.5:
            rows[i, Index.COMMAND] = CMD_C
            c1 = np.clip(np.round(start + (end - start) * 0.3 + rng.normal(0, 3, 2)), 0, ARGS_DIM - 1)
            c2 = np.clip(np.round(start + (end - start) * 0.7 + rng.normal(0, 3, 2)), 0, ARGS_DIM - 1)
            rows[i, Index.CONTROL1] = c1
            rows[i, Index.CONTROL2] = c2
        else:
            rows[i, Index.COMMAND] = CMD_L
        rows[i, Index.START_POS] = start
        rows[i, Index.END_POS] = end
    return rows


def generate_icon(rng: np.random.Generator, max_num_groups: int = 8,
                  max_seq_len: int = 30, max_total_len: int = 240,
                  return_tensors: bool = False):
    """One packed sample dict; ``return_tensors=True`` also returns the raw
    per-group ``[n, 14]`` row tensors."""
    budget = max_total_len
    n_groups = int(rng.integers(1, max_num_groups + 1))
    tensors = []
    for _ in range(n_groups):
        n_cmds = int(rng.integers(3, max_seq_len + 1))
        n_cmds = min(n_cmds, budget)
        if n_cmds < 3:
            break
        tensors.append(_random_path(rng, n_cmds))
        budget -= n_cmds
    packed = pack_groups(tensors, max_num_groups, max_seq_len, max_total_len)
    if return_tensors:
        return packed, tensors
    return packed


def generate_batch(rng: np.random.Generator, batch_size: int,
                   max_num_groups: int = 8, max_seq_len: int = 30,
                   max_total_len: int | None = None,
                   label_range: int | None = None) -> dict[str, np.ndarray]:
    """Stacked batch of packed samples; optionally adds random class labels."""
    if max_total_len is None:
        max_total_len = max_num_groups * max_seq_len
    samples = [generate_icon(rng, max_num_groups, max_seq_len, max_total_len)
               for _ in range(batch_size)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if label_range is not None:
        batch["label"] = rng.integers(0, label_range, size=batch_size).astype(np.int32)
    return batch
