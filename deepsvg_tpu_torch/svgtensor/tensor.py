"""Host-side (numpy) packing of per-path row tensors into model inputs.

A numpy copy of the packing half of ``deepsvg_tpu/svgtensor/tensor.py``
(``pack_groups`` and the helpers it calls, and ``cmd_args_to_data14``); the
JAX module imports ``jax``, so the port keeps its own.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .constants import (
    ARGS_DIM, CMD_ARGS_MASK, CMD_EOS, CMD_SOS, Index, IndexArgs, N_ARGS, PAD_VAL)


def data14_to_cmd_args(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a ``[n, 14]`` row tensor into ``commands [n]`` and ``args [n, 11]``
    (drops the redundant start-position columns 6-7)."""
    data = np.asarray(data, dtype=np.float32)
    commands = data[:, Index.COMMAND].astype(np.int32)
    args = np.concatenate(
        [data[:, Index.RADIUS], data[:, Index.X_AXIS_ROT:Index.X_AXIS_ROT + 1],
         data[:, Index.LARGE_ARC_FLG:Index.LARGE_ARC_FLG + 1],
         data[:, Index.SWEEP_FLG:Index.SWEEP_FLG + 1],
         data[:, Index.CONTROL1], data[:, Index.CONTROL2], data[:, Index.END_POS]],
        axis=-1,
    ).astype(np.float32)
    return commands, args


def cmd_args_to_data14(commands: np.ndarray, args: np.ndarray) -> np.ndarray:
    """Inverse of :func:`data14_to_cmd_args`; start positions are rebuilt by
    chaining the end positions."""
    commands = np.asarray(commands, dtype=np.float32).reshape(-1, 1)
    args = np.asarray(args, dtype=np.float32).reshape(-1, N_ARGS)
    if len(commands) == 0:
        return np.zeros((0, 14), np.float32)
    end_pos = args[:, IndexArgs.END_POS]
    start_pos = np.concatenate([np.zeros((1, 2), np.float32), end_pos[:-1]], axis=0)
    return np.concatenate(
        [commands, args[:, IndexArgs.RADIUS],
         args[:, IndexArgs.X_AXIS_ROT:IndexArgs.X_AXIS_ROT + 1],
         args[:, IndexArgs.LARGE_ARC_FLG:IndexArgs.LARGE_ARC_FLG + 1],
         args[:, IndexArgs.SWEEP_FLG:IndexArgs.SWEEP_FLG + 1],
         start_pos, args[:, IndexArgs.CONTROL1], args[:, IndexArgs.CONTROL2], end_pos],
        axis=-1)


def pack_sequence(commands: np.ndarray, args: np.ndarray, target_len: int,
                  add_sos: bool = True, add_eos: bool = True):
    """SOS + content + EOS + pad to ``target_len``; EOS/pad commands are
    ``CMD_EOS`` and SOS/EOS/pad argument rows are ``PAD_VAL``. Content that
    would overflow is truncated."""
    commands = np.asarray(commands, dtype=np.int32).reshape(-1)
    args = np.asarray(args, dtype=np.float32).reshape(-1, N_ARGS)
    max_content = target_len - int(add_sos) - int(add_eos)
    commands, args = commands[:max_content], args[:max_content]
    n = len(commands)
    out_cmd = np.full((target_len,), CMD_EOS, dtype=np.int32)
    out_args = np.full((target_len, N_ARGS), PAD_VAL, dtype=np.float32)
    ofs = int(add_sos)
    if add_sos:
        out_cmd[0] = CMD_SOS
    out_cmd[ofs:ofs + n] = commands
    out_args[ofs:ofs + n] = args
    return out_cmd, out_args


def relative_args_np(commands: np.ndarray, args: np.ndarray) -> np.ndarray:
    """Absolute -> relative argument encoding (deltas shifted by
    ``ARGS_DIM - 1``; unused slots ``PAD_VAL``)."""
    data = np.asarray(args, dtype=np.float32).copy()
    commands = np.asarray(commands)
    real = commands < CMD_EOS
    d = data[real]
    if len(d) > 1:
        start = d[:-1, IndexArgs.END_POS].copy()
        d[1:, IndexArgs.CONTROL1] -= start
        d[1:, IndexArgs.CONTROL2] -= start
        d[1:, IndexArgs.END_POS] -= start
        data[real] = d
    mask = CMD_ARGS_MASK[commands].astype(bool)
    data[mask] += ARGS_DIM - 1
    data[~mask] = PAD_VAL
    return data


def pack_groups(group_tensors: Sequence[np.ndarray], max_num_groups: int,
                max_seq_len: int, max_total_len: int,
                fillings: Sequence[int] | None = None) -> dict[str, np.ndarray]:
    """Pack per-path ``[n_i, 14]`` row tensors into the model-args dict:
    per-group ``commands [G, max_seq_len+2]`` / ``args`` / ``args_rel``, the
    concatenated ``*_grouped`` forms with a singleton group axis, and
    ``filling [G, 1]``. Missing groups are empty (SOS + EOS + pad)."""
    groups = [np.asarray(t, dtype=np.float32).reshape(-1, 14) for t in group_tensors]
    groups = groups[:max_num_groups]
    fill = list(fillings) if fillings is not None else [0] * len(groups)
    fill = (fill + [0] * max_num_groups)[:max_num_groups]
    while len(groups) < max_num_groups:
        groups.append(np.zeros((0, 14), dtype=np.float32))

    sep_cmd = np.zeros((max_num_groups, max_seq_len + 2), dtype=np.int32)
    sep_args = np.zeros((max_num_groups, max_seq_len + 2, N_ARGS), dtype=np.float32)
    for gi, t in enumerate(groups):
        c, a = data14_to_cmd_args(t)
        sep_cmd[gi], sep_args[gi] = pack_sequence(c, a, max_seq_len + 2)

    c, a = data14_to_cmd_args(np.concatenate(groups, axis=0))
    grouped_cmd, grouped_args = pack_sequence(c, a, max_total_len + 2)

    return {
        "commands": sep_cmd,
        "args": sep_args,
        "args_rel": np.stack(
            [relative_args_np(sep_cmd[g], sep_args[g]) for g in range(max_num_groups)]),
        "commands_grouped": grouped_cmd[None],
        "args_grouped": grouped_args[None],
        "args_rel_grouped": relative_args_np(grouped_cmd, grouped_args)[None],
        "filling": np.asarray(fill, dtype=np.int32)[:, None],
    }
