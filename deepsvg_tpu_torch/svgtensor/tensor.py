"""Host-side (numpy) packing of per-path row tensors into model inputs, and
the relative-argument decoding on tensors.

A numpy copy of the packing half of ``deepsvg_tpu/svgtensor/tensor.py``
(``pack_groups`` and the helpers it calls, and ``cmd_args_to_data14``); the
JAX module imports ``jax``, so the port keeps its own. :func:`make_absolute`,
:func:`mask_invalid_args` and their helper are the torch counterparts of the
JAX module's functions of those names, which undo the relative encoding of
an autoregressive decode; :func:`relative_args` (with
:func:`_prev_real_end_pos` and :func:`jax_cummax`, named as the JAX
module's) makes that encoding on tensors, as :func:`relative_args_np` does
on the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .masks import cmd_args_mask

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


_POS_START = IndexArgs.CONTROL1.start      # control1/control2/end_pos: columns 5:11


def _position_shift(delta_xy: torch.Tensor) -> torch.Tensor:
    """An (x, y) delta ``[..., 2]`` as a shift of all 11 argument columns:
    zero on the non-position columns, repeated over control1, control2 and
    end_pos."""
    zeros = delta_xy.new_zeros(delta_xy.shape[:-1] + (_POS_START,))
    return torch.cat([zeros, delta_xy.repeat((1,) * (delta_xy.dim() - 1) + (3,))], dim=-1)


def _prev_real_end_pos(commands: torch.Tensor, end_pos: torch.Tensor):
    """For each position, the end position of the closest preceding real
    command: ``(start [..., S, 2], has_prev [..., S] bool)``."""
    real = commands < CMD_EOS
    idx = torch.arange(commands.shape[-1], dtype=torch.int64, device=commands.device)
    real_idx = torch.where(real, idx, -1)
    # exclusive running max of the real indices = the previous real command
    shifted = torch.cat([torch.full_like(real_idx[..., :1], -1), real_idx[..., :-1]], dim=-1)
    prev = jax_cummax(shifted)
    start = torch.take_along_dim(end_pos, prev.clamp_min(0)[..., None], dim=-2)
    return start, prev >= 0


def jax_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative max over the last axis (``lax.cummax`` in the
    JAX module, whence the name)."""
    return torch.cummax(x, dim=-1).values


def relative_args(commands: torch.Tensor, args: torch.Tensor) -> torch.Tensor:
    """Absolute -> relative encoded arguments on tensors: the position
    columns of each real command after the first less the previous real
    command's end position, the used arguments shifted by ``ARGS_DIM - 1``,
    the unused ``PAD_VAL``. ``commands [..., S]`` int, ``args [..., S, 11]``
    float."""
    commands = commands.long()
    mask = cmd_args_mask(commands.device, torch.bool)[commands]
    real = commands < CMD_EOS
    start, has_prev = _prev_real_end_pos(commands, args[..., IndexArgs.END_POS])
    delta = torch.where((real & has_prev)[..., None], start, start.new_zeros(()))
    rel = args - _position_shift(delta)
    return torch.where(mask, rel + (ARGS_DIM - 1), torch.full_like(rel, float(PAD_VAL)))


def mask_invalid_args(commands: torch.Tensor, args: torch.Tensor) -> torch.Tensor:
    """Set the arguments a command does not use to ``PAD_VAL``."""
    return torch.where(cmd_args_mask(commands.device, torch.bool)[commands.long()], args, torch.full_like(args, float(PAD_VAL)))


def make_absolute(commands: torch.Tensor, args: torch.Tensor) -> torch.Tensor:
    """Relative (decoded, delta-valued) -> absolute arguments.

    ``commands [..., S]``, ``args [..., S, 11]`` float: the position columns
    of each real command after the first hold deltas from the previous real
    command's end position, the first real command is absolute. Unused
    arguments become ``PAD_VAL``."""
    real = commands < CMD_EOS
    rel_end = torch.where(real[..., None], args[..., IndexArgs.END_POS],
                          args.new_zeros(()))
    prev_cum = torch.cumsum(rel_end, dim=-2) - rel_end   # sum of the previous real deltas
    first_real = real & (torch.cumsum(real.to(torch.int32), dim=-1) == 1)
    add = torch.where((real & ~first_real)[..., None], prev_cum, args.new_zeros(()))
    return mask_invalid_args(commands, args + _position_shift(add))
