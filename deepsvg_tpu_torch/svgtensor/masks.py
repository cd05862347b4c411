"""Mask derivations over command sequences (torch, batch-first).

Every function takes ``commands`` with the sequence on the last axis
(``[..., S]``), as ``deepsvg_tpu/svgtensor/masks.py`` does.
"""
from __future__ import annotations

import functools

import torch

from .constants import CMD_ARGS_MASK, CMD_EOS, CMD_M


@functools.lru_cache(maxsize=None)
def cmd_args_mask(device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``CMD_ARGS_MASK [n_commands, n_args]`` on ``device``, made once per
    device and type: a copy from pageable host memory at every step would
    make the host wait for the device."""
    return torch.as_tensor(CMD_ARGS_MASK, dtype=dtype, device=device)


def padding_mask(commands: torch.Tensor, extended: bool = False) -> torch.Tensor:
    """1.0 for positions strictly before the first EOS, else 0.0 (float32).

    ``extended=True`` also sets any position whose index minus 3 was in the
    base mask: the reference code shifts by 3 although its comment says 1,
    and the loss depends on the code's behaviour.
    """
    is_eos = (commands == CMD_EOS).to(torch.int32)
    mask = (torch.cumsum(is_eos, dim=-1) == 0).to(torch.float32)
    if extended:
        shifted = torch.zeros_like(mask)
        shifted[..., 3:] = mask[..., :-3]
        mask = torch.clamp(mask + shifted, max=1.0)
    return mask


def key_padding_mask(commands: torch.Tensor) -> torch.Tensor:
    """True at padded key positions (first EOS onwards). ``[..., S]`` bool."""
    is_eos = (commands == CMD_EOS).to(torch.int32)
    return torch.cumsum(is_eos, dim=-1) > 0


def group_mask(commands: torch.Tensor) -> torch.Tensor:
    """Running count of moveto commands: the group id of each position
    (``[..., S]`` int32)."""
    return torch.cumsum((commands == CMD_M).to(torch.int32), dim=-1,
                        dtype=torch.int32)


def visibility_mask(commands: torch.Tensor) -> torch.Tensor:
    """True where the sequence holds real content: fewer than S-1 EOS tokens
    (an empty group is ``[SOS, EOS, ...]``). ``[..., S] -> [...]`` bool."""
    s = commands.shape[-1]
    n_eos = (commands == CMD_EOS).to(torch.int32).sum(dim=-1)
    return n_eos < s - 1
