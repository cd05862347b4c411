"""The batch wire format, counterpart of
``deepsvg_tpu/data/loader.py:decompress_batch`` (the part the training step
calls). Batches travel in narrow integer types; the step restores the
canonical ones on the device."""
from __future__ import annotations

import torch

from ..svgtensor.constants import CMD_ARGS_MASK

# absolute arguments are {-1} and [0, 255]; the -1s sit exactly where the
# command does not use the argument, so the wire carries uint8 and the -1s are
# rebuilt from the matching commands tensor
_MASKED_ARGS_WIRE = {"args": "commands", "args_grouped": "commands_grouped"}


def decompress_batch(batch: dict) -> dict:
    """int32 commands, float32 arguments (a uint8 arguments tensor gets its
    -1s back from ``CMD_ARGS_MASK``). Entries already canonical pass through,
    so the step may call this on any batch."""
    out = {}
    for k, v in batch.items():
        out[k] = v.to(torch.int32) if k.startswith("commands") and v.dtype != torch.int32 else v
    for k, v in batch.items():
        if not k.startswith("args") or v.dtype.is_floating_point:
            continue
        if v.dtype == torch.uint8:
            used = torch.as_tensor(CMD_ARGS_MASK, device=v.device).bool()[
                out[_MASKED_ARGS_WIRE[k]].long()]
            out[k] = torch.where(used, v.to(torch.float32), -1.0)
        else:
            out[k] = v.to(torch.float32)
    return out
