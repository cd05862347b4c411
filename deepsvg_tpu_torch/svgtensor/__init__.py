"""SVG tensor data contract: constants, masks and host-side packing."""
from .constants import (
    ARGS_DIM, CMD_A, CMD_ARGS_MASK, CMD_C, CMD_EOS, CMD_L, CMD_M, CMD_SOS,
    CMD_Z, COMMANDS_SIMPLIFIED, Index, IndexArgs, N_ARGS, N_COMMANDS, PAD_VAL)
from .masks import group_mask, key_padding_mask, padding_mask, visibility_mask
from .tensor import pack_groups

__all__ = [
    "ARGS_DIM", "CMD_A", "CMD_ARGS_MASK", "CMD_C", "CMD_EOS", "CMD_L", "CMD_M",
    "CMD_SOS", "CMD_Z", "COMMANDS_SIMPLIFIED", "Index", "IndexArgs", "N_ARGS",
    "N_COMMANDS", "PAD_VAL", "group_mask", "key_padding_mask", "padding_mask",
    "visibility_mask", "pack_groups",
]
