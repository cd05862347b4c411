"""SVG tensor data contract: constants, masks, host-side packing and the
relative-argument encoding and decoding, and the ``SVGTensor`` object API."""
from .constants import (
    ARGS_DIM, CMD_A, CMD_ARGS_MASK, CMD_C, CMD_EOS, CMD_L, CMD_M, CMD_SOS,
    CMD_Z, COMMANDS_SIMPLIFIED, Index, IndexArgs, N_ARGS, N_COMMANDS, PAD_VAL)
from .masks import group_mask, key_padding_mask, padding_mask, visibility_mask
from .tensor import (
    cmd_args_to_data14, data14_to_cmd_args, make_absolute, mask_invalid_args, pack_groups,
    pack_sequence, relative_args)
from .wrapper import SVGTensor

__all__ = [
    "ARGS_DIM", "CMD_A", "CMD_ARGS_MASK", "CMD_C", "CMD_EOS", "CMD_L", "CMD_M",
    "CMD_SOS", "CMD_Z", "COMMANDS_SIMPLIFIED", "Index", "IndexArgs", "N_ARGS",
    "N_COMMANDS", "PAD_VAL", "group_mask", "key_padding_mask", "padding_mask",
    "visibility_mask", "cmd_args_to_data14", "data14_to_cmd_args", "make_absolute",
    "mask_invalid_args", "pack_groups", "pack_sequence", "relative_args", "SVGTensor",
]
