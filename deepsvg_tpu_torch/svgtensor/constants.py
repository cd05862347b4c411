"""Core constants of the SVG tensor representation (numpy only).

A copy of ``deepsvg_tpu/svgtensor/constants.py``: the port keeps its own so
that it imports nothing of the JAX package.

The model consumes the 11-column argument layout::

    cols 0-1 : radius,  col 2: x_axis_rot, col 3: large_arc_flg, col 4: sweep_flg,
    cols 5-6 : control1, cols 7-8: control2, cols 9-10: end_pos

Unused arguments carry ``PAD_VAL`` (-1); coordinates are numericalized to
``[0, ARGS_DIM)``.
"""
from __future__ import annotations

import numpy as np

COMMANDS_SIMPLIFIED = ("m", "l", "c", "a", "EOS", "SOS", "z")

CMD_M, CMD_L, CMD_C, CMD_A, CMD_EOS, CMD_SOS, CMD_Z = range(7)
N_COMMANDS = len(COMMANDS_SIMPLIFIED)

N_ARGS = 11          # 11-column argument layout
ARGS_DIM = 256       # coordinate quantization grid (8-bit)
PAD_VAL = -1         # pad value for unused / padded arguments

# Which of the 11 args each command uses.
#                        rx ry rot fA fS c1x c1y c2x c2y  x  y
CMD_ARGS_MASK = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1],  # m
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1],  # l
        [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1],  # c
        [1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1],  # a
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],  # EOS
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],  # SOS
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],  # z
    ],
    dtype=np.float32,
)


class Index:
    """Column layout of the 14-column row format."""

    COMMAND = 0
    RADIUS = slice(1, 3)
    X_AXIS_ROT = 3
    LARGE_ARC_FLG = 4
    SWEEP_FLG = 5
    START_POS = slice(6, 8)
    CONTROL1 = slice(8, 10)
    CONTROL2 = slice(10, 12)
    END_POS = slice(12, 14)


class IndexArgs:
    """Column layout of the 11-column argument format."""

    RADIUS = slice(0, 2)
    X_AXIS_ROT = 2
    LARGE_ARC_FLG = 3
    SWEEP_FLG = 4
    CONTROL1 = slice(5, 7)
    CONTROL2 = slice(7, 9)
    END_POS = slice(9, 11)
