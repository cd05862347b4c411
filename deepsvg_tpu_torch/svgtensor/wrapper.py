"""Drop-in ``SVGTensor`` convenience class (reference: difflib/tensor.py:8-249).

The framework itself is array-first — packing lives in ``tensor.py`` functions
and the jit paths take plain arrays — but reference users know the
``SVGTensor`` object API (``from_cmd_args(...).data``, ``add_sos()``,
``unpad()``, ``sample_points()``, ``draw()``). This wrapper provides that
surface over numpy arrays, delegating to the functional implementations.
The counterpart of ``deepsvg_tpu/svgtensor/wrapper.py``: the sampling goes
through the port's ``difflib`` in torch on the CPU and returns numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .constants import (
    CMD_EOS,
    CMD_SOS,
    COMMANDS_SIMPLIFIED,
    Index,
    IndexArgs,
    N_ARGS,
    PAD_VAL,
)
from .tensor import cmd_args_to_data14, data14_to_cmd_args, relative_args_np


class SVGTensor:
    """Mutable view over one path-sequence: ``commands [n]``, ``args [n, 11]``."""

    COMMANDS_SIMPLIFIED = COMMANDS_SIMPLIFIED
    Index = Index
    IndexArgs = IndexArgs

    def __init__(self, commands, args, seq_len: Optional[int] = None,
                 label=None, PAD_VAL: int = PAD_VAL, ARGS_DIM: int = 256,
                 filling: int = 0):
        self.commands = np.asarray(commands, dtype=np.float32).reshape(-1)
        self.args_arr = np.asarray(args, dtype=np.float32).reshape(-1, N_ARGS)
        self.seq_len = len(self.commands) if seq_len is None else int(seq_len)
        self.label = label
        self.PAD_VAL = PAD_VAL
        self.ARGS_DIM = ARGS_DIM
        self.filling = filling

    # --- constructors ----------------------------------------------------
    @staticmethod
    def from_data(data, *args, **kwargs) -> "SVGTensor":
        """From the 14-column row format."""
        c, a = data14_to_cmd_args(np.asarray(data))
        return SVGTensor(c, a, *args, **kwargs)

    @staticmethod
    def from_cmd_args(commands, args, *nargs, **kwargs) -> "SVGTensor":
        return SVGTensor(np.asarray(commands), np.asarray(args), *nargs, **kwargs)

    def copy(self) -> "SVGTensor":
        return SVGTensor(
            self.commands.copy(), self.args_arr.copy(), self.seq_len,
            self.label, self.PAD_VAL, self.ARGS_DIM, self.filling,
        )

    # --- views -----------------------------------------------------------
    @property
    def data(self) -> np.ndarray:
        """14-column rows (with chained start positions)."""
        return cmd_args_to_data14(self.commands, self.args_arr)

    def cmds(self) -> np.ndarray:
        return self.commands

    def args(self, with_start_pos: bool = False) -> np.ndarray:
        if with_start_pos:
            d = self.data
            return np.concatenate(
                [d[:, 1:6], d[:, Index.START_POS], d[:, 8:]], axis=-1
            )
        return self.args_arr

    # --- seq ops (reference difflib/tensor.py:108-149) --------------------
    def add_sos(self) -> "SVGTensor":
        self.commands = np.concatenate([[float(CMD_SOS)], self.commands])
        self.args_arr = np.concatenate(
            [np.full((1, N_ARGS), self.PAD_VAL, np.float32), self.args_arr]
        )
        self.seq_len += 1
        return self

    def drop_sos(self) -> "SVGTensor":
        self.commands = self.commands[1:]
        self.args_arr = self.args_arr[1:]
        self.seq_len -= 1
        return self

    def add_eos(self) -> "SVGTensor":
        self.commands = np.concatenate([self.commands, [float(CMD_EOS)]])
        self.args_arr = np.concatenate(
            [self.args_arr, np.full((1, N_ARGS), self.PAD_VAL, np.float32)]
        )
        return self

    def pad(self, seq_len: int = 51) -> "SVGTensor":
        pad_len = max(seq_len - len(self.commands), 0)
        self.commands = np.concatenate(
            [self.commands, np.full(pad_len, float(CMD_EOS), np.float32)]
        )
        self.args_arr = np.concatenate(
            [self.args_arr, np.full((pad_len, N_ARGS), self.PAD_VAL, np.float32)]
        )
        return self

    def unpad(self) -> "SVGTensor":
        self.commands = self.commands[: self.seq_len]
        self.args_arr = self.args_arr[: self.seq_len]
        return self

    # --- transforms -------------------------------------------------------
    def get_relative_args(self) -> np.ndarray:
        return relative_args_np(self.commands.astype(np.int32), self.args_arr)

    def _cmd_args(self):
        import torch

        return (torch.from_numpy(self.commands.astype(np.int64)),
                torch.from_numpy(self.args_arr))

    def sample_points(self, n: int = 10) -> np.ndarray:
        from ..difflib.sample import sample_points

        return sample_points(*self._cmd_args(), n=n).numpy()

    def sample_uniform_points(self, n: int = 100) -> np.ndarray:
        from ..difflib.sample import sample_uniform_points

        return sample_uniform_points(*self._cmd_args(), n=n).numpy()

    def draw(self, *args, **kwargs):
        from ..svglib.svg import SVG

        return SVG.from_tensor(self.data).draw(*args, **kwargs)

    def __len__(self):
        return len(self.commands)

    def __repr__(self):
        return f"SVGTensor(len={len(self)}, seq_len={self.seq_len})"
