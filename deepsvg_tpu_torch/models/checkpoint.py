"""Reader for flax's msgpack parameter files, in pure Python.

``deepsvg_tpu/training/checkpoint.py:save_model`` writes the parameter tree
with ``flax.serialization.msgpack_serialize``. The port may import neither
flax nor ``msgpack``, so this module decodes the format itself: msgpack maps,
strings, binaries, integers, floats, nil/bool and arrays, plus flax's ext
type 1 (an ndarray packed as ``(shape, dtype_name, C-order bytes)``) and ext
type 3 (a numpy scalar, packed as a 0-d ndarray). The result is a nested
dict of numpy arrays. Dtypes are those numpy names itself (no bfloat16), and
arrays above flax's 1 GiB chunking limit are not reassembled.
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: str(self.take(self.unpack(">B")), "utf-8"),
            0xDA: lambda: str(self.take(self.unpack(">H")), "utf-8"),
            0xDB: lambda: str(self.take(self.unpack(">I")), "utf-8"),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in fixed:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return fixed[b]()

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = _Reader(bytes(self.take(n))).value()
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, data = payload
            array = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()
            return array if code == _EXT_NDARRAY else array[()]
        raise ValueError(f"unsupported flax msgpack ext type {code}")


def msgpack_restore(data: bytes):
    """Decode flax-serialized msgpack bytes into nested dicts of numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_params(path: str) -> dict:
    """Read a weights file written by ``save_model``: the ``params`` tree."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if isinstance(tree, dict) and set(tree) == {"params"}:
        tree = tree["params"]
    return tree
