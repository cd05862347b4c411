"""Reader and writer for flax's msgpack parameter files, in pure Python.

``deepsvg_tpu/training/checkpoint.py:save_model`` writes the parameter tree
with ``flax.serialization.msgpack_serialize``. The port may import neither
flax nor ``msgpack``, so this module decodes the format itself (msgpack maps,
strings, binaries, integers, floats, nil/bool and arrays, plus flax's ext
type 1 (an ndarray packed as ``(shape, dtype_name, C-order bytes)``) and ext
type 3 (a numpy scalar, packed as a 0-d ndarray); the result is a nested
dict of numpy arrays) and encodes it (:func:`msgpack_serialize`: the bytes
that ``flax.serialization.msgpack_serialize`` gives for the same tree of
dicts, strings, Python scalars and numpy arrays). Dtypes are those numpy
names itself (no bfloat16), and arrays above flax's 1 GiB chunking limit are
neither split nor reassembled.
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


def _pack_uint(n: int, fix_max: int, fix_base: int, codes) -> bytes:
    """A length or count: the fixed form below ``fix_max``, else the
    smallest of the 8/16/32-bit forms that ``codes`` name (None: absent)."""
    if n < fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                return bytes([code]) + struct.pack(fmt, n)
    for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                             (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
        if n >= -limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _pack_uint(n, 0, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _pack(value) -> bytes:
    """msgpack as ``msgpack.packb(value, use_bin_type=True)`` writes it, with
    numpy arrays and scalars as flax's ext types."""
    if value is None:
        return b"\xc0"
    if isinstance(value, bool):
        return b"\xc3" if value else b"\xc2"
    if isinstance(value, int):
        return _pack_int(value)
    if isinstance(value, float):
        return b"\xcb" + struct.pack(">d", value)
    if isinstance(value, str):
        data = value.encode("utf-8")
        return _pack_uint(len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB)) + data
    if isinstance(value, (bytes, bytearray, memoryview)):
        data = bytes(value)
        return _pack_uint(len(data), 0, 0, (0xC4, 0xC5, 0xC6)) + data
    if isinstance(value, dict):
        return _pack_uint(len(value), 16, 0x80, (None, 0xDE, 0xDF)) + b"".join(
            _pack(k) + _pack(value[k]) for k in sorted(value))
    if isinstance(value, (list, tuple)):
        return _pack_uint(len(value), 16, 0x90, (None, 0xDC, 0xDD)) + b"".join(
            _pack(v) for v in value)
    if isinstance(value, (np.ndarray, np.generic)):
        array = np.asarray(value)
        if array.dtype.hasobject or array.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialized")
        payload = _pack((array.shape, array.dtype.name, array.tobytes("C")))
        return _pack_ext(_EXT_NDARRAY if isinstance(value, np.ndarray) else _EXT_NPSCALAR,
                         payload)
    raise TypeError(f"cannot serialize {type(value).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts, lists, Python scalars and numpy arrays as
    flax's ``msgpack_serialize`` does (each dict's keys sorted, as JAX's tree
    utilities leave them)."""
    return _pack(tree)


def save_params(path: str, tree: dict) -> None:
    """Write ``tree`` (the flax parameter tree, nested dicts of numpy
    arrays) as ``save_model`` does; ``load_params`` reads it back."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))
