"""Native (C++) acceleration for the CPU geometry path.

``svgfit.cpp`` (a copy of the JAX package's) implements the RDP + Schneider
fitting engine and batched cubic sampling behind a minimal C ABI; this
module builds it with ``g++`` on first use into ``native/build/`` (listed in
``.gitignore``) under a name that hashes the source and flags, and exposes
ctypes wrappers. Several processes may build at once (pytest-xdist's
workers): each compiles to a temporary name and ``os.replace`` moves the
finished library into place, so no process loads a half-written file.
Without a toolchain :func:`available` is false and ``SVGPath.simplify``
takes the pure-Python implementations in
``deepsvg_tpu_torch.svglib.path_fitting``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "svgfit.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libsvgfit_{digest.hexdigest()[:16]}.so")


def _build(lib_path: str) -> bool:
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first call; None if
    unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        lib_path = _library_path()
        if not os.path.exists(lib_path) and not _build(lib_path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            _build_failed = True
            return None

        dptr = ctypes.POINTER(ctypes.c_double)
        lib.svgfit_fit_cubics.restype = ctypes.c_int
        lib.svgfit_fit_cubics.argtypes = [
            dptr, ctypes.c_int, ctypes.c_double, dptr, dptr, dptr, ctypes.c_int,
        ]
        lib.svgfit_rdp.restype = ctypes.c_int
        lib.svgfit_rdp.argtypes = [dptr, ctypes.c_int, ctypes.c_double, dptr, ctypes.c_int]
        lib.svgfit_sample_cubics.restype = None
        lib.svgfit_sample_cubics.argtypes = [dptr, ctypes.c_int, ctypes.c_int, dptr]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _as_dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _pieces_to_list(buf: np.ndarray, n: int) -> list:
    out = []
    for i in range(n):
        row = buf[i]
        if row[0] == 0.0:
            out.append(("l", row[1:3].copy(), row[7:9].copy()))
        else:
            out.append(("c", row[1:3].copy(), row[3:5].copy(), row[5:7].copy(), row[7:9].copy()))
    return out


def fit_cubics(points: np.ndarray, error: float, tan1=None, tan2=None, out=None) -> list:
    """Native Schneider fitting; same contract as
    ``svglib.path_fitting.fit_cubics``."""
    lib = get_lib()
    points = np.ascontiguousarray(points, dtype=np.float64)
    n = len(points)
    if out is None:
        out = []
    if n < 2:
        return out
    t1 = np.ascontiguousarray(tan1, np.float64) if tan1 is not None else None
    t2 = np.ascontiguousarray(tan2, np.float64) if tan2 is not None else None
    max_pieces = max(2 * n, 64)
    while True:
        buf = np.empty((max_pieces, 9), np.float64)
        rc = lib.svgfit_fit_cubics(
            _as_dptr(points), n, error,
            _as_dptr(t1) if t1 is not None else None,
            _as_dptr(t2) if t2 is not None else None,
            _as_dptr(buf), max_pieces,
        )
        if rc >= 0:
            out.extend(_pieces_to_list(buf, rc))
            return out
        max_pieces = -rc


def rdp(points: np.ndarray, epsilon: float, out=None) -> list:
    """Native RDP; same contract as ``svglib.path_fitting.rdp``."""
    lib = get_lib()
    points = np.ascontiguousarray(points, dtype=np.float64)
    n = len(points)
    if out is None:
        out = []
    if n < 2:
        return out
    max_pieces = max(n, 64)
    while True:
        buf = np.empty((max_pieces, 9), np.float64)
        rc = lib.svgfit_rdp(_as_dptr(points), n, epsilon, _as_dptr(buf), max_pieces)
        if rc >= 0:
            out.extend(_pieces_to_list(buf, rc))
            return out
        max_pieces = -rc


def sample_cubics(curves: np.ndarray, k: int) -> np.ndarray:
    """Batched cubic sampling: ``curves [m, 8]`` -> ``[m, k, 2]``."""
    lib = get_lib()
    curves = np.ascontiguousarray(curves, dtype=np.float64)
    m = len(curves)
    out = np.empty((m, k, 2), np.float64)
    lib.svgfit_sample_cubics(_as_dptr(curves), m, k, _as_dptr(out))
    return out
