"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library is
built at first use into ``ops/build/`` (listed in ``.gitignore``) under a
name that hashes the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # the compilers' output of the last build in this process


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path() -> str:
    files = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                   + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        digest.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libdeepsvg_kernels_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile and link the kernels if the library for these sources does
    not exist yet; return its path. Raises with the compiler's output if a
    source does not compile."""
    global build_log
    so_path = _library_path()
    if os.path.exists(so_path):
        return so_path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_so, *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_so, so_path)
    return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib


_functions: dict = {}


def kernel_function(name: str, argtypes: list):
    """A C entry point of the library with its argument types declared
    (``c_void_p`` for pointers and the stream); it returns the CUDA error
    code of its launch. Looked up once per name."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")


KERNEL_DTYPES = (torch.bfloat16, torch.float32)   # every kernel's two forms


def kernel_dtype(t, name: str):
    """``t``'s dtype if a kernel has a form for it (bfloat16 or float32);
    raise otherwise. The other operands are then required in this dtype."""
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} has dtype {t.dtype}, expected bfloat16 or float32")
    return t.dtype


def require(t, name: str, device, dtype=None, shape=None) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` with the given
    dtype and shape: what a kernel reads through a raw pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 32:
        raise ValueError(f"{name} must be 32-byte aligned (tensor-core loads)")
