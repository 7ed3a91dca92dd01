"""Build and load the CUDA kernels of ``hpfx_torch.ops``.

The sources in ``csrc/`` are compiled with ``nvcc`` into one shared
library with a plain C interface, at first use, into
``build/hpfx_torch_kernels/`` at the repository root, and loaded with
``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library never loads.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "csrc", "gj_solve.cu"),)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                         "build", "hpfx_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
#: compiler output of the build that produced the loaded library
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of hpfx_torch "
                           "are built on a machine with the CUDA toolkit")
    return path


def _declare(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("hpfx_gj_kernel", "hpfx_gj_kernel_carried"):
        fn = getattr(lib, name)
        # A, b, x, n, R, B, A strides (3), b strides (3), x strides (3),
        # shared-memory bytes, stream
        fn.argtypes = [vp, vp, vp, i, i, ll] + [ll] * 9 + [i, vp]
        fn.restype = i
    lib.hpfx_error_string.argtypes = [i]
    lib.hpfx_error_string.restype = ctypes.c_char_p


def load_library():
    """Build (if needed) and load the kernel library; returns the
    ``ctypes.CDLL`` with every entry point declared."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES:
            with open(src, "rb") as fh:
                h.update(fh.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libhpfx_gj_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                                  capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
        return lib
