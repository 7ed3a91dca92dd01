"""Build and load the CUDA kernels of ``hpfx_torch.ops``.

The sources in ``csrc/`` are compiled at first use, one ``nvcc`` per
source, all started together, and linked into one shared library with a
plain C interface in ``build/hpfx_torch_kernels/`` at the repository
root, loaded with ``ctypes``.  The library's file name carries a hash of
the sources, headers and flags, so an edited source is rebuilt and a
stale library never loads.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, "csrc", f)
                for f in ("gj_solve.cu", "gj_panel.cu", "fused_trip.cu",
                          "rectifier.cu"))
HEADERS = (os.path.join(_HERE, "csrc", "gj_common.cuh"),)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                         "build", "hpfx_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
#: compiler output of the build that produced the loaded library (kept as
#: ``<library>.log``)
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of hpfx_torch "
                           "are built on a machine with the CUDA toolkit")
    return path


def _declare(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # A, b, x, n, R, B, A strides (3), b strides (3), x strides (3), the
    # launch plan (rows, slots, b in shared memory, threads and systems a
    # block), equilibrate, shared-memory bytes, right-hand sides a block,
    # stream
    head = [vp, vp, vp, i, i, ll] + [ll] * 9
    for name in ("hpfx_gj_kernel", "hpfx_gj_kernel_carried",
                 "hpfx_gj_kernel_unrolled"):
        getattr(lib, name).argtypes = head + [i] * 8 + [vp]
    # the kernel (0 gj_kernel, 1 gj_kernel_carried, 2 gj_kernel_unrolled),
    # the launch plan (rows, slots, b in shared memory, threads, smem), out:
    # blocks
    lib.hpfx_gj_blocks_per_sm.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    for name in ("hpfx_gj_kernel", "hpfx_gj_kernel_carried",
                 "hpfx_gj_kernel_unrolled", "hpfx_gj_blocks_per_sm"):
        getattr(lib, name).restype = i
    # panel, used, Z, pivots, used_out, N, Pw, B, panel strides (3), Z
    # strides (3), pivot strides (2), used strides (2), used_out strides
    # (2), stream
    lib.hpfx_gj_panel_kernel.argtypes = [vp] * 5 + [i, i, ll] + [ll] * 12 \
        + [vp]
    lib.hpfx_gj_panel_kernel.restype = i
    # Vm, Va, f, err, act, Sr, Si, inj, packed constants, lines, the four
    # outputs, H, n, m, c, L, coupled, constant count, B, stream
    lib.hpfx_fused_trip.argtypes = [vp] * 14 + [i] * 7 + [ll, vp]
    lib.hpfx_fused_trip.restype = i
    # H, n, m, c, L, coupled, constant count; out: scenarios a block,
    # shared-memory bytes, blocks per SM
    lib.hpfx_fused_trip_occupancy.argtypes = [i] * 7 + [ctypes.POINTER(i)] * 3
    lib.hpfx_fused_trip_occupancy.restype = i
    # sources, i, v, S, steps + 1, substeps, the circuit's constants
    # (v_drop, R_on, C_emi, C_dc, R1, tau, el, e_dc, h, dt), stream
    lib.hpfx_rectifier.argtypes = [vp] * 3 + [i, ll, i] \
        + [ctypes.c_double] * 10 + [vp]
    lib.hpfx_rectifier.restype = i
    lib.hpfx_error_string.argtypes = [i]
    lib.hpfx_error_string.restype = ctypes.c_char_p


def _run_all(cmds):
    """Run the commands in parallel; returns their (returncode, output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _compile_and_link(so: str, tag: str) -> None:
    """Compile every source to an object in parallel, link them into
    ``so`` and write the compilers' output to ``<so>.log`` (before the
    library appears)."""
    pid = os.getpid()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.{pid}.o")
            for src in SOURCES]
    nvcc = _nvcc()
    runs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, src]
                     for src, o in zip(SOURCES, objs)])
    log = "".join(out for _, out in runs)
    if any(rc != 0 for rc, _ in runs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = f"{so}.{pid}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                           *objs], capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    with open(f"{tmp}.log", "w") as fh:
        fh.write(log)
    os.replace(f"{tmp}.log", f"{so}.log")
    os.replace(tmp, so)
    for o in objs:
        os.remove(o)


def load_library():
    """Build (if needed) and load the kernel library; returns the
    ``ctypes.CDLL`` with every entry point declared.  The compilers'
    output is kept beside the library and read into :data:`build_log`."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES + HEADERS:
            with open(src, "rb") as fh:
                h.update(fh.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = h.hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"libhpfx_gj_{tag}.so")
        if not os.path.exists(so):
            _compile_and_link(so, tag)
        with open(f"{so}.log") as fh:
            build_log = fh.read()
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
        return lib
