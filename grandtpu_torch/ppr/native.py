"""ctypes binding + lazy build of the native GFPush kernel.

Port of ``grandtpu/ppr/native.py``. ``csrc/gfpush.cpp`` is a byte-identical
copy of ``grandtpu/ppr/csrc/gfpush.cpp``; it is compiled on first use
(g++ -O3 -fopenmp -march=native) into ``build/grandtpu_torch/libgfpush.so``,
a library of its own beside the JAX package's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from grandtpu_torch.ops._build import build_dir

_LOCK = threading.Lock()
_LIB = None

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "gfpush.cpp")


def _compile() -> str:
    out = os.path.join(build_dir(), "libgfpush.so")
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(_SRC)):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
           "-march=native", "-funroll-loops", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def load_library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_compile())
            lib.gfpush_run.restype = ctypes.c_int
            lib.gfpush_run.argtypes = [
                ctypes.POINTER(ctypes.c_int32),   # indptr
                ctypes.POINTER(ctypes.c_int32),   # indices
                ctypes.c_int64,                   # num_nodes
                ctypes.POINTER(ctypes.c_int32),   # sources
                ctypes.c_int64,                   # num_sources
                ctypes.POINTER(ctypes.c_double),  # coef
                ctypes.c_int32,                   # num_coef
                ctypes.c_double,                  # rmax
                ctypes.c_int32,                   # topk
                ctypes.POINTER(ctypes.c_int32),   # out_cols
                ctypes.POINTER(ctypes.c_double),  # out_vals
                ctypes.c_int32,                   # num_threads
            ]
            _LIB = lib
    return _LIB


def native_available() -> bool:
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def gfpush_native(indptr: np.ndarray, indices: np.ndarray,
                  sources: np.ndarray, coef: np.ndarray, rmax: float,
                  k: int, num_threads: int = 0):
    """Run the native kernel on ``num_threads`` OpenMP threads (0: all).
    Returns (cols int32 [n_src,k], vals float64 [n_src,k]), rows sorted by
    value descending."""
    lib = load_library()
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    sources = np.ascontiguousarray(sources, dtype=np.int32)
    coef = np.ascontiguousarray(coef, dtype=np.float64)
    n_src = sources.shape[0]
    out_cols = np.zeros((n_src, k), dtype=np.int32)
    out_vals = np.zeros((n_src, k), dtype=np.float64)
    rc = lib.gfpush_run(
        _ptr(indptr, ctypes.c_int32), _ptr(indices, ctypes.c_int32),
        ctypes.c_int64(indptr.shape[0] - 1),
        _ptr(sources, ctypes.c_int32), ctypes.c_int64(n_src),
        _ptr(coef, ctypes.c_double), ctypes.c_int32(coef.shape[0]),
        ctypes.c_double(rmax), ctypes.c_int32(k),
        _ptr(out_cols, ctypes.c_int32), _ptr(out_vals, ctypes.c_double),
        ctypes.c_int32(num_threads))
    if rc != 0:
        raise RuntimeError(f"gfpush_run failed with code {rc}")
    return out_cols, out_vals
