"""Build and load the port's hand-written CUDA kernels.

Every ``grandtpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(Hopper) into one shared library with a plain C interface,
``build/grandtpu_torch/libgrandtpu_kernels.so``, which is loaded with
ctypes. The build runs on first use, one ``nvcc`` per source started
together, under a file lock, and again whenever a source or a header
(``csrc/*.cuh``) is newer than the library. ``nvcc``'s messages, ``-Xptxas -v`` register and spill counts
included, go to ``nvcc.log`` beside the library.

Each C function returns the ``cudaError_t`` of its launch; callers raise
on a non-zero code (see :func:`check`).
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
_CFLAGS = _GENCODE + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v"]
LIB_NAME = "libgrandtpu_kernels.so"

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # features, cols, vals, keep, out, batch, ktop, num_features, num_aug,
    # stream
    "dropnode_mean_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # ktop, num_features, num_aug, align, out[7]
    "dropnode_mean_config": [_I, _I, _I, _I, _P],
    # indptr, indices, values, x, y, acc, num_rows, num_features, scale,
    # accumulate, term_bf16, carry_bf16, split_rows, chunk_ptr, chunk_row,
    # chunk_lo, num_chunks, cap, partial, counters, stream
    "csr_spmm_prop": [_P] * 6 + [_I, _I, ctypes.c_float, _I, _I, _I]
                     + [_P] * 4 + [_I, _I, _P, _P, _P],
    # x, amax_bits, num_rows, num_features, x_bf16, stream
    "column_absmax": [_P, _P, _I, _I, _I, _P],
    # x, amax_bits, q, col_scale, zero_bits, num_rows, num_features,
    # x_bf16, stream
    "quantize_with_amax": [_P] * 5 + [_I, _I, _I, _P],
    # rows, cols, vals, x, y, acc, row_scale, num_edges, num_rows,
    # num_features, scale, accumulate, carry_bf16, split_rows, chunk_ptr,
    # chunk_row, chunk_lo, num_chunks, cap, partial, counters, stream
    "coo_spmm": [_P] * 7 + [ctypes.c_int64, _I, _I, ctypes.c_float, _I, _I]
                + [_P] * 4 + [_I, _I, _P, _P, _P],
    # x, item_src, item_ptr, dst, num_items, amax, col_scale, out, num_out,
    # num_features, quantize, stream
    "halo_pack": [_P] * 4 + [_I] + [_P] * 3 + [_I, _I, _I, _P],
    # d_ptr, d_idx, d_val, x, h_ptr, h_idx, h_val, recv, col_scale,
    # row_val, y, acc, num_rows, num_features, scale, accumulate, form,
    # stream
    "halo_hop": [_P] * 12 + [_I, _I, ctypes.c_float, _I, _I, _P],
    # indptr, indices, values | row_val, q, col_scale, y, acc, amax_bits,
    # num_rows, num_features, scale, accumulate, carry_bf16, split_rows,
    # chunk_ptr, chunk_row, chunk_lo, num_chunks, cap, partial, counters,
    # stream
    "csr_spmm_q8": [_P] * 8 + [_I, _I, ctypes.c_float, _I, _I] + [_P] * 4
                   + [_I, _I, _P, _P, _P],
    "csr_spmm_q8mxu": [_P] * 8 + [_I, _I, ctypes.c_float, _I, _I]
                      + [_P] * 4 + [_I, _I, _P, _P, _P],
    # num_features, align_bytes, out[5]
    "csr_spmm_q8_config": [_I, _I, _P],
    # q, col_scale, y, acc (may be null), carry_bf16
    "csr_spmm_q8_align": [_P] * 4 + [_I],
    # table | grad, attr_cols, attr_vals, tk_cols, tk_vals, keep, drop,
    # out | (dtable, scratch), rows, ktop, P, H, num_aug, keep_prob,
    # vocab_lo, vocab_hi, stream
    "embed_prop_fwd_f32": [_P] * 8 + [_I] * 5 + [ctypes.c_float, _I, _I, _P],
    "embed_prop_bwd_f32": [_P] * 9 + [_I] * 5 + [ctypes.c_float, _I, _I, _P],
    # rows, ktop, P, H, num_aug, drop, out[1] (int64 bytes)
    "embed_prop_bwd_scratch": [_I] * 6 + [_P],
    # ids (or null), vals, row_off, out_cols, out_vals | num_rows, k, stream
    "push_topk": [_P] * 3 + [_I, _I, _P, _P, _P],
    # residue, reserve, pushed, tele_in, tele_out, src, deg, thr |
    # num_nodes, num_sources, coef, final, stream
    "dense_push_mask": [_P] * 8 + [_I, _I, ctypes.c_float, _I, _P],
    # f_ids, f_q, f_off, f_cnt, f_exp, src, rec, indices, g_off, g_keys,
    # g_vals, o_off, o_ids, o_q, o_cnt, o_exp, err | num_sources, stream
    "bucket_hop": [_P] * 17 + [_I, _P],
    # hops, num_hops | r_off, g_off, g_keys, g_vals, o_ids, o_sum, o_f,
    # o_cnt, err | num_sources, stream
    "bucket_reserve": [_P, _I] + [_P] * 9 + [_I, _P],
    # out[7]
    "bucket_push_occupancy": [_P],
    # p, g, m, v (arrays of the leaves' pointers), n (int64 array) |
    # num_leaves, bc1, bc2, neg_lr, wd, b1, 1 - b1, b2, 1 - b2, eps, decay,
    # stream
    "adam_update_f32": [_P] * 5 + [_I, _P, _P] + [ctypes.c_float] * 7
                       + [_I, _P],
    "adam_max_leaves": [],
}


def build_dir() -> str:
    """``build/grandtpu_torch`` at the root of the checkout."""
    d = os.path.join(os.path.dirname(_PKG), "build", "grandtpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels "
            "cannot be built")
    return path


def build() -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path. Raises RuntimeError with nvcc's output if a compile fails."""
    bdir = build_dir()
    out = os.path.join(bdir, LIB_NAME)
    srcs = sources()
    with open(os.path.join(bdir, "kernels.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        inputs = srcs + glob.glob(os.path.join(_CSRC, "*.cuh"))
        if (os.path.exists(out) and os.path.getmtime(out)
                >= max(os.path.getmtime(s) for s in inputs)):
            return out
        nvcc = _nvcc()
        procs, objs = [], []
        for src in srcs:
            obj = os.path.join(
                bdir, os.path.splitext(os.path.basename(src))[0] + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_CFLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {os.path.basename(src)}\n{text}")
            if p.returncode != 0:
                failed.append(src)
        with open(os.path.join(bdir, "nvcc.log"), "w") as f:
            f.write("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp = out + ".tmp"
        link = subprocess.run([nvcc, *_GENCODE, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp, out)
    return out


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
