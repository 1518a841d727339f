"""GFPush entry point with backend dispatch (port of
``grandtpu/ppr/api.py``), returning a ``TopKProp``:

- ``native``: the C++/OpenMP kernel on the host;
- ``numpy``: the oracle;
- ``jax``: the dense-residue push (P1, :mod:`.dense_push`; grandtpu's name);
- ``bucket``: the sparse-residue push (P2, :mod:`.bucket_push`);
- ``auto``: grandtpu's policy, :func:`_auto_backend`.

``jax``, ``bucket`` and ``auto`` run on ``device`` (the card unless the
caller asks for the CPU, where the device pushes run their plain versions);
``native`` and ``numpy`` run on the host and ignore it.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.device import resolve_device
from grandtpu_torch.ppr import native
from grandtpu_torch.ppr.bucket_push import gfpush_bucketed
from grandtpu_torch.ppr.coef import build_coef
from grandtpu_torch.ppr.dense_push import gfpush_dense
from grandtpu_torch.ppr.oracle import gfpush_numpy
from grandtpu_torch.sparse.topk import TopKProp

BACKENDS = ("auto", "native", "numpy", "jax", "bucket")

# grandtpu's measured push rates (one v5e and its host, order-10 ppr,
# rmax 1e-5, k 64), kept as they are: the H100's own crossover is a ROADMAP
# item. 'auto' takes the device bucket push when a CUDA device is asked
# for, the push is large enough, and the host kernel would be slower.
_BUCKET_SPS = 900.0            # v5e flat rate
_NATIVE_SPS_PER_CORE = 1250.0  # idle-host per-core rate
_BUCKET_MIN_SOURCES = 4096


def _auto_backend(nnz: int, n_src: int, device: torch.device) -> str:
    """Policy for backend='auto', grandtpu's: the bucket push on the card
    when the push has at least ``_BUCKET_MIN_SOURCES`` sources and the
    throughput model says the host kernel would be slower (or it does not
    build); else native; else the numpy oracle. GRANDTPU_PUSH_BACKEND forces
    a backend; GRANDTPU_PUSH_CORES caps the cores the host kernel is
    assumed to have."""
    forced = os.environ.get("GRANDTPU_PUSH_BACKEND")
    if forced:
        return forced
    has_native = native.native_available()
    if n_src >= _BUCKET_MIN_SOURCES and device.type == "cuda":
        cores = int(os.environ.get("GRANDTPU_PUSH_CORES",
                                   os.cpu_count() or 1))
        if not has_native or _BUCKET_SPS > cores * _NATIVE_SPS_PER_CORE:
            return "bucket"
    return "native" if has_native else "numpy"


def gfpush(adj: sp.spmatrix, sources: np.ndarray, *,
           prop_mode: str = "ppr", order: int = 10, alpha: float = 0.2,
           rmax: float = 1e-7, k: int = 32, backend: str = "auto",
           num_threads: int = 0, device="cuda") -> TopKProp:
    """Compute top-k rows of Pi for `sources` over the (self-looped) adj.
    ``num_threads`` is the native kernel's (0: all cores)."""
    adj = adj.tocsr()
    indptr = np.asarray(adj.indptr, dtype=np.int32)
    indices = np.asarray(adj.indices, dtype=np.int32)
    sources = np.asarray(sources)
    coef = build_coef(prop_mode, order, alpha)
    if backend in ("auto", "jax", "bucket"):
        device = resolve_device(device)
    if backend == "auto":
        backend = _auto_backend(int(adj.nnz), int(sources.shape[0]), device)
    if backend not in BACKENDS[1:]:
        raise ValueError(f"unknown push backend {backend!r}; the port has "
                         f"{BACKENDS}")

    if backend == "native":
        cols, vals = native.gfpush_native(indptr, indices, sources, coef,
                                          rmax, k, num_threads=num_threads)
    elif backend == "jax":
        cols, vals = gfpush_dense(indptr, indices, sources, coef, rmax, k,
                                  device=device)
    elif backend == "bucket":
        cols, vals = gfpush_bucketed(indptr, indices, sources, coef, rmax, k,
                                     device=device)
    else:
        cols, vals = gfpush_numpy(indptr, indices, sources, coef, rmax, k)
    return TopKProp(sources, cols, vals, adj.shape[0])
