"""GFPush entry point with backend dispatch (port of
``grandtpu/ppr/api.py``): the native C++/OpenMP kernel or the numpy oracle,
returning a ``TopKProp``. ``auto`` takes native when it builds, else numpy.
The GPU pushes are ROADMAP Queue A "GPU GFPush backend"."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from grandtpu_torch.ppr.coef import build_coef
from grandtpu_torch.ppr.native import gfpush_native, native_available
from grandtpu_torch.ppr.oracle import gfpush_numpy
from grandtpu_torch.sparse.topk import TopKProp

BACKENDS = ("auto", "native", "numpy")


def gfpush(adj: sp.spmatrix, sources: np.ndarray, *,
           prop_mode: str = "ppr", order: int = 10, alpha: float = 0.2,
           rmax: float = 1e-7, k: int = 32,
           backend: str = "auto") -> TopKProp:
    """Compute top-k rows of Pi for `sources` over the (self-looped) adj."""
    if backend not in BACKENDS:
        raise NotImplementedError(
            f"push backend {backend!r}: the port has {BACKENDS} "
            "(ROADMAP Queue A: GPU GFPush backend)")
    adj = adj.tocsr()
    indptr = np.asarray(adj.indptr, dtype=np.int32)
    indices = np.asarray(adj.indices, dtype=np.int32)
    sources = np.asarray(sources)
    coef = build_coef(prop_mode, order, alpha)
    if backend == "auto":
        backend = "native" if native_available() else "numpy"
    if backend == "native":
        cols, vals = gfpush_native(indptr, indices, sources, coef, rmax, k)
    else:
        cols, vals = gfpush_numpy(indptr, indices, sources, coef, rmax, k)
    return TopKProp(sources, cols, vals, adj.shape[0])
