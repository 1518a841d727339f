"""On-disk cache of GFPush results (port of ``grandtpu/ppr/cache.py``).

A cache entry is one npz keyed by everything that fixes the result:

    sha256(semver || indptr || indices || sources || coef || rmax || k)

hashed over the same bytes in the same order as grandtpu's, so both
packages compute the same key and each reads the other's entries. The key
hashes the CSR arrays themselves, not a dataset name, since self-loops and
split seeds change the arrays and not the name. It does not depend on the
push backend: every backend computes the same top-k rows.

Usage (also behind ``GrandConfig.push_cache_dir``):

    tk = cached_gfpush(cache_dir, adj, sources, prop_mode="ppr", order=10,
                       alpha=0.2, rmax=1e-7, k=32, device="cuda")
"""

from __future__ import annotations

import hashlib
import os
import uuid

import numpy as np
import scipy.sparse as sp

from grandtpu_torch.ppr.api import gfpush
from grandtpu_torch.ppr.coef import build_coef
from grandtpu_torch.sparse.topk import TopKProp

# grandtpu's; bump both together when the push's results change
_SEMVER = b"gfpush-v1"


def push_cache_key(indptr: np.ndarray, indices: np.ndarray,
                   sources: np.ndarray, coef: np.ndarray, rmax: float,
                   k: int) -> str:
    h = hashlib.sha256()
    h.update(_SEMVER)
    for a in (np.asarray(indptr, np.int32), np.asarray(indices, np.int32),
              np.asarray(sources, np.int32),
              np.asarray(coef, np.float64)):
        h.update(a.tobytes())
    h.update(np.float64(rmax).tobytes())
    h.update(np.int64(k).tobytes())
    return h.hexdigest()[:32]


def save_topk(path: str, tk: TopKProp) -> None:
    # a temporary file of its own for each writer (uuid4: pids collide
    # across hosts sharing a cache directory), already .npz-suffixed so
    # that savez keeps its name, then an atomic rename; removed on failure
    tmp = path + f".tmp{uuid.uuid4().hex}.npz"
    try:
        np.savez_compressed(tmp, sources=tk.sources, cols=tk.cols,
                            vals=tk.vals, num_nodes=np.int64(tk.num_nodes))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_topk(path: str) -> TopKProp:
    with np.load(path) as z:
        return TopKProp(z["sources"], z["cols"], z["vals"],
                        int(z["num_nodes"]))


def cached_gfpush(cache_dir: str, adj: sp.spmatrix, sources, *,
                  prop_mode: str = "ppr", order: int = 10,
                  alpha: float = 0.2, rmax: float = 1e-7, k: int = 32,
                  backend: str = "auto", device="cuda") -> TopKProp:
    """:func:`~grandtpu_torch.ppr.gfpush` with a content-addressed cache in
    ``cache_dir``: a hit loads the entry and runs no push; a miss pushes
    (``backend``, ``device`` as ``gfpush``'s) and writes the entry with an
    atomic rename, so that concurrent runs never read a torn file."""
    adj = adj.tocsr()
    sources = np.asarray(sources, dtype=np.int32)
    coef = build_coef(prop_mode, order, alpha)
    key = push_cache_key(adj.indptr, adj.indices, sources, coef, rmax, k)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"push_{key}.npz")
    if os.path.exists(path):
        return load_topk(path)
    tk = gfpush(adj, sources, prop_mode=prop_mode, order=order, alpha=alpha,
                rmax=rmax, k=k, backend=backend, device=device)
    save_topk(path, tk)
    return tk
