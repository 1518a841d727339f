"""numpy GFPush oracle — the semantic ground truth for all other backends
(copy of ``grandtpu/ppr/oracle.py``).

Implements generalized forward push with top-K sparsification exactly as the
reference native kernel does (``precompute/graph.h:53-131``):

- hop loop over i = 0..len(coef)-2: every drained residue r at node u adds
  coef[i]*r to u's reserve; dangling nodes (deg 0) teleport r back to the
  source; otherwise the push happens only if r >= rmax*deg(u) — smaller
  residues are dropped (the approximation knob);
- after the hop loop, remaining residues flush into reserves with the last
  coefficient;
- per source, keep the K largest reserves with value > 0.

The graph is treated as unweighted: only CSR structure is used and
deg(u) = row nnz, matching the reference (``graph.h:43-45``).

This oracle is vectorized over nodes with dense residue/reserve arrays
(exact same arithmetic, different data structure), so it is usable up to a
few hundred thousand nodes for parity tests.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def gfpush_numpy(indptr: np.ndarray,
                 indices: np.ndarray,
                 sources: np.ndarray,
                 coef: np.ndarray,
                 rmax: float,
                 k: int):
    """Run GFPush from each source node.

    Returns (cols, vals): int32 [n_src, k] and float64 [n_src, k], padded
    with col=0 / val=0.0 for rows with fewer than k positive reserves
    (identical to the reference's zero-initialised output buffers,
    ``model.py:252-254``).
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    sources = np.asarray(sources, dtype=np.int64)
    coef = np.asarray(coef, dtype=np.float64)
    n = indptr.shape[0] - 1
    deg = (indptr[1:] - indptr[:-1]).astype(np.float64)
    # structure-only binary adjacency; A^T row u scatter == vec @ A
    adj = sp.csr_matrix(
        (np.ones(indices.shape[0], dtype=np.float64),
         indices.copy(), indptr.copy()), shape=(n, n))
    adj_t = adj.T.tocsr()

    n_src = sources.shape[0]
    out_cols = np.zeros((n_src, k), dtype=np.int32)
    out_vals = np.zeros((n_src, k), dtype=np.float64)

    dangling = deg == 0.0
    safe_deg = np.where(dangling, 1.0, deg)
    threshold = rmax * deg
    n_hops = coef.shape[0] - 1

    for it in range(n_src):
        s = sources[it]
        residue = np.zeros(n, dtype=np.float64)
        reserve = np.zeros(n, dtype=np.float64)
        residue[s] = 1.0
        for i in range(n_hops):
            reserve += coef[i] * residue
            teleport = residue[dangling].sum()
            push_mask = (residue >= threshold) & ~dangling & (residue > 0)
            pushed = np.where(push_mask, residue / safe_deg, 0.0)
            residue = adj_t.dot(pushed)
            residue[s] += teleport
        reserve += coef[-1] * residue

        nz = np.nonzero(reserve > 0.0)[0]
        if nz.shape[0] > k:
            top = np.argpartition(-reserve[nz], k - 1)[:k]
            nz = nz[top]
        order = np.argsort(-reserve[nz], kind="stable")
        nz = nz[order]
        out_cols[it, : nz.shape[0]] = nz
        out_vals[it, : nz.shape[0]] = reserve[nz]
    return out_cols, out_vals
