"""Graph preprocessing (port of ``grandtpu/data/preprocess.py``, the part
the dense-engine path uses)."""

from __future__ import annotations

import scipy.sparse as sp


def add_self_loops_adj(adj: sp.spmatrix, value: float = 1.0) -> sp.csr_matrix:
    """adj + value*I (reference driver ``model.py:243``)."""
    return (adj + value * sp.eye(adj.shape[0], format="csr")).tocsr()
