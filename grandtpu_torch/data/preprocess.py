"""Graph preprocessing (port of ``grandtpu/data/preprocess.py``, the parts
the port's loaders and trainers use)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def add_self_loops_adj(adj: sp.spmatrix, value: float = 1.0) -> sp.csr_matrix:
    """adj + value*I (reference driver ``model.py:243``)."""
    return (adj + value * sp.eye(adj.shape[0], format="csr")).tocsr()


def sym_renormalize(adj: sp.spmatrix) -> sp.csr_matrix:
    """D^-1/2 (A+I) D^-1/2 (reference ``utils/data_loader.py:133-142``,
    off by default there and here)."""
    adj = add_self_loops_adj(adj)
    deg = np.asarray(adj.sum(1)).flatten()
    dinv = np.power(deg, -0.5, out=np.zeros_like(deg), where=deg > 0)
    d = sp.diags(dinv)
    return d.dot(adj).dot(d).tocsr()
