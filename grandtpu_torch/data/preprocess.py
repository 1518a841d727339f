"""Graph and feature preprocessing (port of ``grandtpu/data/preprocess.py``,
numpy/scipy only, element for element the same results): the binary
bag-of-words and row/column feature normalizers, the adjacency transforms
(self-loops, symmetrization, unweighting, the largest connected
component, the symmetric renormalization) and the label helpers."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph


# ---------------------------------------------------------------- features

def row_normalize(mx: sp.spmatrix) -> sp.spmatrix:
    """X <- diag(1/rowsum) X, zero rows kept at 0 (reference
    ``utils/data_loader.py:167-174``)."""
    rowsum = np.asarray(mx.sum(1)).flatten()
    r_inv = np.divide(1.0, rowsum, out=np.zeros_like(rowsum, dtype=np.float64),
                      where=rowsum != 0)
    return sp.diags(r_inv).dot(mx)


def col_standardize(mx: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance per column, as sklearn's StandardScaler
    (reference ``utils/data_loader.py:177-183``, aminer); a constant column
    maps to 0."""
    mx = np.asarray(mx, dtype=np.float64)
    mean = mx.mean(axis=0)
    std = mx.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return (mx - mean) / std


def to_binary_bag_of_words(features: sp.spmatrix) -> sp.csr_matrix:
    """Every stored entry set to 1.0 (reference ``utils/preprocess.py:9-13``)."""
    out = features.tocsr(copy=True)
    out.data[:] = 1.0
    return out


def is_binary_bag_of_words(features: sp.spmatrix) -> bool:
    return bool(np.all(features.tocoo().data == 1.0))


# ---------------------------------------------------------------- adjacency

def eliminate_self_loops_adj(adj: sp.spmatrix) -> sp.csr_matrix:
    """Diagonal entries removed (reference ``utils/preprocess.py:42-50``)."""
    adj = adj.tocoo()
    keep = adj.row != adj.col
    return sp.csr_matrix(
        (adj.data[keep], (adj.row[keep], adj.col[keep])), shape=adj.shape)


def add_self_loops_adj(adj: sp.spmatrix, value: float = 1.0) -> sp.csr_matrix:
    """adj + value*I (reference driver ``model.py:243``)."""
    return (adj + value * sp.eye(adj.shape[0], format="csr")).tocsr()


def to_undirected(adj: sp.spmatrix) -> sp.csr_matrix:
    """A <- max(A, A^T), the planetoid symmetrization of reference
    ``utils/data_loader.py:120``."""
    adj = adj.tocsr()
    return adj.maximum(adj.T).tocsr()


def to_unweighted(adj: sp.spmatrix) -> sp.csr_matrix:
    adj = adj.tocsr(copy=True)
    adj.data[:] = 1.0
    return adj


def sym_renormalize(adj: sp.spmatrix) -> sp.csr_matrix:
    """D^-1/2 (A+I) D^-1/2 (reference ``utils/data_loader.py:133-142``,
    off by default there and here)."""
    adj = add_self_loops_adj(adj)
    deg = np.asarray(adj.sum(1)).flatten()
    dinv = np.power(deg, -0.5, out=np.zeros_like(deg), where=deg > 0)
    d = sp.diags(dinv)
    return d.dot(adj).dot(d).tocsr()


def largest_connected_component(adj: sp.spmatrix,
                                n_components: int = 1) -> np.ndarray:
    """Node ids of the ``n_components`` largest connected components
    (reference ``utils/preprocess.py:61-124``), ascending."""
    _, labels = csgraph.connected_components(adj, directed=False)
    sizes = np.bincount(labels)
    keep = np.argsort(sizes)[::-1][:n_components]
    return np.nonzero(np.isin(labels, keep))[0]


# ---------------------------------------------------------------- labels

def binarize_labels(labels: np.ndarray) -> np.ndarray:
    """Integer class ids -> one-hot f32 [n, classes], the classes sorted
    (reference ``utils/preprocess.py:127-156``); a 2-D input is taken as
    one-hot already."""
    labels = np.asarray(labels)
    if labels.ndim == 2:
        return labels.astype(np.float32)
    classes, cols = np.unique(labels, return_inverse=True)
    out = np.zeros((labels.shape[0], classes.size), dtype=np.float32)
    out[np.arange(labels.shape[0]), cols.reshape(-1)] = 1.0
    return out


def remove_underrepresented_classes(labels: np.ndarray,
                                    train_examples_per_class: int,
                                    val_examples_per_class: int) -> np.ndarray:
    """Ids of the nodes whose class has enough members for a stratified
    split (reference ``utils/preprocess.py:159-168``)."""
    onehot = binarize_labels(labels)
    counts = onehot.sum(axis=0)
    min_needed = train_examples_per_class + val_examples_per_class + 1
    ok_classes = np.nonzero(counts >= min_needed)[0]
    return np.nonzero(onehot[:, ok_classes].sum(axis=1) > 0)[0]
