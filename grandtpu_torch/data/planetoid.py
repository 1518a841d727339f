"""Planetoid (cora/citeseer/pubmed) pickle-protocol loader.

Port of ``grandtpu/data/planetoid.py`` (reference
``utils/data_loader.py:85-129``, without networkx): the ``ind.<name>.*``
pickles read with ``pickle`` as grandtpu reads them, the adjacency built
from the dict of lists as a symmetric binary CSR indexed by node id, the
citeseer fix for isolated test nodes, row-normalized dense features.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import scipy.sparse as sp

from grandtpu_torch.data.preprocess import row_normalize


def parse_index_file(filename: str) -> list[int]:
    with open(filename) as f:
        return [int(line.strip()) for line in f]


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def graph_dict_to_adj(graph: dict, num_nodes: int) -> sp.csr_matrix:
    """{u: [v, ...]} -> symmetric binary CSR without duplicate entries (the
    reference's networkx adjacency and symmetrization,
    ``utils/data_loader.py:118-120``, for keys 0..n-1 as in every
    Planetoid pickle)."""
    rows = [u for u, nbrs in graph.items() for _ in nbrs]
    cols = [v for nbrs in graph.values() for v in nbrs]
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    adj = sp.coo_matrix((np.ones(rows.shape[0], dtype=np.float32),
                         (rows, cols)), shape=(num_nodes, num_nodes)).tocsr()
    adj.sum_duplicates()
    adj.data[:] = 1.0            # simple-graph semantics: edge weight 1
    return adj.maximum(adj.T).tocsr()


def load_planetoid(dataset_str: str, path: str):
    """Return (adj, features_dense, labels_onehot, idx_train, idx_val,
    idx_test, idx_unlabel) with the reference's semantics."""
    names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    x, y, tx, ty, allx, ally, graph = (
        _load_pickle(os.path.join(path, f"ind.{dataset_str}.{n}"))
        for n in names)
    test_idx_reorder = parse_index_file(
        os.path.join(path, f"ind.{dataset_str}.test.index"))
    test_idx_range = np.sort(test_idx_reorder)

    if dataset_str == "citeseer":
        # isolated test nodes exist only in the graph: widen tx/ty with
        # zero rows so that indexing by test id works (reference :102-110)
        full = range(min(test_idx_reorder), max(test_idx_reorder) + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - min(test_idx_range), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_idx_range - min(test_idx_range), :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx_reorder, :] = features[test_idx_range, :]
    features = row_normalize(features)
    features = np.asarray(features.todense(), dtype=np.float32)

    adj = graph_dict_to_adj(graph, features.shape[0])

    labels = np.vstack((ally, ty))
    labels[test_idx_reorder, :] = labels[test_idx_range, :]
    labels = labels.astype(np.float32)

    idx_train = np.arange(len(y))
    idx_val = np.arange(len(y), len(y) + 500)
    idx_test = np.asarray(sorted(test_idx_reorder))
    idx_unlabel = np.arange(len(y), labels.shape[0])
    return adj, features, labels, idx_train, idx_val, idx_test, idx_unlabel
