"""Synthetic attributed-graph generator (dense features).

Port of the dense-feature branch of ``grandtpu/data/synthetic.py``: a
stochastic block model whose communities define the labels, with
class-prototype features. It makes the same numpy RandomState calls in
the same order, so the same seed gives the same graph as ``grandtpu``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def synthetic_graph(num_nodes: int = 400, num_classes: int = 4,
                    num_features: int = 32, avg_degree: float = 8.0,
                    p_in_over_p_out: float = 8.0, feature_noise: float = 0.6,
                    seed: int = 0):
    """Return (adj csr, dense float32 features [n, f], labels_onehot)."""
    rng = np.random.RandomState(seed)
    # balanced classes so 20/30-per-class stratified splits always succeed
    labels = np.arange(num_nodes) % num_classes
    rng.shuffle(labels)

    # --- edges: sample endpoints biased to same-class pairs
    num_edges = int(num_nodes * avg_degree / 2)
    src = rng.randint(0, num_nodes, size=3 * num_edges)
    dst = rng.randint(0, num_nodes, size=3 * num_edges)
    same = labels[src] == labels[dst]
    keep_prob = np.where(same, 1.0, 1.0 / p_in_over_p_out)
    keep = rng.rand(src.shape[0]) < keep_prob
    src, dst = src[keep][:num_edges], dst[keep][:num_edges]
    ok = src != dst
    src, dst = src[ok], dst[ok]
    data = np.ones(src.shape[0], dtype=np.float32)
    adj = sp.coo_matrix((data, (src, dst)),
                        shape=(num_nodes, num_nodes)).tocsr()
    adj.sum_duplicates()
    adj.data[:] = 1.0
    adj = adj.maximum(adj.T).tocsr()

    # --- features: class prototype + noise
    proto = rng.randn(num_classes, num_features).astype(np.float32)
    feats = proto[labels] + feature_noise * rng.randn(
        num_nodes, num_features).astype(np.float32)
    onehot = np.zeros((num_nodes, num_classes), dtype=np.float32)
    onehot[np.arange(num_nodes), labels] = 1.0
    return adj, feats, onehot
