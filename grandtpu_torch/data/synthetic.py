"""Synthetic attributed-graph generator.

Port of ``grandtpu/data/synthetic.py``: a stochastic block model whose
communities define the labels, with class-prototype dense features or
class-banded bag-of-words sparse features (the MAG regime). It makes the
same numpy RandomState calls in the same order, so the same seed gives the
same graph as ``grandtpu``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def synthetic_graph(num_nodes: int = 400, num_classes: int = 4,
                    num_features: int = 32, avg_degree: float = 8.0,
                    p_in_over_p_out: float = 8.0, feature_noise: float = 0.6,
                    sparse_features: bool = False, feature_nnz: int = 24,
                    bow_uniform_frac: float = 0.2, token_skew: float = 0.0,
                    label_noise: float = 0.0, seed: int = 0):
    """Return (adj csr, features, labels_onehot).

    features: dense float32 [n, f], or with ``sparse_features`` a CSR
    bag-of-words whose tokens come from the node's class band of the
    vocabulary (a ``bow_uniform_frac`` share uniform instead; in-band ranks
    Zipf-like when ``token_skew`` > 0). ``label_noise`` flips that share of
    the observed labels to another class after the graph is drawn.
    """
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

    if not sparse_features:
        # --- features: class prototype + noise
        proto = rng.randn(num_classes, num_features).astype(np.float32)
        feats = proto[labels] + feature_noise * rng.randn(
            num_nodes, num_features).astype(np.float32)
    else:
        # --- bag of words, built in CSR form: each class owns a band of the
        # vocabulary; a node's tokens come from its band, a share uniform
        nnz_per = max(min(feature_nnz, num_features), 1)
        band = max(num_features // num_classes, 1)
        if token_skew > 0.0:
            u = rng.rand(num_nodes, nnz_per)
            ranks = np.minimum((band * u ** (1.0 + token_skew)).astype(
                np.int64), band - 1).astype(np.int64)
        else:
            ranks = rng.randint(0, band, size=(num_nodes, nnz_per))
        in_band = ranks + labels[:, None] * band
        uniform = rng.randint(0, num_features, size=(num_nodes, nnz_per))
        cols = np.where(rng.rand(num_nodes, nnz_per) < bow_uniform_frac,
                        uniform, np.minimum(in_band, num_features - 1))
        rows = np.repeat(np.arange(num_nodes), nnz_per)
        feats = sp.coo_matrix(
            (np.ones(rows.shape[0], np.float32), (rows, cols.ravel())),
            shape=(num_nodes, num_features)).tocsr()
        feats.sum_duplicates()
        feats.data[:] = 1.0
    if label_noise > 0.0:
        flip = rng.rand(num_nodes) < label_noise
        offs = rng.randint(1, num_classes, size=num_nodes)
        labels = np.where(flip, (labels + offs) % num_classes, labels)
    onehot = np.zeros((num_nodes, num_classes), dtype=np.float32)
    onehot[np.arange(num_nodes), labels] = 1.0
    return adj, feats, onehot
