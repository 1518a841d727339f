"""SparseGraph: a validated (adjacency, attributes, labels) container and
its npz schema.

Port of ``grandtpu/data/sparsegraph.py`` (reference ``utils/dataio.py``:
the container, ``load_npz_to_sparse_graph``/``save_sparse_graph_to_npz``
and ``standardize()``), numpy/scipy only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from grandtpu_torch.data import preprocess as pp


class SparseGraph:
    """An attributed, labeled graph in scipy CSR matrices: ``adj_matrix``
    [n, n], optional ``attr_matrix`` [n, f] (CSR or dense), optional
    ``labels`` [n] int or [n, c] one-hot, optional name arrays (reference
    ``utils/dataio.py:7-128``)."""

    def __init__(self, adj_matrix, attr_matrix=None, labels=None,
                 node_names=None, attr_names=None, class_names=None,
                 metadata=None):
        adj_matrix = adj_matrix.tocsr().astype(np.float32)
        if adj_matrix.shape[0] != adj_matrix.shape[1]:
            raise ValueError("adjacency must be square")
        n = adj_matrix.shape[0]
        if attr_matrix is not None:
            if sp.issparse(attr_matrix):
                attr_matrix = attr_matrix.tocsr().astype(np.float32)
            else:
                attr_matrix = np.asarray(attr_matrix, dtype=np.float32)
            if attr_matrix.shape[0] != n:
                raise ValueError("attr_matrix first dim != num nodes")
        if labels is not None:
            labels = np.asarray(labels)
            if labels.shape[0] != n:
                raise ValueError("labels first dim != num nodes")
        self.adj_matrix = adj_matrix
        self.attr_matrix = attr_matrix
        self.labels = labels
        self.node_names = node_names
        self.attr_names = attr_names
        self.class_names = class_names
        self.metadata = metadata

    def num_nodes(self) -> int:
        return self.adj_matrix.shape[0]

    def num_edges(self) -> int:
        return int(self.adj_matrix.nnz)

    def is_directed(self) -> bool:
        return (self.adj_matrix != self.adj_matrix.T).nnz != 0

    def to_undirected(self) -> "SparseGraph":
        self.adj_matrix = pp.to_undirected(self.adj_matrix)
        return self

    def to_unweighted(self) -> "SparseGraph":
        self.adj_matrix = pp.to_unweighted(self.adj_matrix)
        return self

    def eliminate_self_loops(self) -> "SparseGraph":
        self.adj_matrix = pp.eliminate_self_loops_adj(self.adj_matrix)
        return self

    def subgraph(self, keep: np.ndarray) -> "SparseGraph":
        """The graph induced by the node ids ``keep``, in their order."""
        keep = np.asarray(keep)
        self.adj_matrix = self.adj_matrix[keep][:, keep]
        if self.attr_matrix is not None:
            self.attr_matrix = self.attr_matrix[keep]
        if self.labels is not None:
            self.labels = self.labels[keep]
        if self.node_names is not None:
            self.node_names = self.node_names[keep]
        return self

    def standardize(self) -> "SparseGraph":
        """Unweighted, undirected, no self-loops, and only the largest
        connected component (reference ``utils/dataio.py:117-124``)."""
        g = self.to_unweighted().to_undirected().eliminate_self_loops()
        return g.subgraph(pp.largest_connected_component(g.adj_matrix))

    def unpack(self):
        return self.adj_matrix, self.attr_matrix, self.labels


def load_npz_to_sparse_graph(path: str) -> SparseGraph:
    """Load the npz schema of reference ``utils/dataio.py:155-201``."""
    with np.load(path, allow_pickle=True) as loader:
        d = dict(loader)
    adj = sp.csr_matrix(
        (d["adj_data"], d["adj_indices"], d["adj_indptr"]),
        shape=d["adj_shape"])
    attr = None
    if "attr_data" in d:
        attr = sp.csr_matrix(
            (d["attr_data"], d["attr_indices"], d["attr_indptr"]),
            shape=d["attr_shape"])
    elif "attr_matrix" in d:
        attr = d["attr_matrix"]
    labels = None
    if "labels_data" in d:
        labels = sp.csr_matrix(
            (d["labels_data"], d["labels_indices"], d["labels_indptr"]),
            shape=d["labels_shape"]).toarray()
    elif "labels" in d:
        labels = d["labels"]
    return SparseGraph(adj, attr, labels,
                       d.get("node_names"), d.get("attr_names"),
                       d.get("class_names"), d.get("metadata"))


def save_sparse_graph_to_npz(path: str, g: SparseGraph) -> None:
    """Save in the same npz schema (reference ``utils/dataio.py:204-245``)."""
    fields = {
        "adj_data": g.adj_matrix.data,
        "adj_indices": g.adj_matrix.indices,
        "adj_indptr": g.adj_matrix.indptr,
        "adj_shape": g.adj_matrix.shape,
    }
    if g.attr_matrix is not None:
        if sp.issparse(g.attr_matrix):
            fields.update(
                attr_data=g.attr_matrix.data,
                attr_indices=g.attr_matrix.indices,
                attr_indptr=g.attr_matrix.indptr,
                attr_shape=g.attr_matrix.shape)
        else:
            fields["attr_matrix"] = g.attr_matrix
    if g.labels is not None:
        fields["labels"] = g.labels
    for name in ("node_names", "attr_names", "class_names", "metadata"):
        val = getattr(g, name)
        if val is not None:
            fields[name] = val
    np.savez(path, **fields)
