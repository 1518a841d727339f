"""Dataset registry: one ``load_data`` entry point for every dataset family.

Port of ``grandtpu/data/registry.py`` (reference
``utils/data_loader.py:15-144``):

- planetoid pickles            cora / citeseer / pubmed
- pickled arrays + standardize aminer
- SparseGraph npz              ms_academic_cs/phy, amazon photo/computers,
                               cora_full
- npz adjacency + npy arrays   reddit, Amazon2M
- raw npz CSR adj AND features mag_scholar_c / mag_scholar_f
- synthetic SBM                synth:* (for tests and scale stand-ins)

The data directory resolves from $GRANDTPU_DATA_DIR, then the fallback
directories of ``_FALLBACK_DIRS``, in grandtpu's order. Loading downloads
nothing: ``grandtpu_torch.data.download`` fetches the datasets the repo
does not bundle.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import scipy.sparse as sp

from grandtpu_torch.data import preprocess as pp
from grandtpu_torch.data.planetoid import load_planetoid
from grandtpu_torch.data.sparsegraph import load_npz_to_sparse_graph
from grandtpu_torch.data.splits import get_train_val_test_split
from grandtpu_torch.data.synthetic import synthetic_graph

_FALLBACK_DIRS = (
    "dataset",
    "/root/reference/dataset",
)

NPZ_FAMILY = ("ms_academic_cs", "ms_academic_phy",
              "amazon_electronics_photo", "amazon_electronics_computers",
              "cora_full")
PLANETOID = ("cora", "citeseer", "pubmed")


@dataclasses.dataclass
class GraphData:
    """Loaded dataset: adjacency + features + one-hot labels + splits."""
    adj: sp.csr_matrix                 # [n, n], no self loops added yet
    features: np.ndarray | sp.csr_matrix   # dense f32 [n, f] or CSR
    labels: np.ndarray                 # one-hot float32 [n, c]
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    idx_unlabel: np.ndarray
    name: str = ""

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_features(self) -> int:
        return self.features.shape[1]

    @property
    def num_classes(self) -> int:
        return self.labels.shape[1]

    @property
    def labels_int(self) -> np.ndarray:
        return np.argmax(self.labels, axis=-1).astype(np.int32)

    @property
    def has_sparse_features(self) -> bool:
        return sp.issparse(self.features)


def _resolve_dir(dataset_str: str) -> str:
    """The first of $GRANDTPU_DATA_DIR, ``./dataset`` and the reference
    mount that exists: its ``<dataset>`` subdirectory if there is one (or
    ``citation`` for a planetoid name), else the directory itself."""
    env = os.environ.get("GRANDTPU_DATA_DIR")
    candidates = ([env] if env else []) + list(_FALLBACK_DIRS)
    for base in candidates:
        sub = os.path.join(base, dataset_str)
        if os.path.isdir(sub):
            return sub
        if dataset_str in PLANETOID and os.path.isdir(
                os.path.join(base, "citation")):
            return os.path.join(base, "citation")
        if os.path.isdir(base):
            return base
    raise FileNotFoundError(
        f"could not locate a data dir for {dataset_str!r}; set "
        f"$GRANDTPU_DATA_DIR (tried {candidates})")


def load_data(dataset_str: str, split_seed: int = 0,
              renormalize: bool = False) -> GraphData:
    """Load a dataset with the reference's split semantics
    (``utils/data_loader.py:15-144``). ``synth:<nodes>[:<classes>[:
    <features>[:sparse]]]`` generates grandtpu's SBM graph (with ``sparse``
    the features are a CSR bag of words, the MAG engine). ``renormalize``
    replaces the adjacency by D^-1/2 (A+I) D^-1/2."""
    if dataset_str.startswith("synth:"):
        data = _load_synthetic(dataset_str, split_seed)
    else:
        path = _resolve_dir(dataset_str)
        try:
            data = _load_from_disk(dataset_str, path, split_seed)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"{e} — dataset {dataset_str!r} files were not found; "
                f"download them (grandtpu_torch.data.download) and point "
                f"$GRANDTPU_DATA_DIR at the directory, or use a "
                f"'synth:<n>:<c>:<f>' spec") from None
    if renormalize:
        data.adj = pp.sym_renormalize(data.adj)
    return data


def _load_from_disk(dataset_str: str, path: str,
                    split_seed: int) -> GraphData:
    if dataset_str in PLANETOID:
        adj, feats, labels, itr, iva, ite, iun = load_planetoid(
            dataset_str, path)
        return GraphData(adj, feats, labels, itr, iva, ite, iun, dataset_str)
    if dataset_str == "aminer":
        adj = _pkl(os.path.join(path, "aminer.adj.sp.pkl"))
        feats = _pkl(os.path.join(path, "aminer.features.pkl"))
        labels = pp.binarize_labels(_pkl(os.path.join(path,
                                                      "aminer.labels.pkl")))
        feats = pp.col_standardize(feats).astype(np.float32)
        return _split_stratified(adj, feats, labels, split_seed, dataset_str)
    if dataset_str in NPZ_FAMILY:
        g = load_npz_to_sparse_graph(os.path.join(path, dataset_str + ".npz"))
        if dataset_str == "cora_full":
            g = g.subgraph(pp.remove_underrepresented_classes(g.labels, 20,
                                                              30))
        adj, feats, labels = g.standardize().unpack()
        labels = pp.binarize_labels(labels)
        if feats is not None and not pp.is_binary_bag_of_words(feats):
            feats = pp.to_binary_bag_of_words(feats)
        if (adj != adj.T).nnz:
            raise ValueError(f"{dataset_str}: the standardized adjacency is "
                             "not symmetric")
        feats = np.asarray(feats.todense(), dtype=np.float32)
        return _split_stratified(adj, feats, labels, split_seed, dataset_str)
    if dataset_str in ("reddit", "Amazon2M"):
        adj = sp.load_npz(os.path.join(path, f"{dataset_str}_adj.npz")).tocsr()
        feats = np.load(os.path.join(path, f"{dataset_str}_feat.npy"))
        labels = pp.binarize_labels(
            np.load(os.path.join(path, f"{dataset_str}_labels.npy")))
        if dataset_str == "reddit":
            return _split_stratified(adj, feats, labels, split_seed,
                                     dataset_str)
        # Amazon2M: 20 train and 30 val nodes a class, drawn by size
        c = labels.shape[1]
        itr, iva, ite = get_train_val_test_split(
            np.random.RandomState(split_seed), labels, train_size=20 * c,
            val_size=30 * c)
        return GraphData(adj, feats, labels, itr, iva, ite,
                         np.concatenate((iva, ite)), dataset_str)
    if dataset_str in ("mag_scholar_c", "mag_scholar_f"):
        with np.load(os.path.join(path, dataset_str + ".npz")) as d:
            adj = sp.csr_matrix(
                (d["adj_matrix.data"], d["adj_matrix.indices"],
                 d["adj_matrix.indptr"]), shape=d["adj_matrix.shape"])
            feats = sp.csr_matrix(
                (d["attr_matrix.data"], d["attr_matrix.indices"],
                 d["attr_matrix.indptr"]), shape=d["attr_matrix.shape"])
            labels_num = d["labels"]
        labels = np.eye(int(labels_num.max()) + 1,
                        dtype=np.float32)[labels_num]
        return _split_stratified(adj, feats, labels, split_seed, dataset_str)
    raise NotImplementedError(f"unknown dataset {dataset_str!r}")


def _split_stratified(adj, feats, labels, split_seed: int, name: str,
                      train_per_class: int = 20,
                      val_per_class: int = 30) -> GraphData:
    """20 train and 30 val nodes a class, the rest test (and unlabeled:
    val + test)."""
    itr, iva, ite = get_train_val_test_split(
        np.random.RandomState(split_seed), labels,
        train_examples_per_class=train_per_class,
        val_examples_per_class=val_per_class)
    return GraphData(adj.tocsr(), feats, labels, itr, iva, ite,
                     np.concatenate((iva, ite)), name)


def _load_synthetic(spec: str, split_seed: int) -> GraphData:
    parts = spec.split(":")[1:]
    n = int(parts[0]) if parts and parts[0] else 400
    c = int(parts[1]) if len(parts) > 1 and parts[1] else 4
    f = int(parts[2]) if len(parts) > 2 and parts[2] else 32
    sparse_feats = len(parts) > 3 and parts[3] == "sparse"
    adj, feats, labels = synthetic_graph(num_nodes=n, num_classes=c,
                                         num_features=f,
                                         sparse_features=sparse_feats, seed=7)
    return _split_stratified(adj, feats, labels, split_seed, spec)


def _pkl(path: str):
    # aminer's files are pickles, as grandtpu reads them: load only files
    # from a source you trust
    with open(path, "rb") as f:
        return pickle.load(f)
