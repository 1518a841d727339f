"""Dataset registry: the ``synth:`` loader.

Port of the ``GraphData`` container and the ``synth:`` branch of
``grandtpu/data/registry.py`` (split protocol of reference
``utils/data_loader.py``: 20 train and 30 val nodes per class, the rest
test). File-based datasets are ROADMAP Queue A "file-based dataset
loaders" and raise here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from grandtpu_torch.data.preprocess import sym_renormalize
from grandtpu_torch.data.splits import get_train_val_test_split
from grandtpu_torch.data.synthetic import synthetic_graph


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


def load_data(dataset_str: str, split_seed: int = 0,
              renormalize: bool = False) -> GraphData:
    """Spec: 'synth:<nodes>[:<classes>[:<features>[:sparse]]]'; with
    ``sparse`` the features are a CSR bag of words (the MAG engine).
    ``renormalize`` replaces the adjacency by D^-1/2 (A+I) D^-1/2, as
    grandtpu's ``load_data`` does."""
    if not dataset_str.startswith("synth:"):
        raise NotImplementedError(
            f"dataset {dataset_str!r}: the port loads only 'synth:' graphs "
            "so far (ROADMAP Queue A: file-based dataset loaders)")
    parts = dataset_str.split(":")[1:]
    n = int(parts[0]) if parts and parts[0] else 400
    c = int(parts[1]) if len(parts) > 1 and parts[1] else 4
    f = int(parts[2]) if len(parts) > 2 and parts[2] else 32
    sparse_feats = len(parts) > 3 and parts[3] == "sparse"
    adj, feats, labels = synthetic_graph(num_nodes=n, num_classes=c,
                                         num_features=f,
                                         sparse_features=sparse_feats, seed=7)
    rs = np.random.RandomState(split_seed)
    itr, iva, ite = get_train_val_test_split(
        rs, labels, train_examples_per_class=20, val_examples_per_class=30)
    iun = np.concatenate((iva, ite))
    adj = sym_renormalize(adj) if renormalize else adj.tocsr()
    return GraphData(adj, feats, labels, itr, iva, ite, iun, dataset_str)
