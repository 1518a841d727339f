"""The port's file loaders against grandtpu's, on files of each family
written to a temporary directory (no dataset file is in the repository).

Both packages' ``load_data`` read the same files through
``$GRANDTPU_DATA_DIR``; every field of the result (adjacency, features,
labels, the four index sets) must be equal element for element and of the
same dtype, because the port copies grandtpu's numpy/scipy code. The
preprocess functions and the split draws are held to grandtpu's the same
way on seeded inputs.
"""

import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from grandtpu.data import load_data as jax_load_data
from grandtpu.data import preprocess as jpp
from grandtpu.data import sparsegraph as jsg
from grandtpu.data.splits import \
    get_train_val_test_split as jax_split

from grandtpu_torch.data import load_data, synthetic_graph
from grandtpu_torch.data import preprocess as tpp
from grandtpu_torch.data import sparsegraph as tsg
from grandtpu_torch.data.splits import _check_split, get_train_val_test_split


@pytest.fixture()
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("GRANDTPU_DATA_DIR", str(tmp_path))
    return tmp_path


def _graph(n=400, c=4, f=10, seed=1):
    adj, feats, onehot = synthetic_graph(num_nodes=n, num_classes=c,
                                         num_features=f, seed=seed)
    return adj, np.asarray(feats, np.float32), onehot


def _same(a, b):
    """Equal element for element, in type, dtype and shape."""
    assert sp.issparse(a) == sp.issparse(b)
    if sp.issparse(a):
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a != b).nnz == 0
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _both_equal(name, seed=0):
    """Load ``name`` through both packages; every field equal. Returns the
    port's GraphData."""
    want = jax_load_data(name, split_seed=seed)
    got = load_data(name, split_seed=seed)
    for field in ("adj", "features", "labels", "idx_train", "idx_val",
                  "idx_test", "idx_unlabel"):
        _same(getattr(got, field), getattr(want, field))
    assert got.name == want.name == name
    return got


@pytest.mark.parametrize("onehot_labels", [True, False])
@pytest.mark.parametrize("name", ["reddit", "Amazon2M"])
def test_npy_families(data_dir, name, onehot_labels):
    """reddit (20/30 a class) and Amazon2M (20·c train, 30·c val drawn by
    size), labels stored one-hot or as class ids."""
    adj, feats, onehot = _graph()
    sp.save_npz(data_dir / f"{name}_adj.npz", adj,
                compressed=name == "reddit")
    np.save(data_dir / f"{name}_feat.npy", feats)
    np.save(data_dir / f"{name}_labels.npy",
            onehot if onehot_labels else onehot.argmax(-1))
    for seed in (0, 3):
        d = _both_equal(name, seed)
    assert len(d.idx_train) == 80
    if name == "Amazon2M":
        assert len(d.idx_val) == 120
        # drawn by size: not 20 of every class
        assert np.unique(d.labels[d.idx_train].sum(0)).size > 1


def test_aminer_family(data_dir):
    adj, feats, onehot = _graph()
    for fname, obj in (("aminer.adj.sp.pkl", adj),
                       ("aminer.features.pkl", feats),
                       ("aminer.labels.pkl", onehot.argmax(-1))):
        with open(data_dir / fname, "wb") as f:
            pickle.dump(obj, f)
    d = _both_equal("aminer")
    assert np.abs(d.features.mean(0)).max() < 1e-5


def test_mag_family(data_dir):
    adj, feats, onehot = _graph()
    feats_sp = sp.csr_matrix(feats)
    np.savez(
        data_dir / "mag_scholar_c.npz",
        **{"adj_matrix.data": adj.data, "adj_matrix.indices": adj.indices,
           "adj_matrix.indptr": adj.indptr,
           "adj_matrix.shape": np.array(adj.shape),
           "attr_matrix.data": feats_sp.data,
           "attr_matrix.indices": feats_sp.indices,
           "attr_matrix.indptr": feats_sp.indptr,
           "attr_matrix.shape": np.array(feats_sp.shape),
           "labels": onehot.argmax(-1)})
    d = _both_equal("mag_scholar_c")
    assert d.has_sparse_features and d.num_classes == 4


@pytest.mark.parametrize("name", ["ms_academic_cs", "cora_full"])
def test_npz_sparsegraph_family(data_dir, name):
    """The SparseGraph npz family: standardize() (the largest connected
    component), binary bag of words; cora_full first drops the classes
    with fewer than 51 nodes."""
    adj, feats, onehot = _graph(n=500, seed=2)
    labels = onehot.argmax(-1)
    if name == "cora_full":      # a class too small for 20 + 30 draws
        labels[np.random.RandomState(0).choice(500, 12, replace=False)] = 4
    # a weighted, non-binary copy: standardize() and the BoW clamp act
    adj = adj.multiply(3.0).tocsr()
    attr = sp.csr_matrix(np.where(feats > 0.5, feats, 0.0))
    tsg.save_sparse_graph_to_npz(str(data_dir / f"{name}.npz"),
                                 tsg.SparseGraph(adj, attr, labels))
    d = _both_equal(name)
    assert d.num_classes == 4
    assert set(np.unique(d.features).tolist()) <= {0.0, 1.0}
    assert (d.adj != d.adj.T).nnz == 0


def _planetoid_files(path, name, seed=0):
    """``ind.<name>.*`` pickles of a small graph in Planetoid's layout:
    30 labelled nodes, 600 more in allx, 100 test nodes whose ids the index
    file lists out of order (citeseer: 5 ids missing, isolated)."""
    rs = np.random.RandomState(seed)
    n_all, n_test, nfeat, c = 630, 100, 16, 3
    gap = 5 if name == "citeseer" else 0
    test_ids = n_all + np.sort(rs.choice(n_test + gap, n_test,
                                         replace=False))
    n = n_all + n_test + gap
    feats = sp.random(n, nfeat, density=0.2, random_state=rs, format="csr",
                      dtype=np.float64)
    lab = np.eye(c)[rs.randint(0, c, n)]
    graph = {u: sorted(set(rs.randint(0, n, 4).tolist()) - {u})
             for u in range(n)}
    objs = {"x": feats[:30], "y": lab[:30], "allx": feats[:n_all],
            "ally": lab[:n_all], "tx": feats[test_ids], "ty": lab[test_ids],
            "graph": graph}
    for key, obj in objs.items():
        with open(path / f"ind.{name}.{key}", "wb") as f:
            pickle.dump(obj, f)
    order = rs.permutation(test_ids)
    (path / f"ind.{name}.test.index").write_text(
        "\n".join(str(i) for i in order) + "\n")


@pytest.mark.parametrize("name", ["cora", "citeseer", "pubmed"])
def test_planetoid_family(data_dir, name):
    """Planetoid pickles (which grandtpu's own tests do not cover), read
    from the ``citation`` subdirectory as both loaders look for it."""
    (data_dir / "citation").mkdir()
    _planetoid_files(data_dir / "citation", name)
    d = _both_equal(name)
    assert len(d.idx_train) == 30 and len(d.idx_val) == 500
    assert (d.adj != d.adj.T).nnz == 0
    rows = d.features.sum(1)
    assert np.allclose(rows[rows > 0], 1.0, atol=1e-6)   # row-normalized


@pytest.mark.parametrize("spec,seed", [("synth:300:3:12", 0),
                                       ("synth:500:5:40:sparse", 7)])
def test_synth_bit_for_bit(spec, seed):
    _both_equal(spec, seed)


def test_sparsegraph_across_packages(tmp_path):
    """A SparseGraph npz written by either package loads in the other
    with every array equal; standardize() and subgraph() agree."""
    adj, feats, onehot = _graph(seed=4)
    args = (adj, sp.csr_matrix(feats), onehot.argmax(-1))
    for save, load in ((tsg.save_sparse_graph_to_npz,
                        jsg.load_npz_to_sparse_graph),
                       (jsg.save_sparse_graph_to_npz,
                        tsg.load_npz_to_sparse_graph)):
        p = str(tmp_path / "g.npz")
        save(p, tsg.SparseGraph(*args))
        a, b = tsg.load_npz_to_sparse_graph(p), load(p)
        for x, y in zip(a.unpack(), b.unpack()):
            _same(x, y)
    keep = np.random.RandomState(0).choice(400, 250, replace=False)
    for op in (lambda g: g.standardize(), lambda g: g.subgraph(keep)):
        for x, y in zip(op(tsg.SparseGraph(*args)).unpack(),
                        op(jsg.SparseGraph(*args)).unpack()):
            _same(x, y)


def _seeded_inputs():
    rs = np.random.RandomState(5)
    adj = sp.random(120, 120, density=0.05, random_state=rs, format="csr")
    adj.setdiag(rs.rand(120))
    adj = adj.tocsr()
    adj[:10, :] = 0          # empty rows, and small components
    adj.eliminate_zeros()
    feats = sp.random(120, 30, density=0.3, random_state=rs, format="csr")
    dense = rs.randn(120, 7)
    dense[:, 3] = 2.5        # a constant column
    labels = rs.choice([3, 8, 9, 12], 120, p=[0.6, 0.3, 0.07, 0.03])
    return adj, feats, dense, labels


@pytest.mark.parametrize("fn,args", [
    ("row_normalize", lambda a, f, d, l: (f,)),
    ("row_normalize", lambda a, f, d, l: (a,)),
    ("col_standardize", lambda a, f, d, l: (d,)),
    ("to_binary_bag_of_words", lambda a, f, d, l: (f,)),
    ("is_binary_bag_of_words", lambda a, f, d, l: (f,)),
    ("is_binary_bag_of_words",
     lambda a, f, d, l: (jpp.to_binary_bag_of_words(f),)),
    ("eliminate_self_loops_adj", lambda a, f, d, l: (a,)),
    ("add_self_loops_adj", lambda a, f, d, l: (a, 2.0)),
    ("to_undirected", lambda a, f, d, l: (a,)),
    ("to_unweighted", lambda a, f, d, l: (a,)),
    ("sym_renormalize", lambda a, f, d, l: (a,)),
    ("largest_connected_component", lambda a, f, d, l: (a,)),
    ("largest_connected_component", lambda a, f, d, l: (a, 3)),
    ("binarize_labels", lambda a, f, d, l: (l,)),
    ("binarize_labels", lambda a, f, d, l: (np.eye(4)[l % 4],)),
    ("remove_underrepresented_classes", lambda a, f, d, l: (l, 2, 3)),
    ("remove_underrepresented_classes", lambda a, f, d, l: (l, 5, 10)),
])
def test_preprocess_as_grandtpu(fn, args):
    inputs = args(*_seeded_inputs())
    got, want = getattr(tpp, fn)(*inputs), getattr(jpp, fn)(*inputs)
    if isinstance(want, bool):
        assert got is want
    else:
        _same(got, want)


@pytest.mark.parametrize("kw", [
    dict(train_size=40, val_size=60),
    dict(train_examples_per_class=5, val_examples_per_class=8),
    dict(train_examples_per_class=5, val_size=30),
    dict(train_size=40, val_examples_per_class=8),
])
@pytest.mark.parametrize("seed", [0, 11])
def test_split_as_grandtpu(kw, seed):
    """The size-based and per-class draws, and their mixes, give
    grandtpu's node ids for the same seed."""
    labels = np.eye(4, dtype=np.float32)[
        np.random.RandomState(2).randint(0, 4, 400)]
    got = get_train_val_test_split(np.random.RandomState(seed), labels, **kw)
    want = jax_split(np.random.RandomState(seed), labels, **kw)
    for g, w in zip(got, want):
        _same(g, w)
    assert sum(map(len, got)) == 400


@pytest.mark.parametrize("parts,match", [
    (([0, 0], [1], [2, 3]), "duplicate"),
    (([0, 1], [1], [2, 3]), "overlap"),
    (([0], [1], [2]), "cover"),
    (([0, 1], [2], [3]), "per class"),
])
def test_check_split_refuses(parts, match):
    """The split invariants raise ValueError, as grandtpu's asserts fail."""
    labels = np.eye(2, dtype=np.float32)[[0, 0, 1, 1]]
    with pytest.raises(ValueError, match=match):
        _check_split(labels, *map(np.asarray, parts), (1, None))
