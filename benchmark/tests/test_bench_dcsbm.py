"""The degree-corrected stand-in (``standin_dcsbm.py``) at a reduced size
of the reddit configuration's graph: its pairs, its bytes, the hub rows
the port's operator splits, and its one generation a checkout."""

import copy
import filecmp
import os
import subprocess

import numpy as np
import pytest

from benchmark import harness, standin, standin_dcsbm
from grandtpu_torch.sparse.spmm import default_split_cap

BENCH = harness.manifest()
REDDIT = harness.cell("reddit-predict", BENCH)[1]


def reduced(**keys) -> dict:
    """The reddit configuration with its graph's published keys, at the
    sizes given."""
    cfg = copy.deepcopy(REDDIT)
    cfg.update(keys)
    return cfg


# 24,000 nodes at the published mean degree of 100 and features cut to 8:
# the expected degrees, repeats merged, put 353 rows above the cap of 808
# holding 19.6 % of the nonzeros (at the full size: 3,481 rows, 33.3 %)
MEAN_100 = reduced(nodes=24000, edges=1200000, features=8)


@pytest.fixture(scope="module")
def graph():
    return standin_dcsbm.generate(MEAN_100)


def test_exact_symmetric_pairs_without_self_loops(graph):
    adj, feats, labels = graph
    n = MEAN_100["nodes"]
    assert adj.shape == (n, n)
    assert adj.nnz == 2 * MEAN_100["edges"]
    assert (adj != adj.T).nnz == 0
    assert not adj.diagonal().any()
    assert np.all(adj.data == 1.0)
    assert feats.shape == (n, MEAN_100["features"]) and feats.dtype == \
        np.float32
    assert np.bincount(labels).tolist() == [n // 41 + (c < n % 41)
                                            for c in range(41)]


def test_hub_rows_split_at_the_default_cap(graph):
    adj = graph[0]
    deg = np.diff(adj.indptr) + 1           # with the self-loop
    nnz = int(deg.sum())
    cap = default_split_cap(adj.shape[0], nnz)
    assert cap == 808
    hubs = deg > cap
    share = deg[hubs].sum() / nnz
    assert 300 <= hubs.sum() <= 420, hubs.sum()
    assert 0.16 <= share <= 0.23, share
    # the hubs lie anywhere in the row order, not in the first rows
    rows = np.flatnonzero(hubs)
    assert rows.min() < adj.shape[0] // 10 and rows.max() > \
        adj.shape[0] * 9 // 10


def test_same_bytes_from_the_same_data_seed(tmp_path):
    cfg = reduced(nodes=24000, edges=240000, features=10, classes=5)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    standin_dcsbm.write(cfg, a)
    standin_dcsbm.write(cfg, b)
    files = sorted(os.listdir(os.path.join(a, cfg["dataset"])))
    assert files == ["reddit_adj.npz", "reddit_feat.npy",
                     "reddit_labels.npy"]
    _, mismatch, errors = filecmp.cmpfiles(
        os.path.join(a, cfg["dataset"]), os.path.join(b, cfg["dataset"]),
        files, shallow=False)
    assert mismatch == [] and errors == []
    other = dict(cfg, graph=dict(cfg["graph"], data_seed=8))
    assert not np.array_equal(standin_dcsbm.generate(other)[0].indices,
                              standin_dcsbm.generate(cfg)[0].indices)


def test_ensure_then_data_root_generates_once(tmp_path, monkeypatch):
    cfg = reduced(nodes=24000, edges=240000, features=10, classes=5)
    cache = str(tmp_path)
    root = standin_dcsbm.ensure(cfg, cache)
    assert root == os.path.join(cache, f"reddit-{standin.data_key(cfg)}")
    raw = standin.raw_arrays(cfg, root)
    assert raw["adj"].nnz == 2 * cfg["edges"]
    assert raw["features"].shape == (cfg["nodes"], cfg["features"])

    def refuse(*args, **kwargs):
        raise AssertionError(f"generated again: {args}")

    monkeypatch.setattr(subprocess, "run", refuse)
    assert standin_dcsbm.ensure(cfg, cache) == root
    assert standin.data_root(cfg, cache) == root
    assert sorted(os.listdir(cache)) == [os.path.basename(root)]


def test_the_configuration_is_the_presets():
    from grandtpu_torch.config import preset

    p = preset("reddit")
    assert (p.order, p.alpha, p.hidden, p.nlayers, p.use_bn,
            p.node_norm) == (REDDIT["order"], REDDIT["alpha"],
                             REDDIT["hidden"], REDDIT["nlayers"],
                             REDDIT["use_bn"], REDDIT["node_norm"])
    assert REDDIT["graph"]["kind"] == "dcsbm"
