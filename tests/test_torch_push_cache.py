"""The port's push cache (``ppr/cache.py``) against grandtpu's: the same key
for the same inputs, each package's entries hits for the other, a new
entry for each changed parameter, and ``train()`` with ``push_cache_dir``
(the MAG engine too)."""

import numpy as np
import pytest
import scipy.sparse as sp

from grandtpu.ppr import cache as jcache

from grandtpu_torch.config import GrandConfig
from grandtpu_torch.ppr import cache as tcache
from grandtpu_torch.ppr import cached_gfpush
from grandtpu_torch.ppr.coef import build_coef
from grandtpu_torch.train import trainer as ttrainer

KW = dict(prop_mode="ppr", order=8, alpha=0.25, rmax=1e-4, k=16)


@pytest.fixture(scope="module")
def pushed():
    rs = np.random.RandomState(0)
    a = sp.random(300, 300, density=0.03, random_state=rs, format="csr")
    adj = ((a + a.T) > 0).astype(np.float32) + sp.eye(300, format="csr")
    return adj.tocsr(), rs.permutation(300)[:60]


@pytest.mark.parametrize("mode,order,alpha", [("ppr", 8, 0.25),
                                              ("avg", 3, 0.1)])
def test_push_cache_key_matches_grandtpu(pushed, mode, order, alpha):
    adj, sources = pushed
    coef = build_coef(mode, order, alpha)
    for rmax, k in ((1e-4, 16), (1e-7, 32)):
        args = (adj.indptr, adj.indices, sources, coef, rmax, k)
        got = tcache.push_cache_key(*args)
        assert got == jcache.push_cache_key(*args)
        assert len(got) == 32


def _poison(monkeypatch, module):
    def boom(*a, **k):
        raise AssertionError("cache miss: the push ran")

    monkeypatch.setattr(module, "gfpush", boom)


def test_entries_hit_across_packages(pushed, tmp_path, monkeypatch):
    """grandtpu's entry is a hit for the port, and the port's for
    grandtpu (each package's push poisoned); cols and vals equal."""
    adj, sources = pushed
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    want = jcache.cached_gfpush(jdir, adj, sources, backend="numpy", **KW)
    mine = cached_gfpush(tdir, adj, sources, backend="native", device="cpu",
                         **KW)
    _poison(monkeypatch, tcache)
    _poison(monkeypatch, jcache)
    got = cached_gfpush(jdir, adj, sources, **KW)
    back = jcache.cached_gfpush(tdir, adj, sources, **KW)
    for a, b in ((got, want), (back, mine)):
        np.testing.assert_array_equal(a.sources, b.sources)
        np.testing.assert_array_equal(a.cols, b.cols)
        np.testing.assert_array_equal(a.vals, b.vals)
        assert a.num_nodes == b.num_nodes == 300
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == sorted(
        p.name for p in (tmp_path / "t").iterdir())


def test_changed_parameters_give_new_entries(pushed, tmp_path, monkeypatch):
    adj, sources = pushed
    d = str(tmp_path)
    tk = cached_gfpush(d, adj, sources, backend="native", device="cpu", **KW)
    _poison(monkeypatch, tcache)
    again = cached_gfpush(d, adj, sources, backend="bucket", device="cpu",
                          **KW)     # the key does not depend on the backend
    np.testing.assert_array_equal(again.vals, tk.vals)
    monkeypatch.undo()
    for change in (dict(k=8), dict(rmax=2e-4)):
        cached_gfpush(d, adj, sources, backend="native", device="cpu",
                      **{**KW, **change})
    cached_gfpush(d, adj, sources[:-1], backend="native", device="cpu",
                  **KW)
    assert len(list(tmp_path.glob("push_*.npz"))) == 4
    assert not list(tmp_path.glob("*.tmp*"))       # no temporary left


@pytest.mark.parametrize("dataset", ["synth:400:4:16",
                                     "synth:400:4:40:sparse"])
def test_trainer_uses_push_cache(dataset, tmp_path, monkeypatch):
    """Two ``train()`` runs with ``push_cache_dir`` leave exactly one
    entry; the second runs no push and trains the same."""
    cfg = GrandConfig(dataset=dataset, epochs=2, eval_batch=2,
                      push_cache_dir=str(tmp_path))
    first = ttrainer.train(cfg, device="cpu")
    assert len(list(tmp_path.glob("push_*.npz"))) == 1
    _poison(monkeypatch, tcache)
    second = ttrainer.train(cfg, device="cpu")
    assert len(list(tmp_path.glob("push_*.npz"))) == 1
    assert second.history == first.history
