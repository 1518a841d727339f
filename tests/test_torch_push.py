"""The port's device GFPush backends against grandtpu's, on the CPU (their
plain versions): the sparse-residue push (P2, ``gfpush_bucketed``) and the
dense-residue push (P1, ``gfpush_dense``, grandtpu's ``gfpush_jax``), with
the numpy oracle as ground truth, the per-row top-k, the block back-off,
determinism, the API's backends and the ``auto`` policy.

Tolerance: ``atol = tie_tol = max(1e-5, 2 * rmax)`` through the row rule of
``tests/test_gfpush_backends.py``. Both device pushes compute in f32 or in
62-bit fixed point, the oracle in f64, so a residue at its rmax threshold
can be pushed in one and dropped in the other: results agree to the
pruning granularity, not to float eps.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.data import synthetic_graph
from grandtpu.ppr import build_coef
from grandtpu.ppr import gfpush as jax_gfpush
from grandtpu.ppr import gfpush_numpy
from grandtpu.ppr.bucket_push import gfpush_bucketed as jax_bucketed
from grandtpu.ppr.jax_push import gfpush_jax

from grandtpu_torch.ppr import api, gfpush
from grandtpu_torch.ppr.bucket_push import (ONE, BucketPushGraph,
                                            gfpush_bucketed, initial_frontier,
                                            push_hop, reserve_topk)
from grandtpu_torch.ppr.dense_push import (dense_push_mask, gfpush_dense)
from grandtpu_torch.ppr.push_topk import push_topk, row_offsets

K = 16


def _rows_as_dicts(cols, vals):
    return [{int(c): float(v) for c, v in zip(cr, vr) if v > 0}
            for cr, vr in zip(cols, vals)]


def _assert_row_parity(cols_a, vals_a, cols_b, vals_b, atol, tie_tol):
    """tests/test_gfpush_backends.py's rule: equal value multisets up to
    atol; equal (col -> val) maps for every entry above the smaller row's
    cutoff by more than tie_tol (ties at the k-th value may pick other
    columns)."""
    a, b = _rows_as_dicts(cols_a, vals_a), _rows_as_dicts(cols_b, vals_b)
    for ra, rb, va, vb in zip(a, b, vals_a, vals_b):
        np.testing.assert_allclose(
            np.sort(np.asarray(list(ra.values())))[::-1],
            np.sort(np.asarray(list(rb.values())))[::-1], atol=atol)
        cutoff = min(va[va > 0].min() if (va > 0).any() else 0,
                     vb[vb > 0].min() if (vb > 0).any() else 0)
        for col, val in ra.items():
            if val > cutoff + tie_tol:
                assert col in rb, f"col {col} missing"
                np.testing.assert_allclose(val, rb[col], atol=atol)


def _parity(want, got, rmax):
    atol = max(1e-5, 2.0 * rmax)
    _assert_row_parity(*want, *got, atol=atol, tie_tol=atol)


@pytest.fixture(scope="module")
def pushed():
    """grandtpu's test graph: synthetic_graph(120, 3, 16, seed=3) plus
    self-loops, ppr order 8, every third node a source."""
    adj, _, _ = synthetic_graph(num_nodes=120, num_classes=3,
                                num_features=16, seed=3)
    adj = (adj + sp.eye(adj.shape[0], format="csr")).tocsr()
    return adj, build_coef("ppr", order=8, alpha=0.25), np.arange(0, 120, 3)


@pytest.fixture(scope="module")
def dangling():
    """The 5-node graph without self-loops; node 4 has no out-edges."""
    rows = np.array([0, 0, 1, 2, 2, 3])
    cols = np.array([1, 2, 4, 1, 3, 0])
    adj = sp.csr_matrix((np.ones(6), (rows, cols)), shape=(5, 5))
    return adj, build_coef("ppr", order=4, alpha=0.3), np.arange(5)


def _port(backend, adj, sources, coef, rmax, k, **kw):
    fn = gfpush_bucketed if backend == "bucket" else gfpush_dense
    return fn(adj.indptr, adj.indices, sources, coef, rmax, k, device="cpu",
              **kw)


@pytest.mark.parametrize("rmax", [0.0, 1e-3, 1e-2])
def test_bucket_matches_grandtpu_and_oracle(pushed, rmax):
    """block=16 over 40 sources: several blocks and a short tail block."""
    adj, coef, sources = pushed
    got = _port("bucket", adj, sources, coef, rmax, K, block=16)
    _parity(gfpush_numpy(adj.indptr, adj.indices, sources, coef, rmax, K),
            got, rmax)
    _parity(jax_bucketed(adj.indptr, adj.indices, sources, coef, rmax, K,
                         block=16), got, rmax)


@pytest.mark.parametrize("dense_threshold", [8192, 0])
@pytest.mark.parametrize("rmax", [0.0, 1e-3, 1e-2])
def test_dense_matches_grandtpu_and_oracle(pushed, rmax, dense_threshold):
    """The dense product (n <= dense_threshold) and K2 over A^T (0)."""
    adj, coef, sources = pushed
    got = _port("jax", adj, sources, coef, rmax, K, block=16,
                dense_threshold=dense_threshold)
    _parity(gfpush_numpy(adj.indptr, adj.indices, sources, coef, rmax, K),
            got, rmax)
    _parity(gfpush_jax(adj.indptr, adj.indices, sources, coef, rmax, K,
                       dense_threshold=dense_threshold), got, rmax)


@pytest.mark.parametrize("backend", ["bucket", "jax"])
def test_dangling_teleport(dangling, backend):
    """A dangling node's residue goes back to the source (graph.h:91-93)."""
    adj, coef, sources = dangling
    got = _port(backend, adj, sources, coef, 0.0, 5)
    want = gfpush_numpy(adj.indptr, adj.indices, sources, coef, 0.0, 5)
    _assert_row_parity(*want, *got, atol=1e-6, tie_tol=1e-6)
    jax_fn = jax_bucketed if backend == "bucket" else gfpush_jax
    _assert_row_parity(*jax_fn(adj.indptr, adj.indices, sources, coef, 0.0,
                               5), *got, atol=1e-6, tie_tol=1e-6)


@pytest.mark.parametrize("backend", ["bucket", "jax"])
def test_single_mode_zero_coefs(backend):
    """'single' coefficients are one-hot on the last hop: the earlier hops'
    zero reserves must not enter the top-k."""
    adj, _, _ = synthetic_graph(num_nodes=80, num_classes=3, num_features=8,
                                seed=7)
    adj = (adj + sp.eye(80, format="csr")).tocsr()
    coef = build_coef("single", order=3, alpha=0.0)
    sources = np.arange(0, 80, 5)
    got = _port(backend, adj, sources, coef, 0.0, 8)
    want = gfpush_numpy(adj.indptr, adj.indices, sources, coef, 0.0, 8)
    _assert_row_parity(*want, *got, atol=1e-6, tie_tol=1e-6)
    assert np.all(got[1] >= 0)


@pytest.mark.parametrize("backend", ["bucket", "jax"])
def test_rows_with_fewer_than_k_positives_are_padded(pushed, backend):
    """k larger than any row's reach: rows end in col 0 / val 0 padding and
    agree with the oracle entry for entry."""
    adj, coef, sources = pushed
    coef = build_coef("ppr", order=2, alpha=0.25)
    cols, vals = _port(backend, adj, sources, coef, 0.0, 120)
    oc, ov = gfpush_numpy(adj.indptr, adj.indices, sources, coef, 0.0, 120)
    assert (vals == 0).any(axis=1).all()
    np.testing.assert_array_equal(vals > 0, ov > 0)
    np.testing.assert_array_equal(np.where(vals > 0, cols, 0), cols)
    _assert_row_parity(oc, ov, cols, vals, atol=1e-6, tie_tol=1e-6)


@pytest.mark.parametrize("backend", ["bucket", "jax"])
def test_two_runs_identical_and_sorted(pushed, backend):
    adj, coef, sources = pushed
    a = _port(backend, adj, sources, coef, 1e-4, K)
    b = _port(backend, adj, sources, coef, 1e-4, K)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert np.all(np.diff(a[1], axis=1) <= 0)       # descending rows


def test_bucket_block_size_does_not_change_the_result(pushed):
    """Fixed-point sums: the same integers whatever the blocking."""
    adj, coef, sources = pushed
    a = _port("bucket", adj, sources, coef, 1e-3, K, block=7)
    b = _port("bucket", adj, sources, coef, 1e-3, K, block=1024)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_bucket_block_backoff(pushed):
    """A slot_limit too small for the block halves it, with grandtpu's
    warning, and the result is the one a small block gives."""
    adj, coef, sources = pushed
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _port("bucket", adj, sources, coef, 1e-4, K, block=64,
                    slot_limit=20_000, min_block=4)
    assert any("retrying at block=" in str(x.message) for x in w)
    want = _port("bucket", adj, sources, coef, 1e-4, K, block=16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _parity(gfpush_numpy(adj.indptr, adj.indices, sources, coef, 1e-4, K),
            got, 1e-4)


def test_bucket_backoff_stops_at_min_block(pushed):
    adj, coef, sources = pushed
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(MemoryError, match="slots"):
            _port("bucket", adj, sources, coef, 1e-4, K, block=64,
                  slot_limit=10, min_block=16)


def test_bucket_hop_in_fixed_point(pushed):
    """One hop from a source: each neighbour gets floor(2^62 / deg), the
    next hop's slots are the neighbours' degrees, and the reserves are
    trunc(coef * q) summed per node."""
    adj, _, _ = pushed
    g = BucketPushGraph(adj.indptr, adj.indices, 0.0, device="cpu")
    src = torch.tensor([0, 5], dtype=torch.int32)
    fr0 = initial_frontier(g, src)
    deg = np.diff(adj.indptr)
    assert fr0.exp.tolist() == deg[[0, 5]].tolist()
    fr1 = push_hop(g, fr0, src, int(fr0.exp.sum()))
    for b, s in enumerate((0, 5)):
        o, c = int(fr1.off[b]), int(fr1.cnt[b])
        nbrs = adj.indices[adj.indptr[s]:adj.indptr[s + 1]]
        assert sorted(fr1.ids[o:o + c].tolist()) == sorted(nbrs.tolist())
        assert set(fr1.q[o:o + c].tolist()) == {ONE // int(deg[s])}
        assert int(fr1.exp[b]) == int(deg[nbrs].sum())
    cols, vals = reserve_topk(g, [(fr0, 0.5), (fr1, 0.25)], 4)
    c1 = int((ONE // int(deg[0])) * 0.25)       # each neighbour of node 0
    others = sorted(set(adj.indices[adj.indptr[0]:adj.indptr[1]]) - {0})
    assert cols[0, :2].tolist() == [0, others[0]]   # node 0 has a self-loop
    assert float(vals[0, 0]) == np.float32((ONE // 2 + c1) / ONE)
    assert float(vals[0, 1]) == np.float32(c1 / ONE)


@pytest.mark.parametrize("backend", ["bucket", "jax"])
def test_gfpush_api_backend_matches_grandtpu(pushed, backend):
    adj, _, sources = pushed
    kw = dict(prop_mode="ppr", order=6, alpha=0.1, rmax=1e-4, k=K)
    got = gfpush(adj, sources, backend=backend, device="cpu", **kw)
    want = jax_gfpush(adj, sources, backend=backend, **kw)
    assert got.cols.shape == (len(sources), K)
    assert got.num_nodes == adj.shape[0]
    np.testing.assert_array_equal(got.sources, want.sources)
    _parity((want.cols, want.vals), (got.cols, got.vals), 1e-4)


def test_gfpush_device_backends_need_a_device():
    """jax, bucket and auto run on the card unless asked for the CPU, and
    raise without one; native and numpy ignore the device."""
    adj = sp.eye(4, format="csr")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for backend in ("jax", "bucket", "auto"):
        with pytest.raises(RuntimeError, match="CUDA"):
            gfpush(adj, np.arange(4), backend=backend, k=2)
    assert gfpush(adj, np.arange(4), backend="numpy", k=2).cols.shape == (4, 2)
    with pytest.raises(ValueError, match="unknown push backend"):
        gfpush(adj, np.arange(4), backend="nope", k=2, device="cpu")


def test_auto_backend_policy(monkeypatch):
    """grandtpu's test_auto_backend_policy with the device in place of
    JAX's backend: the bucket push when a CUDA device is asked for, the push
    is large and the host kernel would lose (or is missing); else native;
    else numpy."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.setattr(api.native, "native_available", lambda: True)
    monkeypatch.setattr(api.os, "cpu_count", lambda: 2)
    nnz = 62_000_000
    assert api._auto_backend(nnz, 16384, cuda) == "native"
    monkeypatch.setenv("GRANDTPU_PUSH_CORES", "0")
    assert api._auto_backend(nnz, 16384, cuda) == "bucket"
    assert api._auto_backend(nnz, 16384, cpu) == "native"
    assert api._auto_backend(nnz, 512, cuda) == "native"
    monkeypatch.delenv("GRANDTPU_PUSH_CORES")
    monkeypatch.setattr(api.native, "native_available", lambda: False)
    assert api._auto_backend(nnz, 16384, cuda) == "bucket"
    assert api._auto_backend(nnz, 16384, cpu) == "numpy"
    monkeypatch.setenv("GRANDTPU_PUSH_BACKEND", "numpy")
    assert api._auto_backend(nnz, 16384, cuda) == "numpy"


def test_auto_backend_end_to_end_bucket(pushed, monkeypatch):
    """backend='auto' forced to the bucket push by GRANDTPU_PUSH_BACKEND
    gives the oracle's answer (the plain version on the CPU device)."""
    adj, _, sources = pushed
    monkeypatch.setenv("GRANDTPU_PUSH_BACKEND", "bucket")
    kw = dict(prop_mode="ppr", order=6, alpha=0.25, rmax=1e-4, k=K)
    got = gfpush(adj, sources, backend="auto", device="cpu", **kw)
    want = jax_gfpush(adj, sources, backend="numpy", **kw)
    _parity((want.cols, want.vals), (got.cols, got.vals), 1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_push_topk_order_ties_and_padding(seed):
    """Value descending, ties by id ascending, only values > 0, padded with
    col 0 / val 0; ragged rows (one empty) with and without ids."""
    rs = np.random.RandomState(seed)
    lens = np.array([0, 3, 40, 17, 200])
    vals = rs.choice([0.0, -1.0, 0.25, 0.5, 0.125, 1e-3],
                     size=lens.sum()).astype(np.float32)
    vals[-100:] = rs.rand(100).astype(np.float32)
    ids = np.concatenate([rs.permutation(10_000)[:n] for n in lens])
    off = row_offsets(torch.as_tensor(lens))
    for use_ids in (True, False):
        k = 12
        cols, out = push_topk(torch.as_tensor(ids, dtype=torch.int32)
                              if use_ids else None,
                              torch.as_tensor(vals), off, k)
        for r, n in enumerate(lens):
            s = int(off[r])
            v = vals[s:s + n]
            i = ids[s:s + n] if use_ids else np.arange(n)
            keep = v > 0
            order = np.lexsort((i[keep], -v[keep]))[:k]
            m = order.shape[0]
            np.testing.assert_array_equal(cols[r, :m].numpy(),
                                          i[keep][order])
            np.testing.assert_array_equal(out[r, :m].numpy(),
                                          v[keep][order])
            assert not cols[r, m:].any() and not out[r, m:].any()


def test_dense_push_mask_plain_hop():
    """One hop of the mask on a 4-node graph with a dangling node: reserve
    update, rmax mask, division by the degree and the teleport in Q62."""
    residue = torch.tensor([[0.5, 0.0], [0.25, 1.0], [0.0, 2e-3],
                            [0.125, 0.5]])
    deg = torch.tensor([2.0, 4.0, 3.0, 0.0])
    thr = 1e-2 * deg
    reserve = torch.ones_like(residue)
    pushed = torch.empty_like(residue)
    tele = torch.zeros(2, dtype=torch.int64)
    src = torch.tensor([0, 1], dtype=torch.int32)
    dense_push_mask(residue, reserve, pushed, None, tele, src, deg, thr,
                    0.5, False)
    torch.testing.assert_close(reserve, 1.0 + 0.5 * residue, rtol=0, atol=0)
    torch.testing.assert_close(
        pushed, torch.tensor([[0.25, 0.0], [0.0625, 0.25], [0.0, 0.0],
                              [0.0, 0.0]]), rtol=0, atol=0)
    assert tele.tolist() == [ONE // 8, ONE // 2]
    # the final call adds the teleport at (src[b], b) before the reserve
    dense_push_mask(residue, reserve, pushed, tele, None, src, deg, thr,
                    1.0, True)
    assert float(reserve[0, 0]) == 1.25 + 0.5 + 0.125
    assert float(reserve[1, 1]) == 1.5 + 1.0 + 0.5
