"""The sizing and layout that the sparse-residue push's CUDA kernels
(``bucket_hop``, ``bucket_reserve``) rest on, on the CPU: the invariants
that size their outputs (a hop's distinct targets never exceed its
expansion slots; a source's distinct reserves never exceed its log's
entries), the host layout of their shared and global tables, the packed
node record, and the plain P2 on a graph with a hub row against grandtpu's
``gfpush_bucketed`` and the numpy oracle.

Tolerance: the row rule of ``tests/test_torch_push.py`` with ``atol =
tie_tol = max(1e-5, 2 * rmax)`` (fixed point against f32 and f64: a
residue at its rmax threshold can be pushed in one and dropped in the
other).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from grandtpu.data import synthetic_graph
from grandtpu.ppr import build_coef, gfpush_numpy
from grandtpu.ppr.bucket_push import gfpush_bucketed as jax_bucketed

from grandtpu_torch.ppr.bucket_push import (ONE, SMEM_SLOTS, BucketPushGraph,
                                            gfpush_bucketed, initial_frontier,
                                            node_records, push_hop_plain,
                                            reserve_table_plain, table_layout)


def _assert_row_parity(cols_a, vals_a, cols_b, vals_b, atol, tie_tol):
    """tests/test_gfpush_backends.py's rule: equal value multisets up to
    atol; equal (col -> val) maps for every entry above the smaller row's
    cutoff by more than tie_tol (ties at the k-th value may pick other
    columns)."""
    for ca, va, cb, vb in zip(cols_a, vals_a, cols_b, vals_b):
        pa, pb = va > 0, vb > 0
        np.testing.assert_allclose(np.sort(va[pa])[::-1],
                                   np.sort(vb[pb])[::-1], atol=atol)
        cutoff = min(va[pa].min() if pa.any() else 0,
                     vb[pb].min() if pb.any() else 0)
        row_b = dict(zip(cb[pb].tolist(), vb[pb].tolist()))
        for col, val in zip(ca[pa].tolist(), va[pa].tolist()):
            if val > cutoff + tie_tol:
                assert col in row_b, f"col {col} missing"
                np.testing.assert_allclose(val, row_b[col], atol=atol)


def _hub_graph(n, hub_degree, dangling, seed):
    """A random graph with self-loops, node 0 a hub row of ``hub_degree``
    random neighbours, and the last ``dangling`` nodes without a row."""
    rs = np.random.RandomState(seed)
    adj = sp.random(n, n, density=min(1.0, 3.0 / n), random_state=rs,
                    format="lil")
    adj.setdiag(1.0)
    adj[0, rs.permutation(n)[:hub_degree]] = 1.0
    for u in range(n - dangling, n):
        adj[u, :] = 0.0
    adj = adj.tocsr()
    adj.eliminate_zeros()
    adj.data[:] = 1.0
    return adj


@settings(max_examples=25, deadline=None)
@given(n=st.integers(6, 60), seed=st.integers(0, 10_000),
       rmax=st.sampled_from([0.0, 1e-3, 3e-2]),
       dangling=st.integers(1, 3), block=st.integers(1, 6))
def test_distinct_targets_within_the_slots(n, seed, rmax, dangling, block):
    """Each hop's next frontier has at most ``fr.exp[b]`` entries for
    source b, and each source's distinct reserves are at most its log's
    entries: the kernels' output regions are those sizes."""
    adj = _hub_graph(n, n // 2, dangling, seed)
    g = BucketPushGraph(adj.indptr, adj.indices, rmax, device="cpu")
    rs = np.random.RandomState(seed)
    src = torch.as_tensor(rs.randint(0, n, block).astype(np.int32))
    coef = build_coef("ppr", 5, 0.2)
    fr = initial_frontier(g, src)
    logs = [(fr, float(coef[0]))]
    for c in coef[1:]:
        nxt = push_hop_plain(g, fr, src)
        assert bool((nxt.cnt <= fr.exp).all()), (nxt.cnt, fr.exp)
        fr = nxt
        logs.append((fr, float(c)))
    row_off, _, sums = reserve_table_plain(g, logs)
    entries = sum(f.cnt for f, _ in logs)
    assert bool((row_off[1:] - row_off[:-1] <= entries).all())
    assert bool((sums > 0).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_table_layout(seed):
    """Global regions are disjoint; a source over 3/4 of the shared table
    gets one that holds its table (the smallest power of two >= twice its
    inserts), a source that fits gets none; every output region holds its
    inserts; the totals are the host's one read."""
    smem_slots = SMEM_SLOTS
    rs = np.random.RandomState(seed)
    edge = 3 * smem_slots // 4
    n = np.concatenate([[0, 1, edge, edge + 1, 40 * smem_slots, 7, 0],
                        rs.randint(0, 2 * smem_slots, 50)])
    lay = table_layout(torch.as_tensor(n))
    g_off, out_off = lay.g_off.numpy(), lay.out_off.numpy()
    region, out = np.diff(g_off), np.diff(out_off)
    assert g_off[0] == 0 and out_off[0] == 0
    assert (region >= 0).all() and (out >= 0).all()    # disjoint, in order
    spills = 4 * n > 3 * smem_slots
    assert not region[~spills].any()
    table = 2 ** np.ceil(np.log2(2 * n[spills]))
    assert (table >= 2 * n[spills]).all() and (region[spills] >= table).all()
    assert (out == n).all()
    assert spills[:5].tolist() == [False, False, False, True, True]
    assert (lay.slots, lay.spill, lay.global_sources) == (
        int(n.sum()), int(region.sum()), int(spills.sum()))



def test_node_records():
    """The packed record equals (indptr[u], deg(u), thr[u]) for every u."""
    adj = _hub_graph(300, 200, 3, 1)
    g = BucketPushGraph(adj.indptr, adj.indices, 1e-4, device="cpu")
    rec = g.rec
    assert rec.dtype == torch.int64 and rec.shape == (300, 2)
    words = rec.view(torch.int32)                 # little-endian halves
    np.testing.assert_array_equal(words[:, 0].numpy(), adj.indptr[:-1])
    np.testing.assert_array_equal(words[:, 1].numpy(), np.diff(adj.indptr))
    assert torch.equal(rec[:, 1], g.thr)
    assert torch.equal(node_records(g.indptr, g.thr), rec)
    assert int(g.thr.max()) <= 3 * ONE // 2


@pytest.mark.parametrize("rmax", [0.0, 1e-4])
def test_plain_push_on_a_hub_row_matches_grandtpu(rmax):
    """A hub row of 300 neighbours in a 400-node graph, pushed from the
    hub's in-neighbours (the sources whose tables the hub fills): the
    plain P2 against grandtpu's bucketed push and the oracle."""
    base, _, _ = synthetic_graph(num_nodes=400, num_classes=4,
                                 num_features=8, seed=11)
    rs = np.random.RandomState(11)
    hub = 7
    adj = (base + sp.eye(400, format="csr")).tolil()
    adj[hub, rs.permutation(400)[:300]] = 1.0
    adj = adj.tocsr()
    adj.data[:] = 1.0
    sources = np.flatnonzero(np.asarray(adj[:, hub].todense()).ravel())
    assert sources.size >= 4 and np.diff(adj.indptr)[hub] >= 300
    coef = build_coef("ppr", order=6, alpha=0.2)
    k = 32
    got = gfpush_bucketed(adj.indptr, adj.indices, sources, coef, rmax, k,
                          block=4, device="cpu")
    atol = max(1e-5, 2 * rmax)
    _assert_row_parity(*gfpush_numpy(adj.indptr, adj.indices, sources, coef,
                                     rmax, k), *got, atol=atol, tie_tol=atol)
    _assert_row_parity(*jax_bucketed(adj.indptr, adj.indices, sources, coef,
                                     rmax, k, block=16), *got, atol=atol,
                       tie_tol=atol)
