"""The K2 split plan (hub rows cut into chunks) and the plain split hops
(K2, K2-bf16, K2-q8, K2-q8mxu), against grandtpu's SplitCSR hops.

The plan (``grandtpu_torch.sparse.spmm.SplitPlan``) must put every edge of
a split row in exactly one chunk of at most ``cap`` edges, in row order,
and be None when no row exceeds the cap. The plain hop follows the plan as
the kernel does (each chunk in edge order, then the chunks in order), so it
is held within 1e-6 of the unsplit plain hop (the same terms added in
another grouping) and within 1e-5 of grandtpu's ``spmm_split`` on
``SplitCSR.from_scipy`` (JAX on the CPU, f32 at HIGHEST precision, sums in
another order). The int8 split hops are held to grandtpu's
``spmm_split_q8``/``spmm_split_q8mxu`` on a SplitCSR with an overflow level
(1e-5 and 1e-6), and to the unsplit plain hop (K2-q8mxu bit for bit, its
chunk partials being int32). Tolerances are max |a - b| / max |b|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.sparse.spmm import SplitCSR
from grandtpu.sparse.spmm import quantize_columns as jax_quantize_columns
from grandtpu.sparse.spmm import \
    row_values_if_constant as jax_row_values_if_constant
from grandtpu.sparse.spmm import spmm_split, spmm_split_q8, spmm_split_q8mxu

from grandtpu_torch.sparse.spmm import (SPLIT_MIN_CAP, CSROperator,
                                        SplitPlan, default_split_cap,
                                        quantize_columns,
                                        row_values_if_constant,
                                        spmm_prop_step, spmm_prop_step_bf16,
                                        spmm_prop_step_plain,
                                        spmm_prop_step_q8,
                                        spmm_prop_step_q8_plain,
                                        spmm_prop_step_q8mxu,
                                        spmm_prop_step_q8mxu_plain)

SPLIT_TOL = 1e-6
JAX_TOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _hub_adj(n=2000, hubs=((7, 1500), (11, 900), (1999, 700)), seed=0):
    """A sparse random D^-1 (A + I) with a few hub rows (row, nonzeros) and
    an empty row 3 (no self-loop either)."""
    rs = np.random.RandomState(seed)
    adj = sp.random(n, n, density=6.0 / n, random_state=rs, format="lil")
    adj.setdiag(1.0)
    for row, deg in hubs:
        adj[row, rs.permutation(n)[:deg]] = 1.0
    adj[3, :] = 0.0
    adj = adj.tocsr()
    adj.data[:] = 1.0
    deg = np.maximum(np.asarray(adj.sum(1)).ravel(), 1e-12)
    return sp.diags(1.0 / deg).dot(adj).tocsr().astype(np.float32)


@pytest.mark.parametrize("cap", [1, 7, 64, 512])
def test_split_plan_covers_every_edge_once(cap):
    adj = _hub_adj()
    indptr = adj.indptr.astype(np.int64)
    plan = SplitPlan.build(indptr, cap, "cpu")
    deg = np.diff(indptr)
    rows = plan.rows.numpy()
    assert np.array_equal(rows, np.flatnonzero(deg > cap))
    ptr = plan.chunk_ptr.numpy()
    chunk_row, lo = plan.chunk_row.numpy(), plan.chunk_lo.numpy()
    assert ptr[0] == 0 and ptr[-1] == plan.num_chunks == lo.size
    assert np.all(np.diff(chunk_row) >= 0)           # chunks in row order
    hi = np.minimum(lo + cap, indptr[rows[chunk_row] + 1])
    assert np.all((hi - lo >= 1) & (hi - lo <= cap))
    covered = np.zeros(adj.nnz, np.int64)
    for i, r in enumerate(rows):
        assert np.array_equal(chunk_row[ptr[i]:ptr[i + 1]],
                              np.full(ptr[i + 1] - ptr[i], i))
        seg_lo, seg_hi = lo[ptr[i]:ptr[i + 1]], hi[ptr[i]:ptr[i + 1]]
        # in edge order, each chunk starting where the last one ended
        assert seg_lo[0] == indptr[r] and seg_hi[-1] == indptr[r + 1]
        assert np.array_equal(seg_lo[1:], seg_hi[:-1])
        for a, b in zip(seg_lo, seg_hi):
            covered[a:b] += 1
    split_edges = np.isin(np.repeat(np.arange(adj.shape[0]), deg), rows)
    assert np.all(covered[split_edges] == 1)
    assert np.all(covered[~split_edges] == 0)


def test_no_plan_when_no_row_exceeds_the_cap():
    adj = _hub_adj(hubs=())
    assert SplitPlan.build(adj.indptr, int(np.diff(adj.indptr).max()),
                           "cpu") is None
    op = CSROperator.from_scipy(adj, "cpu")
    assert op.split_cap == default_split_cap(adj.shape[0], adj.nnz)
    assert op.split_cap >= SPLIT_MIN_CAP and op.plan is None
    hub = CSROperator.from_scipy(_hub_adj(), "cpu")
    assert hub.plan.rows.tolist() == [7, 11, 1999]
    with pytest.raises(ValueError):
        SplitPlan.build(adj.indptr, 0, "cpu")


def _plain_hop(op, x, acc0, term, accumulate):
    y, acc = torch.empty_like(x), acc0.clone()
    spmm_prop_step_plain(op, x, y, acc, 0.8, accumulate, term)
    return y, acc


@pytest.mark.parametrize("term", ["f32", "bf16"])
@pytest.mark.parametrize("nfeat", [1, 33, 100])
@pytest.mark.parametrize("cap", [16, 300])
def test_plain_split_hop_matches_unsplit_and_grandtpu(term, nfeat, cap):
    adj = _hub_adj()
    n = adj.shape[0]
    rs = np.random.RandomState(nfeat)
    x_np = rs.randn(n, nfeat).astype(np.float32)
    x, acc0 = torch.tensor(x_np), torch.tensor(rs.randn(n, nfeat)
                                               .astype(np.float32))
    split = CSROperator.from_scipy(adj, "cpu", split_cap=cap)
    whole = CSROperator.from_scipy(adj, "cpu", split_cap=adj.nnz)
    assert split.plan is not None and whole.plan is None
    for accumulate in (True, False):
        got = _plain_hop(split, x, acc0, term, accumulate)
        want = _plain_hop(whole, x, acc0, term, accumulate)
        for g, w in zip(got, want):
            assert rel(g, w) <= SPLIT_TOL
        # the wrapper on CPU tensors is the plain version
        y, acc = torch.empty_like(x), acc0.clone()
        (spmm_prop_step if term == "f32" else spmm_prop_step_bf16)(
            split, x, y, acc, 0.8, accumulate)
        assert torch.equal(y, got[0]) and torch.equal(acc, got[1])
    assert float(got[0][3].abs().max()) == 0.0         # the empty row
    if term == "f32":
        scsr = SplitCSR.from_scipy(adj, rows_per_block=64, pad_multiple=64)
        assert scsr.levels                             # hubs spill there
        ref = 0.8 * np.asarray(spmm_split(scsr, jnp.asarray(x_np),
                                          fast=False))
        assert rel(got[0], ref) <= JAX_TOL


def _small_skew():
    """A few hundred nodes with a handful of hub rows: D^-1 (A + I), whose
    rows are constant (K2-q8mxu's operator)."""
    return _hub_adj(n=400, hubs=((5, 300), (17, 220), (230, 150),
                                 (399, 120)), seed=3)


def _int8_hop(op, kind, q, s, row_val, accumulate=False, scale=1.0,
              acc0=None):
    """One port int8 hop (the wrapper on CPU tensors: the plain version)
    at ``scale`` with or without accumulate; returns (cur_out, acc)."""
    out = torch.empty(q.shape, dtype=torch.float32)
    acc = None if acc0 is None else acc0.clone()
    if kind == "q8":
        spmm_prop_step_q8(op, q, s, out, acc, scale, accumulate)
    else:
        spmm_prop_step_q8mxu(op, q, s, row_val, out, acc, scale, accumulate)
    return out, acc


@pytest.mark.parametrize("kind", ["q8", "q8mxu"])
@pytest.mark.parametrize("nfeat", [1, 33, 128])
@pytest.mark.parametrize("cap", [16, 100])
def test_int8_split_hop_matches_grandtpu(kind, nfeat, cap):
    """The port's split K2-q8 / K2-q8mxu (plain, on the CPU) against
    grandtpu's spmm_split_q8 / spmm_split_q8mxu on a SplitCSR with an
    overflow level, at scale 1 with no accumulate, on the same x: the
    quantized input bit for bit first, then the hop within 1e-6 (q8mxu:
    the int32 sum is exact, only grandtpu's f32 rescale order differs) or
    1e-5 (q8: bf16 terms summed in f32 in another order).

    K2-q8 reads the edge values, and here they are powers of two: XLA's
    CPU backend drops the bf16 rounding of grandtpu's products q·bf16(v)
    inside the one-hot dot (on D^-1 (A + I)'s values its hop equals the
    unrounded sum to 3e-8 and is 1.7e-3 from the rounded one), while the
    port rounds each term as the TPU does. With v = 2^-k every product is
    exact in bf16, so both packages' terms agree and the test holds the
    split and the sums."""
    adj = _small_skew()
    if kind == "q8":
        adj = adj.copy()
        adj.data = (2.0 ** -np.random.RandomState(1).randint(
            0, 6, adj.nnz)).astype(np.float32)
    n = adj.shape[0]
    x_np = np.random.RandomState(nfeat + cap).randn(n, nfeat).astype(
        np.float32)
    op = CSROperator.from_scipy(adj, "cpu", split_cap=cap)
    assert op.plan is not None and op.plan.rows.numel() >= 4
    q, s = quantize_columns(torch.tensor(x_np))
    jq, js = jax_quantize_columns(jnp.asarray(x_np))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))

    scsr = SplitCSR.from_scipy(adj, rows_per_block=32, pad_multiple=32,
                               max_eb=96)
    assert scsr.levels                                # hubs spill there
    rv = jax_row_values_if_constant(adj)
    row_val = None if rv is None else torch.tensor(rv)
    if kind == "q8":
        want = np.asarray(spmm_split_q8(scsr, jnp.asarray(x_np)))
        limit = 1e-5
    else:
        rv_pad = np.zeros(scsr.num_blocks * scsr.rows_per_block, np.float32)
        rv_pad[:n] = rv
        want = np.asarray(spmm_split_q8mxu(scsr, jnp.asarray(x_np),
                                           jnp.asarray(rv_pad)))
        limit = 1e-6
    got, _ = _int8_hop(op, kind, q, s, row_val)
    assert got.shape == want.shape
    assert rel(got, want) <= limit, (rel(got, want), limit)


@pytest.mark.parametrize("kind", ["q8", "q8mxu"])
@pytest.mark.parametrize("nfeat", [1, 33, 128])
@pytest.mark.parametrize("accumulate", [True, False])
def test_int8_split_hop_matches_unsplit(kind, nfeat, accumulate):
    """The split plain hop against the unsplit one on the same q: K2-q8mxu
    bit for bit (int32 partials), K2-q8 within 1e-6 (the same f32 terms
    grouped by chunks). The wrapper on CPU tensors is the plain version."""
    adj = _small_skew()
    n = adj.shape[0]
    rs = np.random.RandomState(nfeat)
    q, s = quantize_columns(torch.tensor(rs.randn(n, nfeat)
                                         .astype(np.float32)))
    acc0 = torch.tensor(rs.randn(n, nfeat).astype(np.float32))
    row_val = torch.tensor(row_values_if_constant(adj))
    split = CSROperator.from_scipy(adj, "cpu", split_cap=24)
    whole = CSROperator.from_scipy(adj, "cpu", split_cap=adj.nnz)
    assert split.plan is not None and whole.plan is None
    kw = dict(accumulate=accumulate, scale=0.8, acc0=acc0)
    got = _int8_hop(split, kind, q, s, row_val, **kw)
    want = _int8_hop(whole, kind, q, s, row_val, **kw)
    for g, w in zip(got, want):
        if kind == "q8mxu":
            assert torch.equal(g, w)
        else:
            assert rel(g, w) <= SPLIT_TOL
    out_p = torch.empty_like(got[0])
    acc_p = acc0.clone()
    if kind == "q8":
        spmm_prop_step_q8_plain(split, q, s, out_p, acc_p, 0.8, accumulate)
    else:
        spmm_prop_step_q8mxu_plain(split, q, s, row_val, out_p, acc_p, 0.8,
                                   accumulate)
    assert torch.equal(out_p, got[0]) and torch.equal(acc_p, got[1])
    assert float(got[0][3].abs().max()) == 0.0         # the empty row
