"""The counts on the port's hop span (``infer.propagate.hop``): the
operator's nonzeros, the rows, chunks and nonzeros that K2's hub-row split
carries, and the bytes a hop gathers, computed on the host when the
operator is built; and ``predict.hop_gather_gbps``, the benchmark's reader
of them."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from grandtpu_torch import observe
from grandtpu_torch.infer import Propagator
from grandtpu_torch.sparse.spmm import (CSROperator, SplitPlan,
                                        default_split_cap)

HUBS = {7: 1500, 11: 900, 1999: 700}


def _adj(n=2000, hubs=HUBS, seed=0):
    """A self-looped 0/1 adjacency with mean degree ≈ 7 and the hub rows
    ``hubs`` (row: nonzeros)."""
    rs = np.random.RandomState(seed)
    adj = sp.random(n, n, density=6.0 / n, random_state=rs, format="lil")
    adj.setdiag(1.0)
    for row, deg in hubs.items():
        adj[row, rs.permutation(n)[:deg]] = 1.0
    adj = adj.tocsr()
    adj.data[:] = 1.0
    return adj


def _hop_records(prop, x, **kw):
    observe.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = prop(x, **kw)
    recs = [r for r in observe.spans() if r["name"] == "infer.propagate.hop"]
    observe.clear()
    return out, recs


@pytest.mark.parametrize("dtype,precision,item", [
    (torch.float32, "f32", 4), (torch.bfloat16, "bf16", 2),
    (torch.float32, "bf16", 4), (torch.float32, "int8", 1)],
    ids=["f32", "bf16_carry", "bf16_terms", "int8"])
def test_hop_span_counts_the_split(dtype, precision, item):
    adj = _adj()
    prop = Propagator(adj, backend="csr", dtype=dtype, device="cpu")
    op = prop.adj_op
    deg = np.diff(adj.indptr)
    cap = default_split_cap(adj.shape[0], adj.nnz)
    split = np.flatnonzero(deg > cap)
    assert split.tolist() == sorted(HUBS)
    x = torch.randn(adj.shape[0], 13)
    _, recs = _hop_records(prop, x, order=3, precision=precision)
    assert len(recs) == 3
    want = {"nnz": adj.nnz, "split_rows": op.plan.rows.numel(),
            "split_chunks": op.plan.num_chunks,
            "split_nnz": int(deg[split].sum()),
            "gather_bytes": adj.nnz * 13 * item}
    assert want["split_rows"] == 3
    assert want["split_chunks"] == sum(-(-deg[r] // cap) for r in split)
    for r in recs:
        assert r["counts"] == want


def test_flat_operator_counts_no_split():
    adj = _adj(hubs={})
    prop = Propagator(adj, backend="csr", device="cpu")
    assert prop.adj_op.plan is None
    _, recs = _hop_records(prop, torch.randn(adj.shape[0], 4), order=2)
    assert [r["counts"] for r in recs] == [
        {"nnz": adj.nnz, "split_rows": 0, "split_chunks": 0, "split_nnz": 0,
         "gather_bytes": adj.nnz * 4 * 4}] * 2


def test_counts_are_the_plans():
    adj = _adj()
    for cap in (100, 700, int(np.diff(adj.indptr).max())):
        op = CSROperator.from_scipy(adj, "cpu", split_cap=cap)
        plan = SplitPlan.build(adj.indptr, cap, "cpu")
        deg = np.diff(adj.indptr)
        assert op.counts == {
            "nnz": adj.nnz, "split_rows": int((deg > cap).sum()),
            "split_chunks": 0 if plan is None else plan.num_chunks,
            "split_nnz": int(deg[deg > cap].sum())}
    assert op.plan is None and op.counts["split_rows"] == 0


def test_untraced_hops_record_nothing_and_read_the_same():
    adj = _adj()
    prop = Propagator(adj, backend="csr", device="cpu")
    x = torch.randn(adj.shape[0], 6)
    observe.clear()
    off = prop(x, order=2)
    assert observe.spans() == []
    on, recs = _hop_records(prop, x, order=2)
    assert len(recs) == 2 and torch.equal(on, off)


def test_other_backends_carry_no_counts():
    adj = _adj(n=600, hubs={})
    for backend in ("dense", "segment"):
        prop = Propagator(adj, backend=backend, device="cpu")
        _, recs = _hop_records(prop, torch.randn(600, 3), order=1)
        assert [r["counts"] for r in recs] == [{}]


def _rec(device_ms, **counts):
    return {"name": "infer.propagate.hop", "id": 0, "parent": None,
            "root": 0, "host_ms": 1.0, "device_ms": device_ms,
            "counts": counts}


def test_hop_gather_gbps_reads_nothing_without_counters(monkeypatch):
    """The reader on hops that carry no counters, as a program without
    them records (its readings with them: ``test_torch_observe.py``)."""
    from benchmark import harness

    read = harness.reader("predict.hop_gather_gbps")
    monkeypatch.setattr(observe, "spans", lambda: [_rec(20.0), _rec(25.0)])
    assert read({"window": object(), "spans_ms": {}}) is None
    monkeypatch.setattr(observe, "spans",
                        lambda: [_rec(20.0, gather_bytes=10 ** 9)])
    assert read({"window": object(), "spans_ms": {}}) == pytest.approx(50.0)
