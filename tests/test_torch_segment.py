"""The port's segment backend (K2-seg) against grandtpu's: the padded COO
layout element for element, ``spmm_segment`` on graphs with empty rows and
a hub row, ``Propagator``/``exact_propagate(backend="segment")`` in every
mode, and grandtpu's precision rules for a non-block backend. The port
runs K2-seg's plain version on the CPU.

Tolerance: max |port - jax| / max |jax| <= 1e-5 (f32 sums in another
order: grandtpu scatter-adds in XLA's order, the port in edge order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.infer import Propagator as JaxPropagator
from grandtpu.infer import exact_propagate as jax_exact_propagate
from grandtpu.sparse.spmm import PaddedCSR as JaxPaddedCSR
from grandtpu.sparse.spmm import spmm_segment as jax_spmm_segment

from grandtpu_torch.data import load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.infer import Propagator, exact_propagate
from grandtpu_torch.sparse import CSROperator, PaddedCSR, spmm_prop_step
from grandtpu_torch.sparse.spmm import spmm_segment, spmm_segment_plain

TOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def skewed(n=300, seed=0, hub_degree=250):
    """A random graph with empty rows and one hub row."""
    rs = np.random.RandomState(seed)
    a = sp.random(n, n, density=0.03, random_state=rs, format="lil")
    a[5, rs.choice(n, hub_degree, replace=False)] = rs.rand(hub_degree) + 0.1
    for r in (0, 7, 100, n - 1):
        a[r, :] = 0
    a = a.tocsr()
    a.data = (np.abs(a.data) + 0.1).astype(np.float32)
    return a


@pytest.fixture(scope="module")
def graph():
    data = load_data("synth:400:4:16", split_seed=0)
    adj = add_self_loops_adj(data.adj).tolil()
    adj[3, :] = 1.0                          # a hub row: 400 nonzeros
    return adj.tocsr(), np.asarray(data.features, np.float32)


@pytest.mark.parametrize("chunk", [1 << 18, 256, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_padded_csr_matches_grandtpu(seed, chunk):
    a = skewed(seed=seed)
    want = JaxPaddedCSR.from_scipy(a, chunk=chunk)
    got = PaddedCSR.from_scipy(a, chunk=chunk, device="cpu")
    assert (got.num_nodes, got.chunk) == (want.num_nodes, want.chunk)
    for name in ("rows", "cols", "vals"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("seed,nfeat", [(0, 16), (1, 5), (2, 64)])
def test_spmm_segment_matches_grandtpu(seed, nfeat):
    a = skewed(seed=seed)
    x = np.random.RandomState(seed).randn(a.shape[0], nfeat).astype(
        np.float32)
    want = np.asarray(jax_spmm_segment(JaxPaddedCSR.from_scipy(a),
                                       jnp.asarray(x)))
    padded = PaddedCSR.from_scipy(a, device="cpu")
    got = spmm_segment(padded, torch.as_tensor(x))
    assert got.shape == want.shape
    assert rel(got, want) <= TOL
    # the given output buffer is zeroed first and its last row discarded
    out = torch.full((a.shape[0] + 1, nfeat), 7.0)
    again = spmm_segment(padded, torch.as_tensor(x), out=out)
    assert torch.equal(again, got) and again.data_ptr() == out.data_ptr()
    assert float(out[-1].abs().max()) == 0.0


def test_segment_rectangular_matches_scipy():
    """A shard's rows over more input rows than it has (num_cols)."""
    rs = np.random.RandomState(3)
    a = sp.random(40, 100, density=0.1, random_state=rs, format="csr",
                  dtype=np.float32)
    x = rs.randn(100, 8).astype(np.float32)
    got = spmm_segment(PaddedCSR.from_scipy(a, device="cpu"),
                       torch.as_tensor(x))
    assert rel(got, a @ x) <= TOL
    y = torch.empty(40, 8)
    spmm_prop_step(CSROperator.from_scipy(a, "cpu"), torch.as_tensor(x), y,
                   None, 1.0, False)
    assert rel(y, a @ x) <= TOL


def test_padded_csr_rejects_unsorted_rows():
    padded = PaddedCSR.from_scipy(skewed(), device="cpu")
    rows = padded.rows.clone()
    i = int(torch.nonzero(rows[1:] > rows[:-1])[0, 0])
    rows[[i, i + 1]] = rows[[i + 1, i]]
    with pytest.raises(ValueError, match="sorted"):
        PaddedCSR(rows, padded.cols, padded.vals, padded.num_nodes,
                  padded.chunk)
    with pytest.raises(ValueError, match="cols"):
        PaddedCSR(padded.rows, padded.cols + padded.num_nodes, padded.vals,
                  padded.num_nodes, padded.chunk)


def test_segment_plain_adds_in_edge_order():
    """Each row's terms in edge order: a row's sum equals the sequential
    f32 sum of its terms exactly."""
    a = skewed(seed=4)
    x = np.random.RandomState(4).randn(a.shape[0], 3).astype(np.float32)
    got = spmm_segment_plain(PaddedCSR.from_scipy(a, device="cpu"),
                             torch.as_tensor(x)).numpy()
    r = 5
    s = np.zeros(3, np.float32)
    for e in range(a.indptr[r], a.indptr[r + 1]):
        s = s + x[a.indices[e]] * np.float32(a.data[e])
    assert np.array_equal(got[r], s)


@pytest.mark.parametrize("mode", ["ppr", "avg", "single"])
def test_segment_propagate_matches_grandtpu(graph, mode):
    adj, feats = graph
    kw = dict(mode=mode, order=4, alpha=0.3)
    want = np.asarray(jax_exact_propagate(adj, feats, backend="segment",
                                          **kw))
    got = exact_propagate(adj, feats, backend="segment", device="cpu", **kw)
    assert rel(got, want) <= TOL
    prop = Propagator(adj, backend="segment", device="cpu")
    again = prop(feats, **kw)
    assert rel(again, want) <= TOL
    assert prop.last_precision == "f32"
    # and the csr backend's f32 run
    csr = exact_propagate(adj, feats, backend="csr", device="cpu", **kw)
    assert rel(got, csr) <= TOL


@pytest.mark.parametrize("precision", ["auto", "bf16", "int8", "f32"])
def test_segment_runs_f32_at_any_precision(graph, precision):
    """grandtpu's rules for a non-block backend: 'auto' is f32, and 'bf16'
    and 'int8' run the same f32 segment hop."""
    adj, feats = graph
    kw = dict(mode="ppr", order=3, alpha=0.2, backend="segment")
    want = np.asarray(jax_exact_propagate(adj, feats, precision=precision,
                                          **kw))
    f32 = np.asarray(jax_exact_propagate(adj, feats, **kw))
    assert np.array_equal(want, f32)
    got = exact_propagate(adj, feats, precision=precision, device="cpu", **kw)
    assert torch.equal(got, exact_propagate(adj, feats, device="cpu", **kw))
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("precision", ["int8mxu", "int8cast"])
def test_segment_rejects_block_only_precisions(graph, precision):
    adj, feats = graph
    with pytest.raises(ValueError, match="block"):
        JaxPropagator(adj, backend="segment")(feats, precision=precision)
    with pytest.raises(ValueError, match="block"):
        Propagator(adj, backend="segment", device="cpu")(
            feats, precision=precision)


def test_segment_calibrate_returns_f32(graph):
    adj, feats = graph
    assert JaxPropagator(adj, backend="segment").calibrate(feats) == "f32"
    prop = Propagator(adj, backend="segment", device="cpu")
    assert prop.calibrate(feats) == "f32"
    out = prop(feats, precision="auto", order=2)
    assert prop.last_precision == "f32" and out.dtype == torch.float32


def test_segment_bf16_carry_decision(graph):
    """grandtpu's segment backend takes bf16 carries (its scatter then adds
    in bf16); the port raises, naming the ROADMAP item, rather than add in
    another order or precision."""
    adj, feats = graph
    out = jax_exact_propagate(adj, feats, backend="segment", order=2,
                              precision="bf16_carry")
    assert out.dtype == jnp.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        exact_propagate(adj, feats, backend="segment", order=2,
                        precision="bf16_carry", device="cpu")
