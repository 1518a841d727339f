"""The port's fast-precision propagation against grandtpu's: K2-bf16, the
int8 quantize, K2-q8 and K2-q8mxu (plain versions on the CPU), the
bf16 carries, the 'auto' policy with its calibration, and ``train()``
with ``predict_precision`` for both engines. grandtpu runs its SplitCSR
'block' backend, as its own tests do on the CPU.

Tolerances, max |port - jax| / max |jax| unless stated:
- one hop: int8 forms <= 1e-6 (the same q, an exact int32 sum or the same
  bf16 terms, then the same f32 products), bf16 terms and int8cast
  <= 1e-5 (f32 sums in another order), bf16 carries within one bf16 ulp
  of each element and at most 1e-3 of the elements different (another
  f32 sum order can flip a bf16 rounding now and then);
- whole runs of 5 hops: <= 5e-3 for the fast forms (the repo's fast-path
  gate) and <= 1e-2 for bf16 carries, because a flip at one hop carries
  into the next quantize or rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.config import GrandConfig as JaxConfig
from grandtpu.infer import Propagator as JaxPropagator
from grandtpu.infer import choose_fast_precision as jax_choose
from grandtpu.infer import exact_propagate as jax_exact_propagate
from grandtpu.infer.propagate import INT8_MAX_HUB_DEGREE as JAX_HUB
from grandtpu.infer.propagate import INT8_MAX_WORKING_SET_BYTES as JAX_WS
from grandtpu.nn import mag_mlp as jmag
from grandtpu.nn import mlp as jmlp
from grandtpu.sparse.spmm import quantize_columns as jax_quantize
from grandtpu.sparse.spmm import row_values_if_constant as jax_row_values
from grandtpu.train import train as jax_train

from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import mag_from_jax, mlp_from_jax
from grandtpu_torch.data import load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.infer import (Propagator, choose_fast_precision,
                                  exact_propagate, predict_logits_sparse)
from grandtpu_torch.infer import propagate as tprop
from grandtpu_torch.nn.sparse_input import PaddedFeatures
from grandtpu_torch.sparse import (CSROperator, quantize_columns,
                                   row_values_if_constant, spmm_prop_step_q8,
                                   spmm_prop_step_q8mxu)
from grandtpu_torch.train import trainer as ttrainer
from grandtpu_torch.train import trainer_sparse as ttsparse

FAST = ("bf16", "int8", "int8mxu", "int8cast")
# precision -> (grandtpu's precision, carries' dtype)
FORMS = {p: (p, "f32") for p in FAST} | {"bf16_carry": ("bf16", "bf16")}
HOP_TOL = {"bf16": 1e-5, "int8": 1e-6, "int8mxu": 1e-6, "int8cast": 1e-5}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def within_one_bf16_ulp(got, want, max_share=1e-3):
    """Each element of ``got`` within one bf16 ulp of ``want``'s, and at
    most ``max_share`` of them different at all. Another f32 sum order
    flips a rounding only now and then, while a rounding done the wrong
    way (an unrounded scale, say) moves a large share of the elements."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return bool(np.all(np.abs(got - want) <= ulp)
                and np.mean(got != want) <= max_share)


def _hub_graph():
    """A sparse random graph plus one hub joined to most nodes, self-looped
    (as ``tests/test_torch_infer.py``)."""
    rs = np.random.RandomState(11)
    n = 300
    adj = sp.random(n, n, density=0.01, random_state=rs, format="csr")
    adj.data[:] = 1.0
    hub = sp.csr_matrix((np.ones(250), (np.zeros(250, int),
                                        np.arange(1, 251))), shape=(n, n))
    adj = ((adj + adj.T + hub + hub.T) > 0).astype(np.float32)
    adj = (adj + sp.eye(n, format="csr")).tocsr()
    return adj, rs.randn(n, 24).astype(np.float32)


@pytest.fixture(params=["small", "hub"])
def graph(request, small_graph):
    if request.param == "small":
        adj, feats, _ = small_graph
        return adj, np.asarray(feats, np.float32)
    return _hub_graph()


def _pair(adj, form):
    """grandtpu's and the port's Propagator for ``form`` on the CSR path."""
    precision, carry = FORMS[form]
    jprop = JaxPropagator(adj, backend="block", dtype=(
        jnp.bfloat16 if carry == "bf16" else jnp.float32))
    tprop_ = Propagator(adj, backend="csr", device="cpu", dtype=(
        torch.bfloat16 if carry == "bf16" else torch.float32))
    return precision, jprop, tprop_


@pytest.mark.parametrize("mode", ["single", "ppr"])
@pytest.mark.parametrize("form", list(FORMS))
def test_one_hop_matches_grandtpu(graph, form, mode):
    adj, feats = graph
    precision, jprop, port = _pair(adj, form)
    kw = dict(mode=mode, order=1, alpha=0.2, precision=precision)
    assert (port.row_val is None) == (jprop.row_val is None)
    if form == "int8mxu" and jprop.row_val is None:
        # the hub graph's doubled diagonal makes its rows non-constant
        with pytest.raises(ValueError, match="row-constant"):
            jprop(feats, **kw)
        with pytest.raises(ValueError, match="row-constant"):
            port(feats, **kw)
        return
    want = np.asarray(jprop(feats, **kw)).astype(np.float32)
    got = port(feats, **kw)
    assert got.dtype == (torch.bfloat16 if form == "bf16_carry"
                         else torch.float32)
    got = got.float().numpy()
    if form == "bf16_carry":
        assert within_one_bf16_ulp(got, want)
    else:
        assert rel(got, want) <= HOP_TOL[form]


@pytest.mark.parametrize("mode", ["ppr", "avg", "single"])
@pytest.mark.parametrize("form", list(FORMS))
def test_whole_propagation_matches_grandtpu(small_graph, form, mode):
    """5 hops against grandtpu, and against f32: under grandtpu's gates in
    ppr (5e-3 fast, 2e-2 bf16 carries, ``tests/test_auto_precision.py``),
    and in every mode no further from f32 than grandtpu's own run is
    (plus 1e-3: int8 in 'single' mode, without the ppr sum's damping, is
    1e-2 from f32 in both packages)."""
    adj, feats, _ = small_graph
    feats = np.asarray(feats, np.float32)
    kw = dict(mode=mode, order=5, alpha=0.15)
    want = np.asarray(jax_exact_propagate(adj, feats, backend="block",
                                          precision=form, **kw))
    want = want.astype(np.float32)
    jax_f32 = np.asarray(jax_exact_propagate(adj, feats, backend="block",
                                             **kw))
    got = exact_propagate(adj, feats, backend="csr", precision=form,
                          device="cpu", **kw).float().numpy()
    f32 = exact_propagate(adj, feats, backend="csr", device="cpu",
                          **kw).numpy()
    carry = form == "bf16_carry"
    assert rel(got, want) <= (1e-2 if carry else 5e-3)
    assert rel(got, f32) <= rel(want, jax_f32) + 1e-3
    if mode == "ppr":
        assert rel(got, f32) < (2e-2 if carry else 5e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_columns_bit_for_bit(dtype):
    rs = np.random.RandomState(5)
    x = rs.randn(200, 9).astype(np.float32) * rs.rand(9).astype(np.float32)
    x[:, 3] = 0.0                                  # an all-zero column
    # amax 127 gives scale 1: exact .5 ties, rounded half to even
    x[:8, 5] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    x[:, 6] *= 1e-30                               # a tiny column
    x[0, 7] = -50.0                                # the max is negative
    if dtype == "bf16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.tensor(x)
    qj, sj = jax_quantize(xj)
    qt, st = quantize_columns(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[3] == 1.0 and not qt[:, 3].any()
    np.testing.assert_array_equal(qt[:8, 5].numpy(),
                                  [127, 0, 2, 2, 0, -2, 126, -4])


def test_row_values_if_constant_matches_grandtpu(small_graph):
    adj, _, _ = small_graph
    deg = np.asarray(adj.sum(1)).ravel()
    a_norm = sp.diags(1.0 / deg).dot(adj).tocsr()
    np.testing.assert_array_equal(row_values_if_constant(a_norm),
                                  jax_row_values(a_norm))
    varied = a_norm.copy()
    varied.data = varied.data * np.linspace(1, 2, varied.nnz)
    assert row_values_if_constant(varied) is None
    assert jax_row_values(varied) is None
    empty = sp.csr_matrix((3, 3), dtype=np.float32)
    np.testing.assert_array_equal(row_values_if_constant(empty),
                                  np.zeros(3, np.float32))


def test_q8_hops_on_a_general_operator_match_grandtpu_math():
    """The two int8 hops' plain versions on one quantized input: q8 reads
    the edge values (rounded to bf16), q8mxu takes row values instead."""
    rs = np.random.RandomState(2)
    adj = sp.random(50, 50, density=0.1, random_state=rs, format="csr")
    adj.data = adj.data.astype(np.float32)
    x = torch.tensor(rs.randn(50, 7).astype(np.float32))
    q, scale = quantize_columns(x)
    op = CSROperator.from_scipy(adj, "cpu")
    y = torch.empty(50, 7)
    spmm_prop_step_q8(op, q, scale, y, None, 1.0, False)
    vb = adj.copy()
    vb.data = np.asarray(jnp.asarray(vb.data, jnp.bfloat16), np.float32)
    want = np.zeros((50, 7), np.float32)
    rows = np.repeat(np.arange(50), np.diff(adj.indptr))
    terms = (q.numpy()[adj.indices].astype(np.float32)
             * vb.data[:, None]).astype(ml_dtypes.bfloat16)
    np.add.at(want, rows, terms.astype(np.float32))
    assert rel(y.numpy(), want * scale.numpy()) <= 1e-6
    ones = adj.copy()
    ones.data[:] = 1.0
    rv = torch.tensor(rs.rand(50).astype(np.float32))
    spmm_prop_step_q8mxu(CSROperator.from_scipy(ones, "cpu"), q, scale, rv,
                         y, None, 1.0, False)
    isum = (ones @ q.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(
        y.numpy(), isum * rv.numpy()[:, None] * scale.numpy(), rtol=1e-6)


def _amax_operator(rows_constant):
    """400 rows of 0 to 6 nonzeros and row 9 with 300 (above a cap of
    64): the values varied, or 1 / the row's nonzeros (K2-q8mxu's form)."""
    rs = np.random.RandomState(8)
    n = 400
    deg = np.arange(n) % 7
    deg[9] = 300
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([rs.choice(n, d, replace=False) for d in deg])
    vals = (np.repeat(1.0 / np.maximum(deg, 1), deg) if rows_constant
            else rs.uniform(0.1, 1.0, rows.size))
    return sp.csr_matrix((vals.astype(np.float32), (rows, cols)),
                         shape=(n, n))


@pytest.mark.parametrize("kernel", ["q8", "q8mxu"])
@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [False, True])
def test_hop_amax_out_equals_column_absmax(kernel, carry, split):
    """The maxima an int8 hop raises are ``column_absmax`` of the y it
    stored, bit for bit, split or not, and the hop's carries are those of
    the hop without them; a buffer above them keeps its values."""
    from grandtpu_torch.sparse.spmm import column_absmax_plain
    adj = _amax_operator(kernel == "q8mxu")
    op = CSROperator.from_scipy(adj, "cpu",
                                split_cap=64 if split else adj.nnz)
    assert (op.plan is not None) == split
    rs = np.random.RandomState(12)
    x = torch.tensor(rs.randn(400, 21).astype(np.float32))
    q, scale = quantize_columns(x)
    acc0 = torch.tensor(rs.randn(400, 21).astype(np.float32)).to(carry)
    row_val = torch.tensor(row_values_if_constant(adj)) if (
        kernel == "q8mxu") else None

    def hop(amax_out):
        y, acc = torch.empty_like(acc0), acc0.clone()
        if row_val is None:
            spmm_prop_step_q8(op, q, scale, y, acc, 0.8, True, amax_out)
        else:
            spmm_prop_step_q8mxu(op, q, scale, row_val, y, acc, 0.8, True,
                                 amax_out)
        return y, acc

    amax = torch.zeros(21)
    got, plain = hop(amax), hop(None)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert torch.equal(amax, column_absmax_plain(got[0]))
    assert amax.view(torch.int32).equal(
        column_absmax_plain(got[0]).view(torch.int32))
    high = torch.full((21,), 1e30)
    hop(high)
    assert torch.equal(high, torch.full((21,), 1e30))


@pytest.mark.parametrize("precision", ["int8mxu", "int8cast"])
@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["ppr", "single"])
def test_int8_run_reusing_maxima_equals_requantizing(small_graph, precision,
                                                     carry, mode):
    """A whole int8 run, whose later hops quantize on the maxima the hop
    before raised, equals the same run quantizing every hop in full bit
    for bit, and grandtpu's int8 run within the whole-run limit 1e-3."""
    adj, feats, _ = small_graph
    feats = np.asarray(feats, np.float32)
    alpha, order = 0.15, 5
    port = Propagator(adj, backend="csr", device="cpu", dtype=carry)
    got = port(feats, mode=mode, order=order, alpha=alpha,
               precision=precision)
    x = torch.as_tensor(feats).to(carry)
    rnd = tprop.bf16_round if carry == torch.bfloat16 else float
    if mode == "ppr":
        cur = x * rnd(alpha)
        acc, scale = cur.clone(), 1.0 - alpha
    else:
        cur, acc, scale = x.clone(), None, 1.0
    out = torch.empty_like(cur)
    for _ in range(order):
        q, s = quantize_columns(cur)
        if precision == "int8mxu":
            spmm_prop_step_q8mxu(port.adj_op, q, s, port.row_val, out, acc,
                                 scale, mode == "ppr")
        else:
            spmm_prop_step_q8(port.adj_op, q, s, out, acc, scale,
                              mode == "ppr")
        cur, out = out, cur
    assert torch.equal(got, acc if mode == "ppr" else cur)
    if carry == torch.float32:
        want = np.asarray(jax_exact_propagate(
            adj, feats, backend="block", mode=mode, order=order,
            alpha=alpha, precision=precision))
        assert rel(got, want) <= 1e-3


@pytest.mark.parametrize("rows,nfeat,max_degree", [
    (300_000, 128, None), (5_000_000, 128, None),
    (JAX_WS // 512, 128, None), (JAX_WS // 512 + 1, 128, None),
    (300_000, 128, 100), (300_000, 128, JAX_HUB), (300_000, 128, 15_000),
    (2_000_000, 100, 16), (2_000_000, 100, None), (2_700_000, 100, 16),
])
def test_choose_fast_precision_matches_grandtpu(rows, nfeat, max_degree):
    """The heuristic crossover and the skew guard, case by case."""
    assert tprop.INT8_MAX_WORKING_SET_BYTES == JAX_WS
    assert tprop.INT8_MAX_HUB_DEGREE == JAX_HUB
    assert (choose_fast_precision(rows, nfeat, max_degree=max_degree)
            == jax_choose(rows, nfeat, max_degree=max_degree))


def _skew_graph():
    """The mini skew-probe graph of ``tests/test_auto_precision.py``: a
    uniform base graph plus two hub rows of 9000 nonzeros."""
    from grandtpu.data import synthetic_graph
    n, hub_deg = 10_000, 9_000
    adj, feats, _ = synthetic_graph(num_nodes=n, num_classes=4,
                                    num_features=64, avg_degree=4, seed=11)
    rs = np.random.RandomState(7)
    hub_rows = np.repeat(rs.choice(n, 2, replace=False), hub_deg)
    hub_cols = np.concatenate([rs.permutation(n)[:hub_deg]
                               for _ in range(2)])
    hubs = sp.coo_matrix((np.ones(hub_rows.size, np.float32),
                          (hub_rows, hub_cols)), shape=adj.shape)
    adj = (adj + hubs.tocsr() + sp.eye(n, format="csr")).tocsr()
    adj.data[:] = 1.0
    return adj, np.asarray(feats, np.float32)


@pytest.mark.parametrize("case", [
    "heuristic_before_calibrate", "calibrate_caches", "gate_zero_is_f32",
    "dense_is_f32", "skew_guard_routes_to_bf16", "exact_propagate_auto",
    "bf16_carry_dtype"])
def test_auto_precision_mirrors_grandtpu(small_graph, case):
    """Mirrors of ``tests/test_auto_precision.py`` on the port, each held
    to what grandtpu does on the same input."""
    adj, feats, _ = small_graph
    feats = np.asarray(feats, np.float32)
    if case == "heuristic_before_calibrate":
        prop = Propagator(adj, backend="block", device="cpu")
        assert prop._auto_precision is None
        expect = choose_fast_precision(adj.shape[0], feats.shape[1])
        assert expect == jax_choose(adj.shape[0], feats.shape[1]) == "int8"
        auto = prop(feats, mode="avg", order=3, precision="auto")
        manual = prop(feats, mode="avg", order=3, precision=expect)
        np.testing.assert_array_equal(auto.numpy(), manual.numpy())
    elif case == "calibrate_caches":
        prop = Propagator(adj, backend="block", device="cpu")
        choice = prop.calibrate(feats, order=3, repeats=1)
        assert choice in ("bf16", "int8", "f32")
        assert prop._auto_precision == choice
        auto = prop(feats, mode="ppr", order=3, precision="auto")
        manual = prop(feats, mode="ppr", order=3, precision=choice)
        np.testing.assert_array_equal(auto.numpy(), manual.numpy())
    elif case == "gate_zero_is_f32":
        prop = Propagator(adj, backend="block", device="cpu")
        assert prop.calibrate(feats, order=3, repeats=1, gate=0.0) == "f32"
        assert prop._auto_precision == "f32"
        assert JaxPropagator(adj, backend="block").calibrate(
            feats, order=3, repeats=1, gate=0.0) == "f32"
    elif case == "dense_is_f32":
        prop = Propagator(adj, device="cpu")   # n = 120 -> dense
        assert prop.backend == "dense"
        assert prop.calibrate(feats) == "f32"
        out = prop(feats, mode="single", order=2, precision="auto")
        ref = prop(feats, mode="single", order=2)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6)
        with pytest.raises(ValueError, match="csr"):
            prop(feats, precision="int8mxu")
    elif case == "skew_guard_routes_to_bf16":
        adj, feats = _skew_graph()
        prop = Propagator(adj, backend="block", device="cpu")
        assert prop.max_degree >= 9_000
        ref = prop(feats, mode="ppr", order=4).numpy()
        auto = prop(feats, mode="ppr", order=4, precision="auto").numpy()
        bf16 = prop(feats, mode="ppr", order=4, precision="bf16").numpy()
        np.testing.assert_array_equal(auto, bf16)
        assert rel(auto, ref) < 5e-3
    elif case == "exact_propagate_auto":
        ref = exact_propagate(adj, feats, mode="ppr", order=4,
                              backend="block", device="cpu").numpy()
        out = exact_propagate(adj, feats, mode="ppr", order=4,
                              backend="block", precision="auto",
                              device="cpu").numpy()
        want = exact_propagate(adj, feats, mode="ppr", order=4,
                               backend="block", precision="int8",
                               device="cpu").numpy()
        np.testing.assert_array_equal(out, want)
        assert rel(out, ref) < 5e-3
    else:
        out = exact_propagate(adj, feats, mode="ppr", order=5,
                              backend="block", precision="bf16_carry",
                              device="cpu")
        assert out.dtype == torch.bfloat16
        ref = exact_propagate(adj, feats, mode="ppr", order=5,
                              backend="block", device="cpu").numpy()
        assert rel(out.float().numpy(), ref) < 2e-2
        with pytest.raises(ValueError, match="unknown precision"):
            Propagator(adj, backend="block", device="cpu")(
                feats, precision="bf16_carry")


def test_grandtpu_keywords_work_on_the_port(small_graph):
    """Code written against ``grandtpu.infer`` runs on the port: the same
    keywords (``dense_threshold``, ``backend="block"``, ``fast``,
    ``precision``, ``dtype`` given as JAX's own dtype, ``rows_per_block``)
    give the same result."""
    adj, feats, _ = small_graph
    feats = np.asarray(feats, np.float32)
    kw = dict(mode="ppr", order=4, alpha=0.1, dense_threshold=50,
              backend=None, fast=True)
    want = np.asarray(jax_exact_propagate(adj, feats, **kw))
    got = exact_propagate(adj, feats, device="cpu", **kw)
    assert rel(got.numpy(), want) <= 1e-5
    for dtype in (jnp.bfloat16, torch.bfloat16):
        jprop = JaxPropagator(adj, dense_threshold=50, backend="block",
                              dtype=jnp.bfloat16, rows_per_block=288)
        port = Propagator(adj, dense_threshold=50, backend="block",
                          dtype=dtype, rows_per_block=288, device="cpu")
        assert port.backend == "csr" and port.dtype == torch.bfloat16
        w = np.asarray(jprop(feats, mode="avg", order=3, precision="int8"))
        g = port(feats, mode="avg", order=3, precision="int8")
        assert within_one_bf16_ulp(g.float().numpy(), w.astype(np.float32))
    seg = dict(kw, backend="segment")
    want = np.asarray(jax_exact_propagate(adj, feats, **seg))
    assert rel(exact_propagate(adj, feats, device="cpu", **seg).numpy(),
               want) <= 1e-5
    # bf16 carries on the segment backend, given as JAX's dtype
    jseg = JaxPropagator(adj, backend="segment", dtype=jnp.bfloat16)
    port = Propagator(adj, backend="segment", dtype=jnp.bfloat16,
                      device="cpu")
    assert port.dtype == torch.bfloat16
    w = np.asarray(jseg(feats, mode="ppr", order=3, alpha=0.1))
    g = port(feats, mode="ppr", order=3, alpha=0.1)
    assert within_one_bf16_ulp(g.float().numpy(), w.astype(np.float32))
    with pytest.raises(TypeError, match="bfloat16"):
        Propagator(adj, dtype=np.float64, device="cpu")


@pytest.mark.parametrize("precision", ["bf16", "int8", "bf16_carry"])
def test_predict_logits_sparse_precision_matches_grandtpu(precision):
    from grandtpu.infer import classify as jclassify
    from grandtpu.nn.mlp import MLPConfig as JaxMLPConfig
    from grandtpu.nn.sparse_input import PaddedFeatures as JaxPadded

    from grandtpu_torch.nn.mlp import MLPConfig

    data = load_data("synth:300:3:40:sparse", split_seed=1)
    adj_sl = add_self_loops_adj(data.adj)
    padded = JaxPadded.from_csr(data.features)
    mkw = dict(num_features=40, num_classes=3, hidden=8, nlayers=2,
               use_bn=True, node_norm=True)
    params, state = jmag.init_mag_mlp(jax.random.PRNGKey(3),
                                      JaxMLPConfig(**mkw))
    kw = dict(mode="ppr", order=4, alpha=0.2, precision=precision)
    # dense_threshold is grandtpu's default, so a 300-node graph propagates
    # densely in both packages and the precision must not change a thing
    want = jclassify.predict_logits_sparse(
        params, state, JaxMLPConfig(**mkw), jnp.asarray(padded.attr_cols),
        jnp.asarray(padded.attr_vals), adj_sl, **kw)
    model = mag_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), MLPConfig(**mkw),
                         "cpu")
    ours = PaddedFeatures.from_csr(data.features)
    got = predict_logits_sparse(model, ours.attr_cols, ours.attr_vals,
                                adj_sl, **kw)
    assert got.shape == want.shape == (300, 3)
    assert rel(got, want) <= (2e-2 if precision == "bf16_carry" else 1e-5)


def _train_cfg(cls, dataset, precision):
    return cls(dataset=dataset, epochs=2, eval_batch=2, patience=100,
               stop_mode="acc", input_droprate=0.0, hidden_droprate=0.0,
               dropnode_rate=0.0, use_bn=True, node_norm=True, loss="kl",
               clip_norm=0.5, lr=0.01, unlabel_num=100, top_k=16, order=5,
               hidden=16, warmup=4.0, predict_precision=precision)


@pytest.mark.parametrize("precision", ["bf16", "int8", "auto", "bf16_carry"])
@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_train_with_predict_precision_matches_grandtpu(monkeypatch, engine,
                                                       precision):
    """train() of both packages above the dense threshold (20,100 nodes,
    so the precision applies), every drop rate 0, the port from grandtpu's
    init: eval histories within 1e-4, test accuracy within one node."""
    if engine == "dense":
        dataset = "synth:20100:4:16"

        def jax_init(mlp_cfg, seed, device):
            _, key = jax.random.split(jax.random.PRNGKey(seed))
            params, state = jmlp.init_mlp(
                key, jmlp.MLPConfig(**dataclasses.asdict(mlp_cfg)))
            return mlp_from_jax(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, state), mlp_cfg,
                                device)
        monkeypatch.setattr(ttrainer, "init_mlp", jax_init)
    else:
        dataset = "synth:20100:4:32:sparse"

        def jax_init(mlp_cfg, seed, device):
            _, key = jax.random.split(jax.random.PRNGKey(seed))
            params, state = jmag.init_mag_mlp(
                key, jmlp.MLPConfig(**dataclasses.asdict(mlp_cfg)))
            return mag_from_jax(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, state), mlp_cfg,
                                device)
        monkeypatch.setattr(ttsparse, "init_mag_mlp", jax_init)
    seen = {}
    real = tprop.exact_propagator

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)
    monkeypatch.setattr(ttrainer if engine == "dense" else ttsparse,
                        "exact_propagator", spy)
    want = jax_train(_train_cfg(JaxConfig, dataset, precision))
    got = ttrainer.train(_train_cfg(GrandConfig, dataset, precision),
                         device="cpu")
    assert seen["precision"] == precision
    # D^-1 A's rows are constant, so int8 (and auto's int8) is K2-q8mxu
    assert got.predict_precision == {"int8": "int8mxu", "auto": "int8mxu",
                                     "bf16_carry": "bf16"}.get(precision,
                                                               precision)
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        for k in ("val_loss", "val_acc", "loss"):
            assert abs(g[k] - w[k]) <= 1e-4, (k, g, w)
    n_test = 20100 - 4 * (20 + 30)
    assert abs(got.test_acc - want.test_acc) * n_test <= 1.0 + 1e-9
