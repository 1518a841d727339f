"""The segment backend with bf16 carries (K2-seg's bf16 form) against
grandtpu's: the bare product on bf16 input, the split hub-row plan, and
``exact_propagate(backend="segment", precision="bf16_carry")`` in every
mode. The port runs K2-seg's plain version on the CPU.

What grandtpu computes (checked here against a numpy model of it): its
scatter-add promotes the bf16 accumulator to f32 (jax's ``_scatter_impl``:
``promote_dtypes``, then one convert back), so each row is an f32 sum of
the f32 terms ``x[c] * v`` in edge order, rounded to bf16 once, and each
of its scan's 2^18-edge chunks rounds again (rows straddling a chunk
boundary; no graph here has one). The port adds in the same order, a split
hub row by chunks, then the chunks in order.

Tolerance: within one bf16 ulp elementwise, at most 1e-3 of the elements
different (a split row's f32 sum in another association), and within 2e-2
of the f32 result.
"""

import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.infer import exact_propagate as jax_exact_propagate
from grandtpu.sparse.spmm import PaddedCSR as JaxPaddedCSR
from grandtpu.sparse.spmm import spmm_segment as jax_spmm_segment

from grandtpu_torch.infer import Propagator, exact_propagate
from grandtpu_torch.sparse.spmm import (PaddedCSR, spmm_segment,
                                        spmm_segment_prop_step)

from test_torch_precision import within_one_bf16_ulp

BF16 = ml_dtypes.bfloat16


def _graph(n=3000, hub=0, seed=2):
    """A symmetric random graph, self-looped, with ``hub`` nonzeros in row 3
    (above the split cap of 512 when large)."""
    rs = np.random.RandomState(seed)
    a = sp.random(n, n, density=4.0 / n, random_state=rs, format="lil")
    if hub:
        a[3, rs.choice(n, hub, replace=False)] = 1.0
    a = a.tocsr()
    a = ((a + a.T) > 0).astype(np.float32) + sp.eye(n, dtype=np.float32)
    return a.tocsr(), rs.randn(n, 16).astype(np.float32)


@pytest.fixture(autouse=True)
def _quiet():
    # jax warns that the f32 terms are cast into the bf16 accumulator
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


@pytest.mark.parametrize("hub", [0, 2000])
def test_grandtpu_segment_rounds_each_row_once(hub):
    """What XLA's scatter rounds: grandtpu's bf16 product equals an f32
    sum of f32 terms in edge order rounded to bf16 once a row, and not a
    bf16 rounding after every add."""
    adj, x = _graph(hub=hub)
    xb = x.astype(BF16)
    want = np.asarray(jax_spmm_segment(JaxPaddedCSR.from_scipy(adj),
                                       jnp.asarray(xb))).astype(np.float32)
    coo = adj.tocoo()
    order = np.argsort(coo.row, kind="stable")
    rows, cols = coo.row[order], coo.col[order]
    vals = coo.data[order].astype(np.float32)
    terms = xb.astype(np.float32)[cols] * vals[:, None]
    f32 = np.zeros_like(x)
    per_add = np.zeros_like(x)
    for r, t in zip(rows, terms):
        f32[r] += t
        per_add[r] = (per_add[r] + t.astype(BF16).astype(np.float32)
                      ).astype(BF16).astype(np.float32)
    np.testing.assert_array_equal(f32.astype(BF16).astype(np.float32), want)
    assert np.mean(per_add != want) > 0.1


@pytest.mark.parametrize("hub", [0, 2000])
def test_bf16_product_matches_grandtpu(hub):
    """The bare product on bf16 x: a bf16 result within one ulp of
    grandtpu's (bit for bit without a split row), with and without the
    hub row's split plan."""
    adj, x = _graph(hub=hub)
    padded = PaddedCSR.from_scipy(adj, device="cpu")
    assert (padded.plan is not None) == bool(hub)
    xb = torch.as_tensor(x).bfloat16()
    got = spmm_segment(padded, xb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_spmm_segment(JaxPaddedCSR.from_scipy(adj),
                                       jnp.asarray(x.astype(BF16))))
    got, want = got.float().numpy(), want.astype(np.float32)
    if hub:
        assert within_one_bf16_ulp(got, want)
    else:
        np.testing.assert_array_equal(got, want)


def test_bf16_hop_update_rounds_in_bf16():
    """The fused hop on bf16 carries: y = bf16(bf16(scale) * bf16(h)), acc
    = bf16(acc + y), as grandtpu's bf16 ppr update; the launch counter is
    the card's only (the CPU runs the plain version)."""
    adj, x = _graph()
    padded = PaddedCSR.from_scipy(adj, device="cpu")
    xb = torch.as_tensor(x).bfloat16()
    acc = torch.as_tensor(x[::-1].copy()).bfloat16()
    want_acc = acc.clone()
    y = torch.empty_like(xb)
    before = spmm_segment_prop_step.launches
    spmm_segment_prop_step(padded, xb, y, acc, 0.8, True)
    assert spmm_segment_prop_step.launches == before
    h = spmm_segment(padded, xb)
    want_y = h * torch.tensor(0.8).bfloat16()
    assert torch.equal(y, want_y)
    assert torch.equal(acc, want_acc + want_y)


@pytest.mark.parametrize("mode", ["ppr", "avg", "single"])
@pytest.mark.parametrize("hub", [0, 2000])
def test_exact_propagate_segment_bf16_carry_matches_grandtpu(mode, hub):
    adj, x = _graph(hub=hub)
    kw = dict(mode=mode, order=5, alpha=0.15, backend="segment")
    want = np.asarray(jax_exact_propagate(adj, x, precision="bf16_carry",
                                          **kw))
    got = exact_propagate(adj, x, precision="bf16_carry", device="cpu", **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), want.astype(np.float32)
    assert within_one_bf16_ulp(got, want)
    if not hub:
        np.testing.assert_array_equal(got, want)
    f32 = exact_propagate(adj, x, device="cpu", **kw).numpy()
    assert np.abs(got - f32).max() / np.abs(f32).max() <= 2e-2


def test_segment_propagator_takes_bf16_carries():
    """``Propagator(backend="segment", dtype=bf16)``: bf16 carries whatever
    the precision asks (the segment backend ignores it), the form it ran
    recorded as grandtpu's segment hop ('f32' terms)."""
    adj, x = _graph()
    prop = Propagator(adj, backend="segment", dtype=torch.bfloat16,
                      device="cpu")
    a = prop(x, order=3, precision="bf16")
    b = prop(x, order=3, precision="auto")
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert prop.last_precision == "f32"
