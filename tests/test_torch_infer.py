"""grandtpu_torch.infer against grandtpu.infer: exact propagation (dense
backend and the CSR backend's plain version) and chunked classification.

Tolerance: max |port - jax| / max |jax| <= 1e-5 (f32, sums in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.infer import classify as jcls
from grandtpu.infer import exact_propagate as jax_exact_propagate
from grandtpu.nn import mlp as jmlp

from grandtpu_torch.convert import mlp_from_jax
from grandtpu_torch.infer import classify, exact_propagate
from grandtpu_torch.nn.mlp import MLPConfig
from grandtpu_torch.sparse import CSROperator, spmm_prop_step
from test_torch_classify_cuda import owned_logits

TOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _hub_graph():
    """Sparse random graph plus one hub joined to most nodes, self-looped:
    the degree skew SplitCSR exists for on the TPU."""
    rs = np.random.RandomState(11)
    n = 300
    adj = sp.random(n, n, density=0.01, random_state=rs, format="csr")
    adj.data[:] = 1.0
    hub = sp.csr_matrix((np.ones(250), (np.zeros(250, int),
                                        np.arange(1, 251))), shape=(n, n))
    adj = ((adj + adj.T + hub + hub.T) > 0).astype(np.float32)
    adj = (adj + sp.eye(n, format="csr")).tocsr()
    feats = rs.randn(n, 24).astype(np.float32)
    return adj, feats


@pytest.fixture(params=["small", "hub"])
def graph(request, small_graph):
    if request.param == "small":
        adj, feats, _ = small_graph
        return adj, np.asarray(feats, np.float32)
    return _hub_graph()


@pytest.mark.parametrize("mode", ["ppr", "avg", "single"])
@pytest.mark.parametrize("backend,jax_backend", [("dense", "dense"),
                                                 ("csr", "block")])
def test_exact_propagate_parity(graph, mode, backend, jax_backend):
    adj, feats = graph
    kw = dict(mode=mode, order=5, alpha=0.15)
    want = np.asarray(jax_exact_propagate(adj, feats, backend=jax_backend,
                                          **kw))
    x = torch.tensor(feats)
    got = exact_propagate(adj, x, backend=backend, device="cpu", **kw)
    assert got.shape == feats.shape
    assert rel(got, want) <= TOL
    # the carries are swapped in place, never the caller's features
    np.testing.assert_array_equal(x.numpy(), feats)


def test_csr_plain_dispatch_on_cpu(small_graph):
    adj, feats, _ = small_graph
    op = CSROperator.from_scipy(adj, "cpu")
    assert op.indptr.dtype == op.indices.dtype == torch.int32
    x = torch.tensor(np.asarray(feats, np.float32))
    y, acc = torch.empty_like(x), torch.zeros_like(x)
    before = spmm_prop_step.launches
    spmm_prop_step(op, x, y, acc, 0.5, True)
    np.testing.assert_allclose(y.numpy(), 0.5 * (adj @ feats), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(acc.numpy(), y.numpy())
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert spmm_prop_step.launches == before


def test_unported_precision_raises(small_graph):
    """Every precision and backend is ported: the 'segment' backend with
    bf16 carries, the last one that raised, gives grandtpu's bf16 result
    (the same bits here: f32 sums in edge order, each row rounded once)
    within 2e-2 of f32."""
    adj, feats, _ = small_graph
    kw = dict(precision="bf16_carry", backend="segment", order=5)
    got = exact_propagate(adj, feats, device="cpu", **kw)
    want = np.asarray(jax_exact_propagate(adj, feats, **kw))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    f32 = exact_propagate(adj, feats, backend="segment", order=5,
                          device="cpu").numpy()
    err = np.abs(got.float().numpy() - f32).max() / np.abs(f32).max()
    assert err <= 2e-2


def test_predict_logits_and_accuracy_parity(small_graph):
    adj, feats, labels = small_graph
    kw = dict(num_features=feats.shape[1], num_classes=labels.shape[1],
              hidden=16, nlayers=2, use_bn=True, node_norm=True)
    params, state = jmlp.init_mlp(jax.random.PRNGKey(3), jmlp.MLPConfig(**kw))
    model = mlp_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), MLPConfig(**kw),
                         "cpu")
    x = np.asarray(feats, np.float32)
    labels_int = labels.argmax(1).astype(np.int32)
    idx = np.arange(0, x.shape[0], 3)
    want = jcls.predict_logits(params, state, jmlp.MLPConfig(**kw),
                               jnp.asarray(x), batch_size=50)
    got = classify.predict_logits(model, torch.tensor(x), batch_size=50)
    assert got.shape == want.shape
    assert rel(got, want) <= TOL
    assert classify.test_accuracy(
        model, torch.tensor(x), idx, labels_int, batch_size=50) == \
        jcls.test_accuracy(params, state, jmlp.MLPConfig(**kw),
                           jnp.asarray(x), idx, labels_int, batch_size=50)


@pytest.mark.parametrize("path", ["dense", "mag"])
def test_logits_arrays_belong_to_the_caller(path):
    """A second call on other inputs leaves the first call's array as it
    was: no call hands out a buffer that a later call writes into."""
    first = owned_logits(path, seed=1)
    kept = first.copy()
    second = owned_logits(path, seed=2)
    assert not np.array_equal(second, kept)
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
