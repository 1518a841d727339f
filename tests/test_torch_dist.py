"""The port's row-partitioned propagation (D1) against grandtpu's, on 2- and
4-shard meshes: grandtpu's ``make_mesh(n_data=S)`` over the virtual CPU
devices against the port's ``make_mesh(S, devices=["cpu"] * S)`` (the
kernels' plain versions). Here: the mesh, the scatter variant, the global
int8 quantize, the dispatch of ``dist_exact_propagate`` with its precision
names, and the helpers of ``test_torch_dist_block.py`` (the all_gather
variant) and ``test_torch_dist_halo.py`` (the halo exchange), which are
files of their own so that test workers share them out. Every mode runs
in f32; the fast precisions run ppr, whose hop the modes share.

Tolerances, max |port - jax| / max |jax|: 1e-5 for f32 and bf16 terms
(f32 sums in another order), and for one hop of the int8 forms: the same
f32 input quantized with the same global scale gives the same q, element
for element (checked on its own), the int8 sums are exact and the bf16
terms round the same way. Whole int8 runs of 4 hops: 1e-3, one
quantization step, grandtpu's own bound for the same reason
(tests/test_dist.py): f32 ulps by which two programs' carries differ after
a hop (XLA on the CPU adds the ppr update ``acc + (1 - alpha) * h`` as a
fused multiply-add, which the port, like grandtpu's semantics, rounds
twice; and sums in its own order) flip a round() boundary of the next
hop's quantize now and then.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import grandtpu.dist.spmm_shard as jshard
from grandtpu.data import synthetic_graph
from grandtpu.dist import ShardedGraph as JaxShardedGraph
from grandtpu.dist import dist_exact_propagate as jax_dist_propagate
from grandtpu.dist import make_mesh as jax_make_mesh
from grandtpu.dist import sharded_propagate as jax_sharded_propagate

import grandtpu_torch.dist.spmm_shard as tshard
from grandtpu_torch.dist import (BlockShardedGraph, BlockShardedPropagator,
                                 HaloPropagator, HaloShardedGraph,
                                 ShardedGraph, dist_exact_propagate,
                                 estimate_halo_compression, make_mesh,
                                 sharded_propagate)
from grandtpu_torch.dist.halo import halo_pack
from grandtpu_torch.infer import exact_propagate
from grandtpu_torch.infer.propagate import exact_propagator
from grandtpu_torch.sparse import column_absmax, quantize_with_amax

# The suite runs in several worker processes at once (pytest-xdist), and
# every worker collects this module. With torch's default of one OpenMP
# thread a core in each of them, the threads spin against each other and
# against XLA's, and the plain versions' many small ops run a hundred times
# slower; one intra-op thread a process keeps the workers apart.
torch.set_num_threads(1)

TOL = 1e-5
INT8_RUN_TOL = 1e-3
MODES = ("ppr", "avg", "single")
# (shards, mode, precision) of the whole-run checks: f32 in every mode,
# the fast forms in ppr ('int8mxu' is 'int8' in the propagators, checked
# by test_dist_exact_propagate_matches_grandtpu)
RUNS = ([(s, m, "f32") for s in (2, 4) for m in MODES]
        + [(s, "ppr", p) for s in (2, 4) for p in ("bf16", "int8",
                                                   "int8cast")])
# (shards, weights, precision) of the one-hop int8 checks
ONE_HOP = ([(s, "unit", p) for s in (2, 4) for p in ("int8", "int8cast")]
           + [(4, "weighted", p) for p in ("int8", "int8cast")])
KW = dict(order=4, alpha=0.3)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def self_looped(n, degree, seed, features=24):
    adj, feats, _ = synthetic_graph(num_nodes=n, num_classes=3,
                                    num_features=features,
                                    avg_degree=degree, seed=seed)
    return (adj + sp.eye(n, format="csr")).tocsr(), np.asarray(feats,
                                                               np.float32)


@pytest.fixture(scope="module")
def graph_feats():
    return self_looped(200, 8.0, 9)


def meshes(num_shards):
    return (jax_make_mesh(n_data=num_shards),
            make_mesh(num_shards, devices=["cpu"] * num_shards))


def weighted(adj):
    """``adj`` with random edge weights: D^-1 A's rows are then not
    constant, and 'int8' takes the bf16-term form (K2-q8 or the halo's
    cast form) instead of the exact int32 one."""
    adj = adj.copy()
    adj.data = np.random.RandomState(0).rand(adj.nnz) + 0.5
    return adj


def run_tol(precision: str) -> float:
    """f32 and bf16 terms: TOL; the int8 forms ('auto' is int8 here): one
    quantization step over a whole run."""
    return TOL if precision in ("f32", "bf16", "bf16_carry") else INT8_RUN_TOL


def test_make_mesh():
    mesh = make_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.shape == {"data": 3, "model": 1}
    # a (data, model) grid: shard d * n_model + m, as grandtpu's
    grid = make_mesh(2, n_model=2, device="cpu")
    assert grid.shape == {"data": 2, "model": 2} and grid.size == 4
    assert grid.data_shards == (0, 0, 1, 1)
    assert grid.model_shards == (0, 1, 0, 1)
    assert make_mesh(n_model=3, devices=["cpu"] * 6).shape == \
        {"data": 2, "model": 3}
    with pytest.raises(ValueError, match="need 3"):
        make_mesh(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)


def test_mesh_collectives():
    mesh = make_mesh(3, device="cpu")
    xs = [torch.full((2, 4), float(s)) for s in range(3)]
    full = mesh.all_gather(xs)
    assert all(torch.equal(f, torch.cat(xs)) for f in full)
    sends = [torch.arange(3 * 5).reshape(3, 5, 1) + 100 * s for s in range(3)]
    recv = mesh.all_to_all(sends)
    for d in range(3):
        assert torch.equal(recv[d], torch.stack([sends[s][d]
                                                 for s in range(3)]))
    mx = mesh.pmax([torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0]),
                    torch.tensor([0.0, 4.0])])
    assert all(torch.equal(m, torch.tensor([3.0, 5.0])) for m in mx)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_sharded_graph_arrays_equal_grandtpu(graph_feats, num_shards):
    adj, _ = graph_feats
    want = JaxShardedGraph.build(adj, num_shards=num_shards)
    got = ShardedGraph.build(adj, num_shards=num_shards)
    assert got.rows_per_shard == want.rows_per_shard
    for name in ("rows_local", "cols", "vals", "dinv"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("num_shards", [2, 4])
def test_sharded_propagate_matches_grandtpu(graph_feats, num_shards, mode):
    adj, feats = graph_feats
    jmesh, mesh = meshes(num_shards)
    want = jax_sharded_propagate(jmesh, JaxShardedGraph.build(
        adj, num_shards=num_shards), feats, mode=mode, **KW)
    got = sharded_propagate(mesh, ShardedGraph.build(
        adj, num_shards=num_shards), feats, mode=mode, **KW)
    assert got.shape == want.shape and rel(got, want) <= TOL


@pytest.mark.parametrize("num_shards", [2, 4])
def test_int8_exchange_equals_jax_quantize(graph_feats, num_shards):
    """The global per-column quantize (each shard's column max, the mesh's
    max, each shard's quantize, or the fused gather-and-quantize of the
    halo pack) gives grandtpu's q element for element."""
    adj, feats = graph_feats
    mesh = make_mesh(num_shards, device="cpu")
    g = HaloShardedGraph.build(adj, num_shards, rows_per_block=8)
    xs = tshard.place(mesh, g.num_nodes, g.rows_per_shard, 0.3 * feats)
    x = jnp.concatenate([jnp.asarray(b.numpy()) for b in xs])
    amax = jnp.max(jnp.abs(x), axis=0)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    want_q = np.asarray(jnp.clip(jnp.round(x / scale[None, :]), -127,
                                 127).astype(jnp.int8))
    amaxes = mesh.pmax([column_absmax(b) for b in xs])
    qs = [quantize_with_amax(b, a) for b, a in zip(xs, amaxes)]
    assert np.array_equal(torch.cat([q for q, _ in qs]).numpy(), want_q)
    assert all(np.array_equal(s.numpy(), np.asarray(scale)) for _, s in qs)
    for s, b in enumerate(xs):
        idx = torch.as_tensor(g.send_idx[s].reshape(-1))
        send, sc = halo_pack(b, idx, amaxes[s])
        rows = want_q[s * g.rows_per_shard:][:g.rows_per_shard]
        assert np.array_equal(send.numpy(), rows[idx.numpy()])
        assert np.array_equal(sc.numpy(), np.asarray(scale))


def _dispatch(monkeypatch, adj, feats, num_shards, **kw):
    """dist_exact_propagate's result and the sharded graphs it built."""
    built = []
    for cls in (tshard.BlockShardedGraph, HaloShardedGraph):
        real = cls.build
        monkeypatch.setattr(cls, "build", staticmethod(
            lambda *a, _r=real, _n=cls.__name__, **k: (built.append(_n),
                                                       _r(*a, **k))[1]))
    out = dist_exact_propagate(make_mesh(num_shards, device="cpu"), adj,
                               feats, mode="ppr", order=3, alpha=0.2, **kw)
    return out, built


def test_dispatch_fabric_default_single_process(monkeypatch):
    """On the port's single-process mesh the default takes all_gather even
    where the halo would move less, as grandtpu's does; a threshold of 1.0
    takes the halo exchange; one shard goes to exact_propagate."""
    adj, feats = self_looped(4096, 3, 1, features=8)
    assert estimate_halo_compression(adj, 8) < 0.5
    want = np.asarray(jax_dist_propagate(
        jax_make_mesh(n_data=8), adj, feats, mode="ppr", order=3,
        alpha=0.2))
    got, built = _dispatch(monkeypatch, adj, feats, 8)
    assert built == ["BlockShardedGraph"] and rel(got, want) <= TOL
    got, built = _dispatch(monkeypatch, adj, feats, 8, halo_threshold=1.0)
    assert built == ["HaloShardedGraph"] and rel(got, want) <= TOL
    got, built = _dispatch(monkeypatch, adj, feats, 1)
    assert built == [] and rel(got, want) <= TOL
    assert torch.equal(got, exact_propagate(adj, feats, mode="ppr", order=3,
                                            alpha=0.2, device="cpu"))


@pytest.mark.parametrize("precision", ["f32", "int8mxu", "auto",
                                       "bf16_carry"])
@pytest.mark.parametrize("num_shards", [2, 4])
def test_dist_exact_propagate_matches_grandtpu(graph_feats, num_shards,
                                               precision):
    """Every precision name dist_exact_propagate takes, with grandtpu's
    aliasing: 'auto' resolves on the global [n, F] (int8 here),
    'bf16_carry' is 'bf16', 'int8mxu' is 'int8'."""
    adj, feats = graph_feats
    jmesh, mesh = meshes(num_shards)
    kw = dict(mode="ppr", precision=precision, **KW)
    want = np.asarray(jax_dist_propagate(jmesh, adj, feats, **kw))
    got = dist_exact_propagate(mesh, adj, feats, **kw)
    assert rel(got, want) <= run_tol(precision)
    alias = {"auto": "int8", "bf16_carry": "bf16",
             "int8mxu": "int8"}.get(precision)
    if alias:
        assert torch.equal(got, dist_exact_propagate(
            mesh, adj, feats, **(kw | {"precision": alias})))


def test_precision_validation(graph_feats):
    """Unknown precision names raise in the propagators themselves and in
    dist_exact_propagate, as in grandtpu."""
    adj, feats = graph_feats
    mesh = make_mesh(4, device="cpu")
    props = [BlockShardedPropagator(mesh, BlockShardedGraph.build(adj, 4)),
             HaloPropagator(mesh, HaloShardedGraph.build(adj, 4))]
    for prop in props:
        with pytest.raises(ValueError, match="unknown precision"):
            prop(feats, order=2, precision="int9")
    with pytest.raises(ValueError, match="unknown precision"):
        dist_exact_propagate(mesh, adj, feats, order=2, precision="fp8")
    with pytest.raises(ValueError, match="unknown precision"):
        jshard._check_dist_precision("fp8")


@pytest.mark.parametrize("variant", ["block", "halo", "scatter"])
def test_plain_flag_runs_the_same_arithmetic(graph_feats, variant):
    """``plain=True`` (the card checks' reference run) is what the CPU
    tensors run anyway."""
    adj, feats = graph_feats
    mesh = make_mesh(2, device="cpu")
    if variant == "scatter":
        prop = tshard.ShardedPropagator(mesh, ShardedGraph.build(adj, 2))
        kw = {}
    else:
        cls, gcls = ((BlockShardedPropagator, BlockShardedGraph)
                     if variant == "block" else
                     (HaloPropagator, HaloShardedGraph))
        prop = cls(mesh, gcls.build(adj, 2, rows_per_block=8))
        kw = {"precision": "int8"}
    assert torch.equal(prop(feats, **KW, **kw),
                       prop(feats, **KW, **kw, plain=True))


def _hub_graph(n=2000, hub=1500, seed=3):
    """A self-looped SBM graph with node 5 joined to ``hub`` others, both
    ways: a row above the operators' split cap (max(512, 8 x mean row))
    and below the int8 hub guard, so 'auto' picks int8."""
    adj, feats = self_looped(n, 4.0, seed)
    nbrs = np.random.RandomState(seed).permutation(n)[:hub]
    star = sp.csr_matrix((np.ones(hub, np.float32), (np.full(hub, 5), nbrs)),
                         shape=(n, n))
    adj = ((adj + star + star.T) > 0).astype(np.float32).tocsr()
    return adj, feats


@pytest.mark.parametrize("precision", ["int8", "int8cast", "auto"])
def test_block_int8_split_matches_one_card(precision):
    """D1's all_gather variant on 2 shards with a hub row that the shard's
    operator splits: 'int8', 'int8cast' and 'auto' (int8 here) run the
    split hop on the shard and on one card, and the D1 run equals the
    one-card split run (the same global q, and each row's terms grouped by
    the same plan: int32 sums for int8, the same f32 order for
    int8cast)."""
    adj, feats = _hub_graph()
    mesh = make_mesh(2, device="cpu")
    prop, resolved = tshard.dist_exact_propagator(mesh, adj, feats.shape[1],
                                                  precision=precision)
    assert isinstance(prop, BlockShardedPropagator)
    assert resolved == ("int8" if precision == "auto" else precision)
    plans = [op.plan for op in prop.ops]
    assert plans[0] is not None and plans[0].rows.tolist() == [5]
    one, one_p = exact_propagator(adj, feats.shape[1], backend="csr",
                                  precision=precision, device="cpu")
    assert one.adj_op.plan is not None and one_p == resolved
    kw = dict(mode="ppr", **KW)
    got = prop(feats, precision=resolved, **kw)
    want = one(feats, precision=one_p, **kw)
    assert one.last_precision == ("int8cast" if precision == "int8cast"
                                  else "int8mxu")
    assert torch.equal(got, want), rel(got, want)
