"""D1 and the source-sharded push on a (data, model) mesh, along either
axis: grandtpu's propagators and ``sharded_gfpush`` on
``make_mesh(n_data, n_model)`` over the virtual CPU devices, sharded along
``axis`` and replicated over the other, against the port's on
``make_mesh(n_data, n_model, device="cpu")``.

Each 2-D run is also held, with ``torch.equal``, to the port's run on the
1-D mesh of the axis's size, and every local group of the 2-D mesh
(``Mesh.along``: the model columns along 'data', the data rows along
'model') to the first: the groups are replicas of the 1-D computation.

Tolerances, max |port - jax| / max |jax| (as in ``test_torch_dist.py``):
1e-5 for f32 and bf16 terms, 1e-3 for whole int8 runs; the push by
grandtpu's own rule (tests/test_dist.py: values within 1e-5, columns
compared where both tables hold them, as ties may order them
differently), and element for element against the port's 1-D push.
"""

import numpy as np
import pytest
import torch

from grandtpu.dist import BlockShardedGraph as JaxBlockGraph
from grandtpu.dist import BlockShardedPropagator as JaxBlockProp
from grandtpu.dist import ShardedGraph as JaxShardedGraph
from grandtpu.dist import ShardedPropagator as JaxShardedProp
from grandtpu.dist import dist_exact_propagate as jax_dist_propagate
from grandtpu.dist import make_mesh as jax_make_mesh
from grandtpu.dist.halo import HaloPropagator as JaxHaloProp
from grandtpu.dist.halo import HaloShardedGraph as JaxHaloGraph
from grandtpu.dist.push import sharded_gfpush as jax_sharded_gfpush
from grandtpu.ppr import build_coef

from grandtpu_torch.dist import (BlockShardedGraph, BlockShardedPropagator,
                                 HaloPropagator, HaloShardedGraph,
                                 ShardedGraph, ShardedPropagator,
                                 dist_exact_propagate, dist_exact_propagator,
                                 make_mesh, sharded_gfpush)
from grandtpu_torch.infer import exact_propagate
from test_torch_dist import (INT8_RUN_TOL, KW, MODES, TOL,  # noqa: F401
                             graph_feats, rel, self_looped)
from test_torch_dist_push import _tie_rule, adj  # noqa: F401

# one intra-op thread a test process (see test_torch_dist.py)
torch.set_num_threads(1)

# ("n_data x n_model", axis): the model columns of a (2 x 2) and a (4 x 2)
# mesh along 'data', the data rows of a (2 x 2) and a (1 x 4) mesh along
# 'model'
SHAPES = (("2x2", "data"), ("4x2", "data"), ("2x2", "model"),
          ("1x4", "model"))
# (variant, mode, precision): f32 in every mode, the fast forms in ppr
FORMS = ([(v, m, "f32") for v in ("block", "halo", "scatter")
          for m in MODES]
         + [("block", "ppr", "bf16"), ("block", "ppr", "int8"),
            ("halo", "ppr", "int8")])
CASES = [(shape, axis, *form) for shape, axis in SHAPES for form in FORMS]

PORT = {"block": (BlockShardedGraph, BlockShardedPropagator),
        "halo": (HaloShardedGraph, HaloPropagator),
        "scatter": (ShardedGraph, ShardedPropagator)}
JAX = {"block": (JaxBlockGraph, JaxBlockProp),
       "halo": (JaxHaloGraph, JaxHaloProp),
       "scatter": (JaxShardedGraph, JaxShardedProp)}


def _graph(cls, adj, shards: int, variant: str, jax: bool = False):
    """Small blocks (8 rows) so that every shard holds rows and the halo
    exchange moves some."""
    if variant == "scatter":
        return cls.build(adj, num_shards=shards)
    if variant == "block" and jax:
        return cls.build(adj, num_shards=shards, rows_per_block=8,
                         pad_multiple=16)
    return cls.build(adj, num_shards=shards, rows_per_block=8)


def _run_kw(variant: str, mode: str, precision: str) -> dict:
    kw = dict(mode=mode, **KW)
    if variant != "scatter":
        kw["precision"] = precision
    return kw


@pytest.mark.parametrize("shape,axis,variant,mode,precision", CASES)
def test_d1_on_a_2d_mesh_matches_grandtpu_and_the_1d_mesh(
        graph_feats, shape, axis, variant, mode, precision):
    adj, feats = graph_feats
    n_data, n_model = map(int, shape.split("x"))
    shards = n_data if axis == "data" else n_model
    kw = _run_kw(variant, mode, precision)
    jgraph, jprop = JAX[variant]
    want = np.asarray(jprop(jax_make_mesh(n_data, n_model), _graph(
        jgraph, adj, shards, variant, jax=True), axis)(feats, **kw))
    graph, prop = PORT[variant]
    g = _graph(graph, adj, shards, variant)
    mesh = make_mesh(n_data, n_model=n_model, device="cpu")
    p = prop(mesh, g, axis)
    outs = p.each(feats, **kw)
    groups = n_model if axis == "data" else n_data
    assert len(outs) == len(p.groups) == groups
    tol = INT8_RUN_TOL if precision == "int8" else TOL
    assert outs[0].shape == want.shape and rel(outs[0], want) <= tol
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(p(feats, **kw), outs[0])
    one = prop(make_mesh(shards, device="cpu"), g)(feats, **kw)
    assert one.shape == outs[0].shape and torch.equal(outs[0], one)


@pytest.mark.parametrize("shape,axis,threshold", [
    ((2, 2), "data", None), ((2, 2), "data", 1.0), ((1, 4), "model", None),
    ((1, 4), "model", 1.0), ((4, 2), "model", None)])
def test_dist_exact_propagate_along_either_axis(shape, axis, threshold):
    """The dispatch on a 2-D mesh: ``mesh.shape[axis]`` shards (the
    all_gather variant by default on one process, the halo exchange at a
    threshold of 1.0), on a graph whose 512-row blocks fill the shards;
    against grandtpu's on the same JAX mesh and the port's 1-D run."""
    adj, feats = self_looped(2048, 3, 1, features=8)
    kw = dict(mode="ppr", order=3, alpha=0.2, axis=axis,
              halo_threshold=threshold)
    want = np.asarray(jax_dist_propagate(jax_make_mesh(*shape), adj, feats,
                                         **kw))
    mesh = make_mesh(shape[0], n_model=shape[1], device="cpu")
    prop, _ = dist_exact_propagator(mesh, adj, 8, axis=axis,
                                    halo_threshold=threshold)
    shards = mesh.shape[axis]
    assert type(prop).__name__ == ("HaloPropagator" if threshold
                                   else "BlockShardedPropagator")
    assert prop.g.num_shards == shards and prop.groups
    assert [q.mesh.size for q in prop.groups] == [shards] * (
        mesh.size // shards)
    got = dist_exact_propagate(mesh, adj, feats, **kw)
    assert rel(got, want) <= TOL
    kw.pop("axis")
    assert torch.equal(got, dist_exact_propagate(
        make_mesh(shards, device="cpu"), adj, feats, **kw))


def test_one_shard_along_the_axis_is_the_one_device_propagation(
        graph_feats):
    """A (1 x 4) mesh along 'data' (and a (4 x 1) one along 'model') has
    one shard along the axis: grandtpu's exact_propagate, the port's
    one-device propagator on the first device."""
    adj, feats = graph_feats
    kw = dict(mode="avg", **KW)
    want = exact_propagate(adj, feats, device="cpu", **kw)
    for shape, axis in (((1, 4), "data"), ((4, 1), "model")):
        mesh = make_mesh(shape[0], n_model=shape[1], device="cpu")
        prop, _ = dist_exact_propagator(mesh, adj, feats.shape[1],
                                        axis=axis)
        assert type(prop).__name__ == "Propagator"
        got = dist_exact_propagate(mesh, adj, feats, axis=axis, **kw)
        assert torch.equal(got, want)
        jax_got = np.asarray(jax_dist_propagate(jax_make_mesh(*shape), adj,
                                                feats, axis=axis, **kw))
        assert rel(got, jax_got) <= TOL


def test_an_unknown_axis_raises(graph_feats, adj):  # noqa: F811
    """As ``shard_map`` with an axis the mesh does not name: ValueError,
    from the dispatch, every propagator, the push and the mesh."""
    a, feats = graph_feats
    mesh = make_mesh(2, n_model=2, device="cpu")
    with pytest.raises(ValueError, match="not 'bogus'"):
        mesh.along("bogus")
    with pytest.raises(ValueError, match="not 'bogus'"):
        dist_exact_propagate(mesh, a, feats, axis="bogus")
    for variant, (graph, prop) in PORT.items():
        with pytest.raises(ValueError, match="not 'bogus'"):
            prop(mesh, _graph(graph, a, 2, variant), "bogus")
    with pytest.raises(ValueError, match="not 'bogus'"):
        sharded_gfpush(mesh, adj.indptr, adj.indices, np.arange(4),
                       build_coef("ppr", 3, 0.2), 1e-4, 4, axis="bogus")
    # a graph cut for another axis's size
    with pytest.raises(ValueError, match="the mesh's axis 'model' 4"):
        BlockShardedPropagator(make_mesh(1, n_model=4, device="cpu"),
                               BlockShardedGraph.build(a, 2), "model")


@pytest.mark.parametrize("shape,axis,dense_threshold", [
    ((4, 2), "data", 8192), ((4, 2), "data", 0), ((2, 4), "model", 8192),
    ((2, 4), "model", 0)])
def test_sharded_push_along_either_axis(adj, shape, axis,  # noqa: F811
                                        dense_threshold):
    """100 sources split ``mesh.shape[axis]`` ways (padded where they do
    not divide), the dense product or K2 over A^T (threshold 0): within
    grandtpu's rule of its push on the same JAX mesh, and element for
    element the port's push on the 1-D mesh of the axis's size."""
    coef = build_coef("ppr", order=5, alpha=0.3)
    sources = np.arange(0, 200, 2)
    indptr = adj.indptr.astype(np.int32)
    indices = adj.indices.astype(np.int32)
    mesh = make_mesh(shape[0], n_model=shape[1], device="cpu")
    got = sharded_gfpush(mesh, indptr, indices, sources, coef, 1e-4, 8,
                         axis=axis, dense_threshold=dense_threshold,
                         block=7)
    assert got[0].shape == got[1].shape == (100, 8)
    want = jax_sharded_gfpush(jax_make_mesh(*shape), adj.indptr,
                              adj.indices, sources, coef, 1e-4, 8, axis=axis)
    _tie_rule(*got, *want, atol=1e-5)
    one = sharded_gfpush(make_mesh(mesh.shape[axis], device="cpu"), indptr,
                         indices, sources, coef, 1e-4, 8,
                         dense_threshold=dense_threshold, block=7)
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4), (3, 2)])
def test_along_groups_cover_the_mesh_once(shape):
    """Along either axis the groups hold every shard once, in ascending
    order, each named by its index along the axis; ``row(d)`` and
    ``column(c)`` are the groups' meshes."""
    n_data, n_model = shape
    mesh = make_mesh(n_data, n_model=n_model, device="cpu")
    for axis, count, size in (("data", n_model, n_data),
                              ("model", n_data, n_model)):
        groups = mesh.along(axis)
        assert list(groups) == list(range(count))
        seen = sorted(i for idx, _ in groups.values() for i in idx)
        assert seen == list(range(mesh.size))
        for k, (idx, sub) in groups.items():
            assert sub.size == size and not sub.multiprocess
            assert sub.shards == tuple(range(size))
            assert sub is (mesh.column(k) if axis == "data"
                           else mesh.row(k))
            along = (mesh.data_shards if axis == "data"
                     else mesh.model_shards)
            assert tuple(along[i] for i in idx) == sub.shards
