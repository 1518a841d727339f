"""The port's halo exchange of D1 (``HaloShardedGraph``, ``HaloPropagator``,
``estimate_halo_compression``) against grandtpu's on 2- and 4-shard
meshes; tolerances and helpers as in ``test_torch_dist.py``."""

import numpy as np
import pytest
import torch

from grandtpu.dist.halo import HaloPropagator as JaxHaloProp
from grandtpu.dist.halo import HaloShardedGraph as JaxHaloGraph
from grandtpu.dist.halo import \
    estimate_halo_compression as jax_estimate_compression

from grandtpu_torch.dist import (HaloPropagator, HaloShardedGraph,
                                 estimate_halo_compression, make_mesh)
from test_torch_dist import (ONE_HOP, RUNS, KW, TOL, graph_feats,  # noqa: F401
                             meshes, rel, run_tol, self_looped, weighted)


@pytest.mark.parametrize("num_shards,mode,precision", RUNS)
def test_halo_matches_grandtpu(graph_feats, num_shards, mode, precision):
    adj, feats = graph_feats
    jmesh, mesh = meshes(num_shards)
    want = JaxHaloProp(jmesh, JaxHaloGraph.build(
        adj, num_shards=num_shards, rows_per_block=8))(
        feats, mode=mode, precision=precision, **KW)
    got = HaloPropagator(mesh, HaloShardedGraph.build(
        adj, num_shards=num_shards, rows_per_block=8))(
        feats, mode=mode, precision=precision, **KW)
    assert got.shape == want.shape and rel(got, want) <= run_tol(precision)


@pytest.mark.parametrize("num_shards,weights,precision", ONE_HOP)
def test_halo_int8_one_hop_matches_grandtpu(graph_feats, num_shards,
                                            weights, precision):
    """One hop from the same input, as the all_gather variant's test: the
    exact int32 halo form on D^-1 A, the bf16-term one on a weighted
    graph; the diagonal partial is f32 in both."""
    adj, feats = graph_feats
    if weights == "weighted":
        adj = weighted(adj)
    jmesh, mesh = meshes(num_shards)
    want = JaxHaloProp(jmesh, JaxHaloGraph.build(adj, num_shards,
                                                 rows_per_block=8))
    g = HaloShardedGraph.build(adj, num_shards, rows_per_block=8)
    assert (g.row_val is None) == (weights == "weighted")
    kw = dict(mode="ppr", order=1, alpha=0.3, precision=precision)
    assert rel(HaloPropagator(mesh, g)(feats, **kw),
               want(feats, **kw)) <= TOL


def test_halo_bf16_runs_f32_terms(graph_feats):
    """grandtpu's halo variant rounds nothing to bf16 at 'bf16' (its
    onehot_spmm casts int8 sources only): the port keeps that."""
    adj, feats = graph_feats
    prop = HaloPropagator(make_mesh(4, device="cpu"),
                          HaloShardedGraph.build(adj, 4, rows_per_block=8))
    assert torch.equal(prop(feats, precision="bf16", **KW),
                       prop(feats, precision="f32", **KW))


@pytest.mark.parametrize("avg_degree,shards,block", [
    (3, 4, 512), (12, 4, 512), (3, 2, 512), (8, 4, 8), (8, 2, 16)])
def test_halo_build_metadata_equal_grandtpu(avg_degree, shards, block):
    adj, _ = self_looped(1000, avg_degree, 3, features=4)
    want = JaxHaloGraph.build(adj, num_shards=shards, rows_per_block=block)
    got = HaloShardedGraph.build(adj, num_shards=shards, rows_per_block=block)
    assert got.rows_per_shard == want.rows_per_shard
    assert got.halo_per_pair == want.halo_per_pair
    assert got.compression == want.compression
    assert np.array_equal(got.send_idx, np.asarray(want.send_idx))
    if want.row_val is not None:
        assert np.array_equal(got.row_val, np.asarray(want.row_val))
    est = estimate_halo_compression(adj, shards, rows_per_block=block)
    assert est == jax_estimate_compression(adj, shards,
                                           rows_per_block=block)
    assert est == pytest.approx(got.compression)


