"""The port's all_gather variant of D1 (``BlockShardedGraph``,
``BlockShardedPropagator``) against grandtpu's on 2- and 4-shard meshes;
tolerances and helpers as in ``test_torch_dist.py``."""

import numpy as np
import pytest

from grandtpu.dist import BlockShardedGraph as JaxBlockGraph
from grandtpu.dist import BlockShardedPropagator as JaxBlockProp

from grandtpu_torch.dist import BlockShardedGraph, BlockShardedPropagator
from test_torch_dist import (ONE_HOP, RUNS, KW, TOL, graph_feats,  # noqa: F401
                             meshes, rel, run_tol, weighted)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_block_sharded_metadata_equal_grandtpu(graph_feats, num_shards):
    adj, _ = graph_feats
    want = JaxBlockGraph.build(adj, num_shards=num_shards, rows_per_block=8,
                               pad_multiple=16)
    got = BlockShardedGraph.build(adj, num_shards=num_shards,
                                  rows_per_block=8)
    assert got.rows_per_shard == want.rows_per_shard
    assert np.array_equal(got.row_val, np.asarray(want.row_val))
    # the same folded values, by shard
    wv = np.asarray(want.vals).reshape(num_shards, -1)
    for s, (indptr, indices, values) in enumerate(got.csrs):
        assert indptr[-1] == values.size == indices.size
        assert np.array_equal(np.sort(values), np.sort(wv[s][wv[s] != 0]))


@pytest.mark.parametrize("num_shards,mode,precision", RUNS)
def test_block_sharded_matches_grandtpu(graph_feats, num_shards, mode,
                                        precision):
    adj, feats = graph_feats
    jmesh, mesh = meshes(num_shards)
    want = JaxBlockProp(jmesh, JaxBlockGraph.build(
        adj, num_shards=num_shards, rows_per_block=8, pad_multiple=16))(
        feats, mode=mode, precision=precision, **KW)
    got = BlockShardedPropagator(mesh, BlockShardedGraph.build(
        adj, num_shards=num_shards, rows_per_block=8))(
        feats, mode=mode, precision=precision, **KW)
    assert got.shape == want.shape and rel(got, want) <= run_tol(precision)


@pytest.mark.parametrize("num_shards,weights,precision", ONE_HOP)
def test_block_int8_one_hop_matches_grandtpu(graph_feats, num_shards,
                                             weights, precision):
    """One hop from the same input: the same q, exact int32 sums or the
    same bf16 terms, so within the f32 tolerance; 'int8' is the exact
    form on D^-1 A and the bf16-term form on a weighted graph."""
    adj, feats = graph_feats
    if weights == "weighted":
        adj = weighted(adj)
    jmesh, mesh = meshes(num_shards)
    want = JaxBlockProp(jmesh, JaxBlockGraph.build(
        adj, num_shards, rows_per_block=8, pad_multiple=16))
    g = BlockShardedGraph.build(adj, num_shards, rows_per_block=8)
    assert (g.row_val is None) == (weights == "weighted")
    kw = dict(mode="ppr", order=1, alpha=0.3, precision=precision)
    assert rel(BlockShardedPropagator(mesh, g)(feats, **kw),
               want(feats, **kw)) <= TOL
