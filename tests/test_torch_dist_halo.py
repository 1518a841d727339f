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
from grandtpu_torch.dist.halo import SLOTS_PER_ITEM, SendPlan
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




def _plan_gather(x, plan, m):
    """A plain gather driven by the plan alone: each item's row to each of
    its slots."""
    out = x.new_full((m, x.shape[1]), float("nan"))
    counts = (plan.item_ptr[1:] - plan.item_ptr[:-1]).long()
    out[plan.dst.long()] = x[plan.item_src.long().repeat_interleave(counts)]
    return out


def _check_plan(send_idx, x):
    idx = torch.as_tensor(np.ascontiguousarray(send_idx).reshape(-1))
    plan = SendPlan.build(idx)
    src, ptr, dst = (plan.item_src.long(), plan.item_ptr.long(),
                     plan.dst.long())
    assert all(t.dtype == torch.int32 for t in (plan.item_src,
                                                 plan.item_ptr, plan.dst))
    # every slot once; each item one source row, at most SLOTS_PER_ITEM
    # slots, ascending; the distinct rows in ascending order
    assert torch.equal(torch.sort(dst).values, torch.arange(idx.numel()))
    sizes = ptr[1:] - ptr[:-1]
    assert ptr[0] == 0 and ptr[-1] == idx.numel()
    assert bool((sizes >= 1).all()) and bool((sizes <= SLOTS_PER_ITEM).all())
    assert bool((src[1:] >= src[:-1]).all())
    assert torch.equal(torch.unique(src), torch.unique(idx.long()))
    assert torch.equal(idx.long()[dst],
                       src.repeat_interleave(sizes))
    assert bool((dst[1:] > dst[:-1])[(src.repeat_interleave(sizes)[1:] ==
                                      src.repeat_interleave(sizes)[:-1])]
                .all())
    assert torch.equal(_plan_gather(x, plan, idx.numel()), x[idx.long()])


def _pair_counts(adj, shards, rows_per):
    """The distinct columns each (receiver, owner) pair exchanges."""
    coo = adj.tocoo()
    d, s = coo.row // rows_per, coo.col // rows_per
    halo = d != s
    pairs = np.unique(np.stack([d[halo], s[halo], coo.col[halo]]), axis=1)
    return np.bincount(pairs[0] * shards + pairs[1],
                       minlength=shards * shards)


@pytest.mark.parametrize("n,avg_degree,shards,block", [
    (1000, 3, 4, 512), (1000, 12, 4, 8), (1000, 8, 2, 16), (1000, 8, 3, 8),
    (3000, 2, 4, 64)])
def test_send_plan_reproduces_send_idx(n, avg_degree, shards, block):
    """The send plan of every owner reproduces x[send_idx] exactly through
    a gather that reads the plan alone, the padding slots (copies of row 0)
    included, on graphs whose pairs need different numbers of rows."""
    adj, _ = self_looped(n, avg_degree, 3, features=4)
    g = HaloShardedGraph.build(adj, shards, rows_per_block=block)
    counts = _pair_counts(adj, shards, g.rows_per_shard)
    off_diag = counts.reshape(shards, shards)[~np.eye(shards, dtype=bool)]
    assert len(set(off_diag.tolist())) > 1 and g.halo_per_pair > 0
    x = torch.randn(g.rows_per_shard, 5,
                    generator=torch.Generator().manual_seed(n))
    for s in range(shards):
        _check_plan(g.send_idx[s], x)


@pytest.mark.parametrize("case", ["every_receiver", "empty_group",
                                  "all_padding", "long_row"])
def test_send_plan_edge_cases(case):
    """Hand-made send_idx [S=3, S, C_max]: a row that every receiver needs,
    an empty group, groups of padding only, a row with more slots than an
    item holds."""
    send = np.zeros((3, 3, 6), np.int32)
    if case == "every_receiver":
        send[0, :, 0] = 4
        send[0, 1, 1:3] = [1, 6]
    elif case == "empty_group":
        send[1, 0, :4] = [0, 2, 3, 9]
        send[1, 2, :] = 0
    elif case == "long_row":
        send = np.zeros((3, 3, 2 * SLOTS_PER_ITEM + 3), np.int32)
        send[2, 1, :5] = [7, 8, 9, 10, 11]
    x = torch.randn(12, 3, generator=torch.Generator().manual_seed(1))
    for s in range(3):
        _check_plan(send[s], x)
