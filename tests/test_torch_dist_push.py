"""The port's source-sharded GFPush (D2's push, ``grandtpu_torch/dist/
push.py``) on CPU meshes, against grandtpu's ``sharded_gfpush`` on its
virtual CPU mesh (tests/test_dist.py::test_sharded_push_matches_single:
values within 1e-5, columns compared where the two tables both hold them,
as ties may order them differently) and against the port's one-device P1
(``gfpush_dense``: equal, each source's row does not depend on the
others); ``push_source_shard`` over world sizes 1-3 unions to the full
table (::test_multihost_push_shards_union_to_full).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.data import synthetic_graph
from grandtpu.dist import make_mesh as jax_make_mesh
from grandtpu.dist.push import sharded_gfpush as jax_sharded_gfpush
from grandtpu.ppr import build_coef

from grandtpu_torch.dist import make_mesh, push_source_shard, sharded_gfpush
from grandtpu_torch.ppr import gfpush
from grandtpu_torch.ppr.dense_push import gfpush_dense

# one intra-op thread a test process (see test_torch_dist.py)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def adj():
    a, _, _ = synthetic_graph(num_nodes=200, num_classes=3, num_features=24,
                              seed=9)
    return (a + sp.eye(a.shape[0], format="csr")).tocsr()


def _tie_rule(a_cols, a_vals, b_cols, b_vals, atol):
    np.testing.assert_allclose(a_vals, b_vals, atol=atol)
    for ac, av, bc, bv in zip(a_cols, a_vals, b_cols, b_vals):
        da = {c: v for c, v in zip(ac, av) if v > 0}
        db = {c: v for c, v in zip(bc, bv) if v > 0}
        for c, v in da.items():
            if c in db:
                np.testing.assert_allclose(v, db[c], atol=atol)


@pytest.mark.parametrize("shards,dense_threshold", [(8, 8192), (3, 8192),
                                                    (4, 0)])
def test_sharded_push_matches_grandtpu_and_one_device(adj, shards,
                                                      dense_threshold):
    """100 sources over the shards (padded where they do not divide), the
    dense product (n <= dense_threshold) or K2 over A^T (threshold 0)."""
    coef = build_coef("ppr", order=5, alpha=0.3)
    sources = np.arange(0, 200, 2)
    indptr = adj.indptr.astype(np.int32)
    indices = adj.indices.astype(np.int32)
    got = sharded_gfpush(make_mesh(shards, device="cpu"), indptr, indices,
                         sources, coef, 1e-4, 8,
                         dense_threshold=dense_threshold, block=7)
    assert got[0].shape == got[1].shape == (100, 8)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    want = jax_sharded_gfpush(jax_make_mesh(n_data=shards, n_model=1),
                              adj.indptr, adj.indices, sources, coef, 1e-4,
                              8)
    _tie_rule(*got, *want, atol=1e-5)
    one = gfpush_dense(indptr, indices, sources, coef, 1e-4, 8,
                       dense_threshold=dense_threshold, device="cpu")
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])


def test_sharded_push_rejects_other_axes(adj):
    """An axis the mesh does not name ('data' and 'model' run:
    test_torch_dist_2d.py)."""
    with pytest.raises(ValueError, match="'data'"):
        sharded_gfpush(make_mesh(2, device="cpu"), adj.indptr, adj.indices,
                       np.arange(4), build_coef("ppr", 3, 0.2), 1e-4, 4,
                       axis="bogus")


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("backend", ["native", "jax"])
def test_push_source_shards_union_to_full(adj, world, backend):
    """Rank-emulated source shards concatenate to the full push."""
    sources = np.arange(0, 150, 3)   # 50 sources: world 3 -> 17/17/16
    kw = dict(prop_mode="ppr", order=5, alpha=0.3, rmax=1e-4, k=8,
              backend=backend, device="cpu")
    full = gfpush(adj, sources, **kw)
    cols, vals, cover = [], [], 0
    for rank in range(world):
        lo, hi, c, v = push_source_shard(adj, sources, rank, world, **kw)
        assert lo == cover and c.shape == (hi - lo, 8)
        cover = hi
        cols.append(c)
        vals.append(v)
    assert cover == sources.shape[0]
    np.testing.assert_array_equal(np.concatenate(cols), full.cols)
    np.testing.assert_array_equal(np.concatenate(vals), full.vals)
    # a rank past the sources gets an empty share
    lo, hi, c, v = push_source_shard(adj, sources[:2], 2, 3, **kw)
    assert lo == hi and c.shape == v.shape == (0, 8)
