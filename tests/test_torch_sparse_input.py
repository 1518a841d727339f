"""The port's MAG input path against grandtpu: sparse ``synth`` data, the
padded-row layout, the K3 op's plain version (forward and table gradient)
and the MAG head, from identical numpy inputs.

Tolerance: max |port - jax| / max |jax| <= 1e-5 (f32 sums in another
order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.data import load_data as jax_load_data
from grandtpu.data import synthetic_graph as jax_synthetic_graph
from grandtpu.nn import mag_mlp as jmag
from grandtpu.nn import sparse_input as jsi
from grandtpu.nn.dropnode import random_prop
from grandtpu.nn.mlp import MLPConfig as JaxMLPConfig

from grandtpu_torch.convert import mag_from_jax, mag_to_jax
from grandtpu_torch.data import load_data, synthetic_graph
from grandtpu_torch.nn.mag_mlp import MagMLP, init_mag_mlp
from grandtpu_torch.nn.mlp import MLPConfig
from grandtpu_torch.nn.sparse_input import (MAX_SMEM, PaddedFeatures,
                                            _check_args, embed_nodes,
                                            embed_nodes_plain, embed_prop,
                                            embed_prop_plain, fwd_smem_bytes)

TOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _assert_csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_sparse_synth_spec_matches_grandtpu():
    spec = "synth:300:3:50:sparse"
    want = jax_load_data(spec, split_seed=5)
    got = load_data(spec, split_seed=5)
    assert got.has_sparse_features and want.has_sparse_features
    _assert_csr_equal(got.adj, want.adj)
    _assert_csr_equal(got.features, want.features)
    for name in ("labels", "idx_train", "idx_val", "idx_test", "idx_unlabel"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(token_skew=1.5, label_noise=0.1),
    dict(feature_nnz=7, bow_uniform_frac=0.5),
    dict(sparse_features=False, label_noise=0.2),
])
def test_synthetic_graph_options_match_grandtpu(kw):
    kw = {"sparse_features": True, **kw}
    got = synthetic_graph(num_nodes=200, num_classes=4, num_features=40,
                          seed=3, **kw)
    want = jax_synthetic_graph(num_nodes=200, num_classes=4, num_features=40,
                               seed=3, **kw)
    _assert_csr_equal(got[0], want[0])
    if kw["sparse_features"]:
        _assert_csr_equal(got[1], want[1])
    else:
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _rand_csr(n=40, f=30, density=0.25, seed=0):
    rs = np.random.RandomState(seed)
    m = (rs.rand(n, f) < density) * (rs.rand(n, f) - 0.3)
    m[3] = 0.0                                # an empty row
    return sp.csr_matrix(m.astype(np.float32))


@pytest.mark.parametrize("cap", [None, 4, 1])
def test_padded_features_match_grandtpu(cap):
    feats = _rand_csr()
    got = PaddedFeatures.from_csr(feats, cap=cap)
    want = jsi.PaddedFeatures.from_csr(feats, cap=cap)
    np.testing.assert_array_equal(got.attr_cols, want.attr_cols)
    np.testing.assert_array_equal(got.attr_vals, want.attr_vals)
    assert got.num_features == want.num_features == 30
    assert got.attr_cols.dtype == np.int32 and got.attr_vals.dtype == np.float32


def _table_and_attrs(v=30, h=7, seed=1):
    rs = np.random.RandomState(seed)
    padded = PaddedFeatures.from_csr(_rand_csr(f=v, seed=seed))
    table = rs.randn(v, h).astype(np.float32)
    return rs, table, padded.attr_cols, padded.attr_vals


@pytest.mark.parametrize("droprate", [0.0, 0.5])
def test_embed_nodes_plain_matches_grandtpu(droprate):
    _, table, ac, av = _table_and_attrs()
    key = jax.random.PRNGKey(4)
    want = jsi.embed_nodes({"table": jnp.asarray(table)}, jnp.asarray(ac),
                           jnp.asarray(av), key=key, droprate=droprate,
                           training=droprate > 0)
    drop = None
    if droprate > 0:     # the mask JAX draws from the same key
        drop = torch.tensor(np.asarray(jax.random.bernoulli(
            key, 1.0 - droprate, (*ac.shape, table.shape[1]))))
    args = (torch.tensor(table), torch.tensor(ac), torch.tensor(av))
    assert rel(embed_nodes_plain(*args, drop, droprate), want) <= TOL
    node_form = embed_prop(*args, drop=None if drop is None else drop[None],
                           droprate=droprate)
    assert node_form.shape == (1, *want.shape)
    assert rel(node_form[0], want) <= TOL
    if drop is None:
        assert rel(embed_nodes(*args), want) <= TOL


def _jax_embed_prop(table, b_ac, b_av, vals, keys, q, p):
    outs = []
    for k in keys:
        k_emb, k_drop = jax.random.split(k)
        e = jsi.embed_nodes({"table": table}, b_ac, b_av, key=k_emb,
                            droprate=q, training=True)
        outs.append(random_prop(e, vals, key=k_drop, dropnode_rate=p,
                                training=True))
    return jnp.stack(outs)


@pytest.mark.parametrize("num_aug,q,p", [
    (1, 0.0, 0.0), (2, 0.0, 0.5), (2, 0.5, 0.5), (3, 0.5, 0.0),
])
def test_embed_prop_plain_matches_grandtpu_forward_and_grad(num_aug, q, p):
    rs, table, ac, av = _table_and_attrs(seed=2)
    r, ktop, h = 6, 5, table.shape[1]
    tk_cols = rs.randint(0, ac.shape[0], (r, ktop)).astype(np.int32)
    tk_cols[0, 1] = 3                          # a node with no attributes
    tk_vals = rs.rand(r, ktop).astype(np.float32)
    tk_vals[1, 3:] = 0.0                       # top-k padding slots
    g = rs.randn(num_aug, r, h).astype(np.float32)
    keys = list(jax.random.split(jax.random.PRNGKey(7), num_aug))

    b_ac, b_av = jnp.asarray(ac[tk_cols]), jnp.asarray(av[tk_cols])
    j_vals = jnp.asarray(tk_vals)

    def jloss(t):
        return jnp.sum(_jax_embed_prop(t, b_ac, b_av, j_vals, keys, q, p)
                       * jnp.asarray(g))

    want = _jax_embed_prop(jnp.asarray(table), b_ac, b_av, j_vals, keys, q, p)
    want_grad = jax.grad(jloss)(jnp.asarray(table))

    # the masks JAX drew, handed to the port
    keep, drop = [], []
    for k in keys:
        k_emb, k_drop = jax.random.split(k)
        keep.append(np.asarray(jax.random.bernoulli(k_drop, 1.0 - p,
                                                    (r, ktop)))
                    if p > 0 else np.ones((r, ktop), bool))
        drop.append(np.asarray(jax.random.bernoulli(
            k_emb, 1.0 - q, (r, ktop, ac.shape[1], h))))
    keep_t = torch.tensor(np.stack(keep))
    drop_t = torch.tensor(np.stack(drop)) if q > 0 else None
    for fn in (embed_prop_plain, embed_prop):
        t = torch.tensor(table, requires_grad=True)
        out = fn(t, torch.tensor(ac), torch.tensor(av), torch.tensor(tk_cols),
                 torch.tensor(tk_vals), keep_t, drop_t, q)
        assert out.shape == (num_aug, r, h)
        assert rel(out.detach(), want) <= TOL, fn.__name__
        (out * torch.tensor(g)).sum().backward()
        assert rel(t.grad, want_grad) <= TOL, fn.__name__


def _mag_pair(nlayers, use_bn, node_norm, v=20, h=8, c=3):
    kw = dict(num_features=v, num_classes=c, hidden=h, nlayers=nlayers,
              use_bn=use_bn, node_norm=node_norm)
    params, state = jmag.init_mag_mlp(jax.random.PRNGKey(nlayers),
                                      JaxMLPConfig(**kw))
    rs = np.random.RandomState(nlayers)
    state = {"bns": [{"mean": jnp.asarray(rs.randn(h).astype(np.float32)),
                      "var": jnp.asarray(rs.rand(h).astype(np.float32) + .5)}
                     for _ in state["bns"]]}
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    return (params, state, JaxMLPConfig(**kw)), mag_from_jax(
        params, state, MLPConfig(**kw), "cpu")


@pytest.mark.parametrize("nlayers", [1, 2, 3])
@pytest.mark.parametrize("use_bn,node_norm,masked,training", [
    (False, False, False, True), (True, True, True, True),
    (True, False, False, True), (True, True, False, False),
])
def test_mag_head_matches_grandtpu(nlayers, use_bn, node_norm, masked,
                                   training):
    (params, state, jcfg), model = _mag_pair(nlayers, use_bn, node_norm)
    rs = np.random.RandomState(9)
    x = rs.randn(12, model.table.shape[1]).astype(np.float32)
    mask = (np.arange(12) < 9).astype(np.float32) if masked else None
    want, want_state = jmag.apply_mag_head(
        params, state, jcfg, jnp.asarray(x), training=training,
        batch_mask=None if mask is None else jnp.asarray(mask))
    model.train(training)
    got = model(torch.tensor(x),
                batch_mask=None if mask is None else torch.tensor(mask))
    assert rel(got.detach(), want) <= TOL
    _, got_state = mag_to_jax(model)
    for g, w in zip(got_state["bns"], want_state["bns"], strict=True):
        assert rel(g["mean"], w["mean"]) <= TOL
        assert rel(g["var"], w["var"]) <= TOL


@pytest.mark.parametrize("nlayers", [1, 2, 3])
def test_mag_convert_round_trip_is_exact(nlayers):
    (params, state, _), model = _mag_pair(nlayers, True, False)
    assert model.table.shape == ((20, 3) if nlayers == 1 else (20, 8))
    got_p, got_s = mag_to_jax(model)
    assert jax.tree.structure(got_p) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves((got_p, got_s)),
                    jax.tree.leaves((params, state)), strict=True):
        np.testing.assert_array_equal(g, w)


def test_init_mag_mlp_is_seeded_and_shaped_like_grandtpu():
    cfg = MLPConfig(num_features=50, num_classes=4, hidden=16, nlayers=3)
    a, b = init_mag_mlp(cfg, 3, "cpu"), init_mag_mlp(cfg, 3, "cpu")
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    params, _ = jmag.init_mag_mlp(
        jax.random.PRNGKey(0), JaxMLPConfig(**dataclasses.asdict(cfg)))
    got, _ = mag_to_jax(a)
    assert (jax.tree.map(np.shape, got)
            == jax.tree.map(np.shape, jax.tree.map(np.asarray, params)))
    # N(0, 1) table, as torch nn.Embedding's default
    table = a.table.detach()
    assert abs(float(table.mean())) < 0.1
    assert abs(float(table.std()) - 1.0) < 0.1
    assert isinstance(a, MagMLP)


@pytest.mark.parametrize("num_aug", [1, 2, 8])
def test_check_args_states_the_forward_kernels_ktop_limit(num_aug):
    """_check_args accepts Ktop 64 (and 1, 32) and raises for the first
    Ktop whose forward kernel would need more than a block's shared
    memory."""
    def args(ktop):
        cols = torch.zeros(3, 2, dtype=torch.int32)
        return (torch.zeros(10, 64), cols, torch.ones(3, 2),
                torch.zeros(1, ktop, dtype=torch.int32),
                torch.ones(1, ktop),
                torch.ones(num_aug, 1, ktop, dtype=torch.bool), None, 0.0)

    for ktop in (1, 32, 64):
        assert _check_args(*args(ktop)) == (1, ktop, 2, 64, num_aug)
    limit = next(k for k in range(64, 10 ** 6) if fwd_smem_bytes(k, num_aug)
                 > MAX_SMEM)
    assert fwd_smem_bytes(limit - 1, num_aug) <= MAX_SMEM
    _check_args(*args(limit - 1))
    with pytest.raises(ValueError, match="shared memory"):
        _check_args(*args(limit))
