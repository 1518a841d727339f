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
from grandtpu_torch.nn.sparse_input import (
    MAX_SMEM, PaddedFeatures, _check_args, bwd_scratch_bytes, embed_nodes,
    embed_nodes_plain, embed_prop, embed_prop_backward,
    embed_prop_backward_plain, embed_prop_plain, embed_prop_window_backward,
    fwd_smem_bytes)

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


def _jax_k3_case(num_aug, q, p, seed=2, collide=False):
    """K3's inputs at a small size, grandtpu's forward and table gradient
    on them (``_jax_embed_prop``), and the masks JAX drew, as torch
    tensors for the port."""
    rs, table, ac, av = _table_and_attrs(seed=seed)
    if collide:
        ac = np.full_like(ac, 7)               # every id the same table row
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
    args = {"attr_cols": torch.tensor(ac), "attr_vals": torch.tensor(av),
            "tk_cols": torch.tensor(tk_cols), "tk_vals": torch.tensor(tk_vals),
            "keep": torch.tensor(np.stack(keep)),
            "drop": torch.tensor(np.stack(drop)) if q > 0 else None}
    return table, args, torch.tensor(g), want, want_grad


@pytest.mark.parametrize("num_aug,q,p", [
    (1, 0.0, 0.0), (2, 0.0, 0.5), (2, 0.5, 0.5), (3, 0.5, 0.0),
])
def test_embed_prop_plain_matches_grandtpu_forward_and_grad(num_aug, q, p):
    table, args, g, want, want_grad = _jax_k3_case(num_aug, q, p)
    r, h = args["tk_cols"].shape[0], table.shape[1]
    for fn in (embed_prop_plain, embed_prop):
        t = torch.tensor(table, requires_grad=True)
        out = fn(t, **args, droprate=q)
        assert out.shape == (num_aug, r, h)
        assert rel(out.detach(), want) <= TOL, fn.__name__
        (out * g).sum().backward()
        assert rel(t.grad, want_grad) <= TOL, fn.__name__


# vocab windows of the 30-word vocabulary: all of it, a middle part, none
_WINDOWS = {"all": (0, 30), "some": (9, 21), "none": (30, 36)}


@pytest.mark.parametrize("window", sorted(_WINDOWS))
@pytest.mark.parametrize("num_aug,q,p,collide", [
    (1, 0.0, 0.0, False), (2, 0.0, 0.5, False), (2, 0.5, 0.5, False),
    (8, 0.0, 0.5, False), (8, 0.5, 0.5, False), (2, 0.0, 0.5, True),
    (2, 0.5, 0.5, True),
])
def test_embed_prop_backward_plain_matches_grandtpus_grad(num_aug, q, p,
                                                          collide, window):
    """The backward's plain version (each entry's term row, each id's rows
    added in entry order) against ``jax.grad`` of grandtpu's ``embed_nodes``
    + ``random_prop`` on the same inputs and masks: K 1, 2, 8, input
    dropout on and off, colliding ids, and the rows of a vocab window
    (none of the ids in the last)."""
    _, args, g, _, want_grad = _jax_k3_case(num_aug, q, p, collide=collide)
    lo, hi = _WINDOWS[window]
    got = embed_prop_backward_plain(g, lo, hi, **args, droprate=q)
    assert got.shape == (hi - lo, g.shape[-1])
    if window == "none":
        assert not got.any()
    else:
        assert rel(got, np.asarray(want_grad)[lo:hi]) <= TOL
    # the id every entry holds when they collide carries the whole gradient
    if collide and window == "all":
        assert got[7].abs().max() > 0 and not got[torch.arange(30) != 7].any()


@pytest.mark.parametrize("droprate", [0.0, 0.5])
def test_embed_prop_backward_plain_node_form_matches_grandtpus_grad(
        droprate):
    """The node form's backward (``embed_nodes``' table gradient) against
    ``jax.grad`` of grandtpu's ``embed_nodes`` with the mask JAX draws."""
    _, table, ac, av = _table_and_attrs()
    key = jax.random.PRNGKey(4)
    g = np.random.RandomState(5).randn(ac.shape[0], table.shape[1]).astype(
        np.float32)

    def jloss(t):
        e = jsi.embed_nodes({"table": t}, jnp.asarray(ac), jnp.asarray(av),
                            key=key, droprate=droprate,
                            training=droprate > 0)
        return jnp.sum(e * jnp.asarray(g))

    want = jax.grad(jloss)(jnp.asarray(table))
    drop = None
    if droprate > 0:
        drop = torch.tensor(np.asarray(jax.random.bernoulli(
            key, 1.0 - droprate, (*ac.shape, table.shape[1]))))[None]
    got = embed_prop_backward_plain(torch.tensor(g)[None], 0, 30,
                                    torch.tensor(ac), torch.tensor(av),
                                    drop=drop, droprate=droprate)
    assert rel(got, want) <= TOL


def _k3_small(num_aug, q, node_form, collide, seed=0):
    """K3's inputs at a small size: 50 nodes of 24 attribute slots over a
    300-word vocabulary, a node without attributes, top-k padding and a
    row whose mask drops every slot."""
    rs = np.random.RandomState(seed)
    rows, ktop, p, h, vocab, n = 9, 7, 24, 16, 300, 50
    ac = rs.randint(0, vocab, (n, p)).astype(np.int32)
    if collide:
        ac[:] = 7
    av = rs.rand(n, p).astype(np.float32)
    av[:, p // 2:] *= rs.rand(n, p - p // 2) < 0.5
    av[3] = 0.0
    args = {"attr_cols": ac, "attr_vals": av}
    if node_form:
        args = {k: v[:rows] for k, v in args.items()}
        drop_shape = (num_aug, rows, p, h)
    else:
        tk = rs.randint(0, n, (rows, ktop)).astype(np.int32)
        tk[0, 0] = 3
        tv = rs.rand(rows, ktop).astype(np.float32)
        tv[-1, ktop // 2:] = 0.0
        keep = rs.rand(num_aug, rows, ktop) < 0.5
        keep[:, 1] = False
        args.update(tk_cols=tk, tk_vals=tv, keep=keep)
        drop_shape = (num_aug, rows, ktop, p, h)
    if q > 0:
        args["drop"] = rs.rand(*drop_shape) < 1.0 - q
    table = rs.randn(vocab, h).astype(np.float32)
    grad = rs.randn(num_aug, rows, h).astype(np.float32)
    return (torch.tensor(table), {k: torch.tensor(v) for k, v in
                                  args.items()}, torch.tensor(grad))


@pytest.mark.parametrize("window", [(0, 300), (5, 105), (300, 340)])
@pytest.mark.parametrize("num_aug,q,node_form,collide", [
    (1, 0.0, False, False), (2, 0.0, False, False), (2, 0.5, False, False),
    (8, 0.5, False, False), (2, 0.5, True, False), (8, 0.0, True, False),
    (2, 0.0, False, True),
])
def test_embed_prop_backward_plain_matches_autograd(num_aug, q, node_form,
                                                    collide, window):
    """The backward's plain version against autograd of the forward's plain
    version, over windows holding all, some and none of the ids."""
    table, args, grad = _k3_small(num_aug, q, node_form, collide)
    lo, hi = window
    t = (table[lo:hi] if hi <= 300 else torch.zeros(hi - lo, 16)).clone()
    t.requires_grad_(True)
    out = embed_prop_plain(t, **args, droprate=q, vocab_lo=lo, vocab_hi=hi)
    (out * grad).sum().backward()
    got = embed_prop_backward_plain(grad, lo, hi, **args, droprate=q)
    if hi > 300:
        assert not got.any() and not t.grad.any()
    else:
        assert t.grad.abs().max() > 0
        assert rel(got, t.grad) <= TOL


@pytest.mark.parametrize("window", [False, True])
def test_embed_prop_backward_wrappers_take_the_plain_version_on_the_cpu(
        window):
    """The backward's wrappers on CPU tensors return the plain version's
    gradient and launch nothing."""
    table, args, grad = _k3_small(2, 0.5, False, False)
    saved = (args["attr_cols"], args["attr_vals"], args["tk_cols"],
             args["tk_vals"], args["keep"], args["drop"], 0.5,
             (9, 7, 24, 16, 2))
    fn = embed_prop_window_backward if window else embed_prop_backward
    before = fn.launches
    got = (fn(grad, 100, 200, *saved) if window else fn(grad, 300, *saved))
    lo, hi = (100, 200) if window else (0, 300)
    want = embed_prop_backward_plain(grad, lo, hi, **args, droprate=0.5)
    assert torch.equal(got, want) and fn.launches == before


def test_bwd_scratch_bytes_counts_the_kernels_arrays():
    """The backward's scratch at the MAG step's shapes: the 1,280 slots'
    term vectors (K of them with input dropout) and four int32 or f32
    words for each of the 30,720 entries, plus four counters."""
    assert bwd_scratch_bytes(40, 32, 24, 64, 2, False) == 4 * (
        1280 * 64 + 4 * 30720 + 4)
    assert bwd_scratch_bytes(40, 32, 24, 64, 2, True) == 4 * (
        2 * 1280 * 64 + 4 * 30720 + 4)
    # each array padded to 16 bytes
    assert bwd_scratch_bytes(1, 1, 3, 1, 1, False) == 4 * (4 + 4 * 4 + 4)


# csrc/embed_prop.cu: an id's gradient row holds its first row_cap(H) =
# min(32, (H - 1) // 2) entries; a block reads the ids of a longer one's
# entries kThreads x 8 at a time
_LONG_BATCH = 256 * 8


def _kernels_grouping(keys, arrival, cap):
    """The K3 backward kernels' index steps on ``keys`` (each entry's id -
    lo; -1 for an entry that adds nothing), in numpy, with the atomics
    taken in ``arrival`` order: count (each entry's rank among its id's;
    ranks below ``cap`` into the id's row), sum (an id of up to ``cap``
    entries ordered by each one's rank among the row's), long (a longer id's
    entries listed by an ordered scan of the ids, a batch at a time).
    Returns {id: its entries in the order the sums add them}."""
    counts, rows = {}, {}
    for e in arrival:
        c = keys[e]
        if c >= 0:
            rank = counts.get(c, 0)
            counts[c] = rank + 1
            if rank < cap:
                rows.setdefault(c, {})[rank] = e
    order = {}
    for c, n in counts.items():
        if n <= cap:
            s = np.array([rows[c][r] for r in range(n)])
            got = np.empty_like(s)
            got[[int((s < x).sum()) for x in s]] = s
        else:
            got = np.concatenate([
                b0 + np.flatnonzero(keys[b0:b0 + _LONG_BATCH] == c)
                for b0 in range(0, keys.size, _LONG_BATCH)])
        order[c] = got
    return order


@pytest.mark.parametrize("cap", [31, 15, 0])
@pytest.mark.parametrize("ids", ["uniform", "skewed", "one_id", "windowed"])
def test_k3_backward_grouping_matches_a_stable_sort(ids, cap):
    """The kernels' grouping (ranks in whatever order the atomics take,
    then each id's entries put in entry order) gives every id its entries
    in the order of a stable sort of the ids, whatever the arrival order
    and the rows' capacity (31 at H 64, 15 at H 32, 0 at H 1 or 2):
    near-uniform ids, Zipf-like ids (``token_skew``), one id in every entry
    over 108 rounds of the long scan, and a window's dead entries."""
    rng = np.random.RandomState(cap)
    if ids == "one_id":
        keys = np.where(rng.rand(220000) < 0.6, 5, -1)
    elif ids == "skewed":
        _, feats, _ = synthetic_graph(num_nodes=600, num_classes=4,
                                      num_features=5000,
                                      sparse_features=True, token_skew=3.0,
                                      seed=cap)
        keys = feats.indices[rng.randint(0, feats.nnz, 30000)]
    else:
        keys = rng.randint(0, 20000, 30000)
        if ids == "windowed":
            keys = np.where((keys >= 5000) & (keys < 9000), keys - 5000, -1)
    if cap == 0 and ids != "one_id":
        keys = keys[:3000]                 # every id long: keep it short
    order = _kernels_grouping(keys, rng.permutation(keys.size), cap)
    live = np.flatnonzero(keys >= 0)
    stable = live[np.argsort(keys[live], kind="stable")]
    assert sorted(order) == sorted(set(keys[live]))
    got = np.concatenate([order[c] for c in sorted(order)])
    np.testing.assert_array_equal(got, stable)
    if ids in ("one_id", "skewed"):
        assert max(len(v) for v in order.values()) > cap


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
