"""grandtpu_torch.nn against grandtpu.nn on the same numpy-seeded inputs.

Tolerance: max |port - jax| / max |jax| <= 1e-5 (f32, sums in another
order) unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandtpu.nn import dropnode as jdrop
from grandtpu.nn import losses as jloss
from grandtpu.nn import mlp as jmlp

from grandtpu_torch.convert import mlp_from_jax, mlp_to_jax
from grandtpu_torch.nn import dropnode, losses
from grandtpu_torch.nn.mlp import MaskedBatchNorm, MLPConfig, init_mlp

TOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("nlayers,use_bn,node_norm", [
    (2, False, False), (1, True, True), (3, True, False), (2, True, True),
])
def test_mlp_forward_parity(nlayers, use_bn, node_norm):
    kw = dict(num_features=24, num_classes=5, hidden=16, nlayers=nlayers,
              use_bn=use_bn, node_norm=node_norm)
    jcfg = jmlp.MLPConfig(**kw)
    params, state = jmlp.init_mlp(jax.random.PRNGKey(0), jcfg)
    model = mlp_from_jax(_np_tree(params), _np_tree(state), MLPConfig(**kw),
                         "cpu")
    rs = np.random.RandomState(1)
    x = rs.randn(10, 24).astype(np.float32)
    mask = np.array([1] * 7 + [0] * 3, np.float32)

    model.eval()
    want, _ = jmlp.apply_mlp(params, state, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert rel(got, want) <= TOL

    model.train()
    want, new_state = jmlp.apply_mlp(params, state, jcfg, jnp.asarray(x),
                                     training=True,
                                     batch_mask=jnp.asarray(mask))
    got = model(torch.tensor(x), batch_mask=torch.tensor(mask))
    assert rel(got.detach(), want) <= TOL
    _, got_state = mlp_to_jax(model)
    for g, w in zip(got_state["bns"], new_state["bns"]):
        assert rel(g["mean"], w["mean"]) <= TOL
        assert rel(g["var"], w["var"]) <= TOL


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_parity(masked):
    rs = np.random.RandomState(2)
    x = rs.randn(9, 6).astype(np.float32) * 3 + 1
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 0], np.float32)
    p = {"scale": rs.rand(6).astype(np.float32) + 0.5,
         "bias": rs.randn(6).astype(np.float32)}
    s = {"mean": rs.randn(6).astype(np.float32),
         "var": rs.rand(6).astype(np.float32) + 0.5}
    want, want_s = jmlp._batchnorm(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p),
        jax.tree.map(jnp.asarray, s), True,
        jnp.asarray(mask) if masked else None)

    bn = MaskedBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(p["scale"]))
        bn.bias.copy_(torch.tensor(p["bias"]))
        bn.running_mean.copy_(torch.tensor(s["mean"]))
        bn.running_var.copy_(torch.tensor(s["var"]))
    got = bn(torch.tensor(x), torch.tensor(mask) if masked else None)
    assert rel(got.detach(), want) <= TOL
    assert rel(bn.running_mean, want_s["mean"]) <= TOL
    assert rel(bn.running_var, want_s["var"]) <= TOL


@pytest.mark.parametrize("kind", ["l2", "kl"])
@pytest.mark.parametrize("conf", [0.3, 1.1])   # 1.1: empty mask -> 0
def test_consis_loss_parity(kind, conf):
    rs = np.random.RandomState(3)
    logits = rs.randn(2, 11, 4).astype(np.float32) * 2
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    row_mask = (rs.rand(11) < 0.7).astype(np.float32)
    want = jloss.consis_loss(jnp.asarray(logp), 0.1, conf, kind,
                             row_mask=jnp.asarray(row_mask))
    got = losses.consis_loss(torch.tensor(logp), 0.1, conf, kind,
                             row_mask=torch.tensor(row_mask))
    assert np.isfinite(float(got))
    if conf > 1.0:
        assert float(got) == 0.0 == float(want)
    else:
        assert rel(got, want) <= TOL


def test_nll_loss_parity():
    rs = np.random.RandomState(4)
    logp = np.log(rs.dirichlet(np.ones(5), size=8)).astype(np.float32)
    labels = rs.randint(0, 5, 8).astype(np.int32)
    want = jloss.nll_loss(jnp.asarray(logp), jnp.asarray(labels))
    got = losses.nll_loss(torch.tensor(logp), torch.tensor(labels))
    assert rel(got, want) <= TOL


def _k1_inputs(seed=5, n=40, b=6, ktop=8, f=9):
    rs = np.random.RandomState(seed)
    features = rs.randn(n, f).astype(np.float32)
    cols = rs.randint(0, n, (b, ktop)).astype(np.int32)
    vals = rs.rand(b, ktop).astype(np.float32)
    vals[2, 5:] = 0.0                       # padding slots
    return features, cols, vals


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_k1_plain_matches_random_prop(rate):
    """K = 2 augmentations; the JAX keep masks are drawn in the test with
    the keys random_prop would use and handed to the port."""
    features, cols, vals = _k1_inputs()
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    want = np.stack([np.asarray(jdrop.gather_and_prop(
        jnp.asarray(features), jnp.asarray(cols), jnp.asarray(vals),
        key=k, dropnode_rate=rate, training=True)) for k in keys])
    keep = np.stack([np.asarray(jax.random.bernoulli(k, 1.0 - rate,
                                                     vals.shape))
                     for k in keys])
    got = dropnode.gather_and_prop(torch.tensor(features),
                                   torch.tensor(cols), torch.tensor(vals),
                                   torch.tensor(keep))
    assert got.shape == (2, 6, 9)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("num_aug", [1, 2, 8])
@pytest.mark.parametrize("nfeat", [9, 100])
def test_k1_plain_matches_random_prop_numpy_masks(num_aug, nfeat):
    """K = 1, 2 and 8 masks drawn with numpy, at F 9 and 100, against
    grandtpu's random_prop on the masked weights (a slot every mask drops,
    a row of padding, a row that mask 0 drops whole)."""
    features, cols, vals = _k1_inputs(seed=8, f=nfeat)
    rs = np.random.RandomState(9)
    keep = rs.rand(num_aug, *vals.shape) < 0.5
    keep[:, 1, 3] = False                   # dropped in every mask
    vals[4] = 0.0                           # padding only
    keep[0, 5] = False                      # mask 0 drops row 5
    feats = jnp.take(jnp.asarray(features), jnp.asarray(cols), axis=0)
    want = np.stack([np.asarray(jdrop.random_prop(
        feats, jnp.where(jnp.asarray(keep[k]), jnp.asarray(vals), 0.0)))
        for k in range(num_aug)])
    got = dropnode.gather_and_prop(torch.tensor(features),
                                   torch.tensor(cols), torch.tensor(vals),
                                   torch.tensor(keep))
    assert got.shape == (num_aug, 6, nfeat)
    assert rel(got, want) <= TOL
    assert float(got[:, 4].abs().max()) == 0.0
    assert float(got[0, 5].abs().max()) == 0.0


def test_k1_eval_form_and_cpu_dispatch():
    features, cols, vals = _k1_inputs(seed=6)
    want = jdrop.gather_and_prop(jnp.asarray(features), jnp.asarray(cols),
                                 jnp.asarray(vals), training=False)
    before = dropnode.gather_and_prop.launches
    got = dropnode.gather_and_prop(torch.tensor(features),
                                   torch.tensor(cols), torch.tensor(vals))
    assert got.shape == (1, 6, 9)
    assert rel(got[0], want) <= TOL
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert dropnode.gather_and_prop.launches == before


def test_init_mlp_bounds_and_seed():
    cfg = MLPConfig(num_features=30, num_classes=3, hidden=20, nlayers=2,
                    use_bn=True)
    a, b = init_mlp(cfg, 3, "cpu"), init_mlp(cfg, 3, "cpu")
    for fa, fb in zip(a.fcs, b.fcs):
        bound = 1.0 / np.sqrt(fa.in_features)
        assert torch.equal(fa.weight, fb.weight)
        assert float(fa.weight.detach().abs().max()) <= bound
        assert float(fa.bias.detach().abs().max()) <= bound
    params, state = mlp_to_jax(a)
    assert params["fcs"][0]["w"].shape == (30, 20)
    back = mlp_from_jax(params, state, cfg, "cpu")
    for pa, pb in zip(a.state_dict().values(), back.state_dict().values()):
        assert torch.equal(pa, pb)
