"""grandtpu_torch.train.step against grandtpu.train.step: deterministic
steps (every drop rate 0) from the same parameters and batches.

Tolerance: max |port - jax| / max |jax| <= 1e-5 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandtpu.nn import mlp as jmlp
from grandtpu.train import step as jstep

from grandtpu_torch.convert import mlp_from_jax, mlp_to_jax
from grandtpu_torch.nn.mlp import MLPConfig, init_mlp
from grandtpu_torch.train import step as tstep

TOL = 1e-5
N, F_, C, KTOP, N_SRC = 60, 12, 4, 6, 40


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _tables(seed=0):
    rs = np.random.RandomState(seed)
    features = rs.rand(N, F_).astype(np.float32)
    cols = rs.randint(0, N, (N_SRC, KTOP)).astype(np.int32)
    vals = rs.rand(N_SRC, KTOP).astype(np.float32)
    return rs, features, cols, vals


def _pair(mlp_kw, step_kw, lr=1e-2, wd=1e-3):
    """A JAX step and a port step from identical parameters."""
    jm, tm = jmlp.MLPConfig(**mlp_kw), MLPConfig(**mlp_kw)
    params, state = jmlp.init_mlp(jax.random.PRNGKey(1), jm)
    opt = jstep.make_optimizer(lr, wd)
    jfn = jstep.build_train_step(jstep.StepConfig(mlp=jm, **step_kw), opt)
    model = mlp_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), tm, "cpu")
    topt = tstep.make_optimizer(model, lr, wd)
    tfn = tstep.build_train_step(tstep.StepConfig(mlp=tm, **step_kw), model,
                                 topt)
    return (params, state, opt.init(params), jfn), (model, tfn)


@pytest.mark.parametrize("use_bn,clip,kind", [
    (True, 0.1, "kl"), (False, -1.0, "l2"), (True, -1.0, "l2"),
    (False, 0.05, "kl"),
])
def test_deterministic_step_parity(use_bn, clip, kind):
    rs, features, cols, vals = _tables()
    nt, ubs = 8, 10
    mlp_kw = dict(num_features=F_, num_classes=C, hidden=16, nlayers=2,
                  use_bn=use_bn, node_norm=True)
    step_kw = dict(k_aug=2, dropnode_rate=0.0, n_train=nt, lam=1.0,
                   warmup=10.0, tem=0.5, conf=2.0 / C, loss_kind=kind,
                   clip_norm=clip)
    (params, state, opt_state, jfn), (model, tfn) = _pair(mlp_kw, step_kw)
    gen = torch.Generator().manual_seed(0)
    tf, tc, tv = (torch.tensor(a) for a in (features, cols, vals))
    # two steps, so Adam's moments carry over; the second is past warmup,
    # where the ramp is clamped at lam
    for nb in (3.0, 40.0):
        rows = rs.randint(0, N_SRC, nt + ubs).astype(np.int32)
        labels = rs.randint(0, C, nt).astype(np.int32)
        lmask = np.array([1.0] * 6 + [0.0] * 2, np.float32)
        umask = np.array([1.0] * 9 + [0.0], np.float32)
        params, state, opt_state, jm = jfn(
            params, state, opt_state, jnp.asarray(features),
            jnp.asarray(cols), jnp.asarray(vals),
            {"rows": jnp.asarray(rows), "labels": jnp.asarray(labels),
             "label_mask": jnp.asarray(lmask),
             "unlabel_mask": jnp.asarray(umask)},
            jax.random.PRNGKey(2), nb)
        tm = tfn(tf, tc, tv, {"rows": torch.tensor(rows).long(),
                              "labels": torch.tensor(labels).long(),
                              "label_mask": torch.tensor(lmask),
                              "unlabel_mask": torch.tensor(umask)}, gen, nb)
        for name in ("loss", "sup_loss", "consis_loss", "grad_norm",
                     "train_acc"):
            assert rel(tm[name], jm[name]) <= TOL, name
    got_p, got_s = mlp_to_jax(model)
    for g, w in zip(got_p["fcs"], params["fcs"]):
        assert rel(g["w"], w["w"]) <= TOL and rel(g["b"], w["b"]) <= TOL
    # with use_bn off the BN parameters get zero gradients: in both
    # packages only the weight decay moves them
    for g, w in zip(got_p["bns"], params["bns"]):
        assert rel(g["scale"], w["scale"]) <= TOL
        assert rel(g["bias"], w["bias"]) <= TOL
    for g, w in zip(got_s["bns"], state["bns"]):
        assert rel(g["mean"], w["mean"]) <= TOL
        assert rel(g["var"], w["var"]) <= TOL


def test_padded_partial_batch_step_equals_true_batch():
    """A wrap-padded partial train batch gives the same loss, update and BN
    running stats as a step on the true smaller batch."""
    rs, features, cols, vals = _tables(seed=3)
    nt_true, nt_pad, ubs = 5, 8, 10
    mlp = MLPConfig(num_features=F_, num_classes=C, hidden=16, nlayers=2,
                    use_bn=True, node_norm=True)
    common = dict(k_aug=2, dropnode_rate=0.0, lam=1.0, warmup=10.0,
                  tem=0.1, conf=2.0 / C, loss_kind="l2", clip_norm=-1.0)
    tr = rs.randint(0, N_SRC, nt_true)
    un = rs.randint(0, N_SRC, ubs)
    labels = rs.randint(0, C, nt_true)
    reps = -(-nt_pad // nt_true)
    batches = {
        nt_true: {"rows": np.concatenate([tr, un]), "labels": labels,
                  "label_mask": np.ones(nt_true, np.float32)},
        nt_pad: {"rows": np.concatenate([np.tile(tr, reps)[:nt_pad], un]),
                 "labels": np.tile(labels, reps)[:nt_pad],
                 "label_mask": np.array([1.0] * nt_true
                                        + [0.0] * (nt_pad - nt_true),
                                        np.float32)},
    }
    out = {}
    for nt, batch in batches.items():
        model = init_mlp(mlp, 1, "cpu")
        opt = tstep.make_optimizer(model, 1e-2, 0.0)
        fn = tstep.build_train_step(
            tstep.StepConfig(mlp=mlp, n_train=nt, **common), model, opt)
        m = fn(*(torch.tensor(a) for a in (features, cols, vals)),
               {k: torch.tensor(v) if k == "label_mask"
                else torch.tensor(v).long() for k, v in batch.items()},
               torch.Generator().manual_seed(0), 3.0)
        out[nt] = (m, model.state_dict())
    (m_t, s_t), (m_p, s_p) = out[nt_true], out[nt_pad]
    assert rel(m_p["loss"], m_t["loss"]) <= TOL
    for k in s_t:
        assert rel(s_p[k], s_t[k]) <= TOL, k


def test_eval_step_parity():
    rs, features, cols, vals = _tables(seed=4)
    kw = dict(num_features=F_, num_classes=C, hidden=16, nlayers=2,
              use_bn=True, node_norm=True)
    jm = jmlp.MLPConfig(**kw)
    params, state = jmlp.init_mlp(jax.random.PRNGKey(5), jm)
    state = {"bns": [{"mean": jnp.asarray(rs.randn(d).astype(np.float32)),
                      "var": jnp.asarray(rs.rand(d).astype(np.float32) + .5)}
                     for d in (F_, 16)]}
    step_kw = dict(k_aug=2, dropnode_rate=0.5, n_train=4, lam=1.0,
                   warmup=1.0, tem=0.1, conf=0.5, loss_kind="l2",
                   clip_norm=-1.0)
    jev = jstep.build_eval_step(jstep.StepConfig(mlp=jm, **step_kw))
    model = mlp_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), MLPConfig(**kw),
                         "cpu")
    tev = tstep.build_eval_step(tstep.StepConfig(mlp=MLPConfig(**kw),
                                                 **step_kw), model)
    rows = rs.randint(0, N_SRC, 15).astype(np.int32)
    labels = rs.randint(0, C, 15).astype(np.int32)
    mask = (rs.rand(15) < 0.8).astype(np.float32)
    want = jev(params, state, jnp.asarray(features), jnp.asarray(cols),
               jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(labels),
               jnp.asarray(mask))
    got = tev(*(torch.tensor(a) for a in (features, cols, vals)),
              torch.tensor(rows).long(), torch.tensor(labels).long(),
              torch.tensor(mask))
    assert rel(got[0], want[0]) <= TOL
    assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-6)
