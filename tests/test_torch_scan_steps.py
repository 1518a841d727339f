"""``scan_steps`` in the port against grandtpu's: the rolling policy (its
constants, which groups roll and when), the port's rolled run against its
per-step run (equal: on the CPU a rolled group runs its steps one by one
from the group's buffers, with the same arithmetic), the port's rolled run
against grandtpu's ``lax.scan`` run, the step with a tensor step index
against grandtpu's step, resume and preemption with rolled groups, and the
option ignored on a mesh.

Tolerance: max |port - jax| / max |jax| <= 1e-5 (f32), histories within
1e-5 relative; the port against itself bit for bit, with one CPU thread
(the MAG engine's CPU backward scatter-adds in parallel)."""

import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandtpu.config import GrandConfig as JaxConfig
from grandtpu.nn import mag_mlp as jmag
from grandtpu.nn import mlp as jmlp
from grandtpu.nn.mlp import MLPConfig as JaxMLPConfig
from grandtpu.train import loop as jloop
from grandtpu.train import step as jstep
from grandtpu.train import train as jax_train
from grandtpu.train import trainer_sparse as jts

from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import mag_from_jax, mlp_from_jax
from grandtpu_torch.nn.mlp import MLP, MLPConfig
from grandtpu_torch.train import loop as tloop
from grandtpu_torch.train import step as tstep
from grandtpu_torch.train import trainer as ttrainer
from grandtpu_torch.train import trainer_sparse as ttsparse

TOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trainers start from grandtpu's init."""
    def dense(mlp_cfg, seed, device):
        _, key = jax.random.split(jax.random.PRNGKey(seed))
        p, s = jmlp.init_mlp(key, JaxMLPConfig(**dataclasses.asdict(mlp_cfg)))
        return mlp_from_jax(jax.tree.map(np.asarray, p),
                            jax.tree.map(np.asarray, s), mlp_cfg, device)

    def mag(mlp_cfg, seed, device):
        _, key = jax.random.split(jax.random.PRNGKey(seed))
        p, s = jmag.init_mag_mlp(key,
                                 JaxMLPConfig(**dataclasses.asdict(mlp_cfg)))
        return mag_from_jax(jax.tree.map(np.asarray, p),
                            jax.tree.map(np.asarray, s), mlp_cfg, device)

    monkeypatch.setattr(ttrainer, "init_mlp", dense)
    monkeypatch.setattr(ttsparse, "init_mag_mlp", mag)


def _python_scan(step_fn):
    """grandtpu's ``_build_multi_step`` with the steps run one by one in
    Python, so that a recording step sees them (its loop is unchanged)."""
    def multi(params, state, opt_state, batches, keys, nbs, *operands):
        losses = []
        for i in range(len(nbs)):
            batch = {k: v[i] for k, v in batches.items()}
            params, state, opt_state, m = step_fn(
                params, state, opt_state, batch, keys[i], nbs[i], *operands)
            losses.append(m["loss"])
        return params, state, opt_state, {"loss": jnp.stack(losses)}
    return multi


def test_scan_constants_are_grandtpus():
    assert tloop.SCAN_COMPILE_THRESHOLD == jloop.SCAN_COMPILE_THRESHOLD == 3
    assert tloop.MAX_SCAN_SIZES == jloop.MAX_SCAN_SIZES == 2


@pytest.mark.parametrize("epochs,n_train,batch_size,eval_batch,patience", [
    (6, 20, 3, 4, 100),     # 7 steps an epoch: lengths 4 and 3, then more
    (8, 30, 4, 3, 100),     # 8 steps: the epoch ends inside a group
    (6, 16, 2, 5, 100),     # 8 steps, eval every 5: epoch ends cut groups
    (12, 24, 5, 2, 3),      # early stop inside a rolled length
])
def test_scan_policy_matches_grandtpu(monkeypatch, epochs, n_train,
                                      batch_size, eval_batch, patience):
    """With the same batches and scripted evals both loops roll the same
    groups at the same steps, run the others step by step, and stop at the
    same step; the port's rolled lengths are at most 2, each first rolled
    at its third occurrence."""
    kw = dict(epochs=epochs, batch_size=batch_size, unlabel_batch_size=3,
              eval_batch=eval_batch, patience=patience, stop_mode="acc",
              scan_steps=True)
    rs = np.random.RandomState(1)
    train_pos = rs.permutation(60)[:n_train]
    sample_pos = 60 + rs.permutation(20)[:9]
    labels_all = rs.randint(0, 3, n_train)
    evals = [(1.0, 0.5 + 0.01 * (i % 3 == 0) - 0.3 * (i > 4))
             for i in range(200)]

    jev, jlog = iter(evals), []
    scanning = {"on": False}

    def jstep_fn(params, state, opt_state, batch, key, nb):
        jlog.append(("scan" if scanning["on"] else "step", float(nb),
                     np.asarray(batch["rows"]).tolist()))
        return params, state, opt_state, {"loss": jnp.float32(0.0)}

    def jscan(step_fn):
        multi = _python_scan(step_fn)

        def run(*args):
            scanning["on"] = True
            try:
                return multi(*args)
            finally:
                scanning["on"] = False
        return run

    monkeypatch.setattr(jloop, "_build_multi_step", jscan)
    jout = jloop.run_training_loop(
        JaxConfig(**kw), np.random.RandomState(5), jax.random.PRNGKey(0),
        params={}, state={}, opt_state={}, step_fn=jstep_fn,
        eval_fn=lambda p, s: next(jev), train_positions=train_pos,
        sample_positions=sample_pos, train_labels_all=labels_all,
        edges_per_step=1, verbose=lambda *a: None)

    tev, tlog, in_group = iter(evals), [], {"on": False}
    group_call, rolls = tloop.StepGroup.__call__, tloop.scan_rolls
    decisions = []

    def recording_call(self, *args):
        in_group["on"] = True
        try:
            return group_call(self, *args)
        finally:
            in_group["on"] = False

    def recording_rolls(seen, sizes, k):
        decisions.append((k, rolls(seen, sizes, k)))
        return decisions[-1][1]

    monkeypatch.setattr(tloop.StepGroup, "__call__", recording_call)
    monkeypatch.setattr(tloop, "scan_rolls", recording_rolls)

    def tstep_fn(batch, nb):
        assert nb.dtype == torch.float32 and nb.dim() == 0
        tlog.append(("scan" if in_group["on"] else "step", float(nb),
                     batch["rows"].tolist()))
        return {"loss": torch.tensor(0.0)}

    tout = tloop.run_training_loop(
        GrandConfig(**kw), np.random.RandomState(5), step_fn=tstep_fn,
        eval_fn=lambda: next(tev), snapshot=lambda: None,
        train_positions=train_pos, sample_positions=sample_pos,
        train_labels_all=labels_all, device="cpu", verbose=lambda *a: None)

    assert tlog == jlog
    assert any(kind == "scan" for kind, *_ in tlog)
    assert tout["num_batch"] == jout["num_batch"]
    assert tout["history"] == jout["history"]
    rolled = tout["scan_groups"]
    assert 0 < len(rolled) <= tloop.MAX_SCAN_SIZES
    for k in {k for k, _ in decisions}:
        seen = [r for length, r in decisions if length == k]
        if k in rolled:
            # a rolled length runs step by step until its third group
            assert k > 1 and seen[:2] == [False, False] and all(seen[2:])
            assert rolled[k]["runs"] == len(seen) - 2
            assert not rolled[k]["graph"]
        else:
            assert not any(seen)


def _dense_cfg(cls, **kw):
    return cls(dataset="synth:400:4:32", epochs=8, eval_batch=3,
               patience=100, stop_mode="acc", input_droprate=0.0,
               hidden_droprate=0.0, dropnode_rate=0.0, use_bn=True,
               node_norm=True, loss="kl", clip_norm=0.5, lr=0.01,
               unlabel_num=100, top_k=16, order=5, **kw)


def _mag_cfg(cls, **kw):
    return cls(dataset="synth:400:4:64:sparse", epochs=6, eval_batch=4,
               patience=100, stop_mode="acc", input_droprate=0.0,
               hidden_droprate=0.0, dropnode_rate=0.0, use_bn=True,
               node_norm=True, loss="kl", clip_norm=0.5, lr=0.01,
               unlabel_num=100, top_k=16, order=5, warmup=4.0,
               batch_size=20, unlabel_batch_size=30, **kw)


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_scan_run_equals_per_step_run(one_thread, engine):
    """train(scan_steps=True) on the CPU, every drop rate on: the same
    history, step count, test accuracy and final parameters as the
    per-step run, bit for bit; some group length was rolled."""
    if engine == "dense":
        cfg = GrandConfig(dataset="synth:400:4:32", epochs=8, eval_batch=3,
                          patience=100, dropnode_rate=0.5,
                          input_droprate=0.2, hidden_droprate=0.3)
    else:
        cfg = _mag_cfg(GrandConfig).replace(dropnode_rate=0.5,
                                            input_droprate=0.2,
                                            hidden_droprate=0.3)
    per_step = ttrainer.train(cfg, device="cpu")
    rolled = ttrainer.train(cfg.replace(scan_steps=True), device="cpu")
    assert rolled.history == per_step.history and rolled.history
    assert rolled.num_batches == per_step.num_batches
    assert rolled.test_acc == per_step.test_acc
    assert rolled.scan_groups and not per_step.scan_groups
    assert all(s["runs"] > 0 for s in rolled.scan_groups.values())
    want = per_step.model.state_dict()
    for k, v in rolled.model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_scan_run_matches_grandtpu(jax_init, engine):
    """The port's train(scan_steps=True) against grandtpu's (its groups a
    jitted lax.scan), every drop rate 0 and the port started from
    grandtpu's init: the histories within 1e-5 relative, the same step
    count, and both rolled groups."""
    make = _dense_cfg if engine == "dense" else _mag_cfg
    want = jax_train(make(JaxConfig, scan_steps=True))
    got = ttrainer.train(make(GrandConfig, scan_steps=True), device="cpu")
    assert got.scan_groups
    assert got.num_batches == want.num_batches
    assert len(got.history) == len(want.history) > 0
    for g, w in zip(got.history, want.history):
        assert g["batch"] == w["batch"]
        for k in ("val_loss", "val_acc", "loss"):
            assert abs(g[k] - w[k]) <= TOL * max(abs(w[k]), 1.0), (k, g, w)


@pytest.mark.parametrize("nb", [0.0, 3.0, 7.0, 250.0, 1e4])
def test_ramps_are_grandtpus(nb):
    """Both engines' warmup ramps from a 0-d f32 step index equal
    grandtpu's f32 expressions bit for bit."""
    lam, warmup = 1.5, 7.0
    t = torch.tensor(nb, dtype=torch.float32)
    n = jnp.float32(nb)
    assert float(tstep.warmup_ramp(t, "cpu", lam, warmup)) == float(
        jnp.minimum(lam, lam * n / warmup))
    assert float(ttsparse._mag_ramp(t, "cpu", lam, warmup)) == float(
        jnp.minimum(1.0, n / warmup) * lam)
    assert float(tstep.warmup_ramp(nb, "cpu", lam, warmup)) == float(
        tstep.warmup_ramp(t, "cpu", lam, warmup))


def _dense_pair(lr=1e-2, wd=1e-3):
    n, f, c = 60, 12, 4
    rs = np.random.RandomState(0)
    tabs = (rs.rand(n, f).astype(np.float32),
            rs.randint(0, n, (40, 6)).astype(np.int32),
            rs.rand(40, 6).astype(np.float32))
    mlp_kw = dict(num_features=f, num_classes=c, hidden=16, nlayers=2,
                  use_bn=True, node_norm=True)
    step_kw = dict(k_aug=2, dropnode_rate=0.0, n_train=8, lam=1.0,
                   warmup=10.0, tem=0.5, conf=2.0 / c, loss_kind="kl",
                   clip_norm=0.1)
    jm, tm = JaxMLPConfig(**mlp_kw), MLPConfig(**mlp_kw)
    params, state = jmlp.init_mlp(jax.random.PRNGKey(1), jm)
    opt = jstep.make_optimizer(lr, wd)
    jfn = jstep.build_train_step(jstep.StepConfig(mlp=jm, **step_kw), opt)
    model = mlp_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), tm, "cpu")
    tfn = tstep.build_train_step(tstep.StepConfig(mlp=tm, **step_kw), model,
                                 tstep.make_optimizer(model, lr, wd))
    return rs, tabs, (params, state, opt.init(params), jfn), (model, tfn)


def _mag_pair(lr=1e-2, wd=1e-3):
    import scipy.sparse as sp
    from grandtpu_torch.nn.sparse_input import PaddedFeatures

    rs = np.random.RandomState(0)
    m = (rs.rand(60, 40) < 0.15) * rs.rand(60, 40)
    padded = PaddedFeatures.from_csr(sp.csr_matrix(m.astype(np.float32)))
    tabs = (padded.attr_cols, padded.attr_vals,
            rs.randint(0, 60, (40, 6)).astype(np.int32),
            rs.rand(40, 6).astype(np.float32))
    common = dict(batch_size=8, unlabel_batch_size=10, sample=2,
                  dropnode_rate=0.0, input_droprate=0.0, hidden_droprate=0.0,
                  lam=1.0, warmup=10.0, tem=0.5, loss="kl", clip_norm=0.1,
                  use_bn=True, node_norm=True, nlayers=2, hidden=16, lr=lr,
                  weight_decay=wd)
    mkw = dict(num_features=40, num_classes=4, hidden=16, nlayers=2,
               use_bn=True, node_norm=True)
    params, state = jmag.init_mag_mlp(jax.random.PRNGKey(1),
                                      JaxMLPConfig(**mkw))
    opt = jstep.make_optimizer(lr, wd)
    jfn = jts._build_sparse_steps(JaxMLPConfig(**mkw), JaxConfig(**common),
                                  opt, 4)[0]
    model = mag_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), MLPConfig(**mkw),
                         "cpu")
    tfn = ttsparse.build_sparse_steps(GrandConfig(**common), model,
                                      tstep.make_optimizer(model, lr, wd),
                                      4)[0]
    return rs, tabs, (params, state, opt.init(params), jfn), (model, tfn)


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_step_with_tensor_index_matches_grandtpu(engine):
    """Three Adam steps with the step index a 0-d f32 tensor (inside the
    warmup ramp, at its end, past it) against grandtpu's step given the
    f32 index: the losses and the parameters within 1e-5."""
    rs, tabs, (params, state, ost, jfn), (model, tfn) = (
        _dense_pair() if engine == "dense" else _mag_pair())
    gen = torch.Generator().manual_seed(0)
    for nb in (3.0, 10.0, 40.0):
        nt, ubs = 8, 10
        b = {"rows": rs.randint(0, 40, nt + ubs).astype(np.int32),
             "labels": rs.randint(0, 4, nt).astype(np.int32),
             "label_mask": np.array([1.0] * 6 + [0.0] * 2, np.float32),
             "unlabel_mask": np.array([1.0] * 9 + [0.0], np.float32)}
        params, state, ost, jm = jfn(
            params, state, ost, *(jnp.asarray(a) for a in tabs),
            {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(2), jnp.float32(nb))
        tb = {k: torch.tensor(v).long() if k in ("rows", "labels")
              else torch.tensor(v) for k, v in b.items()}
        tm = tfn(*(torch.tensor(a) for a in tabs), tb, gen,
                 torch.tensor(nb, dtype=torch.float32))
        jloss = jm["loss"] if engine == "dense" else jm
        assert rel(tm["loss"], jloss) <= TOL, nb
    got = [p.detach().numpy() for p in model.fcs.parameters()]
    if engine == "dense":
        want = [a for fc in params["fcs"] for a in (fc["w"].T, fc["b"])]
    else:
        assert rel(model.table.detach(), params["emb"]["table"]) <= TOL
        want = [a for fc in params["fcs"] for a in (fc["w"].T, fc["b"])]
    for g, w in zip(got, want, strict=True):
        assert rel(g, w) <= TOL


def _npz_meta(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_scan_resume_equals_per_step_resume(tmp_path, one_thread, jax_init,
                                            engine):
    """A scan_steps run saved at every eval and resumed with scan_steps:
    both legs equal the per-step legs bit for bit, the saved step index is
    the same, and the resumed history holds to grandtpu's resumed
    scan_steps run within 1e-5."""
    make = _dense_cfg if engine == "dense" else _mag_cfg

    def legs(cls, run, ck, **kw):
        first = run(make(cls, ckpt_dir=ck, save_every=1, **kw).replace(
            epochs=3))
        saved = _npz_meta(os.path.join(ck, "latest.npz"))["num_batch"]
        return first, saved, run(make(cls, ckpt_dir=ck, save_every=1,
                                      resume=True, **kw).replace(epochs=5))

    port = lambda cfg: ttrainer.train(cfg, device="cpu")  # noqa: E731
    f1, s1, r1 = legs(GrandConfig, port, str(tmp_path / "s"),
                      scan_steps=True)
    f2, s2, r2 = legs(GrandConfig, port, str(tmp_path / "p"))
    assert r1.scan_groups
    assert (f1.history, s1, r1.history, r1.num_batches) == (
        f2.history, s2, r2.history, r2.num_batches)
    _, sj, rj = legs(JaxConfig, jax_train, str(tmp_path / "j"),
                     scan_steps=True)
    assert sj == s1 and rj.num_batches == r1.num_batches
    for g, w in zip(r1.history, rj.history, strict=True):
        assert g["batch"] == w["batch"]
        for k in ("val_loss", "val_acc", "loss"):
            assert abs(g[k] - w[k]) <= TOL * max(abs(w[k]), 1.0), (k, g, w)


@pytest.mark.parametrize("save_every", [0, 2])
def test_preemption_in_a_rolled_group(tmp_path, monkeypatch, save_every):
    """SIGTERM during a rolled group: both loops finish the group, save
    latest.npz with the same next-step index and stop; a resume with
    scan_steps continues from the saved weights."""
    kw = dict(dataset="x", epochs=6, batch_size=2, unlabel_batch_size=2,
              eval_batch=3, patience=100, save_every=save_every,
              scan_steps=True)
    # 6 steps an epoch, groups of 1, 3, 2: the third group of length 3
    # (steps 13-15, calls 14-16) is the first rolled one
    fire_at = 15

    def fire(calls):
        calls["n"] += 1
        if calls["n"] == fire_at:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(jloop, "_build_multi_step", _python_scan)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jcalls = {"n": 0}

    def jstep_fn(params, state, opt_state, batch, key, nb):
        fire(jcalls)
        return ({"w": params["w"] + 1.0}, state, opt_state,
                {"loss": jnp.float32(0.5)})

    loop_kw = dict(train_positions=np.arange(12),
                   sample_positions=np.arange(6),
                   train_labels_all=np.zeros(12, np.int32))
    jout = jloop.run_training_loop(
        JaxConfig(**kw, ckpt_dir=str(jdir)), np.random.RandomState(0),
        jax.random.PRNGKey(0), params={"w": np.zeros(3, np.float32)},
        state={}, opt_state={}, step_fn=jstep_fn,
        eval_fn=lambda p, s: (0.4, 0.6), edges_per_step=1,
        verbose=lambda *a: None, **loop_kw)

    model = MLP(MLPConfig(num_features=3, num_classes=2, hidden=4,
                          nlayers=2))
    opt = tstep.make_optimizer(model, 0.01, 0.0)
    tcalls = {"n": 0}

    def tstep_fn(batch, nb):
        fire(tcalls)
        with torch.no_grad():
            model.fcs[0].bias.add_(1.0)
        return {"loss": torch.tensor(0.5)}

    cfg = GrandConfig(**kw, ckpt_dir=str(tdir))
    tout = tloop.run_training_loop(
        cfg, np.random.RandomState(0), step_fn=tstep_fn,
        eval_fn=lambda: (0.4, 0.6), snapshot=lambda: None, device="cpu",
        verbose=lambda *a: None, model=model, optimizer=opt, **loop_kw)
    assert tout["preempted"] is jout["preempted"] is True
    assert tout["num_batch"] == jout["num_batch"] == 16
    assert tcalls["n"] == jcalls["n"] == 16
    assert tout["scan_groups"][3]["runs"] == 1
    assert (_npz_meta(tdir / "latest.npz")["num_batch"]
            == _npz_meta(jdir / "latest.npz")["num_batch"] == 16)
    saved = float(model.fcs[0].bias.detach()[0])
    with torch.no_grad():
        model.fcs[0].bias.zero_()
    out2 = tloop.run_training_loop(
        cfg.replace(resume=True), np.random.RandomState(0),
        step_fn=lambda b, nb: {"loss": torch.tensor(0.5)},
        eval_fn=lambda: (0.4, 0.6), snapshot=lambda: None, device="cpu",
        verbose=lambda *a: None, model=model, optimizer=opt, **loop_kw)
    assert not out2["preempted"] and out2["num_batch"] > 16
    assert float(model.fcs[0].bias.detach()[0]) == saved


def test_scan_steps_ignored_on_a_mesh():
    """On a 2-shard CPU mesh scan_steps is kept and ignored (a verbose line
    says so): no group is rolled and the run equals the mesh's per-step
    run."""
    cfg = GrandConfig(dataset="synth:400:4:32", epochs=4, eval_batch=2,
                      patience=100, num_devices=2)
    logs = []
    got = ttrainer.train(cfg.replace(scan_steps=True), device="cpu",
                         log=logs.append)
    want = ttrainer.train(cfg, device="cpu")
    assert any("scan_steps is ignored on a mesh" in str(m) for m in logs)
    assert got.scan_groups == {} and got.history == want.history
