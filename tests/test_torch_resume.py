"""Resume, periodic saves and preemption of the port's training loop against
grandtpu's: the loops stop at the same step on a SIGTERM, ``latest.npz``
(weights, Adam state, meta) is read and written both ways, deterministic
resumed runs give grandtpu's history (every drop rate 0, the port started
from grandtpu's init), from either package's checkpoint, on one device and
on a vocab-sharded CPU mesh, and a resumed run that never improves tests
with ``best.npz``'s weights.

Tolerance: histories within 1e-5 (f32 sums in another order)."""

import dataclasses
import json
import os
import shutil
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
from grandtpu.train import checkpoint as jckpt
from grandtpu.train import loop as jloop
from grandtpu.train import step as jstep
from grandtpu.train import train as jax_train

from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import mag_from_jax, mlp_from_jax, mlp_to_jax
from grandtpu_torch.nn.mlp import MLP, MLPConfig, init_mlp
from grandtpu_torch.train import checkpoint as tckpt
from grandtpu_torch.train import loop as tloop
from grandtpu_torch.train import trainer as ttrainer
from grandtpu_torch.train import trainer_sparse as ttsparse
from grandtpu_torch.train.step import make_optimizer

TOL = 1e-5


def _npz_meta(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def _loop_kw(n_train=12, n_sample=6):
    return dict(train_positions=np.arange(n_train),
                sample_positions=np.arange(n_sample),
                train_labels_all=np.zeros(n_train, np.int32))


@pytest.mark.parametrize("save_every", [0, 2])
def test_preemption_stops_where_grandtpu_stops(tmp_path, save_every):
    """SIGTERM at the 5th step: both loops finish the step group in flight
    (up to the next eval), save latest.npz with the same next-step index,
    log ``preempted`` and stop; the handlers come back; a resume continues
    past it from the saved weights."""
    kw = dict(dataset="x", epochs=4, batch_size=4, unlabel_batch_size=2,
              eval_batch=3, patience=100, save_every=save_every)

    def fire(calls):
        calls["n"] += 1
        if calls["n"] == 5:
            os.kill(os.getpid(), signal.SIGTERM)

    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jcalls = {"n": 0}

    def jstep_fn(params, state, opt_state, batch, key, nb):
        fire(jcalls)
        return ({"w": params["w"] + 1.0}, state, opt_state,
                {"loss": np.float32(0.5)})

    jout = jloop.run_training_loop(
        JaxConfig(**kw, ckpt_dir=str(jdir),
                  metrics_path=str(jdir / "m.jsonl")),
        np.random.RandomState(0), jax.random.PRNGKey(0),
        params={"w": np.zeros(3, np.float32)}, state={}, opt_state={},
        step_fn=jstep_fn, eval_fn=lambda p, s: (0.4, 0.6),
        edges_per_step=1, verbose=lambda *a: None, **_loop_kw())

    model = MLP(MLPConfig(num_features=3, num_classes=2, hidden=4,
                          nlayers=2))
    opt = make_optimizer(model, 0.01, 0.0)
    tcalls = {"n": 0}

    def tstep_fn(batch, nb):
        fire(tcalls)
        with torch.no_grad():
            model.fcs[0].bias.add_(1.0)
        return {"loss": torch.tensor(0.5)}

    cfg = GrandConfig(**kw, ckpt_dir=str(tdir),
                      metrics_path=str(tdir / "m.jsonl"))
    tout = tloop.run_training_loop(
        cfg, np.random.RandomState(0), step_fn=tstep_fn,
        eval_fn=lambda: (0.4, 0.6), snapshot=lambda: None, device="cpu",
        verbose=lambda *a: None, model=model, optimizer=opt, **_loop_kw())

    assert tout["preempted"] is jout["preempted"] is True
    assert tout["num_batch"] == jout["num_batch"]
    assert 5 <= tout["num_batch"] < 12 and tcalls["n"] == jcalls["n"]
    assert (_npz_meta(tdir / "latest.npz")["num_batch"]
            == _npz_meta(jdir / "latest.npz")["num_batch"]
            == tout["num_batch"])
    for d in (jdir, tdir):
        lines = [json.loads(ln) for ln in open(d / "m.jsonl")]
        assert [ln.get("event") for ln in lines if "event" in ln] == [
            "preempted", "train_end"]
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.Handlers.SIG_DFL)
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler

    saved = float(model.fcs[0].bias.detach()[0])
    with torch.no_grad():
        model.fcs[0].bias.zero_()
    out2 = tloop.run_training_loop(
        cfg.replace(resume=True), np.random.RandomState(0),
        step_fn=lambda b, nb: {"loss": torch.tensor(0.5)},
        eval_fn=lambda: (0.4, 0.6), snapshot=lambda: None, device="cpu",
        verbose=lambda *a: None, model=model, optimizer=opt, **_loop_kw())
    assert out2["preempted"] is False
    assert out2["num_batch"] > tout["num_batch"]
    assert float(model.fcs[0].bias.detach()[0]) == saved


def _trained_port(mlp_cfg, weight_decay, steps=3):
    """A port MLP after a few real Adam steps (its moments non-zero)."""
    model = init_mlp(mlp_cfg, 0, "cpu")
    opt = make_optimizer(model, 0.01, weight_decay)
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        x = torch.randn(8, mlp_cfg.num_features, generator=gen)
        model.train()
        loss = model(x).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    return model, opt


@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_port_latest_reads_in_grandtpu(tmp_path, use_bn, weight_decay):
    """grandtpu's load_checkpoint takes the port's latest.npz: params,
    state, the optax Adam state (moments, count) and the meta equal the
    port's; unused BN parameters (``use_bn`` off) have zero moments."""
    mcfg = MLPConfig(num_features=6, num_classes=3, hidden=5, nlayers=3,
                     use_bn=use_bn, input_droprate=0.0, hidden_droprate=0.0)
    model, opt = _trained_port(mcfg, weight_decay)
    params, state, ost = tckpt.training_trees(model, opt, weight_decay)
    path = str(tmp_path / "latest.npz")
    tckpt.save_checkpoint(path, params=params, state=state, opt_state=ost,
                          num_batch=7, best_val_acc=0.5, best_val_loss=0.25)
    jp, js = jmlp.init_mlp(jax.random.PRNGKey(0),
                           JaxMLPConfig(**dataclasses.asdict(mcfg)))
    jo = jstep.make_optimizer(0.01, weight_decay).init(jp)
    lp, ls, lo, meta = jckpt.load_checkpoint(
        path, params_template=jp, state_template=js, opt_template=jo)
    assert meta["num_batch"] == 7 and meta["best_val_acc"] == 0.5
    adam = [s for s in lo if hasattr(s, "mu")][0]
    assert int(adam.count) == 3
    want_p, want_s = mlp_to_jax(model)
    for got, want in ((lp, want_p), (ls, want_s)):
        jax.tree.map(lambda g, w: np.testing.assert_array_equal(
            np.asarray(g), w), got, want)
    for i, fc in enumerate(model.fcs):
        st = opt.state[fc.weight]
        np.testing.assert_array_equal(np.asarray(adam.mu["fcs"][i]["w"]),
                                      st["exp_avg"].numpy().T)
        np.testing.assert_array_equal(np.asarray(adam.nu["fcs"][i]["b"]),
                                      opt.state[fc.bias]["exp_avg_sq"]
                                      .numpy())
    for i, bn in enumerate(model.bns):
        mu = np.asarray(adam.mu["bns"][i]["scale"])
        if use_bn:
            np.testing.assert_array_equal(
                mu, opt.state[bn.weight]["exp_avg"].numpy())
        else:
            assert bn.weight not in opt.state and not mu.any()


@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_grandtpu_latest_reads_in_the_port(tmp_path, use_bn, weight_decay):
    """The port restores grandtpu's latest.npz after optax Adam steps: the
    weights and the BN state, Adam's moments and step (a parameter Adam
    does not move gets no state), and the next step equals grandtpu's."""
    mcfg = MLPConfig(num_features=6, num_classes=3, hidden=5, nlayers=2,
                     use_bn=use_bn, input_droprate=0.0, hidden_droprate=0.0)
    jcfg = JaxMLPConfig(**dataclasses.asdict(mcfg))
    params, state = jmlp.init_mlp(jax.random.PRNGKey(1), jcfg)
    optimizer = jstep.make_optimizer(0.01, weight_decay)
    ost = optimizer.init(params)
    rs = np.random.RandomState(0)
    xs = [rs.randn(8, 6).astype(np.float32) for _ in range(4)]

    def jloss(p, s, x):
        out, s = jmlp.apply_mlp(p, s, jcfg, jnp.asarray(x), training=True)
        return jnp.mean(out ** 2), s

    def jstep_once(p, s, o, x):
        (_, s), g = jax.value_and_grad(jloss, has_aux=True)(p, s, x)
        u, o = optimizer.update(g, o, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s, o

    for x in xs[:3]:
        params, state, ost = jstep_once(params, state, ost, x)
    path = str(tmp_path / "latest.npz")
    jckpt.save_checkpoint(path, params=params, state=state, opt_state=ost,
                          num_batch=4, best_val_acc=0.75, best_val_loss=0.5)

    model = MLP(mcfg)
    opt = make_optimizer(model, 0.01, weight_decay)
    params_t, state_t = tckpt.training_templates(model)
    lp, ls, lo, meta = tckpt.load_checkpoint(
        path, params_template=params_t, state_template=state_t,
        opt_template=tckpt.adam_tree(params_t, weight_decay=weight_decay))
    assert meta["num_batch"] == 4
    tckpt.restore_training(model, opt, lp, ls, lo)
    got_p, got_s = mlp_to_jax(model)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(
        g, np.asarray(w)), (got_p, got_s), (params, state))
    adam = [s for s in ost if hasattr(s, "mu")][0]
    for i, fc in enumerate(model.fcs):
        st = opt.state[fc.weight]
        assert float(st["step"]) == 3.0
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy().T,
                                      np.asarray(adam.nu["fcs"][i]["w"]))
    assert all((bn.weight in opt.state) == use_bn for bn in model.bns)

    # the next Adam step from the restored state is grandtpu's next step
    params, state, ost = jstep_once(params, state, ost, xs[3])
    model.train()
    loss = model(torch.as_tensor(xs[3])).square().mean()
    opt.zero_grad()
    loss.backward()
    opt.step()
    got_p, _ = mlp_to_jax(model)
    if not use_bn:
        # grandtpu's optax decays the unused BN parameters and torch's Adam
        # skips them (ROADMAP Queue C "Unused BN parameters")
        got_p, params = got_p["fcs"], params["fcs"]
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=0, atol=1e-6), got_p, params)


def test_resume_restores_best_weights(tmp_path):
    """A resumed run that never improves keeps best.npz's weights as its
    best state, not latest.npz's (grandtpu's
    ``test_resume_restores_best_weights``)."""
    mcfg = MLPConfig(num_features=4, num_classes=2, hidden=4, nlayers=2)
    best_model, latest_model = init_mlp(mcfg, 1, "cpu"), init_mlp(mcfg, 2,
                                                                  "cpu")
    ck = tmp_path / "ck"
    bp, bs = mlp_to_jax(best_model)
    tckpt.save_checkpoint(str(ck / "best.npz"), params=bp, state=bs,
                          num_batch=5, best_val_acc=0.9)
    lp, ls = mlp_to_jax(latest_model)
    tckpt.save_checkpoint(str(ck / "latest.npz"), params=lp, state=ls,
                          num_batch=7, best_val_acc=0.9, best_val_loss=0.1)
    cfg = GrandConfig(epochs=1, batch_size=4, unlabel_batch_size=4,
                      eval_batch=1, patience=1, ckpt_dir=str(ck),
                      resume=True, stop_mode="acc")
    model = init_mlp(mcfg, 3, "cpu")
    calls = {"n": 0}

    def step_fn(batch, nb):
        calls["n"] += 1
        return {"loss": torch.tensor(1.0)}

    out = tloop.run_training_loop(
        cfg, np.random.RandomState(0), step_fn=step_fn,
        eval_fn=lambda: (1.0, 0.1),      # never improves on the restored 0.9
        snapshot=lambda: {k: v.clone()
                          for k, v in model.state_dict().items()},
        device="cpu", verbose=lambda *a: None, model=model,
        **_loop_kw(8, 8))
    assert calls["n"] >= 1 and out["best"]["acc"] == 0.9
    for k, v in best_model.state_dict().items():
        torch.testing.assert_close(out["best"]["state"][k], v, rtol=0,
                                   atol=0)
    # the model itself continued from latest.npz's weights
    assert torch.equal(model.fcs[1].bias, latest_model.fcs[1].bias)


# deterministic resumed runs of both packages

def _dense_cfg(cls, ck, **kw):
    return cls(dataset="synth:400:4:32", epochs=3, eval_batch=2,
               patience=100, stop_mode="acc", input_droprate=0.0,
               hidden_droprate=0.0, dropnode_rate=0.0, use_bn=True,
               node_norm=True, loss="kl", clip_norm=0.5, lr=0.01,
               unlabel_num=100, top_k=16, order=5, ckpt_dir=ck,
               save_every=1, **kw)


def _mag_cfg(cls, ck, dataset="synth:400:4:64:sparse", **kw):
    return cls(dataset=dataset, epochs=3, eval_batch=2,
               patience=100, stop_mode="acc", input_droprate=0.0,
               hidden_droprate=0.0, dropnode_rate=0.0, use_bn=True,
               node_norm=True, loss="kl", clip_norm=0.5, lr=0.01,
               unlabel_num=100, top_k=16, order=5, warmup=4.0,
               batch_size=40, unlabel_batch_size=60, ckpt_dir=ck,
               save_every=1, **kw)


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


def _close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["batch"] == w["batch"]
        for k in ("val_loss", "val_acc", "loss"):
            assert abs(g[k] - w[k]) <= TOL, (k, g, w)


def _two_legs(run, make_cfg, cls, ck, keep=None, **kw):
    """A run of 3 epochs, then a resumed one of 5: (first, resumed). With
    ``keep``, the first run's checkpoints are copied there before the
    resume overwrites them."""
    first = run(make_cfg(cls, ck, **kw))
    if keep is not None:
        shutil.copytree(ck, keep)
    return first, run(make_cfg(cls, ck, resume=True, **kw).replace(
        epochs=5))


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_resumed_history_matches_grandtpu(tmp_path, jax_init, engine):
    """Each package trains, saves latest.npz at every eval, and is resumed:
    the resumed histories and step counts agree; a port run resumed from
    grandtpu's checkpoint equals one resumed from its own."""
    make_cfg = _dense_cfg if engine == "dense" else _mag_cfg
    jdir, tdir, xdir = (str(tmp_path / d) for d in "jtx")
    jfirst, jres = _two_legs(jax_train, make_cfg, JaxConfig, jdir, keep=xdir)
    port = lambda cfg: ttrainer.train(cfg, device="cpu")  # noqa: E731
    tfirst, tres = _two_legs(port, make_cfg, GrandConfig, tdir)
    _close(tfirst.history, jfirst.history)
    _close(tres.history, jres.history)
    assert tres.num_batches == jres.num_batches
    # latest.npz holds the step after the first leg's last eval, and the
    # resumed run evaluates next at the eval step after it
    saved = _npz_meta(os.path.join(xdir, "latest.npz"))["num_batch"]
    assert saved == tfirst.history[-1]["batch"] + 1
    assert tres.history[0]["batch"] == saved - 1 + 2
    # the port resumed from grandtpu's first-leg files
    cross = port(make_cfg(GrandConfig, xdir, resume=True).replace(epochs=5))
    _close(cross.history, tres.history)


def test_mag_resumed_on_a_vocab_mesh_equals_one_device(tmp_path, jax_init):
    """MAG on a 2-shard vocab-sharded CPU mesh: its latest.npz holds the
    padded table and moments with the row_padded meta, a resume scatters
    them back to the shards, and the resumed history equals the
    one-device run's; each resumes from the other's checkpoint too."""
    port = lambda cfg: ttrainer.train(cfg, device="cpu")  # noqa: E731
    one, mesh, keep, keep2 = (str(tmp_path / d) for d in
                              ("one", "mesh", "keep", "keep2"))
    odd = "synth:400:4:63:sparse"       # a vocabulary the mesh row-pads
    _, res1 = _two_legs(port, _mag_cfg, GrandConfig, one, keep=keep,
                        dataset=odd)
    _, res2 = _two_legs(port, _mag_cfg, GrandConfig, mesh, keep=keep2,
                        num_devices=2, dataset=odd)
    _close(res2.history, res1.history)
    meta = _npz_meta(os.path.join(mesh, "latest.npz"))
    assert any(k.startswith("opt|") for k in meta["__row_padded__"])
    # the mesh resumed from the one-device run's first-leg files
    cross = port(_mag_cfg(GrandConfig, keep, resume=True, num_devices=2,
                          dataset=odd).replace(epochs=5))
    _close(cross.history, res1.history)
    # and one device from the mesh's padded files
    cross = port(_mag_cfg(GrandConfig, keep2, resume=True,
                          dataset=odd).replace(epochs=5))
    _close(cross.history, res1.history)
