"""The port's MAG engine against grandtpu's: deterministic train and eval
steps (every drop rate 0) from the same parameters and batches, the
embedding-space predict, ``train()`` end to end on a sparse ``synth``
graph, and the CLI.

Tolerance: max |port - jax| / max |jax| <= 1e-5 (f32) for one step;
|d val_loss| <= 1e-4 over a whole run (errors compound over steps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from grandtpu.config import GrandConfig as JaxConfig
from grandtpu.infer import classify as jclassify
from grandtpu.nn import mag_mlp as jmag
from grandtpu.nn.mlp import MLPConfig as JaxMLPConfig
from grandtpu.nn.sparse_input import PaddedFeatures as JaxPadded
from grandtpu.train import step as jstep
from grandtpu.train import trainer_sparse as jts
from grandtpu.train import train as jax_train

from grandtpu_torch.cli.main import cli
from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import mag_from_jax, mag_to_jax
from grandtpu_torch.data import load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.infer import predict_logits_sparse
from grandtpu_torch.nn.mag_mlp import MagMLP
from grandtpu_torch.nn.mlp import MLPConfig
from grandtpu_torch.nn.sparse_input import PaddedFeatures
from grandtpu_torch.train import step as tstep
from grandtpu_torch.train import trainer as ttrainer
from grandtpu_torch.train import trainer_sparse as ttsparse

TOL = 1e-5
V, C, N, KTOP, N_SRC = 40, 4, 60, 6, 40


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _tables(seed=0):
    rs = np.random.RandomState(seed)
    m = (rs.rand(N, V) < 0.15) * rs.rand(N, V)
    m[2] = 0.0                                 # a node with no attributes
    padded = PaddedFeatures.from_csr(sp.csr_matrix(m.astype(np.float32)))
    tk_cols = rs.randint(0, N, (N_SRC, KTOP)).astype(np.int32)
    tk_vals = rs.rand(N_SRC, KTOP).astype(np.float32)
    tk_vals[:, -1] = 0.0                       # a padding slot per row
    return rs, (padded.attr_cols, padded.attr_vals, tk_cols, tk_vals)


def _batch(rs, nt, ubs):
    return {"rows": rs.randint(0, N_SRC, nt + ubs).astype(np.int32),
            "labels": rs.randint(0, C, nt).astype(np.int32),
            "label_mask": np.array([1.0] * (nt - 2) + [0.0] * 2, np.float32),
            "unlabel_mask": np.array([1.0] * (ubs - 1) + [0.0], np.float32)}


def _torch_batch(b):
    return {k: torch.tensor(v).long() if k in ("rows", "labels")
            else torch.tensor(v) for k, v in b.items()}


_CAPTURE = optax.GradientTransformation(   # keeps the grads as its state
    lambda p: jax.tree.map(jnp.zeros_like, p),
    lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _pair(nlayers, use_bn, clip, kind, optimizer, lr=1e-2, wd=1e-3):
    """A JAX MAG step pair and the port's, from identical parameters."""
    nt, ubs = 8, 10
    common = dict(batch_size=nt, unlabel_batch_size=ubs, sample=2,
                  dropnode_rate=0.0, input_droprate=0.0, hidden_droprate=0.0,
                  lam=1.0, warmup=10.0, tem=0.5, loss=kind, clip_norm=clip,
                  use_bn=use_bn, node_norm=True, nlayers=nlayers, hidden=16,
                  lr=lr, weight_decay=wd)
    mkw = dict(num_features=V, num_classes=C, hidden=16, nlayers=nlayers,
               use_bn=use_bn, node_norm=True)
    params, state = jmag.init_mag_mlp(jax.random.PRNGKey(1),
                                      JaxMLPConfig(**mkw))
    jopt = jstep.make_optimizer(lr, wd) if optimizer == "adam" else _CAPTURE
    jfns = jts._build_sparse_steps(JaxMLPConfig(**mkw), JaxConfig(**common),
                                   jopt, C)
    model = mag_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), MLPConfig(**mkw),
                         "cpu")
    topt = (tstep.make_optimizer(model, lr, wd) if optimizer == "adam"
            else torch.optim.SGD(model.parameters(), lr=0.0))
    tfns = ttsparse.build_sparse_steps(GrandConfig(**common), model, topt, C)
    return (params, state, jopt.init(params), jfns), (model, tfns), (nt, ubs)


@pytest.mark.parametrize("nlayers,use_bn,clip,kind", [
    (2, True, 0.1, "kl"), (2, False, -1.0, "l2"), (3, True, -1.0, "l2"),
    (1, False, 0.05, "kl"),
])
def test_train_step_grads_match_grandtpu(nlayers, use_bn, clip, kind):
    """Loss and the (clipped) table and fc gradients of one step."""
    rs, tabs = _tables()
    (params, state, opt_state, (jtrain, _)), (model, (ttrain, _)), (nt, ubs) \
        = _pair(nlayers, use_bn, clip, kind, "capture")
    b = _batch(rs, nt, ubs)
    _, _, grads, jloss = jtrain(params, state, opt_state,
                                *(jnp.asarray(a) for a in tabs),
                                {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(2), 3.0)
    m = ttrain(*(torch.tensor(a) for a in tabs), _torch_batch(b),
               torch.Generator().manual_seed(0), 3.0)
    assert rel(m["loss"], jloss) <= TOL
    assert rel(model.table.grad, grads["emb"]["table"]) <= TOL
    assert float(jnp.abs(grads["emb"]["table"]).max()) > 0.0
    for fc, g in zip(model.fcs, grads["fcs"], strict=True):
        assert rel(fc.weight.grad.T, g["w"]) <= TOL
        assert rel(fc.bias.grad, g["b"]) <= TOL


@pytest.mark.parametrize("nlayers,use_bn,clip,kind", [
    (2, True, 0.1, "kl"), (2, False, -1.0, "l2"), (1, False, -1.0, "kl"),
])
def test_train_steps_with_adam_match_grandtpu(nlayers, use_bn, clip, kind):
    """Two steps (one inside the warmup ramp, one past it): losses, the
    parameters after coupled-L2 Adam and the BN running stats."""
    rs, tabs = _tables(seed=1)
    (params, state, opt_state, (jtrain, _)), (model, (ttrain, _)), (nt, ubs) \
        = _pair(nlayers, use_bn, clip, kind, "adam")
    gen = torch.Generator().manual_seed(0)
    for nb in (3.0, 40.0):
        b = _batch(rs, nt, ubs)
        params, state, opt_state, jloss = jtrain(
            params, state, opt_state, *(jnp.asarray(a) for a in tabs),
            {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(2), nb)
        m = ttrain(*(torch.tensor(a) for a in tabs), _torch_batch(b), gen,
                   nb)
        assert rel(m["loss"], jloss) <= TOL, nb
    got_p, got_s = mag_to_jax(model)
    assert rel(got_p["emb"]["table"], params["emb"]["table"]) <= TOL
    for g, w in zip(got_p["fcs"], params["fcs"], strict=True):
        assert rel(g["w"], w["w"]) <= TOL and rel(g["b"], w["b"]) <= TOL
    if use_bn:   # unused BN parameters only see JAX's weight decay
        for g, w in zip(got_p["bns"] + got_s["bns"],
                        params["bns"] + state["bns"], strict=True):
            for k in g:
                assert rel(g[k], w[k]) <= TOL, k


def test_eval_step_matches_grandtpu():
    rs, tabs = _tables(seed=4)
    (params, state, _, (_, jeval)), (model, (_, teval)), _ = _pair(
        2, True, -1.0, "l2", "adam")
    state = {"bns": [{"mean": jnp.asarray(rs.randn(16).astype(np.float32)),
                      "var": jnp.asarray(rs.rand(16).astype(np.float32) + .5)}
                     ]}
    with torch.no_grad():
        model.bns[0].running_mean.copy_(torch.tensor(
            np.asarray(state["bns"][0]["mean"])))
        model.bns[0].running_var.copy_(torch.tensor(
            np.asarray(state["bns"][0]["var"])))
    rows = rs.randint(0, N_SRC, 15).astype(np.int32)
    labels = rs.randint(0, C, 15).astype(np.int32)
    mask = (rs.rand(15) < 0.8).astype(np.float32)
    want = jeval(params, state, *(jnp.asarray(a) for a in tabs),
                 jnp.asarray(rows), jnp.asarray(labels), jnp.asarray(mask))
    got = teval(*(torch.tensor(a) for a in tabs), torch.tensor(rows).long(),
                torch.tensor(labels).long(), torch.tensor(mask))
    assert rel(got[0], want[0]) <= TOL
    assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-6)


@pytest.mark.parametrize("mode,batch_size", [("ppr", 10000), ("avg", 64),
                                             ("single", 100)])
def test_predict_logits_sparse_matches_grandtpu(mode, batch_size):
    data = load_data("synth:300:3:40:sparse", split_seed=1)
    adj_sl = add_self_loops_adj(data.adj)
    padded = JaxPadded.from_csr(data.features)
    mkw = dict(num_features=40, num_classes=3, hidden=8, nlayers=2,
               use_bn=True, node_norm=True)
    params, state = jmag.init_mag_mlp(jax.random.PRNGKey(3),
                                      JaxMLPConfig(**mkw))
    want = jclassify.predict_logits_sparse(
        params, state, JaxMLPConfig(**mkw), jnp.asarray(padded.attr_cols),
        jnp.asarray(padded.attr_vals), adj_sl, mode=mode, order=4, alpha=0.2,
        batch_size=batch_size)
    model = mag_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), MLPConfig(**mkw),
                         "cpu")
    got = predict_logits_sparse(model, padded.attr_cols, padded.attr_vals,
                                adj_sl, mode=mode, order=4, alpha=0.2,
                                batch_size=batch_size)
    assert got.shape == want.shape == (300, 3)
    assert rel(got, want) <= TOL


def _e2e_cfg(cls):
    return cls(dataset="synth:400:4:64:sparse", epochs=8, eval_batch=2,
               patience=100, stop_mode="acc", input_droprate=0.0,
               hidden_droprate=0.0, dropnode_rate=0.0, use_bn=True,
               node_norm=True, loss="kl", clip_norm=0.5, lr=0.01,
               unlabel_num=100, top_k=16, order=5, warmup=4.0,
               sparse_features=True)


def test_train_sparse_matches_grandtpu(monkeypatch):
    """train() of both packages on a sparse graph, every drop rate 0, the
    port starting from grandtpu's init: eval histories within 1e-4, test
    accuracy within one test node."""
    def jax_init(mlp_cfg, seed, device):
        _, init_key = jax.random.split(jax.random.PRNGKey(seed))
        params, state = jmag.init_mag_mlp(
            init_key, JaxMLPConfig(**dataclasses.asdict(mlp_cfg)))
        return mag_from_jax(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, state), mlp_cfg, device)

    monkeypatch.setattr(ttsparse, "init_mag_mlp", jax_init)
    want = jax_train(_e2e_cfg(JaxConfig))
    got = ttrainer.train(_e2e_cfg(GrandConfig), device="cpu")
    assert isinstance(got.model, MagMLP)
    assert len(got.history) == len(want.history) == 8
    for g, w in zip(got.history, want.history):
        assert g["batch"] == w["batch"]
        for k in ("val_loss", "val_acc", "loss"):
            assert abs(g[k] - w[k]) <= 1e-4, (k, g, w)
    assert got.num_batches == want.num_batches
    assert got.propagate_time > 0.0
    n_test = 400 - 4 * (20 + 30)
    assert abs(got.test_acc - want.test_acc) * n_test <= 1.0 + 1e-9


def test_train_sparse_rejects_dense_data():
    cfg = GrandConfig(dataset="synth:200:4:16")
    with pytest.raises(ValueError, match="CSR"):
        ttsparse.train_sparse(cfg, device="cpu")


def test_train_on_sparse_data_defaults_to_cuda():
    """The MAG engine has no CPU fallback either: without a card, train()
    on sparse data raises unless device='cpu' is passed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.train(GrandConfig(dataset="synth:200:4:16:sparse"))


@pytest.mark.parametrize("preset", [[], ["--preset", "mag_scholar_c"]])
def test_cli_run_sparse_on_cpu(capsys, preset):
    assert cli(["run", *preset, "--dataset", "synth:400:4:64:sparse",
                "--epochs", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"test_acc_mean"' in out and "synth:400:4:64:sparse" in out
