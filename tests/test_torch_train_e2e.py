"""The port's dense-engine slice as a whole against grandtpu: loop schedule,
``train()`` end to end, the CLI, device selection, engine dispatch and
import isolation."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandtpu.config import GrandConfig as JaxConfig
from grandtpu.nn import mlp as jmlp
from grandtpu.train import loop as jloop
from grandtpu.train import train as jax_train

from grandtpu_torch.cli.main import cli
from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import mlp_from_jax
from grandtpu_torch.nn.mlp import MLP
from grandtpu_torch.train import checkpoint as tcheckpoint
from grandtpu_torch.train import loop as tloop
from grandtpu_torch.train import trainer as ttrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("stop_mode,n_sample", [("both", 13), ("acc", 3)])
def test_loops_see_identical_batches(stop_mode, n_sample):
    """Given the same recording step and scripted evals, both loops draw the
    same batches (same RandomState calls), evaluate at the same steps and
    stop at the same step."""
    kw = dict(epochs=6, batch_size=7, unlabel_batch_size=5, eval_batch=3,
              patience=3, stop_mode=stop_mode)
    rs = np.random.RandomState(0)
    train_pos = rs.permutation(40)[:20]
    sample_pos = 40 + rs.permutation(30)[:n_sample]
    labels_all = rs.randint(0, 4, 20)
    evals = [(1.0, 0.5), (0.9, 0.6), (0.95, 0.6), (0.8, 0.55), (0.7, 0.6),
             (0.9, 0.4), (0.9, 0.4), (0.9, 0.4)] + [(0.9, 0.3)] * 20

    def record(batches, batch, nb):
        batches.append({k: np.asarray(v).copy() for k, v in batch.items()}
                       | {"nb": float(nb)})

    jb, jev = [], iter(evals)

    def jstep(params, state, opt_state, batch, key, nb):
        record(jb, batch, nb)
        return params, state, opt_state, {"loss": jnp.float32(nb)}

    jout = jloop.run_training_loop(
        JaxConfig(**kw), np.random.RandomState(5), jax.random.PRNGKey(0),
        params={}, state={}, opt_state={}, step_fn=jstep,
        eval_fn=lambda p, s: next(jev), train_positions=train_pos,
        sample_positions=sample_pos, train_labels_all=labels_all,
        edges_per_step=1, verbose=lambda *a: None)

    tb, tev = [], iter(evals)

    def tstep(batch, nb):
        record(tb, batch, nb)
        return {"loss": torch.tensor(float(nb))}

    tout = tloop.run_training_loop(
        GrandConfig(**kw), np.random.RandomState(5), step_fn=tstep,
        eval_fn=lambda: next(tev), snapshot=lambda: None,
        train_positions=train_pos, sample_positions=sample_pos,
        train_labels_all=labels_all, device="cpu", verbose=lambda *a: None)

    assert len(tb) == len(jb) > 0
    for t, j in zip(tb, jb):
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert tout["num_batch"] == jout["num_batch"]
    assert tout["history"] == jout["history"]
    assert tout["best"]["batch"] == jout["best"]["batch"]
    assert tout["best"]["acc"] == jout["best"]["acc"]


def _e2e_cfg(cls):
    return cls(dataset="synth:400:4:32", epochs=8, eval_batch=2,
               patience=100, stop_mode="acc", input_droprate=0.0,
               hidden_droprate=0.0, dropnode_rate=0.0, use_bn=True,
               node_norm=True, loss="kl", clip_norm=0.5, lr=0.01,
               unlabel_num=100, top_k=16, order=5)


def test_train_matches_grandtpu(monkeypatch):
    """train() of both packages with every drop rate 0 and the port starting
    from grandtpu's init: eval histories within 1e-4, test accuracy within
    one test node."""
    def jax_init(mlp_cfg, seed, device):
        _, init_key = jax.random.split(jax.random.PRNGKey(seed))
        params, state = jmlp.init_mlp(
            init_key, jmlp.MLPConfig(**dataclasses.asdict(mlp_cfg)))
        return mlp_from_jax(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, state), mlp_cfg, device)

    monkeypatch.setattr(ttrainer, "init_mlp", jax_init)
    want = jax_train(_e2e_cfg(JaxConfig))
    got = ttrainer.train(_e2e_cfg(GrandConfig), device="cpu")
    assert len(got.history) == len(want.history) == 8
    for g, w in zip(got.history, want.history):
        assert g["batch"] == w["batch"]
        for k in ("val_loss", "val_acc", "loss"):
            assert abs(g[k] - w[k]) <= 1e-4, (k, g, w)
    assert got.num_batches == want.num_batches
    n_test = 400 - 4 * (20 + 30)
    assert abs(got.test_acc - want.test_acc) * n_test <= 1.0 + 1e-9


def test_cli_run_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "grandtpu_torch.cli.main", "run", "--dataset",
         "synth:400:4:16", "--epochs", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"test_acc_mean"' in out.stdout


def test_cli_presets_and_unported_flag(capsys, tmp_path):
    """The CLI runs what it once refused: ``--ckpt-backend orbax`` writes
    the directory ``best/``, which ``predict`` serves from; and
    ``--scan-steps true``."""
    assert cli(["presets"]) == 0
    assert "reddit" in capsys.readouterr().out
    ck = str(tmp_path / "ck")
    assert cli(["run", "--dataset", "synth:400:4:16", "--device", "cpu",
                "--epochs", "2", "--ckpt-dir", ck,
                "--ckpt-backend", "orbax"]) == 0
    assert '"test_acc_mean"' in capsys.readouterr().out
    assert os.listdir(ck) == ["best"]
    assert os.path.isfile(os.path.join(ck, "best", ".metadata"))
    assert cli(["predict", "--dataset", "synth:400:4:16", "--device", "cpu",
                "--ckpt", os.path.join(ck, "best"), "--output",
                str(tmp_path / "p.npz")]) == 0
    assert '"test_acc"' in capsys.readouterr().out
    assert cli(["run", "--dataset", "synth:400:4:16", "--device", "cpu",
                "--epochs", "3", "--eval-batch", "2",
                "--scan-steps", "true"]) == 0
    assert '"test_acc_mean"' in capsys.readouterr().out


@pytest.mark.parametrize("field,value", [
    ("ckpt_backend", "orbax"), ("resume", True), ("save_every", 5),
    ("metrics_path", "m.jsonl"), ("profile_dir", "prof"),
    ("scan_steps", True), ("num_devices", 2), ("push_cache_dir", "cache"),
])
def test_unported_config_raises(field, value, tmp_path):
    """No option raises any more: the ones that used to raise here run and
    do what their field asks (``scan_steps``: rolled groups, the
    trajectory per-step training's; ``ckpt_backend="orbax"``: the
    directories ``best/`` and ``latest/``, resumed from at the saved
    step)."""
    cfg = GrandConfig(dataset="synth:200:4:16").replace(**{field: value})
    if field == "num_devices":
        # data-parallel training is ported (tests/test_torch_dist_train.py);
        # what it still refuses is a batch that does not split over the
        # mesh, before any step
        with pytest.raises(ValueError, match="unlabel_batch_size"):
            ttrainer.train(cfg.replace(batch_size=3), device="cpu")
        return
    base = GrandConfig(dataset="synth:400:4:16", epochs=4, eval_batch=1,
                       patience=100)
    ck = str(tmp_path / "ck")
    if field == "ckpt_backend":
        first = ttrainer.train(base.replace(ckpt_dir=ck, save_every=1,
                                            **{field: value}), device="cpu")
        assert sorted(os.listdir(ck)) == ["best", "latest"]
        _, _, _, meta = tcheckpoint.load_checkpoint(
            os.path.join(ck, "latest.npz"), params_template={},
            state_template={})
        assert meta["num_batch"] == first.num_batches
        logs = []
        got = ttrainer.train(base.replace(ckpt_dir=ck, resume=True, epochs=6,
                                          **{field: value}),
                             device="cpu", log=logs.append)
        assert any("resumed from" in str(m) for m in logs)
        assert got.history[0]["batch"] == first.num_batches
        # the same resume from the same state as npz files
        npz = str(tmp_path / "npz")
        ttrainer.train(base.replace(ckpt_dir=npz, save_every=1),
                       device="cpu")
        want = ttrainer.train(base.replace(ckpt_dir=npz, resume=True,
                                           epochs=6), device="cpu")
        assert got.history == want.history
        return
    if field in ("metrics_path", "profile_dir", "push_cache_dir"):
        value = str(tmp_path / value)
    logs = []
    if field == "resume":
        first = ttrainer.train(base.replace(ckpt_dir=ck, save_every=1),
                               device="cpu")
        got = ttrainer.train(base.replace(ckpt_dir=ck, resume=True,
                                          epochs=6),
                             device="cpu", log=logs.append)
        assert any("resumed from" in str(m) for m in logs)
        # the first run's last step saved the next one's index, its count
        assert got.history[0]["batch"] == first.num_batches
        return
    got = ttrainer.train(base.replace(ckpt_dir=ck, **{field: value}),
                         device="cpu", log=logs.append)
    assert got.num_batches > 0 and not got.preempted
    if field == "save_every":
        # every 5th eval (one a step here) saves the next step's index
        with np.load(os.path.join(ck, "latest.npz")) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            assert "opt|[1]/.count" in z.files
        assert meta["num_batch"] % 5 == 1
    elif field == "metrics_path":
        lines = [json.loads(ln) for ln in open(value)]
        assert sum("val_acc" in ln for ln in lines) == len(got.history)
        assert lines[-1]["event"] == "train_end"
        assert lines[-1]["train_edges_per_s"] > 0
    elif field == "profile_dir":
        assert [f for f in os.listdir(value) if f.endswith(".json")]
    elif field == "scan_steps":
        # one eval a step: every group has length 1, none is rolled
        assert got.scan_groups == {}
        grouped = base.replace(eval_batch=3, epochs=8)
        again = ttrainer.train(grouped.replace(**{field: value}),
                               device="cpu")
        want = ttrainer.train(grouped, device="cpu")
        assert again.scan_groups and again.history == want.history
    else:
        assert len(os.listdir(value)) == 1
        again = ttrainer.train(base.replace(**{field: value}), device="cpu")
        assert len(os.listdir(value)) == 1
        assert again.history == got.history


def test_cli_long_run_flags_reach_train(tmp_path, capsys):
    """The CLI's generated flags for the long-run options reach train():
    a run writes latest.npz, the metrics stream, a push-cache entry and a
    trace; ``--resume true`` continues from latest.npz."""
    d = str(tmp_path)
    base = ["run", "--dataset", "synth:400:4:16", "--device", "cpu",
            "--eval-batch", "2", "--ckpt-dir", f"{d}/ck",
            "--push-cache-dir", f"{d}/pc"]
    assert cli(base + ["--epochs", "2", "--save-every", "1",
                       "--metrics-path", f"{d}/m.jsonl",
                       "--profile-dir", f"{d}/prof"]) == 0
    assert sorted(os.listdir(f"{d}/ck")) == ["best.npz", "latest.npz"]
    assert len(os.listdir(f"{d}/pc")) == 1 and os.listdir(f"{d}/prof")
    lines = [json.loads(ln) for ln in open(f"{d}/m.jsonl")]
    assert lines[-1]["event"] == "train_end"
    capsys.readouterr()
    assert cli(base + ["--epochs", "3", "--resume", "true", "--visible",
                       "true"]) == 0
    assert "resumed from" in capsys.readouterr().out


@pytest.fixture(scope="module")
def native_push_run():
    return ttrainer.train(GrandConfig(dataset="synth:400:4:16", epochs=3,
                                      push_backend="native"), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("push_backend", "jax"), ("push_backend", "bucket"),
])
def test_train_with_device_push_backend(field, value, native_push_run):
    """train() with the device pushes (their plain versions on the CPU):
    a finite history, and test accuracy within one test node of the native
    push's (the top-k rows agree to the pruning granularity, not bit for
    bit)."""
    cfg = GrandConfig(dataset="synth:400:4:16", epochs=3)
    got = ttrainer.train(cfg.replace(**{field: value}), device="cpu")
    want = native_push_run
    assert len(got.history) == len(want.history) > 0
    assert np.all(np.isfinite([v for h in got.history
                               for v in (h["loss"], h["val_loss"])]))
    n_test = 400 - 4 * (20 + 30)
    assert abs(got.test_acc - want.test_acc) * n_test <= 1.0 + 1e-9


def test_sparse_flag_on_dense_data_runs_dense_engine():
    """As in grandtpu, train() dispatches on the data's feature format and
    ignores ``sparse_features`` when the features are dense."""
    cfg = GrandConfig(dataset="synth:400:4:16", epochs=2,
                      sparse_features=True)
    got = ttrainer.train(cfg, device="cpu")
    want = ttrainer.train(cfg.replace(sparse_features=False), device="cpu")
    assert isinstance(got.model, MLP)
    assert got.history == want.history
    assert got.test_acc == want.test_acc


def test_train_defaults_to_cuda():
    """No device argument means the card; without one, train() raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.train(GrandConfig(dataset="synth:200:4:16"))


def test_port_imports_no_jax_and_no_grandtpu():
    code = """
import importlib, pkgutil, sys
import grandtpu_torch
for m in pkgutil.walk_packages(grandtpu_torch.__path__, "grandtpu_torch."):
    importlib.import_module(m.name)
import grandtpu_torch.cli.main, grandtpu_torch.dist
import grandtpu_torch.train.checkpoint as ck
import grandtpu_torch.data.download
import chip_smoke
import numpy as np, tempfile
with tempfile.TemporaryDirectory() as d:
    ck.save_checkpoint(d + "/best", params={"w": np.ones(3, np.float32)},
                       state={}, backend="orbax")
    ck.load_checkpoint(d + "/best", params_template={"w": np.ones(3)},
                       state_template={})
bad = sorted(n for n in sys.modules if n.split(".")[0] in
             ("jax", "jaxlib", "optax", "orbax", "grandtpu"))
print("MODULES", len([n for n in sys.modules if n.startswith("grandtpu_torch")]))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split("MODULES")[1]) >= 20
