"""The port's checkpoints and ``predict`` CLI against grandtpu's: the npz
format key for key and array for array (MLP and MagMLP), checkpoints read
across the packages in both directions, the shape check, ``train()``'s
``best.npz``, and ``predict`` from one grandtpu checkpoint on a dense and a
``:sparse`` graph, with one and with two shards. The directory form
(``backend="orbax"``: torch.distributed.checkpoint's bytes in the port,
orbax's in grandtpu) restores the same leaves and meta as grandtpu's orbax
checkpoint of the same trees, bit for bit; its ``.npz`` stripping,
overwrite, missing directory, a save cut short, the row-padded slice, and
the error on a directory of grandtpu's.

Tolerance of the predict's logits: max |port - jax| / max |jax| <= 1e-5
(f32 sums in another order); predictions and test accuracy equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from grandtpu.cli.main import cli as jax_cli
from grandtpu.nn.mag_mlp import init_mag_mlp as jax_init_mag
from grandtpu.nn.mlp import MLPConfig as JaxMLPConfig
from grandtpu.nn.mlp import init_mlp as jax_init_mlp
from grandtpu.train.checkpoint import load_checkpoint as jax_load
from grandtpu.train.checkpoint import save_checkpoint as jax_save
from grandtpu.train.step import make_optimizer as jax_optimizer

from grandtpu_torch.cli.main import cli
from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import mag_from_jax, mlp_from_jax
from grandtpu_torch.data import load_data
from grandtpu_torch.nn.mlp import MLPConfig
from grandtpu_torch.train import trainer as ttrainer
from grandtpu_torch.train import checkpoint as tcheckpoint
from grandtpu_torch.train.checkpoint import (CheckpointShapeError,
                                             load_checkpoint, load_model,
                                             model_trees, save_checkpoint)

DENSE, SPARSE = "synth:400:4:32", "synth:400:4:64:sparse"


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def mlp_cfg(spec: str) -> dict:
    """The MLPConfig fields the predict CLIs build for ``spec`` with the
    default GrandConfig and ``--use-bn true``."""
    data = load_data(spec, split_seed=GrandConfig().seed1)
    return dict(num_features=data.features.shape[1],
                num_classes=data.num_classes, hidden=64, nlayers=2,
                use_bn=True)


def jax_trees(spec: str, seed: int = 1):
    """grandtpu's (params, state) for ``spec``, BN running stats random."""
    cfg = JaxMLPConfig(**mlp_cfg(spec))
    init = jax_init_mag if spec.endswith(":sparse") else jax_init_mlp
    params, state = init(jax.random.PRNGKey(seed), cfg)
    rs = np.random.RandomState(seed)
    state = {"bns": [{"mean": rs.randn(*np.shape(s["mean"])).astype(
        np.float32), "var": rs.rand(*np.shape(s["var"])).astype(np.float32)
        + 0.5} for s in state["bns"]]}
    return jax.tree.map(np.asarray, params), state


def npz(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("spec", [DENSE, SPARSE])
def test_save_equals_grandtpu_save(tmp_path, spec):
    params, state = jax_trees(spec)
    jax_save(str(tmp_path / "jax.npz"), params=params, state=state,
             num_batch=7, best_val_acc=0.5, best_val_loss=1.25)
    build = mag_from_jax if spec.endswith(":sparse") else mlp_from_jax
    model = build(params, state, MLPConfig(**mlp_cfg(spec)), "cpu")
    p, s = model_trees(model)
    save_checkpoint(str(tmp_path / "port.npz"), params=p, state=s,
                    num_batch=7, best_val_acc=0.5, best_val_loss=1.25)
    want, got = npz(tmp_path / "jax.npz"), npz(tmp_path / "port.npz")
    assert sorted(got) == sorted(want)
    assert any(k.startswith("params|['fcs']/[0]/['w']") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("spec", [DENSE, SPARSE])
def test_checkpoints_load_across_packages(tmp_path, spec):
    params, state = jax_trees(spec, seed=2)
    sparse = spec.endswith(":sparse")
    cfg = MLPConfig(**mlp_cfg(spec))
    # grandtpu's save -> the port
    jax_save(str(tmp_path / "jax.npz"), params=params, state=state,
             best_val_acc=0.75)
    model, meta = load_model(str(tmp_path / "jax.npz"), cfg, sparse=sparse,
                             device="cpu")
    assert meta["best_val_acc"] == 0.75
    got_p, got_s = model_trees(model)
    for a, b in zip(jax.tree.leaves((got_p, got_s)),
                    jax.tree.leaves((params, state))):
        assert np.array_equal(a, b)
    # the port's save -> grandtpu's load_checkpoint
    save_checkpoint(str(tmp_path / "port.npz"), params=got_p, state=got_s,
                    num_batch=3, best_val_acc=0.25)
    jp, js, jo, jmeta = jax_load(str(tmp_path / "port.npz"),
                                 params_template=params,
                                 state_template=state)
    assert jo is None and jmeta["num_batch"] == 3
    for a, b in zip(jax.tree.leaves((jp, js)),
                    jax.tree.leaves((params, state))):
        assert np.array_equal(np.asarray(a), b)


def test_shape_mismatch_raises(tmp_path):
    params, state = jax_trees(DENSE)
    path = str(tmp_path / "best.npz")
    save_checkpoint(path, params=params, state=state)
    wide = MLPConfig(**(mlp_cfg(DENSE) | {"hidden": 32}))
    with pytest.raises(CheckpointShapeError, match="does not match"):
        load_model(path, wide, sparse=False, device="cpu")
    deeper = MLPConfig(**(mlp_cfg(DENSE) | {"nlayers": 3}))
    with pytest.raises(CheckpointShapeError, match="missing"):
        load_model(path, deeper, sparse=False, device="cpu")
    # a leaf recorded as row-padded is sliced back, as in grandtpu
    table = np.ones((10, 4), np.float32)
    save_checkpoint(path, params={"emb": {"table": table}}, state={},
                    row_padded={"params|['emb']/['table']": 7})
    got, _, _, _ = load_checkpoint(
        path, params_template={"emb": {"table": np.zeros((7, 4))}},
        state_template={})
    assert got["emb"]["table"].shape == (7, 4)
    # the directory form (ckpt_backend "orbax") round-trips the same trees
    save_checkpoint(path, params=params, state=state, num_batch=2,
                    backend="orbax")
    got_p, got_s, _, meta = load_checkpoint(path, params_template=params,
                                            state_template=state)
    assert meta["num_batch"] == 2
    for a, b in zip(jax.tree.leaves((got_p, got_s)),
                    jax.tree.leaves((params, state))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def jax_training_trees(spec: str, seed: int = 4):
    """grandtpu's (params, state, opt_state) for ``spec``: optax's Adam
    with weight decay 1e-3 after one update from random gradients (nonzero
    moments, count 1), all as numpy."""
    params, state = jax_trees(spec, seed)
    opt = jax_optimizer(1e-2, 1e-3)
    rs = np.random.RandomState(seed)
    grads = jax.tree.map(
        lambda p: rs.randn(*np.shape(p)).astype(np.float32), params)
    _, opt_state = opt.update(grads, opt.init(params), params)
    return params, state, jax.tree.map(np.asarray, opt_state)


@pytest.mark.parametrize("spec", [DENSE, SPARSE])
def test_directory_checkpoint_equals_grandtpu_orbax(tmp_path, spec):
    """The same trees through grandtpu's orbax save and load and through
    the port's directory save and load: every leaf bit for bit, the meta
    equal; the directory holds the npz's flat dict key for key."""
    params, state, opt = jax_training_trees(spec)
    kw = dict(params=params, state=state, opt_state=opt, num_batch=7,
              best_val_acc=0.5, best_val_loss=1.25,
              row_padded={"params|['fcs']/[0]/['w']": 3})
    jax_save(str(tmp_path / "jax.npz"), backend="orbax", **kw)
    assert (tmp_path / "jax").is_dir()
    want = jax_load(str(tmp_path / "jax.npz"), params_template=params,
                    state_template=state, opt_template=opt)
    assert save_checkpoint(str(tmp_path / "port.npz"), backend="orbax", **kw)
    assert (tmp_path / "port").is_dir()
    assert not (tmp_path / "port.npz").exists()
    got = load_checkpoint(str(tmp_path / "port.npz"), params_template=params,
                          state_template=state, opt_template=opt)
    assert got[3] == want[3]
    assert got[3]["__row_padded__"] == kw["row_padded"]
    g, w = jax.tree.leaves(got[:3]), jax.tree.leaves(want[:3])
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    # the same flat dict as grandtpu's npz of the same trees
    jax_save(str(tmp_path / "flat.npz"), **kw)
    flat = tcheckpoint._load_directory(str(tmp_path / "port"))
    ref = npz(tmp_path / "flat.npz")
    assert sorted(flat) == sorted(ref)
    for k in ref:
        assert flat[k].dtype == ref[k].dtype, k
        assert np.array_equal(flat[k], ref[k]), k
    # grandtpu's own directory is orbax's: the port names it and stops
    with pytest.raises(ValueError, match="grandtpu's orbax backend"):
        load_checkpoint(str(tmp_path / "jax"), params_template=params,
                        state_template=state)


def test_directory_checkpoint_path_and_overwrite(tmp_path):
    """A stray ``.npz`` is stripped on save and load; each save replaces
    the directory and leaves no sibling behind; a missing directory raises
    ``FileNotFoundError`` (the resume path's "start fresh")."""
    params, state, opt = jax_training_trees(DENSE)
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, params=params, state=state, opt_state=opt,
                    num_batch=17, best_val_acc=0.9, backend="orbax")
    assert os.listdir(tmp_path) == ["ckpt"]
    for path in (p, str(tmp_path / "ckpt")):
        _, _, o2, meta = load_checkpoint(path, params_template=params,
                                         state_template=state,
                                         opt_template=opt)
        assert meta["num_batch"] == 17 and meta["best_val_acc"] == 0.9
        for a, b in zip(jax.tree.leaves(o2), jax.tree.leaves(opt)):
            assert np.array_equal(a, b)
    save_checkpoint(p, params=params, state=state, num_batch=18,
                    backend="orbax")
    _, _, none, meta = load_checkpoint(p, params_template=params,
                                       state_template=state)
    assert meta["num_batch"] == 18 and none is None
    assert os.listdir(tmp_path) == ["ckpt"]
    for backend in ("orbax", None):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path / "missing"),
                            params_template=params, state_template=state,
                            backend=backend)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        save_checkpoint(p, params=params, state=state, backend="zarr")


def test_directory_save_cut_short_keeps_the_last(tmp_path, monkeypatch):
    """A directory save that fails raises (no npz instead) and leaves the
    previous checkpoint readable; the next save succeeds."""
    import torch.distributed.checkpoint as dcp

    params, state = jax_trees(DENSE)
    p = str(tmp_path / "latest.npz")
    save_checkpoint(p, params=params, state=state, num_batch=1,
                    backend="orbax")
    real = dcp.save

    def cut(tensors, *, checkpoint_id, **kw):
        real(dict(list(tensors.items())[:2]), checkpoint_id=checkpoint_id,
             **kw)
        raise OSError("the machine went away")

    monkeypatch.setattr(dcp, "save", cut)
    with pytest.raises(OSError, match="went away"):
        save_checkpoint(p, params=params, state=state, num_batch=2,
                        backend="orbax")
    assert not (tmp_path / "latest.npz").exists()
    _, _, _, meta = load_checkpoint(p, params_template=params,
                                    state_template=state)
    assert meta["num_batch"] == 1
    monkeypatch.setattr(dcp, "save", real)
    save_checkpoint(p, params=params, state=state, num_batch=3,
                    backend="orbax")
    assert load_checkpoint(p, params_template=params,
                           state_template=state)[3]["num_batch"] == 3
    assert os.listdir(tmp_path) == ["latest"]


def test_directory_checkpoint_row_padded(tmp_path):
    """A table the save records as row-padded is sliced back to the
    template's rows; any other shape difference raises
    :class:`CheckpointShapeError`, as in the npz form."""
    rs = np.random.RandomState(5)
    table = rs.rand(10, 4).astype(np.float32)
    tmpl = {"emb": {"table": np.zeros((7, 4), np.float32)}}
    p = str(tmp_path / "best")
    save_checkpoint(p, params={"emb": {"table": table}}, state={},
                    row_padded={"params|['emb']/['table']": 7},
                    backend="orbax")
    got, _, _, _ = load_checkpoint(p, params_template=tmpl,
                                   state_template={})
    assert np.array_equal(got["emb"]["table"], table[:7])
    save_checkpoint(p, params={"emb": {"table": table}}, state={},
                    backend="orbax")
    with pytest.raises(CheckpointShapeError, match="does not match"):
        load_checkpoint(p, params_template=tmpl, state_template={})
    with pytest.raises(CheckpointShapeError, match="missing"):
        load_checkpoint(p, params_template={"w": np.zeros(3)},
                        state_template={})


@pytest.mark.parametrize("spec", [DENSE, SPARSE])
def test_directory_checkpoint_serves_like_npz(tmp_path, capsys, spec):
    """``train()`` with ``ckpt_backend="orbax"`` writes ``best/``, whose
    weights are the model's; ``predict`` from it prints what it prints
    from the same weights as npz."""
    cfg = GrandConfig(dataset=spec, epochs=2, use_bn=True,
                      ckpt_dir=str(tmp_path / "dir"), ckpt_backend="orbax")
    r = ttrainer.train(cfg, device="cpu")
    assert os.listdir(cfg.ckpt_dir) == ["best"]
    best = os.path.join(cfg.ckpt_dir, "best")
    model, meta = load_model(best, r.model.cfg,
                             sparse=spec.endswith(":sparse"), device="cpu")
    assert meta["best_val_acc"] == pytest.approx(r.best_val_acc)
    want = r.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    p, st = model_trees(model)
    as_npz = str(tmp_path / "best.npz")
    save_checkpoint(as_npz, params=p, state=st,
                    best_val_acc=meta["best_val_acc"])
    outs = {}
    for name, ck in (("dir", best), ("npz", as_npz)):
        outs[name] = _predict(cli, ["predict", "--dataset", spec, "--ckpt",
                                    ck, "--use-bn", "true", "--device", "cpu",
                                    "--output", str(tmp_path / f"{name}.npz")],
                              capsys)
    assert outs["dir"]["test_acc"] == outs["npz"]["test_acc"]
    assert outs["dir"]["ckpt_val_acc"] == outs["npz"]["ckpt_val_acc"]
    g, w = npz(tmp_path / "dir.npz"), npz(tmp_path / "npz.npz")
    assert np.array_equal(g["logits"], w["logits"])


@pytest.mark.parametrize("spec", ["synth:400:4:16", "synth:400:4:64:sparse"])
def test_train_writes_best_checkpoint(tmp_path, spec):
    """``ckpt_dir`` writes best.npz at each improving eval: its weights are
    the best ones, those of ``TrainResult.model``."""
    cfg = GrandConfig(dataset=spec, epochs=3, use_bn=True,
                      ckpt_dir=str(tmp_path))
    r = ttrainer.train(cfg, device="cpu")
    model, meta = load_model(str(tmp_path / "best.npz"), r.model.cfg,
                             sparse=spec.endswith(":sparse"), device="cpu")
    assert meta["best_val_acc"] == pytest.approx(r.best_val_acc)
    assert meta["best_val_loss"] == pytest.approx(r.best_val_loss)
    want = r.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def _predict(run, argv, capsys) -> dict:
    assert run(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("spec", [DENSE, SPARSE])
def test_predict_cli_matches_grandtpu(tmp_path, capsys, spec, shards):
    params, state = jax_trees(spec, seed=3)
    ckpt = str(tmp_path / "best.npz")
    jax_save(ckpt, params=params, state=state, best_val_acc=0.5)
    common = ["predict", "--dataset", spec, "--ckpt", ckpt, "--use-bn",
              "true", "--order", "4", "--num-devices", str(shards)]
    want = _predict(jax_cli, common + ["--platform", "cpu", "--output",
                                       str(tmp_path / "jax.npz")], capsys)
    got = _predict(cli, common + ["--device", "cpu", "--output",
                                  str(tmp_path / "port.npz")], capsys)
    assert set(got) == set(want) == {"dataset", "output", "test_acc",
                                     "ckpt_val_acc"}
    assert got["test_acc"] == want["test_acc"]
    assert got["ckpt_val_acc"] == want["ckpt_val_acc"] == 0.5
    g, w = npz(tmp_path / "port.npz"), npz(tmp_path / "jax.npz")
    assert rel(g["logits"], w["logits"]) <= 1e-5
    assert np.array_equal(g["predictions"], w["predictions"])
    assert np.array_equal(g["idx_test"], w["idx_test"])
