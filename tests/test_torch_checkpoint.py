"""The port's checkpoints and ``predict`` CLI against grandtpu's: the npz
format key for key and array for array (MLP and MagMLP), checkpoints read
across the packages in both directions, the shape check, ``train()``'s
``best.npz``, and ``predict`` from one grandtpu checkpoint on a dense and a
``:sparse`` graph, with one and with two shards.

Tolerance of the predict's logits: max |port - jax| / max |jax| <= 1e-5
(f32 sums in another order); predictions and test accuracy equal.
"""

import json

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

from grandtpu_torch.cli.main import cli
from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import mag_from_jax, mlp_from_jax
from grandtpu_torch.data import load_data
from grandtpu_torch.nn.mlp import MLPConfig
from grandtpu_torch.train import trainer as ttrainer
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
    with pytest.raises(NotImplementedError, match="orbax"):
        save_checkpoint(path, params=params, state=state, backend="orbax")


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
