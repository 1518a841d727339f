"""The serving path from dataset files, on the CPU: a power-law-shaped
graph written in the Amazon2M file layout (``Amazon2M_adj.npz``,
``Amazon2M_feat.npy``, ``Amazon2M_labels.npy``), ``train()`` with a
checkpoint directory, then ``python -m grandtpu_torch.cli.main predict``
with ``--dataset Amazon2M`` read through ``$GRANDTPU_DATA_DIR``.

The graph has 20,100 nodes (above the dense threshold, so the csr backend
and the precision apply) and a hub row of 1,000 neighbours: above the
operator's split cap (max(512, 8 x mean row)) and below the int8 hub guard
(8,192), so 'auto' resolves to int8 and K2-q8mxu's split hop (its plain
version here) runs. The int8 predict's logits must equal
``exact_propagate(precision="int8")`` followed by the classifier, element
for element, and its propagation must be within the fast-path gate (5e-3,
max |a - b| / max |b|) of grandtpu's int8 propagation of the same graph.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp

from grandtpu.data.preprocess import add_self_loops_adj as jax_self_loops
from grandtpu.infer.propagate import exact_propagate as jax_exact_propagate

from grandtpu_torch.cli.main import cli
from grandtpu_torch.config import preset
from grandtpu_torch.data import load_data, synthetic_graph
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.infer.classify import predict_logits
from grandtpu_torch.infer.propagate import (INT8_MAX_HUB_DEGREE,
                                            exact_propagate,
                                            exact_propagator)
from grandtpu_torch.nn.mlp import MLPConfig
from grandtpu_torch.train import trainer as ttrainer
from grandtpu_torch.train.checkpoint import load_model

N, CLASSES, FEATURES, HUB_DEGREE = 20100, 4, 16, 1000
GATE = 5e-3
# the Amazon2M preset cut to a CPU-sized model; predict reads the same
# flags back
SMALL = dict(hidden=16, epochs=1, eval_batch=2, top_k=16,
             unlabel_num=100, patience=100)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _write_amazon2m(path):
    """The synth SBM graph plus hub row 17 (grandtpu/bench/skew_probe.py's
    construction: random neighbours, re-binarised), in the Amazon2M file
    layout with class-id labels."""
    adj, feats, onehot = synthetic_graph(num_nodes=N, num_classes=CLASSES,
                                         num_features=FEATURES, seed=1)
    cols = np.random.RandomState(7).randint(0, N, HUB_DEGREE)
    adj = (adj + sp.csr_matrix((np.ones(HUB_DEGREE, np.float32),
                                (np.full(HUB_DEGREE, 17), cols)),
                               shape=adj.shape)).tocsr()
    adj.data[:] = 1.0
    sp.save_npz(path / "Amazon2M_adj.npz", adj, compressed=False)
    np.save(path / "Amazon2M_feat.npy", np.asarray(feats, np.float32))
    np.save(path / "Amazon2M_labels.npy", onehot.argmax(-1))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The files, the checkpoint train() wrote, and the predict CLI's
    output at f32, int8 and auto."""
    path = tmp_path_factory.mktemp("amazon2m")
    _write_amazon2m(path)
    mp = pytest.MonkeyPatch()
    mp.setenv("GRANDTPU_DATA_DIR", str(path))
    try:
        cfg = preset("Amazon2M").replace(ckpt_dir=str(path), **SMALL)
        r = ttrainer.train(cfg, device="cpu")
        flags = ["--hidden", "16"]
        out = {}
        for precision in ("f32", "int8", "auto"):
            npz = str(path / f"pred_{precision}.npz")
            argv = ["predict", "--dataset", "Amazon2M", "--ckpt",
                    str(path / "best.npz"), "--precision", precision,
                    "--output", npz, "--device", "cpu", *flags]
            assert cli(argv) == 0
            with np.load(npz) as z:
                out[precision] = {k: z[k] for k in z.files}
        data = load_data("Amazon2M", split_seed=cfg.seed1)
        yield cfg, r, data, out
    finally:
        mp.undo()


def test_files_load_with_the_hub_row(served):
    cfg, r, data, _ = served
    adj_sl = add_self_loops_adj(data.adj)
    longest = int(adj_sl.getnnz(axis=1).max())   # neighbours repeat
    assert longest < INT8_MAX_HUB_DEGREE
    # the Amazon2M split: 20 train and 30 val nodes a class, drawn by size
    assert len(data.idx_train) == 20 * CLASSES
    assert len(data.idx_val) == 30 * CLASSES
    prop, precision = exact_propagator(adj_sl, FEATURES, precision="auto",
                                       device="cpu")
    assert precision == "int8" and prop.backend == "csr"
    assert prop.max_degree == longest           # the hub guard's input
    assert prop.adj_op.split_cap < longest
    assert prop.adj_op.plan.rows.tolist() == [17]
    assert r.predict_precision == "f32"


def test_int8_predict_equals_exact_propagate(served):
    """The int8 (and auto) predict's logits, element for element, against
    exact_propagate at int8 and the classifier on the checkpoint's model;
    the int8 propagation within the gate of grandtpu's."""
    cfg, _, data, out = served
    adj_sl = add_self_loops_adj(data.adj)
    kw = dict(mode=cfg.prop_mode, order=cfg.order, alpha=cfg.alpha)
    prop = exact_propagate(adj_sl, data.features, precision="int8",
                           device="cpu", **kw)
    model, _ = load_model(
        str(cfg.ckpt_dir) + "/best.npz",
        MLPConfig(num_features=FEATURES, num_classes=CLASSES,
                  hidden=cfg.hidden, nlayers=cfg.nlayers, use_bn=cfg.use_bn,
                  node_norm=cfg.node_norm), sparse=False, device="cpu")
    want = predict_logits(model, prop)
    assert np.array_equal(out["int8"]["logits"], want)
    assert np.array_equal(out["auto"]["logits"], want)
    assert out["int8"]["logits"].shape == (N, CLASSES)
    jax_prop = np.asarray(jax_exact_propagate(
        jax_self_loops(data.adj), np.asarray(data.features), precision="int8",
        **kw))
    assert rel(prop.numpy(), jax_prop) <= GATE
    f32 = exact_propagate(adj_sl, data.features, device="cpu", **kw)
    assert np.array_equal(out["f32"]["logits"], predict_logits(model, f32))


def test_predict_prints_its_line(served, capsys):
    """The CLI's JSON line names the file dataset and its test accuracy."""
    cfg, _, data, out = served
    acc = float(np.mean(out["int8"]["predictions"][data.idx_test]
                        == data.labels_int[data.idx_test]))
    argv = ["predict", "--dataset", "Amazon2M", "--ckpt",
            str(cfg.ckpt_dir) + "/best.npz", "--precision", "int8",
            "--output", str(cfg.ckpt_dir) + "/again.npz", "--device", "cpu",
            "--hidden", "16"]
    mp = pytest.MonkeyPatch()
    mp.setenv("GRANDTPU_DATA_DIR", str(cfg.ckpt_dir))
    try:
        assert cli(argv) == 0
    finally:
        mp.undo()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["dataset"] == "Amazon2M" and line["test_acc"] == acc
