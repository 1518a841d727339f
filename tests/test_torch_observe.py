"""The port's ``observe.py`` against grandtpu's: the metrics stream's lines,
the step timer's summary, and the profiler trace around a propagation."""

import json
import os

import numpy as np
import pytest

from grandtpu import observe as jobs

from grandtpu_torch import observe as tobs
from grandtpu_torch.data import load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.infer import exact_propagate

CALLS = [dict(batch=0, epoch=0, val_loss=1.25, val_acc=0.5, train_loss=2.0,
              batch_time_s=0.01),
         dict(event="preempted", num_batch=7),
         dict(event="train_end", num_batch=7, best_val_acc=0.5,
              batch_time_mean_s=0.02, batches=7, train_edges_per_s=3.5e6)]


def _lines(path):
    return [json.loads(ln) for ln in open(path)]


def test_metrics_lines_have_grandtpus_keys(tmp_path):
    """The same log calls give lines with the same keys and values (the
    ``ts`` apart), one JSON object a line, appended across loggers."""
    for mod, name in ((jobs, "j.jsonl"), (tobs, "t.jsonl")):
        for fields in (CALLS[:1], CALLS[1:]):     # two loggers, one file
            log = mod.MetricsLogger(str(tmp_path / "sub" / name))
            for f in fields:
                log.log(**f)
            log.close()
            log.close()                            # a second close is a no-op
    j, t = _lines(tmp_path / "sub" / "j.jsonl"), _lines(tmp_path / "sub"
                                                        / "t.jsonl")
    assert len(j) == len(t) == len(CALLS)
    for a, b, c in zip(j, t, CALLS):
        assert a.keys() == b.keys() == c.keys() | {"ts"}
        assert {k: v for k, v in b.items() if k != "ts"} == c
        assert isinstance(b["ts"], float)


def test_metrics_logger_is_a_noop(tmp_path, monkeypatch):
    """No path, or a rank other than 0, writes nothing."""
    log = tobs.MetricsLogger(None)
    log.log(a=1)
    log.close()
    monkeypatch.setattr(tobs, "_rank", lambda: 1)
    log = tobs.MetricsLogger(str(tmp_path / "m.jsonl"))
    log.log(a=1)
    log.close()
    assert log.path is None and not os.listdir(tmp_path)


@pytest.mark.parametrize("times,edges", [([], 10), ([0.5], 0),
                                         ([0.25, 0.5, 0.125], 4096)])
def test_step_timer_summary_matches_grandtpu(times, edges):
    j, t = jobs.StepTimer(edges), tobs.StepTimer(edges)
    j.times.extend(times)
    t.times.extend(times)
    assert t.summary() == j.summary()
    assert set(t.summary()) == {"batch_time_mean_s", "batches",
                                "train_edges_per_s"}
    with t:
        pass
    assert len(t.times) == len(times) + 1 and t.times[-1] >= 0.0


@pytest.fixture(scope="module")
def graph():
    data = load_data("synth:400:4:16", split_seed=0)
    return add_self_loops_adj(data.adj), np.asarray(data.features,
                                                    np.float32)


def test_profile_trace_holds_the_propagation(graph, tmp_path):
    """A Chrome trace in ``log_dir`` (created), named by rank, whose events
    include the plain K2's ops (the CPU runs the plain version)."""
    adj, feats = graph
    log_dir = tmp_path / "prof" / "run"
    with tobs.profile_trace(str(log_dir)):
        exact_propagate(adj, feats, backend="csr", order=3, device="cpu")
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].startswith("trace_rank0_")
    trace = json.load(open(log_dir / files[0]))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::index_add_" in names


def test_profile_trace_without_log_dir_writes_nothing(graph, tmp_path,
                                                      monkeypatch):
    adj, feats = graph
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with tobs.profile_trace(log_dir):
            exact_propagate(adj, feats, backend="csr", order=2, device="cpu")
    assert not os.listdir(tmp_path)


# --- the span recorder -----------------------------------------------------

def _profiled(fn):
    """``fn()`` inside a CPU ``torch.profiler`` profile: (its result, the
    span records it left, the names of the profiler's events)."""
    from torch.profiler import ProfilerActivity, profile

    tobs.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = tobs.spans()
    tobs.clear()
    return out, recs, {e.name for e in prof.events()}


def test_span_outside_a_profiler_is_the_shared_noop():
    """No profiler records: every call gives the same no-op object, which
    takes counts and records nothing."""
    tobs.clear()
    s = tobs.span("a")
    assert s is tobs.span("b", device="cpu")
    with s as t:
        t.add("n", 3)
        with tobs.span("c"):
            pass
    assert tobs.spans() == [] and tobs.dropped() == 0


def test_spans_inside_a_profiler_nest_under_their_roots():
    """Recorded: name, parent, root (one a top-level span), host times and
    counts, in the order opened; device ms None on the CPU; each name on
    the profiler's timeline; a span left by an exception still closes."""
    def work():
        with tobs.span("a") as a:
            a.add("n", 2)
            with tobs.span("a.b", device="cpu"):
                pass
            with tobs.span("a.c"):
                with tobs.span("a.c.d") as d:
                    d.add("n", 1)
            a.add("n", 3)
        with pytest.raises(ValueError):
            with tobs.span("e"):
                raise ValueError("inside a span")
        with tobs.span("z"):
            pass

    _, recs, names = _profiled(work)
    assert [r["name"] for r in recs] == ["a", "a.b", "a.c", "a.c.d", "e",
                                         "z"]
    by = {r["name"]: r for r in recs}
    a = by["a"]
    assert a["parent"] is None and a["root"] == a["id"]
    assert by["a.b"]["parent"] == by["a.c"]["parent"] == a["id"]
    assert by["a.c.d"]["parent"] == by["a.c"]["id"]
    assert {by[k]["root"] for k in ("a.b", "a.c", "a.c.d")} == {a["id"]}
    for k in ("e", "z"):
        assert by[k]["parent"] is None and by[k]["root"] == by[k]["id"]
    assert a["counts"] == {"n": 5} and by["a.c.d"]["counts"] == {"n": 1}
    assert by["a.b"]["counts"] == {}
    for r in recs:
        assert r["host_ms"] >= 0.0 and r["device_ms"] is None
    assert a["host_ms"] >= by["a.c"]["host_ms"] >= by["a.c.d"]["host_ms"]
    assert set(by) <= names


def test_span_records_are_capped(monkeypatch):
    """Past ``MAX_SPANS`` records a span still nests but is counted as
    dropped, not kept; ``clear`` forgets both."""
    monkeypatch.setattr(tobs, "MAX_SPANS", 2)

    def work():
        with tobs.span("r"):
            for _ in range(3):
                with tobs.span("r.c"):
                    pass
        return tobs.dropped()

    dropped, recs, _ = _profiled(work)
    assert dropped == 2 and [r["name"] for r in recs] == ["r", "r.c"]
    assert recs[1]["parent"] == recs[0]["id"]
    assert tobs.spans() == [] and tobs.dropped() == 0


# --- the predict path's spans ----------------------------------------------

def _mlp(num_features, classes=5, hidden=16, seed=0):
    import torch

    from grandtpu_torch.nn.mlp import MLP, MLPConfig

    torch.manual_seed(seed)
    return MLP(MLPConfig(num_features=num_features, num_classes=classes,
                         hidden=hidden, nlayers=2, use_bn=True))


def _mag(vocab, classes=5, hidden=16, seed=0):
    import torch

    from grandtpu_torch.nn.mag_mlp import MagMLP
    from grandtpu_torch.nn.mlp import MLPConfig

    model = MagMLP(MLPConfig(num_features=vocab, num_classes=classes,
                             hidden=hidden, nlayers=2))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


@pytest.fixture(scope="module")
def mag_graph():
    from grandtpu_torch.nn.sparse_input import PaddedFeatures

    data = load_data("synth:400:4:64:sparse", split_seed=0)
    padded = PaddedFeatures.from_csr(data.features)
    return (add_self_loops_adj(data.adj), padded.attr_cols,
            padded.attr_vals, data.features.shape[1])


def _dense_predict(graph, order=3):
    from grandtpu_torch.infer import Propagator, predict_logits

    adj, feats = graph
    prop = Propagator(adj, backend="csr", device="cpu")
    return predict_logits(_mlp(feats.shape[1]),
                          prop(feats, order=order), batch_size=150)


def _mag_predict(mag_graph, override):
    from grandtpu_torch.infer import Propagator, predict_logits_sparse

    adj, cols, vals, vocab = mag_graph
    kw = dict(order=3, batch_size=150)
    if override:
        prop = Propagator(adj, backend="csr", device="cpu")
        kw["propagate"] = lambda e: prop(e, order=3)
    return predict_logits_sparse(_mag(vocab), cols, vals, adj, **kw)


def _children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent["id"]]


def test_dense_predict_span_tree(graph):
    """``Propagator`` then ``predict_logits``: ``infer.propagate`` with one
    ``infer.propagate.hop`` a hop, and ``infer.classify`` with its head and
    its copy, which counts the logits' bytes; no name is one of the
    benchmark's own ranges."""
    from benchmark.trace import RANGES

    logits, recs, names = _profiled(lambda: _dense_predict(graph))
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["infer.propagate",
                                          "infer.classify"]
    prop, cls = roots
    assert _children(recs, prop) == ["infer.propagate.hop"] * 3
    assert _children(recs, cls) == ["infer.classify.head",
                                    "infer.classify.copy"]
    copy = next(r for r in recs if r["name"] == "infer.classify.copy")
    assert copy["counts"] == {"copy_bytes": logits.shape[0] * 5 * 4}
    assert logits.shape == (graph[1].shape[0], 5)
    assert {r["root"] for r in recs if r["parent"] is not None} == {
        prop["id"], cls["id"]}
    assert {r["name"] for r in recs} <= names
    assert not {r["name"] for r in recs} & set(RANGES)


@pytest.mark.parametrize("override", [False, True],
                         ids=["exact_propagate", "propagate="])
def test_mag_predict_span_tree(mag_graph, override):
    """``predict_logits_sparse``, with and without a ``propagate=``
    override: the embedding, the propagation and the classifier nest
    under one ``infer.predict_sparse`` root."""
    _, recs, _ = _profiled(lambda: _mag_predict(mag_graph, override))
    root = recs[0]
    assert root["name"] == "infer.predict_sparse"
    assert root["parent"] is None
    assert {r["root"] for r in recs} == {root["id"]}
    assert _children(recs, root) == ["infer.embed", "infer.propagate",
                                     "infer.classify"]
    prop = next(r for r in recs if r["name"] == "infer.propagate")
    assert _children(recs, prop) == ["infer.propagate.hop"] * 3
    assert sum(r["name"] == "infer.classify.copy" for r in recs) == 1


@pytest.mark.parametrize("path", ["dense", "mag"])
def test_logits_bit_for_bit_with_the_recorder_on_and_off(graph, mag_graph,
                                                         path):
    def run():
        if path == "dense":
            return _dense_predict(graph)
        return _mag_predict(mag_graph, override=False)

    tobs.clear()
    off = run()
    on, recs, _ = _profiled(run)
    assert recs and tobs.spans() == []
    assert on.dtype == off.dtype and np.array_equal(on, off)


# --- the benchmark's readers of the port's spans ---------------------------

def _rec(name, device_ms, host_ms=1.0, **counts):
    return {"name": name, "id": 0, "parent": None, "root": 0,
            "host_ms": host_ms, "device_ms": device_ms, "counts": counts}


FABRICATED = [
    _rec("infer.classify.copy", 200.0, 330.0, copy_bytes=460_000_000),
    _rec("infer.classify.copy", 100.0, 250.0, copy_bytes=460_000_000),
    _rec("infer.classify.copy", 400.0, 420.0, copy_bytes=460_000_000),
    _rec("infer.classify.head", 100.0), _rec("infer.classify.head", 140.0),
    _rec("infer.classify.head", 120.0),
    _rec("infer.propagate.hop", 2.0), _rec("infer.propagate.hop", 3.0),
    _rec("infer.propagate", 50.0),
    _rec("infer.embed", 10.0, 9.0), _rec("infer.embed", 10.0, 5.0),
    _rec("infer.embed", 10.0, 8.0),
]
READINGS = {"predict.copy_gbps": 2.3, "predict.head_ms": 120.0,
            "predict.hop_ms": 2.5, "predict.embed_host_pct": 80.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_span_readers(metric, monkeypatch):
    """Each reader of the port's spans: its median from a fabricated record
    set of a traced run; None untraced, without spans on the CPU, and
    with a program that records no spans (the parent of the recorder)."""
    from benchmark import harness

    read = harness.reader(metric)
    traced = {"window": object(), "spans_ms": {}}
    monkeypatch.setattr(tobs, "spans", lambda: FABRICATED)
    assert read(traced) == pytest.approx(READINGS[metric])
    assert read({"window": None, "spans_ms": {}}) is None
    cpu = [dict(r, device_ms=None) for r in FABRICATED]
    monkeypatch.setattr(tobs, "spans", lambda: cpu)
    assert read(traced) is None
    monkeypatch.delattr(tobs, "spans")
    assert read(traced) is None


# --- predict --profile-dir -------------------------------------------------

@pytest.mark.parametrize("spec", ["synth:400:4:16", "synth:400:4:64:sparse"])
def test_predict_profile_dir_holds_the_spans(spec, tmp_path, capsys):
    """``predict --profile-dir D`` writes one Chrome trace holding the
    port's ranges; without it no trace is written and the logits are the
    same."""
    from grandtpu_torch.cli.main import cli
    from grandtpu_torch.config import GrandConfig
    from grandtpu_torch.nn.mlp import MLPConfig
    from grandtpu_torch.train.checkpoint import model_trees, save_checkpoint

    sparse = spec.endswith(":sparse")
    data = load_data(spec, split_seed=0)
    c = GrandConfig()
    cfg = MLPConfig(num_features=data.features.shape[1],
                    num_classes=data.num_classes, hidden=c.hidden,
                    nlayers=c.nlayers, use_bn=c.use_bn)
    model = (_mag(cfg.num_features, cfg.num_classes, cfg.hidden) if sparse
             else _mlp(cfg.num_features, cfg.num_classes, cfg.hidden))
    params, state = model_trees(model)
    ckpt = str(tmp_path / "best.npz")
    save_checkpoint(ckpt, params=params, state=state)
    prof = tmp_path / "prof"
    common = ["predict", "--dataset", spec, "--ckpt", ckpt, "--device",
              "cpu"]
    for name, extra in (("with", ["--profile-dir", str(prof)]),
                        ("without", [])):
        assert cli(common + ["--output", str(tmp_path / f"{name}.npz")]
                   + extra) == 0
        assert '"test_acc"' in capsys.readouterr().out
        if name == "with":
            files = os.listdir(prof)
            assert len(files) == 1
    events = json.load(open(prof / files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"infer.propagate", "infer.propagate.hop", "infer.classify",
            "infer.classify.head", "infer.classify.copy"} <= names
    assert ("infer.predict_sparse" in names) == sparse
    assert os.listdir(prof) == files
    with np.load(tmp_path / "with.npz") as a, \
            np.load(tmp_path / "without.npz") as b:
        assert np.array_equal(a["logits"], b["logits"])
