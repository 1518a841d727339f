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
