"""The result's last line and the run's refusals."""

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

from benchmark import harness, run
from benchmark.tests.conftest import SMALL


def test_last_line_shape(root):
    result, compared, _ = run.run_cell("mag-predict", 3, 0.3, False, "cpu",
                                       root=root,
                                       overrides=SMALL["mag-predict"])
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(result, compared)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    e2e, _ = harness.metrics_of("mag-predict", harness.manifest())
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    tail = err.getvalue().strip().splitlines()[-len(compared):]
    assert all(t.startswith("compared ") and " limit " in t for t in tail)


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "mag-predict",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from benchmark import run; "
            "run.run_cell('mag-predict', 1, 0.2, False, 'cpu', "
            f"overrides={SMALL['mag-predict']!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
