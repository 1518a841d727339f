"""BENCHMARK.json against the contract, and every cell, configuration,
traffic mix, metric and limit resolving by name to a file of its own."""

import json
import os
import re
import sys
import types

import pytest

from benchmark import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head",
          "features", "top_k", "sample", "expansion")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert os.path.isdir(os.path.join(harness.ROOT, p))
        assert not p.endswith("_torch")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_texts():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_resolves(name):
    work, cfg, traffic = harness.cell(name, BENCH)
    assert work["chips"] in (1, 4)
    assert cfg["name"] == work["config"]
    assert os.path.isfile(os.path.join(harness.HERE, f"{traffic['driver']}"
                                       ".py"))
    with open(os.path.join(harness.HERE, "limits", f"{name}.json")) as f:
        assert json.load(f)
    e2e, layers = harness.metrics_of(name, BENCH)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layers


READERS = sorted(f[:-3] for f in os.listdir(os.path.join(harness.HERE,
                                                        "metrics"))
                 if f.endswith(".py"))


@pytest.mark.parametrize("name", READERS)
def test_every_reader_loads_and_reads_nothing_untraced(name):
    assert harness.reader(name)({"window": None, "spans_ms": {}}) is None


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader(name):
    m = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert callable(harness.reader(name))
    moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for w in m["workloads"]:
        assert w in WORKLOADS
        assert "workloads" not in moves or w in moves["workloads"]
    if name.endswith("_roofline") or "mfu" in name:
        assert m["unit"] == "%"


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert conf["file"].startswith(tuple(BENCH["paths"]))
    with open(os.path.join(harness.ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert NAME.fullmatch(key)
        assert not key.endswith(("_dim", "_rank"))
        assert not any(w in key for w in WIDTHS), key
        assert key in cfg.get("published", {}), key


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("grandtpu_torch", "grandtpu_torch.nn", "jaxtyping_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "grandtpu.nn",
                        types.ModuleType("grandtpu.nn"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert set(harness.forbidden_modules()) - base == {"grandtpu", "jax"} \
        - base


def test_harness_imports_no_jax():
    import subprocess

    code = ("import sys; import benchmark.run, benchmark.control; "
            "import benchmark.predict; "
            "from benchmark import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
