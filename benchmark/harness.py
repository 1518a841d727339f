"""What every cell shares: the manifest and the files it names, the checks
before and after a run, and the result's last line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose ``driver`` names the
module that runs it, ``predict.py`` today); each per-layer metric is a
reader of its own, ``metrics/<name>.py`` with ``read(obs) -> float |
None``. A later cell or metric is added as files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the top-level modules the timed process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "grandtpu")


def process_start() -> float:
    """The epoch second this process started, from /proc (the kernel's
    record); the time of this call where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(name: str, bench: dict) -> tuple:
    """(workload entry, configuration, traffic mix) of the cell ``name``."""
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    cfg = _json(os.path.relpath(os.path.join(ROOT, conf["file"]), HERE))
    traffic = _json("traffic", f"{work['traffic']}.json")
    return work, cfg, traffic


def metrics_of(name: str, bench: dict) -> tuple:
    """(end-to-end, per-layer) metric entries that cell ``name`` reports."""
    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def reader(metric: str):
    """The ``read(obs)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cache_dirs(root: str) -> dict:
    """The fixed directories inside the checkout where the program's caches
    and the stand-in data live; Triton's and torch's extension caches are
    pointed there too."""
    base = os.path.join(root, "build", "benchmark")
    dirs = {"data": os.path.join(base, "data"),
            "triton": os.path.join(base, "triton"),
            "extensions": os.path.join(base, "torch_extensions")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = dirs["triton"]
    os.environ["TORCH_EXTENSIONS_DIR"] = dirs["extensions"]
    return dirs


def card_info() -> str:
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def value(v: float, unit: str) -> dict:
    if v is None or not math.isfinite(v):
        raise ValueError(f"a metric read {v!r}")
    return {"value": float(v), "unit": unit}


def emit(result: dict, compared: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output,
    the compared numbers under its last key."""
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["compared"] = compared
    print(json.dumps(line), flush=True)
