"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from a stretch of the
window traced by ``torch.profiler`` and from the benchmark's own spans. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``compared``: each number held to the reference beside its
limit, which are also the last lines of standard error.

It exits with 2 and prints no result without the CUDA cards the cell asks
for, and with 3 when a module of JAX or of the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

from benchmark import harness

START = harness.process_start()


def limits(name: str) -> dict:
    with open(os.path.join(harness.HERE, "limits", f"{name}.json")) as f:
        return json.load(f)


def compare(name: str, numbers: dict) -> tuple:
    """(each of cell ``name``'s compared numbers beside its limit, whether
    every one is within it)."""
    bounds = limits(name)
    compared = {k: {"value": v, "limit": bounds[k]}
                for k, v in numbers.items()}
    return compared, all(c["value"] <= c["limit"]
                         for c in compared.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: str = harness.ROOT, bench: dict | None = None,
             overrides: dict | None = None) -> tuple:
    """(result line without ``compared``, compared numbers with their
    limits, the driver's detail) of one run of cell ``name`` on
    ``device``."""
    import torch

    bench = bench or harness.manifest(root)
    work, cfg, traffic = harness.cell(name, bench)
    for key, part in (overrides or {}).items():
        {"cfg": cfg, "traffic": traffic}[key].update(part)
    e2e, layers = harness.metrics_of(name, bench)
    device = torch.device(device)
    ctx = {"cfg": cfg, "traffic": traffic, "seed": seed, "seconds": seconds,
           "trace": trace, "device": device,
           "dirs": harness.cache_dirs(root), "name": name}
    if trace and device.type == "cuda":
        ctx["record_function"] = torch.profiler.record_function
    out = importlib.import_module(f"benchmark.{traffic['driver']}").run(ctx)
    setup_s = out["t_window"] - START
    metrics = {}
    if trace:
        for m in layers:
            v = harness.reader(m["name"])(out["obs"])
            if v is not None:
                metrics[m["name"]] = harness.value(v, m["unit"])
    else:
        for m in e2e:
            v = setup_s if m["name"] == "setup_s" else out["e2e"][m["name"]]
            metrics[m["name"]] = harness.value(v, m["unit"])
    compared, within = compare(name, out["compared"])
    correct = out["failed"] == 0 and within
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": work["chips"], "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    window = out["obs"].get("window")
    if trace and window is not None:
        dev["busy_s"] = window.busy_s()
        dev["window_s"] = window.wall_s
        result["breakdown"] = window.breakdown()
    return result, compared, out.get("detail", {})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = harness.manifest()
    work, _, _ = harness.cell(args.workload, bench)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < work["chips"]):
        print(f"benchmark: {args.workload} needs {work['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result, compared, detail = run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            "cuda:0", bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the timed process must "
              f"not hold JAX or the JAX package", file=sys.stderr)
        return 3
    print(f"card: {harness.card_info()}", file=sys.stderr)
    print(f"detail: {json.dumps(detail)}", file=sys.stderr)
    harness.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
