"""The readings that the limits of ``correct`` are set from, beyond the
benchmark's own runs (which give the program's readings).

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13
    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 \
        --fault altered_answer --seconds 3

Without ``--fault`` it reads the control: the reference put in the
program's place, computed in the nearest precision below the one the
configuration states (TF32 matmuls for float32 with TF32 off), judged by
the same numbers against the reference, at the cell's own size. With
``--fault`` it runs the cell with that fault planted under the timed path
(``faults.py``). Each reading is held to the cell's limits
(``limits/<cell>.json``) as a run's are: one JSON line a seed, with
``correct`` and each number beside its limit. It exits with 1 when any
seed's control or fault comes out correct: the limits would not catch it.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from benchmark import faults, harness, reference, run, standin, weights
from benchmark.predict import Updates, sub_seed


def predict_control(cfg: dict, traffic: dict, seed: int, device,
                    dirs: dict) -> dict:
    """logit_gap of the TF32 reference against the float32 one, on the
    state the window's first request leaves."""
    raw = standin.raw_arrays(cfg, standin.data_root(cfg, dirs["data"]))
    params = weights.make(cfg, sub_seed(seed, 0), device)
    dense = cfg["engine"] == "dense"
    base = torch.as_tensor(raw["features"], device=device) if dense \
        else params["table"]
    updates = Updates(seed, base.shape[0], base.shape[1],
                      traffic["rows_per_request"], device)
    with torch.no_grad():
        for _ in range(traffic["warmup_requests"] + 1):
            rows, vals = updates.next()
            base[rows] = vals
    feats = base if dense else None
    want = reference.predict_logits(cfg, raw, feats, params, device)
    got = reference.predict_logits(cfg, raw, feats, params, device,
                                   tf32=True)
    return {"logit_gap": reference.logit_gap(got, want)}


def read(name: str, seed: int, device, fault: str | None = None,
         seconds: float = 3.0, root: str = harness.ROOT,
         overrides: dict | None = None, bench: dict | None = None) -> dict:
    """The control's (or, with ``fault``, the faulty program's) compared
    numbers of cell ``name`` on ``seed``."""
    bench = bench or harness.manifest(root)
    if fault is not None:
        with faults.planted(fault):
            _, compared, _ = run.run_cell(name, seed, seconds, False, device,
                                          root=root, bench=bench,
                                          overrides=overrides)
        return {k: c["value"] for k, c in compared.items()}
    _, cfg, traffic = harness.cell(name, bench)
    for key, part in (overrides or {}).items():
        {"cfg": cfg, "traffic": traffic}[key].update(part)
    dirs = harness.cache_dirs(root)
    return predict_control(cfg, traffic, seed, torch.device(device), dirs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", choices=faults.FAULTS)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    passed = []
    for s in args.seeds.split(","):
        with contextlib.redirect_stdout(sys.stderr):
            numbers = read(args.workload, int(s), "cuda:0", args.fault,
                           args.seconds)
        compared, correct = run.compare(args.workload, numbers)
        if correct:
            passed.append(int(s))
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "reading": args.fault or "control",
                          "correct": correct, "compared": compared}),
              flush=True)
    if passed:
        print(f"control: {args.fault or 'the control'} came out correct on "
              f"seeds {passed}: the limits do not separate it",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
