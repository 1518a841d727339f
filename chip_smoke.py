#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``grandtpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the result line:

1. device: CUDA present; the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel of ``grandtpu_torch/csrc`` for sm_90a;
3. kernels vs their plain PyTorch versions on the card, at reddit width
   (K1 DropNode gather-mean: features [233000, 602], cols/vals [250, 64],
   K = 2 with a fixed mask, and the eval form [1230, 64]; K2 CSR SpMM: 6
   ppr hops on the operator of ``synth:233000:41:602``), with max relative
   error <= 1e-5 (f32 sums in another order) and kernel / plain / library
   times and each kernel's bound;
4. reference on a small input: ``train()`` with DropNode off on
   ``synth:2000:8:64`` on the card and on the CPU (plain versions) gives
   the same validation history (|d val_loss| <= 1e-4) and test accuracy
   within one node;
5. main path: ``train()`` with the reddit preset on
   ``synth:233000:41:602`` for 2 epochs, launch counters set to 0 just
   before; losses finite, K1 launched for every step and eval, K2 exactly
   ``order`` times;
6. profile: the main path once more under torch.profiler, device time by
   kernel and the device's busy share (after the counters were read).

It prints one ``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from grandtpu_torch.config import preset
from grandtpu_torch.data import load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.infer import Propagator
from grandtpu_torch.nn.dropnode import gather_and_prop, gather_and_prop_plain
from grandtpu_torch.ops._build import build, build_dir
from grandtpu_torch.sparse.spmm import spmm_prop_step, spmm_prop_step_plain
from grandtpu_torch.train import train

DATASET = "synth:233000:41:602"     # RESULTS.md's reddit scale stand-in
SMALL = "synth:2000:8:64"
# K1 at the main path's shapes: N, F, B = 50 + 200, Ktop, K, eval rows
K1_SHAPE = (233000, 602, 250, 64, 2, 1230)
TOL = 1e-5                          # max |kernel - plain| / max |plain|
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12             # f32 outside the tensor cores
DEV = torch.device("cuda", 0)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls
    (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(DEV)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(DEV)
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _errors(got: torch.Tensor, want: torch.Tensor):
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    t0 = time.time()
    path = build()
    print(f"[build] {path} in {time.time() - t0:.3f} s", flush=True)
    with open(os.path.join(build_dir(), "nvcc.log")) as f:
        for line in f:
            if line.startswith("==") or "registers" in line or "spill" in line:
                print(f"[build] {line.rstrip()}")


def check_k1() -> dict:
    n, nfeat, batch, ktop, num_aug, n_eval = K1_SHAPE
    g = torch.Generator(device=DEV).manual_seed(0)
    features = torch.randn(n, nfeat, generator=g, device=DEV)
    # distinct batches in turn, so the timed gathers miss the 50 MB L2 as
    # a train step's fresh batch does (8 x 38.5 MB)
    col_sets = [torch.randint(0, n, (batch, ktop), generator=g, device=DEV,
                              dtype=torch.int32) for _ in range(8)]
    vals = torch.rand(batch, ktop, generator=g, device=DEV)
    keep = torch.rand(num_aug, batch, ktop, generator=g, device=DEV) < 0.5
    cols_e = torch.randint(0, n, (n_eval, ktop), generator=g, device=DEV,
                           dtype=torch.int32)
    vals_e = torch.rand(n_eval, ktop, generator=g, device=DEV)

    got = gather_and_prop(features, col_sets[0], vals, keep)
    got_e = gather_and_prop(features, cols_e, vals_e)
    torch.cuda.synchronize(DEV)
    abs_err, rel_err = _errors(
        got, gather_and_prop_plain(features, col_sets[0], vals, keep))
    abs_e, rel_e = _errors(got_e,
                           gather_and_prop_plain(features, cols_e, vals_e))
    print(f"[K1] train [{num_aug},{batch},{nfeat}] max_abs_err {abs_err} "
          f"max_rel_err {rel_err}; eval [1,{n_eval},{nfeat}] max_abs_err "
          f"{abs_e} max_rel_err {rel_e}", flush=True)
    if not (rel_err <= TOL and rel_e <= TOL):
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"{rel_err}, {rel_e} > {TOL}")

    w = torch.where(keep, vals[None], 0.0).reshape(num_aug * batch, ktop)
    den = w.sum(-1, keepdim=True) + 1e-12
    idx_sets = [c.long().repeat(num_aug, 1) for c in col_sets]

    def library(idx):
        return F.embedding_bag(idx, features, per_sample_weights=w,
                               mode="sum") / den

    it = itertools.cycle(col_sets)
    ms = _time_ms(lambda: gather_and_prop(features, next(it), vals, keep),
                  400)
    plain_ms = _time_ms(
        lambda: gather_and_prop_plain(features, next(it), vals, keep), 50)
    it_idx = itertools.cycle(idx_sets)
    library_ms = _time_ms(lambda: library(next(it_idx)), 200)
    eval_ms = _time_ms(lambda: gather_and_prop(features, cols_e, vals_e), 200)

    def bound(rows, k, uniq):
        # each distinct gathered row read once; cols, vals, mask, output
        nbytes = (uniq * nfeat * 4 + rows * ktop * 8 + k * rows * ktop
                  + k * rows * nfeat * 4)
        return _bound(nbytes, 2 * k * rows * ktop * nfeat
                      + k * rows * nfeat), nbytes

    (bound_ms, bound_by), nbytes = bound(
        batch, num_aug, np.mean([torch.unique(c).numel() for c in col_sets]))
    (eval_bound_ms, _), _ = bound(n_eval, 1, torch.unique(cols_e).numel())
    print(f"[K1] ms {ms} plain_ms {plain_ms} library_ms {library_ms} "
          f"bound_ms {bound_ms} ({bound_by}, {nbytes / 1e6:.1f} MB); "
          f"eval form ms {eval_ms} bound_ms {eval_bound_ms}", flush=True)
    return {"name": "dropnode_mean", "route": "cuda",
            "source": "grandtpu_torch/csrc/dropnode_mean.cu",
            "replaces": "grandtpu/nn/dropnode.py:21",
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"features [{n},{nfeat}], cols [{batch},{ktop}], "
                     f"K={num_aug}", "eval_ms": eval_ms,
            "eval_bound_ms": eval_bound_ms, "eval_max_abs_err": abs_e}


def check_k2(data) -> dict:
    cfg = preset("reddit")
    op = Propagator(add_self_loops_adj(data.adj), device=DEV).adj_op
    n, nnz = op.num_rows, op.nnz
    x = torch.as_tensor(data.features, device=DEV)
    nfeat = x.shape[1]
    scale = 1.0 - cfg.alpha

    def ppr_hops(step):
        cur_in = cfg.alpha * x
        acc = cur_in.clone()
        cur_out = torch.empty_like(cur_in)
        for _ in range(cfg.order):
            step(op, cur_in, cur_out, acc, scale, True)
            cur_in, cur_out = cur_out, cur_in
        return acc

    got = ppr_hops(spmm_prop_step)
    torch.cuda.synchronize(DEV)
    abs_err, rel_err = _errors(got, ppr_hops(spmm_prop_step_plain))
    del got
    print(f"[K2] {cfg.order} ppr hops, n {n} nnz {nnz} F {nfeat}: "
          f"max_abs_err {abs_err} max_rel_err {rel_err}", flush=True)
    if not rel_err <= TOL:
        raise AssertionError(f"K2 disagrees with its plain version: "
                             f"{rel_err} > {TOL}")

    y, acc = torch.empty_like(x), torch.zeros_like(x)
    ms = _time_ms(lambda: spmm_prop_step(op, x, y, acc, scale, True), 30)
    plain_ms = _time_ms(
        lambda: spmm_prop_step_plain(op, x, y, acc, scale, True), 5)
    a_csr = torch.sparse_csr_tensor(op.indptr, op.indices, op.values,
                                    size=(n, n))
    library_ms = _time_ms(lambda: torch.sparse.mm(a_csr, x), 30)
    nbytes = 4 * n * nfeat * 4 + 8 * nnz + 4 * (n + 1)
    flops = 2 * nnz * nfeat + 2 * n * nfeat
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"[K2] per hop: ms {ms} plain_ms {plain_ms} library_ms "
          f"{library_ms} (torch.sparse.mm, y = A x only) bound_ms "
          f"{bound_ms} ({bound_by}, {nbytes / 1e9:.3f} GB)", flush=True)
    return {"name": "csr_spmm_prop", "route": "cuda",
            "source": "grandtpu_torch/csrc/csr_spmm.cu",
            "replaces": "grandtpu/sparse/spmm.py:431",
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"x [{n},{nfeat}], nnz {nnz}, per hop"}


def check_small_reference() -> None:
    cfg = preset("reddit").replace(dataset=SMALL, epochs=3, unlabel_num=500,
                                   dropnode_rate=0.0)
    data = load_data(SMALL, split_seed=cfg.seed1)
    gpu = train(cfg, data=data, device=DEV)
    cpu = train(cfg, data=data, device="cpu")
    d_loss = max(abs(a["val_loss"] - b["val_loss"])
                 for a, b in zip(gpu.history, cpu.history, strict=True))
    d_acc = abs(gpu.test_acc - cpu.test_acc) * len(data.idx_test)
    print(f"[small] {SMALL}: {len(gpu.history)} evals, max |d val_loss| "
          f"{d_loss}, test_acc gpu {gpu.test_acc} cpu {cpu.test_acc}",
          flush=True)
    if not (d_loss <= 1e-4 and d_acc <= 1.0 + 1e-9):
        raise AssertionError("GPU run disagrees with the CPU reference")


def run_main_path(data) -> dict:
    cfg = preset("reddit").replace(dataset=DATASET, epochs=2)
    gather_and_prop.launches = 0
    spmm_prop_step.launches = 0
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.time()
    r = train(cfg, data=data, device=DEV)
    wall = time.time() - t0
    launches = {"dropnode_mean": gather_and_prop.launches,
                "csr_spmm_prop": spmm_prop_step.launches}
    evals = len(r.history)
    print(f"[main] reddit preset on {DATASET}, 2 epochs: steps "
          f"{r.num_batches}, evals {evals}, launches {launches}, test_acc "
          f"{r.test_acc}, best_val_acc {r.best_val_acc}, preprocess_s "
          f"{r.preprocess_time}, batch_time_median_s {r.batch_time_median}, "
          f"propagate_s {r.propagate_time}, total_s {r.total_time}, "
          f"train_call_s {wall}, peak_mem_GB "
          f"{torch.cuda.max_memory_allocated(DEV) / 1e9}", flush=True)
    losses = [v for h in r.history for v in (h["loss"], h["val_loss"])]
    if not (evals > 0 and np.all(np.isfinite(losses))):
        raise AssertionError(f"non-finite losses: {r.history}")
    if not 0.0 <= r.test_acc <= 1.0:
        raise AssertionError(f"test_acc {r.test_acc}")
    if launches["dropnode_mean"] < r.num_batches + evals:
        raise AssertionError("K1 was not launched for every step and eval")
    if launches["csr_spmm_prop"] != cfg.order:
        raise AssertionError(f"K2 launched {launches['csr_spmm_prop']} "
                             f"times, expected order={cfg.order}")
    return launches


def profile_main_path(data) -> None:
    """The main path once more under torch.profiler: device time by kernel
    and the device's busy share of the ``train()`` call."""
    from torch.profiler import ProfilerActivity, profile

    cfg = preset("reddit").replace(dataset=DATASET, epochs=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        r = train(cfg, data=data, device=DEV)
        torch.cuda.synchronize(DEV)
        wall_ms = (time.time() - t0) * 1e3
    # device events, without the user-annotation ranges (such as
    # Optimizer.step) that span other kernels
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("[profile] the profiler recorded no device time")
        return
    by_name: dict[str, list] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy_ms = sum(t for t, _ in by_name.values())
    copy_ms = sum(t for k, (t, _) in by_name.items()
                  if k.startswith(("Memcpy", "Memset")))
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3
    print(f"[profile] train() {wall_ms} ms wall (profiled), device busy "
          f"{busy_ms} ms = {100 * busy_ms / wall_ms}% of wall (copies "
          f"{copy_ms} ms, kernels {busy_ms - copy_ms} ms), first to last "
          f"device event {span_ms} ms, {len(kernels)} device events, "
          f"{r.num_batches} steps; batch_time_median_s "
          f"{r.batch_time_median}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for i, (name, (t, n)) in enumerate(ranked):
        if i < 14 or "dropnode_mean" in name or "csr_spmm" in name:
            print(f"[profile] {t:10.4f} ms {n:6d}x {name[:100]}")


def main() -> int:
    phase_device()
    phase_build()
    t0 = time.time()
    data = load_data(DATASET, split_seed=preset("reddit").seed1)
    print(f"[data] {DATASET} generated in {time.time() - t0:.3f} s",
          flush=True)
    kernels = [check_k1(), check_k2(data)]
    check_small_reference()
    launches = run_main_path(data)
    profile_main_path(data)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
