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
3e. GFPush on the card, with the reddit preset's push (ppr, order 6, alpha
    0.05, rmax 1e-5, k 64) from the 12,050 sources ``train()`` builds:
    ``gfpush(backend="jax")`` (P1: the push mask, K2 over A^T at [233000,
    512], the top-k) and ``gfpush(backend="bucket")`` (P2: expansion,
    compaction, top-k), each a path of its own (counts set to 0 before,
    read after), each held to the native push under the row rule of
    tests/test_gfpush_backends.py (atol = tie_tol = max(1e-5, 2 rmax)), to
    its plain version on the card (P2 bit for bit, its sums being fixed
    point; P1 cols equal and vals <= 1e-5, K2 adding in edge order), and to
    a second run (identical); kernel / plain / library (``torch.topk``)
    times and bounds, and sources/s beside native's with the host's cores;
4. reference on a small input: ``train()`` with DropNode off on
   ``synth:2000:8:64`` on the card and on the CPU (plain versions) gives
   the same validation history (|d val_loss| <= 1e-4) and test accuracy
   within one node;
4d. the same with ``push_backend="bucket"`` (P2 on the card, its plain
    version on the CPU);
5. main path: ``train()`` with the reddit preset on
   ``synth:233000:41:602`` for 2 epochs, launch counters set to 0 just
   before; losses finite, K1 launched for every step and eval, K2 exactly
   ``order`` times;
6. profile: the main path once more under torch.profiler, device time by
   kernel and the device's busy share (after the counters were read).

Then the same for the MAG (sparse-feature) engine, on
``synth:1000000:8:2780000:sparse`` (vocabulary 2,780,000, P = 24):

3c. K3 embed_prop forward and backward vs their plain versions (autograd
    for the backward) at the ``mag_scholar_c`` shapes: table
    [2780000, 64], attr tables [1000000, 24]; the train form (R = 40,
    Ktop = 32, K = 2) without and with a q = 0.5 input-dropout mask, the
    eval form (K = 1, the 240 val rows) and the node form on a
    10,000-node chunk; max relative error <= 1e-5 (the backward's
    atomics sum in another order); K2 timed at H = 64 on the MAG
    operator;
4b. reference on a small input: ``train()`` with the mag_scholar_c
    preset, every drop rate 0, on ``synth:2000:8:500:sparse`` on the card
    and on the CPU: |d val_loss| <= 1e-4 at every eval, test accuracy
    within one node;
5b. MAG main path: ``train()`` with the mag_scholar_c preset, 5 epochs
    (40 steps, 4 evals, then embed -> 10 K2 hops -> head over all 1M
    nodes), counters set to 0 just before; losses finite, the K3 forward
    launched for every step, eval and predict chunk, the K3 backward once
    per step, K2 exactly ``order`` times;
6b. profile of the MAG main path.

Then the fast-precision predict, with the Amazon2M preset (F = 100,
hidden 1024, 47 classes, ppr order 6, alpha 0.2) on
``synth:2000000:47:100`` (2M nodes, 8,885,478 nonzeros with self-loops):

3d. K1 against its plain version at the Amazon2M path's shapes (its
    features [2000000, 100], cols/vals [250, 64], K = 2, and the eval form
    [1410, 64]), <= 1e-5; K2 (f32) for 6 ppr hops against its plain
    version, <= 1e-5; K2-bf16 (f32 and bf16 carries), quantize, K2-q8 and
    K2-q8mxu against their plain versions at the Amazon2M shape
    [2000000, 100], 6 ppr hops each, one hop at a time on a shared input
    (both take the plain hop's output): quantize's q equal element for
    element, K2-q8mxu <= 1e-6 (int32 sums are exact), K2-bf16 with f32
    carries and K2-q8 <= 1e-5, bf16 carries bit for bit (the plain
    versions add in the kernels' order); each whole 6-hop run against the
    f32 K2 result: <= 5e-3 (bf16, int8, int8cast, the fast-path gate) and
    <= 2e-2 (bf16_carry); kernel / plain / library times and bounds;
7.  precision sweep, on the operators 3d built: ``order`` hops timed for
    f32, bf16, int8 (K2-q8mxu), int8cast (K2-q8) and bf16 carries, each
    with its error against f32 and its peak memory; then ``calibrate()``
    with its default candidates. Every hop kernel must have launched on
    this path;
4c. reference on a small input: ``exact_propagate(backend="csr")`` for
    every precision on ``synth:30000:8:64`` (above the dense threshold) on
    the card and on the CPU (<= 1e-5 f32, <= 5e-3 fast forms, <= 2e-2
    bf16_carry), then ``train()`` with the Amazon2M preset, every drop rate
    0 and ``predict_precision="auto"``: |d val_loss| <= 1e-4 at every
    eval, test accuracy within one node;
5c. main path: ``train()`` with the Amazon2M preset, 2 epochs,
    ``predict_precision="auto"`` (which resolves to int8, so K2-q8mxu),
    counters set to 0 just before; losses finite, K1 launched for every
    step and eval, quantize and K2-q8mxu exactly ``order`` times each, the
    f32 K2 not at all;
6c. profile of the Amazon2M main path;
3f. (after 7) P2 as in 3e with the Amazon2M preset's push (rmax 1e-6, the
    deepest of the presets) from the 12,350 sources of its ``train()``,
    against native, its plain version and a second run; its kernels' times
    at these shapes are the kernels line's;
5d. the Amazon2M ``train()`` of 5c with ``push_backend="bucket"`` and a
    checkpoint directory: the P2 kernels and the top-k launch, the 5c
    checks hold, preprocess_time printed beside 5c's (native);
3g. (after 7, on 3d's graph) K2-seg: 6 ppr hops of ``spmm_segment``
    against its plain version, one at a time on a shared input (<= 1e-5:
    a row over several edge runs adds with atomics), the
    ``Propagator(backend="segment")`` run as a path (K2-seg exactly
    ``order`` launches) against the csr backend's f32 run (<= 1e-5), its
    peak device memory against the csr run's, and kernel / plain / library
    (``torch.sparse.mm`` on the coalesced COO) times with the bound;
8.  D1, row-partitioned propagation on a 4-shard mesh on the one card
    (``make_mesh(4, devices=[cuda:0] * 4)``): ``dist_exact_propagate``
    all_gather in f32, bf16 and int8 and halo (``halo_threshold=1.0``) in
    f32 and int8, and ``sharded_propagate`` (K2-seg) in f32, each a path of
    its own with exact launch counts (order x 4 of its hop kernel, and of
    ``column_absmax``/``quantize_with_amax``/``halo_pack`` where the form
    runs them), each against its own plain run on the card (<= 1e-5 f32
    and bf16 terms, 5e-3 int8) and against the one-card ``Propagator`` at
    the same precision (f32 <= 1e-5; the fast forms within the 5e-3 gate
    of f32); then the halo kernels', the quantize split's and the
    collectives' times at the shard shapes, and the halo compression;
5e. the slice's main path, serving: ``python -m grandtpu_torch.cli.main
    predict --preset Amazon2M --dataset synth:2000000:47:100 --ckpt
    <5d's best.npz>`` (run in this process through ``cli()``, its counts
    read around it) with ``--precision f32`` and ``auto``: its test
    accuracy equals that of the 5d model at the same precision (auto:
    5d's own), its npz holds [2000000, 47] logits, its hop kernels launch
    ``order`` times; the wall time split into data, checkpoint, operator
    build, hops and classify.

Every path (5, 5b, 5c, 5d, 7) must launch exactly the hop kernels of the
form its predict's hops ran (``TrainResult.predict_precision``), and the
push kernels of its push backend only (none with native); the training
paths launch none of D1's or K2-seg's. It prints one
``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from grandtpu_torch.cli.main import cli
from grandtpu_torch.config import preset
from grandtpu_torch.data import load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.dist import (ShardedGraph, ShardedPropagator,
                                 dist_exact_propagator, make_mesh)
from grandtpu_torch.dist.halo import (halo_hop, halo_hop_plain, halo_pack,
                                      halo_pack_plain)
from grandtpu_torch.infer import Propagator, exact_propagate, test_accuracy
from grandtpu_torch.infer.classify import embed_all_nodes
from grandtpu_torch.nn.dropnode import gather_and_prop, gather_and_prop_plain
from grandtpu_torch.nn.sparse_input import (PaddedFeatures, embed_prop,
                                            embed_prop_backward,
                                            embed_prop_plain)
from grandtpu_torch.ops._build import build, build_dir
from grandtpu_torch.ppr import bucket_push, dense_push, gfpush
from grandtpu_torch.ppr.coef import build_coef
from grandtpu_torch.ppr.dense_push import (dense_push_mask,
                                           dense_push_mask_plain)
from grandtpu_torch.ppr.native import gfpush_native
from grandtpu_torch.ppr.push_topk import push_topk, push_topk_plain
from grandtpu_torch.sparse.spmm import (column_absmax, column_absmax_plain,
                                        quantize_columns,
                                        quantize_columns_plain,
                                        quantize_with_amax,
                                        quantize_with_amax_plain,
                                        spmm_prop_step, spmm_prop_step_bf16,
                                        spmm_prop_step_plain,
                                        spmm_prop_step_q8,
                                        spmm_prop_step_q8_plain,
                                        spmm_prop_step_q8mxu,
                                        spmm_prop_step_q8mxu_plain,
                                        spmm_segment, spmm_segment_plain)
from grandtpu_torch.train import train

DATASET = "synth:233000:41:602"     # RESULTS.md's reddit scale stand-in
SMALL = "synth:2000:8:64"
# K1 at the main path's shapes: N, F, B = 50 + 200, Ktop, K, eval rows
K1_SHAPE = (233000, 602, 250, 64, 2, 1230)
# and at the Amazon2M path's (its features; 47 classes x 30 val rows)
AMAZON_K1_SHAPE = (2000000, 100, 250, 64, 2, 1410)
MAG_DATASET = "synth:1000000:8:2780000:sparse"   # tools/mag_scale_run.py vocab
MAG_SMALL = "synth:2000:8:500:sparse"
# K3 at the MAG main path's shapes: batch rows 20 + 20, Ktop, K, val rows
# (8 classes x 30), predict chunk
K3_SHAPE = (40, 32, 2, 240, 10000)
H_MAG = 64                          # mag_scholar_c hidden width
AMAZON = "synth:2000000:47:100"     # RESULTS.md's Amazon2M stand-in
AMAZON_SMALL = "synth:30000:8:64"   # above the dense threshold
SHARDS = 4                          # phase 8's mesh, on the one card
CKPT_DIR = os.path.join("build", "chip_smoke_ckpt")   # 5d's best.npz
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


def check_k1(shape, features=None, tag: str = "K1") -> dict:
    """K1 against its plain version at ``shape`` (N, F, B, Ktop, K, eval
    rows), gathering from ``features`` [N, F] (random if None)."""
    n, nfeat, batch, ktop, num_aug, n_eval = shape
    g = torch.Generator(device=DEV).manual_seed(0)
    if features is None:
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
    print(f"[{tag}] train [{num_aug},{batch},{nfeat}] max_abs_err {abs_err} "
          f"max_rel_err {rel_err}; eval [1,{n_eval},{nfeat}] max_abs_err "
          f"{abs_e} max_rel_err {rel_e}", flush=True)
    if not (rel_err <= TOL and rel_e <= TOL):
        raise AssertionError(f"{tag} disagrees with its plain version: "
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
    print(f"[{tag}] ms {ms} plain_ms {plain_ms} library_ms {library_ms} "
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


def _k2_times(op, x, scale: float):
    """One hop's ms, plain_ms, library_ms (torch.sparse.mm, A x only) and
    bound on operator ``op`` with input ``x`` [n, F]."""
    n, nnz, nfeat = op.num_rows, op.nnz, x.shape[1]
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
    return ms, plain_ms, library_ms, bound_ms, bound_by, nbytes


def _k2_hops_error(op, x, cfg):
    """Max errors of ``cfg.order`` ppr hops of K2 against the plain hop."""
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
    return _errors(got, ppr_hops(spmm_prop_step_plain))


def check_k2(data) -> dict:
    cfg = preset("reddit")
    op = Propagator(add_self_loops_adj(data.adj), backend="csr",
                    device=DEV).adj_op
    x = torch.as_tensor(data.features, device=DEV)
    n, nnz, nfeat = op.num_rows, op.nnz, x.shape[1]
    abs_err, rel_err = _k2_hops_error(op, x, cfg)
    print(f"[K2] {cfg.order} ppr hops, n {n} nnz {nnz} F {nfeat}: "
          f"max_abs_err {abs_err} max_rel_err {rel_err}", flush=True)
    if not rel_err <= TOL:
        raise AssertionError(f"K2 disagrees with its plain version: "
                             f"{rel_err} > {TOL}")
    ms, plain_ms, library_ms, bound_ms, bound_by, nbytes = _k2_times(
        op, x, 1.0 - cfg.alpha)
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


def check_k2_mag(data, k2: dict) -> None:
    """K2 in embedding space (H = 64) on the MAG operator; adds its numbers
    to the K2 entry ``k2``."""
    cfg = preset("mag_scholar_c")
    op = Propagator(add_self_loops_adj(data.adj), backend="csr",
                    device=DEV).adj_op
    g = torch.Generator(device=DEV).manual_seed(2)
    x = torch.randn(op.num_rows, cfg.hidden, generator=g, device=DEV)
    abs_err, rel_err = _k2_hops_error(op, x, cfg)
    ms, plain_ms, library_ms, bound_ms, bound_by, nbytes = _k2_times(
        op, x, 1.0 - cfg.alpha)
    print(f"[K2] MAG operator, {cfg.order} ppr hops at H {cfg.hidden}, n "
          f"{op.num_rows} nnz {op.nnz}: max_abs_err {abs_err} max_rel_err "
          f"{rel_err}; per hop ms {ms} plain_ms {plain_ms} library_ms "
          f"{library_ms} bound_ms {bound_ms} ({bound_by}, "
          f"{nbytes / 1e9:.3f} GB)", flush=True)
    if not rel_err <= TOL:
        raise AssertionError(f"K2 (H=64) disagrees with its plain version: "
                             f"{rel_err} > {TOL}")
    k2["max_abs_err"] = max(k2["max_abs_err"], abs_err)
    k2["max_rel_err"] = max(k2["max_rel_err"], rel_err)
    k2["mag"] = {"shape": f"x [{op.num_rows},{cfg.hidden}], nnz {op.nnz}, "
                          "per hop", "ms": ms, "plain_ms": plain_ms,
                 "library_ms": library_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by}


def _k3_form_sets(attr_cols, attr_vals, form: str, g):
    """Eight input sets of one K3 form (distinct rows in turn, so timed
    gathers miss the L2 as the main path's fresh batches do)."""
    rows, ktop, num_aug, n_eval, chunk = K3_SHAPE
    n = attr_cols.shape[0]
    sets = []
    for i in range(8):
        if form == "node":
            sl = slice(i * chunk, (i + 1) * chunk)
            sets.append({"attr_cols": attr_cols[sl], "attr_vals": attr_vals[sl]})
            continue
        r, k = (n_eval, 1) if form == "eval" else (rows, num_aug)
        s = {"attr_cols": attr_cols, "attr_vals": attr_vals,
             "tk_cols": torch.randint(0, n, (r, ktop), generator=g,
                                      device=DEV, dtype=torch.int32),
             "tk_vals": torch.rand(r, ktop, generator=g, device=DEV)}
        if form != "eval":    # the preset's DropNode rate, 0.5
            s["keep"] = torch.rand(k, r, ktop, generator=g, device=DEV) < 0.5
        if form == "train_q0.5":
            s["drop"] = torch.rand(k, r, ktop, attr_cols.shape[1], H_MAG,
                                   generator=g, device=DEV) < 0.5
        sets.append(s)
    return sets


def _k3_library(table, s):
    """``F.embedding_bag`` over the same ids with the combined weights
    w/D * a/(S + 1e-10): the same function when nothing is dropped."""
    if "tk_cols" not in s:
        ids, a = s["attr_cols"].long(), s["attr_vals"]
        return ids, a / (a.sum(-1, keepdim=True) + 1e-10)
    idx = s["tk_cols"].long()
    a = s["attr_vals"][idx]                                # [R, Ktop, P]
    vals = s["tk_vals"][None]
    w = vals if "keep" not in s else torch.where(s["keep"], vals, 0.0)
    w = w / (w.sum(-1, keepdim=True) + 1e-12)              # [K, R, Ktop]
    psw = w[..., None] * (a / (a.sum(-1, keepdim=True) + 1e-10))[None]
    ids = s["attr_cols"][idx].long().expand(psw.shape)
    return (ids.reshape(-1, ids.shape[-2] * ids.shape[-1]),
            psw.reshape(ids.shape[0] * ids.shape[1], -1))


def _k3_bytes(table, s, num_aug):
    """Least bytes and ops of one K3 forward and backward on set ``s``:
    each distinct table row and attr row read once, the masks and the
    output once; the backward writes the whole dense [V, H] gradient."""
    h, p = table.shape[1], s["attr_cols"].shape[1]
    if "tk_cols" in s:
        n_nodes = torch.unique(s["tk_cols"]).numel()
        ids = s["attr_cols"][s["tk_cols"].long()]
        live = s["attr_vals"][s["tk_cols"].long()] != 0
        rows, ktop = s["tk_cols"].shape
        topk = rows * ktop * 8
    else:
        ids, live = s["attr_cols"], s["attr_vals"] != 0
        rows, ktop, topk = s["attr_cols"].shape[0], 1, 0
        n_nodes = rows
    uniq = torch.unique(ids[live]).numel()
    masks = sum(s[k].numel() for k in ("keep", "drop") if k in s)
    common = n_nodes * p * 8 + topk + masks
    out = num_aug * rows * h * 4
    nk = num_aug if "drop" in s else 1
    flops = 2 * nk * int(live.sum()) * h + 2 * num_aug * rows * ktop * h
    return (uniq * h * 4 + common + out, flops,
            table.numel() * 4 + common + out, flops)


def check_k3(data) -> list:
    """K3 forward and backward against the plain version and autograd, in
    the train (with and without input dropout), eval and node forms."""
    padded = PaddedFeatures.from_csr(data.features)
    g = torch.Generator(device=DEV).manual_seed(1)
    table = torch.randn(padded.num_features, H_MAG, generator=g, device=DEV)
    table.requires_grad_(True)
    attr_cols = torch.as_tensor(padded.attr_cols, device=DEV)
    attr_vals = torch.as_tensor(padded.attr_vals, device=DEV)
    errs = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    times = {"fwd": {}, "bwd": {}}
    for form in ("train", "train_q0.5", "eval", "node"):
        q = 0.5 if form == "train_q0.5" else 0.0
        sets = _k3_form_sets(attr_cols, attr_vals, form, g)
        outs = [embed_prop(table, **s, droprate=q) for s in sets]
        num_aug = outs[0].shape[0]
        gout = torch.randn(outs[0].shape, generator=g, device=DEV)
        d_k, = torch.autograd.grad(outs[0], table, gout, retain_graph=True)
        torch.cuda.synchronize(DEV)
        plains = [embed_prop_plain(table, **s, droprate=q) for s in sets]
        d_p, = torch.autograd.grad(plains[0], table, gout, retain_graph=True)
        e_f = _errors(outs[0].detach(), plains[0].detach())
        # the backward's float atomics sum in another order than autograd's
        e_b = _errors(d_k, d_p)
        del d_k, d_p
        for key, e in (("fwd", e_f), ("bwd", e_b)):
            errs[key] = [max(a, b) for a, b in zip(errs[key], e)]
        if not (e_f[1] <= TOL and e_b[1] <= TOL):
            raise AssertionError(f"K3 {form} disagrees with its plain "
                                 f"version: fwd {e_f}, bwd {e_b}")

        it = itertools.cycle(sets)
        with torch.no_grad():
            ms_f = _time_ms(lambda: embed_prop(table, **next(it),
                                               droprate=q), 200)
            plain_f = _time_ms(lambda: embed_prop_plain(
                table, **next(it), droprate=q), 20)
        it_o, it_p = itertools.cycle(outs), itertools.cycle(plains)
        ms_b = _time_ms(lambda: torch.autograd.grad(
            next(it_o), table, gout, retain_graph=True), 50)
        plain_b = _time_ms(lambda: torch.autograd.grad(
            next(it_p), table, gout, retain_graph=True), 20)
        lib_f = lib_b = None
        if q == 0.0:
            libs = [_k3_library(table, s) for s in sets]
            it_l = itertools.cycle(libs)

            def bag(ids_w):
                return F.embedding_bag(ids_w[0], table, mode="sum",
                                       per_sample_weights=ids_w[1])

            with torch.no_grad():
                lib_err = _errors(bag(libs[0]), outs[0].reshape(
                    -1, H_MAG).detach())[1]
                lib_f = _time_ms(lambda: bag(next(it_l)), 200)
            print(f"[K3] {form}: embedding_bag vs the kernel, max rel err "
                  f"{lib_err}", flush=True)
            lib_outs = [bag(iw) for iw in libs]
            lg = torch.randn(lib_outs[0].shape, generator=g, device=DEV)
            it_lo = itertools.cycle(lib_outs)
            lib_b = _time_ms(lambda: torch.autograd.grad(
                next(it_lo), table, lg, retain_graph=True), 50)
            del lib_outs, libs
        b_f, o_f, b_b, o_b = _k3_bytes(table, sets[0], num_aug)
        (bound_f, by_f), (bound_b, by_b) = _bound(b_f, o_f), _bound(b_b, o_b)
        shape = (f"[{num_aug},{outs[0].shape[1]},{H_MAG}]" if form != "node"
                 else f"[1,{K3_SHAPE[4]},{H_MAG}] node form")
        times["fwd"][form] = {"shape": shape, "ms": ms_f, "plain_ms": plain_f,
                              "library_ms": lib_f, "bound_ms": bound_f,
                              "bound_by": by_f, "max_rel_err": e_f[1]}
        times["bwd"][form] = {"shape": shape, "ms": ms_b, "plain_ms": plain_b,
                              "library_ms": lib_b, "bound_ms": bound_b,
                              "bound_by": by_b, "max_rel_err": e_b[1]}
        print(f"[K3] {form} {shape}: fwd ms {ms_f} plain_ms {plain_f} "
              f"library_ms {lib_f} bound_ms {bound_f} ({by_f}, "
              f"{b_f / 1e6:.2f} MB) err {e_f}; bwd ms {ms_b} plain_ms "
              f"{plain_b} library_ms {lib_b} bound_ms {bound_b} ({by_b}, "
              f"{b_b / 1e6:.1f} MB) err {e_b}", flush=True)
        del outs, plains, sets

    # the node form over all 1M nodes, as the predict runs it
    with torch.no_grad():
        all_ms = _time_ms(lambda: embed_all_nodes(table, attr_cols,
                                                  attr_vals), 3, warmup=1)
    live = attr_vals != 0
    uniq = torch.unique(attr_cols[live]).numel()
    n, p = attr_cols.shape
    nbytes = uniq * H_MAG * 4 + n * p * 8 + n * H_MAG * 4
    gathers = int(live.sum())
    all_bound, _ = _bound(nbytes, 2 * gathers * H_MAG)
    print(f"[K3] node form over all {n} nodes ({-(-n // K3_SHAPE[4])} "
          f"launches): ms {all_ms} bound_ms {all_bound} ({nbytes / 1e9:.3f} "
          f"GB, each distinct row once; {uniq} distinct rows); row gathers "
          f"{gathers} = {gathers * H_MAG * 4 / 1e9:.2f} GB at "
          f"{gathers * H_MAG * 4 / 3.35e12 * 1e3:.3f} ms", flush=True)
    times["fwd"]["node_all"] = {"ms": all_ms, "bound_ms": all_bound,
                                "row_gathers": gathers}
    entries = []
    for key, line in (("fwd", 80), ("bwd", 87)):
        main = times[key]["train"]
        entries.append({
            "name": f"embed_prop_{key}", "route": "cuda",
            "source": "grandtpu_torch/csrc/embed_prop.cu",
            "replaces": f"grandtpu/nn/sparse_input.py:{line}",
            "max_abs_err": errs[key][0], "max_rel_err": errs[key][1],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "forms": times[key]})
    return entries


def _ppr_hop_by_hop(hop, plain_hop, x0, order: int, quantize: bool):
    """``order`` ppr hops of ``hop`` against ``plain_hop`` on a shared
    input: at each hop both take the plain run's carries (and, for the int8
    hops, its quantized input), so one hop's rounding does not carry into
    the next. Returns the max (abs, rel) error over the hops' outputs and
    accumulators, the count of their elements that differ, and the count
    of q elements that differ."""
    cur_in, acc = x0, x0.clone()
    worst, differ, q_diff = (0.0, 0.0), 0, 0
    for _ in range(order):
        args = (cur_in,)
        if quantize:
            q, scale = quantize_columns(cur_in)
            q_p, scale_p = quantize_columns_plain(cur_in)
            torch.cuda.synchronize(DEV)
            q_diff += int((q != q_p).sum()) + int((scale != scale_p).sum())
            args = (q_p, scale_p)
        out_k, acc_k = torch.empty_like(cur_in), acc.clone()
        out_p, acc_p = torch.empty_like(cur_in), acc.clone()
        hop(*args, out_k, acc_k)
        torch.cuda.synchronize(DEV)
        plain_hop(*args, out_p, acc_p)
        for got, want in ((out_k, out_p), (acc_k, acc_p)):
            e = _errors(got.float(), want.float())
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
            differ += int((got != want).sum())
        del out_k, acc_k
        cur_in, acc = out_p, acc_p
    return worst, differ, q_diff


def _plain_ppr_run(plain_hop, x0, order: int, quantize: bool):
    """``order`` ppr hops of the plain versions alone (the Propagator's loop
    with ``plain_hop``); returns the accumulator. ``x0`` is not written."""
    cur_in, acc = x0.clone(), x0.clone()
    cur_out = torch.empty_like(x0)
    for _ in range(order):
        args = quantize_columns_plain(cur_in) if quantize else (cur_in,)
        plain_hop(*args, cur_out, acc)
        cur_in, cur_out = cur_out, cur_in
    return acc


def amazon_operators(data) -> dict:
    """The Amazon2M stand-in's operator as f32- and bf16-carry Propagators
    on the card, with its features there."""
    adj_sl = add_self_loops_adj(data.adj)
    return {"adj": adj_sl,
            "f32": Propagator(adj_sl, backend="csr", device=DEV),
            "bf16": Propagator(adj_sl, backend="csr", dtype=torch.bfloat16,
                               device=DEV),
            "x": torch.as_tensor(data.features, device=DEV)}


def check_fast_kernels(ops: dict, k2: dict) -> list:
    """Phase 3d: each fast-precision kernel hop by hop against its plain
    version at the Amazon2M shape, each whole run against f32 K2, and
    their times and bounds; adds K2 (f32) at this shape to ``k2``."""
    cfg = preset("Amazon2M")
    prop, x = ops["f32"], ops["x"]
    op, row_val = prop.adj_op, prop.row_val
    n, nnz, nfeat = op.num_rows, op.nnz, x.shape[1]
    scale, order = 1.0 - cfg.alpha, cfg.order
    x0 = cfg.alpha * x
    bf = torch.bfloat16
    x0_b = x.to(bf) * float(torch.tensor(cfg.alpha).to(bf))

    def k2_hop(term):
        fn = spmm_prop_step if term == "f32" else spmm_prop_step_bf16
        return (lambda ci, co, ac: fn(op, ci, co, ac, scale, True),
                lambda ci, co, ac: spmm_prop_step_plain(op, ci, co, ac,
                                                        scale, True, term))

    # form: (kernel hop, plain hop, first input, quantized, per-hop limit),
    # in the order of the whole runs below. The plain hops add in the
    # kernels' order, so with bf16 carries the hop must be bit for bit the
    # plain one: a rounding done another way (an unrounded scale, say)
    # moves a large share of the elements by one bf16 ulp
    forms = {
        "bf16": (*k2_hop("bf16"), x0, False, TOL),
        "bf16_carry": (*k2_hop("bf16"), x0_b, False, 0.0),
        "q8": (lambda q, s, co, ac: spmm_prop_step_q8(op, q, s, co, ac,
                                                      scale, True),
               lambda q, s, co, ac: spmm_prop_step_q8_plain(
                   op, q, s, co, ac, scale, True), x0, True, TOL),
        "q8mxu": (lambda q, s, co, ac: spmm_prop_step_q8mxu(
                      op, q, s, row_val, co, ac, scale, True),
                  lambda q, s, co, ac: spmm_prop_step_q8mxu_plain(
                      op, q, s, row_val, co, ac, scale, True), x0, True,
                  1e-6),
    }
    errs, q_diff = {}, 0
    for form, (hop, plain_hop, start, quantize, limit) in forms.items():
        errs[form], differ, qd = _ppr_hop_by_hop(hop, plain_hop, start,
                                                 order, quantize)
        q_diff += qd
        print(f"[3d] {form}: {order} ppr hops at [{n},{nfeat}], nnz {nnz}, "
              f"one at a time on a shared input: max_abs_err "
              f"{errs[form][0]} max_rel_err {errs[form][1]} (limit {limit}), "
              f"elements differing {differ}"
              + (f", quantize q/scale elements differing {qd}"
                 if quantize else ""), flush=True)
        if not errs[form][1] <= limit:
            raise AssertionError(f"{form} disagrees with its plain version: "
                                 f"{errs[form][1]} > {limit}")
    if q_diff:
        raise AssertionError(f"quantize_columns differs from its plain "
                             f"version in {q_diff} elements")

    # whole runs of `order` hops: each kernel run against the plain run of
    # the same precision (flips carry from hop to hop, so the fast-path
    # limits), and no further from f32 than the plain arithmetic is
    kw = dict(mode="ppr", order=order, alpha=cfg.alpha)
    ref = prop(x, **kw)
    ref_plain = _plain_ppr_run(k2_hop("f32")[1], x0, order, False)
    # K2 (f32) at this width takes its 4-features-a-lane path
    f32_err = _errors(ref, ref_plain)
    print(f"[3d] csr_spmm_prop: {order} ppr hops at [{n},{nfeat}] against "
          f"its plain version: max_abs_err {f32_err[0]} max_rel_err "
          f"{f32_err[1]} (limit {TOL})", flush=True)
    if not f32_err[1] <= TOL:
        raise AssertionError(f"K2 disagrees with its plain version at "
                             f"[{n},{nfeat}]: {f32_err[1]} > {TOL}")
    runs = {"bf16": prop(x, precision="bf16", **kw),
            "bf16_carry": ops["bf16"](x, precision="bf16", **kw),
            "int8cast": prop(x, precision="int8cast", **kw),
            "int8": prop(x, precision="int8", **kw)}
    whole = {}
    for (p, out), form in zip(runs.items(), forms):
        plain = _plain_ppr_run(forms[form][1], forms[form][2], order,
                               forms[form][3])
        d = _errors(out.float(), plain.float())[1]
        e_k = _errors(out.float(), ref)[1]
        e_p = _errors(plain.float(), ref_plain)[1]
        limit = 2e-2 if p == "bf16_carry" else 5e-3
        whole[p] = {"vs_plain": d, "vs_f32": e_k, "plain_vs_f32": e_p}
        print(f"[3d] whole {order}-hop run {p}: vs its plain run max_rel_err "
              f"{d} (limit {limit}); vs f32 K2 {e_k}, plain vs plain f32 "
              f"{e_p} (fast-path gate {limit}: "
              f"{'held' if e_k <= limit else 'exceeded'})", flush=True)
        if not (d <= limit and e_k <= e_p + 1e-3):
            raise AssertionError(f"{p} run: {d} from its plain run (limit "
                                 f"{limit}), {e_k} from f32 against the "
                                 f"plain run's {e_p}")
        del plain
    del runs, ref, ref_plain

    # times and bounds, one hop (quantize: one call) at the main path's shape
    y, acc = torch.empty_like(x), torch.zeros_like(x)
    y_b, acc_b = torch.empty_like(x0_b), torch.zeros_like(x0_b)
    q, q_scale = quantize_columns(x0)
    struct = 4 * (n + 1) + 4 * nnz
    k2_bytes = 4 * n * nfeat * 4 + 8 * nnz + 4 * (n + 1)
    carry_bytes = 4 * n * nfeat * 2 + 8 * nnz + 4 * (n + 1)
    # q read, f32 y written, acc read and written, the structure
    q8_bytes = n * nfeat * 13 + nfeat * 4 + struct

    def bf16_library():
        """torch.sparse.mm of a bf16 CSR tensor by bf16 x (A x only), if
        this build has it."""
        try:
            a_b = torch.sparse_csr_tensor(op.indptr, op.indices,
                                          op.values.to(bf), size=(n, n))
            torch.sparse.mm(a_b, x0_b)
            torch.cuda.synchronize(DEV)
        except RuntimeError as e:
            print(f"[3d] torch.sparse.mm on bf16 CSR: not in this build "
                  f"({str(e).splitlines()[0][:120]})", flush=True)
            return None
        return _time_ms(lambda: torch.sparse.mm(a_b, x0_b), 30)

    table = {
        "csr_spmm_prop_bf16": (
            lambda: spmm_prop_step_bf16(op, x0, y, acc, scale, True),
            lambda: spmm_prop_step_plain(op, x0, y, acc, scale, True,
                                         "bf16"),
            None, k2_bytes, 2 * nnz * nfeat + 2 * n * nfeat),
        "csr_spmm_prop_bf16_carry": (
            lambda: spmm_prop_step_bf16(op, x0_b, y_b, acc_b, scale, True),
            lambda: spmm_prop_step_plain(op, x0_b, y_b, acc_b, scale, True,
                                         "bf16"),
            bf16_library, carry_bytes, 2 * nnz * nfeat + 2 * n * nfeat),
        "quantize_columns": (
            lambda: quantize_columns(x0), lambda: quantize_columns_plain(x0),
            None, n * nfeat * 5 + nfeat * 4, 3 * n * nfeat),
        "csr_spmm_q8": (
            lambda: spmm_prop_step_q8(op, q, q_scale, y, acc, scale, True),
            lambda: spmm_prop_step_q8_plain(op, q, q_scale, y, acc, scale,
                                            True),
            None, q8_bytes + 4 * nnz, 2 * nnz * nfeat + 3 * n * nfeat),
        "csr_spmm_q8mxu": (
            lambda: spmm_prop_step_q8mxu(op, q, q_scale, row_val, y, acc,
                                         scale, True),
            lambda: spmm_prop_step_q8mxu_plain(op, q, q_scale, row_val, y,
                                               acc, scale, True),
            None, q8_bytes + 4 * n, nnz * nfeat + 4 * n * nfeat),
    }
    times = {}
    for name, (kernel, plain, library, nbytes, ops_) in table.items():
        ms = _time_ms(kernel, 30)
        plain_ms = _time_ms(plain, 3, warmup=1)
        library_ms = library() if library is not None else None
        bound_ms, bound_by = _bound(nbytes, ops_)
        times[name] = {"ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
        print(f"[3d] {name} at [{n},{nfeat}], nnz {nnz}: ms {ms} plain_ms "
              f"{plain_ms} library_ms {library_ms} bound_ms {bound_ms} "
              f"({bound_by}, {nbytes / 1e9:.3f} GB)", flush=True)
    del y, acc, y_b, acc_b, q
    ms, plain_ms, library_ms, bound_ms, bound_by, nbytes = _k2_times(
        op, x0, scale)
    print(f"[3d] csr_spmm_prop at [{n},{nfeat}], nnz {nnz}: ms {ms} plain_ms "
          f"{plain_ms} library_ms {library_ms} (torch.sparse.mm) bound_ms "
          f"{bound_ms} ({bound_by}, {nbytes / 1e9:.3f} GB)", flush=True)
    k2["max_abs_err"] = max(k2["max_abs_err"], f32_err[0])
    k2["max_rel_err"] = max(k2["max_rel_err"], f32_err[1])
    k2["amazon"] = {"shape": f"x [{n},{nfeat}], nnz {nnz}, per hop",
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": f32_err[0], "max_rel_err": f32_err[1]}
    carry = times.pop("csr_spmm_prop_bf16_carry")
    shape = f"x [{n},{nfeat}], nnz {nnz}, per hop"
    sources = {"csr_spmm_prop_bf16": ("csr_spmm.cu", "grandtpu/sparse/"
                                      "spmm.py:197", errs["bf16"]),
               "quantize_columns": ("csr_spmm_q8.cu",
                                    "grandtpu/sparse/spmm.py:452",
                                    (0.0, 0.0)),
               "csr_spmm_q8": ("csr_spmm_q8.cu",
                               "grandtpu/sparse/spmm.py:507", errs["q8"]),
               "csr_spmm_q8mxu": ("csr_spmm_q8.cu",
                                  "grandtpu/sparse/spmm.py:607",
                                  errs["q8mxu"])}
    entries = []
    for name, (src, line, err) in sources.items():
        entry = {"name": name, "route": "cuda",
                 "source": f"grandtpu_torch/csrc/{src}", "replaces": line,
                 "max_abs_err": err[0], "max_rel_err": err[1],
                 **times[name],
                 "shape": shape if name != "quantize_columns"
                 else f"x [{n},{nfeat}] f32, one call (two launches)",
                 "whole_run": whole.get(
                     {"csr_spmm_prop_bf16": "bf16", "csr_spmm_q8": "int8cast",
                      "csr_spmm_q8mxu": "int8"}.get(name, ""))}
        if name == "csr_spmm_prop_bf16":
            entry["bf16_carry"] = {**carry, "max_abs_err":
                                   errs["bf16_carry"][0], "max_rel_err":
                                   errs["bf16_carry"][1],
                                   "whole_run": whole["bf16_carry"]}
        entries.append(entry)
    return entries


def check_small_fast() -> None:
    """Phase 4c, first half: ``exact_propagate`` at every precision on the
    card against the CPU, on a graph above the dense threshold."""
    cfg = preset("Amazon2M")
    data = load_data(AMAZON_SMALL, split_seed=cfg.seed1)
    adj_sl = add_self_loops_adj(data.adj)
    for p in ("f32", "bf16", "int8", "int8mxu", "int8cast", "auto",
              "bf16_carry"):
        kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha,
                  backend="csr", precision=p)
        gpu = exact_propagate(adj_sl, data.features, device=DEV, **kw)
        cpu = exact_propagate(adj_sl, data.features, device="cpu", **kw)
        err = _errors(gpu.float().cpu(), cpu.float())[1]
        limit = {"f32": 1e-5, "bf16_carry": 2e-2}.get(p, 5e-3)
        print(f"[small-fast] {AMAZON_SMALL} {p}: card vs CPU max_rel_err "
              f"{err} (limit {limit})", flush=True)
        if not (gpu.dtype == cpu.dtype and err <= limit):
            raise AssertionError(f"{p}: card disagrees with the CPU")


def run_amazon_path(data, push_backend: str, tag: str,
                    ckpt_dir: str | None = None):
    """The Amazon2M ``train()`` (phase 5c with the native push, 5d with the
    bucket push and ``ckpt_dir``); returns (result, launches)."""
    cfg = preset("Amazon2M").replace(dataset=AMAZON, epochs=2,
                                     predict_precision="auto",
                                     push_backend=push_backend,
                                     ckpt_dir=ckpt_dir)
    r, launches = run_path(cfg, data, tag)
    if launches["dropnode_mean"] < r.num_batches + len(r.history):
        raise AssertionError("K1 was not launched for every step and eval")
    if r.predict_precision != "int8mxu":
        raise AssertionError(f"auto ran {r.predict_precision}, not int8 as "
                             "K2-q8mxu")
    return r, launches


def precision_sweep(ops: dict) -> dict:
    """Phase 7: ``order`` hops at every precision on one Propagator, with
    error against f32 and peak memory, then ``calibrate()``; every hop
    kernel must launch. Returns the launches."""
    cfg = preset("Amazon2M")
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    prop, x = ops["f32"], ops["x"]
    _reset_counts()
    ref = prop(x, **kw)
    ref_max = float(ref.abs().max())
    runs = [("f32", prop, "f32"), ("bf16", prop, "bf16"),
            ("int8", prop, "int8"), ("int8cast", prop, "int8cast"),
            ("bf16_carry", ops["bf16"], "bf16")]
    sweep = {}
    for name, pr, p in runs:
        torch.cuda.synchronize(DEV)
        base = torch.cuda.memory_allocated(DEV)
        torch.cuda.reset_peak_memory_stats(DEV)
        out = pr(x, precision=p, **kw)
        torch.cuda.synchronize(DEV)
        peak = (torch.cuda.max_memory_allocated(DEV) - base) / 1e9
        err = float((out.float() - ref).abs().max()) / ref_max
        del out
        ms = _time_ms(lambda: pr(x, precision=p, **kw), 5, warmup=1)
        sweep[name] = {"ms": ms, "rel_err_vs_f32": err,
                       "peak_extra_GB": peak}
        print(f"[sweep] {name}: {cfg.order} hops {ms} ms, max_rel_err vs "
              f"f32 {err}, peak memory above the resident operands {peak} "
              f"GB", flush=True)
    del ref
    t0 = time.time()
    choice = prop.calibrate(x, order=cfg.order, alpha=cfg.alpha)
    launches = _read_counts()
    print(f"[sweep] calibrate() (candidates bf16, int8) chose {choice} in "
          f"{time.time() - t0:.3f} s; launches {launches}", flush=True)
    missing = [k for k in HOP_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the sweep launched no {missing}")
    return launches


def check_small_reference(cfg) -> None:
    """``train()`` with ``cfg`` (every drop rate 0) on the card and on the
    CPU gives the same validation history and test accuracy."""
    data = load_data(cfg.dataset, split_seed=cfg.seed1)
    gpu = train(cfg, data=data, device=DEV)
    cpu = train(cfg, data=data, device="cpu")
    d_loss = max(abs(a["val_loss"] - b["val_loss"])
                 for a, b in zip(gpu.history, cpu.history, strict=True))
    d_acc = abs(gpu.test_acc - cpu.test_acc) * len(data.idx_test)
    print(f"[small] {cfg.dataset}: {len(gpu.history)} evals, max |d "
          f"val_loss| {d_loss}, test_acc gpu {gpu.test_acc} cpu "
          f"{cpu.test_acc}", flush=True)
    if not (d_loss <= 1e-4 and d_acc <= 1.0 + 1e-9):
        raise AssertionError("GPU run disagrees with the CPU reference")


def train_sources(cfg, data) -> np.ndarray:
    """The source set ``train()`` pushes from (trainer.py's unlabeled
    pool: train, val, then ``unlabel_num`` test nodes drawn with seed2)."""
    rng = np.random.RandomState(cfg.seed2)
    idx_sample = rng.permutation(data.idx_test)[: cfg.unlabel_num]
    return np.concatenate([data.idx_train, data.idx_val, idx_sample])


def _row_rule(cols_a, vals_a, cols_b, vals_b, atol: float) -> None:
    """tests/test_gfpush_backends.py's row rule with tie_tol = atol: equal
    value multisets up to atol, equal (col -> val) maps above the smaller
    row's cutoff by more than atol (ties at the k-th value may differ)."""
    for ca, va, cb, vb in zip(cols_a, vals_a, cols_b, vals_b):
        pa, pb = va > 0, vb > 0
        sa, sb = np.sort(va[pa])[::-1], np.sort(vb[pb])[::-1]
        if sa.shape != sb.shape or not np.allclose(sa, sb, rtol=0,
                                                   atol=atol):
            raise AssertionError(f"row values differ: {sa} vs {sb}")
        cutoff = min(sa[-1] if sa.size else 0.0, sb[-1] if sb.size else 0.0)
        mb = dict(zip(cb[pb].tolist(), vb[pb].tolist()))
        for c, v in zip(ca[pa].tolist(), va[pa].tolist()):
            if v > cutoff + atol and (c not in mb or abs(v - mb[c]) > atol):
                raise AssertionError(f"col {c} ({v}) missing or off")


def _time_each_ms(setup, fn, iters: int) -> float:
    """Mean device time of ``fn()`` alone over ``iters`` calls, each after
    ``setup()`` (CUDA events around each call)."""
    total = 0.0
    for i in range(iters + 1):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(DEV)
        if i:                                   # the first call warms up
            total += start.elapsed_time(end)
    return total / iters


PUSH_KERNELS = {"jax": {"dense_push_mask", "push_topk", "csr_spmm_prop"},
                "bucket": {"bucket_expand", "bucket_compact", "push_topk"}}
PUSH_COUNTED = ("dense_push_mask", "bucket_expand", "bucket_compact",
                "push_topk")


def run_push_path(adj_sl, sources, cfg, backend: str, tag: str):
    """``gfpush(backend=...)`` on the card as a path of its own: counts set
    to 0 just before, read just after; the backend's kernels must launch
    and the other push kernels must not. Returns (TopKProp, launches,
    seconds)."""
    _reset_counts()
    t0 = time.time()
    tk = gfpush(adj_sl, sources, prop_mode=cfg.prop_mode, order=cfg.order,
                alpha=cfg.alpha, rmax=cfg.rmax, k=cfg.top_k, backend=backend,
                device=DEV)
    seconds = time.time() - t0
    launches = _read_counts()
    want = set(PUSH_KERNELS[backend])
    if adj_sl.shape[0] <= 8192:     # gfpush_dense's dense_threshold: matmul
        want.discard("csr_spmm_prop")
    bad = [k for k in PUSH_COUNTED + ("csr_spmm_prop",)
           if (launches[k] > 0) != (k in want)]
    if bad:
        raise AssertionError(f"[{tag}] {backend} push launches {launches}: "
                             f"wrong for {bad}")
    print(f"[{tag}] gfpush(backend={backend!r}) on the card: "
          f"{len(sources)} sources in {seconds} s = {len(sources) / seconds} "
          f"sources/s; launches {launches}", flush=True)
    return tk, launches, seconds


def _p1_times(g, src, coef, k) -> dict:
    """P1's push mask, its K2 over A^T and its top-k at one block's shape,
    on the reserve a real block leaves."""
    n, b = g.n, src.shape[0]
    residue = torch.zeros((n, b), device=DEV)
    residue[src.long(), torch.arange(b, device=DEV)] = 1.0
    reserve, pushed = torch.zeros_like(residue), torch.empty_like(residue)
    tele, tele_in = None, None
    for i in range(coef.shape[0] - 1):       # the block's real carries
        tele = torch.zeros(b, dtype=torch.int64, device=DEV)
        dense_push_mask(residue, reserve, pushed, tele_in, tele, src, g.deg,
                        g.thr, float(coef[i]), False)
        g.product(pushed, residue)
        tele_in = tele
    args = (residue, reserve, pushed, None, tele, src, g.deg, g.thr,
            float(coef[1]), False)
    mask_ms = _time_ms(lambda: dense_push_mask(*args), 20)
    mask_plain = _time_ms(lambda: dense_push_mask_plain(*args), 3, warmup=1)
    mask_bound = _bound(16 * n * b + 8 * n + 12 * b, 5 * n * b)
    k2_ms = _time_ms(lambda: g.product(pushed, residue), 20)
    rows = reserve.t().contiguous().reshape(-1)
    off = torch.arange(b + 1, device=DEV, dtype=torch.int64) * n
    dense_rows = rows.view(b, n)
    topk_ms = _time_ms(lambda: push_topk(None, rows, off, k), 20)
    topk_plain = _time_ms(lambda: push_topk_plain(None, rows, off, k), 3,
                          warmup=1)
    topk_lib = _time_ms(lambda: torch.topk(dense_rows, k, dim=1), 20)
    topk_bound = _bound(4 * n * b + 8 * b * k + 8 * (b + 1), 2 * n * b)
    print(f"[3e] P1 block [{n},{b}]: dense_push_mask ms {mask_ms} plain_ms "
          f"{mask_plain} bound_ms {mask_bound[0]} ({mask_bound[1]}); K2 over "
          f"A^T ms {k2_ms} per hop; push_topk over [{b},{n}] ms {topk_ms} "
          f"plain_ms {topk_plain} library_ms {topk_lib} (torch.topk) "
          f"bound_ms {topk_bound[0]} ({topk_bound[1]})", flush=True)
    return {"dense_push_mask": {"ms": mask_ms, "plain_ms": mask_plain,
                                "bound_ms": mask_bound[0],
                                "bound_by": mask_bound[1],
                                "library_ms": None,
                                "shape": f"carries [{n},{b}], per hop"},
            "push_topk": {"ms": topk_ms, "plain_ms": topk_plain,
                          "bound_ms": topk_bound[0],
                          "bound_by": topk_bound[1], "library_ms": topk_lib,
                          "shape": f"P1 rows [{b},{n}], k {k}"},
            "k2_over_at_ms": k2_ms}


def _p2_times(g, src, coef, k) -> dict:
    """P2's expansion and compaction at the largest hop of one block, and
    its reserve merge and top-k, with their plain versions and bounds
    (bytes from this block's counts)."""
    fr = bucket_push.initial_frontier(g, src)
    logs, hops = [], []
    for i in range(coef.shape[0] - 1):
        logs.append((fr, float(coef[i])))
        slots = int(fr.exp.sum())
        if slots == 0:
            fr = None
            break
        hops.append((fr, slots))
        fr = bucket_push.push_hop(g, fr, src, slots)
    if fr is not None:
        logs.append((fr, float(coef[-1])))
    fr, slots = max(hops, key=lambda h: h[1])
    t_off, keys, vals = bucket_push._tables(2 * fr.exp, 2 * slots)

    def reset():
        keys.fill_(-1)
        vals.zero_()

    def expand():
        bucket_push.bucket_expand(fr, src, g, t_off, keys, vals, merge=False)

    expand_ms = _time_each_ms(reset, expand, 10)
    reset()
    expand()
    nxt = bucket_push.bucket_compact(g, t_off, keys, vals, final=False)
    compact_ms = _time_ms(lambda: bucket_push.bucket_compact(
        g, t_off, keys, vals, final=False), 10)
    hop_plain = _time_ms(lambda: bucket_push.push_hop_plain(g, fr, src), 2,
                         warmup=1)
    entries, out = int(fr.cnt.sum()), int(nxt.cnt.sum())
    # frontier ids + q, each entry's row bounds and threshold, the neighbour
    # ids of the expansion slots, the next frontier written once
    exp_bound = _bound(entries * 28 + slots * 4 + out * 12, 2 * slots)
    # the table read once, the frontier written, each entry's degree and
    # threshold read
    cmp_bound = _bound(2 * slots * 12 + out * 28 + 16 * src.shape[0],
                       2 * slots)
    caps = 2 * sum(f.cnt for f, _ in logs)
    r_off, r_keys, r_vals = bucket_push._tables(caps, int(caps.sum()))
    for f, c in logs:
        bucket_push.bucket_expand(f, src, g, r_off, r_keys, r_vals,
                                  merge=True, coef=c)
    f32 = bucket_push.bucket_compact(g, r_off, r_keys, r_vals, final=True)
    width = int((r_off[1:] - r_off[:-1]).max())
    padded = torch.zeros((src.shape[0], width), device=DEV)
    lens = r_off[1:] - r_off[:-1]
    pos = torch.arange(width, device=DEV)
    valid = pos[None] < lens[:, None]
    padded[valid] = f32[(r_off[:-1, None] + pos[None])[valid]]
    topk_ms = _time_ms(lambda: push_topk(r_keys, f32, r_off, k), 20)
    topk_plain = _time_ms(lambda: push_topk_plain(r_keys, f32, r_off, k), 3,
                          warmup=1)
    topk_lib = _time_ms(lambda: torch.topk(padded, k, dim=1), 20)
    n_slots = int(r_off[-1])
    topk_bound = _bound(8 * n_slots + 8 * src.shape[0] * k, 2 * n_slots)
    print(f"[p2] block of {src.shape[0]}: largest hop {entries} entries, "
          f"{slots} expansion slots, {out} next entries: bucket_expand ms "
          f"{expand_ms} bound_ms {exp_bound[0]}; bucket_compact ms "
          f"{compact_ms} bound_ms {cmp_bound[0]}; plain hop (both) ms "
          f"{hop_plain}; reserve tables {n_slots} slots: push_topk ms "
          f"{topk_ms} plain_ms {topk_plain} library_ms {topk_lib} "
          f"(torch.topk over the rows padded to {width}) bound_ms "
          f"{topk_bound[0]}", flush=True)
    shape = (f"block {src.shape[0]}, hop of {entries} entries, {slots} "
             f"slots, {out} out")
    return {"bucket_expand": {"ms": expand_ms, "plain_ms": hop_plain,
                              "bound_ms": exp_bound[0],
                              "bound_by": exp_bound[1], "library_ms": None,
                              "shape": shape},
            "bucket_compact": {"ms": compact_ms, "plain_ms": hop_plain,
                               "bound_ms": cmp_bound[0],
                               "bound_by": cmp_bound[1], "library_ms": None,
                               "shape": shape},
            "push_topk": {"ms": topk_ms, "plain_ms": topk_plain,
                          "bound_ms": topk_bound[0],
                          "bound_by": topk_bound[1], "library_ms": topk_lib,
                          "shape": f"P2 reserve tables, {src.shape[0]} rows "
                                   f"of {n_slots} slots, k {k}"}}


def _same(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def check_push(data, cfg, tag: str, backends) -> dict:
    """Phases 3e/3f: each device push from the sources ``train()`` builds,
    run through ``gfpush`` as a path, against native under the row rule,
    against its plain version on the card, and run twice; then its kernel
    times. Returns {kernel name: numbers} and each path's launches."""
    adj_sl = add_self_loops_adj(data.adj)
    indptr = np.asarray(adj_sl.indptr, np.int32)
    indices = np.asarray(adj_sl.indices, np.int32)
    sources = train_sources(cfg, data)
    coef = np.asarray(build_coef(cfg.prop_mode, cfg.order, cfg.alpha),
                      np.float32)
    k, rmax = cfg.top_k, cfg.rmax
    atol = max(1e-5, 2 * rmax)
    # the first call compiles the native kernel (g++): not part of its rate
    gfpush_native(indptr, indices, sources[:1], coef, rmax, k)
    t0 = time.time()
    want = gfpush_native(indptr, indices, sources, coef, rmax, k)
    native_s = time.time() - t0
    print(f"[{tag}] {cfg.dataset}: ppr order {cfg.order} alpha {cfg.alpha} "
          f"rmax {rmax} k {k}; native on {os.cpu_count()} host cores: "
          f"{len(sources)} sources in {native_s} s = "
          f"{len(sources) / native_s} sources/s", flush=True)
    out = {"native_sps": len(sources) / native_s,
           "host_cores": os.cpu_count(), "launches": {}, "sps": {}}
    for backend in backends:
        tk, launches, seconds = run_push_path(adj_sl, sources, cfg, backend,
                                              tag)
        out["launches"][backend] = launches
        out["sps"][backend] = len(sources) / seconds
        got = (tk.cols, tk.vals)
        _row_rule(want[0], want[1].astype(np.float32), *got, atol)
        if backend == "jax":
            g = dense_push.DensePushGraph(indptr, indices, rmax, device=DEV)
            again = dense_push.gfpush_dense(indptr, indices, sources, coef,
                                            rmax, k, device=DEV)
            run_block = dense_push.push_block
            block = 512
        else:
            g = bucket_push.BucketPushGraph(indptr, indices, rmax,
                                            device=DEV)
            again = bucket_push.gfpush_bucketed(indptr, indices, sources,
                                                coef, rmax, k, device=DEV)
            run_block = bucket_push.push_block
            block = 1024
        plain = [[], []]
        for start in range(0, len(sources), block):
            src = torch.as_tensor(sources[start:start + block].astype(
                np.int32), device=DEV)
            for i, t in enumerate(run_block(g, src, coef, k, plain=True)):
                plain[i].append(t.cpu().numpy())
        plain = [np.concatenate(p) for p in plain]
        if not _same(got, again):
            raise AssertionError(f"[{tag}] two {backend} runs differ")
        err = float(np.abs(got[1] - plain[1]).max()) / float(
            np.abs(plain[1]).max())
        cols_equal = np.array_equal(got[0], plain[0])
        exact = _same(got, plain)
        print(f"[{tag}] {backend}: within {atol} of native under the row "
              f"rule; two runs identical; against its plain version on the "
              f"card: cols equal {cols_equal}, vals max_rel_err {err}, bit "
              f"for bit {exact}", flush=True)
        # P2 sums in fixed point: bit for bit; P1's K2 adds in edge order
        if not (exact if backend == "bucket" else
                (cols_equal and err <= TOL)):
            raise AssertionError(f"[{tag}] {backend} disagrees with its "
                                 f"plain version")
        src = torch.as_tensor(sources[:block].astype(np.int32), device=DEV)
        times = (_p1_times if backend == "jax" else _p2_times)(g, src, coef,
                                                                k)
        out[backend] = {"max_abs_err": float(np.abs(got[1]
                                                    - plain[1]).max()),
                        "times": times}
        del g
    print(f"[{tag}] sources/s: native {out['native_sps']} ({os.cpu_count()} "
          f"host cores), card {out['sps']}", flush=True)
    return out


COUNTED = {"dropnode_mean": gather_and_prop, "csr_spmm_prop": spmm_prop_step,
           "csr_spmm_prop_bf16": spmm_prop_step_bf16,
           "quantize_columns": quantize_columns,
           "csr_spmm_q8": spmm_prop_step_q8,
           "csr_spmm_q8mxu": spmm_prop_step_q8mxu,
           "embed_prop_fwd": embed_prop,
           "embed_prop_bwd": embed_prop_backward,
           "dense_push_mask": dense_push_mask,
           "bucket_expand": bucket_push.bucket_expand,
           "bucket_compact": bucket_push.bucket_compact,
           "push_topk": push_topk,
           "coo_spmm": spmm_segment,
           "column_absmax": column_absmax,
           "quantize_with_amax": quantize_with_amax,
           "halo_pack": halo_pack,
           "halo_hop": halo_hop}
HOP_KERNELS = ("csr_spmm_prop", "csr_spmm_prop_bf16", "quantize_columns",
               "csr_spmm_q8", "csr_spmm_q8mxu")
# K2-seg, the quantize split and D1's kernels: none of the training paths
# runs them
SERVE_KERNELS = ("coo_spmm", "column_absmax", "quantize_with_amax",
                 "halo_pack", "halo_hop")
# the hop kernels of each form a Propagator's hops run
# (``Propagator.last_precision``; None on the dense backend)
PRECISION_KERNELS = {
    None: set(), "f32": {"csr_spmm_prop"}, "bf16": {"csr_spmm_prop_bf16"},
    "int8mxu": {"quantize_columns", "csr_spmm_q8mxu"},
    "int8cast": {"quantize_columns", "csr_spmm_q8"}}


def _reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def _check_hops(launches: dict, precision, order: int) -> None:
    """The hop kernels of ``precision``'s form launched ``order`` times
    each, the other hop kernels and the serving ones not at all."""
    selected = PRECISION_KERNELS[precision]
    for name in HOP_KERNELS + SERVE_KERNELS:
        want = order if name in selected else 0
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"expected {want} (order={order}, "
                                 f"selected {sorted(selected)})")


def run_path(cfg, data, tag: str) -> tuple:
    """One ``train()`` of the path with every launch count set to 0 just
    before and read just after; returns (result, launches). The hop
    kernels of the form the predict's hops ran must launch ``order`` times
    each, the others not at all."""
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.time()
    r = train(cfg, data=data, device=DEV)
    wall = time.time() - t0
    launches = _read_counts()
    print(f"[{tag}] {cfg.dataset}, {cfg.epochs} epochs, predict_precision "
          f"{cfg.predict_precision} (hops ran {r.predict_precision}): steps "
          f"{r.num_batches}, evals "
          f"{len(r.history)}, launches {launches}, "
          f"test_acc {r.test_acc}, best_val_acc {r.best_val_acc}, "
          f"preprocess_s {r.preprocess_time}, batch_time_median_s "
          f"{r.batch_time_median}, propagate_s {r.propagate_time}, total_s "
          f"{r.total_time}, train_call_s {wall}, peak_mem_GB "
          f"{torch.cuda.max_memory_allocated(DEV) / 1e9}", flush=True)
    losses = [v for h in r.history for v in (h["loss"], h["val_loss"])]
    if not (r.history and np.all(np.isfinite(losses))):
        raise AssertionError(f"non-finite losses: {r.history}")
    if not 0.0 <= r.test_acc <= 1.0:
        raise AssertionError(f"test_acc {r.test_acc}")
    _check_hops(launches, r.predict_precision, cfg.order)
    # the push kernels of the push backend, none for native (and 'auto',
    # which picks native at these source counts on a host with a core)
    pushers = PUSH_KERNELS.get(cfg.push_backend, set())
    for name in PUSH_COUNTED:
        if (launches[name] > 0) != (name in pushers):
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"with push_backend={cfg.push_backend!r}")
    return r, launches


def run_main_path(data) -> dict:
    cfg = preset("reddit").replace(dataset=DATASET, epochs=2)
    r, launches = run_path(cfg, data, "main")
    if launches["dropnode_mean"] < r.num_batches + len(r.history):
        raise AssertionError("K1 was not launched for every step and eval")
    return launches


def run_mag_path(data) -> dict:
    cfg = preset("mag_scholar_c").replace(dataset=MAG_DATASET, epochs=5)
    r, launches = run_path(cfg, data, "mag")
    chunks = -(-data.num_nodes // K3_SHAPE[4])
    if launches["embed_prop_fwd"] != r.num_batches + len(r.history) + chunks:
        raise AssertionError(
            f"K3 forward launched {launches['embed_prop_fwd']} times, not "
            f"once per step, eval and predict chunk ({r.num_batches} + "
            f"{len(r.history)} + {chunks})")
    if launches["embed_prop_bwd"] != r.num_batches:
        raise AssertionError(f"K3 backward launched "
                             f"{launches['embed_prop_bwd']} times, not once "
                             f"per step ({r.num_batches})")
    return launches


def profile_path(cfg, data, tag: str) -> None:
    """The path once more under torch.profiler: device time by kernel and
    the device's busy share of the ``train()`` call. Only device activity
    is traced: recording every host op as well cost seconds a path."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        print(f"[{tag}] the profiler recorded no device time")
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
    print(f"[{tag}] train() {wall_ms} ms wall (profiled), device busy "
          f"{busy_ms} ms = {100 * busy_ms / wall_ms}% of wall (copies "
          f"{copy_ms} ms, kernels {busy_ms - copy_ms} ms), first to last "
          f"device event {span_ms} ms, {len(kernels)} device events, "
          f"{r.num_batches} steps; batch_time_median_s "
          f"{r.batch_time_median}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for i, (name, (t, n)) in enumerate(ranked):
        if i < 14 or any(k in name for k in ("dropnode_mean", "csr_spmm",
                                             "embed_prop", "quantize",
                                             "column_absmax")):
            print(f"[{tag}] {t:10.4f} ms {n:6d}x {name[:100]}")


def push_entries(push_reddit: dict, push_amazon: dict,
                 bucket_launches: dict) -> list:
    """The kernels line's entries of the push kernels: times at the main
    path's shapes (P2 and its top-k at the Amazon2M stand-in, 3f; P1's mask
    at the reddit stand-in, 3e), launches by path."""
    paths = {"amazon_bucket": bucket_launches,
             "p1_reddit": push_reddit["launches"]["jax"],
             "p2_reddit": push_reddit["launches"]["bucket"],
             "p2_amazon": push_amazon["launches"]["bucket"]}
    p1, p2 = push_reddit["jax"], push_amazon["bucket"]
    p2_err = max(p2["max_abs_err"], push_reddit["bucket"]["max_abs_err"])
    rows = [("dense_push_mask", "push_dense.cu", "grandtpu/ppr/jax_push.py:36",
             p1["times"]["dense_push_mask"], p1["max_abs_err"]),
            ("bucket_expand", "push_bucket.cu",
             "grandtpu/ppr/bucket_push.py:141",
             p2["times"]["bucket_expand"], p2_err),
            ("bucket_compact", "push_bucket.cu",
             "grandtpu/ppr/bucket_push.py:117",
             p2["times"]["bucket_compact"], p2_err),
            ("push_topk", "push_topk.cu", "grandtpu/ppr/bucket_push.py:262",
             p2["times"]["push_topk"], max(p2_err, p1["max_abs_err"]))]
    entries = []
    for name, src, line, times, err in rows:
        by_path = {p: la[name] for p, la in paths.items() if la[name]}
        entry = {"name": name, "route": "cuda",
                 "source": f"grandtpu_torch/csrc/{src}", "replaces": line,
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path, "max_abs_err": err, **times}
        if name == "push_topk":
            entry["p1_form"] = p1["times"]["push_topk"]
        entries.append(entry)
    for key, res in (("reddit", push_reddit), ("amazon", push_amazon)):
        entries[-1].setdefault("sources_per_s", {})[key] = {
            "native": res["native_sps"], "host_cores": res["host_cores"],
            **res["sps"]}
    return entries

def _peak_gb(fn):
    """(result, peak device memory of ``fn()`` above what was allocated
    before it, in GB)."""
    torch.cuda.synchronize(DEV)
    base = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    out = fn()
    torch.cuda.synchronize(DEV)
    return out, (torch.cuda.max_memory_allocated(DEV) - base) / 1e9


def check_segment(ops: dict) -> dict:
    """Phase 3g: K2-seg at the Amazon2M shape, hop by hop against its plain
    version; the segment Propagator as a path against the csr backend's f32
    run, with both runs' peak memory; times and the bound."""
    cfg = preset("Amazon2M")
    adj, x, csr = ops["adj"], ops["x"], ops["f32"]
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    t0 = time.time()
    seg, build_gb = _peak_gb(lambda: Propagator(adj, backend="segment",
                                                device=DEV))
    build_s = time.time() - t0
    padded = seg.adj_op
    n, nfeat = x.shape
    e_pad = padded.num_edges_padded
    cur, worst = cfg.alpha * x, (0.0, 0.0)
    for _ in range(cfg.order):
        got = spmm_segment(padded, cur)
        torch.cuda.synchronize(DEV)
        want = spmm_segment_plain(padded, cur)
        e = _errors(got, want)
        worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        cur = want * (1.0 - cfg.alpha)
        del got, want
    print(f"[3g] coo_spmm: {cfg.order} ppr hops at [{n},{nfeat}], "
          f"{e_pad} padded edges, one at a time on a shared input: "
          f"max_abs_err {worst[0]} max_rel_err {worst[1]} (limit {TOL})",
          flush=True)
    if not worst[1] <= TOL:
        raise AssertionError(f"coo_spmm disagrees with its plain version: "
                             f"{worst[1]} > {TOL}")
    ref, csr_gb = _peak_gb(lambda: csr(x, **kw))
    _reset_counts()
    out, seg_gb = _peak_gb(lambda: seg(x, **kw))
    launches = _read_counts()
    err = _errors(out, ref)
    struct_csr = 4 * (n + 1) + 8 * csr.adj_op.nnz
    struct_seg = 12 * e_pad
    print(f"[3g] Propagator(backend='segment') {cfg.order} ppr hops: "
          f"launches {launches}; against the csr backend's f32 run "
          f"max_abs_err {err[0]} max_rel_err {err[1]} (limit {TOL}); peak "
          f"device memory above the resident operands: segment {seg_gb} GB, "
          f"csr {csr_gb} GB; operator structure segment {struct_seg / 1e9} "
          f"GB, csr {struct_csr / 1e9} GB; segment build {build_s} s "
          f"({build_gb} GB)", flush=True)
    bad = {k: v for k, v in launches.items()
           if v != (cfg.order if k == "coo_spmm" else 0)}
    if bad or not err[1] <= TOL:
        raise AssertionError(f"segment path: launches {bad}, err {err}")
    del out, ref
    x0 = cfg.alpha * x
    buf = torch.empty((n + 1, nfeat), device=DEV)
    ms = _time_ms(lambda: spmm_segment(padded, x0, out=buf), 30)
    plain_ms = _time_ms(lambda: spmm_segment_plain(padded, x0, out=buf), 3,
                        warmup=1)
    a = torch.sparse_coo_tensor(
        torch.stack([padded.rows.long(), padded.cols.long()]), padded.vals,
        (n + 1, n)).coalesce()
    library_ms = _time_ms(lambda: torch.sparse.mm(a, x0), 30)
    del a
    # each padded edge's 12 bytes, x read once, y [n + 1, F] written once
    nbytes = 12 * e_pad + 4 * n * nfeat + 4 * (n + 1) * nfeat
    bound_ms, bound_by = _bound(nbytes, 2 * csr.adj_op.nnz * nfeat)
    print(f"[3g] coo_spmm per hop at [{n},{nfeat}]: ms {ms} plain_ms "
          f"{plain_ms} library_ms {library_ms} (torch.sparse.mm, coalesced "
          f"COO) bound_ms {bound_ms} ({bound_by}, {nbytes / 1e9:.3f} GB)",
          flush=True)
    return {"name": "coo_spmm", "route": "cuda",
            "source": "grandtpu_torch/csrc/coo_spmm.cu",
            "replaces": "grandtpu/sparse/spmm.py:74",
            "max_abs_err": worst[0], "max_rel_err": worst[1], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"x [{n},{nfeat}], {e_pad} padded edges, per hop",
            "launches_by_path": {"segment": launches["coo_spmm"]},
            "peak_extra_GB": {"segment": seg_gb, "csr": csr_gb},
            "propagate_vs_csr_max_rel_err": err[1]}


# phase 8's runs: (name, halo_threshold, precision, the kernels of its
# hops, each launched order x SHARDS times)
D1_RUNS = (
    ("all_gather_f32", None, "f32", {"csr_spmm_prop"}),
    ("all_gather_bf16", None, "bf16", {"csr_spmm_prop_bf16"}),
    ("all_gather_int8", None, "int8",
     {"column_absmax", "quantize_with_amax", "csr_spmm_q8mxu"}),
    ("halo_f32", 1.0, "f32", {"halo_pack", "halo_hop"}),
    ("halo_int8", 1.0, "int8", {"column_absmax", "halo_pack", "halo_hop"}),
    ("scatter_f32", None, "f32", {"coo_spmm"}),
)


def _d1_times(prop, xs, tag: str) -> dict:
    """The halo kernels (f32 and int8 forms), the quantize split and the
    collectives at shard 0's shapes of ``prop`` (a HaloPropagator)."""
    mesh, g = prop.mesh, prop.g
    S, c_max, nfeat = g.num_shards, g.halo_per_pair, xs[0].shape[1]
    rows = g.rows_per_shard
    x0, idx0 = xs[0], prop.send_idx[0]
    m = idx0.numel()
    uniq = torch.unique(idx0).numel()
    amax = mesh.pmax([column_absmax(x) for x in xs])
    out = {}
    # halo_pack, f32 and int8: the distinct gathered rows read once, the
    # index, the send buffer written
    for form, a in (("f32", None), ("int8", amax[0])):
        width = 4 if a is None else 1
        nbytes = uniq * nfeat * 4 + 4 * m + m * nfeat * width + (
            0 if a is None else 8 * nfeat)
        ms = _time_ms(lambda: halo_pack(x0, idx0, a), 30)
        plain_ms = _time_ms(lambda: halo_pack_plain(x0, idx0, a), 3)
        if a is None:
            lib = _time_ms(lambda: torch.index_select(x0, 0, idx0), 30)
        else:
            lib = _time_ms(lambda: quantize_with_amax_plain(
                torch.index_select(x0, 0, idx0), a), 10)
        b = _bound(nbytes, m * nfeat * (0 if a is None else 3))
        out[f"halo_pack_{form}"] = {"ms": ms, "plain_ms": plain_ms,
                                    "library_ms": lib, "bound_ms": b[0],
                                    "bound_by": b[1]}
    # halo_hop, f32 and the exact int8 form, on a real exchange
    for form, a in (("f32", None), ("exact", amax)):
        packs = [halo_pack(x, i, aa) for x, i, aa in
                 zip(xs, prop.send_idx, a or [None] * S)]
        recv = mesh.all_to_all([p.view(S, c_max, -1) for p, _ in packs])
        r0 = recv[0].view(S * c_max, -1)
        sc = packs[0][1]
        rv = prop.row_val[0] if form == "exact" else None
        y, acc = torch.empty_like(x0), torch.zeros_like(x0)
        diag, halo = prop.diag[0], prop.halo[0]

        def hop(fn):
            fn(diag, halo, x0, r0, y, acc, 0.8, True, sc, rv)

        ms = _time_ms(lambda: hop(halo_hop), 30)
        plain_ms = _time_ms(lambda: hop(halo_hop_plain), 3, warmup=1)
        width = 4 if form == "f32" else 1
        nbytes = (8 * (rows + 1) + 8 * diag.nnz + 4 * halo.nnz
                  + (4 * halo.nnz if form == "f32" else 4 * rows + 4 * nfeat)
                  + rows * nfeat * 4 + S * c_max * nfeat * width
                  + 3 * rows * nfeat * 4)
        b = _bound(nbytes, 2 * (diag.nnz + halo.nnz) * nfeat
                   + 3 * rows * nfeat)
        out[f"halo_hop_{form}"] = {"ms": ms, "plain_ms": plain_ms,
                                   "library_ms": None, "bound_ms": b[0],
                                   "bound_by": b[1]}
        del packs, recv, r0, y, acc
    # the quantize split at a shard's block
    ms = _time_ms(lambda: column_absmax(x0), 30)
    plain_ms = _time_ms(lambda: column_absmax_plain(x0), 10)
    lib = _time_ms(lambda: torch.linalg.vector_norm(x0, float("inf"), 0), 30)
    b = _bound(rows * nfeat * 4 + 4 * nfeat, rows * nfeat)
    out["column_absmax"] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib, "bound_ms": b[0],
                            "bound_by": b[1]}
    ms = _time_ms(lambda: quantize_with_amax(x0, amax[0]), 30)
    plain_ms = _time_ms(lambda: quantize_with_amax_plain(x0, amax[0]), 10)
    b = _bound(rows * nfeat * 5 + 8 * nfeat, 3 * rows * nfeat)
    out["quantize_with_amax"] = {"ms": ms, "plain_ms": plain_ms,
                                 "library_ms": None, "bound_ms": b[0],
                                 "bound_by": b[1]}
    # the collectives: copies on the one card
    sends = [halo_pack(x, i)[0].view(S, c_max, -1)
             for x, i in zip(xs, prop.send_idx)]
    out["all_gather_ms"] = _time_ms(lambda: mesh.all_gather(xs), 10)
    out["all_to_all_ms"] = _time_ms(lambda: mesh.all_to_all(sends), 10)
    out["pmax_ms"] = _time_ms(lambda: mesh.pmax(amax), 10)
    for k, v in out.items():
        print(f"[{tag}] {k} at shard 0 ([{rows},{nfeat}], {m} send rows): "
              f"{v}", flush=True)
    return out


def check_d1(ops: dict) -> dict:
    """Phase 8: D1 on a 4-shard mesh on the one card. Returns the launches
    of each run, the errors and the times."""
    cfg = preset("Amazon2M")
    adj, x, single = ops["adj"], ops["x"], ops["f32"]
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    mesh = make_mesh(SHARDS, devices=[DEV] * SHARDS)
    ref = {p: single(x, precision=p, **kw) for p in ("f32", "bf16", "int8")}
    res = {"launches": {}, "err": {}, "wall_s": {}}
    halo_prop = None
    for name, threshold, precision, kernels in D1_RUNS:
        t0 = time.time()
        if name.startswith("scatter"):
            prop = ShardedPropagator(mesh, ShardedGraph.build(adj, SHARDS))
            call = {}
        else:
            prop, p = dist_exact_propagator(mesh, adj, x.shape[1],
                                            halo_threshold=threshold,
                                            precision=precision)
            call = {"precision": p}
        torch.cuda.synchronize(DEV)
        build_s = time.time() - t0
        _reset_counts()
        t0 = time.time()
        out = prop(x, **kw, **call)
        torch.cuda.synchronize(DEV)
        hops_s = time.time() - t0
        launches = _read_counts()
        plain = prop(x, **kw, **call, plain=True)
        e_plain = _errors(out, plain)
        e_single = _errors(out, ref[precision])
        e_f32 = _errors(out, ref["f32"])
        limit = 5e-3 if precision == "int8" else TOL
        want = {k: cfg.order * SHARDS if k in kernels else 0
                for k in launches}
        # the one-card run's own distance from f32, which the sharded run
        # of the same form must not exceed by more than 1e-3
        own = _errors(ref[precision], ref["f32"])[1]
        gate = TOL if precision == "f32" else 5e-3
        print(f"[8] {name} ({type(prop).__name__}, {SHARDS} shards of "
              f"{prop.g.rows_per_shard} rows): build {build_s} s, "
              f"{cfg.order} hops {hops_s} s; launches "
              f"{ {k: v for k, v in launches.items() if v} }; vs its plain "
              f"run max_rel_err {e_plain[1]} (limit {limit}); vs the "
              f"one-card Propagator at {precision} {e_single[1]}; vs f32 "
              f"{e_f32[1]} (the one-card {precision} run: "
              f"{own}; fast-path gate {gate}: "
              f"{'held' if e_f32[1] <= gate else 'exceeded'})", flush=True)
        if launches != want:
            raise AssertionError(f"[8] {name}: launches {launches}, want "
                                 f"{want}")
        # the fast forms against f32 only: the halo's quantizes the
        # exchanged rows alone, so it need not be near the one-card int8
        if not (e_plain[1] <= limit and e_f32[1] <= max(gate, own + 1e-3)):
            raise AssertionError(f"[8] {name}: {e_plain[1]} from its plain "
                                 f"run, {e_single[1]} from the one-card run, "
                                 f"{e_f32[1]} from f32 (one-card {own})")
        res["launches"][name] = launches
        res["err"][name] = {"vs_plain": e_plain, "vs_single": e_single[1],
                            "vs_f32": e_f32[1]}
        res["wall_s"][name] = {"build": build_s, "hops": hops_s}
        if name == "halo_f32":
            halo_prop = prop
        del out, plain
    print(f"[8] halo compression {halo_prop.g.compression} (C_max "
          f"{halo_prop.g.halo_per_pair} of {halo_prop.g.rows_per_shard} "
          f"rows a shard)", flush=True)
    xs = [b.contiguous() for b in
          torch.cat([x, x.new_zeros(halo_prop.g.rows_per_shard * SHARDS
                                    - x.shape[0], x.shape[1])]).split(
              halo_prop.g.rows_per_shard)]
    res["times"] = _d1_times(halo_prop, xs, "8")
    res["compression"] = halo_prop.g.compression
    res["shape"] = (f"shard [{halo_prop.g.rows_per_shard},{x.shape[1]}], "
                    f"{halo_prop.g.halo_per_pair} rows a pair")
    return res


def run_serving(r, data, ckpt: str) -> dict:
    """Phase 5e: the predict CLI from 5d's best.npz, at f32 and auto, each
    a path of its own; its test accuracy against 5d's model at the same
    precision. Returns the launches by precision."""
    cfg = preset("Amazon2M").replace(dataset=AMAZON)
    adj_sl = add_self_loops_adj(data.adj)
    feats = torch.as_tensor(data.features, device=DEV)
    want = {"auto": r.test_acc,
            "f32": test_accuracy(r.model, exact_propagate(
                adj_sl, feats, mode=cfg.prop_mode, order=cfg.order,
                alpha=cfg.alpha, device=DEV), data.idx_test,
                data.labels_int)}
    del feats
    torch.cuda.empty_cache()
    out_npz = os.path.join(CKPT_DIR, "predictions.npz")
    res = {}
    for precision, form in (("f32", "f32"), ("auto", "int8mxu")):
        argv = ["predict", "--preset", "Amazon2M", "--dataset", AMAZON,
                "--ckpt", ckpt, "--precision", precision, "--output",
                out_npz]
        stdout, stderr = io.StringIO(), io.StringIO()
        _reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            rc = cli(argv)
        wall = time.time() - t0
        launches = _read_counts()
        if rc != 0:
            raise AssertionError(f"[5e] predict {precision} exited {rc}: "
                                 f"{stderr.getvalue()[-2000:]}")
        line = json.loads(stdout.getvalue().strip().splitlines()[-1])
        seconds = json.loads(stderr.getvalue().strip().splitlines()[-1])
        with np.load(out_npz) as z:
            shape = z["logits"].shape
            finite = bool(np.isfinite(z["logits"]).all())
        print(f"[5e] python -m grandtpu_torch.cli.main {' '.join(argv)}: "
              f"{line}; wall {wall} s, {seconds['predict_seconds']}; logits "
              f"{shape}, finite {finite}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; test_acc "
              f"{line['test_acc']} against train()'s model at {precision} "
              f"{want[precision]}", flush=True)
        if not (shape == (data.num_nodes, data.num_classes) and finite
                and line["test_acc"] == want[precision]):
            raise AssertionError(f"[5e] predict {precision}: logits {shape}, "
                                 f"finite {finite}, test_acc "
                                 f"{line['test_acc']} != {want[precision]}")
        _check_hops(launches, form, cfg.order)
        res[precision] = {"launches": launches, "wall_s": wall,
                          **seconds["predict_seconds"]}
    return res


def serving_entries(seg: dict, d1: dict, serve: dict) -> list:
    """The kernels line's entries of K2-seg, the quantize split and D1's
    kernels, launches by path."""
    runs = d1["launches"]
    times = d1["times"]
    seg["launches_by_path"]["d1_scatter"] = runs["scatter_f32"]["coo_spmm"]
    seg["launches"] = sum(seg["launches_by_path"].values())
    entries = [seg]
    rows = (("column_absmax", "grandtpu/dist/spmm_shard.py:341",
             times["column_absmax"]),
            ("quantize_with_amax", "grandtpu/dist/spmm_shard.py:342",
             times["quantize_with_amax"]),
            ("halo_pack", "grandtpu/dist/halo.py:311",
             times["halo_pack_int8"] | {"f32_form": times["halo_pack_f32"]}),
            ("halo_hop", "grandtpu/dist/halo.py:325",
             times["halo_hop_exact"] | {"f32_form": times["halo_hop_f32"]}))
    for name, line, t in rows:
        by_path = {p: la[name] for p, la in runs.items() if la[name]}
        err = max([d1["err"][p]["vs_plain"][0] for p in by_path] or [0.0])
        entries.append({
            "name": name, "route": "cuda",
            "source": "grandtpu_torch/csrc/" + (
                "halo.cu" if name.startswith("halo") else "csr_spmm_q8.cu"),
            "replaces": line, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err, **t,
            "shape": d1["shape"]})
    return entries



def main() -> int:
    t_start = time.time()

    def mark(label: str) -> None:
        print(f"[time] {label} done at {time.time() - t_start:.3f} s",
              flush=True)

    phase_device()
    phase_build()
    mark("build")
    t0 = time.time()
    data = load_data(DATASET, split_seed=preset("reddit").seed1)
    print(f"[data] {DATASET} generated in {time.time() - t0:.3f} s",
          flush=True)
    k1, k2 = check_k1(K1_SHAPE), check_k2(data)
    mark("3 (K1, K2)")
    push_reddit = check_push(data, preset("reddit").replace(dataset=DATASET),
                             "3e", ("jax", "bucket"))
    mark("3e")
    small = preset("reddit").replace(dataset=SMALL, epochs=3,
                                     unlabel_num=500, dropnode_rate=0.0)
    check_small_reference(small)
    mark("4")
    check_small_reference(small.replace(push_backend="bucket"))
    mark("4d")
    launches = run_main_path(data)
    mark("5")
    profile_path(preset("reddit").replace(dataset=DATASET, epochs=2), data,
                 "profile")
    mark("6")
    del data

    t0 = time.time()
    mag = load_data(MAG_DATASET, split_seed=preset("mag_scholar_c").seed1)
    print(f"[data] {MAG_DATASET} generated in {time.time() - t0:.3f} s",
          flush=True)
    k3 = check_k3(mag)
    check_k2_mag(mag, k2)
    mark("3c")
    check_small_reference(preset("mag_scholar_c").replace(
        dataset=MAG_SMALL, epochs=3, dropnode_rate=0.0, input_droprate=0.0,
        hidden_droprate=0.0))
    mark("4b")
    mag_launches = run_mag_path(mag)
    mark("5b")
    profile_path(preset("mag_scholar_c").replace(dataset=MAG_DATASET,
                                                 epochs=5), mag, "profile-mag")
    mark("6b")
    del mag

    amazon_cfg = preset("Amazon2M").replace(dataset=AMAZON, epochs=2,
                                            predict_precision="auto")
    t0 = time.time()
    amazon = load_data(AMAZON, split_seed=amazon_cfg.seed1)
    print(f"[data] {AMAZON} generated in {time.time() - t0:.3f} s",
          flush=True)
    # one build of the 2M-node operators for phases 3d and 7
    ops = amazon_operators(amazon)
    mark("Amazon2M data and operators")
    k1_amazon = check_k1(AMAZON_K1_SHAPE, ops["x"], "K1 Amazon2M")
    for key in ("max_abs_err", "max_rel_err"):
        k1[key] = max(k1[key], k1_amazon[key])
    k1["amazon"] = {k: v for k, v in k1_amazon.items()
                    if k not in ("name", "route", "source", "replaces")}
    fast = check_fast_kernels(ops, k2)
    mark("3d")
    sweep_launches = precision_sweep(ops)
    mark("7")
    seg = check_segment(ops)
    mark("3g")
    d1 = check_d1(ops)
    mark("8")
    del ops
    torch.cuda.empty_cache()
    push_amazon = check_push(amazon, amazon_cfg, "3f", ("bucket",))
    mark("3f")
    check_small_fast()
    check_small_reference(amazon_cfg.replace(
        dataset=AMAZON_SMALL, epochs=3, dropnode_rate=0.0))
    mark("4c")
    r_native, amazon_launches = run_amazon_path(amazon, "auto", "amazon")
    mark("5c")
    profile_path(amazon_cfg, amazon, "profile-amazon")
    mark("6c")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    r_bucket, bucket_launches = run_amazon_path(amazon, "bucket",
                                                "amazon-bucket", CKPT_DIR)
    print(f"[amazon-bucket] preprocess_s {r_bucket.preprocess_time} with the "
          f"bucket push on the card against {r_native.preprocess_time} with "
          f"native (5c); test_acc {r_bucket.test_acc} (5c: "
          f"{r_native.test_acc}; anchor 0.996, not gated)", flush=True)
    mark("5d")
    serve = run_serving(r_bucket, amazon, os.path.join(CKPT_DIR, "best.npz"))
    mark("5e")
    del amazon

    k1["launches_by_path"] = {
        "reddit": launches["dropnode_mean"],
        "amazon": amazon_launches["dropnode_mean"],
        "amazon_bucket": bucket_launches["dropnode_mean"]}
    p1 = push_reddit["launches"]["jax"]
    k2["launches_by_path"] = {
        "reddit": launches["csr_spmm_prop"],
        "mag": mag_launches["csr_spmm_prop"],
        "amazon": amazon_launches["csr_spmm_prop"],
        "sweep": sweep_launches["csr_spmm_prop"],
        "p1_reddit": p1["csr_spmm_prop"],
        "d1_all_gather_f32": d1["launches"]["all_gather_f32"][
            "csr_spmm_prop"],
        "serve_f32": serve["f32"]["launches"]["csr_spmm_prop"]}
    k2["p1_over_at"] = {"ms": push_reddit["jax"]["times"]["k2_over_at_ms"],
                        "shape": "A^T of the reddit stand-in, x [233000, "
                                 "512], per hop"}
    for k in (k1, k2):
        k["launches"] = sum(k["launches_by_path"].values())
    for k in k3:
        k["launches"] = mag_launches[k["name"]]
    for k in fast:
        k["launches_by_path"] = {
            "amazon": amazon_launches[k["name"]],
            "amazon_bucket": bucket_launches[k["name"]],
            "sweep": sweep_launches[k["name"]],
            "serve_auto": serve["auto"]["launches"][k["name"]],
            **{f"d1_{run}": la[k["name"]]
               for run, la in d1["launches"].items() if la[k["name"]]}}
        k["launches"] = sum(k["launches_by_path"].values())
    pushes = push_entries(push_reddit, push_amazon, bucket_launches)
    served = serving_entries(seg, d1, serve)
    print(json.dumps({"serving": serve, "d1": {
        k: d1[k] for k in ("err", "wall_s", "compression")}}))
    print(json.dumps({"kernels": [k1, k2, *fast, *k3, *pushes, *served]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
