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
from grandtpu_torch.infer.classify import embed_all_nodes
from grandtpu_torch.nn.dropnode import gather_and_prop, gather_and_prop_plain
from grandtpu_torch.nn.sparse_input import (PaddedFeatures, embed_prop,
                                            embed_prop_backward,
                                            embed_prop_plain)
from grandtpu_torch.ops._build import build, build_dir
from grandtpu_torch.sparse.spmm import spmm_prop_step, spmm_prop_step_plain
from grandtpu_torch.train import train

DATASET = "synth:233000:41:602"     # RESULTS.md's reddit scale stand-in
SMALL = "synth:2000:8:64"
# K1 at the main path's shapes: N, F, B = 50 + 200, Ktop, K, eval rows
K1_SHAPE = (233000, 602, 250, 64, 2, 1230)
MAG_DATASET = "synth:1000000:8:2780000:sparse"   # tools/mag_scale_run.py vocab
MAG_SMALL = "synth:2000:8:500:sparse"
# K3 at the MAG main path's shapes: batch rows 20 + 20, Ktop, K, val rows
# (8 classes x 30), predict chunk
K3_SHAPE = (40, 32, 2, 240, 10000)
H_MAG = 64                          # mag_scholar_c hidden width
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


COUNTED = {"dropnode_mean": gather_and_prop, "csr_spmm_prop": spmm_prop_step,
           "embed_prop_fwd": embed_prop,
           "embed_prop_bwd": embed_prop_backward}


def run_path(cfg, data, tag: str) -> tuple:
    """One ``train()`` of the path with every launch count set to 0 just
    before and read just after; returns (result, launches)."""
    for fn in COUNTED.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.time()
    r = train(cfg, data=data, device=DEV)
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in COUNTED.items()}
    print(f"[{tag}] {cfg.dataset}, {cfg.epochs} epochs: steps "
          f"{r.num_batches}, evals {len(r.history)}, launches {launches}, "
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
    if launches["csr_spmm_prop"] != cfg.order:
        raise AssertionError(f"K2 launched {launches['csr_spmm_prop']} "
                             f"times, expected order={cfg.order}")
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
    the device's busy share of the ``train()`` call."""
    from torch.profiler import ProfilerActivity, profile

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
                                             "embed_prop")):
            print(f"[{tag}] {t:10.4f} ms {n:6d}x {name[:100]}")


def main() -> int:
    phase_device()
    phase_build()
    t0 = time.time()
    data = load_data(DATASET, split_seed=preset("reddit").seed1)
    print(f"[data] {DATASET} generated in {time.time() - t0:.3f} s",
          flush=True)
    k1, k2 = check_k1(), check_k2(data)
    check_small_reference(preset("reddit").replace(
        dataset=SMALL, epochs=3, unlabel_num=500, dropnode_rate=0.0))
    launches = run_main_path(data)
    profile_path(preset("reddit").replace(dataset=DATASET, epochs=2), data,
                 "profile")
    del data

    t0 = time.time()
    mag = load_data(MAG_DATASET, split_seed=preset("mag_scholar_c").seed1)
    print(f"[data] {MAG_DATASET} generated in {time.time() - t0:.3f} s",
          flush=True)
    k3 = check_k3(mag)
    check_k2_mag(mag, k2)
    check_small_reference(preset("mag_scholar_c").replace(
        dataset=MAG_SMALL, epochs=3, dropnode_rate=0.0, input_droprate=0.0,
        hidden_droprate=0.0))
    mag_launches = run_mag_path(mag)
    profile_path(preset("mag_scholar_c").replace(dataset=MAG_DATASET,
                                                 epochs=5), mag, "profile-mag")

    k1["launches"] = launches["dropnode_mean"]
    k2["launches_by_path"] = {"reddit": launches["csr_spmm_prop"],
                              "mag": mag_launches["csr_spmm_prop"]}
    k2["launches"] = sum(k2["launches_by_path"].values())
    for k in k3:
        k["launches"] = mag_launches[k["name"]]
    print(json.dumps({"kernels": [k1, k2, *k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
