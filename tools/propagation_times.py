"""Times of the port's int8 and segment propagations on one CUDA card, for
comparing two checkouts of the repo in one call (parent, change, change,
parent).

Usage, from the root of a checkout, with another checkout (for example a
``git archive`` of the parent commit) unpacked under a git-ignored path:

    python tools/propagation_times.py ROOT TAG [all|int8|seg]

imports ``grandtpu_torch`` from ROOT (its kernels build under
ROOT/build), and on the Amazon2M stand-in ``synth:2000000:47:100`` (ppr,
order 6, alpha 0.2) times with CUDA events:

- int8: the whole 6-hop int8 and int8cast runs of the csr Propagator
  (with a digest of each result, so two checkouts can be compared bit for
  bit), f32's, ``calibrate()``'s pick, ``quantize_columns``,
  ``column_absmax``, ``quantize_with_amax``, one K2-q8mxu and one K2-q8
  hop, and, where the checkout has it, each hop raising its column maxima
  (``amax_out``: into the maxima it raised before, and into a buffer
  zeroed before every call);
- seg: the whole 6-hop segment run, one fused K2-seg hop
  (``spmm_segment_prop_step``) and the bare product; on a checkout
  without the fused hop, the zero-fill, the kernel, ``mul_`` and ``add_``
  of one hop apart;
- all: both, then D1 on 4 shards of the one card (the all_gather int8 and
  the scatter runs, synchronized host wall).

Prints one JSON line, with the card's name and power limit in ``smi``.
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

root, tag = sys.argv[1], sys.argv[2]
mode = sys.argv[3] if len(sys.argv) > 3 else "all"
sys.path.insert(0, os.path.abspath(root))

import torch  # noqa: E402

from grandtpu_torch.data import load_data  # noqa: E402
from grandtpu_torch.data.preprocess import add_self_loops_adj  # noqa: E402
from grandtpu_torch.dist import (ShardedGraph, ShardedPropagator,  # noqa
                                 dist_exact_propagator, make_mesh)
from grandtpu_torch.infer import Propagator  # noqa: E402
from grandtpu_torch.ops._build import check, load_kernels  # noqa: E402
from grandtpu_torch.sparse import spmm as S  # noqa: E402

DEV = torch.device("cuda", 0)


def tms(fn, iters, warmup=2):
    """Mean ms of one ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(DEV)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize(DEV)
    return a.elapsed_time(b) / iters


def wall(fn, iters):
    """Mean host ms of one synchronized ``fn()``."""
    fn()
    torch.cuda.synchronize(DEV)
    t = time.time()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize(DEV)
    return (time.time() - t) / iters * 1e3


def digest(t):
    return hashlib.sha1(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def int8_times(adj, data, x, x0, kw, r):
    prop = Propagator(adj, backend="csr", device=DEV)
    op, rv = prop.adj_op, prop.row_val
    ref = prop(x, **kw)
    for p in ("int8", "int8cast"):
        o = prop(x, precision=p, **kw)
        r[f"run_{p}_ms"] = tms(lambda: prop(x, precision=p, **kw), 10)
        r[f"run_{p}_digest"] = digest(o)
        r[f"run_{p}_err_vs_f32"] = float((o - ref).abs().max()
                                         / ref.abs().max())
    r["run_f32_ms"] = tms(lambda: prop(x, **kw), 10)
    r["calibrate"] = prop.calibrate(data.features, mode="ppr", order=6,
                                    alpha=0.2)
    y, acc = torch.empty_like(x), x0.clone()
    amax = S.column_absmax(x0)
    r["quantize_columns_ms"] = tms(lambda: S.quantize_columns(x0), 30)
    r["column_absmax_ms"] = tms(lambda: S.column_absmax(x0), 30)
    r["quantize_with_amax_ms"] = tms(lambda: S.quantize_with_amax(x0, amax),
                                     30)
    q, cs = S.quantize_columns(x0)
    hops = {"q8mxu": lambda *am: S.spmm_prop_step_q8mxu(
                op, q, cs, rv, y, acc, 0.8, True, *am),
            "q8": lambda *am: S.spmm_prop_step_q8(
                op, q, cs, y, acc, 0.8, True, *am)}
    for name, hop in hops.items():
        r[f"{name}_hop_ms"] = tms(hop, 30)
    if "amax_out" in inspect.signature(S.spmm_prop_step_q8mxu).parameters:
        am = torch.zeros(x.shape[1], device=DEV)
        zero_ms = tms(am.zero_, 30)
        for name, hop in hops.items():
            r[f"{name}_hop_amax_ms"] = tms(lambda: hop(am), 30)
            r[f"{name}_hop_amax_fresh_ms"] = tms(
                lambda: (am.zero_(), hop(am)), 30) - zero_ms


def seg_times(adj, x, x0, kw, r):
    n, nfeat = x.shape
    seg = Propagator(adj, backend="segment", device=DEV)
    r["seg_run_digest"] = digest(seg(x, **kw))
    r["seg_run_ms"] = tms(lambda: seg(x, **kw), 10)
    padded = seg.adj_op
    acc = x0.clone()
    if hasattr(S, "spmm_segment_prop_step"):
        y = torch.empty_like(x0)
        r["seg_hop_ms"] = tms(lambda: S.spmm_segment_prop_step(
            padded, x0, y, acc, 0.8, True), 30)
        r["seg_bare_ms"] = tms(lambda: S.spmm_segment(padded, x0, out=y), 30)
        return
    # the earlier K2-seg: a zero-filled [n + 1, F] output, then the update
    buf = torch.empty((n + 1, nfeat), device=DEV)
    lib = load_kernels()
    stream = torch.cuda.current_stream(DEV).cuda_stream
    r["seg_fill_ms"] = tms(buf.zero_, 30)
    r["seg_kernel_ms"] = tms(lambda: check(lib.coo_spmm(
        padded.rows.data_ptr(), padded.cols.data_ptr(),
        padded.vals.data_ptr(), x0.data_ptr(), buf.data_ptr(),
        padded.num_edges_padded, n, nfeat, stream), "coo_spmm"), 30)
    h = buf[:n]
    r["seg_mul_ms"] = tms(lambda: h.mul_(0.8), 30)
    r["seg_add_ms"] = tms(lambda: acc.add_(h), 30)
    r["seg_bare_ms"] = tms(lambda: S.spmm_segment(padded, x0, out=buf), 30)
    r["seg_hop_ms"] = r["seg_bare_ms"] + r["seg_mul_ms"] + r["seg_add_ms"]


def d1_times(adj, x, kw, r):
    mesh = make_mesh(4, devices=[DEV] * 4)
    ag, p = dist_exact_propagator(mesh, adj, x.shape[1], precision="int8")
    r["d1_ag_int8_digest"] = digest(ag(x, precision=p, **kw))
    r["d1_ag_int8_ms"] = wall(lambda: ag(x, precision=p, **kw), 5)
    del ag
    sc = ShardedPropagator(mesh, ShardedGraph.build(adj, 4))
    r["d1_scatter_digest"] = digest(sc(x, **kw))
    r["d1_scatter_ms"] = wall(lambda: sc(x, **kw), 5)


def main():
    if not S.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {S.__file__}, not from {root}")
    r = {"tag": tag, "root": root, "smi": subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    t0 = time.time()
    load_kernels()
    r["build_s"] = time.time() - t0
    data = load_data("synth:2000000:47:100")
    adj = add_self_loops_adj(data.adj)
    x = torch.as_tensor(data.features, device=DEV)
    x0 = 0.2 * x
    kw = dict(mode="ppr", order=6, alpha=0.2)
    if mode in ("all", "int8"):
        int8_times(adj, data, x, x0, kw, r)
    if mode in ("all", "seg"):
        seg_times(adj, x, x0, kw, r)
    if mode == "all":
        d1_times(adj, x, kw, r)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
