"""Times of the port's propagations, of K1, of K3 and of D1's halo exchange
on one CUDA card, for comparing two checkouts of the repo in one call (parent,
change, change, parent).

Usage, from the root of a checkout, with another checkout (for example a
``git archive`` of the parent commit) unpacked under a git-ignored path:

    python tools/propagation_times.py ROOT TAG [all|int8|seg|k1|k3|halo|head]

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
  the scatter runs, synchronized host wall);
- k1: K1 (``gather_and_prop``) on random features at the five forms
  the paths give it: reddit train [2,250,602], eval [1,1230,602] and a
  2-shard mesh's shard [2,125,602] on [233000, 602]; Amazon2M train
  [2,250,100] and eval [1,1410,100] on [2000000, 100]; Ktop 64, keep
  masks at 0.5. Each form cycles 8 input sets (fresh batches miss the L2
  as a train step's do) and gives its device time (torch.profiler, the
  kernel alone), its CUDA-events time over back-to-back calls, its bound
  (the distinct rows of the slots that some mask keeps with a nonzero
  weight, read once; cols, vals and masks; the output; at 3.35 TB/s), a
  digest of its output on the first set and its error against the plain
  version there, and CUDA events' time of ``index_select`` gathering the
  same slots' rows (a plain gather: each row read and written once);
- k3: on the MAG stand-in ``synth:1000000:8:2780000:sparse`` at the
  mag_scholar_c preset's shapes (H 64, Ktop 32, P 24), K3's device time
  (torch.profiler, the kernel alone) in each form: the forward in the
  train [2,40,64], train with input dropout 0.5, eval [1,240,64] and node
  [1,10000,64] forms and over each of the 4 vocab windows; the node form
  over all nodes as the predict runs it (CUDA events, and the kernels'
  summed device time); with a digest of every output. Then the backward
  (``embed_prop_backward`` and ``embed_prop_window_backward`` over the
  first of 4 windows, called directly as any checkout's take them) in the
  train, train with input dropout 0.5, eval, skewed (the train form over
  Zipf-like ids: ``synthetic_graph``'s ``token_skew`` 4 on 100,000 nodes
  of the same vocabulary) and collide (every attribute id the same)
  forms: a digest of each gradient, CUDA events' time over back-to-back
  calls, and the device time of one call as the sum of every device
  operation it runs (kernels, fills, memsets), the sort kernels' share
  apart;
- halo: on the Amazon2M stand-in, halo_pack's int8 and f32 forms at shard
  0 of a 4-shard HaloPropagator (device time and CUDA events, digests),
  and the halo int8 and f32 6-hop runs (synchronized host wall, digests);
- head: the classifier's eval forward at the predict cells' widths (F 100,
  hidden 1024, 47 classes over 2,449,029 rows; F 602, hidden 512, 41
  classes over 232,965 rows; BN and node_norm on, random rows, weights and
  BN running stats) in chunks of 10,000 rows: the hand-written head
  (``nn/mlp_head.head_launcher``, where the checkout has it) by its device
  time (torch.profiler, the kernel alone, which includes its blocks' wait
  for the launch before it) and CUDA events a chunk, and by
  CUDA events over a whole request's chunks, launched as predict_logits
  does (each after the first may overlap the one before) and one at a
  time; its launches, registers, spills and occupancy (``head_config``),
  its gap to the module's eval forward and to its plain version; its
  share of the f32 rate over a request; its bound (2 F
  H + 2 H C flops a row at 67 TFLOP/s), and CUDA events' time of its plain
  version and of the module's forward (``MLP.forward``, what the parent's
  ``predict_logits`` runs) a chunk and a request.

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
from torch.profiler import ProfilerActivity, profile  # noqa: E402

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


def dev_ms(fn, iters, kernel, per_call=1):
    """Mean device ms a call of the kernels whose name holds ``kernel``
    (``per_call`` launches a call), over ``iters`` calls of ``fn()``: the
    mean over the launches the profiler recorded (it can drop some)."""
    fn()
    torch.cuda.synchronize(DEV)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(DEV)
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    return sum(times) / len(times) * per_call if times else None


def call_dev_ms(fn, iters):
    """(mean device ms of one ``fn()``, of it the sort kernels', device
    operations a call) over ``iters`` calls: every device operation the
    profiler recorded (kernels, fills, memsets; one stream, so none
    overlap). A run whose operations are not a whole number a call (the
    profiler dropped records) is retried."""
    fn()
    torch.cuda.synchronize(DEV)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(DEV)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and len(events) % iters == 0:
            break
    total = sum(e.time_range.elapsed_us() for e in events)
    sort = sum(e.time_range.elapsed_us() for e in events
               if "sort" in e.name.lower())
    return total / iters / 1e3, sort / iters / 1e3, len(events) / iters


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


def k3_sets(attr_cols, attr_vals, form, g):
    """Eight input sets of one K3 form at the MAG step's shapes (distinct
    rows in turn, so the timed gathers miss the L2 as fresh batches do)."""
    n, p = attr_cols.shape
    sets = []
    for i in range(8):
        if form == "node":
            sl = slice(i * 10000, (i + 1) * 10000)
            sets.append({"attr_cols": attr_cols[sl],
                         "attr_vals": attr_vals[sl]})
            continue
        r, k = (240, 1) if form == "eval" else (40, 2)
        s = {"attr_cols": attr_cols, "attr_vals": attr_vals,
             "tk_cols": torch.randint(0, n, (r, 32), generator=g,
                                      device=DEV, dtype=torch.int32),
             "tk_vals": torch.rand(r, 32, generator=g, device=DEV)}
        if form != "eval":
            s["keep"] = torch.rand(k, r, 32, generator=g, device=DEV) < 0.5
        if form == "train_q0.5":
            s["drop"] = torch.rand(k, r, 32, p, 64, generator=g,
                                   device=DEV) < 0.5
        sets.append(s)
    return sets


def k3_times(r):
    import itertools

    from grandtpu_torch.infer.classify import embed_all_nodes
    from grandtpu_torch.nn import sparse_input as K3

    mag = load_data("synth:1000000:8:2780000:sparse")
    padded = K3.PaddedFeatures.from_csr(mag.features)
    g = torch.Generator(device=DEV).manual_seed(1)
    v = padded.num_features
    table = torch.randn(v, 64, generator=g, device=DEV)
    ac = torch.as_tensor(padded.attr_cols, device=DEV)
    av = torch.as_tensor(padded.attr_vals, device=DEV)
    r["k3_shape"] = {"nodes": ac.shape[0], "P": ac.shape[1], "vocab": v}
    with torch.no_grad():
        for form in ("train", "train_q0.5", "eval", "node"):
            q = 0.5 if form == "train_q0.5" else 0.0
            sets = k3_sets(ac, av, form, g)
            it = itertools.cycle(sets)
            r[f"k3_fwd_{form}_digest"] = digest(K3.embed_prop(
                table, **sets[0], droprate=q))
            r[f"k3_fwd_{form}_device_ms"] = dev_ms(
                lambda: K3.embed_prop(table, **next(it), droprate=q), 100,
                "embed_prop_fwd_kernel")
            r[f"k3_fwd_{form}_ms"] = tms(
                lambda: K3.embed_prop(table, **next(it), droprate=q), 200)
        sets = k3_sets(ac, av, "train", g)
        per = -(-v // 4)
        padded_t = torch.cat([table, table.new_zeros(per * 4 - v, 64)])
        wins = [(s * per, (s + 1) * per) for s in range(4)]
        shards = [padded_t[lo:hi].contiguous() for lo, hi in wins]
        for w, ((lo, hi), t) in enumerate(zip(wins, shards)):
            it = itertools.cycle(sets)
            r[f"k3_window{w}_fwd_digest"] = digest(K3.embed_prop_window(
                t, lo, hi, **sets[0]))
            r[f"k3_window{w}_fwd_device_ms"] = dev_ms(
                lambda: K3.embed_prop_window(t, lo, hi, **next(it)), 100,
                "embed_prop_fwd_kernel")
        r["k3_node_all_digest"] = digest(embed_all_nodes(table, ac, av))
        r["k3_node_all_ms"] = tms(lambda: embed_all_nodes(table, ac, av), 3,
                                  warmup=1)
        r["k3_node_all_device_ms"] = dev_ms(
            lambda: embed_all_nodes(table, ac, av), 2,
            "embed_prop_fwd_kernel", -(-ac.shape[0] // 10000))
    # the backward called directly, as every checkout's wrappers take it
    from grandtpu_torch.data.synthetic import synthetic_graph
    _, feats, _ = synthetic_graph(num_nodes=100000, num_classes=8,
                                  num_features=v, sparse_features=True,
                                  token_skew=4.0, seed=0)
    skew = K3.PaddedFeatures.from_csr(feats)
    attrs = {"skewed": (torch.as_tensor(skew.attr_cols, device=DEV),
                        torch.as_tensor(skew.attr_vals, device=DEV)),
             "collide": (torch.full_like(ac, 7), av)}
    r["k3_bwd_skewed_P"] = skew.attr_cols.shape[1]
    for form in ("train", "train_q0.5", "eval", "skewed", "collide"):
        q = 0.5 if form == "train_q0.5" else 0.0
        fac, fav = attrs.get(form, (ac, av))
        s = k3_sets(fac, fav, "eval" if form == "eval" else
                    "train_q0.5" if q else "train", g)[0]
        rows, ktop = s["tk_cols"].shape
        num_aug = 1 if form == "eval" else 2
        dims = (rows, ktop, fac.shape[1], 64, num_aug)
        saved = (fac, fav, s["tk_cols"], s["tk_vals"], s.get("keep"),
                 s.get("drop"), q, dims)
        gout = torch.randn(num_aug, rows, 64, generator=g, device=DEV)
        for name, fn in (
                ("full", lambda: K3.embed_prop_backward(gout, v, *saved)),
                ("window", lambda: K3.embed_prop_window_backward(
                    gout, 0, per, *saved))):
            key = f"k3_bwd_{form}_{name}"
            r[f"{key}_digest"] = digest(fn())
            r[f"{key}_ms"] = tms(fn, 32)
            (r[f"{key}_device_ms"], r[f"{key}_sort_device_ms"],
             r[f"{key}_ops_per_call"]) = call_dev_ms(fn, 32)
        del saved, s


K1_FORMS = {   # N, F, B, Ktop, K
    "reddit_train": (233000, 602, 250, 64, 2),
    "reddit_eval": (233000, 602, 1230, 64, 1),
    "reddit_shard": (233000, 602, 125, 64, 2),
    "amazon_train": (2000000, 100, 250, 64, 2),
    "amazon_eval": (2000000, 100, 1410, 64, 1),
}


def k1_bound_ms(nfeat, cols, vals, keep):
    """Bytes of K1's output and of what it needs to read: the distinct
    rows of slots with a nonzero weight in some mask, 8 B a slot, K B a
    slot of mask, the [K, B, F] output; over the HBM's 3.35 TB/s."""
    num_aug = 1 if keep is None else keep.shape[0]
    live = vals != 0 if keep is None else (vals != 0) & keep.any(0)
    nbytes = (torch.unique(cols[live]).numel() * nfeat * 4
              + cols.numel() * (8 + (0 if keep is None else num_aug))
              + num_aug * cols.shape[0] * nfeat * 4)
    return nbytes / 3.35e12 * 1e3


def k1_times(r):
    import itertools

    from grandtpu_torch.nn.dropnode import (gather_and_prop,
                                            gather_and_prop_plain)

    g = torch.Generator(device=DEV).manual_seed(3)
    tables = {}
    with torch.no_grad():
        for form, (n, nfeat, batch, ktop, num_aug) in K1_FORMS.items():
            if (n, nfeat) not in tables:
                tables.clear()
                tables[n, nfeat] = torch.randn(n, nfeat, generator=g,
                                               device=DEV)
            x = tables[n, nfeat]
            sets = []
            for _ in range(8):
                cols = torch.randint(0, n, (batch, ktop), generator=g,
                                     device=DEV, dtype=torch.int32)
                vals = torch.rand(batch, ktop, generator=g, device=DEV)
                keep = None if num_aug == 1 else torch.rand(
                    num_aug, batch, ktop, generator=g, device=DEV) < 0.5
                sets.append((cols, vals, keep))
            it = itertools.cycle(sets)
            got = gather_and_prop(x, *sets[0])
            want = gather_and_prop_plain(x, *sets[0])
            r[f"k1_{form}_digest"] = digest(got)
            r[f"k1_{form}_rel_err"] = float((got - want).abs().max()
                                            / want.abs().max())
            r[f"k1_{form}_device_ms"] = dev_ms(
                lambda: gather_and_prop(x, *next(it)), 200, "dropnode_mean")
            r[f"k1_{form}_ms"] = tms(lambda: gather_and_prop(x, *next(it)),
                                     400)
            r[f"k1_{form}_bound_ms"] = sum(
                k1_bound_ms(nfeat, *s) for s in sets) / len(sets)
            # the same slots' rows gathered by index_select (read and
            # written once each): what a plain gather reaches
            idx = itertools.cycle([c.view(-1).long() for c, _, _ in sets])
            r[f"k1_{form}_index_select_ms"] = tms(
                lambda: x.index_select(0, next(idx)), 100)


def halo_times(adj, x, kw, r):
    from grandtpu_torch.dist import halo as H
    from grandtpu_torch.sparse.spmm import column_absmax

    mesh = make_mesh(4, devices=[DEV] * 4)
    for precision in ("f32", "int8"):
        prop, p = dist_exact_propagator(mesh, adj, x.shape[1],
                                        halo_threshold=1.0,
                                        precision=precision)
        r[f"halo_{precision}_run_digest"] = digest(prop(x, precision=p, **kw))
        r[f"halo_{precision}_run_ms"] = wall(
            lambda: prop(x, precision=p, **kw), 5)
    g = prop.g
    rows = g.rows_per_shard
    xs = [b.contiguous() for b in torch.cat(
        [x, x.new_zeros(rows * 4 - x.shape[0], x.shape[1])]).split(rows)]
    amax = mesh.pmax([column_absmax(b) for b in xs])[0]
    idx = prop.send_idx[0]
    extra = {"plan": prop.plans[0]} if hasattr(prop, "plans") else {}
    r["halo_pack_shape"] = {"rows": rows, "F": x.shape[1],
                            "slots": idx.numel(),
                            "distinct": torch.unique(idx).numel()}
    for form, a in (("f32", None), ("int8", amax)):
        send, scale = H.halo_pack(xs[0], idx, a, **extra)
        r[f"halo_pack_{form}_digest"] = digest(send) + (
            "" if scale is None else digest(scale))
        r[f"halo_pack_{form}_ms"] = tms(
            lambda: H.halo_pack(xs[0], idx, a, **extra), 30)
        r[f"halo_pack_{form}_device_ms"] = dev_ms(
            lambda: H.halo_pack(xs[0], idx, a, **extra), 30, "halo_pack")


def head_times(r):
    import math

    from grandtpu_torch.nn.mlp import MLP, MLPConfig
    try:
        from grandtpu_torch.nn import mlp_head
    except ImportError:
        mlp_head = None
    bs = 10000
    g = torch.Generator(device=DEV).manual_seed(0)
    for cell, (f, h, c, n) in {"amazon2m": (100, 1024, 47, 2449029),
                               "reddit": (602, 512, 41, 232965)}.items():
        with torch.device(DEV):
            model = MLP(MLPConfig(num_features=f, num_classes=c, hidden=h,
                                  nlayers=2, use_bn=True, node_norm=True))
        with torch.no_grad():
            for fc in model.fcs:
                b = 1.0 / math.sqrt(fc.in_features)
                fc.weight.uniform_(-b, b, generator=g)
                fc.bias.uniform_(-b, b, generator=g)
            for bn in model.bns:
                d = bn.weight.shape[0]
                bn.weight.normal_(1.0, 0.1, generator=g)
                bn.bias.normal_(0.0, 0.1, generator=g)
                bn.running_mean.normal_(0.0, 0.3 / math.sqrt(d), generator=g)
                bn.running_var.uniform_(0.5 / d, 1.5 / d, generator=g)
        model.eval()
        x = torch.randn(n, f, generator=g, device=DEV)
        chunk = x[:bs]
        flops = 2 * (f * h + h * c)
        p = f"{cell}_"
        r[p + "bound_chunk_ms"] = flops * bs / 67e12 * 1e3
        r[p + "bound_request_ms"] = flops * n / 67e12 * 1e3

        def module(rows):
            with torch.no_grad():
                return model(rows)

        def request(fn):
            return lambda: [fn(x[i: i + bs]) for i in range(0, n, bs)]

        r[p + "module_chunk_ms"] = tms(lambda: module(chunk), 10)
        r[p + "module_request_ms"] = tms(request(module), 2)
        if mlp_head is None:
            continue
        plain = mlp_head.eval_head_plain(model, chunk)
        want = module(chunk)
        r[p + "plain_chunk_ms"] = tms(
            lambda: mlp_head.eval_head_plain(model, chunk), 10)
        launch = mlp_head.head_launcher(model)
        got = launch(chunk)
        r[p + "gap_vs_module"] = float((got - want).abs().max()
                                       / want.abs().max())
        r[p + "gap_vs_plain"] = float((got - plain).abs().max()
                                      / want.abs().max())
        r[p + "config"] = mlp_head.head_config(f, h, True)
        before = mlp_head.head_launcher.launches
        r[p + "kernel_chunk_ms"] = tms(lambda: launch(chunk), 30)
        r[p + "kernel_chunk_device_ms"] = dev_ms(lambda: launch(chunk), 30,
                                                 "mlp_head")
        # a request's chunks as predict_logits launches them: each after
        # the first may overlap the one before it
        r[p + "kernel_request_ms"] = tms(lambda: [
            launch(x[i: i + bs], _after_head=i > 0)
            for i in range(0, n, bs)],
            5)
        r[p + "kernel_request_alone_ms"] = tms(request(launch), 5)
        r[p + "kernel_launches"] = mlp_head.head_launcher.launches - before
        r[p + "kernel_share_of_f32_peak"] = (r[p + "bound_request_ms"]
                                             / r[p + "kernel_request_ms"])


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
    if mode in ("k1", "k3", "head"):
        {"k1": k1_times, "k3": k3_times, "head": head_times}[mode](r)
        print(json.dumps(r), flush=True)
        return
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
    if mode == "halo":
        halo_times(adj, x, kw, r)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
