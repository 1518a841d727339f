"""The predict driver: full-graph classification requests, a closed loop.

Set-up loads the stand-in through the port's loader, adds self-loops, and
builds the port's ``Propagator`` once, as its docstring intends; the model
is the port's (``MLP`` or ``MagMLP``) holding the benchmark's weights. Each
request first writes a day's updates into a few hundred rows (feature rows
for the dense engine, embedding-table rows for the MAG engine: no answer
can be reused), then classifies every node, ending with the logits on the
host:

- dense: ``Propagator`` over the features, then ``predict_logits``;
- MAG: ``predict_logits_sparse`` with ``propagate=`` the set-up's
  ``Propagator`` (K3's node form, K2 at the hidden width, the head).

After the window, requests drawn from the seed are held to the plain
reference (``reference.predict_logits``), which replays the updates on the
raw data.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from benchmark import reference, roofline, standin, weights
from benchmark.trace import Window

MIX = 0x9E3779B97F4A7C15


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for ``stream`` (0 weights, 1 updates, 2 the
    sample of checked requests), under 2**63."""
    return (seed * 6364136223846793005 + stream * MIX) % (1 << 63)


class Marks:
    """Device timestamps: CUDA events on a card, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Updates:
    """The requests' updates, drawn on the device: request i writes
    ``rows`` distinct rows (one in each of ``rows`` equal strides, from a
    random offset) with fresh N(0, 1) values."""

    def __init__(self, seed: int, num_rows: int, width: int, rows: int,
                 device):
        self.g = torch.Generator(device=device).manual_seed(
            sub_seed(seed, 1))
        self.n, self.width, self.rows = num_rows, width, rows
        self.step = num_rows // rows
        self.device = device

    def next(self) -> tuple:
        g, dev = self.g, self.device
        r0 = torch.randint(0, self.n, (1,), generator=g, device=dev)
        jitter = torch.randint(0, self.step, (self.rows,), generator=g,
                               device=dev)
        rows = (r0 + torch.arange(self.rows, device=dev) * self.step
                + jitter) % self.n
        vals = torch.randn(self.rows, self.width, generator=g, device=dev)
        return rows, vals


def _setup(cfg: dict, dirs: dict, seed: int, device):
    """The port's objects for a request: (state, target tensor the updates
    write, request function)."""
    os.environ["GRANDTPU_DATA_DIR"] = standin.data_root(cfg, dirs["data"])
    from grandtpu_torch.data import load_data
    from grandtpu_torch.data.preprocess import add_self_loops_adj
    from grandtpu_torch.infer import classify, propagate
    from grandtpu_torch.nn.mlp import MLP, MLPConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = load_data(cfg["dataset"], split_seed=0)
    adj_sl = add_self_loops_adj(data.adj)
    mlp_cfg = MLPConfig(num_features=cfg["features"],
                        num_classes=cfg["classes"], hidden=cfg["hidden"],
                        nlayers=cfg["nlayers"], use_bn=cfg["use_bn"],
                        node_norm=cfg["node_norm"])
    w = weights.make(cfg, sub_seed(seed, 0), device)
    width = cfg["features"] if cfg["engine"] == "dense" else cfg["hidden"]
    prop, precision = propagate.exact_propagator(
        adj_sl, width, precision=cfg["predict_precision"], device=device)
    hops = dict(mode=cfg["prop_mode"], order=cfg["order"],
                alpha=cfg["alpha"], precision=precision)
    bs = cfg["predict_batch_size"]
    state = {"prop": prop, "nnz": int(adj_sl.nnz)}
    if cfg["engine"] == "dense":
        with torch.device(device):
            model = MLP(mlp_cfg)
        features = torch.as_tensor(np.asarray(data.features, np.float32),
                                   device=device)
        state.update(model=model, features=features)
        target = features

        def run(spans):
            spans("propagate")
            x = prop(features, **hops)
            spans("classify")
            return classify.predict_logits(model, x, bs)
    else:
        from grandtpu_torch.nn.mag_mlp import MagMLP
        from grandtpu_torch.nn.sparse_input import PaddedFeatures

        padded = PaddedFeatures.from_csr(data.features)
        attr_cols = torch.as_tensor(padded.attr_cols, device=device)
        attr_vals = torch.as_tensor(padded.attr_vals, device=device)
        with torch.device(device):
            model = MagMLP(mlp_cfg)
        state.update(model=model, attr_cols=attr_cols, attr_vals=attr_vals)
        target = model.table

        def run(spans):
            spans("embed")

            def propagate_fn(embs):
                spans("propagate")
                out = prop(embs, **hops)
                spans("classify")
                return out
            return classify.predict_logits_sparse(
                model, attr_cols, attr_vals, None, batch_size=bs,
                propagate=propagate_fn)
    del data, adj_sl
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(w[name])
    del w
    model.eval()
    return state, target, run


def run(ctx: dict) -> dict:
    """One run of a predict cell: the end-to-end numbers, the observations
    for the metric readers and the logit gaps of the checked requests."""
    cfg, traffic, device = ctx["cfg"], ctx["traffic"], ctx["device"]
    seed, seconds = ctx["seed"], ctx["seconds"]
    state, target, run_one = _setup(cfg, ctx["dirs"], seed, device)
    n = target.shape[0] if cfg["engine"] == "dense" else \
        state["attr_cols"].shape[0]
    nnz = state["nnz"]
    updates = Updates(seed, target.shape[0], target.shape[1],
                      traffic["rows_per_request"], device)
    marks = Marks(device)
    record = ctx.get("record_function") or _no_range
    sample = Reservoir(sub_seed(seed, 2), traffic["checked_requests"] - 1)

    def request():
        stamps, open_ = {}, []

        def spans(name):
            # a device stamp and a host range for each part of the request
            stamps[name] = marks.mark()
            if open_:
                open_.pop().__exit__(None, None, None)
            r = record(name)
            r.__enter__()
            open_.append(r)

        with record("request"):
            t0 = time.perf_counter()
            spans("update")
            with torch.no_grad():
                rows, vals = updates.next()
                target.data[rows] = vals
            logits = run_one(spans)
            stamps["end"] = marks.mark()
            open_.pop().__exit__(None, None, None)
            dt = time.perf_counter() - t0
        return dt, stamps, logits

    warm = traffic["warmup_requests"]
    for _ in range(warm):
        request()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_window = time.time()
    times, stamps_all = [], []
    window = Window(device) if ctx["trace"] and device.type == "cuda" \
        else None
    traced = 0
    if window:
        window.start()
    t0 = time.perf_counter()
    while True:
        dt, st, logits = request()
        times.append(dt)
        stamps_all.append(st)
        sample.offer(warm + len(times) - 1, logits)
        elapsed = time.perf_counter() - t0
        if window and window.prof is not None and (
                elapsed >= traffic["trace_seconds"]
                and len(times) >= traffic["trace_min_requests"]):
            window.stop()
            traced = len(times)
        if elapsed >= seconds:
            break
    window_s = time.perf_counter() - t0
    count = len(times)
    kept = dict(sample.items)
    kept[warm + count - 1] = logits
    del logits
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    spans = {name: [marks.ms(st[a], st[b]) for st in stamps_all]
             for name, a, b in _SPANS[cfg["engine"]]}
    # the program's state goes before the reference runs
    del state, target, run_one, sample
    if device.type == "cuda":
        torch.cuda.empty_cache()
    raw = standin.raw_arrays(cfg, standin.data_root(cfg, ctx["dirs"]["data"]))
    tokens = None
    if cfg["engine"] == "sparse":
        f = raw["features"]
        tokens = (int(f.nnz), int(np.count_nonzero(
            np.bincount(f.indices, minlength=f.shape[1]))))
    obs = {"window": window, "traced_requests": traced, "spans_ms": spans,
           "work": request_work(cfg, n, nnz, tokens)}
    gaps = check(cfg, raw, seed, traffic, kept, device)
    lat_ms = sorted(t * 1e3 for t in times)
    return {"t_window": t_window, "attempted": count, "failed": 0,
            "e2e": {"predict_nodes_per_s": n * count / window_s,
                    "predict_ms_p90": float(np.percentile(lat_ms, 90))},
            "obs": obs, "peak": peak,
            "compared": {"logit_gap": max(gaps.values())},
            "detail": {"checked": {str(k): v for k, v in gaps.items()},
                       "median_ms": float(np.median(lat_ms)),
                       "latency_ms": [round(t * 1e3, 2) for t in times],
                       "span_median_ms": {k: float(np.median(v))
                                          for k, v in spans.items()}}}


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from ``seed`` (algorithm R)."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng(seed)
        self.size, self.seen = size, 0
        self.items: list = []

    def offer(self, key, item) -> None:
        if len(self.items) < self.size:
            self.items.append((key, item))
        else:
            r = int(self.rng.integers(0, self.seen + 1))
            if r < self.size:
                self.items[r] = (key, item)
        self.seen += 1


_SPANS = {"dense": (("update", "update", "propagate"),
                    ("propagate", "propagate", "classify"),
                    ("classify", "classify", "end")),
          "sparse": (("update", "update", "embed"),
                     ("embed", "embed", "propagate"),
                     ("propagate", "propagate", "classify"),
                     ("classify", "classify", "end"))}


def _no_range(name):
    return contextlib.nullcontext()


def request_work(cfg: dict, n: int, nnz: int, distinct_ids) -> dict:
    """Least seconds of one request's parts: the embedding (MAG), the
    propagation, the classifier with its logits (the update's few rows
    are left out)."""
    width = cfg["features"] if cfg["engine"] == "dense" else cfg["hidden"]
    prop_s = roofline.propagate_s(n, nnz, width, cfg["order"])
    h, c = cfg["hidden"], cfg["classes"]
    if cfg["engine"] == "dense":
        dims = [(cfg["features"], h)] + [(h, h)] * (cfg["nlayers"] - 2) \
            + [(h, c)]
    else:
        dims = [(h, h)] * (cfg["nlayers"] - 2) + [(h, c)]
    cls_s = roofline.least_s(*roofline.mlp_work(n, dims, c))
    out = {"propagate_s": prop_s, "classify_s": cls_s}
    if cfg["engine"] == "sparse" and distinct_ids is not None:
        tokens, ids = distinct_ids
        out["embed_s"] = roofline.least_s(
            *roofline.embed_work(n, tokens, ids, h))
    out["request_s"] = sum(out.values())
    return out


def check(cfg: dict, raw: dict, seed: int, traffic: dict, kept: dict,
          device) -> dict:
    """{request: logit gap} of the kept requests against the reference,
    which replays every update up to each of them on the raw data."""
    params = weights.make(cfg, sub_seed(seed, 0), device)
    dense = cfg["engine"] == "dense"
    base = torch.as_tensor(raw["features"], device=device) if dense \
        else params["table"]
    updates = Updates(seed, base.shape[0], base.shape[1],
                      traffic["rows_per_request"], device)
    gaps, done = {}, 0
    for i in sorted(kept):
        with torch.no_grad():
            while done <= i:
                rows, vals = updates.next()
                base[rows] = vals
                done += 1
        want = reference.predict_logits(cfg, raw, base if dense else None,
                                         params, device)
        gaps[i] = reference.logit_gap(kept.pop(i), want)
        del want
    return gaps
