"""Profiles, step timing and the metrics stream (port of
``grandtpu/observe.py``).

- ``profile_trace``: ``torch.profiler`` around a block, host activity and,
  where a card is present, its kernels; a Chrome trace in ``log_dir``
  (open it in Perfetto or ``chrome://tracing``)
- ``StepTimer``: per-step host time and the top-k aggregation's edges/s
- ``MetricsLogger``: an append-only JSONL stream, one writer on a mesh over
  processes
- ``span``: a named range at a layer boundary of the port, recorded only
  while a ``torch.profiler`` profile records (``profile_trace``, or a
  benchmark's traced stretch): on the profiler's timeline, and in memory
  with its parent, root, host and device times and counts, which
  :func:`spans` reads
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
import torch.distributed as tdist

# the most span records kept in memory; later spans are counted, not kept
MAX_SPANS = 65536


def _rank() -> int:
    """This process's rank once ``torch.distributed`` is initialized over
    several ranks, else 0."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is present) and write it as a Chrome trace
    ``trace_rank{r}_{ms}.json`` in ``log_dir`` (one file a rank and a
    call). Does nothing when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_rank{_rank()}_{int(time.time() * 1000)}.json"))


class _NoSpan:
    """The span while no profiler records: no range, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, key: str, n) -> None:
        pass


_NO_SPAN = _NoSpan()
_records: list = []          # the kept spans, in the order they opened
_dropped = 0                 # spans past MAX_SPANS
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()   # each host thread's stack of open spans


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One recorded span: a ``record_function`` range, host times from
    ``perf_counter_ns`` and, on a card, a CUDA event at each end on the
    stream current at its start."""

    __slots__ = ("name", "id", "parent", "root", "counts", "t0", "t1",
                 "events", "_stream", "_range", "_stack")

    def __init__(self, name: str, device):
        self._stack = _open_spans()
        self.name, self.id = name, next(_ids)
        self.parent = self._stack[-1].id if self._stack else None
        self.root = self._stack[0].id if self._stack else self.id
        self.counts: dict = {}
        self.t0 = self.t1 = None
        self.events = self._stream = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(torch.device(device))
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        global _dropped
        with _lock:
            if len(_records) < MAX_SPANS:
                _records.append(self)
            else:
                _dropped += 1
                self.events = None
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._stack.append(self)
        if self.events is not None:
            self.events[0].record(self._stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self._stream)
        self.t1 = time.perf_counter_ns()
        self._stack.pop()
        self._range.__exit__(*exc)
        return False

    def add(self, key: str, n) -> None:
        """Add ``n`` to this span's count ``key``."""
        self.counts[key] = self.counts.get(key, 0) + n


def span(name: str, *, device=None):
    """A context manager around one layer's work, recorded only while a
    ``torch.profiler`` profile records; otherwise one shared no-op object
    (no range, no event, no record). Recorded, it opens
    ``record_function(name)``, so it lies on the profiler's timeline
    beside the kernels, and keeps a record that :func:`spans` reads. Its
    parent is the innermost span open on this thread, its root the
    outermost (itself when none is open). ``device``: where the work runs;
    a CUDA device also gives the span a device time. ``add(key, n)`` on
    the object ``with`` yields attaches a count."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(name, device)


def spans() -> list:
    """The closed spans recorded (at most :data:`MAX_SPANS` since the last
    :func:`clear`), in the order they opened, as dicts: ``name``, ``id``,
    ``parent`` (an id, None for a root), ``root`` (an id), ``host_ms``,
    ``device_ms`` (between its CUDA events; None off a card) and
    ``counts``. Waits for the device to reach each span's end."""
    out = []
    with _lock:
        kept = list(_records)
    for s in kept:
        if s.t1 is None:
            continue
        device_ms = None
        if s.events is not None:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "id": s.id, "parent": s.parent,
                    "root": s.root, "host_ms": (s.t1 - s.t0) / 1e6,
                    "device_ms": device_ms, "counts": dict(s.counts)})
    return out


def dropped() -> int:
    """Spans not kept since the last :func:`clear`: opened past
    :data:`MAX_SPANS` records."""
    return _dropped


def clear() -> None:
    """Forget every span record and the count of dropped ones."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


class StepTimer:
    """Tracks per-step wall time and derived throughput."""

    def __init__(self, edges_per_step: int = 0):
        self.edges_per_step = edges_per_step
        self.times: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.times.append(time.time() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def edges_per_s(self) -> float:
        return self.edges_per_step / self.mean if self.mean else 0.0

    def summary(self) -> dict:
        return {"batch_time_mean_s": self.mean,
                "batches": len(self.times),
                "train_edges_per_s": self.edges_per_s}


class MetricsLogger:
    """Append-only JSONL metrics file (no-op when path is None).

    Under ``torch.distributed`` with more than one rank only rank 0 writes:
    every rank computes the same metrics (the eval is replicated), so one
    writer keeps the file free of repeated and interleaved lines. Every
    other rank gets a no-op logger."""

    def __init__(self, path: str | None):
        if path and _rank() != 0:
            path = None
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, **fields):
        if self._fh is None:
            return
        fields.setdefault("ts", time.time())
        self._fh.write(json.dumps(fields) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
