"""Profiles, step timing and the metrics stream (port of
``grandtpu/observe.py``).

- ``profile_trace``: ``torch.profiler`` around a block, host activity and,
  where a card is present, its kernels; a Chrome trace in ``log_dir``
  (open it in Perfetto or ``chrome://tracing``)
- ``StepTimer``: per-step host time and the top-k aggregation's edges/s
- ``MetricsLogger``: an append-only JSONL stream, one writer on a mesh over
  processes
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
import torch.distributed as tdist


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
