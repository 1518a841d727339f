"""The traced part of a ``--trace 1`` window, read from ``torch.profiler``.

The benchmark opens its own host ranges (``torch.profiler.record_function``:
request, update, embed, propagate, classify) around its calls into the
port. From the trace it takes the device's operations (kernels, copies,
fills: one stream), their union as the busy time, and the gaps between
them, named by the innermost host range open at the gap's middle.
"""

from __future__ import annotations

import time

import torch

# the benchmark's own host ranges, by which idle gaps are named
RANGES = ("request", "update", "embed", "propagate", "classify")


class Window:
    """One traced stretch: :meth:`start`, the work, :meth:`stop`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.wall_s = 0.0
        self.ops: list = []        # (name, start_us, end_us) on the device
        self.host: list = []       # (name, start_us, end_us) host ranges

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.events():
            span = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == cuda:
                if not getattr(e, "is_user_annotation", False):
                    self.ops.append(span)
            elif e.name in RANGES:
                self.host.append(span)
        self.prof = None

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        busy, end = 0.0, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s >= end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e6

    def gaps(self) -> list:
        """[(start_us, end_us)] of the device's idle gaps between its first
        and last operation."""
        out, end = [], None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the host range open in their middle (innermost), in
        seconds, at most ``top`` of each."""
        ops: dict = {}
        for name, s, e in self.ops:
            key = _short(name)
            ops[key] = ops.get(key, 0.0) + (e - s) / 1e6
        idle: dict = {}
        for s, e in self.gaps():
            mid = (s + e) / 2
            open_ = [h for h in self.host if h[1] <= mid <= h[2]]
            name = (min(open_, key=lambda h: h[2] - h[1])[0] if open_
                    else "outside the benchmark's ranges")
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
        rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").split("(")[0]
    return name.split("<")[0].split("::")[-1].strip()[:80] or name[:80]

