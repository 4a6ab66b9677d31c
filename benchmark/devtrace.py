"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
slice of the window, read into kernel intervals on the host's clock.

What the readers take from it (:class:`Trace`): each kernel's device
seconds by name, the busy seconds (the union of kernel intervals), the
length of the traced slice, and the idle gaps between kernels, each named
by what the host was doing then (from the benchmark's own record of
device dispatches, :class:`benchmark.stack.Dispatches`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

MARK = "benchmark.trace_start"


def _ns(e, what: str) -> float:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(e, f"{what}_us")()) * 1e3


class Trace:
    """Start with :meth:`start`, end with :meth:`stop`; then :attr:`kernels`
    holds (start_s, end_s, name) on the host's ``perf_counter`` clock."""

    def __init__(self):
        self.prof = None
        self.entered = self.t0 = self.t1 = 0.0
        self.kernels: List[Tuple[float, float, str]] = []
        self.n_events = 0
        self.stop_s = self.read_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        # the profiler slows the host from here on (its start takes
        # seconds): readers of host times take what ended before it
        self.entered = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        # one host annotation ties the profiler's clock to perf_counter
        with record_function(MARK):
            self.t0 = time.perf_counter()
        torch.cuda.current_stream().synchronize()

    def stop(self) -> None:
        """End the slice (the profiler stops; its events are read later,
        outside the window, by :meth:`read`)."""
        import torch

        torch.cuda.current_stream().synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - self.t1

    def read(self) -> None:
        t = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        self.n_events = len(events)
        mark = None
        raw = []
        for e in events:
            name = e.name()
            if name == MARK:
                mark = _ns(e, "start")
            elif "cuda" in str(e.device_type()).lower():
                start = _ns(e, "start")
                raw.append((start, start + _ns(e, "duration"), name))
        if mark is None:
            raise RuntimeError("the profiler lost the benchmark's start mark")
        off = self.t0 - mark * 1e-9
        self.kernels = sorted((s * 1e-9 + off, t_ * 1e-9 + off, n) for s, t_, n in raw)
        self.prof = None
        self.read_s = time.perf_counter() - t

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e, _ in self.kernels:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for s, e, n in self.kernels:
            out[n] += e - s
        return dict(out)

    def idle_gaps(self) -> List[Tuple[float, float]]:
        busy = self.busy_intervals()
        gaps, t = [], self.t0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps


def host_activity(t: float, dispatches) -> str:
    """What the host was doing at ``t`` (perf_counter), from the dispatch
    records: inside a device dispatch's key-table resolve, its host pack,
    the rest of the dispatch (stage boundaries, the eager gather, the
    verdict read), or no dispatch in flight (the scheduler's queue, the
    load generator)."""
    for d in dispatches:
        if d["t0"] <= t <= d["t1"]:
            if t < d["t0"] + d.get("resolve_s", 0.0):
                return "host key-table resolve"
            if t < d["t0"] + d.get("resolve_s", 0.0) + d.get("pack_s", 0.0):
                return "host pack"
            return "inside a dispatch, between stages"
    return "no dispatch in flight"


def breakdown(trace: Trace, dispatches) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the host was doing."""
    ops = sorted(trace.seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
    return {
        "device_ops": [[name, s] for name, s in ops],
        "idle_gaps": [[host_activity((a + b) / 2, dispatches), b - a] for a, b in gaps],
    }


def kernel_seconds(trace: Optional[Trace], marker: str) -> Optional[float]:
    """Device seconds of the kernels whose name holds ``marker``."""
    if trace is None:
        return None
    s = sum(v for n, v in trace.seconds_by_name().items() if marker in n)
    return s if s > 0 else None
