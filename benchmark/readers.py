"""The arithmetic behind the metric readers of ``benchmark/metrics/``.

Each function takes the run (``run.Run``) and returns a number, or None
when the run holds nothing to read (the harness then leaves the metric
out of its line). Percentiles are numpy's linear ones over every sample.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import Optional

import numpy as np

from . import devtrace, roofline


def _done(run):
    return [(run.units[run.window[k]], r) for k, r in enumerate(run.recs) if "verdict" in r]


def sets_per_s(run) -> Optional[float]:
    """Sets of the units that completed over the time from the first
    call to the last verdict."""
    done = _done(run)
    if not done:
        return None
    span = max(r["t1"] for _u, r in done) - min(r["t0"] for _u, r in done)
    return sum(len(u.sets) for u, _r in done) / span


def _rows(run, key: str, traced: bool = False):
    """Dispatch records holding ``key``: those wholly inside the traced
    slice, or (``traced`` False) those outside the time the profiler ran,
    from its start to the end of its stop, which it slows."""
    rows = run.dispatches
    tr = run.trace
    if traced:
        rows = [d for d in rows if d["t0"] >= tr.t0 and d["t1"] <= tr.t1]
    elif tr is not None:
        rows = [d for d in rows if d["t1"] <= tr.entered or d["t0"] >= tr.t1 + tr.stop_s]
    return [d for d in rows if key in d]


def mean_sets_per_dispatch(run) -> Optional[float]:
    rows = _rows(run, "n_sets")
    return float(np.mean([d["n_sets"] for d in rows])) if rows else None


def host_ms(run) -> Optional[float]:
    """Mean key-table resolve plus host pack per dispatch, ms."""
    rows = _rows(run, "pack_s")
    return float(np.mean([(d["resolve_s"] + d["pack_s"]) * 1e3 for d in rows])) if rows else None


def stage_ms(run) -> Optional[float]:
    """Mean stage 1 + 2 + 3 seconds per dispatch (dispatch to stream
    sync), ms."""
    rows = _rows(run, "stages_s")
    return float(np.mean([d["stages_s"] * 1e3 for d in rows])) if rows else None


def pad_waste_pct(run) -> Optional[float]:
    """Padded lanes no set asked for, over all padded lanes of the
    window's dispatches (each dispatch's B*K*M)."""
    rows = [d for d in _rows(run, "waste") if d["waste"] is not None]
    if not rows:
        return None
    padded = np.array([d["rung"][0] * d["rung"][1] * d["rung"][2] for d in rows], float)
    waste = np.array([d["waste"] for d in rows])
    return float((waste * padded).sum() / padded.sum() * 100)


def glue_ms(run) -> Optional[float]:
    """Device time of every kernel but K1-K3 that ran inside a dispatch
    lying wholly in the traced slice, per such dispatch, ms. A dispatch
    syncs its stream before it returns, so its kernels run between its
    call and its return."""
    if run.trace is None:
        return None
    rows = _rows(run, "n_sets", traced=True)
    if not rows:
        return None
    marks = [name for name, _b, _m in roofline.KERNELS.values()]
    spans = sorted((d["t0"], d["t1"]) for d in rows)
    total = 0.0
    for s, e, name in run.trace.kernels:
        if any(m in name for m in marks):
            continue
        k = bisect.bisect_right(spans, (s, float("inf"))) - 1
        if k >= 0 and e <= spans[k][1]:
            total += e - s
    return total / len(rows) * 1e3 if total > 0 else None


def kernel_roofline_pct(run, kernel: str) -> Optional[float]:
    """The kernel's least time (the launches counted in the traced slice,
    ``roofline.bound_s``) over its device time there."""
    if run.trace is None or "c1" not in run.traced:
        return None
    h1 = run.traced["c1"]["kernels"][kernel][2]
    h0 = run.traced["c0"]["kernels"][kernel][2]
    hist = Counter(h1)
    hist.subtract(h0)
    least = roofline.least_seconds(kernel, {n: c for n, c in hist.items() if c > 0})
    took = devtrace.kernel_seconds(run.trace, roofline.KERNELS[kernel][0])
    if not took or least <= 0:
        return None
    return least / took * 100


def idle_pct(run) -> Optional[float]:
    """The share of the traced slice in which no kernel ran."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1 - run.trace.busy_s() / run.trace.window_s) * 100
