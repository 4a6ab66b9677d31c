"""Pipeline-occupancy profiler: per-shard device idle-gap (bubble)
attribution and flush critical-path timelines. The port's own copy of
the JAX package's ``utils/pipeline_profiler.py``: the same API, families,
labels, env knobs and summary, plus :func:`note_compile_begin` and
:func:`note_compile_wall` for the compile service's captures (below).

Three instruments, one module:

* **Per-shard busy/idle interval tracking.** Every staged dispatch
  (``crypto/device/bls._run_stage``, dispatch to the caller's stream
  sync) reports a busy interval on its mesh shard; the gap between a
  shard's sync-complete and its next dispatch is a BUBBLE, attributed to
  its cause by overlap with the recorded host-activity timeline:
  ``pack`` (the host was packing), ``plan`` (the flush planner was
  deciding), ``compile`` (a graph capture was in flight, or the flush
  was shed to the CPU fallback while its rung is captured),
  ``queue_empty`` (the flush thread was waiting on an empty queue: no
  work existed), ``other`` (the uncovered remainder). Lands in
  ``bls_device_bubble_seconds_total{shard,cause}`` (per-cause seconds
  sum exactly to the measured idle) and
  ``bls_device_shard_busy_seconds_total{shard}``.
* **Flush lifecycle timelines.** The scheduler wraps each flush in a
  :class:`FlushRecord`: submit, queue-wait, plan, pack (the packers'
  phase clocks feed the same wall), dispatch, device-wait, resolve. One
  ``pipeline_flush`` flight-recorder event per flush (bisection and shed
  sub-batches included: exactly once) carries the per-phase seconds and
  the critical-path phase; a flush-thread saturation gauge
  (``verification_scheduler_flush_thread_saturation``) says what
  fraction of the flush wall went to host pack vs waiting on the device.
* **Overlap-potential estimate.** Per flush, the projected wall if pack
  for flush N+1 overlapped flush N's device time is the busiest dispatch
  LANE's ``max(pack, device) + fallback`` plus the serial remainder,
  against the measured wall (per lane, because concurrent mesh workers
  already overlap each other). Cumulative projected sets/s and the
  speedup ratio are served in :func:`summary` and
  ``verification_scheduler_overlap_potential_ratio``.

What "busy" means on the card. A busy interval is ``_run_stage``'s host
wall from dispatch to the caller's stream sync. In the port that wall
covers the copy into the graph's static inputs, the wait for the graph's
replay lock, the replay and the clone of its outputs: it is not the
card's kernel time, and a bubble is not the card's idle share as
``torch.profiler`` reads it. Two shards on one card have busy intervals
that overlap on one device; each shard's timeline is kept on its own.

Captures. The JAX compile service's warm-up dispatches a rung's stages;
the port's warm-up (``compile_service/lowering.py``) runs an eager
warm-up, a capture and a check replay, which occupy the card for
seconds. A warm-up is recorded as ``compile`` activity, opened when it
starts (:func:`note_compile_begin`, so a traffic gap that closes while
the capture still runs sees it, as an empty-queue wait is opened early)
and closed when it ends (:func:`note_compile_wall`); never as a busy
interval, so ``bls_device_shard_busy_seconds_total`` counts traffic only
and a traffic gap beside a capture attributes to ``compile``. Both hooks
are the port's additions. A cold rung captured on a verifying thread
stays a busy interval and ``compile`` activity (``fresh=True`` in
:func:`note_stage_wall`).

No torch import; thread-safe (mesh shard workers, ``verify_now`` callers
and the flush thread all record concurrently); with the profiler
disabled (``LIGHTHOUSE_TPU_PIPELINE_PROFILER=0``) every hook returns
after one global check.

Attribution contract: a gap's per-cause seconds are EXACT interval
arithmetic: overlapping host activities are assigned in priority order
(pack > plan > compile > queue_empty) over the still-uncovered
sub-intervals, so no second is double-counted and the cause split
always sums to the gap. The activity timeline is a bounded ring
(default 4096 intervals, ``LIGHTHOUSE_TPU_PIPELINE_ACTIVITY``); an idle
period nothing recorded an activity for attributes to ``other``: the
profiler never fabricates a cause.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import flight_recorder, metrics, slot_ledger

# flush lifecycle phases, in timeline order
FLUSH_PHASES = ("queue_wait", "plan", "pack", "device", "fallback", "resolve")
# bubble causes; attribution priority is the order below minus "other"
BUBBLE_CAUSES = ("pack", "plan", "compile", "queue_empty", "other")
_PRIORITY = ("pack", "plan", "compile", "queue_empty")

# ---------------------------------------------------------------------------
# Metric families
# ---------------------------------------------------------------------------

_BUBBLE_SECONDS = metrics.counter_vec(
    "bls_device_bubble_seconds_total",
    "device idle-gap (bubble) seconds per mesh shard, attributed to "
    "cause by overlap with the recorded host-activity timeline: pack "
    "(host was packing), plan (flush planner deciding), compile (a graph "
    "capture in flight / flush shed to the CPU fallback while its rung "
    "is captured), queue_empty (flush thread waiting on an empty queue), "
    "other (uncovered remainder); per-cause seconds sum exactly to "
    "measured idle",
    ("shard", "cause"),
)
_BUSY_SECONDS = metrics.counter_vec(
    "bls_device_shard_busy_seconds_total",
    "device busy seconds per mesh shard (staged dispatch-to-sync walls "
    "on the host clock, overlap-clipped so concurrent dispatches on one "
    "shard are not double-counted); bubble_ratio = bubble / (busy + "
    "bubble)",
    ("shard",),
)
_FLUSH_PHASE_SECONDS = metrics.counter_vec(
    "verification_scheduler_flush_phase_seconds_total",
    "cumulative flush-lifecycle seconds by phase: queue_wait (oldest "
    "submission's wait before drain), plan (flush planner), pack (host "
    "pack inside the flush), device (staged dispatch-to-sync), "
    "fallback (CPU fallback verifies of shed sub-batches), resolve "
    "(flush wall not covered by the other phases: future delivery, "
    "bookkeeping). Summed phase seconds can exceed summed flush walls "
    "when mesh shard workers pack/dispatch concurrently",
    ("phase",),
)
_SATURATION = metrics.gauge(
    "verification_scheduler_flush_thread_saturation",
    "host-pack share of the most recent flush's active wall: pack / "
    "(pack + device + fallback). 1.0 = the flush thread spent its "
    "whole active time packing (the device starved behind the host); "
    "0.0 = all waiting on the device (pack is free)",
)
_OVERLAP_RATIO = metrics.gauge(
    "verification_scheduler_overlap_potential_ratio",
    "projected speedup if host pack for flush N+1 overlapped flush N's "
    "device time (cumulative measured flush wall / projected "
    "overlapped wall, >= 1.0)",
)


# ---------------------------------------------------------------------------
# Enable / configure
# ---------------------------------------------------------------------------

# one env-parsing convention across the observability knobs
_env_int = flight_recorder._env_int
_env_float = flight_recorder._env_float

_enabled = os.environ.get(
    "LIGHTHOUSE_TPU_PIPELINE_PROFILER", "1"
) not in ("", "0")
_max_activity = max(16, _env_int("LIGHTHOUSE_TPU_PIPELINE_ACTIVITY", 4096))
# activity intervals older than this never explain a live gap (gaps end
# "now"); pruned on append so a long-lived node's ring stays relevant
_activity_retention_s = _env_float(
    "LIGHTHOUSE_TPU_PIPELINE_RETENTION_S", 300.0
)


def enabled() -> bool:
    return _enabled


def configure(
    enabled: Optional[bool] = None,
    max_activity: Optional[int] = None,
    retention_s: Optional[float] = None,
) -> dict:
    """Override knobs at runtime; returns the PREVIOUS values so tests
    can restore them (flight_recorder.configure's contract)."""
    global _enabled, _max_activity, _activity_retention_s, _activity
    prev = {
        "enabled": _enabled,
        "max_activity": _max_activity,
        "retention_s": _activity_retention_s,
    }
    if enabled is not None:
        _enabled = bool(enabled)
    if max_activity is not None and int(max_activity) != _max_activity:
        _max_activity = max(16, int(max_activity))
        with _lock:
            _activity = deque(_activity, maxlen=_max_activity)
    if retention_s is not None:
        _activity_retention_s = float(retention_s)
    return prev


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


class _ShardState:
    __slots__ = (
        "last_sync", "busy_s", "idle_s", "dispatches", "gaps",
        "causes", "cause_counts",
    )

    def __init__(self):
        self.last_sync: Optional[float] = None
        self.busy_s = 0.0
        self.idle_s = 0.0
        self.dispatches = 0
        self.gaps = 0
        self.causes: Dict[str, float] = {}
        self.cause_counts: Dict[str, int] = {}


def _fresh_totals() -> dict:
    return {
        "flushes": 0,
        "sets": 0,
        "wall_s": 0.0,
        "projected_wall_s": 0.0,
        **{f"{p}_s": 0.0 for p in FLUSH_PHASES},
    }


_lock = threading.Lock()
_activity: deque = deque(maxlen=_max_activity)  # (cause, t0, t1)
# still-open empty-queue waits by flush-thread id: a verify_now gap
# closing while the flush thread is STILL parked must attribute to
# queue_empty, not wait for the interval to complete at wake
_open_idle: Dict[int, float] = {}
# still-open compile-service warm-ups by thread id (note_compile_begin):
# a gap closing while a capture still runs attributes to compile
_open_compile: Dict[int, float] = {}
_shards: Dict[int, _ShardState] = {}
_totals = _fresh_totals()

_tls = threading.local()


def reset() -> None:
    """Drop every recorded interval, gap and flush total (knobs keep
    their values)."""
    global _totals
    with _lock:
        _activity.clear()
        _open_idle.clear()
        _open_compile.clear()
        _shards.clear()
        _totals = _fresh_totals()


# ---------------------------------------------------------------------------
# Interval arithmetic (pure helpers; exact, no double counting)
# ---------------------------------------------------------------------------


def _merge(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    ivs = sorted(ivs)
    out: List[Tuple[float, float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _attribute_gap(
    g0: float, g1: float, activity: List[Tuple[str, float, float]]
) -> Dict[str, float]:
    """Split the gap [g0, g1) across BUBBLE_CAUSES: each priority cause
    claims its recorded activity's overlap with the still-uncovered
    sub-intervals; the remainder is ``other``. The returned seconds sum
    to exactly ``g1 - g0``."""
    per_cause: Dict[str, List[Tuple[float, float]]] = {
        c: [] for c in _PRIORITY
    }
    for cause, a0, a1 in activity:
        if a1 <= g0 or a0 >= g1:
            continue
        per_cause[cause].append((max(a0, g0), min(a1, g1)))
    remaining = [(g0, g1)]
    out: Dict[str, float] = {}
    for cause in _PRIORITY:
        ivs = _merge(per_cause[cause])
        if not ivs:
            continue
        got = 0.0
        new_remaining: List[Tuple[float, float]] = []
        for rs, re_ in remaining:
            cur = rs
            for s, e in ivs:
                if e <= cur or s >= re_:
                    continue
                s2, e2 = max(s, cur), min(e, re_)
                if s2 > cur:
                    new_remaining.append((cur, s2))
                got += e2 - s2
                cur = e2
            if cur < re_:
                new_remaining.append((cur, re_))
        remaining = new_remaining
        if got > 0.0:
            out[cause] = got
    rest = sum(e - s for s, e in remaining)
    if rest > 0.0:
        out["other"] = rest
    return out


def _note_activity_locked(cause: str, t0: float, t1: float) -> None:
    _activity.append((cause, t0, t1))
    cutoff = t1 - _activity_retention_s
    while _activity and _activity[0][2] < cutoff:
        _activity.popleft()


# ---------------------------------------------------------------------------
# Flush lifecycle records
# ---------------------------------------------------------------------------


class FlushRecord:
    """One flush's lifecycle aggregate: phase seconds accumulate from
    the flush thread AND its mesh sub-batch workers (the scheduler enters
    :func:`flush_scope` on each); :func:`flush_end` closes the record,
    journals ONE ``pipeline_flush`` event and feeds the gauges."""

    __slots__ = (
        "trigger", "kinds", "n_submissions", "n_sets", "queue_wait_s",
        "t0", "phases", "shards", "by_thread", "_lock",
    )

    def __init__(self, trigger: str, kinds: str, n_submissions: int,
                 n_sets: int, queue_wait_s: float):
        self.trigger = trigger
        self.kinds = kinds
        self.n_submissions = int(n_submissions)
        self.n_sets = int(n_sets)
        self.queue_wait_s = max(0.0, float(queue_wait_s))
        self.t0 = time.perf_counter()
        self.phases = {"plan": 0.0, "pack": 0.0, "device": 0.0,
                       "fallback": 0.0}
        self.shards: set = set()
        # per-dispatching-thread (pack, device, fallback) walls: mesh
        # sub-batch workers run CONCURRENTLY, so the overlap projection
        # reasons about the busiest LANE, not phase sums (summed device
        # seconds across two shards exceed the wall)
        self.by_thread: Dict[int, Dict[str, float]] = {}
        self._lock = threading.Lock()

    def add(self, phase: str, seconds: float,
            shard: Optional[int] = None) -> None:
        with self._lock:
            self.phases[phase] = self.phases.get(phase, 0.0) + seconds
            if shard is not None:
                self.shards.add(int(shard))
            if phase in ("pack", "device", "fallback"):
                lane = self.by_thread.setdefault(
                    threading.get_ident(),
                    {"pack": 0.0, "device": 0.0, "fallback": 0.0},
                )
                lane[phase] += seconds


class _NoopScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopScope()


class _FlushScope:
    """Thread-local current-flush frame: hooks fired on this thread
    (pack walls, stage walls, fallback walls) attribute to the record
    without plumbing a handle through the backend."""

    __slots__ = ("record", "_prev")

    def __init__(self, record: FlushRecord):
        self.record = record

    def __enter__(self):
        self._prev = getattr(_tls, "flush", None)
        _tls.flush = self.record
        return self

    def __exit__(self, *exc):
        _tls.flush = self._prev
        return False


def flush_scope(record: Optional[FlushRecord]):
    """Scope this thread's profiler hooks to ``record`` (the scheduler
    enters it on the flush thread, on every mesh sub-batch worker and on
    the watchdog's thread); None (profiler disabled) is a shared
    no-op."""
    if record is None:
        return _NOOP
    return _FlushScope(record)


def current_flush() -> Optional[FlushRecord]:
    return getattr(_tls, "flush", None)


def flush_begin(
    trigger: str, kinds: str, n_submissions: int, n_sets: int,
    queue_wait_s: float,
) -> Optional[FlushRecord]:
    """Open one flush's lifecycle record (None when disabled: every
    later hook and :func:`flush_end` then no-op for free)."""
    if not _enabled:
        return None
    return FlushRecord(trigger, kinds, n_submissions, n_sets, queue_wait_s)


def flush_end(
    record: Optional[FlushRecord],
    verdict: Optional[bool] = None,
    mode: Optional[str] = None,
    n_sub_batches: int = 0,
    dp_shards=(),
) -> Optional[dict]:
    """Close the record: derive the residual ``resolve`` phase and the
    critical path, project the overlapped wall, update the cumulative
    totals + gauges, and journal ONE ``pipeline_flush`` event. Returns
    the journaled row."""
    if record is None or not _enabled:
        return None
    wall = max(0.0, time.perf_counter() - record.t0)
    with record._lock:
        phases = dict(record.phases)
        shards = sorted(record.shards)
        lanes = [dict(v) for v in record.by_thread.values()]
    plan_s = phases.get("plan", 0.0)
    pack_s = phases.get("pack", 0.0)
    device_s = phases.get("device", 0.0)
    fallback_s = phases.get("fallback", 0.0)
    # residual: the flush wall no phase explains (future delivery,
    # bookkeeping, thread handoff). Concurrent mesh workers can make the
    # phase sum exceed the wall: the residual floors at 0 (phase seconds
    # stay the truth; the wall is the wall)
    resolve_s = max(
        0.0, wall - plan_s - pack_s - device_s - fallback_s
    )
    # overlap projection per LANE (dispatching thread): pack for flush
    # N+1 over flush N's device time hides the smaller of the lane's
    # (pack, device) behind the larger; concurrent lanes already
    # overlap each other, so the projection reasons about the busiest
    # lane. Clamped to the wall: concurrency already achieved cannot be
    # re-claimed as potential.
    if lanes:
        busiest_serial = max(
            ln["pack"] + ln["device"] + ln["fallback"] for ln in lanes
        )
        busiest_overlapped = max(
            max(ln["pack"], ln["device"]) + ln["fallback"] for ln in lanes
        )
    else:
        busiest_serial = busiest_overlapped = 0.0
    lane_residual = max(0.0, wall - plan_s - busiest_serial)
    projected = min(
        wall, busiest_overlapped + plan_s + lane_residual
    )
    busy = pack_s + device_s + fallback_s
    saturation = (pack_s / busy) if busy > 0 else 0.0
    critical = max(
        (
            ("pack", pack_s), ("device", device_s),
            ("fallback", fallback_s), ("plan", plan_s),
            ("resolve", resolve_s),
        ),
        key=lambda kv: kv[1],
    )[0]
    phase_seconds = {
        "queue_wait": record.queue_wait_s,
        "plan": plan_s, "pack": pack_s, "device": device_s,
        "fallback": fallback_s, "resolve": resolve_s,
    }
    global _totals
    with _lock:
        _totals["flushes"] += 1
        _totals["sets"] += record.n_sets
        _totals["wall_s"] += wall
        _totals["projected_wall_s"] += projected
        for p, s in phase_seconds.items():
            _totals[f"{p}_s"] += s
        total_wall = _totals["wall_s"]
        total_projected = _totals["projected_wall_s"]
    for p, s in phase_seconds.items():
        if s > 0:
            _FLUSH_PHASE_SECONDS.with_labels(p).inc(s)
    _SATURATION.set(round(saturation, 4))
    _OVERLAP_RATIO.set(
        round(total_wall / total_projected, 4) if total_projected else 0.0
    )
    row = {
        "trigger": record.trigger,
        "kinds": record.kinds,
        "n_submissions": record.n_submissions,
        "n_sets": record.n_sets,
        "mode": mode,
        "n_sub_batches": int(n_sub_batches),
        "dp_shards": list(dp_shards) if dp_shards else shards,
        "queue_wait_s": round(record.queue_wait_s, 6),
        "plan_s": round(plan_s, 6),
        "pack_s": round(pack_s, 6),
        "device_s": round(device_s, 6),
        "fallback_s": round(fallback_s, 6),
        "resolve_s": round(resolve_s, 6),
        "wall_s": round(wall, 6),
        "critical_path": critical,
        "saturation": round(saturation, 4),
        "projected_wall_s": round(projected, 6),
        "overlap_speedup": round(wall / projected, 4) if projected else None,
        "verdict": verdict,
    }
    flight_recorder.record("pipeline_flush", **row)
    return row


# ---------------------------------------------------------------------------
# Hooks (the hot path; one global check when disabled)
# ---------------------------------------------------------------------------


def note_pack_wall(t0: float, t1: float) -> None:
    """One host pack completed on THIS thread (the packers in
    crypto/device/bls.py call this with their own perf_counter wall):
    host-activity interval for bubble attribution + the current flush
    record's ``pack`` phase."""
    if not _enabled or t1 <= t0:
        return
    rec = getattr(_tls, "flush", None)
    if rec is not None:
        rec.add("pack", t1 - t0)
    with _lock:
        _note_activity_locked("pack", t0, t1)


def note_plan_wall(
    t0: float, t1: float, record: Optional[FlushRecord] = None
) -> None:
    """The flush planner's decision wall (scheduler flush thread).
    ``record`` attributes the phase explicitly: the scheduler plans
    BEFORE entering the dispatch scope; hooks fired inside the scope
    fall back to the thread-local record."""
    if not _enabled or t1 <= t0:
        return
    rec = record if record is not None else getattr(_tls, "flush", None)
    if rec is not None:
        rec.add("plan", t1 - t0)
    with _lock:
        _note_activity_locked("plan", t0, t1)


def note_fallback_wall(t0: float, t1: float) -> None:
    """One CPU fallback verify completed (the compile service: the flush
    was shed because its rung is cold): the device idled for a
    capture-caused reason, so the activity lands under ``compile``."""
    if not _enabled or t1 <= t0:
        return
    rec = getattr(_tls, "flush", None)
    if rec is not None:
        rec.add("fallback", t1 - t0)
    with _lock:
        _note_activity_locked("compile", t0, t1)


def note_compile_begin(t0: float) -> None:
    """This thread STARTS a compile-service warm-up (eager warm-up,
    capture and check replay of a rung's stage graphs): mark it open, so
    a gap closing on any shard while it runs attributes to ``compile``.
    The port's addition (the module docstring says why)."""
    if not _enabled:
        return
    with _lock:
        _open_compile[threading.get_ident()] = t0


def note_compile_wall(t0: float, t1: float) -> None:
    """The warm-up this thread opened with :func:`note_compile_begin`
    ended: close the marker and record the completed ``compile``
    activity interval. No busy interval on any shard: a warm-up is not
    traffic. The port's addition."""
    if not _enabled:
        # marker cleared even when disabled (a knob flip mid-warm-up)
        if _open_compile:
            with _lock:
                _open_compile.pop(threading.get_ident(), None)
        return
    with _lock:
        _open_compile.pop(threading.get_ident(), None)
        if t1 > t0:
            _note_activity_locked("compile", t0, t1)


def note_idle_begin(t0: float) -> None:
    """The scheduler's flush thread is ENTERING an empty-queue wait:
    mark the interval open NOW, so a ``verify_now`` dispatch landing
    while the thread is still parked attributes its gap to
    ``queue_empty`` instead of ``other`` (the completed interval only
    reaches the ring at wake, too late for gaps that close mid-wait)."""
    if not _enabled:
        return
    with _lock:
        _open_idle[threading.get_ident()] = t0


def note_idle_end(t0: float, t1: float) -> None:
    """The empty-queue wait ended: close the open marker and record the
    completed ``queue_empty`` activity interval (no work existed: a
    device gap overlapping it is traffic's fault, not the pipeline's)."""
    if not _enabled:
        # marker cleared even when disabled: a knob flip mid-wait must
        # not leave a stale open marker claiming queue_empty forever
        if _open_idle:
            with _lock:
                _open_idle.pop(threading.get_ident(), None)
        return
    # pop + record under ONE lock hold: a gap closing between the two
    # would see neither the open marker nor the completed interval and
    # misattribute the wait to `other`
    with _lock:
        _open_idle.pop(threading.get_ident(), None)
        if t1 > t0:
            _note_activity_locked("queue_empty", t0, t1)


def note_stage_wall(
    stage: str, shard, t0: float, t1: float, fresh: bool = False
) -> None:
    """One staged device dispatch synced (``bls._run_stage``): a busy
    interval on ``shard``. The gap since the shard's previous
    sync-complete is a BUBBLE, attributed by overlap with the
    host-activity timeline and landed in
    ``bls_device_bubble_seconds_total{shard,cause}``. ``fresh`` marks a
    first-shape dispatch whose wall includes a graph capture: the
    interval is also recorded as ``compile`` activity so OTHER shards'
    gaps behind it attribute honestly. Overlapping dispatches on one
    shard (verify_now racing a flush) are busy-clipped, never
    double-counted, and never produce a negative gap."""
    if not _enabled:
        return
    if t1 <= t0:
        return
    shard = int(shard) if shard is not None else 0
    rec = getattr(_tls, "flush", None)
    if rec is not None:
        rec.add("device", t1 - t0, shard=shard)
    gap_attr = None
    with _lock:
        if fresh:
            _note_activity_locked("compile", t0, t1)
        st = _shards.get(shard)
        if st is None:
            st = _shards[shard] = _ShardState()
        if st.last_sync is not None and t0 > st.last_sync:
            g0, g1 = st.last_sync, t0
            # scan the ring from the TAIL and stop at the first entry
            # ending before the gap: activities are appended at their
            # end time, so per-dispatch work is bounded by the
            # intervals near the gap, not the ring capacity. Thread
            # scheduling jitter can in rare cases hide an older
            # overlapping entry behind the break; its seconds then fall
            # to `other` (conservative; the split still sums exactly).
            overlapping: List[Tuple[str, float, float]] = []
            for entry in reversed(_activity):
                if entry[2] <= g0:
                    break
                overlapping.append(entry)
            # still-open empty-queue waits cover the gap's tail even
            # though their completed interval has not reached the ring
            # yet (they close at wake; this gap closes NOW)
            for start in _open_idle.values():
                if start < g1:
                    overlapping.append(("queue_empty", start, g1))
            # likewise a warm-up still capturing on the worker
            for start in _open_compile.values():
                if start < g1:
                    overlapping.append(("compile", start, g1))
            gap_attr = _attribute_gap(g0, g1, overlapping)
            st.idle_s += g1 - g0
            st.gaps += 1
            for cause, s in gap_attr.items():
                st.causes[cause] = st.causes.get(cause, 0.0) + s
                st.cause_counts[cause] = st.cause_counts.get(cause, 0) + 1
        busy0 = t0 if st.last_sync is None else max(t0, st.last_sync)
        busy = max(0.0, t1 - busy0)
        st.busy_s += busy
        st.dispatches += 1
        st.last_sync = t1 if st.last_sync is None else max(st.last_sync, t1)
    if busy > 0:
        _BUSY_SECONDS.with_labels(str(shard)).inc(busy)
    if gap_attr:
        for cause, s in gap_attr.items():
            _BUBBLE_SECONDS.with_labels(str(shard), cause).inc(s)
        # chain-time attribution: the bubble lands on the slot the gap
        # CLOSED in (the cause split stays in the counter family)
        slot_ledger.note_bubble(sum(gap_attr.values()))
    if fresh:
        slot_ledger.note_fresh_compile(stage)


# ---------------------------------------------------------------------------
# Reading (the `pipeline` document and bls.stage_latency_summary)
# ---------------------------------------------------------------------------


def shard_bubble_ratio(shard) -> Optional[float]:
    """idle / (busy + idle) for one shard; None before its first
    dispatch (no interval exists: never a fabricated 0.0)."""
    with _lock:
        st = _shards.get(int(shard) if shard is not None else 0)
        if st is None or (st.busy_s + st.idle_s) <= 0:
            return None
        return round(st.idle_s / (st.busy_s + st.idle_s), 4)


def bubble_rows() -> Dict[str, dict]:
    """Aggregated per-cause bubble rows across every shard: the
    ``bubble:<cause>`` rows ``bls.stage_latency_summary()`` reports
    next to the stage and pack splits."""
    with _lock:
        agg: Dict[str, List[float]] = {}
        for st in _shards.values():
            for cause, s in st.causes.items():
                rec = agg.setdefault(cause, [0.0, 0])
                rec[0] += s
                rec[1] += st.cause_counts.get(cause, 0)
    return {
        cause: {
            "sum_s": round(s, 6),
            "count": n,
            "mean_s": round(s / n, 6) if n else 0.0,
        }
        for cause, (s, n) in sorted(agg.items())
    }


def summary() -> dict:
    """One document: per-shard busy/idle/bubble attribution, cumulative
    flush-phase seconds, flush-thread saturation, and the
    overlap-potential projection."""
    with _lock:
        shards_doc = {}
        for i in sorted(_shards):
            st = _shards[i]
            span = st.busy_s + st.idle_s
            causes = {
                c: round(s, 6) for c, s in sorted(st.causes.items())
            }
            dominant = (
                max(st.causes.items(), key=lambda kv: kv[1])[0]
                if st.causes else None
            )
            shards_doc[str(i)] = {
                "dispatches": st.dispatches,
                "gaps": st.gaps,
                "busy_s": round(st.busy_s, 6),
                "idle_s": round(st.idle_s, 6),
                "bubble_ratio": (
                    round(st.idle_s / span, 4) if span > 0 else None
                ),
                "causes": causes,
                "dominant_cause": dominant,
            }
        totals = dict(_totals)
    flushes = totals["flushes"]
    wall = totals["wall_s"]
    projected = totals["projected_wall_s"]
    pack = totals["pack_s"]
    device = totals["device_s"]
    fallback = totals["fallback_s"]
    busy = pack + device + fallback
    return {
        "enabled": _enabled,
        "shards": shards_doc,
        "flushes": {
            "count": flushes,
            "sets": totals["sets"],
            "wall_s": round(wall, 6),
            **{
                f"{p}_s": round(totals[f"{p}_s"], 6)
                for p in FLUSH_PHASES
            },
        },
        # cumulative counterpart of the per-flush gauge: what fraction
        # of ALL flush active time went to host pack
        "flush_thread_saturation": (
            round(pack / busy, 4) if busy > 0 else None
        ),
        "overlap_potential": {
            "basis": (
                "projected wall per flush = busiest dispatch lane's "
                "max(pack, device) + fallback, plus plan and the "
                "residual (pack for flush N+1 overlapping flush N's "
                "device time hides the smaller of each lane's two "
                "walls; concurrent dp lanes already overlap each "
                "other); PROJECTED, not measured"
            ),
            "pack_s": round(pack, 6),
            "device_s": round(device, 6),
            "measured_wall_s": round(wall, 6),
            "projected_wall_s": round(projected, 6),
            "measured_sets_per_sec": (
                round(totals["sets"] / wall, 2) if wall > 0 else None
            ),
            "projected_sets_per_sec": (
                round(totals["sets"] / projected, 2)
                if projected > 0 else None
            ),
            "projected_speedup": (
                round(wall / projected, 4) if projected > 0 else None
            ),
        },
    }
