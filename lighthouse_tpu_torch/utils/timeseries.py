"""On-node metrics history: bounded time-series rings, a background
sampler over a declared family allowlist, and the capacity/headroom
estimator. The port's own copy of the JAX package's
``utils/timeseries.py``: the same API, env knobs, rings and estimator,
with the allowlist limited to the families the port registers and the
estimator's lazy reads pointed at the port's profiler and mesh.

The other observability surfaces (the SLO window, the transfer ledger,
the pipeline profiler) are instantaneous snapshots; this module is the
time axis ("how close to saturation are we, and is it getting worse?"),
the signal the bulk class's admission valve reads:

* **Bounded per-series rings with downsampling tiers.** Every sample of
  a series lands in the ``raw`` ring; completed time buckets fold into
  the ``1m`` and ``10m`` tiers as ``(t, min, max, mean, count)`` points,
  so an operator can read an hour at sample resolution and a day at
  10-minute resolution from a store whose memory is STRICTLY bounded:
  ring capacities are fixed (old points overwritten, never reallocated)
  and the series count is capped (``max_series``; overflow series are
  counted, not stored). Retention at the defaults (10 s sampling):
  ``raw`` 360 points = 1 h, ``1m`` 180 points = 3 h, ``10m`` 144 points
  = 24 h.
* **A declared sampler allowlist** (:data:`SAMPLE_FAMILIES`): the
  background sampler snapshots EXISTING registry families (scheduler
  occupancy/queue depth, per-kind arrival and verdict rates, per-shard
  sets/s and bubble ratio, deadline misses, device memory, H2D bytes)
  into ``capacity_*`` series. Counter families become per-second RATES
  (delta / dt against the previous sample); gauges are stored as read.
  An undeclared series cannot appear.
* **The capacity/headroom estimator** (:func:`estimate_capacity`):
  measured serving cost per signature set (preference order: per-shard
  dispatch walls from the mesh families over sampling-interval deltas,
  then the compile service's organic rung-cost feed, then the pipeline
  profiler's flush walls; the source is always reported, never
  fabricated) x the healthy-shard count gives
  ``capacity_estimated_sets_per_sec``; held against the measured arrival
  rate it gives ``capacity_utilization`` and ``capacity_headroom_ratio``
  (``headroom = max(0, 1 - arrival/capacity)``), which the bulk
  admission valve (``verification_service/admission.py``) reads.

Design constraints (the house observability discipline):

* no torch import.
* DISABLED sampling costs one global check per :func:`sample` call, no
  allocation.
* Enabled :meth:`TimeseriesStore.record` is O(1) amortized: ring
  appends + bucket accumulation under one lock; readers snapshot under
  the same lock, so a reader never observes a torn point.

Env knobs (read at import; :func:`configure` overrides at runtime):

    LIGHTHOUSE_TPU_TIMESERIES        1|0   sampling enabled (default 1)
    LIGHTHOUSE_TPU_TS_INTERVAL_S     float sampler period (default 10)
    LIGHTHOUSE_TPU_TS_RAW_POINTS     int   raw ring capacity (default 360)
    LIGHTHOUSE_TPU_TS_1M_POINTS     int   1m ring capacity (default 180)
    LIGHTHOUSE_TPU_TS_10M_POINTS    int   10m ring capacity (default 144)
    LIGHTHOUSE_TPU_TS_MAX_SERIES     int   series cap (default 256)
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import flight_recorder, metrics, slot_ledger

SCHEMA = "lighthouse_tpu.timeseries/1"

# downsampling tiers: (name, bucket seconds); "raw" stores every sample
TIERS = (("raw", 0.0), ("1m", 60.0), ("10m", 600.0))
TIER_NAMES = tuple(name for name, _ in TIERS)

# one env-parsing convention across the observability knobs
_env_int = flight_recorder._env_int
_env_float = flight_recorder._env_float

# ---------------------------------------------------------------------------
# Sampler allowlist: every series family the background sampler may
# produce, sorted, snake_case, capacity_-prefixed (plus the two slot_
# series of the slot ledger). The JAX package's list, each source a
# family the port registers.
#
# mode:
#   gauge   - store the source gauge's value as read
#   rate    - store (cum - prev_cum) / dt of the source counter family
#   ratio   - bubble/(bubble+busy) over the sampling interval's deltas
#   derived - produced by the capacity estimator, not read from a source
# label: the source label NAME each series is split by (children whose
# other labels differ are summed under it); None = sum every child (or
# the source is unlabelled).
# ---------------------------------------------------------------------------


class FamilySpec:
    __slots__ = ("family", "mode", "source", "label")

    def __init__(self, family: str, mode: str, source: Optional[str],
                 label: Optional[str]):
        self.family = family
        self.mode = mode
        self.source = source
        self.label = label


SAMPLE_FAMILIES: Tuple[FamilySpec, ...] = (
    FamilySpec("capacity_arrival_sets_per_sec", "rate",
               "verification_scheduler_arrival_sets_total", "kind"),
    # bulk QoS class: queue depth + served rate + the admission throttle
    # state (bulk sheds FIRST as headroom vanishes; gossip's series stay
    # flat)
    FamilySpec("capacity_bulk_queue_depth", "gauge",
               "verification_scheduler_bulk_queue_depth", None),
    FamilySpec("capacity_bulk_sets_per_sec", "rate",
               "verification_scheduler_bulk_sets_total", "kind"),
    FamilySpec("capacity_bulk_throttled", "gauge",
               "verification_scheduler_bulk_throttled", None),
    FamilySpec("capacity_deadline_miss_per_sec", "rate",
               "verification_scheduler_deadline_misses_total", "kind"),
    FamilySpec("capacity_device_memory_bytes", "gauge",
               "device_memory_bytes", "kind"),
    FamilySpec("capacity_dp_shards", "gauge",
               "verification_scheduler_dp_shards", None),
    FamilySpec("capacity_estimated_sets_per_sec", "derived", None, None),
    FamilySpec("capacity_h2d_bytes_per_sec", "rate",
               "bls_device_h2d_bytes_total", None),
    FamilySpec("capacity_headroom_ratio", "derived", None, None),
    FamilySpec("capacity_occupancy_ratio", "gauge",
               "verification_scheduler_batch_occupancy_ratio", None),
    # the key-table reupload ratio, the recompile (capture) rate and the
    # SLO burn rate as HISTORY (the live gauges alone have no time axis)
    FamilySpec("capacity_pubkey_reupload_ratio", "gauge",
               "bls_device_pubkey_reupload_ratio", "kind"),
    FamilySpec("capacity_queue_depth", "gauge",
               "verification_scheduler_queue_depth", None),
    FamilySpec("capacity_recompiles_per_sec", "rate",
               "bls_device_recompiles_total", None),
    FamilySpec("capacity_shard_bubble_ratio", "ratio",
               "bls_device_bubble_seconds_total", "shard"),
    FamilySpec("capacity_shard_sets_per_sec", "rate",
               "bls_device_shard_sets_total", "shard"),
    FamilySpec("capacity_slo_burn_rate", "gauge",
               "verification_scheduler_slo_burn_rate", "kind"),
    FamilySpec("capacity_utilization", "derived", None, None),
    # sets_total, NOT submissions_total: a backfill submission carries
    # 48-128 sets, so a per-submission rate would read ~100x under the
    # true serving rate and its units would not match the arrival
    # series it is held against
    FamilySpec("capacity_verdict_sets_per_sec", "rate",
               "verification_scheduler_sets_total", "kind"),
    # chain-time slot ledger: the per-epoch first-sighting hit ratio as
    # history, plus the ledger's own event throughput
    FamilySpec("slot_first_sighting_hit_ratio", "gauge",
               "key_table_first_sighting_hit_ratio", "epoch"),
    FamilySpec("slot_ledger_events_per_sec", "rate",
               "slot_ledger_events_total", "event"),
)

# ---------------------------------------------------------------------------
# Metric families (the estimator's live gauges + the sampler's own
# accounting)
# ---------------------------------------------------------------------------

_EST_CAPACITY = metrics.gauge(
    "capacity_estimated_sets_per_sec",
    "estimated serving capacity of the node in signature sets/s: "
    "healthy mesh shards x 1 / measured cost-per-set (cost preference "
    "order: per-shard dispatch walls -> compile-service organic rung "
    "cost -> pipeline flush walls). 0 until a cost has been measured: "
    "never fabricated",
)
_UTILIZATION = metrics.gauge(
    "capacity_utilization",
    "measured demand (deadline-class arrival rate + ADMITTED bulk "
    "service rate; parked bulk demand is excluded so the admission "
    "valve never throttles on demand it itself controls) / estimated "
    "capacity: < 1 means headroom exists, > 1 means the queue is "
    "growing and deadline misses are a matter of time",
)
_HEADROOM = metrics.gauge(
    "capacity_headroom_ratio",
    "max(0, 1 - utilization): the live headroom dial the bulk admission "
    "valve reads",
)
_SAMPLES_TOTAL = metrics.counter(
    "capacity_sampler_samples_total",
    "sampling passes the capacity timeseries sampler has run "
    "(background thread ticks + explicit sample() calls)",
)
_SAMPLER_ERRORS = metrics.counter(
    "capacity_sampler_errors_total",
    "background sampling passes that raised (the pass is dropped, the "
    "thread survives): a climbing rate with a stalled "
    "capacity_sampler_samples_total means the time axis is silently "
    "empty and one of the allowlisted source families changed shape",
)
_SAMPLER_MEMORY = metrics.gauge(
    "capacity_sampler_memory_bytes",
    "estimated bytes held by the timeseries store (series rings + "
    "rate state); stays under the configured bound (max_series x "
    "full-tier cost)",
)

# ---------------------------------------------------------------------------
# Enable / configure
# ---------------------------------------------------------------------------

_enabled = os.environ.get(
    "LIGHTHOUSE_TPU_TIMESERIES", "1"
) not in ("", "0")
_interval_s = max(0.01, _env_float("LIGHTHOUSE_TPU_TS_INTERVAL_S", 10.0))
_raw_points = max(8, _env_int("LIGHTHOUSE_TPU_TS_RAW_POINTS", 360))
_m1_points = max(4, _env_int("LIGHTHOUSE_TPU_TS_1M_POINTS", 180))
_m10_points = max(4, _env_int("LIGHTHOUSE_TPU_TS_10M_POINTS", 144))
_max_series = max(8, _env_int("LIGHTHOUSE_TPU_TS_MAX_SERIES", 256))

# conservative per-point cost constants for the memory bound (CPython
# tuple of floats + deque slot, rounded up)
_RAW_POINT_BYTES = 120
_AGG_POINT_BYTES = 180
_SERIES_OVERHEAD_BYTES = 1024


def enabled() -> bool:
    return _enabled


def configure(
    enabled: Optional[bool] = None,
    interval_s: Optional[float] = None,
    raw_points: Optional[int] = None,
    m1_points: Optional[int] = None,
    m10_points: Optional[int] = None,
    max_series: Optional[int] = None,
) -> dict:
    """Override knobs at runtime; returns the PREVIOUS values so tests
    can restore with ``configure(**prev)`` (flight_recorder's contract).
    Changing a ring capacity applies to the NEXT :func:`reset`'s store:
    live rings keep their geometry (bounded either way)."""
    global _enabled, _interval_s, _raw_points, _m1_points, _m10_points
    global _max_series
    prev = {
        "enabled": _enabled,
        "interval_s": _interval_s,
        "raw_points": _raw_points,
        "m1_points": _m1_points,
        "m10_points": _m10_points,
        "max_series": _max_series,
    }
    if enabled is not None:
        _enabled = bool(enabled)
    if interval_s is not None:
        _interval_s = max(0.01, float(interval_s))
    if raw_points is not None:
        _raw_points = max(8, int(raw_points))
    if m1_points is not None:
        _m1_points = max(4, int(m1_points))
    if m10_points is not None:
        _m10_points = max(4, int(m10_points))
    if max_series is not None:
        _max_series = max(8, int(max_series))
    return prev


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


class _Series:
    __slots__ = ("raw", "tiers", "open_buckets")

    def __init__(self, raw_points: int, m1_points: int, m10_points: int):
        self.raw: deque = deque(maxlen=raw_points)  # (t, v)
        # tier name -> ring of (t_bucket, min, max, mean, count)
        self.tiers: Dict[str, deque] = {
            "1m": deque(maxlen=m1_points),
            "10m": deque(maxlen=m10_points),
        }
        # tier name -> open accumulator [bucket_start, min, max, sum, n]
        self.open_buckets: Dict[str, Optional[list]] = {
            "1m": None, "10m": None,
        }


class TimeseriesStore:
    """Bounded, thread-safe store of named series (see module
    docstring). ``record`` is the single write path (sampler thread,
    tests, any number of writer threads); every read snapshots under
    the same lock."""

    def __init__(
        self,
        raw_points: Optional[int] = None,
        m1_points: Optional[int] = None,
        m10_points: Optional[int] = None,
        max_series: Optional[int] = None,
    ):
        self.raw_points = int(raw_points if raw_points is not None
                              else _raw_points)
        self.m1_points = int(m1_points if m1_points is not None
                             else _m1_points)
        self.m10_points = int(m10_points if m10_points is not None
                              else _m10_points)
        self.max_series = int(max_series if max_series is not None
                              else _max_series)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, str], _Series] = {}
        self._recorded_total = 0
        self._dropped_series = 0

    # -- writing ----------------------------------------------------------

    def record(
        self, family: str, value: float, t: Optional[float] = None,
        label: str = "",
    ) -> None:
        """Append one sample of ``(family, label)`` at time ``t``
        (default: now, wall clock: readers get operator-facing
        timestamps). A series beyond the ``max_series`` bound is
        COUNTED as dropped, never stored — the memory bound is strict."""
        if t is None:
            t = time.time()
        v = float(value)
        key = (family, label)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self._dropped_series += 1
                    return
                s = self._series[key] = _Series(
                    self.raw_points, self.m1_points, self.m10_points
                )
            s.raw.append((t, v))
            self._recorded_total += 1
            for tier, bucket_s in TIERS:
                if bucket_s <= 0:
                    continue
                start = (t // bucket_s) * bucket_s
                ob = s.open_buckets[tier]
                if ob is not None and start > ob[0]:
                    # bucket complete: fold into the tier ring
                    s.tiers[tier].append((
                        ob[0], ob[1], ob[2], ob[3] / ob[4], ob[4],
                    ))
                    ob = None
                if ob is None or start < ob[0]:
                    # fresh bucket; a timestamp OLDER than the open
                    # bucket (synthetic test time running backwards)
                    # stays in the raw ring but cannot join a closed
                    # aggregation window
                    if ob is None:
                        s.open_buckets[tier] = [start, v, v, v, 1]
                    continue
                ob[1] = min(ob[1], v)
                ob[2] = max(ob[2], v)
                ob[3] += v
                ob[4] += 1

    # -- reading ----------------------------------------------------------

    def families(self) -> List[str]:
        with self._lock:
            return sorted({fam for fam, _ in self._series})

    def points(
        self, family: str, label: str = "", tier: str = "raw",
        window_s: Optional[float] = None, now: Optional[float] = None,
    ) -> List[tuple]:
        """One series' points, oldest first. ``raw`` points are
        ``(t, value)``; downsampled tiers serve ``(t_bucket, min, max,
        mean, count)`` including the still-open bucket (freshness wins;
        its count says how partial it is). ``window_s`` keeps points
        newer than ``now − window_s``."""
        if tier not in TIER_NAMES:
            raise ValueError(
                f"unknown tier {tier!r} (expected one of {TIER_NAMES})"
            )
        with self._lock:
            s = self._series.get((family, label))
            if s is None:
                return []
            if tier == "raw":
                pts = list(s.raw)
            else:
                pts = list(s.tiers[tier])
                ob = s.open_buckets[tier]
                if ob is not None:
                    pts.append((ob[0], ob[1], ob[2], ob[3] / ob[4], ob[4]))
        if window_s is not None:
            cutoff = (time.time() if now is None else now) - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def doc(
        self, families: Optional[List[str]] = None, tier: str = "raw",
        window_s: Optional[float] = None,
    ) -> dict:
        """One history document: schema, tier,
        filters, and every selected series' points keyed family →
        label ("" for unlabeled)."""
        if tier not in TIER_NAMES:
            raise ValueError(
                f"unknown tier {tier!r} (expected one of {TIER_NAMES})"
            )
        with self._lock:
            keys = sorted(self._series)
        if families is not None:
            want = set(families)
            keys = [k for k in keys if k[0] in want]
        fams: Dict[str, Dict[str, list]] = {}
        for fam, label in keys:
            pts = self.points(fam, label, tier=tier, window_s=window_s)
            fams.setdefault(fam, {})[label] = [list(p) for p in pts]
        return {
            "schema": SCHEMA,
            "tier": tier,
            "window_s": window_s,
            "families": fams,
        }

    def stats(self) -> dict:
        """Store accounting incl. the memory estimate vs its bound —
        the ``store`` half of :func:`capacity_summary`."""
        with self._lock:
            n_series = len(self._series)
            n_raw = sum(len(s.raw) for s in self._series.values())
            n_agg = sum(
                len(ring) + (1 if s.open_buckets[t] is not None else 0)
                for s in self._series.values()
                for t, ring in s.tiers.items()
            )
            recorded = self._recorded_total
            dropped = self._dropped_series
        est = (
            n_raw * _RAW_POINT_BYTES
            + n_agg * _AGG_POINT_BYTES
            + n_series * _SERIES_OVERHEAD_BYTES
        )
        bound = self.max_series * (
            self.raw_points * _RAW_POINT_BYTES
            + (self.m1_points + self.m10_points + 2) * _AGG_POINT_BYTES
            + _SERIES_OVERHEAD_BYTES
        )
        return {
            "series": n_series,
            "max_series": self.max_series,
            "recorded_total": recorded,
            "dropped_series": dropped,
            "raw_points": n_raw,
            "agg_points": n_agg,
            "capacity": {
                "raw": self.raw_points,
                "1m": self.m1_points,
                "10m": self.m10_points,
            },
            "memory_bytes_est": est,
            "memory_bound_bytes": bound,
        }


# ---------------------------------------------------------------------------
# Module-level store + sampler state
# ---------------------------------------------------------------------------

_state_lock = threading.Lock()
_store: Optional[TimeseriesStore] = None
# (family, label) -> (t, cumulative value): the rate baseline. For the
# ratio mode the value is the (numerator, denominator) pair.
_rate_state: Dict[Tuple[str, str], Tuple[float, float]] = {}
_ratio_state: Dict[Tuple[str, str], Tuple[float, float, float]] = {}
_last_estimate: Optional[dict] = None
# interval-delta shard cost: (cum seconds, cum sets) at the previous
# pass, and the last interval-measured cost (sticky: see
# measured_cost_per_set)
_cost_prev: Optional[Tuple[float, float]] = None
_cost_last: Optional[float] = None


def get_store() -> TimeseriesStore:
    global _store
    with _state_lock:
        if _store is None:
            _store = TimeseriesStore()
        return _store


def reset() -> None:
    """Fresh store + rate baselines + last estimate (knobs keep their
    values)."""
    global _store, _last_estimate, _cost_prev, _cost_last
    with _state_lock:
        _store = TimeseriesStore()
        _rate_state.clear()
        _ratio_state.clear()
        _last_estimate = None
        _cost_prev = None
        _cost_last = None


# ---------------------------------------------------------------------------
# Reading the registry (one sampling pass)
# ---------------------------------------------------------------------------


def _source_values(source: str, label: Optional[str]) -> Optional[dict]:
    """{label value ("" when unlabelled/summed): numeric value} for one
    registry family, summing children across the non-kept labels; None
    when the family is not registered yet."""
    m = metrics.get(source)
    if m is None:
        return None
    if not hasattr(m, "labelnames"):
        return {"": float(m.value)}
    out: Dict[str, float] = {}
    try:
        keep_idx = m.labelnames.index(label) if label is not None else None
    except ValueError:
        keep_idx = None
    for values, child in m.children().items():
        key = values[keep_idx] if keep_idx is not None else ""
        out[key] = out.get(key, 0.0) + float(child.value)
    return out


def _sample_rates(spec: FamilySpec, store: TimeseriesStore,
                  now: float) -> Dict[str, float]:
    """Counter family -> per-second rates against the previous pass's
    cumulative values. The first sighting of a label records nothing
    (there is no interval to rate over: never a fabricated 0)."""
    cur = _source_values(spec.source, spec.label)
    rates: Dict[str, float] = {}
    if cur is None:
        return rates
    for label, value in cur.items():
        key = (spec.family, label)
        prev = _rate_state.get(key)
        _rate_state[key] = (now, value)
        if prev is None:
            continue
        t0, v0 = prev
        dt = now - t0
        if dt <= 0:
            continue
        rate = max(0.0, value - v0) / dt
        rates[label] = rate
        store.record(spec.family, rate, t=now, label=label)
    return rates


def _sample_bubble_ratio(spec: FamilySpec, store: TimeseriesStore,
                         now: float) -> None:
    """bubble / (bubble + busy) per shard over the sampling interval's
    deltas: the live counterpart of the profiler's lifetime ratio."""
    bubble = _source_values("bls_device_bubble_seconds_total", "shard")
    busy = _source_values("bls_device_shard_busy_seconds_total", "shard")
    if bubble is None or busy is None:
        return
    for shard in sorted(set(bubble) | set(busy)):
        nb = bubble.get(shard, 0.0)
        ns = busy.get(shard, 0.0)
        key = (spec.family, shard)
        prev = _ratio_state.get(key)
        _ratio_state[key] = (now, nb, ns)
        if prev is None:
            continue
        _t0, pb, ps = prev
        d_bubble = max(0.0, nb - pb)
        d_busy = max(0.0, ns - ps)
        span = d_bubble + d_busy
        if span <= 0:
            continue  # idle interval: no dispatch, no honest ratio
        store.record(spec.family, d_bubble / span, t=now, label=shard)


# ---------------------------------------------------------------------------
# The capacity / headroom estimator
# ---------------------------------------------------------------------------


def _shard_cost_cumulative() -> Optional[Tuple[float, float]]:
    """(sum of shard verify seconds, sum of shard sets) from the mesh
    families; None until both exist."""
    secs_m = metrics.get("bls_device_shard_verify_seconds")
    sets_m = metrics.get("bls_device_shard_sets_total")
    if secs_m is None or sets_m is None:
        return None
    secs = sum(
        float(c.sum) for c in secs_m.children().values()
    ) if hasattr(secs_m, "children") else 0.0
    sets = sum(
        float(c.value) for c in sets_m.children().values()
    ) if hasattr(sets_m, "children") else 0.0
    return secs, sets


def _update_interval_shard_cost() -> None:
    """One pass of the mesh cost feed: the per-set cost over THIS
    sampling interval's dispatch deltas (sticky: kept until a later
    interval measures again). Interval deltas, never lifetime
    cumulative values: a process-lifetime average would let hours of
    warm history mask what serving costs right now. Called under
    _state_lock."""
    global _cost_prev, _cost_last
    cur = _shard_cost_cumulative()
    if cur is None:
        return
    prev, _cost_prev = _cost_prev, cur
    if prev is None:
        return
    d_secs = cur[0] - prev[0]
    d_sets = cur[1] - prev[1]
    if d_secs > 0 and d_sets > 0:
        _cost_last = d_secs / d_sets


def measured_cost_per_set() -> Tuple[Optional[float], Optional[str]]:
    """Measured serving cost per signature set, with its source, in
    preference order (most device-truthful first):

    1. ``shard_verify``: the mesh feed, per-shard dispatch walls over
       recent SAMPLING-INTERVAL deltas (sticky once measured), so the
       per-set cost is per card and capacity scales with the
       healthy-shard count;
    2. ``compile_service``: the service's organic rung-cost gauge
       (``compile_service_measured_cost_seconds_per_set``, fed by
       ``note_rung_verified`` on every staged dispatch);
    3. ``flush_wall``: the pipeline profiler's cumulative flush
       accounting: device+fallback seconds per fused set, or (for a
       stub or ``cpu-native`` verifier that never fires a stage hook)
       the flush wall minus planning per set.

    Returns (None, None) when nothing has been measured: the estimator
    never invents a capacity."""
    if _cost_last is not None and _cost_last > 0:
        return _cost_last, "shard_verify"
    g = metrics.get("compile_service_measured_cost_seconds_per_set")
    if g is not None and float(getattr(g, "value", 0.0)) > 0:
        return float(g.value), "compile_service"
    from . import pipeline_profiler

    flushes = pipeline_profiler.summary().get("flushes", {})
    sets = flushes.get("sets", 0)
    if sets:
        busy = flushes.get("device_s", 0.0) + flushes.get("fallback_s", 0.0)
        if busy > 0:
            return busy / sets, "flush_wall"
        serving = flushes.get("wall_s", 0.0) - flushes.get("plan_s", 0.0)
        if serving > 0:
            return serving / sets, "flush_wall"
    return None, None


def _healthy_shard_count() -> int:
    """The mesh feed: the live healthy-shard count when a mesh is
    attached (read directly: the dp gauge only updates at flush time, so
    it would lag a card loss), else 1 (single-device serving). A mesh
    with EVERY card lost is a true 0: capacity is zero and the dial must
    say so."""
    try:
        from ..crypto.device import mesh as mesh_mod

        if mesh_mod.get_active_mesh() is not None:
            return mesh_mod.healthy_shard_count()
    except Exception:
        pass
    g = metrics.get("verification_scheduler_dp_shards")
    if g is not None and float(getattr(g, "value", 0.0)) > 0:
        return int(g.value)
    return 1


def estimate_capacity(
    arrival_sets_per_sec: Optional[float] = None,
    cost_s_per_set: Optional[float] = None,
    shards: Optional[int] = None,
    publish: bool = True,
) -> dict:
    """One estimator pass: combine measured cost, healthy shards and
    the arrival rate into the capacity/utilization/headroom triple.
    Every input is overridable; a model run passes its inputs with
    ``publish=False`` (the formula has exactly one home, and a model run
    must not write the live gauges). Anything unmeasured stays ``None``
    and the corresponding gauge is left untouched: the dial never lies."""
    source = "override"
    if cost_s_per_set is None:
        cost_s_per_set, source = measured_cost_per_set()
    if shards is None:
        shards = _healthy_shard_count()
    est = None
    if cost_s_per_set and cost_s_per_set > 0:
        est = shards / cost_s_per_set
    utilization = headroom = None
    if est is not None and arrival_sets_per_sec is not None:
        if est > 0:
            utilization = arrival_sets_per_sec / est
            headroom = max(0.0, 1.0 - utilization)
        else:
            # measured ZERO capacity (a mesh with every card lost):
            # utilization is undefined (x/0) but the headroom dial
            # must read empty, not unknown
            headroom = 0.0
    doc = {
        "cost_s_per_set": (
            round(cost_s_per_set, 9) if cost_s_per_set else None
        ),
        "cost_source": source if cost_s_per_set else None,
        "shards": shards,
        "estimated_sets_per_sec": (
            round(est, 3) if est is not None else None
        ),
        "arrival_sets_per_sec": (
            round(arrival_sets_per_sec, 3)
            if arrival_sets_per_sec is not None else None
        ),
        "utilization": (
            round(utilization, 4) if utilization is not None else None
        ),
        "headroom_ratio": (
            round(headroom, 4) if headroom is not None else None
        ),
    }
    if publish:
        if est is not None:
            _EST_CAPACITY.set(est)
        if utilization is not None:
            _UTILIZATION.set(utilization)
        if headroom is not None:
            _HEADROOM.set(headroom)
            # chain-time: the slot's report card keeps its MINIMUM
            # headroom, the worst moment inside the slot
            slot_ledger.note_headroom(headroom)
    return doc


# ---------------------------------------------------------------------------
# The sampling pass (one global check when disabled)
# ---------------------------------------------------------------------------


def _bulk_arrival_rate(now: float) -> float:
    """Bulk-PATH arrival rate (sets/s) off the same counter the arrival
    series samples, grouped by the path label instead of kind. NOT
    stored as a series: it exists only to be subtracted from the
    estimator's utilization numerator (see ``sample()``). First
    sighting rates 0.0 (no interval yet). Called under ``_state_lock``
    like every `_rate_state` user."""
    vals = _source_values(
        "verification_scheduler_arrival_sets_total", "path"
    )
    value = (vals or {}).get("bulk")
    if value is None:
        return 0.0
    key = ("_util_bulk_arrivals", "bulk")
    prev = _rate_state.get(key)
    _rate_state[key] = (now, value)
    if prev is None:
        return 0.0
    t0, v0 = prev
    dt = now - t0
    if dt <= 0:
        return 0.0
    return max(0.0, value - v0) / dt


def sample(now: Optional[float] = None) -> Optional[dict]:
    """Run ONE sampling pass: snapshot every allowlisted family into
    the store, then run the capacity estimator on the rates just
    measured and record its outputs as series too. Returns the
    estimator document (None when disabled: a single global check)."""
    if not _enabled:
        return None
    global _last_estimate
    if now is None:
        now = time.time()
    store = get_store()
    arrival_total: Optional[float] = None
    bulk_served = 0.0
    with _state_lock:
        for spec in SAMPLE_FAMILIES:
            if spec.mode == "gauge":
                vals = _source_values(spec.source, spec.label)
                if vals is None:
                    continue
                for label, v in vals.items():
                    store.record(spec.family, v, t=now, label=label)
            elif spec.mode == "rate":
                rates = _sample_rates(spec, store, now)
                if spec.family == "capacity_arrival_sets_per_sec" and rates:
                    arrival_total = sum(rates.values())
                elif spec.family == "capacity_bulk_sets_per_sec" and rates:
                    bulk_served = sum(rates.values())
            elif spec.mode == "ratio":
                _sample_bubble_ratio(spec, store, now)
            # "derived" families are recorded below by the estimator
        # primed EVERY pass (not only when the arrival series already
        # rated) so its own first sighting lines up with the arrival
        # family's
        bulk_demand = _bulk_arrival_rate(now)
        if arrival_total is not None:
            # the utilization NUMERATOR counts deadline-class demand
            # plus ADMITTED bulk service, not raw bulk offered demand:
            # bulk arrivals the admission valve has parked would
            # otherwise hold headroom below the resume threshold on
            # demand the valve itself controls, a loop that could never
            # un-throttle under a persistent bulk submitter. The
            # per-kind arrival SERIES keeps the full demand picture.
            arrival_total = max(0.0, arrival_total - bulk_demand) + bulk_served
        _update_interval_shard_cost()
    est = estimate_capacity(arrival_sets_per_sec=arrival_total)
    if est["estimated_sets_per_sec"] is not None:
        store.record(
            "capacity_estimated_sets_per_sec",
            est["estimated_sets_per_sec"], t=now,
        )
    if est["utilization"] is not None:
        store.record("capacity_utilization", est["utilization"], t=now)
    if est["headroom_ratio"] is not None:
        store.record("capacity_headroom_ratio", est["headroom_ratio"], t=now)
    with _state_lock:
        _last_estimate = {**est, "t": now}
    _SAMPLES_TOTAL.inc()
    _SAMPLER_MEMORY.set(store.stats()["memory_bytes_est"])
    return est


def last_estimate() -> Optional[dict]:
    with _state_lock:
        return dict(_last_estimate) if _last_estimate else None


# ---------------------------------------------------------------------------
# Background sampler
# ---------------------------------------------------------------------------


class Sampler:
    """Background thread calling :func:`sample` every ``interval_s``.
    Started by the node or a driver; the store serves whatever history
    exists either way."""

    def __init__(self, interval_s: Optional[float] = None):
        self.interval_s = float(
            interval_s if interval_s is not None else _interval_s
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Sampler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="capacity-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                sample()
            except Exception:
                # a sampling crash must never kill the thread, and a
                # silent swallow would serve an empty time axis with
                # nothing pointing at why: count it
                _SAMPLER_ERRORS.inc()
            self._stop.wait(self.interval_s)


_sampler: Optional[Sampler] = None


def start_sampler(interval_s: Optional[float] = None) -> Sampler:
    global _sampler
    with _state_lock:
        if _sampler is None or not _sampler.running():
            _sampler = Sampler(interval_s=interval_s)
        s = _sampler
        # started INSIDE the lock: a concurrent stop_sampler() must
        # either see the running thread (and stop it) or take the
        # handle before start, never an orphaned, unstoppable sampler
        # (start never joins, so no deadlock with the new thread's own
        # _state_lock acquisition)
        s.start()
    return s


def stop_sampler() -> None:
    global _sampler
    with _state_lock:
        s = _sampler
        _sampler = None
    # join OUTSIDE the lock: the sampler thread may be mid-sample()
    # waiting on _state_lock
    if s is not None:
        s.stop()


def sampler_running() -> bool:
    s = _sampler
    return s is not None and s.running()


# ---------------------------------------------------------------------------
# The `capacity` document
# ---------------------------------------------------------------------------


def capacity_summary() -> dict:
    """One document: sampler state, store accounting (memory estimate
    vs bound), the family catalogue, and the latest estimator output."""
    store = get_store()
    s = _sampler
    return {
        "enabled": _enabled,
        "sampler": {
            "running": sampler_running(),
            # the RUNNING sampler's actual period: start_sampler may
            # have overridden the module default
            "interval_s": s.interval_s if s is not None else _interval_s,
            "samples_total": int(_SAMPLES_TOTAL.value),
        },
        "store": store.stats(),
        "families": [s.family for s in SAMPLE_FAMILIES],
        "estimate": last_estimate(),
    }
