"""Rolling verdict-latency SLO tracker for the verification scheduler:
the port's copy of the JAX package's ``verification_service/slo.py``.

The histogram family ``verification_scheduler_verdict_latency_seconds
{kind,path}`` (``batcher.py``) is cumulative: right for dashboards, wrong
for "what are submitters experiencing RIGHT NOW?". This module keeps a
bounded per-kind window of the most recent end-to-end submit-to-verdict
latencies (every resolution path: fused flush, planned sub-batch,
bisection retry, backpressure shed, ``verify_now`` bypass, compile-
service fallback) and answers with rolling p50/p99 and the miss ratio.

**Burn rate.** Per kind and per-sample timestamps, over a ``fast``
window (default 60 s) and a ``slow`` one (default 600 s): ``burn =
window_miss_ratio / budget_miss_ratio`` (budget default 1%). When BOTH
windows burn at or above the alert threshold (default 1.0) the tracker
journals ONE ``slo_burn`` flight-recorder event per excursion (a
continuing storm re-confirms the latch without re-firing; a stretch
longer than the fast window without a confirmed alert re-arms it),
ticks ``verification_scheduler_slo_burn_events_total{kind}`` and serves
the live rates in ``verification_scheduler_slo_burn_rate{kind,window}``.

**Per class.** A ``bulk`` verdict (deadline-insensitive backfill) never
counts as a miss and never enters the burn buckets, where its on-time
samples would dilute gossip's miss ratio; ``summary()`` labels each
kind with its class (sticky-deadline: one deadline-class sample
upgrades a kind for good) and ``latched_kinds()``, the bulk admission
controller's read, only names deadline-class kinds.

**Ratio scopes.** ``summary()`` reports ``window_miss_ratio`` (window
misses / window deadline-class count) and ``lifetime_miss_ratio``
(lifetime misses / lifetime deadline-class count), never a ratio
across scopes.

Scheduler-instance-scoped: a run or a test reads ITS scheduler's window
(``summary()``/``burn()``); the burn gauge and counter families are
process-global like every metric family. ``observe()`` is O(1)
amortized (one deque append and one time-bucket update under one lock;
burn rechecks are miss-driven over a bounded bucket ring) and
``summary()`` sorts only the bounded window (default 1024 samples per
kind).

Env knobs: ``LIGHTHOUSE_TPU_SLO_WINDOW`` (sample window),
``LIGHTHOUSE_TPU_SLO_BUDGET_RATIO`` (budgeted miss ratio, default 0.01),
``LIGHTHOUSE_TPU_SLO_FAST_S`` / ``LIGHTHOUSE_TPU_SLO_SLOW_S`` (burn
windows, default 60/600 s), ``LIGHTHOUSE_TPU_SLO_BURN_ALERT`` (alert
threshold, default 1.0).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from ..utils import flight_recorder, metrics

DEFAULT_WINDOW = 1024
DEFAULT_BUDGET_MISS_RATIO = 0.01
DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0
DEFAULT_BURN_ALERT = 1.0

_ENV_WINDOW = "LIGHTHOUSE_TPU_SLO_WINDOW"
_ENV_BUDGET = "LIGHTHOUSE_TPU_SLO_BUDGET_RATIO"
_ENV_FAST = "LIGHTHOUSE_TPU_SLO_FAST_S"
_ENV_SLOW = "LIGHTHOUSE_TPU_SLO_SLOW_S"
_ENV_ALERT = "LIGHTHOUSE_TPU_SLO_BURN_ALERT"

_Sample = Tuple[float, float, str, bool, str]  # (t, s, path, missed, qos)

_BURN_RATE = metrics.gauge_vec(
    "verification_scheduler_slo_burn_rate",
    "miss-budget burn rate per caller kind and window (fast/slow): "
    "window miss ratio / budgeted miss ratio. 1.0 consumes exactly the "
    "budget over that window; both windows >= the alert threshold "
    "journals an slo_burn event (the standing alert primitive). "
    "Updated on misses and on burn()/summary() reads",
    ("kind", "window"),
)
_BURN_EVENTS = metrics.counter_vec(
    "verification_scheduler_slo_burn_events_total",
    "slo_burn alerts journaled per caller kind: both burn windows "
    "crossed the alert threshold (latched — one event per excursion, "
    "not per miss)",
    ("kind",),
)


# one env-parsing convention across the observability knobs
_env_float = flight_recorder._env_float


def quantile_ms(sorted_latencies, q: float) -> float:
    """Nearest-rank quantile of an already-sorted seconds list, in
    milliseconds (0.0 for an empty window). THE quantile spelling for
    every replay/SLO report, so a harness and the health block can never
    disagree on rank semantics. Nearest-rank proper: index
    ``ceil(q*n) - 1`` — ``int(q*n)`` would overshoot by one exactly when
    ``q*n`` is integral, silently reporting the max as p99 at round
    window sizes."""
    if not sorted_latencies:
        return 0.0
    n = len(sorted_latencies)
    idx = min(n - 1, max(0, math.ceil(q * n) - 1))
    return round(sorted_latencies[idx] * 1000.0, 3)


class SloTracker:
    """Bounded rolling window of verdict latencies per caller kind (see
    module docstring). ``observe`` is called by the scheduler on every
    resolution; ``summary`` is the health-endpoint/replay-report read;
    ``burn`` is the miss-budget burn-rate read."""

    def __init__(
        self,
        window: int | None = None,
        budget_miss_ratio: float | None = None,
        fast_window_s: float | None = None,
        slow_window_s: float | None = None,
        burn_alert: float | None = None,
    ):
        if window is None:
            try:
                window = int(os.environ.get(_ENV_WINDOW, ""))
            except ValueError:
                window = DEFAULT_WINDOW
        self.window = max(1, int(window))
        self.budget_miss_ratio = max(1e-9, float(
            budget_miss_ratio
            if budget_miss_ratio is not None
            else _env_float(_ENV_BUDGET, DEFAULT_BUDGET_MISS_RATIO)
        ))
        self.fast_window_s = max(1e-3, float(
            fast_window_s
            if fast_window_s is not None
            else _env_float(_ENV_FAST, DEFAULT_FAST_WINDOW_S)
        ))
        self.slow_window_s = max(self.fast_window_s, float(
            slow_window_s
            if slow_window_s is not None
            else _env_float(_ENV_SLOW, DEFAULT_SLOW_WINDOW_S)
        ))
        self.burn_alert = max(1e-6, float(
            burn_alert
            if burn_alert is not None
            else _env_float(_ENV_ALERT, DEFAULT_BURN_ALERT)
        ))
        self._lock = threading.Lock()
        self._samples: Dict[str, Deque[_Sample]] = {}
        self._count_total: Dict[str, int] = {}
        # lifetime DEADLINE-class sample count per kind: the
        # lifetime_miss_ratio denominator (misses are deadline-only by
        # construction, so the all-class count would dilute a mixed
        # kind's ratio exactly like the window fix below prevents)
        self._dl_count_total: Dict[str, int] = {}
        self._misses_total: Dict[str, int] = {}
        # kind -> QoS class label, STICKY-deadline: "bulk"
        # only while every sample the kind ever carried was bulk — one
        # deadline sample upgrades it for good (a mixed-class kind's
        # deadline samples keep feeding the burn buckets, so its burn
        # doc must stay visible). The summary label + the guarantee
        # that latched_kinds() only ever names deadline-class kinds.
        self._kind_qos: Dict[str, str] = {}
        # burn accounting is TIME-bucketed, decoupled from the
        # count-bounded quantile deque: at production verdict rates
        # (hundreds/s) 1024 samples span seconds, which would silently
        # collapse both burn windows onto the same sliver of history
        # and defeat the slow window's blip forgiveness. Buckets are
        # fast_window/20 wide; the ring holds one slow window of them
        # per kind — bounded memory at ANY rate.
        self._bucket_s = max(1e-3, self.fast_window_s / 20.0)
        self._bucket_cap = int(self.slow_window_s / self._bucket_s) + 2
        # kind -> deque of [bucket_start, count, misses]
        self._burn_buckets: Dict[str, Deque[list]] = {}
        # burn-alert latches + recompute throttle, per kind: the latch
        # is the time the alert state was last CONFIRMED — a continuing
        # storm refreshes it (no re-fire); a gap longer than the fast
        # window (misses aged out, then a fresh excursion) re-arms it
        self._burn_alerted_at: Dict[str, Optional[float]] = {}
        # last latched-path re-confirmation scan per kind: while
        # latched, misses re-evaluate at bucket granularity (the
        # windows only move in bucket steps), not on every miss
        self._burn_checked_at: Dict[str, float] = {}
        self._burn_events_total: Dict[str, int] = {}

    def observe(
        self, kind: str, path: str, seconds: float, missed: bool,
        now: float | None = None, qos: str = "deadline",
    ) -> None:
        """Record one resolved submission: end-to-end latency, the
        resolution path that produced the verdict, and whether it landed
        past the deadline. ``now`` is injectable for deterministic
        burn-window tests (default ``time.monotonic()``). ``qos`` is the
        submission's service class: a non-deadline sample feeds the
        quantile window only — never the burn buckets, whose count
        denominator a saturating bulk stream would otherwise dilute
        (module docstring)."""
        if now is None:
            now = time.monotonic()
        check_burn = False
        with self._lock:
            dq = self._samples.get(kind)
            if dq is None:
                dq = self._samples[kind] = deque(maxlen=self.window)
                self._count_total[kind] = 0
                self._dl_count_total[kind] = 0
                self._misses_total[kind] = 0
            # sticky-deadline: a kind that EVER carried deadline-class
            # samples keeps its burn visibility — last-writer-wins
            # would let one bulk sample of a mixed-class kind hide an
            # ACTIVE gossip burn excursion from burn()/summary()
            if qos == "deadline" or kind not in self._kind_qos:
                self._kind_qos[kind] = qos
            dq.append((now, seconds, path, missed, qos))
            self._count_total[kind] += 1
            if qos == "deadline":
                self._dl_count_total[kind] += 1
            if missed:
                self._misses_total[kind] += 1
            if qos != "deadline":
                return
            buckets = self._burn_buckets.get(kind)
            if buckets is None:
                buckets = self._burn_buckets[kind] = deque(
                    maxlen=self._bucket_cap
                )
            start = (now // self._bucket_s) * self._bucket_s
            if not buckets or start > buckets[-1][0]:
                buckets.append([start, 0, 0])
            # an out-of-order timestamp (synthetic test time) folds into
            # the newest bucket rather than corrupting the ring order
            buckets[-1][1] += 1
            if missed:
                buckets[-1][2] += 1
                at = self._burn_alerted_at.get(kind)
                if at is not None and now - at <= self.fast_window_s:
                    # latched: re-CONFIRM at bucket granularity (the
                    # windows only move in bucket steps, so finer
                    # rechecks cannot change the answer — a storm
                    # costs one bounded scan per bucket, not per
                    # miss). The latch is NEVER refreshed without a
                    # confirming scan: a sub-budget background miss
                    # trickle would otherwise pin it alive forever
                    # and silence every later real excursion.
                    last = self._burn_checked_at.get(
                        kind, -float("inf")
                    )
                    if now - last >= self._bucket_s:
                        check_burn = True
                else:
                    # un-latched: EVERY miss evaluates (bounded bucket
                    # scan, ≤ one slow window of buckets) — a
                    # time-throttle here once let a sub-throttle burst
                    # cross both windows without ever journaling
                    check_burn = True
        if check_burn:
            self._recheck_burn(kind, now)

    # -- burn-rate tracking ------------------------------------------------

    def _window_burn_locked(
        self, kind: str, window_s: float, now: float
    ) -> dict:
        """Miss ratio + burn over the trailing ``window_s``, from the
        time-bucketed counters (bucket granularity ≈ fast/20 — a ≤5%
        edge approximation, never a rate-dependent window collapse)."""
        cutoff = now - window_s
        count = misses = 0
        for start, n, m in reversed(self._burn_buckets.get(kind) or ()):
            if start + self._bucket_s <= cutoff:
                break
            count += n
            misses += m
        ratio = (misses / count) if count else 0.0
        return {
            "window_s": window_s,
            "count": count,
            "misses": misses,
            "miss_ratio": round(ratio, 6),
            "burn": (
                round(ratio / self.budget_miss_ratio, 4) if count else None
            ),
        }

    def _burn_kind_locked(self, kind: str, now: float) -> dict:
        fast = self._window_burn_locked(kind, self.fast_window_s, now)
        slow = self._window_burn_locked(kind, self.slow_window_s, now)
        alerting = (
            fast["burn"] is not None and fast["burn"] >= self.burn_alert
            and slow["burn"] is not None and slow["burn"] >= self.burn_alert
        )
        return {
            "fast": fast,
            "slow": slow,
            "alerting": alerting,
            "events_total": self._burn_events_total.get(kind, 0),
        }

    @staticmethod
    def _publish_burn_gauges(kind: str, doc: dict) -> None:
        """Mirror one kind's computed burn into the gauge family —
        called from miss-driven rechecks AND from burn()/summary()
        reads, so a post-storm scrape decays the gauge instead of
        freezing it at the excursion's peak (an alert on the gauge
        would otherwise fire forever after full recovery)."""
        for win in ("fast", "slow"):
            burn = doc[win]["burn"]
            _BURN_RATE.with_labels(kind, win).set(
                burn if burn is not None else 0.0
            )

    def _recheck_burn(self, kind: str, now: float) -> None:
        """Recompute the two burn windows for ``kind`` and drive the
        alert latch: entering the alerting state journals ONE
        ``slo_burn`` event per EXCURSION (the standing alert). A
        continuing storm re-confirms the latch without re-firing; a
        stretch longer than the fast window without a confirmed alert
        (quiet, or background misses under budget) expires it, so the
        next excursion alerts again even if nothing read the tracker
        in between."""
        with self._lock:
            self._burn_checked_at[kind] = now
            doc = self._burn_kind_locked(kind, now)
            fire = False
            if doc["alerting"]:
                at = self._burn_alerted_at.get(kind)
                if at is None or now - at > self.fast_window_s:
                    fire = True
                    self._burn_events_total[kind] = (
                        self._burn_events_total.get(kind, 0) + 1
                    )
                    doc["events_total"] = self._burn_events_total[kind]
                self._burn_alerted_at[kind] = now
            # NOT cleared on a non-alerting recheck: re-arm is purely
            # time-based (a quiet — or merely sub-budget — stretch
            # longer than the fast window since the last CONFIRMED
            # alert). A miss ratio oscillating around the budget would
            # otherwise fire one event per re-crossing and flood the
            # journal during a sustained near-budget storm.
        self._publish_burn_gauges(kind, doc)
        if fire:
            _BURN_EVENTS.with_labels(kind).inc()
            flight_recorder.record(
                "slo_burn",
                kind=kind,
                budget_miss_ratio=self.budget_miss_ratio,
                burn_alert=self.burn_alert,
                fast_window_s=self.fast_window_s,
                fast_miss_ratio=doc["fast"]["miss_ratio"],
                fast_burn=doc["fast"]["burn"],
                slow_window_s=self.slow_window_s,
                slow_miss_ratio=doc["slow"]["miss_ratio"],
                slow_burn=doc["slow"]["burn"],
            )

    def latched_kinds(self, now: float | None = None) -> list:
        """Kinds whose burn-alert latch is live: a confirmed ``slo_burn``
        excursion within the fast window. THE standing-alert read the
        bulk admission controller polls — bulk-class samples
        never reach the burn buckets, so any latched kind is by
        construction a deadline-class (gossip) kind."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            return sorted(
                kind
                for kind, at in self._burn_alerted_at.items()
                if at is not None and now - at <= self.fast_window_s
            )

    def burn(self, now: float | None = None) -> dict:
        """The miss-budget burn document: per kind, miss ratio and burn
        multiple over the fast and slow windows, the alert latch state
        and the per-kind alert count — plus the budget configuration.
        The latch stays miss-driven; reads refresh the burn GAUGES so
        they decay after a storm instead of freezing at its peak."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            # bulk-class kinds never feed the burn buckets —
            # an all-zero doc for them would read as "zero burn
            # measured" rather than "not applicable", so they are
            # absent here exactly as their summary() burn block is None
            kinds = {
                kind: self._burn_kind_locked(kind, now)
                for kind in sorted(self._samples)
                if self._kind_qos.get(kind, "deadline") == "deadline"
            }
        for kind, doc in kinds.items():
            self._publish_burn_gauges(kind, doc)
        return {
            "budget_miss_ratio": self.budget_miss_ratio,
            "burn_alert": self.burn_alert,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "kinds": kinds,
        }

    # -- totals ------------------------------------------------------------

    def misses_total(self) -> int:
        """Lifetime deadline misses across every kind — THE total the
        scheduler's ``status()`` and ``slo_summary()`` both report (one
        source of truth; the per-kind split lives in ``summary()``)."""
        with self._lock:
            return sum(self._misses_total.values())

    def summary(
        self, deadline_ms: float | None = None, now: float | None = None,
    ) -> dict:
        """The ``slo`` document: per kind, rolling p50/p99/max over the
        window, the miss ratio in BOTH scopes (window-scoped and
        lifetime — never mixed, see module docstring), lifetime totals,
        a per-path breakdown (each path's own window quantiles) so a
        flattering fast path cannot hide a slow one's tail, and the
        per-kind burn-rate block."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            snap = {k: list(dq) for k, dq in self._samples.items()}
            counts = dict(self._count_total)
            dl_counts = dict(self._dl_count_total)
            misses = dict(self._misses_total)
            kind_qos = dict(self._kind_qos)
            # deadline-class kinds only (burn()'s filter): computing a
            # bulk kind's burn doc here would be lock-held work whose
            # result the "burn" key below discards anyway
            burn_kinds = {
                kind: self._burn_kind_locked(kind, now)
                for kind in sorted(self._samples)
                if kind_qos.get(kind, "deadline") == "deadline"
            }
        for kind, bdoc in burn_kinds.items():
            self._publish_burn_gauges(kind, bdoc)
        kinds = {}
        for kind in sorted(snap):
            samples = snap[kind]
            lat = sorted(s[1] for s in samples)
            # the windowed miss ratio is DEADLINE-scoped: a
            # mixed-class kind's saturating bulk stream would otherwise
            # pack the shared window with never-miss samples and read
            # near-zero during an active gossip miss storm — the exact
            # dilution the burn buckets already refuse. Quantiles stay
            # all-class (bulk visibility is the feature; the per-path
            # rows below separate the classes for mixed kinds).
            dl_count = sum(1 for s in samples if s[4] == "deadline")
            window_misses = sum(1 for s in samples if s[3])
            paths = {}
            for path in sorted({s[2] for s in samples}):
                plat = sorted(s[1] for s in samples if s[2] == path)
                paths[path] = {
                    "count": len(plat),
                    "p50_ms": quantile_ms(plat, 0.50),
                    "p99_ms": quantile_ms(plat, 0.99),
                }
            kinds[kind] = {
                # the QoS class this kind's samples carry:
                # bulk kinds report quantiles but no burn block — their
                # misses are defined away, not hidden
                "qos": kind_qos.get(kind, "deadline"),
                "count_total": counts[kind],
                "window_count": len(samples),
                "p50_ms": quantile_ms(lat, 0.50),
                "p99_ms": quantile_ms(lat, 0.99),
                "max_ms": round(lat[-1] * 1000.0, 3) if lat else 0.0,
                "misses_total": misses[kind],
                "window_misses": window_misses,
                "window_miss_ratio": (
                    round(window_misses / dl_count, 4) if dl_count else 0.0
                ),
                # explicitly lifetime-scoped: the
                # lifetime numerator over the lifetime DEADLINE-class
                # denominator — a reader never has to divide
                # across scopes, and a mixed kind's bulk samples cannot
                # dilute it
                "lifetime_miss_ratio": (
                    round(misses[kind] / dl_counts.get(kind, 0), 6)
                    if dl_counts.get(kind) else 0.0
                ),
                "paths": paths,
                # bulk kinds carry no burn block: their samples never
                # enter the burn buckets, so the empty doc would read
                # as "zero burn measured" rather than "not applicable"
                "burn": (
                    burn_kinds.get(kind)
                    if kind_qos.get(kind, "deadline") == "deadline"
                    else None
                ),
            }
        doc = {
            "window": self.window,
            "kinds": kinds,
            "burn_config": {
                "budget_miss_ratio": self.budget_miss_ratio,
                "burn_alert": self.burn_alert,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
            },
        }
        if deadline_ms is not None:
            doc["deadline_ms"] = round(float(deadline_ms), 3)
        return doc
