"""Headroom-driven admission control for the bulk QoS class: the port's
copy of the JAX package's ``verification_service/admission.py``.

The scheduler's bulk class (``batcher.py``) lets chain-segment backfill
and slasher-style ingest use idle device time without moving gossip's
p99. This module is the valve: it pauses bulk admission while either of
two signals says the node is out of slack:

* **capacity headroom** (``capacity_headroom_ratio`` = max(0, 1 -
  arrival/capacity)) below ``floor`` (default 0.10,
  ``LIGHTHOUSE_TPU_SCHED_BULK_HEADROOM_FLOOR``). An UNKNOWN headroom
  reads as "no signal", never as "no headroom". The default feed is the
  capacity estimator's latest headroom (``utils/timeseries.py``,
  :func:`_live_headroom`): None until the sampler has measured a cost
  and an arrival rate;
* **the SLO burn latch** (``slo.py``, ``latched_kinds()``): a confirmed
  ``slo_burn`` excursion on any deadline-class kind pauses bulk at once.

**Hysteresis.** Throttling resumes only when BOTH signals clear: the
burn latch expired AND headroom recovered past ``resume_headroom``
(default 0.20, ``LIGHTHOUSE_TPU_SCHED_BULK_RESUME_HEADROOM``), or is
unknown.

**One journal event per excursion**: entering journals ONE
``bulk_throttle`` (reason, headroom, latched kinds), leaving ONE
``bulk_resume`` (duration); the ``verification_scheduler_bulk_throttled``
gauge records the state.

Degradation order: losing headroom sheds bulk FIRST: bulk flushes pause
while queued bulk waits, and a bulk-queue overflow degrades the
submission to its CALLER's thread, never to gossip's flush thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..utils import flight_recorder, metrics, timeseries

DEFAULT_HEADROOM_FLOOR = 0.10
DEFAULT_RESUME_HEADROOM = 0.20
# evaluate() is called on every bulk submit and every flush-loop wake;
# the signals only move at sampler cadence, so re-reads are throttled
DEFAULT_MIN_INTERVAL_S = 0.05

_ENV_FLOOR = "LIGHTHOUSE_TPU_SCHED_BULK_HEADROOM_FLOOR"
_ENV_RESUME = "LIGHTHOUSE_TPU_SCHED_BULK_RESUME_HEADROOM"

_env_float = flight_recorder._env_float

_THROTTLED = metrics.gauge(
    "verification_scheduler_bulk_throttled",
    "1 while bulk admission is paused (headroom below the floor or a "
    "gossip slo_burn latch live), 0 while bulk flows — state; the "
    "transitions are journaled as bulk_throttle/bulk_resume events and "
    "counted in verification_scheduler_bulk_throttle_events_total",
)
_THROTTLE_EVENTS = metrics.counter_vec(
    "verification_scheduler_bulk_throttle_events_total",
    "bulk-admission throttle excursions entered, by triggering reason "
    "(headroom = capacity_headroom_ratio below the floor, slo_burn = a "
    "deadline-class burn latch) — one tick per excursion, not per "
    "evaluation; resumes are the bulk_resume journal events",
    ("reason",),
)


def _live_headroom() -> Optional[float]:
    """The default headroom feed: the capacity estimator's latest
    ``headroom_ratio`` (None when the sampler is off or nothing has been
    measured yet: 'no signal', never 'no headroom')."""
    try:
        est = timeseries.last_estimate()
        if est is None:
            return None
        return est.get("headroom_ratio")
    except Exception:
        return None


class BulkAdmissionController:
    """The bulk-admission valve (module docstring). ``evaluate()``
    returns True while bulk may flush/admit; the scheduler calls it on
    every bulk submit and every flush-loop wake. ``tracker`` is bound
    by the scheduler to ITS SloTracker when not injected."""

    def __init__(
        self,
        headroom_fn: Optional[Callable[[], Optional[float]]] = None,
        tracker=None,
        floor: float | None = None,
        resume_headroom: float | None = None,
        min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
    ):
        self.headroom_fn = headroom_fn or _live_headroom
        self.tracker = tracker
        self.floor = max(0.0, float(
            floor if floor is not None
            else _env_float(_ENV_FLOOR, DEFAULT_HEADROOM_FLOOR)
        ))
        self.resume_headroom = max(self.floor, float(
            resume_headroom if resume_headroom is not None
            else _env_float(_ENV_RESUME, DEFAULT_RESUME_HEADROOM)
        ))
        self.min_interval_s = max(0.0, float(min_interval_s))
        self._lock = threading.Lock()
        self._throttled = False
        self._reason: Optional[str] = None
        self._since: Optional[float] = None
        self._last_eval = -float("inf")
        self._last_headroom: Optional[float] = None
        self._excursions = 0
        # the process-global gauge is deliberately NOT reset here: a
        # second controller constructed in-process (a replay tool, a
        # test helper, another scheduler) must not wipe a live
        # scheduler's throttle state off /metrics — gauges register at
        # 0 and only TRANSITIONS write it

    # -- the valve ---------------------------------------------------------

    def throttled(self) -> bool:
        with self._lock:
            return self._throttled

    def evaluate(self, now: float | None = None, force: bool = False) -> bool:
        """Re-read the signals and drive the throttle latch; returns
        True when bulk is admitted. Rate-limited internally (the
        signals move at sampler cadence); transitions journal exactly
        once per excursion. ``force`` skips the rate limit — the
        scheduler forces on every bulk ARRIVAL so the first submission
        after a signal collapse journals its ``bulk_throttle`` before
        any of its sets could queue (bulk arrivals are big, self-paced
        chunks; the per-arrival re-read is cheap and the rate limit
        exists for the flush loop's tight wake cadence, not for them).
        Never raises — a broken signal read must not take the flush
        thread down, and reads as 'no signal'."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if not force and now - self._last_eval < self.min_interval_s:
                return not self._throttled
            self._last_eval = now
        try:
            headroom = self.headroom_fn()
        except Exception:
            headroom = None
        try:
            latched = (
                self.tracker.latched_kinds(now)
                if self.tracker is not None else []
            )
        except Exception:
            latched = []
        fire = resume = None
        with self._lock:
            self._last_headroom = headroom
            if not self._throttled:
                reason = None
                if latched:
                    reason = "slo_burn"
                elif headroom is not None and headroom < self.floor:
                    reason = "headroom"
                if reason is not None:
                    self._throttled = True
                    self._reason = reason
                    self._since = now
                    self._excursions += 1
                    fire = reason
            else:
                # hysteresis: BOTH signals must clear, and headroom must
                # recover past resume_headroom, not just the floor
                if not latched and (
                    headroom is None or headroom >= self.resume_headroom
                ):
                    resume = round(now - (self._since or now), 3)
                    self._throttled = False
                    self._reason = None
                    self._since = None
            admitted = not self._throttled
        if fire is not None:
            _THROTTLED.set(1)
            _THROTTLE_EVENTS.with_labels(fire).inc()
            flight_recorder.record(
                "bulk_throttle",
                reason=fire,
                headroom=headroom,
                floor=self.floor,
                resume_headroom=self.resume_headroom,
                latched_kinds=",".join(latched),
            )
        elif resume is not None:
            _THROTTLED.set(0)
            flight_recorder.record(
                "bulk_resume",
                headroom=headroom,
                resume_headroom=self.resume_headroom,
                throttled_s=resume,
            )
        return admitted

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """The admission block of the scheduler's health document."""
        with self._lock:
            return {
                "throttled": self._throttled,
                "reason": self._reason,
                "throttled_s": (
                    round(time.monotonic() - self._since, 3)
                    if self._since is not None else None
                ),
                "excursions_total": self._excursions,
                "headroom_floor": self.floor,
                "resume_headroom": self.resume_headroom,
                "last_headroom": self._last_headroom,
            }
