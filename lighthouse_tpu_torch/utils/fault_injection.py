"""Deterministic fault injection for the device stack: the port's copy of
the JAX package's ``utils/fault_injection.py``.

The self-healing machinery (shard probation and recovery in
``crypto/device/mesh.py``, the scheduler's dispatch watchdog, compile
retry, key-table re-sync) is only trustworthy if its failure paths can
be driven on demand and reproducibly. This module is that seam: named
fault points compiled into the hot path (``staged_dispatch`` in
``crypto/device/bls._run_stage``, ``device_put`` in the raw and indexed
packers, ``compile`` in ``compile_service/service._compile_rung``,
``key_table_sync`` in ``crypto/device/key_table.sync``) that cost one
global check when disarmed and fire a deterministic schedule of injected
failures when armed.

Triggers, per point (call indices are 1-based, counted from arming,
after an optional ``after`` warm-in):

* ``nth=N``: fire exactly on the Nth call (one-shot unless sticky);
* ``every=K``: fire on every Kth call;
* ``p=0.3,seed=S``: seeded Bernoulli per call index; the schedule is a
  pure function of (seed, index), the JAX package's call for call;
* ``mode=sticky``: once fired, every later call fires too (a chip that
  died and stays dead), against the default one-shot or scheduled modes;
* ``count=C``: cap total injections;
* ``hang=S``: the action: instead of raising :class:`InjectedFault`,
  sleep S seconds then return (a stalled dispatch, the shape the
  scheduler's watchdog exists to reap).

Config: env ``LIGHTHOUSE_TPU_FAULTS="point:k=v,k=v;point:k=v"`` read at
import, or :func:`configure`/:func:`arm` at runtime. Every injection
ticks ``fault_injections_total{point,action}`` and journals a
``fault_injected`` flight-recorder event.

A disarmed ``fire()`` is one global check, no allocation.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional

from . import flight_recorder, metrics

# The fault-point catalogue: one entry per instrumented seam of the port.
# arm()/fire() reject unknown points so a typo cannot silently no-op a
# chaos run.
FAULT_POINTS = (
    "compile",          # compile_service/service.py, per rung warm-up
    "device_put",       # crypto/device/bls.py, raw/indexed pack upload
    "key_table_sync",   # crypto/device/key_table.py, mirror sync
    "staged_dispatch",  # crypto/device/bls.py, per staged program dispatch
)

_ENV_FAULTS = "LIGHTHOUSE_TPU_FAULTS"


class InjectedFault(RuntimeError):
    """The failure an armed fault point raises: a plain RuntimeError
    subtype, so every recovery layer handles it exactly like a real
    backend failure (nothing may special-case chaos)."""


_INJECTIONS = metrics.counter_vec(
    "fault_injections_total",
    "injected faults fired, by fault point and action (raise = "
    "InjectedFault thrown at the seam, hang = the call slept its "
    "configured stall instead)",
    ("point", "action"),
)
_ARMED_GAUGE = metrics.gauge(
    "fault_points_armed",
    "fault points currently armed (0 = the fault-injection layer is "
    "disarmed and fire() costs one global check)",
)


class _FaultPoint:
    __slots__ = (
        "point", "nth", "every", "p", "seed", "after", "hang_s",
        "sticky", "count", "calls", "injected", "tripped",
    )

    def __init__(
        self,
        point: str,
        nth: Optional[int] = None,
        every: Optional[int] = None,
        p: Optional[float] = None,
        seed: int = 0,
        after: int = 0,
        hang_s: Optional[float] = None,
        sticky: bool = False,
        count: Optional[int] = None,
    ):
        self.point = point
        self.nth = None if nth is None else int(nth)
        self.every = None if every is None else max(1, int(every))
        self.p = None if p is None else float(p)
        self.seed = int(seed)
        self.after = max(0, int(after))
        self.hang_s = None if hang_s is None else float(hang_s)
        self.sticky = bool(sticky)
        # nth without sticky is one-shot by construction; an explicit
        # count caps every other trigger shape
        self.count = None if count is None else max(0, int(count))
        self.calls = 0
        self.injected = 0
        self.tripped = False

    def scheduled(self, i: int) -> bool:
        """Pure trigger schedule for 1-based call index ``i``: no state,
        so the same spec yields the same schedule anywhere."""
        i -= self.after
        if i <= 0:
            return False
        if self.nth is not None and i == self.nth:
            return True
        if self.every is not None and i % self.every == 0:
            return True
        if self.p is not None:
            # seeded per-index Bernoulli: a pure function of
            # (seed, index), never of call interleaving
            return random.Random((self.seed << 20) ^ i).random() < self.p
        return False

    def decide(self, i: int) -> bool:
        if self.sticky and self.tripped:
            return True
        if self.count is not None and self.injected >= self.count:
            return False
        return self.scheduled(i)

    def config(self) -> dict:
        return {
            "nth": self.nth,
            "every": self.every,
            "p": self.p,
            "seed": self.seed,
            "after": self.after,
            "hang_s": self.hang_s,
            "sticky": self.sticky,
            "count": self.count,
        }


_lock = threading.Lock()
_points: Dict[str, _FaultPoint] = {}
_armed = False  # the single global the disarmed fire() checks


def fire(point: str) -> None:
    """The hot-path hook compiled into every fault seam. Disarmed this is
    one global check; armed it advances the point's call counter and
    either returns, raises :class:`InjectedFault`, or sleeps the
    configured hang."""
    if not _armed:
        return
    with _lock:
        fpt = _points.get(point)
        if fpt is None:
            if point not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {point!r}; declare it in "
                    f"fault_injection.FAULT_POINTS"
                )
            return
        fpt.calls += 1
        i = fpt.calls
        trig = fpt.decide(i)
        if trig:
            fpt.injected += 1
            fpt.tripped = True
        hang_s = fpt.hang_s
    if not trig:
        return
    action = "hang" if hang_s else "raise"
    _INJECTIONS.with_labels(point, action).inc()
    flight_recorder.record(
        "fault_injected",
        point=point,
        call=i,
        action=action,
        hang_s=hang_s,
    )
    if hang_s:
        time.sleep(hang_s)
        return
    raise InjectedFault(f"injected fault at {point!r} (call {i})")


def arm(point: str, **kwargs) -> None:
    """Arm one fault point (see the module docstring for the trigger
    grammar). Re-arming a point replaces its spec and resets its
    counters."""
    if point not in FAULT_POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; have {FAULT_POINTS}"
        )
    global _armed
    with _lock:
        _points[point] = _FaultPoint(point, **kwargs)
        _armed = True
        _ARMED_GAUGE.set(len(_points))


def clear(point: Optional[str] = None) -> None:
    """Disarm one point (or all of them); the global flag drops as soon
    as nothing is armed, restoring the one-check disabled path."""
    global _armed
    with _lock:
        if point is None:
            _points.clear()
        else:
            _points.pop(point, None)
        _armed = bool(_points)
        _ARMED_GAUGE.set(len(_points))


def armed() -> bool:
    return _armed


def schedule(n_calls: int, **kwargs) -> list:
    """The deterministic trigger schedule a spec would produce for calls
    1..n (sticky expansion included)."""
    fpt = _FaultPoint("schedule", **kwargs)
    out = []
    tripped = False
    fired = 0
    for i in range(1, n_calls + 1):
        hit = (fpt.sticky and tripped) or (
            (fpt.count is None or fired < fpt.count) and fpt.scheduled(i)
        )
        if hit:
            tripped = True
            fired += 1
        out.append(hit)
    return out


def status() -> dict:
    """Every armed point's calls, injections, trip state and config."""
    with _lock:
        return {
            "armed": _armed,
            "points": {
                name: {
                    "calls": fpt.calls,
                    "injected": fpt.injected,
                    "tripped": fpt.tripped,
                    "config": fpt.config(),
                }
                for name, fpt in sorted(_points.items())
            },
        }


# ---------------------------------------------------------------------------
# Spec parsing (env): "point:k=v,k=v;point:k=v"
# ---------------------------------------------------------------------------

_KEYS = {
    "nth": int,
    "every": int,
    "p": float,
    "seed": int,
    "after": int,
    "hang": float,   # spelled hang= in specs, hang_s in arm()
    "count": int,
    "mode": str,     # oneshot | sticky
}


def parse_spec(spec: str) -> Dict[str, dict]:
    """``{point: arm_kwargs}`` from a spec string; raises ValueError on
    malformed input (a chaos run with a typo'd spec must fail loudly,
    not silently run fault-free)."""
    out: Dict[str, dict] = {}
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        if ":" not in chunk:
            raise ValueError(f"fault spec chunk {chunk!r} has no point:")
        point, _, body = chunk.partition(":")
        point = point.strip()
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; have {FAULT_POINTS}"
            )
        kwargs: dict = {}
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, _, val = kv.partition("=")
            key = key.strip()
            caster = _KEYS.get(key)
            if caster is None:
                raise ValueError(
                    f"unknown fault spec key {key!r} in {chunk!r}; "
                    f"have {sorted(_KEYS)}"
                )
            if key == "mode":
                if val not in ("oneshot", "sticky"):
                    raise ValueError(f"mode must be oneshot|sticky: {kv!r}")
                kwargs["sticky"] = val == "sticky"
            elif key == "hang":
                kwargs["hang_s"] = caster(val)
            else:
                kwargs[key] = caster(val)
        out[point] = kwargs
    return out


def configure(spec: str) -> None:
    """Parse and arm a whole spec string (the env entry point)."""
    for point, kwargs in parse_spec(spec).items():
        arm(point, **kwargs)


_env_spec = os.environ.get(_ENV_FAULTS, "").strip()
if _env_spec:
    configure(_env_spec)
