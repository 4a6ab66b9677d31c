"""Duty-lookahead precompute: the port of the JAX package's
``duty_lookahead/__init__.py``.

Committee shuffles are deterministic an epoch ahead
(``state_transition/helpers.py`` — the attester seed reaches back
``MIN_SEED_LOOKAHEAD`` epochs), yet the key table's aggregate cache is
purely reactive: a committee's FIRST sighting pays hundreds of
pure-Python EC adds on a verifier thread, and only the second-plus
sighting ships the collapsed K=1 row. The
``key_table_first_sighting_hit_ratio`` measured ~0.81 on the
epoch-boundary flood — one in five committee batches paying the
host-sum worst case exactly when traffic peaks. This module closes
that window with the precomputed-key-store pattern the FPGA
verification-engine paper applies to certificates (PAPERS.md, arxiv
2112.02229), lifted to aggregate rows:

* a **builder-owned background worker** (:class:`DutyLookahead`) that
  watches the process-global slot clock (``utils/slot_clock.py`` — so
  replay-installed clocks drive it too) and, past a configurable
  trigger point inside the current epoch (default: halfway), walks the
  NEXT epoch's shuffle via a pluggable **duty source** (the client
  wires :func:`chain_duty_source` — one ``CommitteeCache`` per epoch,
  never a per-(slot, index) ``get_beacon_committee`` rebuild; the
  replay harness wires a trace-derived source);
* each committee's validator-index tuple resolves against the host
  ``ValidatorPubkeyCache`` and its aggregate-sum G1 row is computed
  OFF the hot path — the windowed device MSM (all-one scalars,
  ``crypto/device/bls.py::device_msm_g1`` on the lookahead's
  ``device``, ``cuda`` unless the caller asks for the CPU) when the
  device sum is on, else the host EC fold, each path counted —
  then pre-inserted through
  ``DeviceKeyTable.insert_precomputed``, which bypasses
  ``agg_min_repeats`` for lookahead-sourced tuples (the reactive
  path's admission rules are untouched) so the committee's first
  sighting already ships K=1 with zero host EC adds inside any verify
  span;
* worker lifecycle reuses the key table's ``sync_or_schedule`` shape: one
  worker thread, capped exponential backoff with jitter on repeated
  failure (each retry IS the probation probe), clean :meth:`stop`,
  and a ``duty_lookahead`` fault-injection point so the failure paths
  are drivable on demand.

Surfaces follow the house pattern: ``duty_lookahead_*`` metric
families, ``lookahead_epoch_warmed`` / ``lookahead_insert_failed``
journal kinds, a ``duty_lookahead`` block in ``/lighthouse/health``,
and chain-time attribution of the precompute work into the slot
ledger (``note_lookahead`` — the cost lands in the quiet mid-epoch
slots that paid it, visibly OUTSIDE every verify span).

torch-free at import (the replay driver imports this module on boxes
that must not initialize a backend); the device sum path imports
lazily. A device failure on the card fails the epoch's warm (journaled,
retried after a backoff) and is never served by the host fold; only a
caller that asked for the CPU falls back to it.

Env knobs (read at import; :func:`configure` overrides at runtime):

    LIGHTHOUSE_TPU_DUTY_LOOKAHEAD               1|0    (default 1)
    LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_TRIGGER_FRAC  float  (default 0.5)
    LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_POLL_S        float  (default 1.0)
    LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_BACKOFF_BASE_S float (default 1.0)
    LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_BACKOFF_MAX_S float  (default 60.0)
    LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_DEVICE_SUM    1|0    (default 1)
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

from ..utils import fault_injection, flight_recorder, metrics, slot_clock
from ..utils import slot_ledger

_ENV_ENABLED = "LIGHTHOUSE_TPU_DUTY_LOOKAHEAD"
_ENV_TRIGGER = "LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_TRIGGER_FRAC"
_ENV_POLL = "LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_POLL_S"
_ENV_BACKOFF_BASE = "LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_BACKOFF_BASE_S"
_ENV_BACKOFF_MAX = "LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_BACKOFF_MAX_S"
_ENV_DEVICE_SUM = "LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_DEVICE_SUM"

DEFAULT_TRIGGER_FRAC = 0.5
DEFAULT_POLL_S = 1.0
DEFAULT_BACKOFF_BASE_S = 1.0
DEFAULT_BACKOFF_MAX_S = 60.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def env_enabled() -> bool:
    return os.environ.get(_ENV_ENABLED, "1") not in ("", "0")


def env_device_sum() -> bool:
    return os.environ.get(_ENV_DEVICE_SUM, "1") not in ("", "0")


# ---------------------------------------------------------------------------
# Telemetry (documented in docs/OBSERVABILITY.md, linted by
# tests/test_zgate4_metrics_lint.py)
# ---------------------------------------------------------------------------

_EPOCHS = metrics.counter_vec(
    "duty_lookahead_epochs_total",
    "lookahead epoch warm attempts by outcome: warmed = the next "
    "epoch's committees were walked and pre-inserted, empty = the duty "
    "source yielded no committees (warm still counts as done for the "
    "epoch), error = the attempt raised and the backoff timer armed",
    ("outcome",),
)
_COMMITTEES = metrics.counter_vec(
    "duty_lookahead_committees_total",
    "committees processed by the lookahead, by sum path: device = "
    "aggregate row produced by the windowed device MSM (all-one "
    "scalars), host = pure-Python EC fold fallback, virtual = no key "
    "table attached (replay/model mode — admission prewarmed, no row "
    "computed), failed = pubkey resolution or pre-insert declined",
    ("path",),
)
_INSERTS = metrics.counter_vec(
    "duty_lookahead_inserts_total",
    "key-table pre-insert outcomes (DeviceKeyTable.insert_precomputed "
    "return values: inserted, exists, infinity, never_cache, full, "
    "unsynced, disabled)",
    ("outcome",),
)
_WARM_SECONDS = metrics.gauge(
    "duty_lookahead_warm_seconds",
    "wall seconds the most recent epoch warm took (resolve + sum + "
    "pre-insert, all off the hot path)",
)


DutySource = Callable[[int], Iterable[Sequence[int]]]


def chain_duty_source(chain) -> DutySource:
    """Duty source over a live chain: ONE ``CommitteeCache`` built per
    queried epoch from the head state (the shuffle is a pure function
    of (state, epoch) and the attester seed reaches back
    ``MIN_SEED_LOOKAHEAD`` epochs, so the next epoch's assignment is
    already determined), yielding every (slot, index) committee's
    validator-index tuple."""

    def source(epoch: int) -> Iterable[Tuple[int, ...]]:
        from ..state_transition.helpers import CommitteeCache

        state = chain.head_state
        cache = CommitteeCache(chain.preset, state, int(epoch))
        start = int(epoch) * chain.preset.SLOTS_PER_EPOCH
        for slot in range(start, start + chain.preset.SLOTS_PER_EPOCH):
            for index in range(cache.committees_per_slot):
                committee = cache.committee(slot, index)
                if len(committee) > 1:
                    yield tuple(int(v) for v in committee)

    return source


class DutyLookahead:
    """The background precompute worker (see module docstring).

    ``duty_source(epoch)`` yields validator-index tuples for that
    epoch's committees. ``key_table`` / ``pubkey_cache`` may both be
    None (replay/model mode): the worker then only counts committees
    and fires ``on_warmed`` — the harness prewarms its sighting model
    there — without touching a device. ``on_warmed(epoch, committees)``
    is called after every successful warm."""

    def __init__(
        self,
        duty_source: DutySource,
        key_table=None,
        pubkey_cache=None,
        *,
        trigger_frac: Optional[float] = None,
        poll_s: Optional[float] = None,
        backoff_base_s: Optional[float] = None,
        backoff_max_s: Optional[float] = None,
        device_sum: Optional[bool] = None,
        on_warmed: Optional[Callable[[int, list], None]] = None,
        device="cuda",
    ):
        self.duty_source = duty_source
        self.key_table = key_table
        self.pubkey_cache = pubkey_cache
        self.trigger_frac = min(0.95, max(0.0, (
            _env_float(_ENV_TRIGGER, DEFAULT_TRIGGER_FRAC)
            if trigger_frac is None else float(trigger_frac)
        )))
        self.poll_s = max(0.05, (
            _env_float(_ENV_POLL, DEFAULT_POLL_S)
            if poll_s is None else float(poll_s)
        ))
        self.backoff_base_s = max(0.01, (
            _env_float(_ENV_BACKOFF_BASE, DEFAULT_BACKOFF_BASE_S)
            if backoff_base_s is None else float(backoff_base_s)
        ))
        self.backoff_max_s = max(self.backoff_base_s, (
            _env_float(_ENV_BACKOFF_MAX, DEFAULT_BACKOFF_MAX_S)
            if backoff_max_s is None else float(backoff_max_s)
        ))
        self.device_sum = (
            env_device_sum() if device_sum is None else bool(device_sum)
        )
        self.on_warmed = on_warmed
        self.device = device
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warmed_epoch: Optional[int] = None
        self._failures = 0           # consecutive warm failures
        self._backoff_until = 0.0    # monotonic deadline of the pause
        self._last_error: Optional[str] = None
        self._last_warm_s: Optional[float] = None
        self._epochs = {"warmed": 0, "empty": 0, "error": 0}
        self._committees = {"device": 0, "host": 0, "virtual": 0,
                            "failed": 0}
        self._inserts: Dict[str, int] = {}

    # -- lifecycle (the key table's worker shape) -------------------------

    def start(self) -> "DutyLookahead":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            t = threading.Thread(
                target=self._run, name="duty-lookahead", daemon=True
            )
            self._thread = t
        t.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Clean stop: signal, then a bounded join — stop() during an
        in-flight warm must never wedge the client's shutdown."""
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=timeout)

    close = stop  # the Client.stop() idiom other workers expose

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                pass  # tick() accounts its own failures; never die
            self._stop.wait(self.poll_s)

    # -- trigger policy ----------------------------------------------------

    def epoch_fraction(self) -> float:
        """How far into the current epoch the process-global clock is
        (0.0 at the epoch's first slot boundary, →1.0 at its end)."""
        clock = slot_clock.get_clock()
        slot = clock.now()
        into_epoch = slot - clock.first_slot_of_epoch(clock.epoch_of(slot))
        sub_slot = 0.0
        if clock.seconds_per_slot > 0:
            sub_slot = clock.seconds_into_slot() / clock.seconds_per_slot
        return min(1.0, (into_epoch + sub_slot) / clock.slots_per_epoch)

    def tick(self) -> Optional[dict]:
        """One poll: warm the NEXT epoch once the trigger point inside
        the current epoch has passed (and the backoff pause, if a prior
        attempt failed, has expired). Idempotent per target epoch."""
        if self._stop.is_set():
            return None
        clock = slot_clock.get_clock()
        target = clock.current_epoch() + 1
        with self._lock:
            if self._warmed_epoch is not None and target <= self._warmed_epoch:
                return None
            if time.monotonic() < self._backoff_until:
                return None
        if self.epoch_fraction() < self.trigger_frac:
            return None
        return self.warm_epoch(target)

    # -- the warm ----------------------------------------------------------

    def warm_epoch(self, epoch: int) -> Optional[dict]:
        """Walk ``epoch``'s committees and pre-insert their aggregate
        rows. The synchronous core the worker thread calls — and the
        seam replays drive directly (no thread, deterministic). On
        failure: error journal + capped exponential backoff with
        jitter; each expiry's retry is the probation probe."""
        epoch = int(epoch)
        t0 = time.perf_counter()
        try:
            fault_injection.fire("duty_lookahead")
            committees = [
                tuple(int(v) for v in c)
                for c in self.duty_source(epoch)
                if len(c) > 1
            ]
            counts = {"device": 0, "host": 0, "virtual": 0, "failed": 0}
            inserts: Dict[str, int] = {}
            for idxs in committees:
                path = self._warm_one(idxs, epoch, inserts)
                counts[path] += 1
        except Exception as e:
            wall = time.perf_counter() - t0
            with self._lock:
                self._failures += 1
                fails = self._failures
                delay = min(
                    self.backoff_max_s,
                    self.backoff_base_s * (2.0 ** (fails - 1)),
                ) * random.uniform(0.5, 1.0)
                self._backoff_until = time.monotonic() + delay
                self._last_error = repr(e)[:200]
                self._epochs["error"] += 1
            _EPOCHS.with_labels("error").inc()
            flight_recorder.record(
                "lookahead_insert_failed",
                epoch=epoch,
                reason="warm_error",
                error=repr(e)[:200],
                failures=fails,
                backoff_s=round(delay, 3),
            )
            from ..utils import logging as tlog

            tlog.log(
                "warn", "duty-lookahead epoch warm failed",
                epoch=epoch, failures=fails, delay_s=round(delay, 3),
                error=repr(e)[:120],
            )
            return None
        wall = time.perf_counter() - t0
        warmed = counts["device"] + counts["host"] + counts["virtual"]
        outcome = "warmed" if committees else "empty"
        with self._lock:
            self._failures = 0
            self._backoff_until = 0.0
            self._last_warm_s = wall
            if self._warmed_epoch is None or epoch > self._warmed_epoch:
                self._warmed_epoch = epoch
            self._epochs[outcome] += 1
            for k, v in counts.items():
                self._committees[k] += v
            for k, v in inserts.items():
                self._inserts[k] = self._inserts.get(k, 0) + v
        _EPOCHS.with_labels(outcome).inc()
        for k, v in counts.items():
            if v:
                _COMMITTEES.with_labels(k).inc(v)
        for k, v in inserts.items():
            _INSERTS.with_labels(k).inc(v)
        _WARM_SECONDS.set(round(wall, 6))
        # chain-time attribution: the precompute cost
        # lands in the slot that PAID it — outside every verify span
        slot_ledger.note_lookahead(
            committees=warmed,
            host_sums=counts["host"],
            device_sums=counts["device"],
        )
        flight_recorder.record(
            "lookahead_epoch_warmed",
            epoch=epoch,
            committees=len(committees),
            warmed=warmed,
            device_sums=counts["device"],
            host_sums=counts["host"],
            virtual=counts["virtual"],
            failed=counts["failed"],
            wall_s=round(wall, 6),
        )
        if self.on_warmed is not None:
            try:
                self.on_warmed(epoch, committees)
            except Exception:
                pass
        return {
            "epoch": epoch,
            "committees": len(committees),
            "counts": counts,
            "inserts": dict(inserts),
            "wall_s": wall,
        }

    def _warm_one(
        self, idxs: Tuple[int, ...], epoch: int, inserts: Dict[str, int]
    ) -> str:
        """Resolve + sum + pre-insert ONE committee; returns the sum
        path ('device' | 'host' | 'virtual' | 'failed')."""
        if self.key_table is None or self.pubkey_cache is None:
            # replay/model mode: admission is prewarmed via on_warmed,
            # no row exists to compute
            return "virtual"
        try:
            points = [self.pubkey_cache.get(i).point for i in idxs]
        except Exception as e:
            self._journal_insert_failed(epoch, idxs, "unresolved", e)
            return "failed"
        point, path = self._sum_points(points)
        outcome = self.key_table.insert_precomputed(idxs, point, epoch=epoch)
        inserts[outcome] = inserts.get(outcome, 0) + 1
        if outcome in ("inserted", "exists", "infinity", "never_cache"):
            # infinity/never_cache are terminal decisions, not failures:
            # the device agg_inf_bad screen owns that edge by design
            return path
        self._journal_insert_failed(epoch, idxs, outcome, None)
        return "failed"

    def _sum_points(self, points) -> Tuple[object, str]:
        """The committee's aggregate G1 sum: device windowed MSM with
        all-one scalars when enabled (same rung ladder as the op-pool
        aggregator), else the host EC fold. A device failure on the card
        raises, so :meth:`warm_epoch` fails the epoch loudly (error
        journal, ``last_error``, backoff); on a caller that asked for the
        CPU the error is kept in ``last_error`` and the host fold serves,
        counted ``host``, as in the JAX package."""
        if self.device_sum and len(points) > 1:
            try:
                from ..compile_service.service import MSM_RUNGS
                from ..crypto.device import bls as dbls

                pad_n = None
                for r in sorted(MSM_RUNGS):
                    if r >= len(points):
                        pad_n = r
                        break
                out = dbls.device_msm_g1(
                    points, [1] * len(points), pad_n=pad_n,
                    device=self.device,
                )
                return out, "device"
            except Exception as e:
                import torch

                if torch.device(self.device).type == "cuda":
                    raise
                with self._lock:
                    self._last_error = repr(e)[:200]
        agg = points[0]
        for p in points[1:]:
            agg = agg + p
        return agg, "host"

    def _journal_insert_failed(
        self, epoch: int, idxs, reason: str, error
    ) -> None:
        _COMMITTEES.with_labels("failed").inc(0)  # family present early
        flight_recorder.record(
            "lookahead_insert_failed",
            epoch=epoch,
            committee_size=len(idxs),
            reason=reason,
            error=None if error is None else repr(error)[:200],
        )

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """The ``/lighthouse/health`` ``duty_lookahead`` block."""
        with self._lock:
            backoff_s = max(0.0, self._backoff_until - time.monotonic())
            return {
                "running": self._thread is not None,
                "trigger_frac": self.trigger_frac,
                "poll_s": self.poll_s,
                "device_sum": self.device_sum,
                "warmed_epoch": self._warmed_epoch,
                "epochs": dict(self._epochs),
                "committees": dict(self._committees),
                "inserts": dict(self._inserts),
                "failures": self._failures,
                "backoff_s": round(backoff_s, 3),
                "last_error": self._last_error,
                "last_warm_s": (
                    None if self._last_warm_s is None
                    else round(self._last_warm_s, 6)
                ),
            }


# ---------------------------------------------------------------------------
# Module-level config seam (tests / replay drivers)
# ---------------------------------------------------------------------------

_cfg_lock = threading.Lock()
_enabled = env_enabled()


def enabled() -> bool:
    return _enabled


def configure(enabled: Optional[bool] = None) -> dict:
    """Runtime override of the env default; returns the PREVIOUS values
    so callers restore with ``configure(**prev)``."""
    global _enabled
    with _cfg_lock:
        prev = {"enabled": _enabled}
        if enabled is not None:
            _enabled = bool(enabled)
    return prev
