"""Flight recorder: a bounded, thread-safe event journal for failure
forensics (reference: Lighthouse pairs its metric families with
structured slog events — ``common/logging`` — so a counter tick never
loses its context; committee-BLS measurement work shows per-batch
context, not aggregates, explains verifier tail latency).

The metrics registry answers "how much, how often"; trace spans answer
"where did the wall-clock go"; this module answers "what exactly
happened around THIS failure": every staged device verify, gossip
rejection, queue shed and peer ban appends one structured event to a
fixed-capacity ring, and on a verify failure or crit-level log the
whole ring can be snapshotted to a JSON artifact. The port's own copy of
the JAX package's ``utils/flight_recorder.py``: the same API, dump schema
and env knobs, its own ring.

Design constraints (same discipline as :mod:`utils.tracing`):

* DISABLED recording must cost well under 1 microsecond per call —
  ``record()`` returns after one global check, no allocation.
* Enabled recording is O(1): one ring-slot write under one lock, no
  I/O. Capacity is fixed; old events are overwritten, never reallocated.
* Every event kind is declared in :data:`EVENT_KINDS`; ``record()``
  rejects unknown kinds so a typo cannot silently fork the catalogue.
* Dump-on-failure is opt-in (``LIGHTHOUSE_TPU_FLIGHT_DUMP=1``) and
  rate-limited: test suites induce failures constantly, and forensics
  must never become an I/O amplifier on the hot path.

Env knobs (all read at import; :func:`configure` overrides at runtime):

    LIGHTHOUSE_TPU_FLIGHT_RECORDER          1|0   record events (default 1)
    LIGHTHOUSE_TPU_FLIGHT_CAPACITY          int   ring capacity (default 4096)
    LIGHTHOUSE_TPU_FLIGHT_DUMP              1|0   dump_on_failure writes (default 0)
    LIGHTHOUSE_TPU_FLIGHT_DIR               path  dump directory
    LIGHTHOUSE_TPU_FLIGHT_RETAIN            int   dump files kept (default 8)
    LIGHTHOUSE_TPU_FLIGHT_DUMP_INTERVAL_S   float min seconds between dumps (default 30)
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Callable, Iterable, List, Optional

from . import metrics

SCHEMA = "lighthouse_tpu.flight_recorder/1"
DUMP_PREFIX = "lighthouse_tpu_flight_"

# The event-kind catalogue: one entry per producer call site family in the
# port, snake_case. The JAX package's other kinds arrive with their
# producers.
EVENT_KINDS = (
    "attestation_rejected",   # beacon_chain/attestation_verification.py
    "block_rejected",         # beacon_chain/block_verification.py
    "bls_stage_verify",       # crypto/device/bls.py, one per staged verify
    "bulk_resume",            # verification_service/admission.py, excursion end
    "bulk_throttle",          # verification_service/admission.py, bulk paused
    "cold_route",             # compile_service/service.py, cold-bucket flush
    "compile_failed",         # compile_service/service.py, per failed rung
    "compile_ready",          # compile_service/service.py, rung now warm
    "compile_retry",          # compile_service/service.py, failed rung re-queued
    "compile_started",        # compile_service/service.py, per AOT rung
    "deadline_miss",          # verification_service/batcher.py, SLO miss
    "fault_injected",         # utils/fault_injection.py, one per injected fault
    "incident_opened",        # utils/watchtower.py, detector latched an incident
    "incident_resolved",      # utils/watchtower.py, breach cleared + duration
    "key_table_reset",        # crypto/device/key_table.py, agg region recycle
    "key_table_sync",         # crypto/device/key_table.py, startup/delta rows
    "log",                    # utils/logging.py, warn/error/crit lines
    "lookahead_epoch_warmed",  # duty_lookahead/, one per warmed epoch
    "lookahead_insert_failed",  # duty_lookahead/, per failed pre-insert
    "op_pool_device_agg",     # operation_pool/device_agg.py, per device merge
    "pipeline_flush",         # utils/pipeline_profiler.py, one per flush
    "queue_shed",             # beacon_processor/processor.py
    "scheduler_bisection",    # verification_service/batcher.py, per split
    "scheduler_flush",        # verification_service/batcher.py, per batch
    "scheduler_plan",         # verification_service/batcher.py, per flush plan
    "scheduler_shed",         # verification_service/batcher.py, backpressure
    "shard_dispatch",         # verification_service/batcher.py, dp sub-batch
    "shard_lost",             # crypto/device/mesh.py, chip dropped from axis
    "shard_probation",        # crypto/device/mesh.py, probation entry/failed probe
    "shard_recovered",        # crypto/device/mesh.py, chip re-admitted to axis
    "slo_burn",               # verification_service/slo.py, budget burn alert
    "sync_rejected",          # beacon_chain/sync_committee_verification.py
    "transfer_ledger",        # utils/transfer_ledger.py, one per verify
    "watchdog_reaped",        # verification_service/batcher.py, hung dispatch
)
_KINDS = frozenset(EVENT_KINDS)

_EVENTS_TOTAL = metrics.counter_vec(
    "flight_recorder_events_total",
    "journal events recorded, by event kind",
    ("kind",),
)
_DUMPS_TOTAL = metrics.counter_vec(
    "flight_recorder_dumps_total",
    "journal snapshots written to disk, by trigger",
    ("trigger",),
)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


_enabled = os.environ.get("LIGHTHOUSE_TPU_FLIGHT_RECORDER", "1") not in ("", "0")
_capacity = max(1, _env_int("LIGHTHOUSE_TPU_FLIGHT_CAPACITY", 4096))
_dump_on_failure = os.environ.get("LIGHTHOUSE_TPU_FLIGHT_DUMP", "0") not in ("", "0")
_dump_dir = os.environ.get("LIGHTHOUSE_TPU_FLIGHT_DIR") or os.path.join(
    tempfile.gettempdir(), "lighthouse_tpu_flight"
)
_retain = max(1, _env_int("LIGHTHOUSE_TPU_FLIGHT_RETAIN", 8))
_min_dump_interval_s = _env_float("LIGHTHOUSE_TPU_FLIGHT_DUMP_INTERVAL_S", 30.0)

_lock = threading.Lock()
_ring: List[Optional[dict]] = [None] * _capacity
_seq = 0  # total events ever recorded; ring slot = seq % capacity

_dump_lock = threading.Lock()
_last_dump = -float("inf")

_subscribers: List[Callable[[dict], None]] = []
_tls = threading.local()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, (bytes, bytearray)):
        return "0x" + bytes(v).hex()
    return str(v)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def record(kind: str, /, **fields) -> None:
    """Append one structured event to the ring. O(1); when disabled this
    is a single global check (< 1 µs, pinned by the gate test)."""
    if not _enabled:
        return
    if kind not in _KINDS:
        raise ValueError(
            f"unknown flight-recorder event kind {kind!r}; declare it in "
            f"EVENT_KINDS"
        )
    ev = {
        "t": time.time(),
        "thread": threading.current_thread().name,
        "kind": kind,
        "fields": {k: _jsonable(v) for k, v in fields.items()},
    }
    global _seq
    with _lock:
        ev["seq"] = _seq
        _ring[_seq % _capacity] = ev
        _seq += 1
    _EVENTS_TOTAL.with_labels(kind).inc()
    if kind.endswith("_rejected"):
        # chain-time attribution: every journal rejection lands on its
        # slot's report card (utils.slot_ledger imports neither this
        # module nor torch: no cycle)
        from . import slot_ledger

        slot_ledger.note_rejection(kind)
    if _subscribers:
        _notify(ev)


def _notify(ev: dict) -> None:
    """Invoke subscribers outside the ring lock. Re-entrant records (a
    subscriber that logs, and logging that journals) append normally but
    do NOT re-notify — bounds any record->subscriber->record loop."""
    if getattr(_tls, "notifying", False):
        return
    _tls.notifying = True
    try:
        for fn in list(_subscribers):
            try:
                fn(ev)
            except Exception:
                pass  # a broken subscriber must never break the producer
    finally:
        _tls.notifying = False


def subscribe(fn: Callable[[dict], None]) -> None:
    """Register a callback invoked (outside the ring lock) for every
    recorded event — the wiring surface for e.g. the validator monitor.
    NOTE: disabling the recorder (``LIGHTHOUSE_TPU_FLIGHT_RECORDER=0``)
    silences subscribers too — validator-monitor failure tracking rides
    on the journal, so that knob trades it away along with the ring."""
    if fn not in _subscribers:
        _subscribers.append(fn)


def unsubscribe(fn: Callable[[dict], None]) -> None:
    try:
        _subscribers.remove(fn)
    except ValueError:
        pass


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def events(kinds: Iterable[str] | None = None, limit: int | None = None) -> List[dict]:
    """Journal contents, oldest first; optionally filtered to ``kinds``
    and truncated to the newest ``limit`` (after filtering)."""
    with _lock:
        n = min(_seq, _capacity)
        start = _seq - n
        evs = [_ring[i % _capacity] for i in range(start, _seq)]
    if kinds is not None:
        kindset = set(kinds)
        evs = [e for e in evs if e["kind"] in kindset]
    if limit is not None:
        # -0: would mean "everything" — a 0/negative limit means none
        evs = evs[-limit:] if limit > 0 else []
    return evs


def status() -> dict:
    """One-line health of the recorder itself (the /lighthouse surfaces)."""
    with _lock:
        seq, cap = _seq, _capacity
    return {
        "enabled": _enabled,
        "capacity": cap,
        "recorded_total": seq,
        "dropped": max(0, seq - cap),
        "dump_on_failure": _dump_on_failure,
        "dump_dir": _dump_dir,
    }


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def clear() -> None:
    """Drop every recorded event (capacity unchanged) and reset the
    dump rate-limit clock."""
    global _seq, _last_dump
    with _lock:
        for i in range(_capacity):
            _ring[i] = None
        _seq = 0
    with _dump_lock:
        _last_dump = -float("inf")


def configure(
    capacity: int | None = None,
    enabled: bool | None = None,
    dump: bool | None = None,
    dump_dir: str | None = None,
    retain: int | None = None,
    min_dump_interval_s: float | None = None,
) -> dict:
    """Override settings at runtime; returns the PREVIOUS values of every
    settable knob so callers (tests) can restore with ``configure(**prev)``.
    Changing ``capacity`` reallocates and clears the ring."""
    global _capacity, _ring, _seq, _enabled, _dump_on_failure
    global _dump_dir, _retain, _min_dump_interval_s
    prev = {
        "capacity": _capacity,
        "enabled": _enabled,
        "dump": _dump_on_failure,
        "dump_dir": _dump_dir,
        "retain": _retain,
        "min_dump_interval_s": _min_dump_interval_s,
    }
    if capacity is not None and capacity != _capacity:
        with _lock:
            _capacity = max(1, int(capacity))
            _ring = [None] * _capacity
            _seq = 0
    if enabled is not None:
        _enabled = bool(enabled)
    if dump is not None:
        _dump_on_failure = bool(dump)
    if dump_dir is not None:
        _dump_dir = dump_dir
    if retain is not None:
        _retain = max(1, int(retain))
    if min_dump_interval_s is not None:
        _min_dump_interval_s = float(min_dump_interval_s)
    return prev


# ---------------------------------------------------------------------------
# Dumping
# ---------------------------------------------------------------------------


def snapshot(trigger: str | None = None, context: dict | None = None) -> dict:
    """The dump document: recorder state + every journal event, plus the
    triggering context. Stable schema (``SCHEMA``, the JAX package's) so
    forensics tooling can rely on it."""
    evs = events()
    with _lock:
        seq, cap = _seq, _capacity
    now = time.time()  # one clock read: seconds and ms must agree
    return {
        "schema": SCHEMA,
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(now))
        + f".{int(now * 1000) % 1000:03d}Z",
        "pid": os.getpid(),
        "trigger": trigger,
        "context": {k: _jsonable(v) for k, v in (context or {}).items()},
        "capacity": cap,
        "recorded_total": seq,
        "dropped": max(0, seq - cap),
        "events": evs,
    }


def dump(trigger: str, /, path: str | None = None, **context) -> str:
    """Write the journal snapshot to ``path`` (default: a fresh file in
    the dump directory) and apply retention. Returns the path written."""
    doc = snapshot(trigger, context)
    if path is None:
        os.makedirs(_dump_dir, exist_ok=True)
        path = os.path.join(
            _dump_dir,
            f"{DUMP_PREFIX}{int(time.time() * 1000):013d}_{doc['recorded_total']:08d}_{trigger}.json",
        )
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    _DUMPS_TOTAL.with_labels(trigger).inc()
    _apply_retention()
    return path


def dump_on_failure(trigger: str, /, **context) -> str | None:
    """Snapshot the journal on a failure signal (staged verify returned
    False, block signature batch failed, crit-level log). No-op unless
    dumping is enabled; rate-limited to one dump per
    ``min_dump_interval_s`` so induced-failure storms (test suites,
    attack traffic) cannot turn forensics into an I/O amplifier."""
    global _last_dump
    if not (_enabled and _dump_on_failure):
        return None
    with _dump_lock:
        if time.monotonic() - _last_dump < _min_dump_interval_s:
            return None
        try:
            path = dump(trigger, **context)
        except OSError as e:
            # no logging here: utils.logging journals into this module.
            # The window is NOT consumed: a failed write (full disk, bad
            # dir) must not suppress the next genuine failure's dump.
            print(f"flight_recorder: dump failed: {e!r}", file=sys.stderr)
            return None
        _last_dump = time.monotonic()
        return path


def _apply_retention() -> None:
    """Keep only the newest ``retain`` dump files in the dump directory
    (names embed a ms timestamp, so lexicographic order is age order)."""
    try:
        names = sorted(
            n for n in os.listdir(_dump_dir) if n.startswith(DUMP_PREFIX)
        )
        for n in names[: max(0, len(names) - _retain)]:
            os.remove(os.path.join(_dump_dir, n))
    except OSError:
        pass
