"""Served data-parallel device mesh for the staged BLS verifier: the
port's counterpart of the JAX package's ``crypto/device/mesh.py``.

A process-global :class:`DeviceMesh` that the flush planner, the
scheduler, the compile service and the key table all consult to spread
independent sub-batches across cards (data-parallel over signature
sets).

Shards are whole sub-batches, not sharded tensors: the flush planner
already emits kind-homogeneous, independently dispatchable sub-batches,
so the dp axis is a second packing axis ((dp shard x rung) plans). Each
shard's sub-batch packs, ships and verifies on its own device under a
thread-local dispatch scope (:func:`dispatch_to`, which enters
``torch.cuda.device`` for a CUDA shard); no collective ever runs, so
losing a card degrades to fewer shards instead of killing the node: the
planner drops that shard, and an in-flight sub-batch on the lost device
re-verifies on a failover shard (the re-verify is the verdict).

Health: per-card sets/s over a rolling window, failure counts,
lost/healthy state and per-card ``device_memory_bytes`` feed the
``bls_device_shard_*`` families; transitions journal ``shard_lost``.
:meth:`DeviceMesh.status` reads each shard's ``bubble_ratio`` from the
pipeline profiler (whose ``bls_device_shard_busy_seconds_total`` counts
each shard's staged dispatches), and the capacity estimator
(``utils/timeseries.py``) reads :func:`healthy_shard_count`.

Self-healing: a lost shard enters probation. A background recovery
worker (:meth:`DeviceMesh.start_recovery`) probes it on a capped
exponential backoff with jitter (``base * 2**(attempt-1)`` capped,
times ``U[0.5, 1.0]``). One probe is a canary on the card (a tiny
computation on the shard's device, or an injected ``probe_fn``), then a
best-effort re-warm of the compile service's rungs on that shard (warm
rungs are skipped: the graphs survived the loss), then a key-table
re-sync (a failure fails the probe: a shard never re-joins with a stale
replica), then re-admission. Every transition journals
(``shard_probation`` per entry or failed probe with the next backoff,
``shard_recovered`` on re-admission).

Discovery reads ``torch.cuda.device_count()``. An explicit device list
(``torch.device`` objects or their names, CPU devices included) or
``None`` placeholders (``DeviceMesh(devices=[None, None])``: nothing is
dispatched anywhere but the thread-local shard) are injected instead;
several shards may name one card.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import torch

from ...utils import flight_recorder, metrics, pipeline_profiler

_ENV_ENABLED = "LIGHTHOUSE_TPU_DP_MESH"
_ENV_DEVICES = "LIGHTHOUSE_TPU_DP_DEVICES"
_ENV_RECOVERY = "LIGHTHOUSE_TPU_MESH_RECOVERY"
_ENV_PROBE_BASE = "LIGHTHOUSE_TPU_MESH_PROBE_BASE_S"
_ENV_PROBE_MAX = "LIGHTHOUSE_TPU_MESH_PROBE_MAX_S"

DEFAULT_PROBE_BASE_S = 1.0
DEFAULT_PROBE_MAX_S = 30.0

# rolling per-card throughput window (seconds): short enough that a
# stalled card's sets/s visibly decays, long enough to smooth flush
# burstiness
_RATE_WINDOW_S = 60.0

_log = logging.getLogger(__name__)


def env_enabled() -> bool:
    return os.environ.get(_ENV_ENABLED, "1") not in ("", "0")


def recovery_env_enabled() -> bool:
    """Kill switch for the self-healing worker: default on; 0 pins the
    one-way degradation."""
    return os.environ.get(_ENV_RECOVERY, "1") not in ("", "0")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def env_devices():
    """The operator's dp width knob: a positive integer, the string
    ``all``/``auto`` (discover every local device), or None when
    unset or malformed (a caller then builds a 1-wide mesh)."""
    raw = os.environ.get(_ENV_DEVICES, "").strip().lower()
    if raw in ("all", "auto"):
        return "all"
    try:
        n = int(raw)
    except ValueError:
        return None
    return n if n > 0 else None


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

_SHARD_SETS = metrics.counter_vec(
    "bls_device_shard_sets_total",
    "signature sets verified per mesh shard (data-parallel device "
    "index) — the per-card half of the aggregate sets/s story",
    ("shard",),
)
_SHARD_SECONDS = metrics.histogram_vec(
    "bls_device_shard_verify_seconds",
    "per-shard dispatch wall time of one sharded sub-batch verify "
    "(pack + staged dispatch on that shard's device)",
    ("shard",),
)
_SHARD_FAILURES = metrics.counter_vec(
    "bls_device_shard_failures_total",
    "dispatch failures per mesh shard (exceptions raised by a sharded "
    "verify; a failure whose failover re-verify succeeds marks the "
    "shard lost — see the shard_lost journal kind)",
    ("shard",),
)
_SHARD_HEALTH = metrics.gauge_vec(
    "bls_device_shard_health",
    "1 = shard healthy (planner packs onto it), 0 = lost (dropped "
    "from the shard axis; the node keeps serving on the rest)",
    ("shard",),
)
_SHARD_MEMORY = metrics.gauge_vec(
    "bls_device_shard_memory_bytes",
    "device bytes in use per mesh shard (the CUDA caching allocator's "
    "allocated bytes; not set for CPU or placeholder devices)",
    ("shard",),
)
_SHARD_PROBATION = metrics.gauge_vec(
    "bls_device_shard_probation",
    "1 = shard is in probation (lost from the axis, the recovery "
    "worker is probing it on backoff), 0 = not (healthy, or lost with "
    "recovery disabled)",
    ("shard",),
)
_SHARD_PROBES = metrics.counter_vec(
    "bls_device_shard_probes_total",
    "recovery probes run against a probation shard, by outcome (ok = "
    "canary + re-warm + key-table re-sync all passed and the shard "
    "was re-admitted; error = the probe failed and the next one backs "
    "off further)",
    ("shard", "outcome"),
)
_SHARD_RECOVERIES = metrics.counter_vec(
    "bls_device_shard_recoveries_total",
    "probation shards re-admitted to the planner's shard axis by the "
    "recovery worker (see the shard_recovered journal kind)",
    ("shard",),
)


class _ShardState:
    __slots__ = (
        "healthy", "failures", "sets_total", "dispatches",
        "last_dispatch_t", "window", "lost_error",
        "probation", "probe_attempts", "next_probe_t", "lost_at",
        "recovered_total",
    )

    def __init__(self):
        self.healthy = True
        self.failures = 0
        self.sets_total = 0
        self.dispatches = 0
        self.last_dispatch_t: Optional[float] = None
        self.window: deque = deque()  # (t, n_sets)
        self.lost_error: Optional[str] = None
        # probation/recovery: set on the healthy->lost transition,
        # cleared on re-admission (or operator restore)
        self.probation = False
        self.probe_attempts = 0
        self.next_probe_t: Optional[float] = None
        self.lost_at: Optional[float] = None
        self.recovered_total = 0


class DeviceMesh:
    """The served dp mesh (see the module docstring). ``devices`` injects
    an explicit device list (``torch.device`` objects or names, or
    ``None`` placeholders); ``n_devices`` bounds discovery, which reads
    ``torch.cuda.device_count()`` in the constructor, so a mesh that
    exists is a mesh whose devices existed at build time."""

    def __init__(
        self,
        n_devices: Optional[int] = None,
        devices: Optional[Sequence] = None,
        probe_fn=None,
        probe_base_s: Optional[float] = None,
        probe_max_s: Optional[float] = None,
    ):
        if devices is None:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if not count:
                raise RuntimeError("no CUDA devices visible to torch")
            if n_devices is not None:
                if n_devices > count:
                    raise RuntimeError(
                        f"dp_devices={n_devices} but torch.cuda.device_count() "
                        f"is {count}"
                    )
                count = n_devices
            devices = [torch.device("cuda", i) for i in range(count)]
        self.devices = [None if d is None else torch.device(d) for d in devices]
        if not self.devices:
            raise RuntimeError("DeviceMesh needs at least one device")
        self._lock = threading.Lock()
        self._t0 = time.monotonic()  # rate denominator floor (young mesh)
        self._shards: Dict[int, _ShardState] = {
            i: _ShardState() for i in range(len(self.devices))
        }
        for i in self._shards:
            _SHARD_HEALTH.with_labels(str(i)).set(1)
        # recovery worker: idle until start_recovery(); the probe
        # callable is injectable so chaos tooling and tests can probe
        # through the real verify seam
        self._probe_fn = probe_fn
        self._probe_base_s = (
            float(probe_base_s)
            if probe_base_s is not None
            else _env_float(_ENV_PROBE_BASE, DEFAULT_PROBE_BASE_S)
        )
        self._probe_max_s = (
            float(probe_max_s)
            if probe_max_s is not None
            else _env_float(_ENV_PROBE_MAX, DEFAULT_PROBE_MAX_S)
        )
        self._rec_cv = threading.Condition()
        self._rec_stop = False
        self._rec_thread: Optional[threading.Thread] = None
        self._recoveries_total = 0

    # -- topology ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.devices)

    def all_shards(self) -> List[int]:
        return sorted(self._shards)

    def healthy_shards(self) -> List[int]:
        with self._lock:
            return sorted(i for i, s in self._shards.items() if s.healthy)

    def is_healthy(self, shard: int) -> bool:
        with self._lock:
            st = self._shards.get(shard)
            return st is not None and st.healthy

    def is_probing(self, shard: int) -> bool:
        """True while ``shard`` is in probation: lost from the axis but
        under active recovery. The compile service treats a probing
        shard's rungs as live work (the re-warm half of a probe), unlike
        a plainly lost shard's."""
        with self._lock:
            st = self._shards.get(shard)
            return st is not None and st.probation

    def probing_shards(self) -> List[int]:
        with self._lock:
            return sorted(
                i for i, s in self._shards.items() if s.probation
            )

    def primary_shard(self) -> Optional[int]:
        """The default dispatch target when no shard scope is set: the
        lowest healthy shard (None when every card is lost: the caller
        then dispatches on its own device)."""
        healthy = self.healthy_shards()
        return healthy[0] if healthy else None

    def failover_shard(self, failed: int) -> Optional[int]:
        """Where an in-flight sub-batch re-verifies after ``failed``
        raised: the lowest healthy shard that is not the failed one."""
        for i in self.healthy_shards():
            if i != failed:
                return i
        return None

    def device_for(self, shard: int) -> Optional[torch.device]:
        """The device behind a shard id (None for a placeholder: the
        dispatch scope then sets only the thread-local shard)."""
        try:
            return self.devices[shard]
        except (IndexError, TypeError):
            return None

    # -- dispatch accounting ----------------------------------------------

    def note_dispatch(self, shard: int, n_sets: int, seconds: float) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._shards.get(shard)
            if st is None:
                return
            st.sets_total += int(n_sets)
            st.dispatches += 1
            st.last_dispatch_t = now
            st.window.append((now, int(n_sets)))
            while st.window and now - st.window[0][0] > _RATE_WINDOW_S:
                st.window.popleft()
        _SHARD_SETS.with_labels(str(shard)).inc(int(n_sets))
        _SHARD_SECONDS.with_labels(str(shard)).observe(float(seconds))

    def note_failure(self, shard: int, error: BaseException,
                     lost: bool = True) -> bool:
        """One dispatch on ``shard`` raised. ``lost=True`` (a failover
        re-verify of the same work succeeded, so the work was fine and
        the card is the problem) drops the shard from the axis; returns
        True exactly on the healthy->lost transition (when the
        ``shard_lost`` event is journaled)."""
        transition = False
        with self._lock:
            st = self._shards.get(shard)
            if st is None:
                return False
            st.failures += 1
            failures = st.failures
            if lost and st.healthy:
                st.healthy = False
                st.lost_error = repr(error)[:200]
                transition = True
        _SHARD_FAILURES.with_labels(str(shard)).inc()
        if transition:
            _SHARD_HEALTH.with_labels(str(shard)).set(0)
            flight_recorder.record(
                "shard_lost",
                shard=shard,
                failures=failures,
                healthy_remaining=len(self.healthy_shards()),
                error=repr(error)[:200],
            )
            _log.warning("mesh shard %s lost, degrading to fewer dp shards: %s",
                         shard, repr(error)[:120])
            # a lost card enters probation at once (the state is set
            # whether or not a recovery worker runs: the worker reads it)
            self._enter_probation(shard, error)
        return transition

    def restore_shard(self, shard: int) -> None:
        """Operator action (or test hook): put a repaired card back on
        the shard axis. Also the recovery worker's re-admission commit;
        probation state clears with the restore."""
        with self._lock:
            st = self._shards.get(shard)
            if st is None:
                return
            st.healthy = True
            st.lost_error = None
            st.probation = False
            st.probe_attempts = 0
            st.next_probe_t = None
        _SHARD_HEALTH.with_labels(str(shard)).set(1)
        _SHARD_PROBATION.with_labels(str(shard)).set(0)

    # -- probation / recovery ---------------------------------------------

    def _backoff(self, attempt: int) -> float:
        """Capped exponential backoff with jitter: ``base * 2**(attempt-1)``
        capped at the max, times ``U[0.5, 1.0]`` so nodes losing cards to
        one shared cause never probe in lockstep."""
        backoff = min(
            self._probe_max_s,
            self._probe_base_s * (2.0 ** max(0, attempt - 1)),
        )
        return backoff * random.uniform(0.5, 1.0)

    def _enter_probation(self, shard: int, error: BaseException) -> None:
        delay = self._backoff(1)
        now = time.monotonic()
        with self._lock:
            st = self._shards.get(shard)
            if st is None or st.probation:
                return
            st.probation = True
            st.probe_attempts = 0
            st.lost_at = now
            st.next_probe_t = now + delay
        _SHARD_PROBATION.with_labels(str(shard)).set(1)
        flight_recorder.record(
            "shard_probation",
            shard=shard,
            attempt=0,
            next_probe_s=round(delay, 3),
            error=repr(error)[:200],
        )
        with self._rec_cv:
            self._rec_cv.notify_all()

    def start_recovery(
        self,
        probe_fn=None,
        base_backoff_s: Optional[float] = None,
        max_backoff_s: Optional[float] = None,
    ) -> "DeviceMesh":
        """Start the background recovery worker (idempotent). The worker
        probes probation shards on their backoff schedule; one passing
        probe (canary + re-warm + key-table re-sync) re-admits the shard.
        Parameters override the constructor's and the env's."""
        with self._rec_cv:
            if probe_fn is not None:
                self._probe_fn = probe_fn
            if base_backoff_s is not None:
                self._probe_base_s = float(base_backoff_s)
            if max_backoff_s is not None:
                self._probe_max_s = float(max_backoff_s)
            if self._rec_thread is not None and self._rec_thread.is_alive():
                return self
            self._rec_stop = False
            self._rec_thread = threading.Thread(
                target=self._recovery_loop, name="mesh-recovery",
                daemon=True,
            )
            self._rec_thread.start()
        return self

    def stop_recovery(self, timeout: float = 10.0) -> None:
        """Stop the recovery worker. A probe in flight gets ``timeout`` to
        finish; past that the (daemon) thread is abandoned: the identity
        check in the loop makes a later ``start_recovery`` safe."""
        with self._rec_cv:
            self._rec_stop = True
            self._rec_cv.notify_all()
        t = self._rec_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout)
        self._rec_thread = None

    def recovery_running(self) -> bool:
        t = self._rec_thread
        return t is not None and t.is_alive() and not self._rec_stop

    def _due_probes(self):
        """(due shard list, seconds until the earliest pending probe or
        None); takes the state lock itself."""
        now = time.monotonic()
        due: List[int] = []
        nxt: Optional[float] = None
        with self._lock:
            for i, st in self._shards.items():
                if not st.probation or st.next_probe_t is None:
                    continue
                if st.next_probe_t <= now:
                    due.append(i)
                elif nxt is None or st.next_probe_t < nxt:
                    nxt = st.next_probe_t
        wait = None if nxt is None else max(0.01, nxt - now)
        return sorted(due), wait

    def _recovery_loop(self) -> None:
        # identity check: stop_recovery gives up joining after its
        # timeout (a probe cannot be cancelled) and a later
        # start_recovery spawns a fresh worker; a superseded thread
        # exits instead of double-probing
        me = threading.current_thread()
        while True:
            with self._rec_cv:
                if self._rec_stop or self._rec_thread is not me:
                    return
                due, wait = self._due_probes()
                if not due:
                    self._rec_cv.wait(wait)
                    continue
            for shard in due:
                with self._rec_cv:
                    if self._rec_stop or self._rec_thread is not me:
                        return
                self._probe_shard(shard)

    def _default_canary(self, shard: int) -> bool:
        """A tiny computation on the probed shard's device: proves the
        card executes work again. Placeholder devices pass (there is no
        hardware to probe; the injected ``probe_fn`` is the seam)."""
        dev = self.device_for(shard)
        if dev is None:
            return True
        return torch.arange(8, device=dev).sum().item() == 28

    def _rewarm_shard(self, shard: int) -> int:
        """Best-effort: re-queue the compile service's rungs for this
        shard. Rungs still warm in the registry are skipped by the
        worker at once (the graphs survived the loss); cold ones are
        captured in the background while per-shard routing sheds around
        them. Returns the number of rungs already warm."""
        try:
            from ...compile_service import service as _csvc

            svc = _csvc.get_active_service()
            if svc is None:
                return 0
            warm = len(svc.warm_rungs_active(device=shard))
            for rung in svc.plan:
                svc.request(*rung, device=shard)
            return warm
        except Exception:
            return 0

    def _resync_key_table(self, shard: int) -> None:
        """Re-sync the device key table before re-admission (raises on
        failure: a shard never re-joins with a replica behind the host
        cache). The table mirrors every sync onto every replica, so one
        catch-up sync covers whatever deltas failed while the card was
        down."""
        from . import key_table as _kt

        tbl = _kt.get_table()
        if tbl is None:
            return
        tbl.sync(reason="recovery")

    def _probe_shard(self, shard: int) -> None:
        t0 = time.monotonic()
        err: Optional[BaseException] = None
        ok = False
        warm_rungs = 0
        try:
            # the probe runs inside the shard's dispatch scope, so an
            # injected probe_fn exercises the real per-shard seam (the
            # canary lands on the probed card, and faults keyed on
            # current_shard() see the probe)
            with dispatch_to(shard):
                probe = self._probe_fn or self._default_canary
                ok = bool(probe(shard))
            if ok:
                warm_rungs = self._rewarm_shard(shard)
                self._resync_key_table(shard)
        except BaseException as e:  # noqa: BLE001 — a probe must never kill the worker
            err, ok = e, False
        if ok:
            with self._lock:
                st = self._shards.get(shard)
                if st is None or not st.probation:
                    return  # operator restored (or shard vanished) meanwhile
                probes = st.probe_attempts + 1
                down_s = t0 - (st.lost_at or t0)
                st.recovered_total += 1
                self._recoveries_total += 1
            _SHARD_PROBES.with_labels(str(shard), "ok").inc()
            _SHARD_RECOVERIES.with_labels(str(shard)).inc()
            self.restore_shard(shard)
            flight_recorder.record(
                "shard_recovered",
                shard=shard,
                probes=probes,
                down_s=round(down_s, 3),
                warm_rungs=warm_rungs,
                healthy_total=len(self.healthy_shards()),
            )
            _log.warning("mesh shard %s recovered, re-admitted to the dp axis "
                         "after %s probes (%.3f s down)", shard, probes, down_s)
        else:
            with self._lock:
                st = self._shards.get(shard)
                if st is None or not st.probation:
                    return
                st.probe_attempts += 1
                attempt = st.probe_attempts
                delay = self._backoff(attempt + 1)
                st.next_probe_t = time.monotonic() + delay
            _SHARD_PROBES.with_labels(str(shard), "error").inc()
            flight_recorder.record(
                "shard_probation",
                shard=shard,
                attempt=attempt,
                next_probe_s=round(delay, 3),
                error=None if err is None else repr(err)[:200],
            )

    # -- introspection ----------------------------------------------------

    def _rate(self, st: _ShardState, now: float) -> float:
        """Sets/s over the rolling window: the denominator is the window
        length (capped by the mesh's age while it is younger than one
        window), so one burst after an idle gap never reads as thousands
        of sets/s."""
        live = [(t, n) for (t, n) in st.window if now - t <= _RATE_WINDOW_S]
        if not live:
            return 0.0
        span = min(_RATE_WINDOW_S, max(1.0, now - self._t0))
        return sum(n for _t, n in live) / span

    def memory_by_shard(self) -> Dict[int, Optional[int]]:
        """Per-card device bytes in use (``torch.cuda.memory_stats``'
        allocated bytes for a CUDA shard; None for CPU and placeholder
        devices)."""
        out: Dict[int, Optional[int]] = {}
        for i, dev in enumerate(self.devices):
            val = None
            if dev is not None and dev.type == "cuda":
                try:
                    stats = torch.cuda.memory_stats(dev)
                    val = int(stats.get("allocated_bytes.all.current", 0))
                except Exception:
                    val = None
            out[i] = val
            if val is not None:
                _SHARD_MEMORY.with_labels(str(i)).set(val)
        return out

    def status(self) -> dict:
        """Topology, per-card health, throughput and memory, probation
        state, and the aggregate sets/s the dp axis delivers."""
        now = time.monotonic()
        mem = self.memory_by_shard()
        with self._lock:
            chips = []
            agg_rate = 0.0
            probation = []
            recoveries = self._recoveries_total
            for i in sorted(self._shards):
                st = self._shards[i]
                rate = self._rate(st, now)
                if st.healthy:
                    agg_rate += rate
                if st.probation:
                    probation.append(i)
                dev = self.devices[i] if i < len(self.devices) else None
                chips.append({
                    "shard": i,
                    "device": str(dev) if dev is not None else None,
                    "platform": dev.type if dev is not None else None,
                    "healthy": st.healthy,
                    "failures": st.failures,
                    "sets_total": st.sets_total,
                    "dispatches": st.dispatches,
                    "sets_per_sec": round(rate, 2),
                    "device_memory_bytes": mem.get(i),
                    # idle / (busy + idle) of this shard's staged
                    # dispatch timeline (pipeline profiler, host clock);
                    # None before its first dispatch
                    "bubble_ratio": pipeline_profiler.shard_bubble_ratio(i),
                    "lost_error": st.lost_error,
                    "probation": st.probation,
                    "probe_attempts": st.probe_attempts,
                    "next_probe_in_s": (
                        round(max(0.0, st.next_probe_t - now), 3)
                        if st.probation and st.next_probe_t is not None
                        else None
                    ),
                    "recovered_total": st.recovered_total,
                })
            healthy = [i for i, s in self._shards.items() if s.healthy]
        return {
            "n_devices": len(self.devices),
            "healthy_shards": sorted(healthy),
            "lost_shards": sorted(set(self._shards) - set(healthy)),
            "probation_shards": probation,
            "recoveries_total": recoveries,
            "recovery_running": self.recovery_running(),
            "probe_base_s": self._probe_base_s,
            "probe_max_s": self._probe_max_s,
            "aggregate_sets_per_sec": round(agg_rate, 2),
            "rate_window_s": _RATE_WINDOW_S,
            "chips": chips,
        }


# ---------------------------------------------------------------------------
# Thread-local dispatch scope (the seam the scheduler wraps around a
# sharded sub-batch so the packers and the staged dispatch land on that
# shard's device without a handle plumbed through every call)
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_shard() -> Optional[int]:
    """The shard this thread is dispatching for (None outside any
    :func:`dispatch_to` scope)."""
    return getattr(_tls, "shard", None)


class dispatch_to:
    """Context manager scoping this thread's dispatches to ``shard``: sets
    the thread-local shard and, for a CUDA shard, enters
    ``torch.cuda.device`` (CUDA's current device is per thread, so each
    thread that dispatches for a shard enters its own scope). A CPU
    device or a placeholder sets only the thread-local."""

    def __init__(self, shard: Optional[int]):
        self.shard = shard
        self._prev = None
        self._dev_cm = None

    def __enter__(self):
        self._prev = getattr(_tls, "shard", None)
        # device scope first: if entering it raises, the thread-local
        # stays untouched (a leaked shard would pin every later
        # unscoped dispatch on this long-lived thread to the wrong card)
        if self.shard is not None:
            mesh = get_active_mesh()
            dev = mesh.device_for(self.shard) if mesh is not None else None
            if dev is not None and dev.type == "cuda":
                self._dev_cm = torch.cuda.device(dev)
                self._dev_cm.__enter__()
        _tls.shard = self.shard
        return self

    def __exit__(self, *exc):
        try:
            if self._dev_cm is not None:
                self._dev_cm.__exit__(*exc)
        finally:
            self._dev_cm = None
            _tls.shard = self._prev
        return False


# ---------------------------------------------------------------------------
# Process-global mesh (the seam the scheduler, compile service, key table
# and CudaBackend reach)
# ---------------------------------------------------------------------------

_mesh_lock = threading.Lock()
_mesh: Optional[DeviceMesh] = None


def set_mesh(mesh: Optional[DeviceMesh]) -> None:
    global _mesh
    with _mesh_lock:
        _mesh = mesh


def clear_mesh(mesh: Optional[DeviceMesh] = None) -> None:
    """Detach the global mesh (only if it still is ``mesh`` when one is
    given: a racing rebuild must not lose its fresh mesh)."""
    global _mesh
    with _mesh_lock:
        if mesh is None or _mesh is mesh:
            _mesh = None


def get_active_mesh() -> Optional[DeviceMesh]:
    """The attached mesh; None when nothing is attached (single-device
    behaviour everywhere)."""
    return _mesh


def device_of(shard: Optional[int], default):
    """The device a dispatch for ``shard`` runs on: the shard's device
    when a mesh is attached and the shard is not a placeholder, else
    ``default`` (the caller's own device)."""
    mesh = _mesh
    if shard is None or mesh is None:
        return default
    dev = mesh.device_for(int(shard))
    return default if dev is None else dev


def healthy_shard_count() -> int:
    """Healthy shards the attached mesh serves on right now, read live:
    the shard-count feed of the capacity estimator
    (``utils/timeseries.py``), which must not lag a card loss as the
    flush-time dp gauge would; 0 when no mesh is attached."""
    mesh = _mesh
    if mesh is None:
        return 0
    try:
        return len(mesh.healthy_shards())
    except Exception:
        return 0
