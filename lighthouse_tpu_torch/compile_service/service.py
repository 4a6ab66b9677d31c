"""CompileService: ahead-of-time capture of the staged verifier's CUDA
graphs, rung by rung, and warm-shape routing: the port of the JAX
package's ``compile_service/service.py``.

In the JAX package a fresh bucket shape costs an XLA compile; here it
costs an eager warm-up and a CUDA-graph capture per stage
(``crypto/device/graphs.py``), seconds on the caller's thread. This
module keeps that off the hot path:

* **AOT warm-up**: a background worker walks the rung plan in priority
  order and captures each rung's stage graphs
  (:func:`~lighthouse_tpu_torch.compile_service.lowering.warm_staged`,
  dispatched through ``bls._run_stage`` so a warmed rung is not fresh
  for real traffic), with retry and backoff, and keeps a thread-safe
  warm-shape registry;
* **warm-shape routing**: :meth:`CompileService.route` answers whether a
  rung (B, K, M) can dispatch without a capture: ``warm`` (its graphs
  exist), ``padded`` (a larger warm rung covers it: pad up) or ``shed``
  (nothing warm). ``CudaBackend`` pads its batches to the rung
  :meth:`CompileService.pads_for` names;
* **the shed fallback**: the verification scheduler
  (``verification_service/batcher.py``) routes every flush through
  :meth:`CompileService.decide_flush` and serves a ``shed`` one through
  :meth:`CompileService.fallback_verify`, a synchronous verify on the C
  verifier (``crypto/native.py``, backend ``cpu-native``) while the
  worker captures the rung. A cold rung never stalls a flush. The JAX
  service falls back further, to its pure-Python pairing, when the C
  build fails; the port has no host pairing, so a failed build raises.
* **the mesh ladder**: with a device mesh attached at :meth:`start`
  (``crypto/device/mesh.py``), the work items are (rung, shard) over
  every shard, headline rungs first; the registry, routing and warmth
  are per shard, each shard's rungs warm in its dispatch scope, and a
  lost shard's rungs are skipped (a probing shard's are live work).

Telemetry, as the JAX service's: the nine ``compile_service_*`` families
(warm-ups in flight, warm rungs, queue depth, per-stage warm-ups and
their seconds, cold routes, retries, the fallback's wall, the measured
serving cost per set) and the ``compile_started`` / ``compile_ready`` /
``compile_failed`` / ``compile_retry`` / ``cold_route`` journal events. A
shed flush's fallback journals a zero-byte transfer-ledger row and lands
its wall as ``compile`` activity in the pipeline profiler.

Left out, and why (``ROADMAP.md``): the persistent compile cache and
its manifest (``cache.py``; a CUDA graph cannot be written to disk, and
the kernels' nvcc build already persists under ``_build/``). So every
``compile_ready`` event says ``persisted=False``.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional, Tuple

from ..crypto.device import mesh as _mesh
from ..utils import (
    fault_injection,
    flight_recorder,
    metrics,
    pipeline_profiler,
    tracing,
    transfer_ledger,
)
from ..verification_service import planner as _planner
from ..verification_service.planner import Rung, round_up_bucket

_log = logging.getLogger(__name__)

# The rung plan's walk order (priority), the JAX package's: the gossip
# aggregate headline bucket first, then the flush planner's kind-
# homogeneous sub-batch shapes, the intermediate B rungs, the large fused
# bucket and small rungs for trickle traffic, and last the bulk rungs
# (K = 1, one distinct message per set, so M pads to B).
DEFAULT_RUNGS: Tuple[Rung, ...] = (
    (64, 16, 8),
    (48, 16, 8),
    (32, 1, 8),
    (16, 16, 8),
    (64, 1, 8),
    (256, 16, 8),
    (96, 16, 8),
    (192, 16, 8),
    (4, 16, 8),
    (1, 16, 8),
    (512, 1, 512),
    (256, 1, 256),
)

# Padded point counts N of the G1 MSM and G2 sum programs
# (``crypto/device/msm.py`` pads to them): 512 covers a mainnet
# committee. They are keyed on their own rung, never on (B, K, M), and
# warmed only when a caller opts in (:func:`set_msm_warm_enabled`).
MSM_RUNGS: Tuple[int, ...] = (64, 128, 256, 512)

_msm_warm_enabled = False


def set_msm_warm_enabled(on: bool) -> None:
    """Opt the AOT walk into warming the MSM ladder alongside the first
    staged rungs (one MSM rung per staged rung, smallest first)."""
    global _msm_warm_enabled
    _msm_warm_enabled = bool(on)


def msm_warm_enabled() -> bool:
    return _msm_warm_enabled


_ENV_ENABLED = "LIGHTHOUSE_TPU_COMPILE_SERVICE"
_ENV_RUNGS = "LIGHTHOUSE_TPU_COMPILE_RUNGS"
# a failed rung re-queues with bounded exponential backoff and jitter, up
# to a per-rung attempt budget, so a deterministic failure cannot spin
_ENV_RETRY_MAX = "LIGHTHOUSE_TPU_COMPILE_RETRY_MAX"
_ENV_RETRY_BASE = "LIGHTHOUSE_TPU_COMPILE_RETRY_BASE_S"
_ENV_RETRY_CAP = "LIGHTHOUSE_TPU_COMPILE_RETRY_MAX_S"

DEFAULT_RETRY_MAX_ATTEMPTS = 3
DEFAULT_RETRY_BASE_S = 1.0
DEFAULT_RETRY_MAX_S = 60.0


_COMPILE_BUCKETS = (
    0.01, 0.05, 0.25, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1200.0,
)

_IN_FLIGHT = metrics.gauge(
    "compile_service_compiles_in_flight",
    "rung warm-ups (eager run, CUDA-graph capture, check replay per "
    "stage) the background worker is running right now",
)
_WARM_RUNGS = metrics.gauge(
    "compile_service_warm_rungs",
    "bucket rungs (B, K, M) x fp_impl x mesh shard whose three stage "
    "graphs are captured and routable (single-device nodes only ever "
    "count shard 0)",
)
_QUEUE_DEPTH = metrics.gauge(
    "compile_service_queue_depth",
    "bucket rungs queued for background warm-up",
)
_COMPILES = metrics.counter_vec(
    "compile_service_compiles_total",
    "per-stage AOT warm-ups by outcome (ok includes a stage whose graph "
    "another shard on the same card had already captured: it replays)",
    ("stage", "outcome"),
)
_COMPILE_SECONDS = metrics.histogram_vec(
    "compile_service_compile_seconds",
    "per-stage AOT warm-up wall time per rung (a capture takes seconds "
    "on the card; a warm graph's replay milliseconds)",
    ("stage",),
    buckets=_COMPILE_BUCKETS,
)
_COLD_ROUTES = metrics.counter_vec(
    "compile_service_cold_routes_total",
    "scheduler flushes that arrived at a cold bucket: padded = served "
    "on a larger warm rung, shed = served via the synchronous CPU "
    "fallback while the rung's graphs are captured in the background",
    ("action",),
)
_COMPILE_RETRIES = metrics.counter(
    "compile_service_compile_retries_total",
    "failed rung warm-ups re-queued with backoff by the retry layer (see "
    "the compile_retry journal kind); retries beyond the per-rung "
    "attempt cap are NOT scheduled and the rung stays cold until "
    "invalidate()/demand re-queues it",
)
_FALLBACK_SECONDS = metrics.histogram(
    "compile_service_fallback_verify_seconds",
    "wall time of one synchronous CPU fallback verify of a shed flush — "
    "the latency a submission pays on the SLO layer's `fallback` "
    "resolution path (verification_scheduler_verdict_latency_seconds"
    "{path=fallback}) while the cold rung's graphs are captured behind it",
)
_MEASURED_COST = metrics.gauge(
    "compile_service_measured_cost_seconds_per_set",
    "organically measured WARM serving cost per signature set: "
    "cumulative staged-verify wall / cumulative sets across every rung "
    "note_rung_verified reported, EXCLUDING each rung's first dispatch "
    "(whose wall includes the captures). The rung-cost feed the "
    "capacity/headroom estimator reads when no per-shard mesh walls "
    "exist; per-rung splits in status()['rung_costs']",
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


def _env_rungs() -> Optional[Tuple[Rung, ...]]:
    """Parse ``LIGHTHOUSE_TPU_COMPILE_RUNGS="B:K:M,B:K:M"``; None when
    unset or malformed (malformed falls back to the default plan, with a
    warning)."""
    raw = os.environ.get(_ENV_RUNGS)
    if not raw:
        return None
    try:
        rungs = tuple(
            tuple(int(p) for p in chunk.split(":"))
            for chunk in raw.split(",")
            if chunk.strip()
        )
        if rungs and all(len(r) == 3 and all(v > 0 for v in r) for r in rungs):
            return rungs  # type: ignore[return-value]
    except ValueError:
        pass
    _log.warning("malformed %s ignored: %s", _ENV_RUNGS, raw[:80])
    return None


def _geometry(sets) -> Tuple[int, int, int]:
    """(n_sets, max pubkeys per set, unique messages) of a flush."""
    return _planner.flush_geometry(sets)


class WarmShapeRegistry:
    """Thread-safe set of (B, K, M, impl, device) rungs whose stage
    graphs are captured; ``device`` is the mesh shard index (0 without a
    mesh). :meth:`invalidate` bumps an epoch, so a warm-up that started
    before it cannot mark its rung warm afterwards."""

    def __init__(self):
        self._lock = threading.Lock()
        self._warm: set = set()
        self._epoch = 0

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def mark_ready(
        self, rung: Rung, impl: str, epoch: int | None = None,
        device: int = 0,
    ) -> bool:
        """Record ``rung`` warm under ``impl`` on ``device``; False when
        the mark is stale (the epoch moved since the warm-up started) or
        already present."""
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return False
            key = (*rung, impl, int(device))
            if key in self._warm:
                return False
            self._warm.add(key)
            _WARM_RUNGS.set(len(self._warm))
            return True

    def is_warm(self, rung: Rung, impl: str, device: int = 0) -> bool:
        with self._lock:
            return (*rung, impl, int(device)) in self._warm

    def best_covering(
        self, n_sets: int, k_req: int, m_req: int, impl: str,
        device: int = 0,
    ) -> Optional[Rung]:
        """Cheapest warm rung on ``device`` holding the request padded up
        (``planner.best_covering_rung``); None when none covers it."""
        with self._lock:
            warm = [
                (b, k, m)
                for (b, k, m, i, d) in self._warm
                if i == impl and d == int(device)
            ]
        return _planner.best_covering_rung(warm, n_sets, k_req, m_req)

    def warm_rungs(self) -> list:
        """Device 0's warm rungs as (B, K, M, impl) tuples."""
        with self._lock:
            return sorted(
                (b, k, m, i) for (b, k, m, i, d) in self._warm if d == 0
            )

    def warm_rungs_all(self) -> list:
        """Every warm (B, K, M, impl, device) key."""
        with self._lock:
            return sorted(self._warm)

    def invalidate(self) -> None:
        with self._lock:
            self._warm.clear()
            self._epoch += 1
            _WARM_RUNGS.set(0)


class CompileService:
    """Background AOT capture and warm-shape router for the staged
    verifier (see the module docstring). ``compile_rung_fn(b, k, m)`` and
    ``fallback_verify_fn(sets)`` are injectable for tests; the defaults
    capture the rung's stage graphs on ``device`` through
    :func:`lowering.warm_staged` (``cuda`` unless the caller asks for the
    CPU, where nothing is captured and the stages run once eagerly) and
    verify shed flushes on the C verifier (``cpu-native``)."""

    def __init__(
        self,
        rungs: Optional[Iterable[Rung]] = None,
        compile_rung_fn: Optional[Callable[[int, int, int], dict]] = None,
        device="cuda",
        fallback_verify_fn: Optional[Callable[[list], bool]] = None,
    ):
        self.plan: Tuple[Rung, ...] = tuple(
            tuple(r) for r in (rungs or _env_rungs() or DEFAULT_RUNGS)
        )
        self.device = device
        self._compile_rung_fn = compile_rung_fn
        self._fallback_fn = fallback_verify_fn
        self._fallback_backend = None
        self._fallback_calls = 0
        self._fallback_sets = 0
        self._fallback_seconds = 0.0
        self.registry = WarmShapeRegistry()
        self._cv = threading.Condition()
        # work items are (rung, mesh shard): the mesh ladder. Without a
        # mesh only shard 0 is queued; start() reads the mesh's shards
        self._devices: Tuple[int, ...] = (0,)
        self._queue: deque = deque()
        self._queued: set = set()
        self._in_flight = None
        self._stopped = True
        self._thread: Optional[threading.Thread] = None
        self._compiled_total = 0
        self._failed_total = 0
        self._cold_routes = {"padded": 0, "shed": 0}
        self.retry_max_attempts = max(
            1, _env_int(_ENV_RETRY_MAX, DEFAULT_RETRY_MAX_ATTEMPTS)
        )
        self.retry_base_s = _env_float(_ENV_RETRY_BASE, DEFAULT_RETRY_BASE_S)
        self.retry_max_s = _env_float(_ENV_RETRY_CAP, DEFAULT_RETRY_MAX_S)
        self._attempts: dict = {}   # (rung, device) -> failures so far
        self._retry_at: dict = {}   # (rung, device) -> due monotonic time
        self._retries_total = 0
        self._last_error: Optional[str] = None
        # (impl, device, n) MSM rungs already warm: the ladder rides the
        # first staged rungs, one MSM rung each
        self._msm_warmed: set = set()
        # (rung, device) -> [dispatches, sum_s, sum_sets]
        self._rung_costs: dict = {}
        self._cost_sum_s = 0.0
        self._cost_sum_sets = 0
        # (rung, device) -> {stage: {seconds, fresh}} of its AOT warm-up
        self._stage_records: dict = {}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "CompileService":
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            # the mesh ladder: rung x shard, headline rungs first, so
            # every shard gets the big warm rung before any gets the next
            self._devices = self._mesh_devices()
            for rung in self.plan:
                for dev in self._devices:
                    self._enqueue_locked((rung, dev), front=False)
            self._stopped = False
            self._thread = threading.Thread(
                target=self._loop, name="compile-service", daemon=True
            )
            self._thread.start()
            # wake a superseded worker blocked in wait() so that it exits
            self._cv.notify_all()
        return self

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        self._thread = None

    def active(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stopped

    def invalidate(self) -> None:
        """Drop every warm rung and re-queue the plan, the rung in flight
        included (its mark will be stale)."""
        self.registry.invalidate()
        with self._cv:
            self._queue.clear()
            self._queued.clear()
            self._retry_at.clear()
            self._attempts.clear()
            self._msm_warmed.clear()
            for rung in self.plan:
                for dev in self._devices:
                    self._enqueue_locked(
                        (rung, dev), front=False, even_in_flight=True
                    )
            self._cv.notify_all()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until nothing is queued, in flight or waiting to retry;
        False if ``timeout`` seconds pass first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queue or self._in_flight or self._retry_at:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(left)
        return True

    @staticmethod
    def _mesh_devices() -> Tuple[int, ...]:
        """Shard indices the ladder walks: the attached mesh's every
        shard, (0,) without one."""
        m = _mesh.get_active_mesh()
        return tuple(m.all_shards()) if m is not None else (0,)

    def _device_healthy(self, dev: int) -> bool:
        if dev == 0 and len(self._devices) == 1:
            return True  # one shard: no mesh to consult
        m = _mesh.get_active_mesh()
        # a probing shard's rungs are live work: the recovery worker's
        # re-warm queues them before the shard is re-admitted
        return m is None or m.is_healthy(dev) or m.is_probing(dev)

    # -- queueing ---------------------------------------------------------

    def _enqueue_locked(
        self, item, front: bool, even_in_flight: bool = False
    ) -> None:
        if item in self._queued:
            # a demand request still promotes a queued rung to the front
            if front and self._queue and self._queue[0] != item:
                self._queue.remove(item)
                self._queue.appendleft(item)
            return
        if item == self._in_flight and not even_in_flight:
            return
        self._queued.add(item)
        if front:
            self._queue.appendleft(item)
        else:
            self._queue.append(item)
        _QUEUE_DEPTH.set(len(self._queue))
        self._cv.notify_all()  # the worker, and any wait_idle() caller

    def request(self, b: int, k: int, m: int, device: int = 0) -> None:
        """Ask the worker to warm rung (b, k, m) on mesh shard ``device``
        next."""
        with self._cv:
            self._enqueue_locked(
                ((int(b), int(k), int(m)), int(device)), front=True
            )

    # -- routing ----------------------------------------------------------

    @staticmethod
    def _impl() -> str:
        """The active ``fp.mul`` engine: the registry's engine slot, as the
        JAX service's. The Fp2 and line switches are covered by
        ``crypto.device.reset_compiled_state``, as in JAX."""
        from ..crypto.device import fp

        return fp.get_impl()

    def route(
        self, n_sets: int, k_req: int = 1, m_req: int = 1,
        device: int = 0,
    ) -> dict:
        """Routing decision for ``n_sets`` sets with up to ``k_req``
        pubkeys per set and ``m_req`` distinct messages on mesh shard
        ``device``:
        ``{"action": warm|padded|shed, "rung": (B, K, M) | None, "exact":
        (B, K, M), "fp_impl": impl, "device": device}``. A registry read;
        :meth:`decide_flush` does the accounting, and the verification
        scheduler serves a ``shed`` through :meth:`fallback_verify`."""
        impl = self._impl()
        exact = (
            round_up_bucket(n_sets),
            round_up_bucket(k_req),
            round_up_bucket(m_req),
        )
        if self.registry.is_warm(exact, impl, device=device):
            return {
                "action": "warm", "rung": exact, "exact": exact,
                "fp_impl": impl, "device": device,
            }
        covering = self.registry.best_covering(
            n_sets, k_req, m_req, impl, device=device
        )
        if covering is not None:
            return {
                "action": "padded", "rung": covering, "exact": exact,
                "fp_impl": impl, "device": device,
            }
        return {
            "action": "shed", "rung": None, "exact": exact,
            "fp_impl": impl, "device": device,
        }

    def decide_flush(
        self, sets, caller: str = "flush",
        geometry: Optional[Tuple[int, int, int]] = None,
        device_index: int = 0,
    ) -> dict:
        """Route a flush on mesh shard ``device_index``, count a cold
        bucket and queue its exact rung there, so that the next flush of
        this shape on that shard is warm. ``geometry`` is the caller's
        (n_sets, k_req, m_req) when it has it. ``padded`` is
        downgraded to ``shed`` unless this service is the process-global
        one: the pad-up happens inside ``CudaBackend``, which reads only
        the global seam (:func:`set_service`)."""
        n, k, m = geometry if geometry is not None else _geometry(sets)
        decision = self.route(n, k, m, device=int(device_index))
        if decision["action"] == "padded" and get_active_service() is not self:
            decision = {
                "action": "shed",
                "rung": None,
                "exact": decision["exact"],
                "fp_impl": decision["fp_impl"],
                "device": decision["device"],
            }
        if decision["action"] != "warm":
            action = decision["action"]
            with self._cv:  # the flush thread AND verify_now callers
                self._cold_routes[action] += 1
            _COLD_ROUTES.with_labels(action).inc()
            eb, ek, em = decision["exact"]
            rung = decision["rung"]
            flight_recorder.record(
                "cold_route",
                action=action,
                caller=caller,
                n_sets=n,
                k_req=k,
                m_req=m,
                exact_b=eb, exact_k=ek, exact_m=em,
                warm_b=None if rung is None else rung[0],
                warm_k=None if rung is None else rung[1],
                warm_m=None if rung is None else rung[2],
                fp_impl=decision["fp_impl"],
                device=decision["device"],
            )
            self.request(eb, ek, em, device=int(device_index))
        return decision

    def warm_rungs_active(self, device: int = 0) -> list:
        """Warm (B, K, M) rungs on mesh shard ``device`` under the port's
        engine."""
        impl = self._impl()
        return [
            (b, k, m)
            for (b, k, m, i, d) in self.registry.warm_rungs_all()
            if i == impl and d == int(device)
        ]

    def warm_rungs_by_shard(self, shards) -> dict:
        """``{shard: [(B, K, M), ...]}`` under the active engine: the
        planner's per-shard warm view (a shard whose set is empty plans
        cold there, and its sub-batch sheds instead of stalling)."""
        impl = self._impl()
        out = {int(s): [] for s in shards}
        for (b, k, m, i, d) in self.registry.warm_rungs_all():
            if i == impl and d in out:
                out[d].append((b, k, m))
        return out

    def pads_for(
        self, n_sets: int, k_req: int, m_req: int, device: int = 0
    ) -> Optional[Rung]:
        """Pad target for the packers: the warm rung a warm or padded
        route lands on for mesh shard ``device``, or None (the packers
        then round up themselves)."""
        return self.route(n_sets, k_req, m_req, device=int(device))["rung"]

    # -- fallback ---------------------------------------------------------

    def fallback_verify(self, sets) -> bool:
        """Synchronous host verification of a shed flush on the C
        verifier (``cpu-native``), verdict-identical to the device call,
        including the device backend's infinity pre-screens; exceptions
        propagate like the direct call's would (the scheduler's bisection
        delivers them to exactly the leaf submission that caused them).
        A failed C build raises: there is no further fallback."""
        t0 = time.perf_counter()
        try:
            with tracing.span(
                "compile_service.fallback_verify", n_sets=len(sets)
            ), _FALLBACK_SECONDS.time():
                if self._fallback_fn is not None:
                    return bool(self._fallback_fn(list(sets)))
                from ..crypto import bls as _bls

                prepared = []
                for item in sets:
                    if isinstance(item, _bls.SignatureSet):
                        if not item.signing_keys or item.signature.is_infinity():
                            return False
                        if any(pk.point.is_infinity() for pk in item.signing_keys):
                            return False
                        prepared.append(
                            (
                                item.signature,
                                [pk.point for pk in item.signing_keys],
                                item.message,
                            )
                        )
                    else:
                        prepared.append(item)
                return bool(
                    self._fallback_backend_inst().verify_signature_sets(
                        prepared
                    )
                )
        finally:
            t1 = time.perf_counter()
            with self._cv:
                self._fallback_calls += 1
                self._fallback_sets += len(sets)
                self._fallback_seconds += t1 - t0
            # a CPU resolution ships zero host-to-device bytes: its row
            # keeps the ledger exactly-once across resolution paths (kind
            # and path from the scheduler's context on this thread), on a
            # raise too
            transfer_ledger.record_cpu(len(sets))
            # the card idles for a capture-caused reason while a shed
            # flush resolves on the CPU: `compile` activity, and the
            # current flush record's `fallback` phase
            pipeline_profiler.note_fallback_wall(t0, t1)

    def _fallback_backend_inst(self):
        if self._fallback_backend is None:
            from ..crypto.native import NativeBackend

            self._fallback_backend = NativeBackend()
        return self._fallback_backend

    # -- warmth notification ---------------------------------------------

    def note_rung_verified(
        self, b: int, k: int, m: int, epoch: int | None = None,
        device: int = 0, seconds: float | None = None,
        n_sets: int | None = None,
    ) -> None:
        """A verify at (b, k, m) just ran, so its stage graphs exist:
        mark the rung warm (unless ``epoch``, read before the dispatch, is
        stale). ``seconds``/``n_sets`` feed the measured cost per set;
        each rung's first dispatch, which paid the captures, is kept out
        of the aggregate."""
        rung = (int(b), int(k), int(m))
        if seconds is not None and n_sets:
            with self._cv:
                rec = self._rung_costs.setdefault(
                    (rung, int(device)), [0, 0.0, 0]
                )
                warm = rec[0] > 0
                rec[0] += 1
                rec[1] += float(seconds)
                rec[2] += int(n_sets)
                if warm:
                    self._cost_sum_s += float(seconds)
                    self._cost_sum_sets += int(n_sets)
                    _MEASURED_COST.set(self._cost_sum_s / self._cost_sum_sets)
        impl = self._impl()
        if self.registry.mark_ready(rung, impl, epoch=epoch, device=device):
            self._record_ready(rung, impl, seconds=None, source="organic",
                               device=device)

    def measured_rung_costs(self) -> dict:
        """Per (rung, device) serving cost, ``"BxKxM@devD" -> {dispatches,
        sum_s, sum_sets, s_per_set}`` over every dispatch, and the
        aggregate warm-only ``s_per_set`` (first dispatches excluded)."""
        with self._cv:
            rungs = {
                "x".join(str(v) for v in rung) + f"@dev{dev}": {
                    "dispatches": n,
                    "sum_s": round(s, 6),
                    "sum_sets": sets,
                    "s_per_set": round(s / sets, 9) if sets else None,
                }
                for (rung, dev), (n, s, sets)
                in sorted(self._rung_costs.items())
            }
            total_s, total_sets = self._cost_sum_s, self._cost_sum_sets
        return {
            "rungs": rungs,
            "s_per_set": (
                round(total_s / total_sets, 9) if total_sets else None
            ),
            "sum_sets": total_sets,
        }

    def _record_ready(self, rung: Rung, impl: str, seconds: float | None,
                      source: str, device: int = 0) -> None:
        with self._cv:  # the worker and organic-warmth verify threads
            self._compiled_total += 1
        flight_recorder.record(
            "compile_ready",
            b=rung[0], k=rung[1], m=rung[2],
            fp_impl=impl,
            seconds=None if seconds is None else round(seconds, 3),
            source=source,
            persisted=False,
            device=device,
        )

    # -- background worker ------------------------------------------------

    def _loop(self) -> None:
        # a worker superseded by a later start() exits instead of
        # draining the queue twice
        me = threading.current_thread()
        while True:
            with self._cv:
                while True:
                    if self._stopped or self._thread is not me:
                        return
                    self._promote_due_retries_locked()
                    if self._queue:
                        break
                    wait = None
                    if self._retry_at:
                        wait = max(
                            0.01,
                            min(self._retry_at.values()) - time.monotonic(),
                        )
                    self._cv.wait(wait)
                item = self._queue.popleft()
                self._queued.discard(item)
                self._in_flight = item
                _QUEUE_DEPTH.set(len(self._queue))
            try:
                self._compile_rung(item)
            finally:
                with self._cv:
                    # only OUR marker (and the gauge): a superseding
                    # worker may be mid-warm-up on its own rung
                    if self._in_flight == item:
                        self._in_flight = None
                        _IN_FLIGHT.set(0)
                    self._cv.notify_all()

    def _promote_due_retries_locked(self) -> None:
        """Move due retries back onto the queue (under the cv)."""
        if not self._retry_at:
            return
        now = time.monotonic()
        due = [it for it, t in self._retry_at.items() if t <= now]
        for it in due:
            del self._retry_at[it]
            if it not in self._queued and it != self._in_flight:
                self._queued.add(it)
                self._queue.append(it)
        if due:
            _QUEUE_DEPTH.set(len(self._queue))

    def _schedule_retry(self, rung: Rung, dev: int, impl: str,
                        error: BaseException) -> None:
        """A rung failed: re-queue it after a bounded, jittered backoff,
        unless its attempt budget is spent (it then stays cold)."""
        key = (rung, int(dev))
        with self._cv:
            attempts = self._attempts.get(key, 0) + 1
            self._attempts[key] = attempts
            if attempts >= self.retry_max_attempts:
                return
            if key in self._queued or key in self._retry_at:
                return
            delay = min(
                self.retry_max_s,
                self.retry_base_s * (2.0 ** (attempts - 1)),
            ) * random.uniform(0.5, 1.0)
            self._retry_at[key] = time.monotonic() + delay
            self._retries_total += 1
            self._cv.notify_all()
        _COMPILE_RETRIES.inc()
        b, k, m = rung
        flight_recorder.record(
            "compile_retry",
            b=b, k=k, m=m, fp_impl=impl, device=dev,
            attempt=attempts,
            max_attempts=self.retry_max_attempts,
            delay_s=round(delay, 3),
            error=repr(error)[:200],
        )

    def _compile_rung(self, item) -> None:
        # item is ((B, K, M), device); a bare (B, K, M) means device 0
        if len(item) == 2 and isinstance(item[0], tuple):
            rung, dev = item
        else:
            rung, dev = tuple(item), 0
        impl = self._impl()
        if self.registry.is_warm(rung, impl, device=dev):
            return  # warmed by traffic while queued
        if not self._device_healthy(dev):
            return  # a lost shard's rungs are dead weight, not work
        epoch = self.registry.epoch
        b, k, m = rung
        flight_recorder.record(
            "compile_started", b=b, k=k, m=m, fp_impl=impl, source="aot",
            device=dev,
        )
        _IN_FLIGHT.set(1)
        t0 = time.perf_counter()
        try:
            with tracing.span(
                "compile_service.compile", b=b, k=k, m=m, fp_impl=impl,
                device=dev,
            ):
                # chaos seam: an armed `compile` fault point raises here
                # and exercises the retry layer as a failed capture would
                fault_injection.fire("compile")
                if self._compile_rung_fn is not None:
                    stages = self._compile_rung_fn(b, k, m)
                else:
                    from . import lowering

                    stages = lowering.warm_staged(b, k, m, device=self.device,
                                                  shard=dev)
        except Exception as e:  # a failed rung must not kill the worker
            with self._cv:
                self._failed_total += 1
                self._last_error = f"{b}x{k}x{m}: {e!r}"[:300]
            # stage-attributed accounting: the stages that warmed before
            # the failure count ok, the one that raised counts error (all
            # three when the failure names no stage)
            partial = getattr(e, "partial", None) or {}
            failed_stage = getattr(e, "stage", None)
            for stage, rec in partial.items():
                _COMPILES.with_labels(stage, "ok").inc()
                _COMPILE_SECONDS.with_labels(stage).observe(
                    float(rec.get("seconds", 0.0)))
            failed = ((failed_stage,) if failed_stage is not None else
                      tuple(st for st in ("stage1", "stage2", "stage3")
                            if st not in partial))
            for stage in failed:
                _COMPILES.with_labels(stage, "error").inc()
            flight_recorder.record(
                "compile_failed", b=b, k=k, m=m, fp_impl=impl,
                error=repr(e)[:200], device=dev,
                attempt=self._attempts.get((rung, dev), 0) + 1,
            )
            _log.warning("compile service rung %sx%sx%s failed: %r", b, k, m, e)
            self._schedule_retry(rung, dev, impl, e)
            return
        seconds = time.perf_counter() - t0
        with self._cv:
            self._attempts.pop((rung, dev), None)
            self._stage_records[(rung, dev)] = dict(stages or {})
        for stage, rec in (stages or {}).items():
            _COMPILES.with_labels(stage, "ok").inc()
            _COMPILE_SECONDS.with_labels(stage).observe(
                float(rec.get("seconds", 0.0)))
        if self._compile_rung_fn is None:
            self._warm_extras(b, k, impl, dev)
        if self.registry.mark_ready(rung, impl, epoch=epoch, device=dev):
            self._record_ready(rung, impl, seconds=seconds, source="aot",
                               device=dev)

    def _warm_extras(self, b: int, k: int, impl: str, dev: int) -> None:
        """The gathered variant's gather (when a key table is attached)
        and, when MSM warming is on, one cold MSM rung, smallest first. A
        failure here degrades those paths only, not the staged rung."""
        from . import lowering

        try:
            from ..crypto.device import key_table as _kt

            tbl = _kt.get_active_table()
            if tbl is not None:
                # against this shard's own replica
                grec = lowering.warm_gather(b, k, tbl, shard=dev)
                _COMPILES.with_labels("gather", "ok").inc()
                _COMPILE_SECONDS.with_labels("gather").observe(
                    float(grec.get("seconds", 0.0)))
        except Exception as e:
            _COMPILES.with_labels("gather", "error").inc()
            _log.warning("gather warm-up at B=%s K=%s failed: %r", b, k, e)
        if not msm_warm_enabled():
            return
        for n in MSM_RUNGS:
            mkey = (impl, dev, n)
            if mkey in self._msm_warmed or self._stopped:
                continue
            try:
                mrec = lowering.warm_msm(n, device=self.device, shard=dev)
                _COMPILES.with_labels("msm", "ok").inc()
                _COMPILE_SECONDS.with_labels("msm").observe(
                    float(mrec.get("seconds", 0.0)))
                self._msm_warmed.add(mkey)
            except Exception as e:
                _COMPILES.with_labels("msm", "error").inc()
                _log.warning("MSM warm-up at N=%s failed: %r", n, e)
            break

    # -- introspection ----------------------------------------------------

    def status(self) -> dict:
        """The warm surface, queue, retries, cold-route counts, the shed
        fallback (its backend, calls, sets and seconds), measured rung
        costs, each warmed rung's per-stage seconds, and the captured
        graphs (``graphs.status()``: nodes, pool bytes, lock waits)."""
        from ..crypto.device import graphs

        with self._cv:
            multi = len(self._devices) > 1

            def item(rung, dev):
                # one shard keeps the [B, K, M] rendering; a mesh walk
                # appends the shard a queued warm-up is for
                return [*rung, dev] if multi else list(rung)

            def label(rung, dev):
                return "x".join(map(str, rung)) + (f"@dev{dev}" if multi else "")

            queue = [item(r, dev) for r, dev in self._queue]
            in_flight = None if self._in_flight is None else item(*self._in_flight)
            now = time.monotonic()
            doc = {
                "running": self.active(),
                "plan": [list(r) for r in self.plan],
                "warm_rungs": [list(r) for r in self.registry.warm_rungs()],
                "queue": queue,
                "in_flight": in_flight,
                "compiled_total": self._compiled_total,
                "failed_total": self._failed_total,
                "last_error": self._last_error,
                "cold_routes": dict(self._cold_routes),
                "retry": {
                    "max_attempts": self.retry_max_attempts,
                    "base_s": self.retry_base_s,
                    "retries_total": self._retries_total,
                    "pending": [
                        [*rung, dev, round(max(0.0, due - now), 2)]
                        for (rung, dev), due in sorted(self._retry_at.items())
                    ],
                },
                "msm_warm": sorted(n for _i, _d, n in self._msm_warmed),
                "fallback": {
                    # the C verifier, or a test's fallback_verify_fn
                    "backend": (
                        "cpu-native" if self._fallback_fn is None else "injected"
                    ),
                    "built": self._fallback_backend is not None,
                    "calls": self._fallback_calls,
                    "sets": self._fallback_sets,
                    "seconds": round(self._fallback_seconds, 6),
                },
                "stages": {
                    label(rung, dev): recs
                    for (rung, dev), recs in self._stage_records.items()
                },
            }
            if multi:
                doc["mesh_devices"] = list(self._devices)
                doc["warm_rungs_by_device"] = [
                    list(r) for r in self.registry.warm_rungs_all()
                ]
        doc["rung_costs"] = self.measured_rung_costs()
        doc["graphs"] = graphs.status()
        return doc


# ---------------------------------------------------------------------------
# The process-global service: the seam ``CudaBackend`` reads without a
# handle passed through every caller.
# ---------------------------------------------------------------------------

_service_lock = threading.Lock()
_service: Optional[CompileService] = None


def set_service(svc: Optional[CompileService]) -> None:
    global _service
    with _service_lock:
        _service = svc


def clear_service(svc: Optional[CompileService] = None) -> None:
    """Detach the global service (only if it still is ``svc`` when one is
    given: a racing rebuild must not lose its fresh service)."""
    global _service
    with _service_lock:
        if svc is None or _service is svc:
            _service = None


def get_service() -> Optional[CompileService]:
    return _service


def get_active_service() -> Optional[CompileService]:
    svc = _service
    if svc is not None and svc.active():
        return svc
    return None


def invalidate_registry() -> None:
    """Invalidate the global service's warm-shape registry (no-op without
    one)."""
    svc = _service
    if svc is not None:
        svc.invalidate()


def env_enabled() -> bool:
    return os.environ.get(_ENV_ENABLED, "1") not in ("", "0")
