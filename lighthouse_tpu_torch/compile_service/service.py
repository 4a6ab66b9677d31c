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
  :meth:`CompileService.pads_for` names.

Left out, and why (``ROADMAP.md``): the persistent compile cache and
its manifest (``cache.py``; a CUDA graph cannot be written to disk, and
the kernels' nvcc build already persists under ``_build/``); the CPU
fallback verifier of shed flushes (it has no caller until the
verification scheduler is ported; ``route`` still answers ``shed``);
mesh devices other than 0; the metrics and journal hooks.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional, Tuple

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
    graphs are captured; ``device`` is the mesh index (always 0 until the
    mesh is ported). :meth:`invalidate` bumps an epoch, so a warm-up that
    started before it cannot mark its rung warm afterwards."""

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


class CompileService:
    """Background AOT capture and warm-shape router for the staged
    verifier (see the module docstring). ``compile_rung_fn(b, k, m)`` is
    injectable for tests; the default captures the rung's stage graphs on
    ``device`` through :func:`lowering.warm_staged` (``cuda`` unless the
    caller asks for the CPU, where nothing is captured and the stages run
    once eagerly)."""

    def __init__(
        self,
        rungs: Optional[Iterable[Rung]] = None,
        compile_rung_fn: Optional[Callable[[int, int, int], dict]] = None,
        device="cuda",
    ):
        self.plan: Tuple[Rung, ...] = tuple(
            tuple(r) for r in (rungs or _env_rungs() or DEFAULT_RUNGS)
        )
        self.device = device
        self._compile_rung_fn = compile_rung_fn
        self.registry = WarmShapeRegistry()
        self._cv = threading.Condition()
        # work items are (rung, mesh device); only device 0 is queued
        # until the mesh is ported
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
            for rung in self.plan:
                self._enqueue_locked((rung, 0), front=False)
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
                self._enqueue_locked((rung, 0), front=False, even_in_flight=True)
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
        self._cv.notify_all()  # the worker, and any wait_idle() caller

    def request(self, b: int, k: int, m: int, device: int = 0) -> None:
        """Ask the worker to warm rung (b, k, m) next."""
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
        pubkeys per set and ``m_req`` distinct messages:
        ``{"action": warm|padded|shed, "rung": (B, K, M) | None, "exact":
        (B, K, M), "fp_impl": impl, "device": device}``. A registry read;
        :meth:`decide_flush` does the accounting."""
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
        """Route a flush, count a cold bucket and queue its exact rung, so
        that the next flush of this shape is warm. ``geometry`` is the
        caller's (n_sets, k_req, m_req) when it has it. ``padded`` is
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
            with self._cv:
                self._cold_routes[decision["action"]] += 1
            eb, ek, em = decision["exact"]
            self.request(eb, ek, em, device=int(device_index))
        return decision

    def warm_rungs_active(self, device: int = 0) -> list:
        """Warm (B, K, M) rungs on ``device`` under the port's engine."""
        impl = self._impl()
        return [
            (b, k, m)
            for (b, k, m, i, d) in self.registry.warm_rungs_all()
            if i == impl and d == int(device)
        ]

    def pads_for(
        self, n_sets: int, k_req: int, m_req: int, device: int = 0
    ) -> Optional[Rung]:
        """Pad target for the packers: the warm rung a warm or padded
        route lands on, or None (the packers then round up themselves)."""
        return self.route(n_sets, k_req, m_req, device=int(device))["rung"]

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
        if self.registry.mark_ready(rung, self._impl(), epoch=epoch, device=device):
            self._record_ready()

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

    def _record_ready(self) -> None:
        with self._cv:  # the worker and organic-warmth verify threads
            self._compiled_total += 1

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
            try:
                self._compile_rung(item)
            finally:
                with self._cv:
                    if self._in_flight == item:
                        self._in_flight = None
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

    def _schedule_retry(self, rung: Rung, dev: int) -> None:
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

    def _compile_rung(self, item) -> None:
        # item is ((B, K, M), device); a bare (B, K, M) means device 0
        if len(item) == 2 and isinstance(item[0], tuple):
            rung, dev = item
        else:
            rung, dev = tuple(item), 0
        impl = self._impl()
        if self.registry.is_warm(rung, impl, device=dev):
            return  # warmed by traffic while queued
        epoch = self.registry.epoch
        b, k, m = rung
        try:
            if self._compile_rung_fn is not None:
                stages = self._compile_rung_fn(b, k, m)
            else:
                from . import lowering

                stages = lowering.warm_staged(b, k, m, device=self.device)
        except Exception as e:  # a failed rung must not kill the worker
            with self._cv:
                self._failed_total += 1
                self._last_error = f"{b}x{k}x{m}: {e!r}"[:300]
            _log.warning("compile service rung %sx%sx%s failed: %r", b, k, m, e)
            self._schedule_retry(rung, dev)
            return
        with self._cv:
            self._attempts.pop((rung, dev), None)
            self._stage_records[(rung, dev)] = dict(stages or {})
        if self._compile_rung_fn is None:
            self._warm_extras(b, k, impl, dev)
        if self.registry.mark_ready(rung, impl, epoch=epoch, device=dev):
            self._record_ready()

    def _warm_extras(self, b: int, k: int, impl: str, dev: int) -> None:
        """The gathered variant's gather (when a key table is attached)
        and, when MSM warming is on, one cold MSM rung, smallest first. A
        failure here degrades those paths only, not the staged rung."""
        from . import lowering

        try:
            from ..crypto.device import key_table as _kt

            tbl = _kt.get_active_table()
            if tbl is not None:
                lowering.warm_gather(b, k, tbl)
        except Exception as e:
            _log.warning("gather warm-up at B=%s K=%s failed: %r", b, k, e)
        if not msm_warm_enabled():
            return
        for n in MSM_RUNGS:
            mkey = (impl, dev, n)
            if mkey in self._msm_warmed or self._stopped:
                continue
            try:
                lowering.warm_msm(n, device=self.device)
                self._msm_warmed.add(mkey)
            except Exception as e:
                _log.warning("MSM warm-up at N=%s failed: %r", n, e)
            break

    # -- introspection ----------------------------------------------------

    def status(self) -> dict:
        """The warm surface, queue, retries, cold-route counts, measured
        rung costs, each warmed rung's per-stage seconds, and the captured
        graphs (``graphs.status()``: nodes, pool bytes, lock waits)."""
        from ..crypto.device import graphs

        with self._cv:
            queue = [list(r) for r, _dev in self._queue]
            in_flight = None if self._in_flight is None else list(self._in_flight[0])
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
                "stages": {
                    "x".join(map(str, rung)): recs
                    for (rung, _dev), recs in self._stage_records.items()
                },
            }
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
