"""Cross-caller continuous batching for BLS signature-set verification:
the port's copy of the JAX package's ``verification_service/batcher.py``.

Per-batch fixed overhead (host pack, dispatch, padded lanes, and on the
card the fixed time of the stage graphs) amortizes only at large B, yet
every gossip caller would otherwise issue its own synchronous
``bls.verify_signature_sets`` call. :class:`VerificationScheduler` is
the continuous-batching layer between the verifiers and the backend:
concurrent producers ``submit(sets, kind)`` and a flush thread fuses
their submissions into shared batches padded onto the bucket ladder the
device packers use (``planner.BUCKET_LADDER``), so the set of captured
stage graphs stays bounded across traffic shapes.

Semantics contract: per-submission verdicts are IDENTICAL to a direct
per-caller ``verify_signature_sets`` call.

* A fused batch that verifies True proves every member submission would
  verify True on its own (the standard 2^-64 random-linear-combination
  soundness).
* A fused batch that verifies False (or raises) is split and retried
  (bisection) until the poisoned submission(s) are isolated; a LEAF
  verdict is literally the direct call on that submission's sets.
* An empty submission resolves False at once and never joins a batch.

Flush triggers, by priority: shutdown drain, explicit ``flush()``,
bucket full (``max_batch_sets`` pending), deadline (the oldest
submission waited ``deadline_ms``), and the bulk class at deadline-class
idle.

Backpressure: the pending queue is bounded by ``max_queue_sets``; a
submission that would overflow it is SHED: verified synchronously in
the caller's thread (same verdict, no fusing) and journaled as a
``scheduler_shed`` flight-recorder event. Latency-critical callers
(block verification) use :meth:`verify_now`, a counted synchronous
bypass.

Bulk QoS class: ``submit(sets, kind, qos="bulk")`` queues deadline-
insensitive work (chain-segment backfill, historical sync) on a second
bounded queue that the flush thread serves only when the deadline class
is idle, ``bulk_flush_sets`` (default 512) at a time, lingering
``bulk_linger_ms`` (default 100) for a trickle. Admission is governed by
:class:`.admission.BulkAdmissionController`; bulk-queue overflow
degrades to the CALLER's thread, never to the flush thread.

Verdict-latency SLO: every submission's submit-to-verdict latency is
observed on EVERY resolution path (``fused``, ``sub_batch``,
``bisection``, ``shed``, ``bypass``, ``fallback``, ``empty``, ``bulk``,
``bulk_shed``) into ``verification_scheduler_verdict_latency_seconds
{kind,path}`` and the rolling window of :mod:`.slo`. A deadline-class
verdict later than ``slo_grace * deadline_ms`` (default 2x,
``LIGHTHOUSE_TPU_SCHED_SLO_GRACE``) is a miss: the deadline is the
queue wait by construction, so the grace is the service budget.

Flush planning: the planner (:mod:`.planner`) splits a flush into
kind-homogeneous bin-packed sub-batches when that cuts padded lanes and
keeps the single-rung plan otherwise; each sub-batch is routed,
dispatched and bisected on its own, and submissions stay atomic.

Cold-rung protection: with a
:class:`~lighthouse_tpu_torch.compile_service.CompileService` attached,
every sub-batch (and every shed or ``verify_now`` call) is routed
first. ``warm`` and ``padded`` dispatch on the card (``CudaBackend``
pads to the warm rung); ``shed`` (no warm rung covers it) is served by
the service's synchronous ``fallback_verify`` on the C verifier (same
verdict, path ``fallback``) while the service's worker captures the
rung's stage graphs. Bisection retries do not route: they call the
sub-batch's verifier directly, as in the JAX package.

Device mesh: with a mesh attached (``crypto/device/mesh.py``), plans
gain the dp shard axis over the mesh's healthy shards and each shard's
own warm rungs. Sub-batches on different shards dispatch concurrently,
one worker thread each, and each sub-batch's whole resolution tree
(bisection retries included) runs in its shard's dispatch scope. Losing
a card degrades instead of erroring: the first raise on a shard triggers
one re-verify of the same sets on a failover shard. If that succeeds
the card is the problem: the shard is dropped (``shard_lost``,
probation) and the failover's verdict stands. If it raises the same way
the work is the problem: the shard keeps its health and the exception
propagates as without a mesh. ``verify_now`` dispatches on the primary
healthy shard and fails over once the same way.

Dispatch watchdog: with a deadline (``watchdog_s``, env
``LIGHTHOUSE_TPU_SCHED_WATCHDOG_S``; ``watchdog_bypass_s`` and
``LIGHTHOUSE_TPU_SCHED_WATCHDOG_BYPASS_S`` for ``verify_now``; both 0 =
off by default, since a cold rung's captures legitimately take seconds)
each sharded dispatch runs on a monitored daemon thread, which enters
the shard's dispatch scope itself (CUDA's current device is per
thread). Past the deadline the dispatch is abandoned (its result is
discarded), counted in ``verification_scheduler_watchdog_reaped_total``,
journaled as ``watchdog_reaped``, and raises :class:`WatchdogTimeout`
into the failover path above.

Telemetry, at the JAX scheduler's hook points: each flush is one
pipeline-profiler record (``flush_begin``, the plan's wall, a
``flush_scope`` on every dispatching thread, ``flush_end`` journals one
``pipeline_flush`` event), the flush thread's empty-queue waits are
``queue_empty`` activity, every backend call runs in a transfer-ledger
``context(kind, path)``, and every resolution and bulk admission is noted
to the slot ledger. A thread the scheduler starts for a dispatch (a
mesh shard's flush worker, the watchdog's thread) enters the caller's
flush scope and ledger context itself: both are thread-local.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional

from ..crypto import bls
from ..crypto.device import mesh as mesh_mod
from ..utils import (
    flight_recorder,
    metrics,
    pipeline_profiler,
    slot_ledger,
    tracing,
    transfer_ledger,
)
from .admission import BulkAdmissionController
from .planner import BUCKET_LADDER, FlushPlanner, round_up_bucket
from .slo import SloTracker

__all__ = [
    "BUCKET_LADDER",
    "VerificationScheduler",
    "WatchdogTimeout",
    "backend_verify",
    "backend_verify_bulk",
    "backend_verify_each",
    "backend_verify_now",
    "round_up_bucket",
    "scheduler_of",
]

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


_FUSED_BATCHES = metrics.counter_vec(
    "verification_scheduler_fused_batches_total",
    "backend batches dispatched (one per sub-batch under a planned "
    "split), labeled by the sorted caller-kind mix — mixed labels "
    "(e.g. aggregate+sync_message+unaggregated) appear on single-rung "
    "flushes; a planned split dispatches kind-homogeneous labels",
    ("kinds",),
)
_SUBMISSIONS = metrics.counter_vec(
    "verification_scheduler_submissions_total",
    "submissions resolved, by caller kind and verdict outcome",
    ("kind", "outcome"),
)
_SETS_TOTAL = metrics.counter_vec(
    "verification_scheduler_sets_total",
    "signature sets fused into shared batches, per caller kind",
    ("kind",),
)
_FLUSHES = metrics.counter_vec(
    "verification_scheduler_flushes_total",
    "batch flushes by trigger (full = bucket ceiling reached, deadline = "
    "oldest submission hit the latency budget, explicit, shutdown)",
    ("trigger",),
)
_OCCUPANCY = metrics.gauge(
    "verification_scheduler_batch_occupancy_ratio",
    "live lanes / padded lanes (B*K*M, the shared formula in "
    "verification_service/planner.py) of the most recent flush's "
    "DEVICE-dispatched sub-batches; sub-batches shed to the CPU "
    "fallback are excluded",
)
_PAD_WASTE = metrics.gauge(
    "verification_scheduler_padding_waste_ratio",
    "1 - occupancy of the most recent device-dispatched flush plan "
    "(the lanes the device pays for that no caller asked for) — the "
    "SAME formula as bls_device_padding_waste_ratio (equality pinned "
    "per geometry by test; under a planned split this gauge aggregates "
    "the whole plan while the device gauge holds its last sub-batch)",
)
_QUEUE_DEPTH = metrics.gauge(
    "verification_scheduler_queue_depth",
    "signature sets currently queued awaiting a flush",
)
_QUEUE_WAIT = metrics.histogram(
    "verification_scheduler_queue_wait_seconds",
    "submit-to-dispatch wait per DEADLINE-class submission (bounded by "
    "the deadline) — bulk submissions are excluded: a bulk "
    "wait spans linger + gossip-busy windows + throttle excursions by "
    "design and would explode this histogram's tail while gossip is "
    "perfectly healthy; bulk wait is visible in "
    "verification_scheduler_verdict_latency_seconds{path=bulk} and the "
    "bulk queue-depth gauge",
)
_BISECTIONS = metrics.counter(
    "verification_scheduler_bisections_total",
    "split-and-retry group verifications run to isolate poisoned "
    "submissions after a fused batch failed",
)
_SHED = metrics.counter_vec(
    "verification_scheduler_shed_total",
    "submissions shed to synchronous caller fallback on a full queue",
    ("kind",),
)
_BYPASS = metrics.counter_vec(
    "verification_scheduler_bypass_total",
    "synchronous verify_now calls (latency-critical callers, e.g. block "
    "verification) that skip the fusing queue",
    ("kind",),
)
_PLANS = metrics.counter_vec(
    "verification_scheduler_plans_total",
    "flush-planner decisions: planned = kind-homogeneous bin-packed "
    "sub-batches, single = the legacy one-rung flush (planner "
    "disabled, could not win, or would go cold while the single rung "
    "is warm)",
    ("mode",),
)
_PLAN_SUBBATCHES = metrics.counter_vec(
    "verification_scheduler_plan_subbatches_total",
    "sub-batches dispatched by the flush planner, labeled by the "
    "sub-batch's sorted caller-kind mix (kind-homogeneous under a "
    "planned split)",
    ("kind",),
)
_PLAN_LANES = metrics.counter_vec(
    "verification_scheduler_plan_lanes_total",
    "device lanes (B*K*M cells) of DEVICE-dispatched sub-batches: live "
    "= lanes callers asked for, padded = lanes of the rung the flush "
    "actually routed to (the shared padding-waste formula, "
    "verification_service/planner.py). Sub-batches shed to the CPU "
    "fallback are not counted — the device paid nothing for them",
    ("lane",),
)
_VERDICT_LATENCY = metrics.histogram_vec(
    "verification_scheduler_verdict_latency_seconds",
    "end-to-end submit-to-verdict latency per submission, on EVERY "
    "resolution path: fused (single-rung flush), sub_batch (planned "
    "split), bisection (split-and-retry leaf), shed (backpressure "
    "caller-thread fallback), bypass (verify_now), fallback "
    "(compile-service CPU-native shed), empty (immediate False), bulk "
    "(bulk-class idle-time flush), bulk_shed (bulk-queue overflow "
    "degraded to the caller's thread) — the submitter-experienced "
    "latency the SLO layer certifies",
    ("kind", "path"),
)
_DP_SHARDS = metrics.gauge(
    "verification_scheduler_dp_shards",
    "healthy dp mesh shards the flush planner currently packs onto "
    "(crypto/device/mesh.py; 0 = no mesh attached — single-device "
    "dispatch). Losing a card decrements this and the node keeps "
    "serving on the rest",
)
_DP_SUBBATCHES = metrics.counter_vec(
    "verification_scheduler_dp_subbatches_total",
    "sharded sub-batches dispatched per dp shard (the shard axis of a "
    "(dp x rung) flush plan; unsharded single-device dispatches are "
    "not counted here — see verification_scheduler_plan_subbatches_"
    "total for the rung axis)",
    ("shard",),
)
_DP_SETS = metrics.counter_vec(
    "verification_scheduler_dp_sets_total",
    "signature sets dispatched per dp shard by the flush planner — "
    "with bls_device_shard_sets_total this splits the aggregate "
    "sets/s story into scheduler-side and device-side halves",
    ("shard",),
)
_WATCHDOG_REAPED = metrics.counter_vec(
    "verification_scheduler_watchdog_reaped_total",
    "sharded dispatches abandoned by the watchdog after exceeding the "
    "configured deadline (each converts into the card-loss failover "
    "path: the same sets re-verify on a failover shard and the hung "
    "card enters probation — see the watchdog_reaped journal kind)",
    ("shard",),
)
_ARRIVALS = metrics.counter_vec(
    "verification_scheduler_arrival_sets_total",
    "signature sets ARRIVING at the scheduler per caller kind and entry "
    "path (submit = the fusing queue, incl. submissions later shed; "
    "bypass = verify_now), counted at submission time — NOT at flush "
    "time like verification_scheduler_sets_total, whose rate saturates "
    "at serving capacity exactly when the arrival rate matters most. "
    "A capacity sampler rates this family into an arrival rate, the "
    "utilization numerator",
    ("kind", "path"),
)
_BULK_QUEUE_DEPTH = metrics.gauge(
    "verification_scheduler_bulk_queue_depth",
    "signature sets queued in the bulk QoS class awaiting an idle-time "
    "flush — bounded by the bulk queue knob; overflow "
    "degrades to the caller's thread, so this gauge can saturate but "
    "never grow without bound. The deadline class's queue is "
    "verification_scheduler_queue_depth",
)
_BULK_SETS = metrics.counter_vec(
    "verification_scheduler_bulk_sets_total",
    "signature sets SERVED by the bulk class per caller kind: queued "
    "drains counted at flush time, overflow sheds counted when their "
    "caller-thread verify resolves (shed bulk is still bulk service — "
    "the capacity estimator's utilization numerator must see it). With "
    "verification_scheduler_sets_total (flushed, both classes) this "
    "splits served throughput by QoS class; the capacity sampler "
    "rates it into capacity_bulk_sets_per_sec",
    ("kind",),
)
_BULK_SHED = metrics.counter_vec(
    "verification_scheduler_bulk_shed_total",
    "bulk submissions degraded to synchronous verification in their "
    "CALLER's thread on bulk-queue overflow (the documented degradation "
    "order: bulk sheds first, self-paced, never onto gossip's flush "
    "thread)",
    ("kind",),
)
_DEADLINE_MISSES = metrics.counter_vec(
    "verification_scheduler_deadline_misses_total",
    "submissions whose verdict landed after the SLO budget (slo_grace x "
    "deadline_ms, default 2x — queue-wait allowance plus equal service "
    "headroom) measured from SUBMISSION time, regardless of which flush "
    "trigger fired; each miss journals a deadline_miss flight-recorder "
    "event. The deadline alone is the flush TRIGGER; this family is "
    "what makes it an SLO",
    ("kind",),
)


class WatchdogTimeout(RuntimeError):
    """A sharded dispatch exceeded the watchdog deadline and was
    abandoned: handled exactly like a raised dispatch (failover decides
    whether the card or the work is the problem)."""


class _Submission:
    __slots__ = ("kind", "sets", "future", "submitted_at", "qos")

    def __init__(self, kind: str, sets: List, qos: str = "deadline"):
        self.kind = kind
        self.sets = sets
        self.qos = qos
        self.future: Future = Future()
        self.submitted_at = time.monotonic()


class VerificationScheduler:
    """Thread-safe cross-caller batcher: ``submit(sets, kind) -> Future``
    fuses submissions from concurrent producers into shared
    ``verify_signature_sets`` batches (see module docstring for the
    verdict-identity contract)."""

    def __init__(
        self,
        verify_fn: Optional[Callable[[list], bool]] = None,
        deadline_ms: float | None = None,
        max_batch_sets: int | None = None,
        max_queue_sets: int | None = None,
        compile_service=None,
        plan_flushes: bool | None = None,
        flush_planner=None,
        slo_grace: float | None = None,
        bulk_max_queue_sets: int | None = None,
        bulk_flush_sets: int | None = None,
        bulk_linger_ms: float | None = None,
        bulk_admission: Optional[BulkAdmissionController] = None,
        watchdog_s: float | None = None,
        watchdog_bypass_s: float | None = None,
    ):
        # default: the port's batch verifier, which runs on the card
        self._verify = verify_fn or bls.verify_signature_sets
        # warm-shape router (compile_service/service.py); None = every
        # flush dispatches directly, cold compiles and all
        self._compile_service = compile_service
        # shape-aware flush planner (planner.py): partitions a fused
        # flush into kind-homogeneous bin-packed sub-batches when that
        # beats the legacy single-rung pad-up. plan_flushes=False (or
        # LIGHTHOUSE_TPU_SCHED_PLANNER=0) pins the legacy plan
        self._planner = (
            flush_planner
            if flush_planner is not None
            else FlushPlanner(enabled=plan_flushes)
        )
        self.deadline_s = (
            deadline_ms
            if deadline_ms is not None
            else _env_float("LIGHTHOUSE_TPU_SCHED_DEADLINE_MS", 25.0)
        ) / 1000.0
        self.max_batch_sets = int(
            max_batch_sets
            if max_batch_sets is not None
            else _env_int("LIGHTHOUSE_TPU_SCHED_MAX_BATCH", 256)
        )
        self.max_queue_sets = int(
            max_queue_sets
            if max_queue_sets is not None
            else _env_int("LIGHTHOUSE_TPU_SCHED_MAX_QUEUE", 2048)
        )
        # verdict-SLO budget multiplier (see module docstring: deadline
        # = max queue wait by construction, so the budget adds service
        # headroom; <1x would brand trigger noise a miss)
        self.slo_grace = max(
            1.0,
            slo_grace
            if slo_grace is not None
            else _env_float("LIGHTHOUSE_TPU_SCHED_SLO_GRACE", 2.0),
        )
        # dispatch watchdog deadlines (module docstring): 0 = off, the
        # default (a cold rung's captures take seconds, so the deadline
        # is an operator decision; the bypass has its own knob)
        self.watchdog_s = float(
            watchdog_s
            if watchdog_s is not None
            else _env_float("LIGHTHOUSE_TPU_SCHED_WATCHDOG_S", 0.0)
        )
        self.watchdog_bypass_s = float(
            watchdog_bypass_s
            if watchdog_bypass_s is not None
            else _env_float("LIGHTHOUSE_TPU_SCHED_WATCHDOG_BYPASS_S", 0.0)
        )
        self._watchdog_reaped = 0
        # bulk QoS class (module docstring): a second bounded
        # queue serviced only when the deadline class is idle, drained
        # in big-rung chunks, governed by the admission controller
        self.bulk_max_queue_sets = int(
            bulk_max_queue_sets
            if bulk_max_queue_sets is not None
            else _env_int("LIGHTHOUSE_TPU_SCHED_MAX_BULK_QUEUE", 8192)
        )
        self.bulk_flush_sets = max(1, int(
            bulk_flush_sets
            if bulk_flush_sets is not None
            else _env_int("LIGHTHOUSE_TPU_SCHED_BULK_FLUSH_SETS", 512)
        ))
        self.bulk_linger_s = max(0.0, (
            bulk_linger_ms
            if bulk_linger_ms is not None
            else _env_float("LIGHTHOUSE_TPU_SCHED_BULK_LINGER_MS", 100.0)
        ) / 1000.0)
        # while throttled the flush thread re-polls admission at this
        # cadence instead of parking forever (resume is time-driven:
        # the latch expiry and the headroom dial move without a wake)
        self._bulk_recheck_s = 0.25
        self._admission = (
            bulk_admission
            if bulk_admission is not None
            else BulkAdmissionController()
        )
        self._bulk_flushes = 0
        self._bulk_sets_flushed = 0
        self._bulk_shed = 0
        # throttle-transition latch for the slot ledger's parked sets:
        # one note per excursion, never per recheck poll
        self._bulk_parked_noted = False
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: deque[_Submission] = deque()
        self._pending_sets = 0
        self._bulk_pending: deque[_Submission] = deque()
        self._bulk_pending_sets = 0
        self._flush_requested = False
        self._stopped = True  # not accepting until start()
        self._thread: Optional[threading.Thread] = None
        # own counters for status(): the health endpoint should not have
        # to parse the exposition to describe the scheduler
        self._fused_batches = 0
        self._bisections = 0
        self._shed = 0
        self._buckets_seen: set[int] = set()
        self._last_occupancy = 0.0
        self._plans_planned = 0
        self._plans_single = 0
        self._last_plan: Optional[dict] = None
        # rolling verdict-latency window (the /lighthouse/health slo
        # block and the replay harness read THIS scheduler's window, not
        # the process-global cumulative histograms); the tracker also
        # owns the lifetime miss totals — one source of truth
        self._slo = SloTracker()
        # the admission controller's burn-latch read is THIS scheduler's
        # tracker (an injected controller may already carry its own)
        if self._admission.tracker is None:
            self._admission.tracker = self._slo

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "VerificationScheduler":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stopped = False
            self._thread = threading.Thread(
                target=self._loop, name="verification-scheduler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting queued work and drain: everything already
        submitted resolves (final flush, trigger=shutdown); later
        ``submit`` calls fall back to a synchronous direct call."""
        with self._cv:
            if self._stopped and self._thread is None:
                return
            self._stopped = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        self._thread = None

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stopped

    # -- submission -------------------------------------------------------

    def submit(self, sets, kind: str, qos: str = "deadline") -> Future:
        """Queue one caller's signature sets for fused verification.
        Returns a Future resolving to the same bool a direct
        ``bls.verify_signature_sets(sets)`` call would return.
        ``qos="bulk"`` routes deadline-insensitive work (chain-segment
        backfill, slasher ingest) onto the bulk class — idle-time
        big-rung flushes under admission control (module docstring) —
        with the same verdict-identity contract."""
        if qos not in ("deadline", "bulk"):
            raise ValueError(f"unknown qos class {qos!r}")
        if qos == "bulk":
            return self._submit_bulk(sets, kind)
        sub = _Submission(kind, list(sets))
        if not sub.sets:
            # matches verify_signature_sets([]) == False; must not join a
            # fused batch where it would have no sets to vote with
            self._finish(sub, False, path="empty")
            return sub.future
        # arrival accounting: counted at SUBMISSION time —
        # shed submissions included (they arrived; the queue just could
        # not hold them) — so the capacity estimator's utilization
        # numerator keeps climbing past saturation instead of reading
        # serving throughput back as demand
        _ARRIVALS.with_labels(kind, "submit").inc(len(sub.sets))
        shed = False
        with self._cv:
            if self._stopped:
                shed = True  # not running: degrade to the direct call
            elif (
                self._pending
                and self._pending_sets + len(sub.sets) > self.max_queue_sets
            ):
                # backpressure: full queue sheds to caller fallback. An
                # oversized submission on an EMPTY queue is accepted — it
                # flushes as its own batch and could never fit otherwise.
                shed = True
            if shed:
                self._shed += 1
            else:
                was_empty = not self._pending
                self._pending.append(sub)
                self._pending_sets += len(sub.sets)
                _QUEUE_DEPTH.set(self._pending_sets)
                if was_empty or self._pending_sets >= self.max_batch_sets:
                    # wake the flush thread: it must (re)arm the deadline
                    # timer for a fresh queue, or fire the bucket-full flush
                    self._cv.notify()
        if shed:
            _SHED.with_labels(kind).inc()
            flight_recorder.record(
                "scheduler_shed",
                kind=kind,
                n_sets=len(sub.sets),
                queue_sets=self._pending_sets,
                bound=self.max_queue_sets,
                running=self.running(),
            )
            self._shed_resolve(
                sub, "scheduler.shed_fallback", f"shed:{kind}", "shed"
            )
        return sub.future

    def _submit_bulk(self, sets, kind: str) -> Future:
        """Bulk-class admission: enqueue on the bounded bulk
        queue — serviced only at deadline-class idle — or, on overflow
        (or a stopped scheduler), degrade to a synchronous verify in
        the CALLER's thread: the self-paced pre-scheduler behavior,
        identical verdict, never a burden on gossip's flush thread."""
        sub = _Submission(kind, list(sets), qos="bulk")
        if not sub.sets:
            self._finish(sub, False, path="empty")
            return sub.future
        _ARRIVALS.with_labels(kind, "bulk").inc(len(sub.sets))
        # drive the throttle latch from the arrival side too, FORCED
        # past the evaluator's rate limit: the first bulk submission
        # after headroom collapses must journal the bulk_throttle
        # BEFORE any of its sets could queue — the ordering the
        # acceptance gate pins (throttle precedes the miss burst, not
        # the other way around) — and a rate-limited read would return
        # the stale pre-collapse state for arrivals landing within
        # min_interval_s of the flush loop's last evaluation. The
        # result is deliberately NOT cached: admission state is read
        # fresh off the controller's latch everywhere (a cached flag
        # written from two threads could overwrite a fresh throttle
        # with a stale admitted and let one chunk flush mid-excursion)
        self._admission.evaluate(force=True)
        shed = False
        with self._cv:
            if self._stopped:
                shed = True
            elif (
                self._bulk_pending
                and self._bulk_pending_sets + len(sub.sets)
                > self.bulk_max_queue_sets
            ):
                # overflow sheds to the caller's thread; an oversized
                # submission on an EMPTY bulk queue is accepted (same
                # live-lock rule as the deadline queue)
                shed = True
            if shed:
                self._bulk_shed += 1
            else:
                self._bulk_pending.append(sub)
                self._bulk_pending_sets += len(sub.sets)
                _BULK_QUEUE_DEPTH.set(self._bulk_pending_sets)
                # wake the flush thread: it must (re)arm the bulk
                # linger/full timer (a gossip-idle thread may be parked
                # with no deadline armed at all)
                self._cv.notify()
        if shed:
            _BULK_SHED.with_labels(kind).inc()
            flight_recorder.record(
                "scheduler_shed",
                kind=kind,
                qos="bulk",
                n_sets=len(sub.sets),
                queue_sets=self._bulk_pending_sets,
                bound=self.bulk_max_queue_sets,
                running=self.running(),
            )
            self._shed_resolve(
                sub, "scheduler.bulk_shed", f"bulk_shed:{kind}", "bulk_shed"
            )
            # shed bulk IS bulk service (verified in the caller's
            # thread, possibly on the device): counted into the served
            # family so the capacity estimator's utilization numerator
            # (timeseries.sample) sees the work — an uncounted shed
            # stream would let headroom over-read exactly while the
            # device is busiest with it
            _BULK_SETS.with_labels(kind).inc(len(sub.sets))
        return sub.future

    def _shed_resolve(
        self, sub: "_Submission", span_name: str, caller: str, path: str,
    ) -> None:
        """ONE shed rule for both QoS classes: leaf resolution in the
        CALLER's thread — verdict, outcome accounting and exception
        delivery all match the direct call the submission degraded to.
        Cold-rung protection applies to EVERY shed path: a degraded
        caller must never block seconds on a rung's graph captures (the
        compile-service fallback serves it instead, relabeling the
        resolution path)."""
        with tracing.span(span_name, kind=sub.kind, n_sets=len(sub.sets)):
            verify = None
            svc = self._compile_service
            if svc is not None and svc.active():
                decision = svc.decide_flush(sub.sets, caller=caller)
                if decision["action"] == "shed":
                    verify = svc.fallback_verify
                    path = "fallback"
            self._resolve_group([sub], verify, path=path)

    def verify_now(self, sets, kind: str = "block") -> bool:
        """Synchronous bypass for latency-critical callers: identical to
        a direct backend call, counted so dashboards can see how much
        traffic skips the fusing queue."""
        sets = list(sets)
        _BYPASS.with_labels(kind).inc()
        if sets:
            _ARRIVALS.with_labels(kind, "bypass").inc(len(sets))
        t0 = time.monotonic()
        path = "bypass"
        try:
            with tracing.span("scheduler.bypass", kind=kind, n_sets=len(sets)):
                # the bypass dispatches on the mesh's primary healthy
                # shard (after a card loss the block path keeps serving
                # on the survivors), resolved first so the warm check
                # below consults the shard that will dispatch
                mesh = mesh_mod.get_active_mesh()
                primary = mesh.primary_shard() if mesh is not None else None
                svc = self._compile_service
                if svc is not None and svc.active():
                    # even the latency-critical bypass must not stall on a
                    # cold rung's graph captures: shed to the service's
                    # counted synchronous fallback (identical verdict)
                    decision = svc.decide_flush(
                        sets, caller=f"verify_now:{kind}",
                        device_index=primary or 0,
                    )
                    if decision["action"] == "shed":
                        # SLO path follows the RESOLUTION, not the entry:
                        # a bypass served by the CPU fallback has the
                        # fallback's latency profile, and filing it under
                        # `bypass` would blame device dispatch for a
                        # cold-route cost (the other fallback call sites
                        # already label it this way)
                        path = "fallback"
                        with transfer_ledger.context(kind, path):
                            return svc.fallback_verify(sets)
                with transfer_ledger.context(kind, path):
                    if mesh is not None and primary is not None:
                        t_mesh = time.monotonic()
                        try:
                            out = self._dispatch_on(
                                self._verify, sets, primary,
                                self.watchdog_bypass_s,
                            )
                        except BaseException as e:  # noqa: BLE001 — failover decides
                            # one retry on a failover shard, the
                            # sub-batches' contract; a failover that raises
                            # the same way means the work is the problem
                            # and the raise reaches the caller
                            return self._failover_retry(
                                self._verify, sets, primary, e, mesh,
                                watchdog_s=self.watchdog_bypass_s,
                            )
                        mesh.note_dispatch(primary, len(sets),
                                           time.monotonic() - t_mesh)
                        return out
                    return self._verify(sets)
        finally:
            # the bypass IS this caller's end-to-end latency: no queue,
            # but a cold-route fallback or a slow device dispatch can
            # still blow the deadline — it must feed the same SLO
            # surface the queued paths do (a raise still observes; the
            # caller paid the wall time either way)
            self._observe_latency(
                kind, path, time.monotonic() - t0, len(sets)
            )

    def flush(self) -> None:
        """Ask the flush thread to dispatch whatever is pending now."""
        with self._cv:
            self._flush_requested = True
            self._cv.notify()

    # -- flush loop -------------------------------------------------------

    def _oldest_deadline(self) -> Optional[float]:
        if not self._pending:
            return None
        return self._pending[0].submitted_at + self.deadline_s

    def _bulk_due_locked(self, now: float) -> Optional[float]:
        """The time the bulk queue becomes eligible to flush — ``now``
        once a full big-rung chunk is pending, else the oldest bulk
        submission's linger expiry; None when the queue is empty or
        admission is paused. Called under the lock; bulk eligibility
        additionally requires the deadline class to be idle (the
        caller checks ``self._pending`` — never preempt)."""
        if not self._bulk_pending or self._admission.throttled():
            return None
        if self._bulk_pending_sets >= self.bulk_flush_sets:
            return now
        return self._bulk_pending[0].submitted_at + self.bulk_linger_s

    def _loop(self) -> None:
        while True:
            # admission DRIVEN outside the cv (it reads the capacity
            # estimator and may journal a transition); the lock-held
            # due computation reads the controller's latch directly —
            # never a cached flag (see _submit_bulk)
            if self._bulk_pending_sets or self._admission.throttled():
                self._admission.evaluate()
                # chain time: on entering a throttle excursion, the sets
                # sitting in the bulk queue are PARKED, noted once per
                # excursion to the slot the valve closed in
                throttled_now = self._admission.throttled()
                if throttled_now and not self._bulk_parked_noted:
                    parked = self._bulk_pending_sets
                    if parked:
                        slot_ledger.note_bulk(parked_sets=parked)
                self._bulk_parked_noted = throttled_now
            trigger = None
            bulk = False
            with self._cv:
                while True:
                    if self._stopped:
                        trigger = "shutdown"
                        break
                    if self._flush_requested:
                        trigger = "explicit"
                        break
                    if self._pending_sets >= self.max_batch_sets:
                        trigger = "full"
                        break
                    deadline = self._oldest_deadline()
                    now = time.monotonic()
                    if deadline is not None and now >= deadline:
                        trigger = "deadline"
                        break
                    # bulk services ONLY at deadline-class idle (never
                    # preempts), and only while admitted
                    bulk_due = self._bulk_due_locked(now)
                    if (
                        not self._pending
                        and bulk_due is not None
                        and now >= bulk_due
                    ):
                        trigger = "bulk"
                        bulk = True
                        break
                    waits = []
                    if deadline is not None:
                        waits.append(deadline - now)
                    if bulk_due is not None and not self._pending:
                        waits.append(bulk_due - now)
                    if self._bulk_pending and self._admission.throttled():
                        # throttled with bulk waiting: the resume signal
                        # (latch expiry, headroom recovery) moves without
                        # a notify — re-poll instead of parking forever
                        waits.append(self._bulk_recheck_s)
                    # an empty-queue wait is the `queue_empty` bubble
                    # cause: a device gap beside it is traffic's, not the
                    # pipeline's (timed only when the DEADLINE queue is
                    # empty: parked bulk is idle by design). Opened
                    # eagerly, so a verify_now gap closing while this
                    # thread still waits sees it
                    idle_t0 = (
                        time.perf_counter() if not self._pending else None
                    )
                    if idle_t0 is not None:
                        pipeline_profiler.note_idle_begin(idle_t0)
                    self._cv.wait(min(waits) if waits else None)
                    if idle_t0 is not None:
                        pipeline_profiler.note_idle_end(
                            idle_t0, time.perf_counter()
                        )
                    if self._bulk_pending and self._admission.throttled():
                        # re-evaluate admission outside the lock before
                        # the next wait round
                        break
                if trigger is None:
                    continue  # admission recheck wake
                if bulk:
                    subs = self._drain_bulk_locked()
                else:
                    subs = self._drain_locked()
                    if trigger == "shutdown" and not subs:
                        # the shutdown drain covers BOTH classes: gossip
                        # first (priority holds to the end), then bulk
                        # in big-rung chunks until empty — admission
                        # cannot veto the drain contract (every queued
                        # future resolves)
                        subs = self._drain_bulk_locked()
                        bulk = bool(subs)
                self._flush_requested = False
                stopped = self._stopped
            if subs:
                self._flush_batch(
                    subs, trigger, qos="bulk" if bulk else "deadline"
                )
            elif stopped:
                return

    @staticmethod
    def _drain_from(queue, cap: int) -> List[_Submission]:
        """ONE drain rule for both QoS classes: take at most ``cap``
        sets off ``queue`` in whole submissions (a submission is the
        isolation unit and never splits across fused batches; the
        first submission is always taken so an oversized one cannot
        live-lock). Called under the lock."""
        subs: List[_Submission] = []
        n = 0
        while queue:
            nxt = queue[0]
            if subs and n + len(nxt.sets) > cap:
                break
            subs.append(queue.popleft())
            n += len(nxt.sets)
        return subs

    def _drain_locked(self) -> List[_Submission]:
        """One bucket's worth off the deadline queue (under the lock)."""
        subs = self._drain_from(self._pending, self.max_batch_sets)
        self._pending_sets -= sum(len(s.sets) for s in subs)
        _QUEUE_DEPTH.set(self._pending_sets)
        return subs

    def _drain_bulk_locked(self) -> List[_Submission]:
        """One big-rung chunk (``bulk_flush_sets``) off the bulk queue
        (under the lock)."""
        subs = self._drain_from(self._bulk_pending, self.bulk_flush_sets)
        self._bulk_pending_sets -= sum(len(s.sets) for s in subs)
        _BULK_QUEUE_DEPTH.set(self._bulk_pending_sets)
        return subs

    def _flush_batch(
        self, subs: List[_Submission], trigger: str, qos: str = "deadline",
    ) -> None:
        n_sets = sum(len(s.sets) for s in subs)
        kinds_mix = "+".join(sorted({s.kind for s in subs}))
        now = time.monotonic()
        for s in subs:
            if qos != "bulk":
                # bulk waits (linger + gossip-busy windows + throttle
                # excursions) are the class contract, not queue latency
                # — they'd pollute the deadline-class histogram's tail
                _QUEUE_WAIT.observe(now - s.submitted_at)
            _SETS_TOTAL.with_labels(s.kind).inc(len(s.sets))
            if qos == "bulk":
                _BULK_SETS.with_labels(s.kind).inc(len(s.sets))
        if qos == "bulk":
            self._bulk_flushes += 1
            self._bulk_sets_flushed += n_sets
            # chain time: the sets the admission valve let through
            slot_ledger.note_bulk(admitted_sets=n_sets)
        # one pipeline-profiler record per flush: queue wait (the oldest
        # submission's; 0 for bulk, whose wait is its class contract),
        # plan, pack, device and fallback walls from this thread and the
        # shard workers (flush_scope below); flush_end journals one
        # pipeline_flush event (None when the profiler is off)
        prec = pipeline_profiler.flush_begin(
            trigger=trigger, kinds=kinds_mix, n_submissions=len(subs),
            n_sets=n_sets, queue_wait_s=(
                0.0 if qos == "bulk" else now - subs[0].submitted_at
            ),
        )
        svc = self._compile_service
        if svc is not None and not svc.active():
            svc = None
        # the plan: one legacy-style sub-batch, or kind-homogeneous
        # bin-packed sub-batches when that wins on padded lanes
        # (planner.py). With a compile service attached the planner only
        # splits onto rungs the warm registry can serve; with a device
        # mesh attached plans gain the dp shard axis and the warm set is
        # per shard (a cold shard sheds instead of stalling the flush).
        mesh = mesh_mod.get_active_mesh()
        shards = mesh.healthy_shards() if mesh is not None else None
        _DP_SHARDS.set(len(shards) if shards else 0)
        warm = None
        if svc is not None:
            try:
                if shards:
                    # per shard even at width 1: after a card loss the
                    # surviving shard may not be shard 0, and its own
                    # warmth must drive the plan
                    warm = svc.warm_rungs_by_shard(shards)
                else:
                    warm = svc.warm_rungs_active()
            except Exception:
                warm = None
        t_plan = time.perf_counter()
        plan = self._planner.plan(subs, warm_rungs=warm, shards=shards, qos=qos)
        pipeline_profiler.note_plan_wall(t_plan, time.perf_counter(), record=prec)
        _PLANS.with_labels(plan.mode).inc()
        _FLUSHES.with_labels(trigger).inc()
        waste = plan.waste()
        if plan.mode == "planned":
            self._plans_planned += 1
        else:
            self._plans_single += 1
        self._last_plan = {
            "mode": plan.mode,
            "n_sub_batches": len(plan.sub_batches),
            "rungs": plan.rungs_label(),
            "dp_shards": plan.shards_used(),
            "padding_waste": round(waste, 4),
            "est_h2d_bytes": plan.est_h2d_bytes,
            "est_live_h2d_bytes": plan.est_live_h2d_bytes,
        }
        bisections_before = self._bisections
        all_ok = True
        dev_live = dev_padded = 0  # lanes of DEVICE-dispatched sub-batches
        results: List[Optional[dict]] = [None] * len(plan.sub_batches)
        # the dp axis is the parallelism: sub-batches on different shards
        # dispatch concurrently (one worker per sub-batch, bounded by the
        # plan) and the flush thread joins them; a single-shard (or
        # unsharded) plan keeps the serial dispatch
        multi_shard = len({sb.shard for sb in plan.sub_batches}) > 1
        with tracing.span(
            "scheduler.flush",
            trigger=trigger,
            qos=qos,
            kinds=kinds_mix,
            n_submissions=len(subs),
            n_sets=n_sets,
            mode=plan.mode,
            n_sub_batches=len(plan.sub_batches),
            dp_shards=len(plan.shards_used()),
        ) as sp:
            def run_one(idx: int, sb) -> None:
                # the profiler scope rides on the dispatching thread (the
                # flush thread, or a shard worker): pack, device and
                # fallback walls under it attribute to THIS flush
                with pipeline_profiler.flush_scope(prec):
                    try:
                        results[idx] = self._dispatch_sub_batch(
                            sb, svc, mesh, plan.mode, trigger, qos
                        )
                    except BaseException as e:  # noqa: BLE001 — futures first
                        # a worker must never strand its futures: whatever
                        # slipped past the dispatch path's own handling is
                        # delivered to every submission (the caller sees
                        # the raise a direct call would have surfaced)
                        for s in sb.subs:
                            self._account(s, "sub_batch")
                            _SUBMISSIONS.with_labels(s.kind, "error").inc()
                            if not s.future.done():
                                s.future.set_exception(e)

            if multi_shard:
                workers = [
                    threading.Thread(
                        target=run_one, args=(i, sb),
                        name=f"flush-shard-{sb.shard}", daemon=True,
                    )
                    for i, sb in enumerate(plan.sub_batches)
                ]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join()
            else:
                for i, sb in enumerate(plan.sub_batches):
                    run_one(i, sb)
            # bookkeeping on the flush thread (the workers only verify;
            # the self._* counters keep one writer)
            for sb, rec in zip(plan.sub_batches, results):
                if rec is None:
                    all_ok = False
                    continue
                self._fused_batches += 1
                self._buckets_seen.add(sb.rung[0])
                if rec["route"] != "shed":
                    dev_live += sb.live
                    dev_padded += rec["paid"]
                all_ok = all_ok and rec["ok"]
            sp.set(verdict=all_ok)
        # one pipeline_flush event per flush: bisections, shed sub-batches
        # and worker crashes included (the record closed is the one opened)
        pipeline_profiler.flush_end(
            prec, verdict=all_ok, mode=plan.mode,
            n_sub_batches=len(plan.sub_batches),
            dp_shards=plan.shards_used(),
        )
        if dev_padded:
            # gauges describe device lanes only (consistent with
            # verification_scheduler_plan_lanes_total): an all-shed
            # flush dispatched nothing and leaves them untouched
            occupancy = dev_live / float(dev_padded)
            _OCCUPANCY.set(occupancy)
            _PAD_WASTE.set(1.0 - occupancy)
            self._last_occupancy = occupancy
        flight_recorder.record(
            "scheduler_plan",
            mode=plan.mode,
            qos=qos,
            n_submissions=len(subs),
            n_sets=n_sets,
            n_sub_batches=len(plan.sub_batches),
            static_sub_batches=sum(
                1 for sb in plan.sub_batches if getattr(sb, "static", False)
            ),
            dp_shards=plan.shards_used(),
            rungs=plan.rungs_label(),
            live_lanes=plan.live,
            padded_lanes=plan.padded,
            legacy_padded_lanes=plan.legacy_padded,
            waste=round(waste, 4),
            est_h2d_bytes=plan.est_h2d_bytes,
            est_live_h2d_bytes=plan.est_live_h2d_bytes,
            kinds=kinds_mix,
        )
        flight_recorder.record(
            "scheduler_flush",
            trigger=trigger,
            qos=qos,
            kinds=kinds_mix,
            n_submissions=len(subs),
            n_sets=n_sets,
            bucket=(
                plan.sub_batches[0].rung[0]
                if plan.mode == "single"
                else None
            ),
            mode=plan.mode,
            occupancy=round(1.0 - waste, 4),  # plan-wide (journal = plan record)
            verdict=all_ok,
            bisections=self._bisections - bisections_before,
        )

    # -- sub-batch dispatch -------------------------------------------------

    def _dispatch_sub_batch(
        self, sb, svc, mesh, plan_mode: str, trigger: str,
        qos: str = "deadline",
    ) -> dict:
        """Execute ONE plan element: route it on its shard (cold-rung
        protection per element: a sub-batch that no warm rung on its
        shard covers is served through the compile service's counted
        synchronous fallback, and bisects there too), dispatch it on its
        dp shard when the plan is sharded, and resolve its submissions.
        Runs on the flush thread for serial plans and on a per-sub-batch
        worker for multi-shard plans: everything here is thread-safe."""
        verify = self._verify
        route_action = "direct"
        paid = sb.padded
        if svc is not None:
            try:
                decision = svc.decide_flush(
                    sb.sets,
                    caller=f"flush:{trigger}",
                    geometry=(sb.n_sets, sb.k_req, sb.m_req),
                    device_index=sb.shard or 0,
                )
                route_action = decision["action"]
                if route_action == "shed":
                    verify = svc.fallback_verify
                elif decision["rung"] is not None:
                    # the registry may have warmed between planning and
                    # routing: charge the rung the device will ACTUALLY
                    # pad to, not the one the plan assumed
                    rb, rk, rm = decision["rung"]
                    paid = rb * rk * rm
            except Exception:
                # a routing failure must never fail a flush: dispatch
                # direct (the pre-service behavior)
                verify = self._verify
                route_action = "direct"
        _FUSED_BATCHES.with_labels(sb.kinds).inc()
        _PLAN_SUBBATCHES.with_labels(sb.kinds).inc()
        if route_action != "shed":
            # a shed sub-batch runs on the CPU fallback: the device paid
            # no lanes for it
            _PLAN_LANES.with_labels("live").inc(sb.live)
            _PLAN_LANES.with_labels("padded").inc(paid)
        # SLO path label: the compile-service CPU fallback is its own
        # resolution path (its latency profile is nothing like a device
        # dispatch); a BULK flush resolves under its class's own label;
        # otherwise a planned split resolves via sub_batch, a single-rung
        # flush via fused
        if route_action == "shed":
            path = "fallback"
        elif qos == "bulk":
            path = "bulk"
        elif plan_mode == "planned":
            path = "sub_batch"
        else:
            path = "fused"
        sharded = mesh is not None and sb.shard is not None
        if sharded and route_action != "shed":
            # the failover wrapper scopes every call of this sub-batch's
            # resolution tree (bisection retries included) to its shard
            verify = self._sharded_verify(verify, sb.shard, mesh)
            _DP_SUBBATCHES.with_labels(str(sb.shard)).inc()
            _DP_SETS.with_labels(str(sb.shard)).inc(sb.n_sets)
        t0 = time.monotonic()
        with tracing.span(
            "scheduler.sub_batch",
            kinds=sb.kinds,
            n_sets=sb.n_sets,
            rung="x".join(str(v) for v in sb.rung),
            route=route_action,
            shard=sb.shard,
        ):
            ok = self._resolve_group(
                sb.subs, verify, fused=sb.sets, path=path
            )
        if sharded:
            flight_recorder.record(
                "shard_dispatch",
                shard=sb.shard,
                kinds=sb.kinds,
                n_sets=sb.n_sets,
                rung="x".join(str(v) for v in sb.rung),
                route=route_action,
                ok=ok,
                seconds=round(time.monotonic() - t0, 6),
            )
        return {"ok": ok, "route": route_action, "paid": paid}

    def _dispatch_on(self, verify, sets, shard, deadline_s: float):
        """One dispatch scoped to ``shard``, under the watchdog when
        ``deadline_s`` > 0: the call then runs on a monitored daemon
        thread that enters the shard's dispatch scope itself (CUDA's
        current device is per thread), and a dispatch that outlasts the
        deadline raises :class:`WatchdogTimeout` here; the caller turns it
        into the card-loss failover instead of wedging the flush thread
        on a hung device."""
        if not deadline_s or deadline_s <= 0:
            with mesh_mod.dispatch_to(shard):
                return verify(sets)
        # the watchdog's thread re-enters this thread's ledger context and
        # flush scope (both thread-local) with the shard's dispatch scope
        ctx = transfer_ledger.current_context()
        rec = pipeline_profiler.current_flush()
        box: dict = {}
        done = threading.Event()

        def target():
            try:
                with transfer_ledger.context(*ctx), \
                        pipeline_profiler.flush_scope(rec), \
                        mesh_mod.dispatch_to(shard):
                    box["ok"] = verify(sets)
            except BaseException as e:  # noqa: BLE001 — relayed below
                box["err"] = e
            finally:
                done.set()

        worker = threading.Thread(
            target=target, name=f"dispatch-wd-{shard}", daemon=True
        )
        worker.start()
        if not done.wait(deadline_s):
            with self._lock:
                self._watchdog_reaped += 1
            _WATCHDOG_REAPED.with_labels(str(shard)).inc()
            flight_recorder.record(
                "watchdog_reaped",
                shard=shard,
                deadline_s=deadline_s,
                n_sets=len(sets),
            )
            raise WatchdogTimeout(
                f"sharded dispatch on shard {shard} exceeded the "
                f"{deadline_s:g}s watchdog deadline"
            )
        if "err" in box:
            raise box["err"]
        return box["ok"]

    def _sharded_verify(self, verify, shard: int, mesh):
        """Wrap ``verify`` so the whole resolution tree of one sharded
        sub-batch dispatches on ``shard``, and so losing that card
        degrades instead of erroring: the first raise (or watchdog reap)
        triggers one failover re-verify of the same sets on another
        healthy shard (or the caller's own device when none is left);
        :meth:`_failover_retry` decides whether the card or the work is
        at fault. Later calls of the tree go straight to the failover
        shard."""
        state = {"failed_over": False}

        def run(sets):
            target = shard
            if state["failed_over"] or not mesh.is_healthy(shard):
                target = mesh.failover_shard(shard)
            if target is None:
                return verify(sets)  # every card lost: the caller's device
            t0 = time.monotonic()
            try:
                out = self._dispatch_on(verify, sets, target, self.watchdog_s)
            except BaseException as e:  # noqa: BLE001 — failover decides
                if target != shard:
                    raise  # the failover shard itself raised: a real error
                state["failed_over"] = True
                return self._failover_retry(verify, sets, shard, e, mesh)
            mesh.note_dispatch(target, len(sets), time.monotonic() - t0)
            return out

        return run

    def _failover_retry(self, verify, sets, shard: int, err, mesh,
                        watchdog_s: float | None = None):
        """Re-verify ``sets`` on the failover shard after ``shard`` raised
        ``err``. Success: the card is the problem, the shard is dropped
        (``note_failure`` journals ``shard_lost``) and the failover's
        verdict stands. A raise: the work is the problem, the shard keeps
        its health and the raise propagates."""
        fb = mesh.failover_shard(shard)
        wd = self.watchdog_s if watchdog_s is None else watchdog_s
        t0 = time.monotonic()
        try:
            if fb is not None:
                out = self._dispatch_on(verify, sets, fb, wd)
            else:
                out = verify(sets)
        except BaseException:
            mesh.note_failure(shard, err, lost=False)
            raise
        mesh.note_failure(shard, err, lost=True)
        if fb is not None:
            mesh.note_dispatch(fb, len(sets), time.monotonic() - t0)
        return out

    # -- verdict resolution (split-and-retry isolation) -------------------

    def _resolve_group(
        self, subs: List[_Submission], verify: Optional[Callable] = None,
        fused: Optional[list] = None, path: str = "fused",
    ) -> bool:
        """Verify ``subs`` as one fused call; on False — or on a raised
        backend exception, which a larger fused shape can hit even when
        each member's own call would not — bisect so every submission
        ends at exactly the verdict (or exception) its own direct call
        produces. Only a LEAF failure is delivered to a future.
        ``verify`` overrides the backend for the WHOLE resolution tree
        (the compile service's shed fallback); ``fused`` is the caller's
        already-flattened set list (bisection sub-calls re-flatten);
        ``path`` is the SLO resolution-path label every member resolves
        under (a bisected tree relabels its members ``bisection`` — the
        retries ARE the latency the submitter experienced)."""
        if verify is None:
            verify = self._verify
        # data-movement attribution: the backend's pack under this call
        # charges its bytes to this group's kind mix and resolution path
        # (a bisection retry's re-packed bytes land under path=bisection)
        kinds = "+".join(sorted({s.kind for s in subs}))
        try:
            with transfer_ledger.context(kinds, path):
                ok = bool(verify(
                    fused if fused is not None
                    else [st for s in subs for st in s.sets]
                ))
        except BaseException as e:  # noqa: BLE001 — flush thread survives
            if len(subs) == 1:
                sub = subs[0]
                # this fused call WAS the direct call: the caller would
                # have seen the raise, so the future carries it (and the
                # wall time it waited still counts against the SLO)
                _SUBMISSIONS.with_labels(sub.kind, "error").inc()
                self._account(sub, path)
                if not sub.future.done():
                    sub.future.set_exception(e)
                return False
            return self._bisect(subs, verify)
        if ok:
            for s in subs:
                self._finish(s, True, path)
            return True
        if len(subs) == 1:
            # leaf: this fused call WAS the direct per-caller call
            self._finish(subs[0], False, path)
            return False
        return self._bisect(subs, verify)

    def _bisect(
        self, subs: List[_Submission], verify: Optional[Callable] = None
    ) -> bool:
        with self._lock:  # dp shard workers may bisect concurrently
            self._bisections += 1
        _BISECTIONS.inc()
        flight_recorder.record(
            "scheduler_bisection",
            n_submissions=len(subs),
            n_sets=sum(len(s.sets) for s in subs),
            kinds="+".join(sorted({s.kind for s in subs})),
        )
        mid = len(subs) // 2
        left = self._resolve_group(subs[:mid], verify, path="bisection")
        right = self._resolve_group(subs[mid:], verify, path="bisection")
        return left and right

    def _finish(self, sub: _Submission, ok: bool, path: str) -> None:
        # accounting is unconditional — the resolution tree reaches each
        # submission exactly once, and an externally-cancelled future
        # must not make the counters (or the SLO window) undercount the
        # work the scheduler actually did; only the future mutation is
        # guarded
        self._account(sub, path)
        _SUBMISSIONS.with_labels(sub.kind, "ok" if ok else "invalid").inc()
        if not sub.future.done():
            sub.future.set_result(ok)

    # -- verdict-latency SLO ----------------------------------------------

    def _account(self, sub: _Submission, path: str) -> None:
        """One submission resolved: its end-to-end latency feeds the SLO
        surface exactly once, on whatever path delivered the verdict —
        under the submission's own QoS class, so a bisected or shed bulk
        submission stays bulk-class on every leaf."""
        self._observe_latency(
            sub.kind, path, time.monotonic() - sub.submitted_at,
            len(sub.sets), qos=sub.qos,
        )

    def _observe_latency(
        self, kind: str, path: str, latency_s: float, n_sets: int,
        qos: str = "deadline",
    ) -> None:
        budget_s = self.deadline_s * self.slo_grace
        # a bulk verdict is deadline-insensitive BY CONTRACT: it cannot
        # miss (its latency is the idle-time wait the class signed up
        # for) and must not reach the burn buckets either way (slo.py)
        missed = qos == "deadline" and latency_s > budget_s
        _VERDICT_LATENCY.with_labels(kind, path).observe(latency_s)
        self._slo.observe(kind, path, latency_s, missed, qos=qos)
        # chain time: the one point every resolution path funnels through,
        # so each submission lands on its slot's report card exactly once
        slot_ledger.note_resolution(
            kind, path, n_sets, latency_s, missed=missed, qos=qos
        )
        if missed:
            _DEADLINE_MISSES.with_labels(kind).inc()
            flight_recorder.record(
                "deadline_miss",
                kind=kind,
                path=path,
                n_sets=n_sets,
                latency_ms=round(latency_s * 1000.0, 3),
                deadline_ms=round(self.deadline_s * 1000.0, 3),
                budget_ms=round(budget_s * 1000.0, 3),
            )

    def slo_summary(self) -> dict:
        """Rolling p50/p99 + miss ratio per kind over the tracker window
        — the ``slo`` block `/lighthouse/health` serves and the replay
        harness reports."""
        doc = self._slo.summary(deadline_ms=self.deadline_s * 1000.0)
        doc["slo_grace"] = self.slo_grace
        doc["budget_ms"] = round(
            self.deadline_s * self.slo_grace * 1000.0, 3
        )
        doc["deadline_misses_total"] = self._slo.misses_total()
        return doc

    # -- introspection ----------------------------------------------------

    def status(self) -> dict:
        """One document for /lighthouse/health: queue depth, occupancy,
        config, and the padded buckets this process has dispatched (the
        recompile-bound surface)."""
        with self._lock:
            pending_subs = len(self._pending)
            pending_sets = self._pending_sets
            bulk_subs = len(self._bulk_pending)
            bulk_sets = self._bulk_pending_sets
        mesh = mesh_mod.get_active_mesh()  # read the seam once
        return {
            "running": self.running(),
            "queue_submissions": pending_subs,
            "queue_sets": pending_sets,
            # the bulk QoS class: per-class queue depth,
            # flush/shed totals and the live admission/throttle state —
            # the health rows an operator reads to see WHY backfill is
            # paused while gossip is fine
            "bulk": {
                "queue_submissions": bulk_subs,
                "queue_sets": bulk_sets,
                "max_queue_sets": self.bulk_max_queue_sets,
                "flush_sets": self.bulk_flush_sets,
                "linger_ms": round(self.bulk_linger_s * 1000.0, 3),
                "flushes_total": self._bulk_flushes,
                "sets_flushed_total": self._bulk_sets_flushed,
                "shed_total": self._bulk_shed,
                "admission": self._admission.status(),
            },
            "deadline_misses_total": self._slo.misses_total(),
            "max_batch_sets": self.max_batch_sets,
            "max_queue_sets": self.max_queue_sets,
            "deadline_ms": round(self.deadline_s * 1000.0, 3),
            "fused_batches_total": self._fused_batches,
            "bisections_total": self._bisections,
            "shed_total": self._shed,
            "watchdog_s": self.watchdog_s,
            "watchdog_bypass_s": self.watchdog_bypass_s,
            "watchdog_reaped_total": self._watchdog_reaped,
            "last_batch_occupancy": round(self._last_occupancy, 4),
            "buckets_seen": sorted(self._buckets_seen),
            "compile_service_attached": self._compile_service is not None,
            "dp_shards": len(mesh.healthy_shards()) if mesh is not None else 0,
            "planner": {
                "enabled": self._planner.enabled,
                "overhead_lanes": self._planner.overhead_lanes,
                "plans_planned_total": self._plans_planned,
                "plans_single_total": self._plans_single,
                "last_plan": self._last_plan,
            },
        }


# ---------------------------------------------------------------------------
# Caller-side helpers: one spelling for "verify these sets, fused when a
# scheduler is attached to the chain, direct otherwise".
# ---------------------------------------------------------------------------


def scheduler_of(chain) -> Optional[VerificationScheduler]:
    sched = getattr(chain, "verification_scheduler", None)
    if sched is not None and sched.running():
        return sched
    return None


def backend_verify(chain, sets, kind: str) -> bool:
    """One batch verification for ``chain``: submitted to the attached
    scheduler (cross-caller fusing) when present, else the direct
    backend call. Verdict identical either way."""
    sched = scheduler_of(chain)
    if sched is None:
        return bls.verify_signature_sets(sets)
    return sched.submit(sets, kind).result()


def backend_verify_each(chain, list_of_sets, kind: str) -> List[bool]:
    """Per-item fallback helper: verify each element of ``list_of_sets``
    independently. With a scheduler the items are submitted together
    first so they fuse into one retry batch instead of N serial calls."""
    sched = scheduler_of(chain)
    if sched is None:
        return [bls.verify_signature_sets(s) for s in list_of_sets]
    futures = [sched.submit(s, kind) for s in list_of_sets]
    return [f.result() for f in futures]


def backend_verify_now(chain, sets, kind: str = "block") -> bool:
    """Latency-critical callers (block verification): the scheduler's
    counted synchronous bypass when attached, else the direct call."""
    sched = scheduler_of(chain)
    if sched is None:
        return bls.verify_signature_sets(sets)
    return sched.verify_now(sets, kind)


def backend_verify_bulk(chain, sets, kind: str) -> bool:
    """Deadline-insensitive callers (chain-segment backfill, historical
    sync, slasher ingest): the scheduler's BULK class when attached —
    idle-time big-rung flushes under admission control, so a saturating
    backfill can never move gossip's p99 — else the direct call. The
    caller blocks on the verdict either way (segment import is
    sequential by nature, which is exactly the self-pacing the
    degradation order relies on). Verdict identical to a direct
    ``bls.verify_signature_sets(sets)``.

    A big segment is CHUNKED into ``bulk_flush_sets``-sized
    submissions here: submissions are atomic (the isolation unit never
    splits) and the drain always takes the first submission whole, so
    one multi-thousand-set submission would flush as one batch and
    occupy the flush thread for the segment's entire verify wall —
    breaking the documented head-of-line bound (a gossip arrival waits
    at most ONE in-flight bulk chunk). All chunks are submitted before
    any result is awaited (they fuse/pipeline at gossip idle), every
    future is consumed, and the all() verdict matches the single batch
    call's."""
    sched = scheduler_of(chain)
    if sched is None:
        return bls.verify_signature_sets(sets)
    sets = list(sets)
    if not sets:
        # matches verify_signature_sets([]) == False via the
        # scheduler's empty-submission path
        return sched.submit(sets, kind, qos="bulk").result()
    chunk = max(1, int(sched.bulk_flush_sets))
    futs = [
        sched.submit(sets[i:i + chunk], kind, qos="bulk")
        for i in range(0, len(sets), chunk)
    ]
    return all([f.result() for f in futs])
