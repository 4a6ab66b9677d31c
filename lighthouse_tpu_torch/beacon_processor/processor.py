"""Work-queue scheduler (see package docstring; reference
``beacon_processor/mod.rs``)."""

from __future__ import annotations

import enum
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils import flight_recorder, logging, metrics, tracing

_QUEUE_LEN = metrics.gauge("beacon_processor_queue_total", "queued work items")
_WORK_TOTAL = metrics.counter_vec(
    "beacon_processor_work_total", "work items executed per kind", ("kind",)
)
_HANDLE_SECONDS = metrics.histogram_vec(
    "beacon_processor_handle_seconds",
    "handler execution wall time per drained batch",
    ("kind",),
)
_BATCH_SIZE = metrics.histogram(
    "beacon_processor_batch_size",
    "coalesced attestation batch sizes",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
)
_WAIT_TIME = metrics.histogram(
    "beacon_processor_queue_wait_seconds", "submit-to-execution latency"
)
_DROPPED = metrics.counter(
    "beacon_processor_dropped_total", "work items shed on full queues"
)
_SHED_LATCH = logging.TimeLatch(10.0)


class WorkKind(enum.Enum):
    # priority order: lower value = drained first (reference's match order
    # in InboundEvents / the Work enum priorities)
    CHAIN_SEGMENT = 0
    GOSSIP_BLOCK = 1
    GOSSIP_AGGREGATE = 2
    GOSSIP_SYNC_CONTRIBUTION = 3
    GOSSIP_ATTESTATION = 4
    GOSSIP_SYNC_MESSAGE = 5
    API_REQUEST = 6


# Bounded queue sizes (reference mod.rs:84-105: 16_384 unagg, 4_096 agg,
# 1_024 blocks; sync queues sized like their attestation analogues).
DEFAULT_QUEUE_BOUNDS = {
    WorkKind.CHAIN_SEGMENT: 64,
    WorkKind.GOSSIP_BLOCK: 1_024,
    WorkKind.GOSSIP_AGGREGATE: 4_096,
    WorkKind.GOSSIP_SYNC_CONTRIBUTION: 4_096,
    WorkKind.GOSSIP_ATTESTATION: 16_384,
    WorkKind.GOSSIP_SYNC_MESSAGE: 16_384,
    WorkKind.API_REQUEST: 1_024,
}

# Device-bucket batch ceilings (the reference caps both at 64,
# mod.rs:176-177; the device backend's batch lanes are cheaper).
DEFAULT_BATCH_CEILINGS = {
    WorkKind.GOSSIP_ATTESTATION: 256,
    WorkKind.GOSSIP_AGGREGATE: 64,
    WorkKind.GOSSIP_SYNC_MESSAGE: 128,
}

# LIFO kinds (the reference drains attestations newest-first so stale
# items shed under load).
_LIFO = {WorkKind.GOSSIP_ATTESTATION, WorkKind.GOSSIP_SYNC_MESSAGE}


@dataclass
class Work:
    kind: WorkKind
    item: object
    submitted_at: float = field(default_factory=time.monotonic)
    done: Optional[Callable] = None  # called with the handler's result


class BeaconProcessor:
    """``handlers`` maps WorkKind -> callable. Batchable kinds receive a
    LIST of items; others receive one item. Results are delivered through
    each Work's ``done`` callback (None = fire-and-forget)."""

    def __init__(
        self,
        handlers: dict,
        n_workers: int = 2,
        queue_bounds: dict | None = None,
        batch_ceilings: dict | None = None,
    ):
        self.handlers = handlers
        self.queue_bounds = dict(queue_bounds or DEFAULT_QUEUE_BOUNDS)
        self.batch_ceilings = dict(batch_ceilings or DEFAULT_BATCH_CEILINGS)
        self._queues: dict[WorkKind, deque] = {k: deque() for k in WorkKind}
        self._lock = threading.Lock()
        self._work_ready = threading.Condition(self._lock)
        self._shutdown = False
        self._delayed: list[tuple[float, Work]] = []
        self._workers = [
            threading.Thread(target=self._worker_loop, name=f"bp-worker-{i}", daemon=True)
            for i in range(n_workers)
        ]
        self._timer = threading.Thread(target=self._delay_loop, daemon=True)
        for w in self._workers:
            w.start()
        self._timer.start()

    # -- submission ------------------------------------------------------

    def submit(self, work: Work) -> bool:
        """False if the bounded queue is full and the item was shed
        (reference queue-overflow shedding, mod.rs:1179-1204)."""
        with self._lock:
            if self._shutdown:
                return False
            q = self._queues[work.kind]
            if len(q) >= self.queue_bounds[work.kind]:
                _DROPPED.inc()
                flight_recorder.record(
                    "queue_shed", kind=work.kind.name, queue_len=len(q),
                    bound=self.queue_bounds[work.kind],
                    total_queued=sum(len(x) for x in self._queues.values()),
                )
                logging.rate_limited(
                    _SHED_LATCH, "warn", "work queue full, shedding",
                    kind=work.kind.name,
                )
                return False
            q.append(work)
            _QUEUE_LEN.set(sum(len(q) for q in self._queues.values()))
            self._work_ready.notify()
            return True

    def submit_later(self, work: Work, delay_s: float) -> None:
        """Re-processing queue: schedule for re-submission after a delay
        (reference work_reprocessing_queue — early blocks / attestations
        for unknown blocks)."""
        with self._lock:
            self._delayed.append((time.monotonic() + delay_s, work))

    # -- worker loop -----------------------------------------------------

    def _next_batch(self) -> Optional[tuple[WorkKind, list[Work]]]:
        """Called under the lock: drain by priority, coalescing batchable
        kinds up to their ceiling."""
        for kind in sorted(WorkKind, key=lambda k: k.value):
            q = self._queues[kind]
            if not q:
                continue
            ceiling = self.batch_ceilings.get(kind, 1)
            batch = []
            while q and len(batch) < ceiling:
                batch.append(q.pop() if kind in _LIFO else q.popleft())
            _QUEUE_LEN.set(sum(len(q) for q in self._queues.values()))
            return kind, batch
        return None

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                got = self._next_batch()
                while not self._shutdown and got is None:
                    self._work_ready.wait(timeout=0.1)
                    got = self._next_batch()
                if got is None:  # shutdown with empty queues
                    return
                kind, batch = got
            now = time.monotonic()
            for w in batch:
                _WAIT_TIME.observe(now - w.submitted_at)
            if kind in self.batch_ceilings:
                _BATCH_SIZE.observe(len(batch))
            self._execute(kind, batch)

    def _execute(self, kind: WorkKind, batch: list[Work]) -> None:
        handler = self.handlers.get(kind)
        if handler is None:
            return
        _WORK_TOTAL.with_labels(kind.name).inc(len(batch))
        with tracing.span(
            "beacon_processor.execute", kind=kind.name, batch=len(batch)
        ), _HANDLE_SECONDS.with_labels(kind.name).time():
            self._execute_inner(kind, batch, handler)

    def _execute_inner(self, kind: WorkKind, batch: list[Work], handler) -> None:
        if kind in self.batch_ceilings:
            try:
                results = handler([w.item for w in batch])
                if results is None:
                    results = [None] * len(batch)
                else:
                    results = list(results)
            except Exception as e:  # handler bugs must not kill the worker
                results = [e] * len(batch)
            if len(results) < len(batch):
                # a short handler return must never strand a done callback
                short = RuntimeError("batch handler returned too few results")
                results += [short] * (len(batch) - len(results))
            for w, r in zip(batch, results):
                self._complete(w, r)
        else:
            for w in batch:
                try:
                    r = handler(w.item)
                except Exception as e:
                    r = e
                self._complete(w, r)

    @staticmethod
    def _complete(w: Work, result) -> None:
        """Invoke the callback exactly once; its own exceptions are the
        callback owner's bug, not a reason to re-complete anything."""
        if w.done:
            try:
                w.done(result)
            except Exception:
                pass

    def _delay_loop(self) -> None:
        while True:
            time.sleep(0.02)
            with self._lock:
                if self._shutdown:
                    return
                now = time.monotonic()
                ready = [w for t, w in self._delayed if t <= now]
                self._delayed = [(t, w) for t, w in self._delayed if t > now]
            for w in ready:
                self.submit(w)

    # -- lifecycle -------------------------------------------------------

    def queue_lengths(self) -> dict:
        with self._lock:
            return {k.name: len(q) for k, q in self._queues.items()}

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._work_ready.notify_all()
        for w in self._workers:
            w.join(timeout=5)
