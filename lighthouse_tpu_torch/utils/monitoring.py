"""Remote monitoring push (reference ``common/monitoring_api``
``src/lib.rs:63,105``: periodic POST of process + beacon-node health to
a remote monitoring endpoint).

One JSON document per interval::

    {"general": {"version", "timestamp"},
     "process": {"pid", "cpu_process_seconds_total", "memory_process_bytes"},
     "beacon_node": {"head_slot", "finalized_epoch", "peers", "sync_state"}}

A failed push retries with bounded exponential backoff plus jitter
(``base_backoff_s`` doubling up to ``max_backoff_s``) instead of waiting
the full interval — a briefly-down collector misses one document, not
several — and every attempt ticks ``monitoring_push_total{outcome}`` so
a silent push drought is scrapeable.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.request

from . import metrics

VERSION = "lighthouse_tpu/0.4.0"

_PUSH_TOTAL = metrics.counter_vec(
    "monitoring_push_total",
    "remote monitoring push attempts, by outcome (ok/error)",
    ("outcome",),
)


def collect(chain) -> dict:
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu_s = ru.ru_utime + ru.ru_stime
        rss = ru.ru_maxrss * 1024  # linux reports KiB
    except Exception:
        cpu_s, rss = 0.0, 0
    net = getattr(chain, "network", None)
    return {
        "general": {"version": VERSION, "timestamp": int(time.time() * 1000)},
        "process": {
            "pid": os.getpid(),
            "cpu_process_seconds_total": round(cpu_s, 2),
            "memory_process_bytes": rss,
        },
        "beacon_node": {
            "head_slot": int(chain.head_state.slot),
            "finalized_epoch": int(
                chain.fork_choice.store.finalized_checkpoint[0]
            ),
            "peers": net.transport.peer_count() if net is not None else 0,
            "sync_state": "Synced",
        },
    }


class MonitoringService:
    def __init__(
        self,
        chain,
        endpoint: str,
        interval_s: float = 60.0,
        base_backoff_s: float = 1.0,
        max_backoff_s: float | None = None,
    ):
        self.chain = chain
        self.endpoint = endpoint
        self.interval_s = interval_s
        self.base_backoff_s = base_backoff_s
        # retries never wait longer than the regular cadence
        self.max_backoff_s = (
            min(max_backoff_s, interval_s)
            if max_backoff_s is not None
            else interval_s
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.sent = 0
        self.errors = 0
        self._consecutive_failures = 0

    def start(self) -> "MonitoringService":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def push_once(self) -> bool:
        doc = collect(self.chain)
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                ok = 200 <= r.status < 300
        except Exception:
            ok = False
        if ok:
            self.sent += 1
            _PUSH_TOTAL.with_labels("ok").inc()
        else:
            self.errors += 1
            _PUSH_TOTAL.with_labels("error").inc()
        return ok

    def next_wait(self, consecutive_failures: int) -> float:
        """Seconds until the next push attempt: the regular interval
        after a success, bounded exponential backoff with jitter after
        ``consecutive_failures`` straight failures. Jitter multiplies by
        U[0.5, 1.0] so a fleet of nodes losing one collector does not
        retry in lockstep; the result never exceeds ``max_backoff_s``."""
        if consecutive_failures <= 0:
            return self.interval_s
        backoff = min(
            self.max_backoff_s,
            self.base_backoff_s * (2.0 ** (consecutive_failures - 1)),
        )
        return backoff * random.uniform(0.5, 1.0)

    def _loop(self) -> None:
        wait = self.interval_s
        while not self._stop.wait(wait):
            try:
                ok = self.push_once()
            except Exception:
                # a transient collect/push failure must never kill the
                # monitoring thread for the life of the process
                self.errors += 1
                _PUSH_TOTAL.with_labels("error").inc()
                ok = False
            self._consecutive_failures = (
                0 if ok else self._consecutive_failures + 1
            )
            wait = self.next_wait(self._consecutive_failures)
