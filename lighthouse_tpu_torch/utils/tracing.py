"""Lightweight nested trace spans for the verification hot path.

The metrics registry answers "how much, how often"; this module answers
"where did THIS batch's wall-clock go": nested, attributed, thread-aware
timed spans exportable as chrome://tracing JSON (load the file at
``chrome://tracing`` or https://ui.perfetto.dev). The port's own copy of
the JAX package's ``utils/tracing.py``: same span API and export format,
its own buffer.

Design constraints (the hot path keeps its instrumentation always-on):

* DISABLED is the default and must cost well under 1 microsecond per
  enter/exit — ``span()`` returns a shared no-op context manager without
  allocating a span object.
* Enabled recording is thread-safe: spans nest per-thread via a
  thread-local stack; completed spans append to a bounded global buffer
  under one lock (two appends per span, no per-event I/O).
* Export emits chrome trace "X" (complete) events with microsecond
  timestamps relative to the trace epoch, plus thread-name metadata.

Enable with ``LIGHTHOUSE_TPU_TRACE=1`` in the environment or
:func:`enable` at runtime; :func:`clear` resets the buffer and epoch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List

_MAX_EVENTS = 200_000

_enabled = False
_lock = threading.Lock()
_events: List[dict] = []
_dropped = 0
_thread_names: Dict[int, str] = {}
_t0 = time.perf_counter()

_tls = threading.local()


class _NoopSpan:
    """Shared disabled-path singleton: enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:  # parity with _Span.set
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. the verdict)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = _tls.stack
        stack.pop()
        tid = threading.get_ident()
        args: Dict[str, Any] = {k: _jsonable(v) for k, v in self.attrs.items()}
        if stack:
            args["parent"] = stack[-1]
        if exc_type is not None:
            args["error"] = exc_type.__name__
        ev = {
            "name": self.name,
            "ph": "X",
            # clamp: a span straddling clear()'s epoch reset must not
            # emit a negative timestamp (chrome rejects them)
            "ts": max(0.0, round((self.t0 - _t0) * 1e6, 3)),
            "dur": round((t1 - self.t0) * 1e6, 3),
            "pid": os.getpid(),
            "tid": tid,
            "args": args,
        }
        global _dropped
        with _lock:
            if len(_events) < _MAX_EVENTS:
                _events.append(ev)
                if tid not in _thread_names:
                    _thread_names[tid] = threading.current_thread().name
            else:
                _dropped += 1
        return False


def _jsonable(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


def span(name: str, **attrs):
    """Context manager timing one named region; nests within the
    enclosing span of the same thread. ``attrs`` become chrome-trace
    ``args``. When tracing is disabled this is a shared no-op."""
    if not _enabled:
        return _NOOP
    return _Span(name, attrs)


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def clear() -> None:
    """Drop recorded events and restart the trace epoch."""
    global _dropped, _t0
    with _lock:
        _events.clear()
        _thread_names.clear()
        _dropped = 0
        _t0 = time.perf_counter()


def events() -> List[dict]:
    with _lock:
        return list(_events)


def dropped() -> int:
    with _lock:
        return _dropped


def chrome_trace() -> dict:
    """The chrome://tracing JSON object for everything recorded so far."""
    with _lock:
        evs = list(_events)
        names = dict(_thread_names)
    meta = [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": os.getpid(),
            "tid": tid,
            "args": {"name": tname},
        }
        for tid, tname in sorted(names.items())
    ]
    return {
        "traceEvents": meta + evs,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "lighthouse_tpu_torch.utils.tracing"},
    }


def export_chrome(path: str) -> int:
    """Write the chrome trace JSON to ``path``; returns the event count."""
    trace = chrome_trace()
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])


if os.environ.get("LIGHTHOUSE_TPU_TRACE", "") not in ("", "0"):
    enable()
