"""Structured logging with rate limiting (reference:
``common/logging/src/lib.rs`` — slog decorators + ``TimeLatch`` at
``:196`` suppressing repeat warnings inside a window).

``log(level, msg, **fields)`` emits one structured line to stderr —
``key=value`` text by default, one JSON object per line with
``LIGHTHOUSE_TPU_LOG_FORMAT=json`` (or :func:`set_format`). The minimum
level honors ``LIGHTHOUSE_TPU_LOG_LEVEL`` at import and
:func:`set_level` at runtime (both thread-safe). Hot paths guard
repeated messages with a :class:`TimeLatch` so a flood (e.g. queue
shedding, repeated peer bans) costs one line per window instead of one
per event.

Every emitted line ticks ``log_messages_total{level}`` (Lighthouse-style
— error/crit rates are scrapeable), warn-and-above lines feed the
flight-recorder journal, and a crit line triggers
``flight_recorder.dump_on_failure`` so the context that led up to it is
preserved.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from . import flight_recorder, metrics

_MESSAGES = metrics.counter_vec(
    "log_messages_total", "structured log messages emitted, by level",
    ("level",),
)
_SUPPRESSED = metrics.counter(
    "log_lines_suppressed_total", "log lines dropped by TimeLatch windows"
)

LEVELS = ("debug", "info", "warn", "error", "crit")
FORMATS = ("text", "json")

# warn-and-above lines are journaled: below that the ring would be all
# chatter and the forensics window would shrink to nothing
_JOURNAL_MIN_IDX = LEVELS.index("warn")

_state_lock = threading.Lock()
_min_idx = LEVELS.index("info")
_format = "text"


def set_level(level: str) -> None:
    global _min_idx
    assert level in LEVELS
    with _state_lock:
        _min_idx = LEVELS.index(level)


def get_level() -> str:
    with _state_lock:
        return LEVELS[_min_idx]


def set_format(fmt: str) -> None:
    global _format
    assert fmt in FORMATS
    with _state_lock:
        _format = fmt


def log(level: str, msg: str, **fields) -> None:
    idx = LEVELS.index(level)
    # one locked read of both knobs: a concurrent set_level/set_format
    # can never interleave a half-updated view into this emission
    with _state_lock:
        min_idx, fmt = _min_idx, _format
    if idx < min_idx:
        return
    _MESSAGES.with_labels(level).inc()
    if idx >= _JOURNAL_MIN_IDX:
        flight_recorder.record("log", level=level, msg=msg, **fields)
    if fmt == "json":
        doc = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "level": level,
            "msg": msg,
        }
        for k, v in fields.items():
            # a caller field named ts/level/msg must survive, not be
            # silently shadowed by the envelope (text mode prints it)
            doc[k if k not in doc else f"field_{k}"] = _json_val(v)
        line = json.dumps(doc)
    else:
        ts = time.strftime("%b %d %H:%M:%S")
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        line = f"{ts} {level.upper():5s} {msg}{' ' + kv if kv else ''}"
    print(line, file=sys.stderr, flush=True)
    if level == "crit":
        # crit = the node is in trouble: preserve the journal that led
        # here (no-op unless dumping is enabled; rate-limited inside)
        flight_recorder.dump_on_failure("crit_log", msg=msg)


def _fmt(v) -> str:
    if isinstance(v, bytes):
        return "0x" + v.hex()[:16]
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _json_val(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, bytes):
        return "0x" + v.hex()[:16]
    return str(v)


class TimeLatch:
    """One ``fire()`` per ``window`` seconds (reference TimeLatch):
    returns True when the caller should emit, False (counted) otherwise."""

    def __init__(self, window: float = 30.0):
        self.window = window
        self._last = 0.0
        self._lock = threading.Lock()

    def fire(self) -> bool:
        now = time.monotonic()
        with self._lock:
            if now - self._last >= self.window:
                self._last = now
                return True
        _SUPPRESSED.inc()
        return False


def rate_limited(latch: TimeLatch, level: str, msg: str, **fields) -> None:
    """Emit through a latch; suppressed lines are counted, not printed."""
    if latch.fire():
        log(level, msg, **fields)


# env knobs honored at import (unknown values are ignored, not fatal:
# a typo in an env var must never take the node down)
_env_level = os.environ.get("LIGHTHOUSE_TPU_LOG_LEVEL", "").lower()
if _env_level in LEVELS:
    set_level(_env_level)
_env_format = os.environ.get("LIGHTHOUSE_TPU_LOG_FORMAT", "").lower()
if _env_format in FORMATS:
    set_format(_env_format)
