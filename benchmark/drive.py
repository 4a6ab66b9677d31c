"""The load of a run: a closed loop that hands the next unit over when the
last returns.

It returns one record per unit it started: its index, ``t0`` (the call),
``t1`` (the verdict, or None when none came), the verdict, and the error a
call raised. Times are ``time.perf_counter()``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional


def _call(call: Callable, rec: dict) -> dict:
    rec["t0"] = time.perf_counter()
    try:
        rec["verdict"] = bool(call())
    except Exception as e:  # a failed call is a failed unit, counted
        rec["error"] = repr(e)[:300]
    rec["t1"] = time.perf_counter() if "verdict" in rec else None
    return rec


def closed(units, call: Callable, end: float, on_each: Optional[Callable] = None) -> List[dict]:
    """``call(unit)`` for each unit in turn until ``end`` has passed; no
    unit starts after it."""
    out = []
    for i, u in enumerate(units):
        if time.perf_counter() >= end:
            break
        out.append(_call(lambda: call(u), {"i": i}))
        if on_each is not None:
            on_each()
    return out
