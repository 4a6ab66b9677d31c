"""Arrival-trace model for traffic replay: the port's copy of the JAX
package's ``verification_service/traffic.py``.

A steady-state throughput number says nothing about what a submitter
experiences under bursty, epoch-boundary-shaped load; this module is
the arrival model:

* a **versioned JSONL trace format** (:data:`TRACE_SCHEMA`, the JAX
  package's, so a trace written by either package reads in the other):
  one header line, then one arrival event per line: ``t`` (seconds from
  trace start), ``kind`` (caller kind), ``n_sets``/``pubkeys``/
  ``messages`` (submission geometry, the three axes the packers pad),
  ``path`` (``submit`` for the fusing queue, ``verify_now`` for the
  latency-critical bypass), ``qos``;
* **synthetic mainnet-shaped generators** (:data:`GENERATORS`): gossip
  steady state, epoch-boundary attestation flood, sync-committee period,
  bulk backfill underneath, a saturation ramp; each deterministic under
  its seed (``random.Random``; no wall clock, no global RNG);
* a **lockstep simulator** (:func:`lockstep_replay`): the scheduler's
  drain/flush policy and the shape-aware planner replayed as a pure
  function of the trace: same trace and parameters give the same
  submission sequence, flush-plan shapes and set counts, byte for byte.

This module never starts a thread. A timed replay against a live
scheduler (``chip_smoke.py``'s serve phase) submits each event at its
time ``t``.
"""

from __future__ import annotations

import hashlib
import json
import random
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .planner import FlushPlanner

TRACE_VERSION = 1
TRACE_SCHEMA = f"lighthouse_tpu.traffic_trace/{TRACE_VERSION}"

_PATHS = ("submit", "verify_now")
# QoS service classes: "deadline" = gossip's latency class,
# "bulk" = the deadline-insensitive backfill/ingest class (submit-path
# only — the verify_now bypass IS the latency-critical escape hatch)
_QOS = ("deadline", "bulk")
_EVENT_DEFAULTS = {
    "pubkeys": 1, "messages": 1, "path": "submit", "qos": "deadline",
}


# ---------------------------------------------------------------------------
# Trace format (JSONL: header line + one event per line)
# ---------------------------------------------------------------------------


def _validate_event(ev: dict, lineno: int) -> dict:
    out = dict(_EVENT_DEFAULTS)
    out.update(ev)
    try:
        out["t"] = float(out["t"])
        out["kind"] = str(out["kind"])
        out["n_sets"] = int(out["n_sets"])
        out["pubkeys"] = int(out["pubkeys"])
        out["messages"] = int(out["messages"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"trace line {lineno}: malformed event {ev!r}: {e}")
    if out["t"] < 0 or out["n_sets"] <= 0 or out["pubkeys"] <= 0 \
            or out["messages"] <= 0:
        raise ValueError(
            f"trace line {lineno}: non-positive geometry/time in {ev!r}"
        )
    if out["path"] not in _PATHS:
        raise ValueError(
            f"trace line {lineno}: unknown path {out['path']!r} "
            f"(expected one of {_PATHS})"
        )
    if out["qos"] not in _QOS:
        raise ValueError(
            f"trace line {lineno}: unknown qos {out['qos']!r} "
            f"(expected one of {_QOS})"
        )
    if out["qos"] == "bulk" and out["path"] != "submit":
        raise ValueError(
            f"trace line {lineno}: qos=bulk is submit-only (the "
            f"verify_now bypass is the latency-critical class)"
        )
    # optional committee identity: the validator-index tuple
    # an aggregate's signers form — what the aggregate-cache collapse
    # keys on and the replay's first-sighting model consumes
    if "validators" in out:
        try:
            vals = [int(v) for v in out["validators"]]
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"trace line {lineno}: malformed validators in {ev!r}: {e}"
            )
        if any(v < 0 for v in vals):
            raise ValueError(
                f"trace line {lineno}: negative validator index in {ev!r}"
            )
        out["validators"] = vals
    return out


def trace_header(
    events: List[dict],
    name: str,
    seed: int,
    generator: str | None = None,
    params: dict | None = None,
) -> dict:
    """THE header document for a trace of ``events`` (assumed sorted) —
    one construction shared by :func:`write_trace` and a timed replay
    that generates without writing, so the two can never carry
    different field sets."""
    return {
        "schema": TRACE_SCHEMA,
        "name": name,
        "seed": int(seed),
        "n_events": len(events),
        "duration_s": round(events[-1]["t"], 6) if events else 0.0,
        "generator": generator,
        "params": params or {},
    }


def write_trace(
    path: str,
    events: List[dict],
    name: str,
    seed: int,
    generator: str | None = None,
    params: dict | None = None,
) -> dict:
    """Write ``events`` as a versioned JSONL trace; returns the header.
    Events are validated and written sorted by arrival time so a trace
    file is replayable as-is."""
    events = sorted(
        (_validate_event(ev, i + 2) for i, ev in enumerate(events)),
        key=lambda e: e["t"],
    )
    header = trace_header(events, name, seed, generator, params)
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True) + "\n")
    return header


def read_trace(path: str) -> Tuple[dict, List[dict]]:
    """Parse a trace file; raises ``ValueError`` on a missing/unsupported
    schema version or a malformed event — a replay must never silently
    reinterpret a trace written by a different format generation."""
    with open(path) as f:
        # keep REAL file line numbers through the blank-line filter so
        # every error message points at the line the operator must edit
        lines = [
            (lineno, ln)
            for lineno, ln in enumerate((l.strip() for l in f), start=1)
            if ln
        ]
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    header_lineno, header_line = lines[0]
    try:
        header = json.loads(header_line)
    except ValueError as e:
        raise ValueError(
            f"{path}: line {header_lineno}: unparseable header: {e}"
        )
    schema = header.get("schema")
    if schema != TRACE_SCHEMA:
        raise ValueError(
            f"{path}: unsupported trace schema {schema!r} "
            f"(this build reads {TRACE_SCHEMA!r})"
        )
    events = []
    for lineno, ln in lines[1:]:
        try:
            ev = json.loads(ln)
        except ValueError as e:
            raise ValueError(f"{path}: line {lineno}: unparseable: {e}")
        events.append(_validate_event(ev, lineno))
    events.sort(key=lambda e: e["t"])
    return header, events


def synthetic_sets(
    kind: str, n_sets: int, pubkeys: int, messages: int
) -> list:
    """Geometry-only signature sets for an arrival event: ``(None,
    [None]*pubkeys, message bytes)`` triples — everything the planner
    and the packers' geometry extraction read, nothing the crypto needs.
    Messages are salted per kind: real traffic's kinds sign different
    messages, so the fused flush's unique-message axis is the sum, not
    the max, of the per-kind counts."""
    return [
        (
            None,
            [None] * pubkeys,
            kind.encode() + (i % max(1, messages)).to_bytes(4, "big"),
        )
        for i in range(n_sets)
    ]


# ---------------------------------------------------------------------------
# Generators (deterministic under seed; rates are per-second)
# ---------------------------------------------------------------------------


def _poisson(
    rng: random.Random,
    rate: float,
    t0: float,
    t1: float,
    make: Callable[[float, random.Random], dict],
) -> List[dict]:
    """Homogeneous Poisson arrivals of one event class on [t0, t1)."""
    out: List[dict] = []
    if rate <= 0 or t1 <= t0:
        return out
    t = t0 + rng.expovariate(rate)
    while t < t1:
        out.append(make(round(t, 6), rng))
        t += rng.expovariate(rate)
    return out


def _finish(events: List[dict]) -> List[dict]:
    events.sort(key=lambda e: e["t"])
    return events


def gossip_steady(
    duration_s: float = 10.0,
    seed: int = 0,
    rate_scale: float = 1.0,
    committee: int = 8,
    unagg_rate: float = 40.0,
    agg_rate: float = 12.0,
    sync_rate: float = 6.0,
) -> List[dict]:
    """Steady-state gossip: single-pubkey attestations, committee-width
    aggregates, and sync-committee messages as independent Poisson
    streams — the baseline every other shape layers onto."""
    rng = random.Random(seed)
    evs: List[dict] = []
    evs += _poisson(
        rng, unagg_rate * rate_scale, 0.0, duration_s,
        lambda t, r: {"t": t, "kind": "unaggregated", "n_sets": 1,
                      "pubkeys": 1, "messages": 1, "path": "submit"},
    )
    evs += _poisson(
        rng, agg_rate * rate_scale, 0.0, duration_s,
        lambda t, r: {"t": t, "kind": "aggregate", "n_sets": 1,
                      "pubkeys": committee, "messages": 1, "path": "submit"},
    )
    evs += _poisson(
        rng, sync_rate * rate_scale, 0.0, duration_s,
        lambda t, r: {"t": t, "kind": "sync_message", "n_sets": 1,
                      "pubkeys": 1, "messages": 1, "path": "submit"},
    )
    return _finish(evs)


def epoch_boundary_flood(
    duration_s: float = 12.0,
    seed: int = 0,
    rate_scale: float = 1.0,
    committee: int = 8,
    slot_s: float = 2.0,
    flood_start_frac: float = 0.5,
    flood_width_s: float = 2.0,
    flood_factor: float = 8.0,
    block_sets: int = 2,
    n_committees: int = 16,
) -> List[dict]:
    """The acceptance-gate shape: gossip steady-state with an
    attestation FLOOD in the window starting at
    ``flood_start_frac * duration_s`` (the epoch boundary, where every
    validator's attestation for the old epoch and the committee
    reshuffle land together), plus one latency-critical block
    verification per slot on the ``verify_now`` bypass — the trace that
    exercises fused, planned, shed, bypass and fallback resolution
    paths at once.

    Committee realism: a real epoch has a FIXED committee
    shuffle — the same validator-index tuples recur across the epoch's
    aggregates — so flood aggregates draw their ``validators`` tuple
    from ``n_committees`` stable disjoint committees instead of being
    anonymous. Repeated tuples are exactly what the aggregate-cache
    collapse (key table) keys on; without them the
    first-sighting hit-ratio is structurally unmeasurable on this
    trace."""
    rng = random.Random(seed)
    evs = gossip_steady(
        duration_s=duration_s, seed=seed + 1, rate_scale=rate_scale,
        committee=committee,
    )
    f0 = flood_start_frac * duration_s
    f1 = min(duration_s, f0 + flood_width_s)
    # the flood rides ON TOP of the base rates (extra independent
    # streams), so the boundary window carries base + (factor-1)x extra
    extra = max(0.0, flood_factor - 1.0) * rate_scale
    # the epoch's committee shuffle: stable disjoint index tuples
    committees = [
        tuple(range(c * committee, (c + 1) * committee))
        for c in range(max(1, int(n_committees)))
    ]
    evs += _poisson(
        rng, 40.0 * extra, f0, f1,
        lambda t, r: {"t": t, "kind": "unaggregated", "n_sets": 1,
                      "pubkeys": 1, "messages": 1, "path": "submit"},
    )
    evs += _poisson(
        rng, 12.0 * extra, f0, f1,
        lambda t, r: {"t": t, "kind": "aggregate", "n_sets": 1,
                      "pubkeys": committee, "messages": 1, "path": "submit",
                      "validators": list(
                          committees[r.randrange(len(committees))]
                      )},
    )
    # one block per slot, early in the slot, on the synchronous bypass
    slot = 0
    while slot * slot_s < duration_s:
        t = slot * slot_s + rng.uniform(0.0, 0.3 * slot_s)
        if t < duration_s:
            evs.append({
                "t": round(t, 6), "kind": "block", "n_sets": block_sets,
                "pubkeys": 1, "messages": block_sets, "path": "verify_now",
            })
        slot += 1
    return _finish(evs)


def sync_committee_period(
    duration_s: float = 12.0,
    seed: int = 0,
    rate_scale: float = 1.0,
    slot_s: float = 2.0,
    subcommittee: int = 16,
    msg_rate: float = 30.0,
    contrib_per_slot: int = 4,
    background_rate: float = 8.0,
) -> List[dict]:
    """Sync-committee period: per slot, a burst of single-pubkey sync
    messages in the first half (the 4-second broadcast window scaled
    down) and a few subcommittee-width contributions near the slot end,
    over a thin attestation background."""
    rng = random.Random(seed)
    evs: List[dict] = []
    evs += _poisson(
        rng, background_rate * rate_scale, 0.0, duration_s,
        lambda t, r: {"t": t, "kind": "unaggregated", "n_sets": 1,
                      "pubkeys": 1, "messages": 1, "path": "submit"},
    )
    slot = 0
    while slot * slot_s < duration_s:
        s0 = slot * slot_s
        evs += _poisson(
            rng, msg_rate * rate_scale, s0, min(duration_s, s0 + slot_s / 2),
            lambda t, r: {"t": t, "kind": "sync_message", "n_sets": 1,
                          "pubkeys": 1, "messages": 1, "path": "submit"},
        )
        for _ in range(contrib_per_slot):
            t = s0 + slot_s * rng.uniform(0.7, 0.95)
            if t < duration_s:
                evs.append({
                    "t": round(t, 6), "kind": "sync_contribution",
                    "n_sets": 1, "pubkeys": subcommittee, "messages": 1,
                    "path": "submit",
                })
        slot += 1
    return _finish(evs)


def bulk_backfill(
    duration_s: float = 20.0,
    seed: int = 0,
    rate_scale: float = 1.0,
    committee: int = 8,
    batch_every_s: float = 2.5,
    batch_sets: Tuple[int, ...] = (64, 96, 128),
    gossip_rate: float = 8.0,
) -> List[dict]:
    """Chain-segment backfill running UNDERNEATH live gossip: large
    deadline-insensitive contiguous submissions every few seconds (the
    bulk class) while a thin unaggregated stream keeps
    arriving — the shape that shows whether bulk batches starve gossip
    tail latency."""
    rng = random.Random(seed)
    evs: List[dict] = []
    evs += _poisson(
        rng, gossip_rate * rate_scale, 0.0, duration_s,
        lambda t, r: {"t": t, "kind": "unaggregated", "n_sets": 1,
                      "pubkeys": 1, "messages": 1, "path": "submit"},
    )
    t = rng.uniform(0.0, batch_every_s)
    while t < duration_s:
        n = rng.choice(batch_sets)
        evs.append({
            "t": round(t, 6), "kind": "backfill", "n_sets": int(n),
            "pubkeys": committee, "messages": max(1, int(n) // 8),
            "path": "submit",
        })
        t += batch_every_s * rng.uniform(0.7, 1.3)
    return _finish(evs)


def saturation_ramp(
    duration_s: float = 20.0,
    seed: int = 0,
    rate_scale: float = 1.0,
    committee: int = 8,
    start_rate: float = 5.0,
    end_rate: float = 80.0,
    agg_fraction: float = 0.25,
    backfill_every_s: float = 4.0,
    backfill_sets: int = 48,
    slice_s: float = 0.5,
) -> List[dict]:
    """The capacity-certification shape: gossip arrival rate
    rising LINEARLY from ``start_rate`` to ``end_rate`` events/s over
    the trace (an inhomogeneous Poisson process, realized as
    piecewise-constant ``slice_s`` slices with the rate interpolated at
    each slice midpoint — deterministic under seed like every other
    generator), split ``agg_fraction`` committee-width aggregates /
    the rest single-pubkey attestations, over a bulk-backfill FLOOR
    (large deadline-insensitive submissions every ``backfill_every_s``).
    Somewhere along the ramp demand crosses serving capacity: the trace
    the headroom estimator is certified against (headroom must cross
    below its alert threshold and an ``slo_burn`` event must journal
    BEFORE the first deadline-miss burst — the estimator is predictive,
    not retrospective), and the shape bulk-QoS admission control is
    tuned against."""
    rng = random.Random(seed)
    evs: List[dict] = []
    t0 = 0.0
    while t0 < duration_s:
        t1 = min(duration_s, t0 + slice_s)
        frac = ((t0 + t1) / 2.0) / duration_s
        rate = (start_rate + (end_rate - start_rate) * frac) * rate_scale
        evs += _poisson(
            rng, rate * (1.0 - agg_fraction), t0, t1,
            lambda t, r: {"t": t, "kind": "unaggregated", "n_sets": 1,
                          "pubkeys": 1, "messages": 1, "path": "submit"},
        )
        evs += _poisson(
            rng, rate * agg_fraction, t0, t1,
            lambda t, r: {"t": t, "kind": "aggregate", "n_sets": 1,
                          "pubkeys": committee, "messages": 1,
                          "path": "submit"},
        )
        t0 = t1
    t = rng.uniform(0.0, backfill_every_s)
    while t < duration_s:
        evs.append({
            "t": round(t, 6), "kind": "backfill",
            "n_sets": int(backfill_sets), "pubkeys": committee,
            "messages": max(1, int(backfill_sets) // 8),
            "path": "submit",
        })
        t += backfill_every_s * rng.uniform(0.8, 1.2)
    return _finish(evs)


def bulk_backfill_under_gossip(
    duration_s: float = 12.0,
    seed: int = 0,
    rate_scale: float = 1.0,
    committee: int = 8,
    bulk_start_frac: float = 0.25,
    bulk_every_s: float = 0.4,
    bulk_sets: Tuple[int, ...] = (96, 128, 192),
) -> List[dict]:
    """The bulk-isolation shape: FULL
    gossip steady-state — the same three Poisson streams as
    ``gossip_steady`` with the same seed derivation, so a gossip-only
    baseline run of ``gossip_steady(duration_s, seed, rate_scale,
    committee)`` carries byte-identical gossip arrivals — plus a
    SATURATING bulk stream (``qos="bulk"``, kind ``backfill``): large
    contiguous chain-segment submissions every ``bulk_every_s`` from
    ``bulk_start_frac * duration_s`` onward, offering far more sets/s
    than any deadline-class box serves. The leading bulk-free window is
    the within-trace control; the robustness contract under replay is
    that gossip's per-kind p99 and deadline-miss ratio in the bulk
    window are indistinguishable from the baseline run, bulk drains at
    gossip idle onto the big rungs, and the admission controller
    journals ``bulk_throttle`` before any gossip miss burst."""
    rng = random.Random(seed)
    # IDENTICAL gossip arrivals to gossip_steady(seed): same helper,
    # same derived seed — the isolation test depends on this equality
    evs = gossip_steady(
        duration_s=duration_s, seed=seed, rate_scale=rate_scale,
        committee=committee,
    )
    t = bulk_start_frac * duration_s
    while t < duration_s:
        n = rng.choice(bulk_sets)
        evs.append({
            # the REAL wired bulk callers' geometry (chain-segment
            # import + checkpoint backfill verify proposal signatures):
            # K=1, one DISTINCT message per set — exactly the shape the
            # bulk AOT rungs (512,1,512)/(256,1,256) serve, so a warm
            # staged replay of this trace exercises the big-rung drain
            # path instead of shedding every bulk flush to the CPU
            # fallback (a committee-carrying K=8/M=n//8 shape could
            # never route to the shipped bulk rungs)
            "t": round(t, 6), "kind": "backfill", "n_sets": int(n),
            "pubkeys": 1, "messages": int(n),
            "path": "submit", "qos": "bulk",
        })
        t += bulk_every_s * rng.uniform(0.8, 1.2)
    return _finish(evs)


# Generator catalogue.
GENERATORS: Dict[str, Callable[..., List[dict]]] = {
    "gossip_steady": gossip_steady,
    "epoch_boundary_flood": epoch_boundary_flood,
    "sync_committee_period": sync_committee_period,
    "bulk_backfill": bulk_backfill,
    "saturation_ramp": saturation_ramp,
    "bulk_backfill_under_gossip": bulk_backfill_under_gossip,
}


# ---------------------------------------------------------------------------
# Lockstep replay: the flush policy as a pure function of the trace
# ---------------------------------------------------------------------------


class ReplaySubmission:
    """The planner-facing submission shape (``.kind`` + ``.sets``),
    shared by the lockstep simulator and a timed replay's payload
    pre-build."""

    __slots__ = ("kind", "sets")

    def __init__(self, kind: str, sets: list):
        self.kind = kind
        self.sets = sets


def lockstep_replay(
    events: List[dict],
    deadline_ms: float = 25.0,
    max_batch_sets: int = 256,
    planner: Optional[FlushPlanner] = None,
    warm_rungs: Optional[list] = None,
    shards: Optional[list] = None,
    bulk_flush_sets: int = 512,
    bulk_linger_ms: float = 100.0,
    slot_s: float = 2.0,
    slots_per_epoch: int = 32,
    agg_min_repeats: int = 2,
    lookahead: bool = False,
) -> dict:
    """Deterministic virtual replay: walk the trace in arrival order and
    apply the scheduler's EXACT drain/flush policy (deadline measured
    from the oldest pending submission; bucket-full at
    ``max_batch_sets``; whole-submission drains; shutdown drain at the
    end) with the shape-aware planner deciding every flush — no
    threads, no wall clock, no device. ``qos="bulk"`` events
    enqueue on the modeled bulk queue, which drains in
    ``bulk_flush_sets`` chunks ONLY while the deadline queue is idle —
    full chunks immediately at idle, partial ones after
    ``bulk_linger_ms`` — mirroring the batcher's never-preempt trigger
    priority (admission control is live-signal-driven and deliberately
    NOT modeled: headroom needs a wall clock). The returned report
    (submission sequence, per-flush plan shapes, per-kind set counts,
    and a sha256 digest over all of it) is a pure function of (trace,
    parameters): the determinism property
    a replay holds across processes.

    Chain-time: virtual trace time maps deterministically to
    slots (``slot = t // slot_s``), and the report carries a per-slot
    block — arrivals, sets, flushes and committee sightings per slot —
    so a flood slot is individually visible instead of smeared into the
    window average. Committee sightings model the key table's
    aggregate-cache admission on events carrying ``validators``: a
    tuple's first ``agg_min_repeats`` consults are ``first`` sightings
    (host EC sum territory), every later one a collapsed ``hit``
    (``DEFAULT_AGG_MIN_REPEATS`` in crypto/device/key_table.py). The
    model is local and pure — the lockstep simulator never touches the
    process-global slot ledger.

    Duty-lookahead: with ``lookahead=True`` the admission
    model is prewarmed the way the duty-lookahead worker prewarms the
    key table — every committee tuple's epoch shuffle is deterministic
    an epoch ahead, so each tuple counts as already-admitted (its seen
    count starts at ``agg_min_repeats``) BEFORE its first arrival.
    First sightings collapse to hits and the report's ``chain_time``
    gains a ``lookahead`` block (prewarmed tuple count, per-epoch
    breakdown). With ``lookahead=False`` (the default) the report body
    is byte-identical to earlier releases — the digest-determinism
    property is preserved."""
    planner = planner or FlushPlanner()
    deadline_s = deadline_ms / 1000.0
    bulk_linger_s = bulk_linger_ms / 1000.0
    slot_s = max(1e-9, float(slot_s))
    slots_per_epoch = max(1, int(slots_per_epoch))
    slots: Dict[int, dict] = {}
    committee_seen: Dict[tuple, int] = {}
    lookahead_epochs: Dict[int, int] = {}
    if lookahead:
        # the worker's effect, replayed pure: every committee's epoch
        # assignment is known ahead of its first signature, so each
        # distinct tuple starts at the admission threshold (the
        # pre-inserted aggregate row) — attributed to the epoch of its
        # first arrival for the report
        for ev in sorted(events, key=lambda e: e["t"]):
            vals = ev.get("validators")
            if vals and len(vals) > 1:
                key = tuple(vals)
                if key not in committee_seen:
                    committee_seen[key] = agg_min_repeats
                    e = int(ev["t"] // slot_s) // slots_per_epoch
                    lookahead_epochs[e] = lookahead_epochs.get(e, 0) + 1
    t_end = 0.0

    def slot_row(t: float) -> dict:
        s = int(t // slot_s)
        row = slots.get(s)
        if row is None:
            row = slots[s] = {
                "slot": s,
                "epoch": s // slots_per_epoch,
                "arrivals": 0,
                "sets": 0,
                "bypass_sets": 0,
                "flushes": 0,
                "flushed_sets": 0,
                "bulk_sets": 0,
                "sightings_first": 0,
                "sightings_hit": 0,
            }
        return row
    pending: deque = deque()  # (ReplaySubmission, arrival t)
    pending_sets = 0
    bulk_pending: deque = deque()  # (ReplaySubmission, arrival t)
    bulk_pending_sets = 0
    # the virtual arrival time at which the bulk queue last crossed the
    # full-chunk threshold (None while below): a full chunk's idle-time
    # drain is due from that moment, not from the oldest arrival
    bulk_full_at: Optional[float] = None
    submissions: List[list] = []
    bypasses: List[list] = []
    flushes: List[dict] = []
    set_totals: Dict[str, int] = {}
    bulk_set_total = 0

    def drain_one(
        trigger: str, qos: str = "deadline", t: float = 0.0
    ) -> None:
        nonlocal pending_sets, bulk_pending_sets, bulk_full_at
        bulk = qos == "bulk"
        queue = bulk_pending if bulk else pending
        cap = bulk_flush_sets if bulk else max_batch_sets
        subs: List[ReplaySubmission] = []
        n = 0
        while queue:
            nxt, _t = queue[0]
            if subs and n + len(nxt.sets) > cap:
                break
            sub, _t = queue.popleft()
            subs.append(sub)
            n += len(sub.sets)
        if bulk:
            bulk_pending_sets -= n
            if bulk_pending_sets < bulk_flush_sets:
                bulk_full_at = None
        else:
            pending_sets -= n
        plan = planner.plan(
            subs, warm_rungs=warm_rungs, shards=shards, qos=qos
        )
        row = slot_row(t)
        row["flushes"] += 1
        row["flushed_sets"] += n
        if bulk:
            row["bulk_sets"] += n
        flushes.append({
            "trigger": trigger,
            "qos": qos,
            "slot": row["slot"],
            "n_submissions": len(subs),
            "n_sets": n,
            "mode": plan.mode,
            "rungs": plan.rungs_label(),
            "dp_shards": plan.shards_used(),
            "live_lanes": plan.live,
            "padded_lanes": plan.padded,
            "waste": round(plan.waste(), 4),
            # per-element byte accounting: what the raw packer
            # would ship per sub-batch
            "sub_batches": [
                {
                    "kinds": sb.kinds,
                    "rung": list(sb.rung),
                    "shard": sb.shard,
                    "n_sets": sb.n_sets,
                    "pk_slots": sb.pk_slots,
                    "m_req": sb.m_req,
                    "est_h2d_bytes": sb.est_h2d_bytes,
                    "est_live_h2d_bytes": sb.est_live_h2d_bytes,
                }
                for sb in plan.sub_batches
            ],
        })

    def advance_to(t_limit: float) -> None:
        """Run every drain due strictly before ``t_limit``, in virtual-
        time order: gossip deadline drains first; bulk drains only in
        the windows where the deadline queue is empty (the batcher's
        never-preempt rule — a gossip submission PARKS bulk until its
        own deadline passes)."""
        while True:
            if pending:
                td = pending[0][1] + deadline_s
                if td <= t_limit:
                    drain_one("deadline", t=td)
                    continue
                return  # gossip pending blocks bulk past t_limit
            if bulk_pending:
                if bulk_full_at is not None:
                    tb = bulk_full_at
                else:
                    tb = bulk_pending[0][1] + bulk_linger_s
                if tb <= t_limit:
                    drain_one("bulk", qos="bulk", t=tb)
                    continue
            return

    for ev in sorted(events, key=lambda e: e["t"]):
        advance_to(ev["t"])
        t_end = max(t_end, ev["t"])
        row = slot_row(ev["t"])
        row["arrivals"] += 1
        row["sets"] += ev["n_sets"]
        vals = ev.get("validators")
        if vals and len(vals) > 1:
            # the key table's admission policy, replayed pure: consult
            # j of a tuple is a hit only once j > agg_min_repeats
            key = tuple(vals)
            prior = committee_seen.get(key, 0)
            committee_seen[key] = prior + 1
            if prior >= agg_min_repeats:
                row["sightings_hit"] += 1
            else:
                row["sightings_first"] += 1
        if ev["path"] == "verify_now":
            row["bypass_sets"] += ev["n_sets"]
            bypasses.append([ev["kind"], ev["n_sets"]])
            set_totals[ev["kind"]] = (
                set_totals.get(ev["kind"], 0) + ev["n_sets"]
            )
            continue
        sets = synthetic_sets(
            ev["kind"], ev["n_sets"], ev["pubkeys"], ev["messages"]
        )
        set_totals[ev["kind"]] = set_totals.get(ev["kind"], 0) + ev["n_sets"]
        if ev.get("qos", "deadline") == "bulk":
            bulk_pending.append((ReplaySubmission(ev["kind"], sets), ev["t"]))
            bulk_pending_sets += ev["n_sets"]
            bulk_set_total += ev["n_sets"]
            submissions.append([ev["kind"], ev["n_sets"], "bulk"])
            if (
                bulk_full_at is None
                and bulk_pending_sets >= bulk_flush_sets
            ):
                bulk_full_at = ev["t"]
            continue
        pending.append((ReplaySubmission(ev["kind"], sets), ev["t"]))
        pending_sets += ev["n_sets"]
        submissions.append([ev["kind"], ev["n_sets"]])
        while pending_sets >= max_batch_sets:
            drain_one("full", t=ev["t"])
    while pending:
        drain_one("shutdown", t=t_end)
    while bulk_pending:
        drain_one("shutdown", qos="bulk", t=t_end)

    first_total = sum(r["sightings_first"] for r in slots.values())
    hit_total = sum(r["sightings_hit"] for r in slots.values())
    sighting_total = first_total + hit_total
    body = {
        "n_events": len(events),
        "deadline_ms": round(deadline_ms, 3),
        "max_batch_sets": max_batch_sets,
        "bulk_flush_sets": bulk_flush_sets,
        "bulk_linger_ms": round(bulk_linger_ms, 3),
        "submissions": submissions,
        "bypasses": bypasses,
        "flushes": flushes,
        "set_totals": dict(sorted(set_totals.items())),
        "bulk": {
            "sets_offered": bulk_set_total,
            "flushes": sum(1 for f in flushes if f["qos"] == "bulk"),
        },
        # slot-aligned view: one row per virtual slot, so a
        # flood slot is individually visible in the report and its
        # digest
        "chain_time": {
            "slot_s": round(slot_s, 6),
            "slots_per_epoch": slots_per_epoch,
            "n_slots": len(slots),
            "agg_min_repeats": agg_min_repeats,
            "committee_sightings": sighting_total,
            "first_sightings": first_total,
            "sighting_hits": hit_total,
            "first_sighting_hit_ratio": (
                round(hit_total / sighting_total, 4)
                if sighting_total else None
            ),
        },
        "slots": [slots[s] for s in sorted(slots)],
    }
    if lookahead:
        # present ONLY when on: the lookahead-off body (and digest)
        # stays byte-identical to earlier releases
        body["chain_time"]["lookahead"] = {
            "enabled": True,
            "committees": sum(lookahead_epochs.values()),
            "epochs": [
                [e, lookahead_epochs[e]] for e in sorted(lookahead_epochs)
            ],
        }
    digest = hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()
    return {"mode": "lockstep", **body, "digest": digest}
