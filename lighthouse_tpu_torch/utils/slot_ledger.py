"""Slot ledger: a bounded, thread-safe per-slot rollup store, the
chain-time axis of the measurement stack. The port's own copy of the JAX
package's ``utils/slot_ledger.py``: the same API, families, env knobs and
report cards (reference: Lighthouse's ``validator_monitor`` attributes
per-epoch summaries to registered validators; batch-verification cost
peaks at slot and epoch boundaries, so wall-clock windows smear the
signal an operator needs).

The SLO windows, the transfer ledger, the pipeline profiler and the
capacity timeseries answer "how is the node doing lately"; this module
answers "how did the node do in slot N": every scheduler resolution,
deadline miss, journal rejection, H2D byte total, bubble interval and
headroom sample lands in its slot's **report card** (per-kind
sets/verdicts/misses, in-slot p99, min headroom, bytes moved, fresh
captures, bulk admitted/parked), with epoch-level aggregation on top that
tracks the key table's aggregate cache: a committee seen for the first
time (host EC sum paid) against a collapsed K=1 hit, minting the
``key_table_first_sighting_hit_ratio{epoch}`` gauge.

Design constraints (the discipline of :mod:`utils.tracing`,
:mod:`utils.flight_recorder` and :mod:`utils.transfer_ledger`):

* no torch import: report cards render on hosts with no card.
* DISABLED attribution costs well under 1 microsecond per call: every
  ``note_*`` returns after one global check, no allocation.
* Enabled attribution is O(1) amortized: one dict update under one lock.
  Retention is bounded (``max_slots`` cards, ``max_epochs`` epoch rows);
  evicted cards fold into eviction totals so **lifetime conservation
  holds**: for every counter, sum(retained cards) + evicted == lifetime,
  also for an attribution to a slot older than every retained card
  (:func:`_retain`; the JAX module loses those).
* Attribution is exactly-once by construction: each producer hooks the
  single point its event is finalized (e.g. the scheduler's
  ``_observe_latency``), never the per-path branches above it.

Chain time comes from :mod:`utils.slot_clock`'s process-global clock
unless the caller passes ``slot=`` explicitly (replays resolve slots
from virtual trace time and pass them in).

Env knobs (read at import; :func:`configure` overrides at runtime):

    LIGHTHOUSE_TPU_SLOT_LEDGER        1|0   attribute events (default 1)
    LIGHTHOUSE_TPU_SLOT_LEDGER_SLOTS  int   report cards retained (default 64)
    LIGHTHOUSE_TPU_SLOT_LEDGER_EPOCHS int   epoch rows retained (default 64)
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from . import metrics
from . import slot_clock

SCHEMA = "lighthouse_tpu.slot_ledger/1"

# In-slot latency reservoir cap: enough for exact p99 at any realistic
# per-slot arrival rate; beyond it the card keeps counting but stops
# sampling (sampled count is reported so a truncated p99 is visible).
LATENCY_SAMPLE_CAP = 4096

# The event catalogue for slot_ledger_events_total: one label value per
# note_* family.
EVENTS = (
    "bubble",
    "bulk",
    "fresh_compile",
    "h2d",
    "headroom",
    "lookahead",
    "rejection",
    "resolution",
    "sighting",
)

_SLOTS_RETAINED = metrics.gauge(
    "slot_ledger_slots",
    "per-slot report cards currently retained by the slot ledger",
)
_EVICTED_TOTAL = metrics.counter(
    "slot_ledger_evicted_total",
    "report cards evicted by slot-ledger retention (folded into "
    "eviction totals, so lifetime conservation still holds)",
)
_EVENTS_TOTAL = metrics.counter_vec(
    "slot_ledger_events_total",
    "events attributed to a slot report card, by event family",
    ("event",),
)
_FIRST_SIGHTING_RATIO = metrics.gauge_vec(
    "key_table_first_sighting_hit_ratio",
    "per-epoch committee aggregate-cache collapse ratio: collapsed K=1 "
    "hits / (first sightings + hits)",
    ("epoch",),
)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


_enabled = os.environ.get("LIGHTHOUSE_TPU_SLOT_LEDGER", "1") not in ("", "0")
_max_slots = max(1, _env_int("LIGHTHOUSE_TPU_SLOT_LEDGER_SLOTS", 64))
_max_epochs = max(1, _env_int("LIGHTHOUSE_TPU_SLOT_LEDGER_EPOCHS", 64))

_lock = threading.RLock()

# slot -> report card dict (see _new_card for the schema)
_cards: Dict[int, dict] = {}
# epoch -> {"first": int, "hits": int}
_epochs: Dict[int, dict] = {}

# Names of the card counters that must conserve: for each,
# sum over retained cards + _evicted[name] == _lifetime[name].
_COUNTERS = (
    "sets",
    "verdicts",
    "misses",
    "rejections",
    "h2d_bytes",
    "fresh_compiles",
    "bulk_admitted_sets",
    "bulk_parked_sets",
    "sightings_first",
    "sightings_hit",
    "lookahead_committees",
    "lookahead_host_sums",
    "lookahead_device_sums",
)


def _zero_totals() -> Dict[str, float]:
    t: Dict[str, float] = {k: 0 for k in _COUNTERS}
    t["bubble_s"] = 0.0
    return t


_lifetime = _zero_totals()
_evicted = _zero_totals()
_evicted_cards = 0


def _new_card(slot: int, epoch: int) -> dict:
    return {
        "slot": slot,
        "epoch": epoch,
        # kind -> {"sets", "verdicts", "misses"}
        "kinds": {},
        "sets": 0,
        "verdicts": 0,
        "misses": 0,
        # kind -> count (journal *_rejected events)
        "rejected": {},
        "rejections": 0,
        "h2d_bytes": 0,
        "bubble_s": 0.0,
        "fresh_compiles": 0,
        "bulk_admitted_sets": 0,
        "bulk_parked_sets": 0,
        "sightings_first": 0,
        "sightings_hit": 0,
        "lookahead_committees": 0,
        "lookahead_host_sums": 0,
        "lookahead_device_sums": 0,
        "headroom_min": None,
        "headroom_samples": 0,
        "_lat_ms": [],  # capped reservoir, exact until the cap
        "lat_samples": 0,
    }


def _resolve(slot: Optional[int]) -> Tuple[int, int]:
    """(slot, epoch) for an attribution: explicit slot, else the
    process-global clock's current slot."""
    clock = slot_clock.get_clock()
    s = clock.now() if slot is None else int(slot)
    return s, clock.epoch_of(s)


def _card(slot: int, epoch: int) -> dict:
    """Card for ``slot``, creating it. Caller holds the lock and calls
    :func:`_retain` after its update."""
    card = _cards.get(slot)
    if card is None:
        card = _new_card(slot, epoch)
        _cards[slot] = card
    return card


def _retain() -> None:
    """Retention, applied AFTER the caller's update: evict the oldest
    cards past ``max_slots``. The JAX module evicts when it creates the
    card, so an attribution to a slot older than every retained card
    lands on a card already evicted and is lost to the conservation
    totals; here that card is updated first, then folded into them.
    Caller holds the lock."""
    while len(_cards) > _max_slots:
        _evict(min(_cards))
    if _SLOTS_RETAINED.value != len(_cards):
        _SLOTS_RETAINED.set(len(_cards))


def _evict(slot: int) -> None:
    """Fold the evicted card's counters into the eviction totals so
    lifetime conservation survives retention. Caller holds the lock."""
    global _evicted_cards
    card = _cards.pop(slot)
    for k in _COUNTERS:
        _evicted[k] += card[k]
    _evicted["bubble_s"] += card["bubble_s"]
    _evicted_cards += 1
    _EVICTED_TOTAL.inc()


# ---------------------------------------------------------------------------
# Producers (one note_* per attribution point)
# ---------------------------------------------------------------------------


def note_resolution(
    kind: str,
    path: str,
    n_sets: int,
    latency_s: float,
    missed: bool = False,
    qos: str = "deadline",
    slot: Optional[int] = None,
) -> None:
    """One scheduler resolution, hooked at the scheduler's single
    accounting point (``_observe_latency``) so bisection/shed/bulk paths
    cannot double-count."""
    if not _enabled:
        return
    s, e = _resolve(slot)
    with _lock:
        _update_resolution(_card(s, e), kind, n_sets, latency_s, missed)
        _lifetime["sets"] += n_sets
        _lifetime["verdicts"] += 1
        if missed:
            _lifetime["misses"] += 1
        _retain()
    _EVENTS_TOTAL.with_labels("resolution").inc()


def _update_resolution(
    card: dict, kind: str, n_sets: int, latency_s: float, missed: bool
) -> None:
    per = card["kinds"].get(kind)
    if per is None:
        per = {"sets": 0, "verdicts": 0, "misses": 0}
        card["kinds"][kind] = per
    per["sets"] += n_sets
    per["verdicts"] += 1
    card["sets"] += n_sets
    card["verdicts"] += 1
    if missed:
        per["misses"] += 1
        card["misses"] += 1
    card["lat_samples"] += 1
    if len(card["_lat_ms"]) < LATENCY_SAMPLE_CAP:
        card["_lat_ms"].append(latency_s * 1000.0)


def note_rejection(kind: str, slot: Optional[int] = None) -> None:
    """One journal rejection (``*_rejected`` flight-recorder kinds)."""
    if not _enabled:
        return
    s, e = _resolve(slot)
    with _lock:
        card = _card(s, e)
        card["rejected"][kind] = card["rejected"].get(kind, 0) + 1
        card["rejections"] += 1
        _lifetime["rejections"] += 1
        _retain()
    _EVENTS_TOTAL.with_labels("rejection").inc()


def note_h2d_bytes(n: int, slot: Optional[int] = None) -> None:
    """Host-to-device bytes committed by the transfer ledger."""
    if not _enabled:
        return
    s, e = _resolve(slot)
    with _lock:
        _card(s, e)["h2d_bytes"] += n
        _lifetime["h2d_bytes"] += n
        _retain()
    _EVENTS_TOTAL.with_labels("h2d").inc()


def note_bubble(seconds: float, slot: Optional[int] = None) -> None:
    """One pipeline bubble interval (profiler idle-gap attribution)."""
    if not _enabled:
        return
    s, e = _resolve(slot)
    with _lock:
        _card(s, e)["bubble_s"] += seconds
        _lifetime["bubble_s"] += seconds
        _retain()
    _EVENTS_TOTAL.with_labels("bubble").inc()


def note_headroom(ratio: float, slot: Optional[int] = None) -> None:
    """One headroom estimate sample; the card keeps the slot minimum:
    the worst moment inside the slot, not an average over it."""
    if not _enabled:
        return
    s, e = _resolve(slot)
    with _lock:
        card = _card(s, e)
        if card["headroom_min"] is None or ratio < card["headroom_min"]:
            card["headroom_min"] = float(ratio)
        card["headroom_samples"] += 1
        _retain()
    _EVENTS_TOTAL.with_labels("headroom").inc()


def note_fresh_compile(stage: Optional[str] = None, slot: Optional[int] = None) -> None:
    """One fresh dispatch observed inside the slot (a stage wall
    attributed with ``fresh=True``: in the port, a CUDA-graph capture)."""
    if not _enabled:
        return
    s, e = _resolve(slot)
    with _lock:
        _card(s, e)["fresh_compiles"] += 1
        _lifetime["fresh_compiles"] += 1
        _retain()
    _EVENTS_TOTAL.with_labels("fresh_compile").inc()


def note_bulk(
    admitted_sets: int = 0, parked_sets: int = 0, slot: Optional[int] = None
) -> None:
    """Bulk-class admission outcome: sets admitted through the governor
    vs parked (throttled) by a headroom excursion."""
    if not _enabled:
        return
    s, e = _resolve(slot)
    with _lock:
        card = _card(s, e)
        card["bulk_admitted_sets"] += admitted_sets
        card["bulk_parked_sets"] += parked_sets
        _lifetime["bulk_admitted_sets"] += admitted_sets
        _lifetime["bulk_parked_sets"] += parked_sets
        _retain()
    _EVENTS_TOTAL.with_labels("bulk").inc()


def note_lookahead(
    committees: int = 0,
    host_sums: int = 0,
    device_sums: int = 0,
    slot: Optional[int] = None,
) -> None:
    """Duty-lookahead precompute work attributed to the slot it ran in:
    committees warmed for a FUTURE epoch, split by the sum path that
    produced each aggregate row (device MSM vs host EC fold). Precompute
    cost lands visibly in the quiet slots that paid it and stays out of
    the verify-span accounting."""
    if not _enabled:
        return
    s, e = _resolve(slot)
    with _lock:
        card = _card(s, e)
        card["lookahead_committees"] += committees
        card["lookahead_host_sums"] += host_sums
        card["lookahead_device_sums"] += device_sums
        _lifetime["lookahead_committees"] += committees
        _lifetime["lookahead_host_sums"] += host_sums
        _lifetime["lookahead_device_sums"] += device_sums
        _retain()
    _EVENTS_TOTAL.with_labels("lookahead").inc()


def note_committee_sighting(outcome: str, slot: Optional[int] = None) -> None:
    """One committee-aggregate consult: ``"first"`` (host EC sum paid:
    the key table had no collapsed row) or ``"hit"`` (collapsed K=1 row
    served). Conservation: first + hits == committee sightings, and the
    per-epoch ``key_table_first_sighting_hit_ratio`` gauge is minted from
    exactly these two counters."""
    if not _enabled:
        return
    if outcome not in ("first", "hit"):
        raise ValueError(f"sighting outcome must be 'first' or 'hit', got {outcome!r}")
    s, e = _resolve(slot)
    with _lock:
        card = _card(s, e)
        row = _epochs.get(e)
        if row is None:
            row = {"first": 0, "hits": 0}
            _epochs[e] = row
            while len(_epochs) > _max_epochs:
                del _epochs[min(_epochs)]
        if outcome == "first":
            card["sightings_first"] += 1
            _lifetime["sightings_first"] += 1
            row["first"] += 1
        else:
            card["sightings_hit"] += 1
            _lifetime["sightings_hit"] += 1
            row["hits"] += 1
        total = row["first"] + row["hits"]
        ratio = row["hits"] / total if total else 0.0
        _retain()
    _FIRST_SIGHTING_RATIO.with_labels(str(e)).set(ratio)
    _EVENTS_TOTAL.with_labels("sighting").inc()


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _quantile_ms(samples: List[float], q: float) -> float:
    """Nearest-rank quantile over raw ms samples (a local copy of the SLO
    window's rule: the ledger stays importable without the verification
    service)."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    idx = max(0, min(len(xs) - 1, int(q * len(xs) + 0.999999) - 1))
    return xs[idx]


def _render_card(card: dict) -> dict:
    """Public report-card view: raw reservoir replaced by its quantiles."""
    out = {k: v for k, v in card.items() if not k.startswith("_")}
    out["kinds"] = {k: dict(v) for k, v in card["kinds"].items()}
    out["rejected"] = dict(card["rejected"])
    lat = card["_lat_ms"]
    out["p50_ms"] = round(_quantile_ms(lat, 0.50), 3)
    out["p99_ms"] = round(_quantile_ms(lat, 0.99), 3)
    out["lat_sampled"] = len(lat)
    return out


def slot_cards(last: Optional[int] = None) -> List[dict]:
    """Retained report cards, ascending by slot; ``last`` keeps only the
    newest N."""
    with _lock:
        slots = sorted(_cards)
        if last is not None:
            slots = slots[-max(0, int(last)):] if last > 0 else []
        return [_render_card(_cards[s]) for s in slots]


def epoch_cards(last: Optional[int] = None) -> List[dict]:
    """Epoch rows (first sightings / hits / ratio), ascending by epoch."""
    with _lock:
        epochs = sorted(_epochs)
        if last is not None:
            epochs = epochs[-max(0, int(last)):] if last > 0 else []
        out = []
        for e in epochs:
            row = _epochs[e]
            total = row["first"] + row["hits"]
            out.append(
                {
                    "epoch": e,
                    "first_sightings": row["first"],
                    "hits": row["hits"],
                    "sightings": total,
                    "hit_ratio": round(row["hits"] / total, 4) if total else 0.0,
                }
            )
        return out


def lifetime_totals() -> dict:
    """Lifetime counters (conservation: retained + evicted == these)."""
    with _lock:
        return dict(_lifetime)


def evicted_totals() -> dict:
    with _lock:
        return dict(_evicted)


def summary() -> dict:
    """The ``chain_time`` document: clock parameters, retention state,
    lifetime totals and the newest epoch's dial."""
    clock = slot_clock.get_clock()
    with _lock:
        retained = len(_cards)
        evicted_cards = _evicted_cards
        lifetime = dict(_lifetime)
        newest = max(_epochs) if _epochs else None
        row = dict(_epochs[newest]) if newest is not None else None
    doc = {
        "enabled": _enabled,
        "current_slot": clock.now(),
        "current_epoch": clock.current_epoch(),
        "seconds_per_slot": clock.seconds_per_slot,
        "slots_per_epoch": clock.slots_per_epoch,
        "slots_retained": retained,
        "max_slots": _max_slots,
        "cards_evicted": evicted_cards,
        "lifetime": lifetime,
    }
    if row is not None:
        total = row["first"] + row["hits"]
        doc["latest_epoch"] = {
            "epoch": newest,
            "first_sightings": row["first"],
            "hits": row["hits"],
            "hit_ratio": round(row["hits"] / total, 4) if total else 0.0,
        }
    return doc


# ---------------------------------------------------------------------------
# Control
# ---------------------------------------------------------------------------


def enabled() -> bool:
    return _enabled


def configure(
    enabled: Optional[bool] = None,
    max_slots: Optional[int] = None,
    max_epochs: Optional[int] = None,
) -> dict:
    """Override settings at runtime; returns the PREVIOUS values so
    callers (tests, replay drivers) restore with ``configure(**prev)``.
    Shrinking ``max_slots`` applies retention immediately."""
    global _enabled, _max_slots, _max_epochs
    prev = {
        "enabled": _enabled,
        "max_slots": _max_slots,
        "max_epochs": _max_epochs,
    }
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if max_slots is not None:
            _max_slots = max(1, int(max_slots))
            while len(_cards) > _max_slots:
                _evict(min(_cards))
            _SLOTS_RETAINED.set(len(_cards))
        if max_epochs is not None:
            _max_epochs = max(1, int(max_epochs))
            while len(_epochs) > _max_epochs:
                del _epochs[min(_epochs)]
    return prev


def reset() -> None:
    """Drop every card, epoch row and total (retention knobs unchanged)."""
    global _lifetime, _evicted, _evicted_cards
    with _lock:
        _cards.clear()
        _epochs.clear()
        _lifetime = _zero_totals()
        _evicted = _zero_totals()
        _evicted_cards = 0
        _SLOTS_RETAINED.set(0)


# ---------------------------------------------------------------------------
# Committee sighting model (replay-side)
# ---------------------------------------------------------------------------


class CommitteeSightingModel:
    """A mirror of the key table's aggregate-cache admission policy, for
    replays where no device key table exists (stub or ``cpu-native``
    verifiers never call ``resolve_sets``): a committee validator-index
    tuple is a collapsed **hit** only once it has been seen
    ``min_repeats`` times before (the table inserts a candidate at its
    ``min_repeats``-th miss: sighting 1 is a first, sighting 2 the
    first+insert, sighting 3+ are hits, matching
    ``DEFAULT_AGG_MIN_REPEATS = 2``). Feeds the same
    :func:`note_committee_sighting` dial as the real table."""

    def __init__(self, min_repeats: int = 2):
        self.min_repeats = max(1, int(min_repeats))
        self._seen: Dict[Tuple[int, ...], int] = {}
        self.first = 0
        self.hits = 0
        self.prewarmed = 0

    def prewarm(self, committees) -> int:
        """Duty-lookahead admission: mark each committee tuple as already
        satisfying the repeat threshold (the model's mirror of
        ``DeviceKeyTable.insert_precomputed``, which bypasses
        ``agg_min_repeats``). A prewarmed tuple's FIRST observe is a hit.
        Warming is not a sighting: nothing is noted to the ledger here.
        Returns tuples newly warmed."""
        n = 0
        for c in committees:
            key = tuple(int(v) for v in c)
            if self._seen.get(key, 0) < self.min_repeats:
                self._seen[key] = self.min_repeats
                n += 1
        self.prewarmed += n
        return n

    def observe(self, committee, slot: Optional[int] = None) -> str:
        key = tuple(int(v) for v in committee)
        prior = self._seen.get(key, 0)
        self._seen[key] = prior + 1
        outcome = "hit" if prior >= self.min_repeats else "first"
        if outcome == "hit":
            self.hits += 1
        else:
            self.first += 1
        note_committee_sighting(outcome, slot=slot)
        return outcome

    def hit_ratio(self) -> float:
        total = self.first + self.hits
        return self.hits / total if total else 0.0
