"""Validator monitor (reference:
``beacon_node/beacon_chain/src/validator_monitor.rs:112-165`` — tracks
registered validators' attestation inclusion/latency and block proposals,
exported through the metrics registry and an API summary).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..utils import flight_recorder, logging, metrics

_MONITORED = metrics.gauge(
    "validator_monitor_validators", "number of monitored validators"
)
_FAILURES = metrics.counter_vec(
    "validator_monitor_failures_total",
    "monitored validators' rejected gossip objects, by kind and reason "
    "(fed by the flight-recorder rejection events)",
    ("kind", "reason"),
)
# a rejection storm against a monitored validator is one page, not a
# log line per event (the journal + counter keep the full count)
_FAIL_LATCH = logging.TimeLatch(10.0)
_ATT_HITS = metrics.counter(
    "validator_monitor_attestation_in_block_total",
    "monitored validators' attestations observed in imported blocks",
)
_PROPOSALS = metrics.counter(
    "validator_monitor_block_proposals_total",
    "monitored validators' imported block proposals",
)
_DELAY = metrics.histogram(
    "validator_monitor_inclusion_delay_slots",
    "attestation inclusion delay for monitored validators",
    buckets=(1, 2, 3, 4, 8, 16, 32),
)


@dataclass
class ValidatorRecord:
    index: int
    attestations_included: int = 0
    blocks_proposed: int = 0
    attestations_failed: int = 0
    blocks_failed: int = 0
    last_failure_reason: str | None = None
    last_attestation_slot: int | None = None
    last_inclusion_delay: int | None = None
    missed_epochs: set = field(default_factory=set)


class ValidatorMonitor:
    """Register indices (or ``auto`` to watch everyone) and feed imported
    blocks through ``process_block``; summaries come out of ``summary()``
    and the process metrics registry."""

    def __init__(self, auto: bool = False):
        self.auto = auto
        self._records: dict[int, ValidatorRecord] = {}
        self._lock = threading.Lock()
        self._attached = False

    # -- flight-recorder wiring -------------------------------------------

    def attach(self) -> "ValidatorMonitor":
        """Subscribe to the flight-recorder journal: ``attestation_rejected``
        and ``block_rejected`` events for monitored validators become
        ``validator_monitor_failures_total{kind, reason}`` ticks, per-record
        failure counts, and a warn log — a monitored validator failing to
        land work is an operator page, not just an anonymous counter."""
        if not self._attached:
            flight_recorder.subscribe(self._on_event)
            self._attached = True
        return self

    def detach(self) -> None:
        if self._attached:
            flight_recorder.unsubscribe(self._on_event)
            self._attached = False

    def _on_event(self, ev: dict) -> None:
        kind = ev.get("kind")
        fields = ev.get("fields") or {}
        if kind == "attestation_rejected":
            index = fields.get("validator_index", fields.get("aggregator_index"))
            failure = "attestation"
        elif kind == "block_rejected":
            index = fields.get("proposer_index")
            failure = "block"
        else:
            return
        if index is None:
            return  # rejection happened before an index was known
        reason = fields.get("reason", "unknown")
        with self._lock:
            # observe-only, even in auto mode: a rejection can carry an
            # ATTACKER-SUPPLIED index (e.g. a bogus proposer_index on a
            # junk gossip block) — only indices already registered (or
            # auto-registered from VALIDATED imports) may grow state
            rec = self._records.get(int(index))
            if rec is None:
                return  # not monitored
            if failure == "attestation":
                rec.attestations_failed += 1
            else:
                rec.blocks_failed += 1
            rec.last_failure_reason = reason
        _FAILURES.with_labels(failure, reason).inc()
        logging.rate_limited(
            _FAIL_LATCH, "warn", f"monitored validator {failure} rejected",
            validator_index=int(index), reason=reason,
            slot=fields.get("slot"),
        )

    def add_validator(self, index: int) -> None:
        with self._lock:
            self._records.setdefault(index, ValidatorRecord(index))
            _MONITORED.set(len(self._records))

    def _record(self, index: int) -> ValidatorRecord | None:
        rec = self._records.get(index)
        if rec is None and self.auto:
            rec = self._records[index] = ValidatorRecord(index)
            _MONITORED.set(len(self._records))
        return rec

    # -- feed -------------------------------------------------------------

    def process_block(self, chain, signed_block, state) -> None:
        """Called after import with the block's post-state: credits the
        proposer and every monitored attester in the block's attestations
        (the reference hooks the same import path)."""
        block = signed_block.message
        with self._lock:
            rec = self._record(block.proposer_index)
            if rec is not None:
                rec.blocks_proposed += 1
                _PROPOSALS.inc()
            from ..state_transition import get_attesting_indices

            seen: set = set()  # overlapping aggregates must not double-count
            for att in block.body.attestations:
                try:
                    indices = get_attesting_indices(
                        chain.preset, state, att.data, att.aggregation_bits
                    )
                except Exception:
                    continue
                delay = block.slot - att.data.slot
                for vi in indices:
                    key = (int(vi), att.data.slot, att.data.index)
                    if key in seen:
                        continue
                    seen.add(key)
                    rec = self._record(int(vi))
                    if rec is None:
                        continue
                    rec.attestations_included += 1
                    rec.last_attestation_slot = att.data.slot
                    rec.last_inclusion_delay = delay
                    _ATT_HITS.inc()
                    _DELAY.observe(delay)

    def note_missed_epoch(self, index: int, epoch: int) -> None:
        with self._lock:
            rec = self._records.get(index)
            if rec is not None:
                rec.missed_epochs.add(epoch)

    # -- read -------------------------------------------------------------

    def summary(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "index": r.index,
                    "attestations_included": r.attestations_included,
                    "blocks_proposed": r.blocks_proposed,
                    "attestations_failed": r.attestations_failed,
                    "blocks_failed": r.blocks_failed,
                    "last_failure_reason": r.last_failure_reason,
                    "last_attestation_slot": r.last_attestation_slot,
                    "last_inclusion_delay": r.last_inclusion_delay,
                    "missed_epochs": sorted(r.missed_epochs),
                }
                for r in self._records.values()
            ]
