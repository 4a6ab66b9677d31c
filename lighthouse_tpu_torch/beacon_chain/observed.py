"""Duplicate-detection caches (reference:
``beacon_node/beacon_chain/src/observed_attesters.rs`` (1,002 LoC),
``observed_aggregates.rs``, ``observed_block_producers.rs``,
``observed_operations.rs``).

These guard the gossip pipelines: an item seen once is not re-verified or
re-propagated. All prune on finalization advance.
"""

from __future__ import annotations

from typing import Iterable


class ObservedAttesters:
    """(validator, target-epoch) pairs for unaggregated attestations —
    one vote per epoch per validator may be gossiped."""

    def __init__(self):
        self._by_epoch: dict[int, set[int]] = {}

    def observe(self, validator_index: int, epoch: int) -> bool:
        """Record; True if it was already present."""
        seen = self._by_epoch.setdefault(epoch, set())
        if validator_index in seen:
            return True
        seen.add(validator_index)
        return False

    def is_known(self, validator_index: int, epoch: int) -> bool:
        return validator_index in self._by_epoch.get(epoch, ())

    def prune(self, finalized_epoch: int) -> None:
        for e in [e for e in self._by_epoch if e < finalized_epoch]:
            del self._by_epoch[e]


class ObservedAggregators(ObservedAttesters):
    """(aggregator, target-epoch) — one aggregate per epoch per aggregator."""


class ObservedAggregates:
    """Roots of aggregate attestations already fully processed (keyed by
    hash-tree-root of the attestation, per slot)."""

    def __init__(self):
        self._by_slot: dict[int, set[bytes]] = {}

    def observe(self, att_root: bytes, slot: int) -> bool:
        seen = self._by_slot.setdefault(slot, set())
        if att_root in seen:
            return True
        seen.add(att_root)
        return False

    def is_known(self, att_root: bytes, slot: int) -> bool:
        return att_root in self._by_slot.get(slot, ())

    def prune(self, finalized_slot: int) -> None:
        for s in [s for s in self._by_slot if s < finalized_slot]:
            del self._by_slot[s]


class ObservedBlockProducers:
    """(proposer, slot) pairs — equivocation guard on gossip blocks."""

    def __init__(self):
        self._by_slot: dict[int, set[int]] = {}

    def observe(self, proposer_index: int, slot: int) -> bool:
        seen = self._by_slot.setdefault(slot, set())
        if proposer_index in seen:
            return True
        seen.add(proposer_index)
        return False

    def is_known(self, proposer_index: int, slot: int) -> bool:
        return proposer_index in self._by_slot.get(slot, ())

    def prune(self, finalized_slot: int) -> None:
        for s in [s for s in self._by_slot if s <= finalized_slot]:
            del self._by_slot[s]


class ObservedOperations:
    """Dedup for gossiped slashings/exits (reference
    ``observed_operations.rs``): proposer slashings by proposer index,
    exits by validator index, attester slashings by attesting-index
    coverage (a slashing adding no new indices is redundant)."""

    def __init__(self):
        self.proposer_slashings: set[int] = set()
        self.exits: set[int] = set()
        self.attester_slashed: set[int] = set()

    def observe_proposer_slashing(self, proposer_index: int) -> bool:
        if proposer_index in self.proposer_slashings:
            return True
        self.proposer_slashings.add(proposer_index)
        return False

    def observe_exit(self, validator_index: int) -> bool:
        if validator_index in self.exits:
            return True
        self.exits.add(validator_index)
        return False

    def observe_attester_slashing(self, slashable_indices: Iterable[int]) -> bool:
        new = set(slashable_indices) - self.attester_slashed
        if not new:
            return True
        self.attester_slashed |= new
        return False
