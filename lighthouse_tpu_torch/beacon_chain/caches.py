"""Production caches: the latency tier that lets the node meet slot
deadlines under load (reference ``beacon_node/beacon_chain/src/
{early_attester_cache,beacon_proposer_cache,attester_cache,
block_times_cache}.rs`` + ``state_advance_timer.rs:93-231``).

All are small, lock-guarded, and advisory: every consumer keeps a
state-backed fallback path, so a miss is a slowdown, never an error.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional


@dataclass
class EarlyAttesterItem:
    epoch: int
    beacon_block_root: bytes
    source: tuple[int, bytes]
    target_root: bytes


class EarlyAttesterCache:
    """Attestation template for the most recently imported head-candidate
    block: serves ``produce_unaggregated_attestation`` without touching
    any state (reference ``beacon_chain.rs:1496-1512``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._item: Optional[EarlyAttesterItem] = None

    def add(self, epoch: int, block_root: bytes, source: tuple[int, bytes],
            target_root: bytes) -> None:
        with self._lock:
            self._item = EarlyAttesterItem(epoch, block_root, source, target_root)

    def try_attest(self, epoch: int, head_root: bytes) -> Optional[EarlyAttesterItem]:
        """The cached template, iff it is for this epoch and this head."""
        with self._lock:
            item = self._item
        if (
            item is not None
            and item.epoch == epoch
            and item.beacon_block_root == head_root
        ):
            return item
        return None


class BeaconProposerCache:
    """(epoch, decision_root) -> proposer index per slot of the epoch
    (reference ``beacon_proposer_cache.rs``; the decision root pins the
    shuffling so a reorg cannot serve stale duties)."""

    def __init__(self, cap: int = 16):
        self._lock = threading.Lock()
        self._cap = cap
        self._map: OrderedDict[tuple[int, bytes], list[int]] = OrderedDict()

    def get(self, epoch: int, decision_root: bytes) -> Optional[list[int]]:
        with self._lock:
            v = self._map.get((epoch, decision_root))
            if v is None:
                return None
            self._map.move_to_end((epoch, decision_root))
            return list(v)  # callers may mutate their copy freely

    def insert(self, epoch: int, decision_root: bytes, proposers: list[int]) -> None:
        with self._lock:
            self._map[(epoch, decision_root)] = list(proposers)
            while len(self._map) > self._cap:
                self._map.popitem(last=False)


@dataclass
class AttesterDutyInfo:
    source: tuple[int, bytes]
    target_root: bytes


class AttesterCache:
    """(epoch, head_root) -> FFG info for attestation production — the
    cross-epoch-boundary fallback that otherwise costs a full state copy
    + epoch advance per request (reference ``attester_cache.rs``)."""

    def __init__(self, cap: int = 16):
        self._lock = threading.Lock()
        self._cap = cap
        self._map: OrderedDict[tuple[int, bytes], AttesterDutyInfo] = OrderedDict()

    def get(self, epoch: int, head_root: bytes) -> Optional[AttesterDutyInfo]:
        with self._lock:
            v = self._map.get((epoch, head_root))
            if v is not None:
                self._map.move_to_end((epoch, head_root))
            return v

    def insert(self, epoch: int, head_root: bytes, info: AttesterDutyInfo) -> None:
        with self._lock:
            self._map[(epoch, head_root)] = info
            while len(self._map) > self._cap:
                self._map.popitem(last=False)


class BlockTimesCache:
    """Per-block observed/imported/became-head timestamps for delay
    metrics and the validator monitor (reference
    ``block_times_cache.rs``). Bounded FIFO."""

    def __init__(self, cap: int = 64):
        self._lock = threading.Lock()
        self._cap = cap
        self._map: OrderedDict[bytes, dict] = OrderedDict()

    def _entry(self, root: bytes) -> dict:
        e = self._map.get(root)
        if e is None:
            e = self._map[root] = {}
            while len(self._map) > self._cap:
                self._map.popitem(last=False)
        return e

    def set_observed(self, root: bytes, ts: float | None = None) -> None:
        with self._lock:
            self._entry(root).setdefault("observed", ts or time.time())

    def set_imported(self, root: bytes, ts: float | None = None) -> None:
        with self._lock:
            self._entry(root).setdefault("imported", ts or time.time())

    def set_became_head(self, root: bytes, ts: float | None = None) -> None:
        with self._lock:
            self._entry(root).setdefault("became_head", ts or time.time())

    def delays(self, root: bytes) -> dict:
        """{observed_to_imported, imported_to_head, observed_to_head}
        (seconds; only the spans whose endpoints were both recorded)."""
        with self._lock:
            e = dict(self._map.get(root, {}))
        out = {}
        if "observed" in e and "imported" in e:
            out["observed_to_imported"] = e["imported"] - e["observed"]
        if "imported" in e and "became_head" in e:
            out["imported_to_head"] = e["became_head"] - e["imported"]
        if "observed" in e and "became_head" in e:
            out["observed_to_head"] = e["became_head"] - e["observed"]
        return out
