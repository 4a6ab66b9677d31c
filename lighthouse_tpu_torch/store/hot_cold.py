"""Hot/cold split database (reference:
``beacon_node/store/src/hot_cold_store.rs:49-62`` — hot DB holds recent
states + all blocks; the cold "freezer" holds finalized history as sparse
restore-point states + per-slot root indexes, reconstructed by replay).

Layout here:

* blocks: ``Column.BLOCK``, key = block root, value = fork byte + SSZ.
* hot states: full SSZ snapshots every ``slots_per_snapshot`` slots
  (``Column.STATE``); other slots get a :class:`StateSummary`
  (``Column.STATE_SUMMARY``) and are rebuilt by replaying blocks from the
  nearest snapshot at or below — the reference's `load_hot_state` +
  `BlockReplayer` path (``hot_cold_store.rs`` ``load_hot_state``,
  ``state_processing/src/block_replayer.rs``).
* cold: on finalization ``migrate`` moves everything at or below the split
  slot out of the hot columns; restore-point states every
  ``slots_per_restore_point`` (``Column.COLD_STATE``) plus per-slot
  block/state-root indexes (``Column.COLD_BLOCK_ROOTS`` /
  ``COLD_STATE_ROOTS``) for forwards iteration.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from ..ssz import hash_tree_root
from ..state_transition.epoch import fork_of
from ..types.containers import FORK_IDS as _FORK_IDS, FORK_NAMES as _FORK_NAMES
from ..utils import metrics
from .kv import Column, KeyValueStore

_STATE_READS = metrics.histogram(
    "store_state_read_seconds", "get_state latency incl. any replay"
)
_STATE_REPLAYS = metrics.counter(
    "store_state_replays_total", "states rebuilt by block replay"
)
_BLOCK_READS = metrics.counter("store_block_reads_total", "get_block calls")
_MIGRATE_TIME = metrics.histogram(
    "store_migrate_seconds", "freezer migration latency"
)
_DB_SIZE = metrics.gauge(
    "store_db_size_bytes", "approximate database size (0 if unknown)"
)

_SPLIT_KEY = b"split"
_HEAD_KEY = b"head"
_GENESIS_STATE_ROOT_KEY = b"genesis_state_root"


@dataclass
class StateSummary:
    """Hot-DB record for a non-snapshot state (reference
    ``HotStateSummary``): enough to find the replay base and blocks."""

    slot: int
    latest_block_root: bytes
    previous_state_root: bytes

    def encode(self) -> bytes:
        return struct.pack("<Q", self.slot) + self.latest_block_root + self.previous_state_root

    @classmethod
    def decode(cls, data: bytes) -> "StateSummary":
        (slot,) = struct.unpack_from("<Q", data)
        return cls(slot, data[8:40], data[40:72])


class StoreError(ValueError):
    pass


class HotColdDB:
    """``types`` is the ``types_for(preset)`` namespace; ``replayer`` is
    ``(state, blocks, target_slot) -> state`` (dependency-injected so the
    store does not hard-bind the signature-verification strategy)."""

    def __init__(
        self,
        kv: KeyValueStore,
        types,
        spec,
        replayer: Callable,
        slots_per_snapshot: int = 32,
        slots_per_restore_point: int = 2048,
    ):
        self.kv = kv
        self.types = types
        self.preset = types.preset
        self.spec = spec
        self.replayer = replayer
        self.slots_per_snapshot = slots_per_snapshot
        self.slots_per_restore_point = slots_per_restore_point

    # -- split ----------------------------------------------------------

    @property
    def split_slot(self) -> int:
        raw = self.kv.get(Column.METADATA, _SPLIT_KEY)
        return struct.unpack("<Q", raw)[0] if raw else 0

    def _set_split_slot(self, slot: int) -> None:
        self.kv.put(Column.METADATA, _SPLIT_KEY, struct.pack("<Q", slot))

    # -- blocks ----------------------------------------------------------

    def put_block(self, block_root: bytes, signed_block) -> None:
        fork = _fork_of_block(self.types, signed_block)
        data = bytes([_FORK_IDS[fork]]) + type(signed_block).encode(signed_block)
        self.kv.put(Column.BLOCK, block_root, data)

    def get_block(self, block_root: bytes):
        _BLOCK_READS.inc()
        data = self.kv.get(Column.BLOCK, block_root)
        if data is None:
            return None
        fork = _FORK_NAMES[data[0]]
        return self.types.signed_block[fork].decode(data[1:])

    def block_exists(self, block_root: bytes) -> bool:
        return self.kv.get(Column.BLOCK, block_root) is not None

    # -- hot states ------------------------------------------------------

    def put_state(self, state_root: bytes, state) -> None:
        """Snapshot or summary depending on slot alignment."""
        if state.slot % self.slots_per_snapshot == 0:
            self._put_state_full(Column.STATE, state_root, state)
        else:
            summary = StateSummary(
                slot=state.slot,
                latest_block_root=_latest_block_root(state, state_root),
                previous_state_root=bytes(
                    state.state_roots[(state.slot - 1) % self.preset.SLOTS_PER_HISTORICAL_ROOT]
                ),
            )
            self.kv.put(Column.STATE_SUMMARY, state_root, summary.encode())

    def put_state_snapshot(self, state_root: bytes, state) -> None:
        """Force a full snapshot (genesis / anchor states)."""
        self._put_state_full(Column.STATE, state_root, state)

    def _put_state_full(self, column: str, state_root: bytes, state) -> None:
        fork = fork_of(state)
        data = bytes([_FORK_IDS[fork]]) + type(state).encode(state)
        self.kv.put(column, state_root, data)

    def _get_state_full(self, column: str, state_root: bytes):
        data = self.kv.get(column, state_root)
        if data is None:
            return None
        fork = _FORK_NAMES[data[0]]
        return self.types.state[fork].decode(data[1:])

    def get_state(self, state_root: bytes):
        """Load a state: hot snapshot directly, hot summary via replay,
        frozen states via restore-point + cold-index replay."""
        with _STATE_READS.time():
            state = self._get_state_full(Column.STATE, state_root)
            if state is not None:
                return state
            raw = self.kv.get(Column.STATE_SUMMARY, state_root)
            if raw is None:
                return self._load_cold_state(state_root)
            summary = StateSummary.decode(raw)
            _STATE_REPLAYS.inc()
            return self._replay_to(summary)

    def _replay_to(self, summary: StateSummary):
        """Walk summaries back to a snapshot, collect the block chain in
        between, replay forward."""
        blocks = []
        seen_root = None
        cur = summary
        while True:
            # Empty slots share latest_block_root with their predecessor —
            # dedupe by root while walking backwards.
            if cur.latest_block_root != seen_root:
                block = self.get_block(cur.latest_block_root)
                if block is None:
                    raise StoreError(
                        f"replay: missing block {cur.latest_block_root.hex()[:12]}"
                    )
                blocks.append(block)
                seen_root = cur.latest_block_root
            base = self._get_state_full(Column.STATE, cur.previous_state_root)
            if base is None:
                base = self._get_cold_state(cur.previous_state_root)
            if base is not None:
                chain = [b for b in reversed(blocks) if b.message.slot > base.slot]
                return self.replayer(base, chain, summary.slot)
            raw = self.kv.get(Column.STATE_SUMMARY, cur.previous_state_root)
            if raw is None:
                raise StoreError(
                    f"replay: missing summary {cur.previous_state_root.hex()[:12]}"
                )
            cur = StateSummary.decode(raw)

    def _get_cold_state(self, state_root: bytes):
        """Restore-point lookup across both freezer layouts: chunked
        (COLD_PARTIAL, freezer.py) then legacy full SSZ (COLD_STATE)."""
        from . import freezer

        state = freezer.load_restore_point(
            self.kv, self.types, state_root,
            self.cold_block_root_at_slot, self._cold_state_root_at_slot,
        )
        if state is not None:
            return state
        return self._get_state_full(Column.COLD_STATE, state_root)

    def _cold_state_root_at_slot(self, slot: int) -> Optional[bytes]:
        return self.kv.get(Column.COLD_STATE_ROOTS, struct.pack("<Q", slot))

    def _load_cold_state(self, state_root: bytes):
        """Frozen state: restore point at or below + replay through the
        cold per-slot block index (reference ``hot_cold_store.rs``
        ``load_cold_state`` + state reconstruction)."""
        state = self._get_cold_state(state_root)
        if state is not None:
            return state
        raw = self.kv.get(Column.COLD_STATE_SLOTS, state_root)
        if raw is None:
            return None
        (slot,) = struct.unpack("<Q", raw)
        srp = self.slots_per_restore_point
        base = None
        base_slot = (slot // srp) * srp
        while base is None and base_slot >= 0:
            base_root = self.kv.get(
                Column.COLD_STATE_ROOTS, struct.pack("<Q", base_slot)
            )
            if base_root is not None:
                base = self._get_cold_state(base_root)
            if base is None:
                if base_slot == 0:
                    break
                base_slot -= srp
        if base is None:
            raise StoreError(f"no restore point at or below slot {slot}")
        blocks, seen = [], None
        for s in range(base.slot + 1, slot + 1):
            br = self.cold_block_root_at_slot(s)
            if br is None or br == seen:
                continue
            block = self.get_block(br)
            if block is None:
                raise StoreError(f"cold replay: missing block at slot {s}")
            if block.message.slot > base.slot:
                blocks.append(block)
            seen = br
        return self.replayer(base, blocks, slot)

    # -- cold (freezer) --------------------------------------------------

    def migrate(self, finalized_state_root: bytes, finalized_state) -> None:
        """Move finalized history below the new split into the freezer
        (reference ``beacon_chain/src/migrate.rs`` + ``hot_cold_store``
        ``migrate_database``): walk back from the finalized state, index
        roots per slot, keep restore points, drop hot entries."""
        new_split = finalized_state.slot
        old_split = self.split_slot
        if new_split <= old_split:
            return
        _timer = _MIGRATE_TIME.time()
        _timer.__enter__()

        # Per-slot root indexes for the newly-frozen range, walked from the
        # finalized state backwards via summaries/snapshots.
        root = finalized_state_root
        restore_points: list[bytes] = []
        while True:
            raw_sum = self.kv.get(Column.STATE_SUMMARY, root)
            full = self._get_state_full(Column.STATE, root)
            if raw_sum is not None:
                s = StateSummary.decode(raw_sum)
                slot, block_root, prev = s.slot, s.latest_block_root, s.previous_state_root
            elif full is not None:
                slot = full.slot
                block_root = _latest_block_root(full, root)
                prev = bytes(
                    full.state_roots[(slot - 1) % self.preset.SLOTS_PER_HISTORICAL_ROOT]
                ) if slot > 0 else None
            else:
                break  # already migrated (or anchor boundary)
            if slot < old_split:
                break
            self.kv.put_batch(
                [
                    (Column.COLD_BLOCK_ROOTS, struct.pack("<Q", slot), block_root),
                    (Column.COLD_STATE_ROOTS, struct.pack("<Q", slot), root),
                    (Column.COLD_STATE_SLOTS, root, struct.pack("<Q", slot)),
                ]
            )
            if slot % self.slots_per_restore_point == 0:
                restore_points.append(root)
            if slot == 0 or prev is None:
                break
            root = prev

        # Restore points are materialized AFTER the walk so the per-slot
        # cold index covering their vector windows is complete, and BEFORE
        # hot entries are dropped (their states load from hot summaries).
        # Stored CHUNKED (freezer.py): vectors reconstruct from the cold
        # index, validators from the interned record table. A round-trip
        # byte-compare guards bit-exactness; any mismatch (e.g. a
        # checkpoint-synced node whose window predates the cold index)
        # falls back to the legacy full snapshot.
        from . import freezer

        for rp_root in restore_points:
            full = self.get_state(rp_root)
            freezer.put_restore_point(self.kv, self.types, rp_root, full)
            loaded = freezer.load_restore_point(
                self.kv, self.types, rp_root,
                self.cold_block_root_at_slot, self._cold_state_root_at_slot,
            )
            if loaded is None or type(full).encode(full) != type(loaded).encode(loaded):
                self.kv.delete(Column.COLD_PARTIAL, rp_root)
                self._put_state_full(Column.COLD_STATE, rp_root, full)

        # The finalized state itself anchors the hot DB: keep it as a full
        # snapshot, drop frozen summaries/snapshots strictly below it.
        self._put_state_full(Column.STATE, finalized_state_root, finalized_state)
        for col in (Column.STATE, Column.STATE_SUMMARY):
            for key in list(self.kv.keys(col)):
                if key == finalized_state_root:
                    continue
                raw = self.kv.get(col, key)
                if raw is None:
                    continue
                slot = (
                    StateSummary.decode(raw).slot
                    if col == Column.STATE_SUMMARY
                    # fork byte + genesis_time (8) + genesis_validators_root (32)
                    else struct.unpack_from("<Q", raw, 41)[0]
                )
                if slot < new_split:
                    self.kv.delete(col, key)
        self._set_split_slot(new_split)
        _timer.__exit__(None, None, None)
        _DB_SIZE.set(self.kv.approx_size())

    def cold_block_root_at_slot(self, slot: int) -> Optional[bytes]:
        return self.kv.get(Column.COLD_BLOCK_ROOTS, struct.pack("<Q", slot))

    def forwards_block_roots(self, start_slot: int, end_slot: int) -> Iterator[tuple[int, bytes]]:
        """Cold-range forwards iterator (reference ``forwards_iter.rs``)."""
        for slot in range(start_slot, end_slot + 1):
            root = self.cold_block_root_at_slot(slot)
            if root is not None:
                yield slot, root

    # -- head / metadata -------------------------------------------------

    def put_head(self, block_root: bytes) -> None:
        self.kv.put(Column.METADATA, _HEAD_KEY, block_root)

    def get_head(self) -> Optional[bytes]:
        return self.kv.get(Column.METADATA, _HEAD_KEY)

    def put_genesis_state_root(self, root: bytes) -> None:
        self.kv.put(Column.METADATA, _GENESIS_STATE_ROOT_KEY, root)

    def get_genesis_state_root(self) -> Optional[bytes]:
        return self.kv.get(Column.METADATA, _GENESIS_STATE_ROOT_KEY)

    def put_blob(self, column: str, key: bytes, data: bytes) -> None:
        self.kv.put(column, key, data)

    def get_blob(self, column: str, key: bytes) -> Optional[bytes]:
        return self.kv.get(column, key)


def _latest_block_root(state, state_root_hint: bytes | None = None) -> bytes:
    from ..state_transition.helpers import latest_block_header_root

    return latest_block_header_root(state, state_root_hint)


def _fork_of_block(types, signed_block) -> str:
    for fork, cls in types.signed_block.items():
        if isinstance(signed_block, cls):
            return fork
    raise StoreError(f"unknown block type {type(signed_block).__name__}")
