"""Ancestor iterators over stored chains (reference:
``beacon_node/store/src/iter.rs`` ``BlockRootsIterator`` /
``StateRootsIterator`` — walk backwards from a block/state towards
genesis, crossing into the freezer when the hot chain ends).
"""

from __future__ import annotations

from typing import Iterator

from .hot_cold import HotColdDB


def block_roots_iter(db: HotColdDB, head_block_root: bytes) -> Iterator[tuple[int, bytes]]:
    """Yield (slot, block_root) walking back from ``head_block_root`` to
    genesis (block-granular: empty slots are skipped, like the reference's
    parent-chain walk)."""
    root = head_block_root
    while True:
        block = db.get_block(root)
        if block is None:
            return
        slot = block.message.slot
        yield slot, root
        if slot == 0:
            return
        parent = bytes(block.message.parent_root)
        if parent == bytes(32):
            return
        root = parent


def state_roots_iter(db: HotColdDB, head_state_root: bytes) -> Iterator[tuple[int, bytes]]:
    """Yield (slot, state_root) walking back via hot summaries/snapshots,
    then the cold per-slot index."""
    from .kv import Column
    from .hot_cold import StateSummary
    import struct

    root = head_state_root
    while True:
        raw = db.kv.get(Column.STATE_SUMMARY, root)
        if raw is not None:
            s = StateSummary.decode(raw)
            yield s.slot, root
            if s.slot == 0:
                return
            root = s.previous_state_root
            continue
        state = db._get_state_full(Column.STATE, root) or db._get_state_full(
            Column.COLD_STATE, root
        )
        if state is None:
            return
        yield state.slot, root
        if state.slot == 0:
            return
        # continue through the cold index if present, else via state_roots
        prev = db.kv.get(Column.COLD_STATE_ROOTS, struct.pack("<Q", state.slot - 1))
        if prev is None:
            prev = bytes(
                state.state_roots[(state.slot - 1) % db.preset.SLOTS_PER_HISTORICAL_ROOT]
            )
        root = prev
