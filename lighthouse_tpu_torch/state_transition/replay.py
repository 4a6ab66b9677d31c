"""Block replay (reference: ``consensus/state_processing/src/block_replayer.rs``):
re-apply a chain of already-verified blocks to a base state, advancing
through empty slots, without re-verifying signatures.

Used by the store to rebuild summary states from snapshots and by
checkpoint-sync backfill.
"""

from __future__ import annotations

import copy

from ..types.chain_spec import ChainSpec
from ..types.preset import Preset
from .block import process_block
from .epoch import fork_of
from .slot import per_slot_processing


def replay_blocks(
    preset: Preset,
    spec: ChainSpec,
    base_state,
    blocks,
    target_slot: int,
    copy_state: bool = True,
):
    """Apply ``blocks`` (ascending slots, all > base_state.slot) and then
    advance empty slots to ``target_slot``. Signature verification is
    skipped — replay is only ever fed blocks that were verified on import
    (reference BlockReplayer uses NoVerification)."""
    state = copy.deepcopy(base_state) if copy_state else base_state
    for signed in blocks:
        while state.slot < signed.message.slot:
            state = per_slot_processing(preset, spec, state)
        process_block(
            preset, spec, state, signed, fork_of(state), signature_strategy="none"
        )
    while state.slot < target_slot:
        state = per_slot_processing(preset, spec, state)
    return state


def store_replayer(preset: Preset, spec: ChainSpec):
    """Adapter with the HotColdDB replayer signature."""

    def _replay(base_state, blocks, target_slot):
        return replay_blocks(preset, spec, base_state, blocks, target_slot)

    return _replay
