"""Per-slot processing + state advance (reference:
``consensus/state_processing/src/per_slot_processing.rs`` and
``state_advance.rs``)."""

from __future__ import annotations

from ..ssz import hash_tree_root
from ..ssz.cache import cached_state_root
from ..types.chain_spec import ChainSpec
from ..types.preset import Preset
from .epoch import process_epoch
from .upgrade import maybe_upgrade_state


def process_slot(preset: Preset, state) -> None:
    """Cache the previous state/block roots (spec process_slot)."""
    prev_state_root = cached_state_root(state)
    state.state_roots[state.slot % preset.SLOTS_PER_HISTORICAL_ROOT] = prev_state_root
    if state.latest_block_header.state_root == bytes(32):
        state.latest_block_header.state_root = prev_state_root
    prev_block_root = hash_tree_root(state.latest_block_header)
    state.block_roots[state.slot % preset.SLOTS_PER_HISTORICAL_ROOT] = prev_block_root


def per_slot_processing(preset: Preset, spec: ChainSpec, state):
    """Advance the state by one slot (epoch processing at boundaries,
    fork upgrade when the new epoch crosses a fork). Returns the state
    (same object, mutated) — possibly REPLACED by its upgraded variant."""
    process_slot(preset, state)
    if (state.slot + 1) % preset.SLOTS_PER_EPOCH == 0:
        process_epoch(preset, spec, state)
    state.slot += 1
    return maybe_upgrade_state(preset, spec, state)


def state_transition(
    preset: Preset, spec: ChainSpec, state, signed_block,
    signature_strategy: str = "individual", validate_result: bool = True,
):
    """The spec's top-level ``state_transition``: advance slots, apply the
    block, and (validate_result) require the block's claimed state root to
    match (reference ``per_block_processing`` callers + spec
    ``state_transition``). Returns the (possibly fork-upgraded) state."""
    from .block import BlockProcessingError, process_block
    from .epoch import fork_of

    block = signed_block.message
    while state.slot < block.slot:
        state = per_slot_processing(preset, spec, state)
    process_block(
        preset, spec, state, signed_block, fork_of(state),
        signature_strategy=signature_strategy,
    )
    if validate_result:
        got = cached_state_root(state)
        if got != bytes(block.state_root):
            raise BlockProcessingError(
                f"state root mismatch: block claims "
                f"{bytes(block.state_root).hex()[:12]}, got {got.hex()[:12]}"
            )
    return state


def partial_state_advance(preset: Preset, spec: ChainSpec, state, target_slot: int):
    """Advance to ``target_slot`` (reference ``partial_state_advance``:
    used before signature verification of future-slot objects)."""
    if target_slot < state.slot:
        raise ValueError("cannot advance backwards")
    while state.slot < target_slot:
        state = per_slot_processing(preset, spec, state)
    return state
