"""Fork-boundary revert (reference:
``beacon_node/beacon_chain/src/fork_revert.rs:19-30`` —
``revert_to_fork_boundary``: when the head is stuck on a pre-fork branch
whose blocks were produced without the fork applied, reset the head to
the last block before the fork boundary so the chain can re-sync onto
the right branch)."""

from __future__ import annotations

from ..store.iter import block_roots_iter


def revert_to_fork_boundary(chain, fork_epoch: int) -> bytes:
    """Re-anchor ``chain`` at the latest stored block strictly before the
    fork boundary slot. Returns the new head root. Blocks above the
    boundary remain in the store but leave fork choice (they are re-run
    through import if they were actually valid)."""
    boundary_slot = fork_epoch * chain.preset.SLOTS_PER_EPOCH
    target = None
    for slot, root in block_roots_iter(chain.store, chain.head_block_root):
        if slot < boundary_slot:
            target = (slot, root)
            break
    if target is None:
        raise ValueError("no pre-fork block found to revert to")
    slot, root = target
    block = chain.store.get_block(root)
    state = chain.store.get_state(bytes(block.message.state_root))
    if state is None:
        raise ValueError("pre-fork state unavailable for revert")

    # re-anchor fork choice at the boundary block
    from ..fork_choice.fork_choice import ForkChoice

    chain.fork_choice = ForkChoice(
        chain.preset,
        chain.spec,
        state.slot,
        root,
        (state.current_justified_checkpoint.epoch, root),
        (state.finalized_checkpoint.epoch, root),
        [v.effective_balance for v in state.validators],
    )
    chain.set_head(root, state)
    chain._last_finalized_epoch = state.finalized_checkpoint.epoch
    chain.snapshot_cache.insert(root, state)
    chain.store.put_head(root)
    return root
