"""Light-client update production (reference:
``beacon_node/beacon_chain``'s light-client server duties over
``consensus/types/src/light_client_*.rs``: serve Bootstrap /
FinalityUpdate / OptimisticUpdate objects proving sync-committee and
finality membership out of the head state)."""

from __future__ import annotations

from ..ssz import hash_tree_root
from ..ssz.proof import compute_merkle_proof
from ..state_transition.helpers import latest_block_header_root


FINALIZED_ROOT_INDEX = 105
NEXT_SYNC_COMMITTEE_INDEX = 55
CURRENT_SYNC_COMMITTEE_INDEX = 54


def _header_for(chain, state):
    """BeaconBlockHeader of the state's latest block, state_root filled."""
    import copy

    header = copy.copy(state.latest_block_header)
    if bytes(header.state_root) == bytes(32):
        header.state_root = hash_tree_root(state)
    return header


def produce_bootstrap(chain, state):
    """LightClientBootstrap for a (finalized) state."""
    t = chain.types
    leaf, branch, gi = compute_merkle_proof(state, ["current_sync_committee"])
    assert gi == CURRENT_SYNC_COMMITTEE_INDEX, gi
    return t.LightClientBootstrap(
        header=_header_for(chain, state),
        current_sync_committee=state.current_sync_committee,
        current_sync_committee_branch=branch,
    )


def produce_finality_update(chain):
    """LightClientFinalityUpdate at the current head."""
    t = chain.types
    state = chain.head_state
    # the branch proves head_state.finalized_checkpoint — the header MUST
    # be that same checkpoint's block (fork choice's store can be ahead)
    fin_root = bytes(state.finalized_checkpoint.root)
    if fin_root == bytes(32):
        return None  # no real finality yet: nothing provable to serve
    fin_block = chain.store.get_block(fin_root)
    if fin_block is None:
        return None
    leaf, branch, gi = compute_merkle_proof(
        state, ["finalized_checkpoint", "root"]
    )
    assert gi == FINALIZED_ROOT_INDEX, gi
    fin_msg = fin_block.message
    finalized_header = t.BeaconBlockHeader(
        slot=fin_msg.slot,
        proposer_index=fin_msg.proposer_index,
        parent_root=bytes(fin_msg.parent_root),
        state_root=bytes(fin_msg.state_root),
        body_root=hash_tree_root(fin_msg.body),
    )
    agg = None
    if chain.op_pool is not None:
        agg = chain.op_pool.sync_aggregate_for_block(
            state.slot, chain.head_block_root
        )
    if agg is None:
        from ..crypto.bls import INFINITY_SIGNATURE

        agg = t.SyncAggregate(sync_committee_signature=INFINITY_SIGNATURE)
    return t.LightClientFinalityUpdate(
        attested_header=_header_for(chain, state),
        finalized_header=finalized_header,
        finality_branch=branch,
        sync_aggregate=agg,
        signature_slot=state.slot + 1,
    )


def produce_optimistic_update(chain):
    t = chain.types
    state = chain.head_state
    agg = None
    if chain.op_pool is not None:
        agg = chain.op_pool.sync_aggregate_for_block(
            state.slot, chain.head_block_root
        )
    if agg is None:
        from ..crypto.bls import INFINITY_SIGNATURE

        agg = t.SyncAggregate(sync_committee_signature=INFINITY_SIGNATURE)
    return t.LightClientOptimisticUpdate(
        attested_header=_header_for(chain, state),
        sync_aggregate=agg,
        signature_slot=state.slot + 1,
    )
