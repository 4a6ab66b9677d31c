"""Spec state-transition function (reference layer:
``consensus/state_processing``, SURVEY.md §2.3): slot/epoch/block
processing, shuffling/committees, signature-set accumulation (the feeder
of the TPU BLS backend), genesis, and fork upgrades.
"""

from .block import (
    BlockProcessingError,
    process_block,
    state_pubkey_resolver,
)
from .epoch import fork_of, process_epoch
from .genesis import (
    initialize_beacon_state_from_eth1,
    interop_genesis_state,
    interop_secret_key,
    is_valid_genesis_state,
)
from .merkle import compute_merkle_root, is_valid_merkle_branch
from .replay import replay_blocks, store_replayer
from .mutators import initiate_validator_exit, slash_validator
from .shuffle import compute_shuffled_index, shuffle_list, unshuffle_list
from .signature_sets import BlockSignatureAccumulator
from .slot import partial_state_advance, per_slot_processing, process_slot, state_transition
from .upgrade import maybe_upgrade_state, upgrade_to_altair, upgrade_to_bellatrix
from .helpers import (
    CommitteeCache,
    compute_activation_exit_epoch,
    compute_committee,
    compute_epoch_at_slot,
    compute_proposer_index,
    compute_start_slot_at_epoch,
    get_active_validator_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_block_root,
    get_block_root_at_slot,
    get_committee_count_per_slot,
    get_current_epoch,
    get_previous_epoch,
    get_randao_mix,
    get_seed,
    get_total_active_balance,
    get_total_balance,
    get_validator_churn_limit,
    integer_squareroot,
    is_active_validator,
    is_eligible_for_activation,
    is_eligible_for_activation_queue,
    is_slashable_attestation_data,
    is_slashable_validator,
    is_valid_indexed_attestation_structure,
    get_indexed_attestation,
    get_attesting_indices,
)

__all__ = [k for k in dir() if not k.startswith("_")]
