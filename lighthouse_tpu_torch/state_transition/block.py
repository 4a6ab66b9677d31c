"""Per-block processing for phase0/altair/bellatrix (spec
``process_block``; reference:
``consensus/state_processing/src/per_block_processing.rs:91`` and the
``per_block_processing/`` modules).

Signature strategy mirrors the reference's ``BlockSignatureStrategy``
(``per_block_processing.rs:45-56``):

* ``"none"``       — trust everything (used after bulk verification)
* ``"individual"`` — verify each set as it is built
* ``"bulk"``       — accumulate every set, verify as ONE batch first
  (the TPU-native path: one device launch per block), then process with
  ``"none"``.
"""

from __future__ import annotations

from ..crypto import bls
from ..ssz import hash_tree_root
from ..types.chain_spec import ChainSpec, FAR_FUTURE_EPOCH
from ..types.containers import types_for
from ..types.preset import Preset
from . import signature_sets as sigsets
from .helpers import (
    compute_epoch_at_slot,
    get_attesting_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
    get_current_epoch,
    get_indexed_attestation,
    get_previous_epoch,
    get_randao_mix,
    get_total_active_balance,
    get_total_balance,
    increase_balance,
    decrease_balance,
    integer_squareroot,
    is_active_validator,
    is_slashable_attestation_data,
    is_slashable_validator,
    is_valid_indexed_attestation_structure,
    get_block_root,
    get_block_root_at_slot,
)
from .merkle import is_valid_merkle_branch
from .mutators import (
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    add_flag,
    has_flag,
    initiate_validator_exit,
    slash_validator,
)

GENESIS_EPOCH = 0


class BlockProcessingError(ValueError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise BlockProcessingError(msg)


def state_pubkey_resolver(state):
    """index -> PublicKey via the state registry (deserialization-checked,
    memoized — the in-process stand-in for the beacon chain's persistent
    ValidatorPubkeyCache, ``validator_pubkey_cache.rs:20``)."""
    cache: dict[int, bls.PublicKey] = {}

    def resolve(i: int):
        if i in cache:
            return cache[i]
        if i >= len(state.validators):
            return None
        pk = bls.PublicKey.deserialize(state.validators[i].pubkey)
        cache[i] = pk
        return pk

    return resolve


def state_pubkey_bytes_resolver(state):
    cache: dict[bytes, bls.PublicKey] = {}

    def resolve(b: bytes):
        if b not in cache:
            cache[b] = bls.PublicKey.deserialize(b)
        return cache[b]

    return resolve


def _verify_set(s: bls.SignatureSet, what: str) -> None:
    _require(bls.verify_signature_sets([s]), f"invalid signature: {what}")


# ---------------------------------------------------------------------------
# process_block
# ---------------------------------------------------------------------------

def process_block(
    preset: Preset,
    spec: ChainSpec,
    state,
    signed_block,
    fork: str,
    signature_strategy: str = "individual",
    execution_engine=None,
) -> None:
    block = signed_block.message
    resolver = state_pubkey_resolver(state)
    by_bytes = state_pubkey_bytes_resolver(state)

    if signature_strategy == "bulk":
        acc = sigsets.BlockSignatureAccumulator(
            preset, spec, state, resolver, by_bytes
        )
        acc.include_all(signed_block)
        _require(acc.verify(), "bulk signature verification failed")
        signature_strategy = "none"
    elif signature_strategy == "individual":
        _verify_set(
            sigsets.block_proposal_set(preset, spec, state, signed_block, resolver),
            "block proposal",
        )

    verify = signature_strategy == "individual"

    process_block_header(preset, state, block)
    if fork == "bellatrix" and is_execution_enabled(preset, state, block.body):
        process_execution_payload(
            preset, spec, state, block.body.execution_payload, execution_engine
        )
    process_randao(preset, spec, state, block, verify, resolver)
    process_eth1_data(preset, state, block.body)
    process_operations(preset, spec, state, block.body, fork, verify, resolver)
    if fork in ("altair", "bellatrix"):
        process_sync_aggregate(
            preset, spec, state, block.slot, block.body.sync_aggregate, verify, by_bytes
        )


def process_block_header(preset: Preset, state, block) -> None:
    t = types_for(preset)
    _require(block.slot == state.slot, "block slot != state slot")
    _require(
        block.slot > state.latest_block_header.slot, "block not newer than header"
    )
    _require(
        block.proposer_index == get_beacon_proposer_index(preset, state),
        "wrong proposer index",
    )
    _require(
        block.parent_root == hash_tree_root(state.latest_block_header),
        "parent root mismatch",
    )
    state.latest_block_header = t.BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=bytes(32),
        body_root=hash_tree_root(block.body),
    )
    _require(
        not state.validators[block.proposer_index].slashed, "proposer slashed"
    )


def process_randao(
    preset: Preset, spec: ChainSpec, state, block, verify: bool, resolver
) -> None:
    from ..ssz.sha256 import hash_bytes

    epoch = get_current_epoch(preset, state)
    if verify:
        _verify_set(
            sigsets.randao_set(preset, spec, state, block, resolver), "randao reveal"
        )
    mix = bytes(
        a ^ b
        for a, b in zip(
            get_randao_mix(preset, state, epoch), hash_bytes(block.body.randao_reveal)
        )
    )
    state.randao_mixes[epoch % preset.EPOCHS_PER_HISTORICAL_VECTOR] = mix


def process_eth1_data(preset: Preset, state, body) -> None:
    state.eth1_data_votes = list(state.eth1_data_votes) + [body.eth1_data]
    if (
        state.eth1_data_votes.count(body.eth1_data) * 2
        > preset.EPOCHS_PER_ETH1_VOTING_PERIOD * preset.SLOTS_PER_EPOCH
    ):
        state.eth1_data = body.eth1_data


def process_operations(
    preset: Preset, spec: ChainSpec, state, body, fork: str, verify: bool, resolver
) -> None:
    expected_deposits = min(
        preset.MAX_DEPOSITS,
        state.eth1_data.deposit_count - state.eth1_deposit_index,
    )
    _require(
        len(body.deposits) == expected_deposits,
        f"expected {expected_deposits} deposits, block has {len(body.deposits)}",
    )
    for ps in body.proposer_slashings:
        process_proposer_slashing(preset, spec, state, ps, fork, verify, resolver)
    for asl in body.attester_slashings:
        process_attester_slashing(preset, spec, state, asl, fork, verify, resolver)
    for att in body.attestations:
        process_attestation(preset, spec, state, att, fork, verify, resolver)
    for dep in body.deposits:
        process_deposit(preset, spec, state, dep, fork)
    for ex in body.voluntary_exits:
        process_voluntary_exit(preset, spec, state, ex, verify, resolver)


def process_proposer_slashing(
    preset: Preset, spec: ChainSpec, state, slashing, fork: str, verify: bool, resolver
) -> None:
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    _require(h1.slot == h2.slot, "proposer slashing: slots differ")
    _require(
        h1.proposer_index == h2.proposer_index, "proposer slashing: proposers differ"
    )
    _require(h1 != h2, "proposer slashing: identical headers")
    _require(
        h1.proposer_index < len(state.validators), "proposer slashing: bad index"
    )
    v = state.validators[h1.proposer_index]
    _require(
        is_slashable_validator(v, get_current_epoch(preset, state)),
        "proposer slashing: not slashable",
    )
    if verify:
        for s in sigsets.proposer_slashing_sets(preset, spec, state, slashing, resolver):
            _verify_set(s, "proposer slashing header")
    slash_validator(preset, spec, state, fork, h1.proposer_index)


def process_attester_slashing(
    preset: Preset, spec: ChainSpec, state, slashing, fork: str, verify: bool, resolver
) -> None:
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    _require(
        is_slashable_attestation_data(a1.data, a2.data),
        "attester slashing: data not slashable",
    )
    for a in (a1, a2):
        _require(
            is_valid_indexed_attestation_structure(preset, a),
            "attester slashing: malformed indexed attestation",
        )
        if verify:
            _verify_set(
                sigsets.indexed_attestation_set(preset, spec, state, a, resolver),
                "attester slashing attestation",
            )
    slashed_any = False
    current = get_current_epoch(preset, state)
    for index in sorted(
        set(a1.attesting_indices) & set(a2.attesting_indices)
    ):
        if is_slashable_validator(state.validators[index], current):
            slash_validator(preset, spec, state, fork, index)
            slashed_any = True
    _require(slashed_any, "attester slashing: no one slashed")


def process_attestation(
    preset: Preset, spec: ChainSpec, state, attestation, fork: str, verify: bool, resolver
) -> None:
    data = attestation.data
    current = get_current_epoch(preset, state)
    previous = get_previous_epoch(preset, state)
    _require(data.target.epoch in (previous, current), "attestation: bad target epoch")
    _require(
        data.target.epoch == compute_epoch_at_slot(preset, data.slot),
        "attestation: target/slot mismatch",
    )
    _require(
        data.slot + preset.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot,
        "attestation: too early",
    )
    # One-epoch inclusion window, shared by every pre-Deneb fork (Deneb
    # removes the upper bound; none of our forks reach it).
    _require(
        state.slot <= data.slot + preset.SLOTS_PER_EPOCH,
        "attestation: too late",
    )
    _require(
        data.index < get_committee_count_per_slot(preset, state, data.target.epoch),
        "attestation: bad committee index",
    )
    committee = get_beacon_committee(preset, state, data.slot, data.index)
    _require(
        len(attestation.aggregation_bits) == len(committee),
        "attestation: bits/committee length mismatch",
    )

    indexed = get_indexed_attestation(preset, state, attestation)
    _require(
        is_valid_indexed_attestation_structure(preset, indexed),
        "attestation: malformed indexed attestation",
    )
    if verify:
        _verify_set(
            sigsets.indexed_attestation_set(preset, spec, state, indexed, resolver),
            "attestation",
        )

    if fork == "phase0":
        t = types_for(preset)
        pending = t.PendingAttestation(
            aggregation_bits=attestation.aggregation_bits,
            data=data,
            inclusion_delay=state.slot - data.slot,
            proposer_index=get_beacon_proposer_index(preset, state),
        )
        if data.target.epoch == current:
            _require(
                data.source == state.current_justified_checkpoint,
                "attestation: wrong current source",
            )
            state.current_epoch_attestations = list(
                state.current_epoch_attestations
            ) + [pending]
        else:
            _require(
                data.source == state.previous_justified_checkpoint,
                "attestation: wrong previous source",
            )
            state.previous_epoch_attestations = list(
                state.previous_epoch_attestations
            ) + [pending]
        return

    # altair+: participation flags + proposer reward
    participation_flags = get_attestation_participation_flags(
        preset, state, data, state.slot - data.slot
    )
    if data.target.epoch == current:
        epoch_participation = state.current_epoch_participation
    else:
        epoch_participation = state.previous_epoch_participation
    total_active = get_total_active_balance(preset, state)
    base_reward_per_increment = (
        preset.EFFECTIVE_BALANCE_INCREMENT
        * preset.BASE_REWARD_FACTOR
        // integer_squareroot(total_active)
    )
    proposer_reward_numerator = 0
    for index in get_attesting_indices(
        preset, state, data, attestation.aggregation_bits
    ):
        eff = state.validators[index].effective_balance
        base_reward = (
            eff // preset.EFFECTIVE_BALANCE_INCREMENT * base_reward_per_increment
        )
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in participation_flags and not has_flag(
                epoch_participation[index], flag_index
            ):
                epoch_participation[index] = add_flag(
                    epoch_participation[index], flag_index
                )
                proposer_reward_numerator += base_reward * PARTICIPATION_FLAG_WEIGHTS[flag_index]
    proposer_reward_denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
        * WEIGHT_DENOMINATOR
        // PROPOSER_WEIGHT
    )
    increase_balance(
        state,
        get_beacon_proposer_index(preset, state),
        proposer_reward_numerator // proposer_reward_denominator,
    )


def get_attestation_participation_flags(
    preset: Preset, state, data, inclusion_delay: int
) -> list[int]:
    """Spec get_attestation_participation_flag_indices."""
    justified = (
        state.current_justified_checkpoint
        if data.target.epoch == get_current_epoch(preset, state)
        else state.previous_justified_checkpoint
    )
    is_matching_source = data.source == justified
    _require(is_matching_source, "attestation: source mismatch")
    is_matching_target = data.target.root == get_block_root(
        preset, state, data.target.epoch
    )
    is_matching_head = (
        is_matching_target
        and data.beacon_block_root == get_block_root_at_slot(preset, state, data.slot)
    )
    flags = []
    if is_matching_source and inclusion_delay <= integer_squareroot(
        preset.SLOTS_PER_EPOCH
    ):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= preset.SLOTS_PER_EPOCH:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == preset.MIN_ATTESTATION_INCLUSION_DELAY:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def process_deposit(preset: Preset, spec: ChainSpec, state, deposit, fork: str) -> None:
    t = types_for(preset)
    leaf = hash_tree_root(t.DepositData, deposit.data)
    _require(
        is_valid_merkle_branch(
            leaf,
            deposit.proof,
            preset.DEPOSIT_CONTRACT_TREE_DEPTH + 1,
            state.eth1_deposit_index,
            state.eth1_data.deposit_root,
        ),
        "deposit: bad merkle proof",
    )
    state.eth1_deposit_index += 1
    apply_deposit(preset, spec, state, deposit.data, fork)


def apply_deposit(preset: Preset, spec: ChainSpec, state, data, fork: str) -> None:
    pubkeys = [v.pubkey for v in state.validators]
    if data.pubkey not in pubkeys:
        if not sigsets.deposit_signature_is_valid(preset, spec, data):
            return  # invalid deposit signatures are skipped, not fatal
        t = types_for(preset)
        amount = data.amount
        eff = min(
            amount - amount % preset.EFFECTIVE_BALANCE_INCREMENT,
            preset.MAX_EFFECTIVE_BALANCE,
        )
        state.validators = list(state.validators) + [
            t.Validator(
                pubkey=data.pubkey,
                withdrawal_credentials=data.withdrawal_credentials,
                effective_balance=eff,
                slashed=False,
                activation_eligibility_epoch=FAR_FUTURE_EPOCH,
                activation_epoch=FAR_FUTURE_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        ]
        state.balances = list(state.balances) + [amount]
        if fork in ("altair", "bellatrix"):
            state.previous_epoch_participation = list(
                state.previous_epoch_participation
            ) + [0]
            state.current_epoch_participation = list(
                state.current_epoch_participation
            ) + [0]
            state.inactivity_scores = list(state.inactivity_scores) + [0]
    else:
        index = pubkeys.index(data.pubkey)
        increase_balance(state, index, data.amount)


def process_voluntary_exit(
    preset: Preset, spec: ChainSpec, state, signed_exit, verify: bool, resolver
) -> None:
    exit_msg = signed_exit.message
    _require(
        exit_msg.validator_index < len(state.validators), "exit: bad index"
    )
    v = state.validators[exit_msg.validator_index]
    current = get_current_epoch(preset, state)
    _require(is_active_validator(v, current), "exit: not active")
    _require(v.exit_epoch == FAR_FUTURE_EPOCH, "exit: already exiting")
    _require(current >= exit_msg.epoch, "exit: epoch in future")
    _require(
        current >= v.activation_epoch + spec.shard_committee_period,
        "exit: too young",
    )
    if verify:
        _verify_set(
            sigsets.exit_set(preset, spec, state, signed_exit, resolver),
            "voluntary exit",
        )
    initiate_validator_exit(preset, spec, state, exit_msg.validator_index)


def sync_aggregate_rewards(preset: Preset, state) -> tuple[int, int]:
    """Spec sync-aggregate reward pair: (participant_reward,
    proposer_reward per included bit) — shared by process_sync_aggregate
    and the Beacon API block-rewards route."""
    total_active_increments = (
        get_total_active_balance(preset, state) // preset.EFFECTIVE_BALANCE_INCREMENT
    )
    total_base_rewards = (
        preset.EFFECTIVE_BALANCE_INCREMENT
        * preset.BASE_REWARD_FACTOR
        // integer_squareroot(get_total_active_balance(preset, state))
        * total_active_increments
    )
    max_participant_rewards = (
        total_base_rewards
        * SYNC_REWARD_WEIGHT
        // WEIGHT_DENOMINATOR
        // preset.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // preset.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )
    return participant_reward, proposer_reward


def process_sync_aggregate(
    preset: Preset, spec: ChainSpec, state, slot: int, sync_aggregate, verify: bool,
    by_bytes,
) -> None:
    if verify:
        s = sigsets.sync_aggregate_set(
            preset, spec, state, slot, sync_aggregate, by_bytes
        )
        if s is not None:
            _verify_set(s, "sync aggregate")

    participant_reward, proposer_reward = sync_aggregate_rewards(preset, state)

    pubkey_to_index = {v.pubkey: i for i, v in enumerate(state.validators)}
    proposer = get_beacon_proposer_index(preset, state)
    for pk_bytes, bit in zip(
        state.current_sync_committee.pubkeys, sync_aggregate.sync_committee_bits
    ):
        index = pubkey_to_index[pk_bytes]
        if bit:
            increase_balance(state, index, participant_reward)
            increase_balance(state, proposer, proposer_reward)
        else:
            decrease_balance(state, index, participant_reward)


# ---------------------------------------------------------------------------
# Execution payload (bellatrix)
# ---------------------------------------------------------------------------

def is_merge_transition_complete(preset: Preset, state) -> bool:
    t = types_for(preset)
    return state.latest_execution_payload_header != t.ExecutionPayloadHeader()


def is_execution_enabled(preset: Preset, state, body) -> bool:
    t = types_for(preset)
    return (
        is_merge_transition_complete(preset, state)
        or body.execution_payload != t.ExecutionPayload()
    )


def process_execution_payload(
    preset: Preset, spec: ChainSpec, state, payload, execution_engine=None
) -> None:
    t = types_for(preset)
    if is_merge_transition_complete(preset, state):
        _require(
            payload.parent_hash == state.latest_execution_payload_header.block_hash,
            "payload: parent hash mismatch",
        )
    _require(
        payload.prev_randao
        == get_randao_mix(preset, state, get_current_epoch(preset, state)),
        "payload: prev_randao mismatch",
    )
    _require(
        payload.timestamp == compute_timestamp_at_slot(preset, spec, state, state.slot),
        "payload: bad timestamp",
    )
    if execution_engine is not None:
        _require(
            execution_engine.notify_new_payload(payload), "payload: EL rejected"
        )
    state.latest_execution_payload_header = t.ExecutionPayloadHeader(
        parent_hash=payload.parent_hash,
        fee_recipient=payload.fee_recipient,
        state_root=payload.state_root,
        receipts_root=payload.receipts_root,
        logs_bloom=payload.logs_bloom,
        prev_randao=payload.prev_randao,
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=payload.block_hash,
        transactions_root=hash_tree_root(
            t.ExecutionPayload.fields[-1][1], payload.transactions
        ),
    )


def compute_timestamp_at_slot(preset: Preset, spec: ChainSpec, state, slot: int) -> int:
    return state.genesis_time + (slot - 0) * spec.seconds_per_slot
