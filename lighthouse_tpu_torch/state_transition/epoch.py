"""Per-epoch processing, phase0 and altair/bellatrix variants (spec
``process_epoch``; reference: ``consensus/state_processing/src/
per_epoch_processing/`` base + altair modules).

Two tiers share this module's orchestration: the scalar spec loops below
(the readable oracle, and the big-int fallback) and the columnar numpy
passes over the state views in ``state/`` (the default — vector ops over
the whole registry, the layout a device tier consumes). ``process_epoch``
dispatches; ``tests/test_epoch_columnar.py`` pins the two bit-identical.
"""

from __future__ import annotations

from ..ssz import hash_tree_root
from ..types.chain_spec import ChainSpec, FAR_FUTURE_EPOCH
from ..types.containers import types_for
from ..types.preset import Preset
from .helpers import (
    compute_activation_exit_epoch,
    decrease_balance,
    get_active_validator_indices,
    get_attesting_indices,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_previous_epoch,
    get_randao_mix,
    get_total_active_balance,
    get_total_balance,
    get_validator_churn_limit,
    increase_balance,
    integer_squareroot,
    is_active_validator,
    is_eligible_for_activation,
    is_eligible_for_activation_queue,
)
from .mutators import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    has_flag,
    initiate_validator_exit,
)

BASE_REWARDS_PER_EPOCH = 4
GENESIS_EPOCH = 0


def fork_of(state) -> str:
    if hasattr(state, "latest_execution_payload_header"):
        return "bellatrix"
    if hasattr(state, "current_epoch_participation"):
        return "altair"
    return "phase0"


def process_epoch(preset: Preset, spec: ChainSpec, state) -> None:
    """Dispatch: columnar (numpy state views, ``state/epoch.py``) by
    default, scalar spec loops on guard fallback or when
    ``LIGHTHOUSE_TPU_EPOCH=scalar`` pins the oracle path."""
    import os

    mode = os.environ.get("LIGHTHOUSE_TPU_EPOCH", "auto")
    if mode != "scalar":
        from .state import Fallback, process_epoch_columnar

        try:
            process_epoch_columnar(preset, spec, state)
            return
        except Fallback:
            if mode == "columnar":
                raise
            # guards fire before any mutation: scalar rerun is safe

    process_epoch_scalar(preset, spec, state)


def process_epoch_scalar(preset: Preset, spec: ChainSpec, state) -> None:
    fork = fork_of(state)
    if fork == "phase0":
        process_justification_and_finalization_phase0(preset, state)
        process_rewards_and_penalties_phase0(preset, spec, state)
    else:
        process_justification_and_finalization_altair(preset, state)
        process_inactivity_updates(preset, spec, state)
        process_rewards_and_penalties_altair(preset, spec, state)
    process_registry_updates(preset, spec, state)
    process_slashings(preset, state, fork)
    process_eth1_data_reset(preset, state)
    process_effective_balance_updates(preset, state)
    process_slashings_reset(preset, state)
    process_randao_mixes_reset(preset, state)
    process_historical_roots_update(preset, state)
    if fork == "phase0":
        state.previous_epoch_attestations = state.current_epoch_attestations
        state.current_epoch_attestations = []
    else:
        state.previous_epoch_participation = state.current_epoch_participation
        state.current_epoch_participation = [0] * len(state.validators)
        process_sync_committee_updates(preset, state)


# ---------------------------------------------------------------------------
# phase0: pending-attestation accounting
# ---------------------------------------------------------------------------

def _matching_attestations(preset: Preset, state, epoch: int):
    current = get_current_epoch(preset, state)
    assert epoch in (current, get_previous_epoch(preset, state))
    return (
        state.current_epoch_attestations
        if epoch == current
        else state.previous_epoch_attestations
    )


def _matching_target_attestations(preset: Preset, state, epoch: int):
    root = get_block_root(preset, state, epoch)
    return [
        a for a in _matching_attestations(preset, state, epoch)
        if a.data.target.root == root
    ]


def _matching_head_attestations(preset: Preset, state, epoch: int):
    return [
        a
        for a in _matching_target_attestations(preset, state, epoch)
        if a.data.beacon_block_root
        == get_block_root_at_slot(preset, state, a.data.slot)
    ]


def _unslashed_attesting_indices(preset: Preset, state, attestations):
    out = set()
    for a in attestations:
        out |= set(
            get_attesting_indices(preset, state, a.data, a.aggregation_bits)
        )
    return sorted(i for i in out if not state.validators[i].slashed)


def _attesting_balance(preset: Preset, state, attestations) -> int:
    return get_total_balance(
        preset, state, _unslashed_attesting_indices(preset, state, attestations)
    )


def process_justification_and_finalization_phase0(preset: Preset, state) -> None:
    if get_current_epoch(preset, state) <= GENESIS_EPOCH + 1:
        return
    previous = get_previous_epoch(preset, state)
    current = get_current_epoch(preset, state)
    prev_bal = _attesting_balance(
        preset, state, _matching_target_attestations(preset, state, previous)
    )
    cur_bal = _attesting_balance(
        preset, state, _matching_target_attestations(preset, state, current)
    )
    _weigh_justification_and_finalization(preset, state, prev_bal, cur_bal)


def _weigh_justification_and_finalization(
    preset: Preset, state, prev_target_balance: int, cur_target_balance: int
) -> None:
    t = types_for(preset)
    previous = get_previous_epoch(preset, state)
    current = get_current_epoch(preset, state)
    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint
    total = get_total_active_balance(preset, state)

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[: preset.JUSTIFICATION_BITS_LENGTH - 1]
    if prev_target_balance * 3 >= total * 2:
        state.current_justified_checkpoint = t.Checkpoint(
            epoch=previous, root=get_block_root(preset, state, previous)
        )
        bits[1] = True
    if cur_target_balance * 3 >= total * 2:
        state.current_justified_checkpoint = t.Checkpoint(
            epoch=current, root=get_block_root(preset, state, current)
        )
        bits[0] = True
    state.justification_bits = bits

    # finalization rules
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current:
        state.finalized_checkpoint = old_current_justified


def _base_reward_phase0(preset: Preset, state, total_balance: int, index: int) -> int:
    eff = state.validators[index].effective_balance
    return (
        eff
        * preset.BASE_REWARD_FACTOR
        // integer_squareroot(total_balance)
        // BASE_REWARDS_PER_EPOCH
    )


def _is_in_inactivity_leak(preset: Preset, state) -> bool:
    return _finality_delay(preset, state) > preset.MIN_EPOCHS_TO_INACTIVITY_PENALTY


def _finality_delay(preset: Preset, state) -> int:
    return get_previous_epoch(preset, state) - state.finalized_checkpoint.epoch


def _eligible_indices(preset: Preset, state) -> list[int]:
    previous = get_previous_epoch(preset, state)
    return [
        i
        for i, v in enumerate(state.validators)
        if is_active_validator(v, previous)
        or (v.slashed and previous + 1 < v.withdrawable_epoch)
    ]


def process_rewards_and_penalties_phase0(
    preset: Preset, spec: ChainSpec, state
) -> None:
    if get_current_epoch(preset, state) == GENESIS_EPOCH:
        return
    rewards, penalties = get_attestation_deltas(preset, state)
    for i in range(len(state.validators)):
        increase_balance(state, i, rewards[i])
        decrease_balance(state, i, penalties[i])


def get_attestation_deltas(preset: Preset, state):
    """Spec get_attestation_deltas (source/target/head + inclusion delay +
    inactivity)."""
    total = get_total_active_balance(preset, state)
    previous = get_previous_epoch(preset, state)
    rewards = [0] * len(state.validators)
    penalties = [0] * len(state.validators)
    eligible = _eligible_indices(preset, state)

    matching_source = _matching_attestations(preset, state, previous)
    matching_target = _matching_target_attestations(preset, state, previous)
    matching_head = _matching_head_attestations(preset, state, previous)

    in_leak = _is_in_inactivity_leak(preset, state)
    increment = preset.EFFECTIVE_BALANCE_INCREMENT

    for attestations, _name in (
        (matching_source, "source"),
        (matching_target, "target"),
        (matching_head, "head"),
    ):
        unslashed = set(_unslashed_attesting_indices(preset, state, attestations))
        attesting_balance = get_total_balance(preset, state, unslashed)
        for i in eligible:
            base = _base_reward_phase0(preset, state, total, i)
            if i in unslashed:
                if in_leak:
                    rewards[i] += base
                else:
                    reward_numerator = base * (attesting_balance // increment)
                    rewards[i] += reward_numerator // (total // increment)
            else:
                penalties[i] += base

    # inclusion delay (source attesters only)
    source_unslashed = set(
        _unslashed_attesting_indices(preset, state, matching_source)
    )
    for i in source_unslashed:
        best = None
        for a in matching_source:
            if i in get_attesting_indices(preset, state, a.data, a.aggregation_bits):
                if best is None or a.inclusion_delay < best.inclusion_delay:
                    best = a
        base = _base_reward_phase0(preset, state, total, i)
        proposer_reward = base // preset.PROPOSER_REWARD_QUOTIENT
        rewards[best.proposer_index] += proposer_reward
        max_attester_reward = base - proposer_reward
        rewards[i] += max_attester_reward // best.inclusion_delay

    # inactivity penalty
    if in_leak:
        target_unslashed = set(
            _unslashed_attesting_indices(preset, state, matching_target)
        )
        delay = _finality_delay(preset, state)
        for i in eligible:
            base = _base_reward_phase0(preset, state, total, i)
            penalties[i] += BASE_REWARDS_PER_EPOCH * base - (
                base // preset.PROPOSER_REWARD_QUOTIENT
            )
            if i not in target_unslashed:
                eff = state.validators[i].effective_balance
                penalties[i] += eff * delay // preset.INACTIVITY_PENALTY_QUOTIENT
    return rewards, penalties


# ---------------------------------------------------------------------------
# altair: participation-flag accounting
# ---------------------------------------------------------------------------

def get_unslashed_participating_indices(
    preset: Preset, state, flag_index: int, epoch: int
) -> set[int]:
    current = get_current_epoch(preset, state)
    assert epoch in (current, get_previous_epoch(preset, state))
    participation = (
        state.current_epoch_participation
        if epoch == current
        else state.previous_epoch_participation
    )
    return {
        i
        for i in get_active_validator_indices(state, epoch)
        if has_flag(participation[i], flag_index)
        and not state.validators[i].slashed
    }


def process_justification_and_finalization_altair(preset: Preset, state) -> None:
    if get_current_epoch(preset, state) <= GENESIS_EPOCH + 1:
        return
    prev_idx = get_unslashed_participating_indices(
        preset, state, TIMELY_TARGET_FLAG_INDEX, get_previous_epoch(preset, state)
    )
    cur_idx = get_unslashed_participating_indices(
        preset, state, TIMELY_TARGET_FLAG_INDEX, get_current_epoch(preset, state)
    )
    _weigh_justification_and_finalization(
        preset,
        state,
        get_total_balance(preset, state, prev_idx),
        get_total_balance(preset, state, cur_idx),
    )


def process_inactivity_updates(preset: Preset, spec: ChainSpec, state) -> None:
    if get_current_epoch(preset, state) == GENESIS_EPOCH:
        return
    prev_target = get_unslashed_participating_indices(
        preset, state, TIMELY_TARGET_FLAG_INDEX, get_previous_epoch(preset, state)
    )
    in_leak = _is_in_inactivity_leak(preset, state)
    for i in _eligible_indices(preset, state):
        if i in prev_target:
            state.inactivity_scores[i] -= min(1, state.inactivity_scores[i])
        else:
            state.inactivity_scores[i] += spec.inactivity_score_bias
        if not in_leak:
            state.inactivity_scores[i] -= min(
                spec.inactivity_score_recovery_rate, state.inactivity_scores[i]
            )


def _base_reward_altair(preset: Preset, state, total: int, index: int) -> int:
    increment = preset.EFFECTIVE_BALANCE_INCREMENT
    base_per_increment = (
        increment * preset.BASE_REWARD_FACTOR // integer_squareroot(total)
    )
    return (
        state.validators[index].effective_balance // increment * base_per_increment
    )


def process_rewards_and_penalties_altair(
    preset: Preset, spec: ChainSpec, state
) -> None:
    if get_current_epoch(preset, state) == GENESIS_EPOCH:
        return
    fork = fork_of(state)
    total = get_total_active_balance(preset, state)
    previous = get_previous_epoch(preset, state)
    increment = preset.EFFECTIVE_BALANCE_INCREMENT
    in_leak = _is_in_inactivity_leak(preset, state)
    eligible = _eligible_indices(preset, state)

    rewards = [0] * len(state.validators)
    penalties = [0] * len(state.validators)

    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        unslashed = get_unslashed_participating_indices(
            preset, state, flag_index, previous
        )
        unslashed_balance = get_total_balance(preset, state, unslashed)
        unslashed_increments = unslashed_balance // increment
        active_increments = total // increment
        for i in eligible:
            base = _base_reward_altair(preset, state, total, i)
            if i in unslashed:
                if not in_leak:
                    numerator = base * weight * unslashed_increments
                    rewards[i] += numerator // (active_increments * WEIGHT_DENOMINATOR)
            elif flag_index != TIMELY_HEAD_FLAG_INDEX:
                penalties[i] += base * weight // WEIGHT_DENOMINATOR

    # inactivity penalties (always applied, scaled by score)
    quotient = (
        preset.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
        if fork == "altair"
        else preset.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
    )
    prev_target = get_unslashed_participating_indices(
        preset, state, TIMELY_TARGET_FLAG_INDEX, previous
    )
    for i in eligible:
        if i not in prev_target:
            penalty_numerator = (
                state.validators[i].effective_balance * state.inactivity_scores[i]
            )
            penalties[i] += penalty_numerator // (
                spec.inactivity_score_bias * quotient
            )

    for i in range(len(state.validators)):
        increase_balance(state, i, rewards[i])
        decrease_balance(state, i, penalties[i])


# ---------------------------------------------------------------------------
# shared tail phases
# ---------------------------------------------------------------------------

def process_registry_updates(preset: Preset, spec: ChainSpec, state) -> None:
    current = get_current_epoch(preset, state)
    for i, v in enumerate(state.validators):
        if is_eligible_for_activation_queue(preset, v):
            v.activation_eligibility_epoch = current + 1
        if is_active_validator(v, current) and v.effective_balance <= spec.ejection_balance:
            initiate_validator_exit(preset, spec, state, i)

    queue = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if is_eligible_for_activation(state, v)
        ),
        key=lambda i: (state.validators[i].activation_eligibility_epoch, i),
    )
    for i in queue[: get_validator_churn_limit(preset, spec, state)]:
        state.validators[i].activation_epoch = compute_activation_exit_epoch(
            preset, current
        )


def process_slashings(preset: Preset, state, fork: str) -> None:
    epoch = get_current_epoch(preset, state)
    total_balance = get_total_active_balance(preset, state)
    mult = {
        "phase0": preset.PROPORTIONAL_SLASHING_MULTIPLIER,
        "altair": preset.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR,
        "bellatrix": preset.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX,
    }[fork]
    adjusted = min(sum(state.slashings) * mult, total_balance)
    increment = preset.EFFECTIVE_BALANCE_INCREMENT
    for i, v in enumerate(state.validators):
        if (
            v.slashed
            and epoch + preset.EPOCHS_PER_SLASHINGS_VECTOR // 2 == v.withdrawable_epoch
        ):
            penalty_numerator = v.effective_balance // increment * adjusted
            decrease_balance(state, i, penalty_numerator // total_balance * increment)


def process_eth1_data_reset(preset: Preset, state) -> None:
    next_epoch = get_current_epoch(preset, state) + 1
    if next_epoch % preset.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(preset: Preset, state) -> None:
    increment = preset.EFFECTIVE_BALANCE_INCREMENT
    hysteresis_increment = increment // preset.HYSTERESIS_QUOTIENT
    down = hysteresis_increment * preset.HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis_increment * preset.HYSTERESIS_UPWARD_MULTIPLIER
    for i, v in enumerate(state.validators):
        balance = state.balances[i]
        if (
            balance + down < v.effective_balance
            or v.effective_balance + up < balance
        ):
            v.effective_balance = min(
                balance - balance % increment, preset.MAX_EFFECTIVE_BALANCE
            )


def process_slashings_reset(preset: Preset, state) -> None:
    next_epoch = get_current_epoch(preset, state) + 1
    state.slashings[next_epoch % preset.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(preset: Preset, state) -> None:
    current = get_current_epoch(preset, state)
    next_epoch = current + 1
    state.randao_mixes[next_epoch % preset.EPOCHS_PER_HISTORICAL_VECTOR] = (
        get_randao_mix(preset, state, current)
    )


def process_historical_roots_update(preset: Preset, state) -> None:
    next_epoch = get_current_epoch(preset, state) + 1
    period = preset.SLOTS_PER_HISTORICAL_ROOT // preset.SLOTS_PER_EPOCH
    if next_epoch % period == 0:
        t = types_for(preset)
        batch = t.HistoricalBatch(
            block_roots=list(state.block_roots), state_roots=list(state.state_roots)
        )
        state.historical_roots = list(state.historical_roots) + [
            hash_tree_root(batch)
        ]


def process_sync_committee_updates(preset: Preset, state) -> None:
    next_epoch = get_current_epoch(preset, state) + 1
    if next_epoch % preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(preset, state)


# ---------------------------------------------------------------------------
# sync committee selection
# ---------------------------------------------------------------------------

def get_next_sync_committee_indices(preset: Preset, state) -> list[int]:
    """Spec balance-weighted sampling over the shuffled active set.

    The whole permutation is materialized once with the vectorized
    ``shuffle_list`` (identical output to per-index
    ``compute_shuffled_index`` — pinned by tests), so the rejection loop
    costs one SHA-256 per 32 candidates instead of ~SHUFFLE_ROUND_COUNT
    hashes per candidate — the difference between milliseconds and
    minutes at mainnet validator counts."""
    import hashlib

    from .helpers import get_seed
    from .shuffle import shuffle_list

    DOMAIN_SYNC_COMMITTEE = 7
    epoch = get_current_epoch(preset, state) + 1
    active = get_active_validator_indices(state, epoch)
    count = len(active)
    seed = get_seed(preset, state, epoch, DOMAIN_SYNC_COMMITTEE)
    perm = shuffle_list(count, seed, preset.SHUFFLE_ROUND_COUNT)
    indices = []
    i = 0
    block = b""
    while len(indices) < preset.SYNC_COMMITTEE_SIZE:
        if i % 32 == 0:
            block = hashlib.sha256(
                seed + (i // 32).to_bytes(8, "little")
            ).digest()
        candidate = active[int(perm[i % count])]
        random_byte = block[i % 32]
        eff = state.validators[candidate].effective_balance
        if eff * 255 >= preset.MAX_EFFECTIVE_BALANCE * random_byte:
            indices.append(candidate)
        i += 1
    return indices


def get_next_sync_committee(preset: Preset, state):
    from ..crypto import bls

    t = types_for(preset)
    indices = get_next_sync_committee_indices(preset, state)
    pubkeys = [state.validators[i].pubkey for i in indices]
    # aggregate pubkey = sum of the G1 points
    pts = [bls.PublicKey.deserialize(b).point for b in pubkeys]
    acc = pts[0]
    for p in pts[1:]:
        acc = acc + p
    aggregate = bls.PublicKey(acc).serialize()
    return t.SyncCommittee(pubkeys=list(pubkeys), aggregate_pubkey=aggregate)
