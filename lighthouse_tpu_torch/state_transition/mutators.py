"""State mutators shared by block and epoch processing (spec
``initiate_validator_exit`` / ``slash_validator``; reference:
``consensus/state_processing/src/common/``)."""

from __future__ import annotations

from ..types.chain_spec import ChainSpec, FAR_FUTURE_EPOCH
from ..types.preset import Preset
from .helpers import (
    compute_activation_exit_epoch,
    decrease_balance,
    get_beacon_proposer_index,
    get_current_epoch,
    get_validator_churn_limit,
    increase_balance,
)

# Altair participation flag indices / weights (public spec constants).
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64
PARTICIPATION_FLAG_WEIGHTS = (
    TIMELY_SOURCE_WEIGHT,
    TIMELY_TARGET_WEIGHT,
    TIMELY_HEAD_WEIGHT,
)


def add_flag(flags: int, index: int) -> int:
    return flags | (1 << index)


def has_flag(flags: int, index: int) -> bool:
    return bool(flags & (1 << index))


def initiate_validator_exit(preset: Preset, spec: ChainSpec, state, index: int) -> None:
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_epochs = [
        w.exit_epoch for w in state.validators if w.exit_epoch != FAR_FUTURE_EPOCH
    ]
    exit_queue_epoch = max(
        exit_epochs
        + [compute_activation_exit_epoch(preset, get_current_epoch(preset, state))]
    )
    churn = sum(1 for w in state.validators if w.exit_epoch == exit_queue_epoch)
    if churn >= get_validator_churn_limit(preset, spec, state):
        exit_queue_epoch += 1
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = exit_queue_epoch + spec.min_validator_withdrawability_delay


def slash_validator(
    preset: Preset,
    spec: ChainSpec,
    state,
    fork: str,
    slashed_index: int,
    whistleblower_index: int | None = None,
) -> None:
    epoch = get_current_epoch(preset, state)
    initiate_validator_exit(preset, spec, state, slashed_index)
    v = state.validators[slashed_index]
    v.slashed = True
    v.withdrawable_epoch = max(
        v.withdrawable_epoch, epoch + preset.EPOCHS_PER_SLASHINGS_VECTOR
    )
    state.slashings[epoch % preset.EPOCHS_PER_SLASHINGS_VECTOR] += v.effective_balance
    if fork == "phase0":
        min_q = preset.MIN_SLASHING_PENALTY_QUOTIENT
    elif fork == "altair":
        min_q = preset.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR
    else:
        min_q = preset.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX
    decrease_balance(state, slashed_index, v.effective_balance // min_q)

    proposer_index = get_beacon_proposer_index(preset, state)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = v.effective_balance // preset.WHISTLEBLOWER_REWARD_QUOTIENT
    if fork == "phase0":
        proposer_reward = whistleblower_reward // preset.PROPOSER_REWARD_QUOTIENT
    else:
        proposer_reward = whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)
