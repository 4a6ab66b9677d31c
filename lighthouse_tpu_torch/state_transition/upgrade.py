"""Fork upgrades phase0 -> altair -> bellatrix (spec upgrade functions;
reference: ``consensus/state_processing/src/upgrade/``)."""

from __future__ import annotations

from ..types.chain_spec import ChainSpec
from ..types.containers import types_for
from ..types.preset import Preset
from .helpers import get_current_epoch, get_attesting_indices
from .mutators import add_flag
from .block import get_attestation_participation_flags, BlockProcessingError


def maybe_upgrade_state(preset: Preset, spec: ChainSpec, state):
    """At an epoch boundary, replace the state with its next-fork variant
    when the new epoch crosses a scheduled fork."""
    if state.slot % preset.SLOTS_PER_EPOCH != 0:
        return state
    epoch = get_current_epoch(preset, state)
    from .epoch import fork_of

    fork = fork_of(state)
    if (
        fork == "phase0"
        and spec.altair_fork_epoch is not None
        and epoch == spec.altair_fork_epoch
    ):
        state = upgrade_to_altair(preset, spec, state)
        fork = "altair"
    if (
        fork == "altair"
        and spec.bellatrix_fork_epoch is not None
        and epoch == spec.bellatrix_fork_epoch
    ):
        state = upgrade_to_bellatrix(preset, spec, state)
    return state


def _translate_participation(preset: Preset, state, pending_attestations) -> None:
    """Replay phase0 pending attestations into altair participation flags
    (spec translate_participation)."""
    for a in pending_attestations:
        try:
            flags = get_attestation_participation_flags(
                preset, state, a.data, a.inclusion_delay
            )
        except BlockProcessingError:
            continue
        for index in get_attesting_indices(
            preset, state, a.data, a.aggregation_bits
        ):
            for f in flags:
                state.previous_epoch_participation[index] = add_flag(
                    state.previous_epoch_participation[index], f
                )


def upgrade_to_altair(preset: Preset, spec: ChainSpec, pre):
    from .epoch import get_next_sync_committee

    t = types_for(preset)
    epoch = get_current_epoch(preset, pre)
    n = len(pre.validators)
    post = t.state["altair"](
        genesis_time=pre.genesis_time,
        genesis_validators_root=pre.genesis_validators_root,
        slot=pre.slot,
        fork=t.Fork(
            previous_version=pre.fork.current_version,
            current_version=spec.altair_fork_version,
            epoch=epoch,
        ),
        latest_block_header=pre.latest_block_header,
        block_roots=pre.block_roots,
        state_roots=pre.state_roots,
        historical_roots=pre.historical_roots,
        eth1_data=pre.eth1_data,
        eth1_data_votes=pre.eth1_data_votes,
        eth1_deposit_index=pre.eth1_deposit_index,
        validators=pre.validators,
        balances=pre.balances,
        randao_mixes=pre.randao_mixes,
        slashings=pre.slashings,
        previous_epoch_participation=[0] * n,
        current_epoch_participation=[0] * n,
        justification_bits=pre.justification_bits,
        previous_justified_checkpoint=pre.previous_justified_checkpoint,
        current_justified_checkpoint=pre.current_justified_checkpoint,
        finalized_checkpoint=pre.finalized_checkpoint,
        inactivity_scores=[0] * n,
    )
    _translate_participation(preset, post, pre.previous_epoch_attestations)
    sync = get_next_sync_committee(preset, post)
    post.current_sync_committee = sync
    post.next_sync_committee = get_next_sync_committee(preset, post)
    return post


def upgrade_to_bellatrix(preset: Preset, spec: ChainSpec, pre):
    t = types_for(preset)
    epoch = get_current_epoch(preset, pre)
    post = t.state["bellatrix"](
        **{
            name: getattr(pre, name)
            for name, _ in t.state["altair"].fields
            if name != "fork"
        },
        fork=t.Fork(
            previous_version=pre.fork.current_version,
            current_version=spec.bellatrix_fork_version,
            epoch=epoch,
        ),
        latest_execution_payload_header=t.ExecutionPayloadHeader(),
    )
    return post
