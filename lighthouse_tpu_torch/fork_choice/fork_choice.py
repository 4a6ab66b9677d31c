"""Spec fork choice over the proto-array (reference:
``consensus/fork_choice/src/fork_choice.rs``: ``on_block`` :668,
``on_attestation`` :1083, ``get_head`` :511, ``on_attester_slashing``
:1136; store trait ``fork_choice_store.rs``).

Implements the v1.2-era rules the reference ships: LMD-GHOST votes with
FFG filtering, best-justified deferral to epoch boundaries, proposer
score boost, equivocation removal, and optimistic execution statuses.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional

from ..types.chain_spec import ChainSpec
from ..types.preset import Preset
from .proto_array import ExecutionStatus, ProtoArrayForkChoice


class ForkChoiceError(ValueError):
    pass


@dataclass
class ForkChoiceStore:
    """The mutable store (reference ``ForkChoiceStore`` trait): slot clock
    + checkpoints + justified balances, owned by the chain."""

    current_slot: int
    justified_checkpoint: tuple[int, bytes]
    finalized_checkpoint: tuple[int, bytes]
    best_justified_checkpoint: tuple[int, bytes]
    justified_balances: list[int] = dc_field(default_factory=list)
    proposer_boost_root: bytes = bytes(32)
    equivocating_indices: set[int] = dc_field(default_factory=set)


@dataclass
class QueuedAttestation:
    slot: int
    validator_indices: list[int]
    block_root: bytes
    target_epoch: int


class ForkChoice:
    def __init__(
        self,
        preset: Preset,
        spec: ChainSpec,
        genesis_or_anchor_slot: int,
        anchor_root: bytes,
        anchor_justified: tuple[int, bytes],
        anchor_finalized: tuple[int, bytes],
        justified_balances: list[int],
        execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT,
    ):
        self.preset = preset
        self.spec = spec
        self.proto = ProtoArrayForkChoice(
            genesis_or_anchor_slot,
            anchor_root,
            anchor_justified,
            anchor_finalized,
            execution_status,
        )
        self.store = ForkChoiceStore(
            current_slot=genesis_or_anchor_slot,
            justified_checkpoint=anchor_justified,
            finalized_checkpoint=anchor_finalized,
            best_justified_checkpoint=anchor_justified,
            justified_balances=list(justified_balances),
        )
        self.queued_attestations: list[QueuedAttestation] = []

    # -- clock -----------------------------------------------------------

    def on_tick(self, slot: int) -> None:
        """Per-slot tick: dequeue one-slot-delayed attestations, reset the
        proposer boost, and at epoch boundaries adopt best-justified."""
        P = self.preset
        while self.store.current_slot < slot:
            self.store.current_slot += 1
            self.store.proposer_boost_root = bytes(32)
            if self.store.current_slot % P.SLOTS_PER_EPOCH == 0:
                if (
                    self.store.best_justified_checkpoint[0]
                    > self.store.justified_checkpoint[0]
                ):
                    self.store.justified_checkpoint = (
                        self.store.best_justified_checkpoint
                    )
        self._process_queued_attestations()

    def _process_queued_attestations(self) -> None:
        remaining = []
        for qa in self.queued_attestations:
            if qa.slot < self.store.current_slot:
                for v in qa.validator_indices:
                    self.proto.process_attestation(v, qa.block_root, qa.target_epoch)
            else:
                remaining.append(qa)
        self.queued_attestations = remaining

    # -- blocks ----------------------------------------------------------

    def on_block(
        self,
        current_slot: int,
        block,
        block_root: bytes,
        state,
        execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT,
    ) -> None:
        """Register an imported block (caller has fully verified it)."""
        self.on_tick(max(current_slot, self.store.current_slot))
        if block.slot > current_slot:
            raise ForkChoiceError("block from the future")
        if not self.proto.contains(block.parent_root):
            raise ForkChoiceError("unknown parent in fork choice")
        fin_epoch, fin_root = self.store.finalized_checkpoint
        if fin_root != bytes(32):
            fin_slot = fin_epoch * self.preset.SLOTS_PER_EPOCH
            anc = self.proto.ancestor_at_slot(block.parent_root, fin_slot)
            if anc is not None and fin_epoch > 0 and anc != fin_root:
                raise ForkChoiceError("block does not descend from finalized root")

        state_justified = (
            state.current_justified_checkpoint.epoch,
            state.current_justified_checkpoint.root,
        )
        state_finalized = (
            state.finalized_checkpoint.epoch,
            state.finalized_checkpoint.root,
        )
        if state_justified[0] > self.store.best_justified_checkpoint[0]:
            self.store.best_justified_checkpoint = state_justified
        if self._should_update_justified(block, state_justified):
            self._update_justified(state_justified, state)
        if state_finalized[0] > self.store.finalized_checkpoint[0]:
            self.store.finalized_checkpoint = state_finalized
            if state_justified[0] > self.store.justified_checkpoint[0]:
                self._update_justified(state_justified, state)

        # proposer boost for timely blocks (spec: before attestation cutoff;
        # the caller passes current_slot == block.slot only when timely)
        if block.slot == current_slot:
            self.store.proposer_boost_root = block_root

        self.proto.on_block(
            block.slot,
            block_root,
            block.parent_root,
            state_justified,
            state_finalized,
            execution_status,
        )

    def _should_update_justified(self, block, new_justified) -> bool:
        P = self.preset
        if new_justified[0] <= self.store.justified_checkpoint[0]:
            return False
        if (
            self.store.current_slot % P.SLOTS_PER_EPOCH
            < P.SAFE_SLOTS_TO_UPDATE_JUSTIFIED
        ):
            return True
        # mid-epoch: only update if new justified descends from the old one
        just_slot = self.store.justified_checkpoint[0] * P.SLOTS_PER_EPOCH
        anc = self.proto.ancestor_at_slot(new_justified[1], just_slot)
        return anc == self.store.justified_checkpoint[1]

    def _update_justified(self, checkpoint, state) -> None:
        self.store.justified_checkpoint = checkpoint
        self.store.justified_balances = [
            v.effective_balance if _active(v, checkpoint[0]) else 0
            for v in state.validators
        ]

    # -- attestations ----------------------------------------------------

    def on_attestation(
        self, current_slot: int, indexed_attestation, is_from_block: bool = False
    ) -> None:
        data = indexed_attestation.data
        P = self.preset
        target = data.target
        if not is_from_block:
            cur_epoch = current_slot // P.SLOTS_PER_EPOCH
            if target.epoch not in (cur_epoch, cur_epoch - 1):
                raise ForkChoiceError("attestation target epoch out of range")
        if target.epoch != data.slot // P.SLOTS_PER_EPOCH:
            raise ForkChoiceError("attestation target/slot mismatch")
        if not self.proto.contains(target.root):
            raise ForkChoiceError("unknown attestation target block")
        if not self.proto.contains(data.beacon_block_root):
            raise ForkChoiceError("unknown attestation head block")
        if self.proto.get_block_slot(data.beacon_block_root) > data.slot:
            raise ForkChoiceError("attestation to a future block")
        # The LMD vote must be consistent with the FFG target: the head block
        # must descend from (or be) the claimed target at the target's start
        # slot, else the attestation moves LMD weight for an impossible vote.
        target_start = target.epoch * P.SLOTS_PER_EPOCH
        if (
            self.proto.ancestor_at_slot(data.beacon_block_root, target_start)
            != target.root
        ):
            raise ForkChoiceError("LMD vote inconsistent with FFG target")
        # LMD votes take effect one slot after creation
        self.queued_attestations.append(
            QueuedAttestation(
                slot=data.slot,
                validator_indices=list(indexed_attestation.attesting_indices),
                block_root=data.beacon_block_root,
                target_epoch=target.epoch,
            )
        )
        self._process_queued_attestations()

    def on_attester_slashing(self, indexed_1, indexed_2) -> None:
        both = set(indexed_1.attesting_indices) & set(indexed_2.attesting_indices)
        for v in both:
            self.store.equivocating_indices.add(v)
            self.proto.process_equivocation(v)

    # -- head ------------------------------------------------------------

    def get_head(self) -> bytes:
        boost_amount = 0
        if (
            self.store.proposer_boost_root != bytes(32)
            and self.spec.proposer_score_boost
        ):
            total = sum(self.store.justified_balances)
            committee_weight = total // self.preset.SLOTS_PER_EPOCH
            boost_amount = committee_weight * self.spec.proposer_score_boost // 100
        return self.proto.find_head(
            self.store.justified_checkpoint,
            self.store.finalized_checkpoint,
            self.store.justified_balances,
            self.store.proposer_boost_root,
            boost_amount,
        )

    # -- execution verdicts ---------------------------------------------

    def on_valid_execution_payload(self, root: bytes) -> None:
        self.proto.on_execution_status(root, ExecutionStatus.VALID)

    def on_invalid_execution_payload(self, root: bytes) -> None:
        self.proto.on_execution_status(root, ExecutionStatus.INVALID)

    # -- pruning ---------------------------------------------------------

    def prune(self) -> None:
        fin_root = self.store.finalized_checkpoint[1]
        if fin_root != bytes(32) and self.proto.contains(fin_root):
            self.proto.prune(fin_root)


def _active(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch
