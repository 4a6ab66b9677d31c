"""Block import pipeline types (reference:
``beacon_node/beacon_chain/src/block_verification.rs:21-44,590-660``):

    gossip bytes -> GossipVerifiedBlock  (cheap checks + ONE proposal sig)
                 -> SignatureVerifiedBlock (ALL block sigs, one batch)
                 -> ExecutionPendingBlock  (payload sent to the EL)
                 -> imported (fork choice + store)

Each stage owns the evidence of the previous one; ``BeaconChain.process_block``
drives the chain of custody.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field as dc_field

from ..ssz import hash_tree_root
from ..state_transition import (
    BlockSignatureAccumulator,
    partial_state_advance,
    get_beacon_proposer_index,
)
from ..state_transition.epoch import fork_of
from ..state_transition.signature_sets import block_proposal_set
from ..utils import flight_recorder, metrics, tracing
from ..verification_service import backend_verify_now

_STAGE_SECONDS = metrics.histogram_vec(
    "beacon_block_verification_seconds",
    "block import pipeline: per-stage wall time (gossip = structure + "
    "proposer + proposal signature; signature = full-block batch)",
    ("stage",),
)
_OUTCOMES = metrics.counter_vec(
    "beacon_block_verification_outcomes_total",
    "block verification verdicts per stage (outcome = ok or BlockError kind)",
    ("stage", "outcome"),
)


class BlockError(ValueError):
    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"{kind}{': ' + detail if detail else ''}")
        self.kind = kind
        self.detail = detail


def _record_rejection(stage: str, e: BlockError, signed_block, block_root=None):
    """Journal one ``block_rejected`` event with the forensic context a
    counter tick loses: stage, reason, slot, proposer and root."""
    if not flight_recorder.enabled():
        # the root below may need a full SSZ hash: never pay it (bursts
        # of duplicate-gossip rejections) when nothing is recording
        return
    block = signed_block.message
    if block_root is None:
        block_root = hash_tree_root(block)
    flight_recorder.record(
        "block_rejected",
        stage=stage, reason=e.kind, detail=e.detail,
        slot=int(block.slot), proposer_index=int(block.proposer_index),
        root=bytes(block_root),
    )


@dataclass
class GossipVerifiedBlock:
    """Propagation-safe: structure + proposer + proposal signature checked
    against an advanced parent state (reference ``block_verification.rs:590``)."""

    signed_block: object
    block_root: bytes
    state: object  # parent state advanced to block.slot (pre-block)

    @classmethod
    def new(cls, chain, signed_block):
        with tracing.span(
            "block.gossip_verify", slot=int(signed_block.message.slot)
        ), _STAGE_SECONDS.with_labels("gossip").time():
            try:
                out = cls._new_inner(chain, signed_block)
            except BlockError as e:
                _OUTCOMES.with_labels("gossip", e.kind).inc()
                _record_rejection(
                    "gossip", e, signed_block,
                    getattr(e, "block_root", None),
                )
                raise
            _OUTCOMES.with_labels("gossip", "ok").inc()
            return out

    @classmethod
    def _new_inner(cls, chain, signed_block):
        block_root = hash_tree_root(signed_block.message)
        try:
            return cls._new_checked(chain, signed_block, block_root)
        except BlockError as e:
            # forensics reuses THIS Merkleization: a flood of junk gossip
            # blocks must not pay a second full SSZ hash per rejection
            e.block_root = block_root
            raise

    @classmethod
    def _new_checked(cls, chain, signed_block, block_root):
        block = signed_block.message
        current_slot = chain.slot()

        if block.slot > current_slot:
            raise BlockError("FutureSlot", f"{block.slot} > {current_slot}")
        fin_epoch, _ = chain.fork_choice.store.finalized_checkpoint
        if block.slot <= fin_epoch * chain.preset.SLOTS_PER_EPOCH:
            raise BlockError("WouldRevertFinalizedSlot")
        if chain.fork_choice.proto.contains(block_root):
            raise BlockError("BlockIsAlreadyKnown")
        if chain.observed_block_producers.is_known(block.proposer_index, block.slot):
            raise BlockError("RepeatProposal")
        parent_root = bytes(block.parent_root)
        if not chain.fork_choice.proto.contains(parent_root):
            raise BlockError("ParentUnknown", parent_root.hex()[:12])

        state = (
            chain.advanced_state_for(parent_root, block.slot)
            or chain.state_at_block_root(parent_root)
        )
        state = partial_state_advance(chain.preset, chain.spec, copy.deepcopy(state), block.slot)
        expected = get_beacon_proposer_index(chain.preset, state)
        if expected != block.proposer_index:
            raise BlockError(
                "IncorrectBlockProposer", f"{block.proposer_index} != {expected}"
            )
        s = block_proposal_set(
            chain.preset, chain.spec, state, signed_block,
            chain.pubkey_cache.resolver(), block_root=block_root,
        )
        # block verification is latency-critical (a late block loses the
        # slot): the scheduler's SYNCHRONOUS bypass, never the fusing queue
        if not backend_verify_now(chain, [s], kind="block"):
            raise BlockError("ProposalSignatureInvalid")
        chain.observed_block_producers.observe(block.proposer_index, block.slot)
        return cls(signed_block, block_root, state)


@dataclass
class SignatureVerifiedBlock:
    """Every signature in the block verified as ONE batch — the
    north-star consumer (reference ``block_verification.rs:599`` +
    ``block_signature_verifier.rs:120-132``)."""

    signed_block: object
    block_root: bytes
    state: object
    proposal_already_verified: bool = False

    @classmethod
    def from_gossip(cls, gossip: GossipVerifiedBlock, chain):
        return cls._verify(
            chain, gossip.signed_block, gossip.block_root, gossip.state,
            skip_proposal=True,
        )

    @classmethod
    def new(cls, chain, signed_block, block_root=None):
        block = signed_block.message
        if block_root is None:
            block_root = hash_tree_root(block)
        parent_root = bytes(block.parent_root)
        if not chain.fork_choice.proto.contains(parent_root):
            raise BlockError("ParentUnknown", parent_root.hex()[:12])
        state = (
            chain.advanced_state_for(parent_root, block.slot)
            or chain.state_at_block_root(parent_root)
        )
        state = partial_state_advance(
            chain.preset, chain.spec, copy.deepcopy(state), block.slot
        )
        return cls._verify(chain, signed_block, block_root, state, skip_proposal=False)

    @classmethod
    def _verify(cls, chain, signed_block, block_root, state, skip_proposal):
        from ..crypto.bls import BlsError

        with tracing.span(
            "block.signature_verify", slot=int(signed_block.message.slot),
            skip_proposal=skip_proposal,
        ), _STAGE_SECONDS.with_labels("signature").time():
            try:
                acc = BlockSignatureAccumulator(
                    chain.preset, chain.spec, state, chain.pubkey_cache.resolver(),
                    resolver_by_pubkey_bytes=chain.pubkey_resolver_by_bytes(),
                )
                if skip_proposal:
                    acc.include_randao_reveal(signed_block.message)
                    acc.include_operations(signed_block)
                else:
                    acc.include_all(signed_block, block_root=block_root)
                # same bypass as the proposal check: the full-block batch
                # must not wait on the gossip fusing deadline
                ok = backend_verify_now(chain, acc.sets, kind="block")
            except BlsError:  # malformed signature bytes in the block body
                ok = False
        _OUTCOMES.with_labels(
            "signature", "ok" if ok else "InvalidSignature"
        ).inc()
        if not ok:
            e = BlockError("InvalidSignature")
            _record_rejection("signature", e, signed_block, block_root)
            # a full-block signature batch failing is the verify-failure
            # the forensics layer exists for: snapshot the journal (the
            # staged device event with per-stage latencies is in it)
            flight_recorder.dump_on_failure(
                "block_signature_invalid",
                slot=int(signed_block.message.slot), root=bytes(block_root),
            )
            raise e
        return cls(signed_block, block_root, state, skip_proposal)


@dataclass
class ExecutionPendingBlock:
    """Consensus-verified; payload handed to the execution layer whose
    verdict is joined at import (reference ``block_verification.rs:621``)."""

    signed_block: object
    block_root: bytes
    state: object
    payload_verification_handle: object = dc_field(default=None)
