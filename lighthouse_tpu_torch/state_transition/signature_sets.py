"""SignatureSet constructors: every signed object in the system -> the
(signature, pubkeys, signing_root) triple the batch verifier consumes.

This is the re-design of the reference's
``consensus/state_processing/src/per_block_processing/signature_sets.rs``
(set constructors) + ``block_signature_verifier.rs`` (the accumulator):
the accumulator here is a plain list whose one consumer is
``bls.verify_signature_sets`` — on the ``tpu`` backend that means ONE
fixed-shape device batch for the whole block (vs the reference's
rayon-chunked CPU loop, ``block_signature_verifier.rs:374-382``).

Deposits are deliberately excluded (spec: deposit signatures are checked
individually with the genesis domain and may legitimately be invalid —
reference ``block_signature_verifier.rs:116-117``).
"""

from __future__ import annotations

from typing import Callable

from ..crypto import bls
from .. import ssz
from ..ssz import hash_tree_root
from ..types import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
    ChainSpec,
    compute_signing_root,
    get_domain,
    types_for,
)
from ..types.preset import Preset
from .helpers import get_attesting_indices, get_beacon_proposer_index

PubkeyResolver = Callable[[int], "bls.PublicKey | None"]


class SignatureSetError(ValueError):
    pass


def _pk(resolver: PubkeyResolver, index: int) -> bls.PublicKey:
    pk = resolver(index)
    if pk is None:
        raise SignatureSetError(f"unknown validator index {index}")
    return pk


def _sig(raw: bytes) -> bls.Signature:
    return bls.Signature.deserialize(raw)


def block_proposal_set(
    preset: Preset, spec: ChainSpec, state, signed_block, resolver: PubkeyResolver,
    block_root: bytes | None = None,
) -> bls.SignatureSet:
    block = signed_block.message
    epoch = block.slot // preset.SLOTS_PER_EPOCH
    domain = get_domain(spec, state, DOMAIN_BEACON_PROPOSER, epoch)
    if block_root is None:
        block_root = hash_tree_root(type(block), block)
    root = compute_signing_root(None, block_root, domain)
    return bls.SignatureSet.single_pubkey(
        _sig(signed_block.signature), _pk(resolver, block.proposer_index), root,
        signing_index=block.proposer_index,
    )


def randao_set(
    preset: Preset, spec: ChainSpec, state, block, resolver: PubkeyResolver
) -> bls.SignatureSet:
    epoch = block.slot // preset.SLOTS_PER_EPOCH
    domain = get_domain(spec, state, DOMAIN_RANDAO, epoch)
    root = compute_signing_root(ssz.Uint64, epoch, domain)
    return bls.SignatureSet.single_pubkey(
        _sig(block.body.randao_reveal), _pk(resolver, block.proposer_index), root,
        signing_index=block.proposer_index,
    )


def proposer_slashing_sets(
    preset: Preset, spec: ChainSpec, state, slashing, resolver: PubkeyResolver
) -> list[bls.SignatureSet]:
    out = []
    for signed_header in (slashing.signed_header_1, slashing.signed_header_2):
        header = signed_header.message
        epoch = header.slot // preset.SLOTS_PER_EPOCH
        domain = get_domain(spec, state, DOMAIN_BEACON_PROPOSER, epoch)
        root = compute_signing_root(type(header), header, domain)
        out.append(
            bls.SignatureSet.single_pubkey(
                _sig(signed_header.signature),
                _pk(resolver, header.proposer_index),
                root,
                signing_index=header.proposer_index,
            )
        )
    return out


def indexed_attestation_set(
    preset: Preset, spec: ChainSpec, state, indexed, resolver: PubkeyResolver
) -> bls.SignatureSet:
    t = types_for(preset)
    domain = get_domain(spec, state, DOMAIN_BEACON_ATTESTER, indexed.data.target.epoch)
    root = compute_signing_root(t.AttestationData, indexed.data, domain)
    indices = [int(i) for i in indexed.attesting_indices]
    pks = [_pk(resolver, i) for i in indices]
    return bls.SignatureSet.multiple_pubkeys(
        _sig(indexed.signature), pks, root, signing_indices=indices
    )


def attestation_set(
    preset: Preset, spec: ChainSpec, state, attestation, resolver: PubkeyResolver
) -> bls.SignatureSet:
    from .helpers import get_indexed_attestation

    indexed = get_indexed_attestation(preset, state, attestation)
    return indexed_attestation_set(preset, spec, state, indexed, resolver)


def attester_slashing_sets(
    preset: Preset, spec: ChainSpec, state, slashing, resolver: PubkeyResolver
) -> list[bls.SignatureSet]:
    return [
        indexed_attestation_set(preset, spec, state, slashing.attestation_1, resolver),
        indexed_attestation_set(preset, spec, state, slashing.attestation_2, resolver),
    ]


def exit_set(
    preset: Preset, spec: ChainSpec, state, signed_exit, resolver: PubkeyResolver
) -> bls.SignatureSet:
    t = types_for(preset)
    exit_msg = signed_exit.message
    domain = get_domain(spec, state, DOMAIN_VOLUNTARY_EXIT, exit_msg.epoch)
    root = compute_signing_root(t.VoluntaryExit, exit_msg, domain)
    return bls.SignatureSet.single_pubkey(
        _sig(signed_exit.signature), _pk(resolver, exit_msg.validator_index), root,
        signing_index=exit_msg.validator_index,
    )


def sync_aggregate_set(
    preset: Preset, spec: ChainSpec, state, block_slot: int, sync_aggregate,
    resolver_by_pubkey_bytes,
) -> "bls.SignatureSet | None":
    """Sync committee signs the previous slot's block root. Returns None if
    no bits are set AND the signature is the infinity point (valid empty
    aggregate, spec eth2_fast_aggregate_verify G2_POINT_AT_INFINITY rule)."""
    from .helpers import get_block_root_at_slot

    t = types_for(preset)
    bits = sync_aggregate.sync_committee_bits
    participant_pubkeys = [
        pk_bytes
        for pk_bytes, bit in zip(state.current_sync_committee.pubkeys, bits)
        if bit
    ]
    sig = _sig(sync_aggregate.sync_committee_signature)
    if not participant_pubkeys:
        if sig.serialize() == bls.INFINITY_SIGNATURE:
            return None
        raise SignatureSetError("empty sync aggregate with non-infinity signature")
    prev_slot = max(block_slot, 1) - 1
    domain = get_domain(
        spec, state, DOMAIN_SYNC_COMMITTEE, prev_slot // preset.SLOTS_PER_EPOCH
    )
    root = compute_signing_root(
        None, get_block_root_at_slot(preset, state, prev_slot), domain
    )
    pks = [resolver_by_pubkey_bytes(b) for b in participant_pubkeys]
    if any(p is None for p in pks):
        raise SignatureSetError("unknown sync-committee pubkey")
    return bls.SignatureSet.multiple_pubkeys(sig, pks, root)


def aggregate_and_proof_sets(
    preset: Preset, spec: ChainSpec, state, signed_agg, resolver: PubkeyResolver
) -> list[bls.SignatureSet]:
    """The three sets of a gossip aggregate (reference:
    ``attestation_verification/batch.rs:77-107``): selection proof,
    aggregator signature, aggregate attestation signature."""
    t = types_for(preset)
    msg = signed_agg.message
    att = msg.aggregate
    epoch = att.data.slot // preset.SLOTS_PER_EPOCH

    sel_domain = get_domain(spec, state, DOMAIN_SELECTION_PROOF, epoch)
    sel_root = compute_signing_root(ssz.Uint64, att.data.slot, sel_domain)
    selection = bls.SignatureSet.single_pubkey(
        _sig(msg.selection_proof), _pk(resolver, msg.aggregator_index), sel_root,
        signing_index=msg.aggregator_index,
    )

    agg_domain = get_domain(spec, state, DOMAIN_AGGREGATE_AND_PROOF, epoch)
    agg_root = compute_signing_root(t.AggregateAndProof, msg, agg_domain)
    aggregator = bls.SignatureSet.single_pubkey(
        _sig(signed_agg.signature), _pk(resolver, msg.aggregator_index), agg_root,
        signing_index=msg.aggregator_index,
    )

    attestation = attestation_set(preset, spec, state, att, resolver)
    return [selection, aggregator, attestation]


def deposit_signature_is_valid(preset: Preset, spec: ChainSpec, deposit_data) -> bool:
    """Deposits verify individually against the GENESIS fork version and an
    empty genesis_validators_root (spec is_valid_deposit_signature); invalid
    signatures skip the deposit rather than fail the block."""
    from ..types import compute_domain, DOMAIN_DEPOSIT

    t = types_for(preset)
    try:
        pk = bls.PublicKey.deserialize(deposit_data.pubkey)
        sig = bls.Signature.deserialize(deposit_data.signature)
        domain = compute_domain(
            spec, DOMAIN_DEPOSIT, spec.genesis_fork_version, bytes(32)
        )
        msg = t.DepositMessage(
            pubkey=deposit_data.pubkey,
            withdrawal_credentials=deposit_data.withdrawal_credentials,
            amount=deposit_data.amount,
        )
        root = compute_signing_root(t.DepositMessage, msg, domain)
        # verify() may ALSO raise BlsError now: decompression is lazy, so
        # an off-curve x surfaces here, and must skip the deposit, not
        # fail the block (spec is_valid_deposit_signature semantics)
        return sig.verify(pk, root)
    except bls.BlsError:
        return False


class BlockSignatureAccumulator:
    """Collects every signature set of a signed block, then verifies them
    as ONE batch (the ``VerifyBulk`` strategy of the reference's
    ``BlockSignatureVerifier``, ``block_signature_verifier.rs:66-132``)."""

    def __init__(self, preset: Preset, spec: ChainSpec, state, resolver: PubkeyResolver,
                 resolver_by_pubkey_bytes=None):
        self.preset = preset
        self.spec = spec
        self.state = state
        self.resolver = resolver
        self.resolver_by_pubkey_bytes = resolver_by_pubkey_bytes
        self.sets: list[bls.SignatureSet] = []

    def include_all(self, signed_block, block_root: bytes | None = None) -> None:
        self.include_block_proposal(signed_block, block_root)
        block = signed_block.message
        self.include_randao_reveal(block)
        self.include_operations(signed_block)

    def include_operations(self, signed_block) -> None:
        """Every body operation's sets: slashings, attestations, exits,
        sync aggregate (reference include_* methods,
        ``block_signature_verifier.rs:135-340``)."""
        block = signed_block.message
        body = block.body
        for ps in body.proposer_slashings:
            self.sets.extend(
                proposer_slashing_sets(self.preset, self.spec, self.state, ps, self.resolver)
            )
        for asl in body.attester_slashings:
            self.sets.extend(
                attester_slashing_sets(self.preset, self.spec, self.state, asl, self.resolver)
            )
        for att in body.attestations:
            self.sets.append(
                attestation_set(self.preset, self.spec, self.state, att, self.resolver)
            )
        for ex in body.voluntary_exits:
            self.sets.append(
                exit_set(self.preset, self.spec, self.state, ex, self.resolver)
            )
        if hasattr(body, "sync_aggregate"):
            s = sync_aggregate_set(
                self.preset,
                self.spec,
                self.state,
                block.slot,
                body.sync_aggregate,
                self.resolver_by_pubkey_bytes,
            )
            if s is not None:
                self.sets.append(s)

    def include_block_proposal(self, signed_block, block_root=None) -> None:
        self.sets.append(
            block_proposal_set(
                self.preset, self.spec, self.state, signed_block, self.resolver, block_root
            )
        )

    def include_randao_reveal(self, block) -> None:
        self.sets.append(
            randao_set(self.preset, self.spec, self.state, block, self.resolver)
        )

    def verify(self) -> bool:
        return bls.verify_signature_sets(self.sets)
