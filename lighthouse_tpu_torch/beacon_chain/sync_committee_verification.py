"""Gossip verification of sync-committee messages and contributions
(reference: ``beacon_chain/src/sync_committee_verification.rs`` —
``verify_sync_committee_message`` :561 and ``verify_sync_signed_
contribution_and_proof`` :252-267).

Both verifiers follow the attestation pipeline's shape: structural checks
and dedup bookkeeping under the chain lock, the BLS batch as one
``verify_signature_sets`` call (a contribution costs three sets, exactly
like an aggregate attestation — selection proof, aggregator signature,
aggregated message signature).
"""

from __future__ import annotations

import hashlib
import threading

from ..crypto import bls
from ..ssz import hash_tree_root
from ..types.chain_spec import (
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
)
from ..types.domains import compute_signing_root, get_domain
from ..utils import flight_recorder
from ..verification_service import backend_verify, backend_verify_each

TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE = 16


class SyncCommitteeError(ValueError):
    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"{kind}: {detail}" if detail else kind)
        self.kind = kind


class VerifiedSyncCommitteeMessage:
    __slots__ = ("message", "positions")

    def __init__(self, message, positions):
        self.message = message
        self.positions = positions  # positions within the FULL committee


class VerifiedSyncContribution:
    __slots__ = ("signed", "participant_indices")

    def __init__(self, signed, participant_indices):
        self.signed = signed
        self.participant_indices = participant_indices


class ObservedSyncItems:
    """Dedup caches for sync gossip, pruned by slot (reference
    ``observed_attesters``-style seen-caches for sync messages)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._messages: set[tuple] = set()        # (slot, validator_index)
        self._aggregators: set[tuple] = set()     # (slot, subcommittee, vi)
        self._contributions: set[tuple] = set()   # (slot, root, subc, bits)

    def observe(self, table: str, key: tuple) -> bool:
        with self._lock:
            s = getattr(self, f"_{table}")
            if key in s:
                return True
            s.add(key)
            return False

    def is_known(self, table: str, key: tuple) -> bool:
        with self._lock:
            return key in getattr(self, f"_{table}")

    def prune(self, min_slot: int) -> None:
        with self._lock:
            for name in ("_messages", "_aggregators", "_contributions"):
                s = getattr(self, name)
                setattr(self, name, {k for k in s if k[0] >= min_slot})


def _observed(chain) -> ObservedSyncItems:
    obs = getattr(chain, "observed_sync_items", None)
    if obs is None:
        obs = chain.observed_sync_items = ObservedSyncItems()
    return obs


def sync_committee_pubkeys(chain, slot: int):
    """Full sync-committee pubkey list for ``slot``'s period, or None when
    the head state cannot know it (reference committee rotation rule)."""
    P = chain.preset
    state = chain.head_state
    if not hasattr(state, "current_sync_committee"):
        return None  # pre-altair
    period = (slot // P.SLOTS_PER_EPOCH) // P.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    head_period = (
        state.slot // P.SLOTS_PER_EPOCH
    ) // P.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    if period == head_period:
        return [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    if period == head_period + 1:
        return [bytes(pk) for pk in state.next_sync_committee.pubkeys]
    return None


def is_sync_committee_aggregator(preset, selection_proof: bytes) -> bool:
    """Spec ``is_sync_committee_aggregator``."""
    modulo = max(
        1,
        preset.sync_subcommittee_size
        // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE,
    )
    h = hashlib.sha256(bytes(selection_proof)).digest()
    return int.from_bytes(h[:8], "little") % modulo == 0


def _slot_window_ok(chain, slot: int) -> bool:
    # Sync messages are only useful for the current slot; allow one slot
    # of clock disparity either way (reference MAXIMUM_GOSSIP_CLOCK_
    # DISPARITY applied to the one-slot propagation window).
    current = chain.slot()
    return slot <= current + 1 and slot + 1 >= current


def _prepare_sync_message(chain, msg):
    """Structural checks + signature-set assembly for one message; MUST be
    called under the chain lock. Returns (positions, SignatureSet)."""
    slot = int(msg.slot)
    vi = int(msg.validator_index)
    if not _slot_window_ok(chain, slot):
        raise SyncCommitteeError("OutsideSlotWindow", f"slot {slot}")
    state = chain.head_state
    if not 0 <= vi < len(state.validators):
        raise SyncCommitteeError("UnknownValidator", str(vi))
    committee = sync_committee_pubkeys(chain, slot)
    if committee is None:
        raise SyncCommitteeError("UnknownSyncCommittee")
    pk_raw = bytes(state.validators[vi].pubkey)
    positions = [i for i, c in enumerate(committee) if c == pk_raw]
    if not positions:
        raise SyncCommitteeError("NotInSyncCommittee", str(vi))
    if _observed(chain).is_known("messages", (slot, vi)):
        raise SyncCommitteeError("PriorMessageKnown", str(vi))
    epoch = slot // chain.preset.SLOTS_PER_EPOCH
    domain = get_domain(chain.spec, state, DOMAIN_SYNC_COMMITTEE, epoch)
    signing_root = compute_signing_root(
        None, bytes(msg.beacon_block_root), domain
    )
    from .pubkey_cache import PubkeyCacheError

    try:
        pk = chain.pubkey_cache.get(vi)  # a bls.PublicKey wrapper
    except PubkeyCacheError:
        raise SyncCommitteeError("UnknownValidator", str(vi))
    try:
        sig = bls.Signature.deserialize(bytes(msg.signature))
    except bls.BlsError:
        raise SyncCommitteeError("InvalidSignature")
    return positions, bls.SignatureSet.single_pubkey(sig, pk, signing_root)


def batch_verify_sync_committee_messages(chain, messages):
    """ONE backend call for a whole gossip batch, per-item fallback on
    failure — the sync analogue of ``batch_verify_unaggregated_
    attestations`` (reference processes sync messages through the same
    batch machinery, ``sync_committee_verification.rs:561`` fed by the
    beacon processor). Returns VerifiedSyncCommitteeMessage |
    SyncCommitteeError per input; BLS runs outside the chain lock."""
    results: list[object] = [None] * len(messages)
    pending = []  # (pos, msg, positions, set)
    with chain._chain_lock:
        for pos, m in enumerate(messages):
            try:
                positions, s = _prepare_sync_message(chain, m)
                pending.append((pos, m, positions, s))
            except SyncCommitteeError as e:
                results[pos] = e
    try:
        # scheduler-aware (verification_service/batcher.py): sync batches
        # fuse with concurrent attestation traffic into shared device
        # batches when the chain carries a scheduler
        batch_ok = bool(pending) and backend_verify(
            chain, [p[3] for p in pending], "sync_message"
        )
    except bls.BlsError:
        batch_ok = False
    if batch_ok:
        item_ok = {p[0]: True for p in pending}
    else:
        item_ok = {}
        try:
            each = backend_verify_each(
                chain, [[p[3]] for p in pending], "sync_message"
            )
        except bls.BlsError:
            each = [False] * len(pending)
        for p, ok in zip(pending, each):
            item_ok[p[0]] = ok
    with chain._chain_lock:
        for pos, m, positions, _s in pending:
            if not item_ok[pos]:
                results[pos] = SyncCommitteeError("InvalidSignature")
            elif _observed(chain).observe(
                "messages", (int(m.slot), int(m.validator_index))
            ):
                results[pos] = SyncCommitteeError(
                    "PriorMessageKnown", str(int(m.validator_index))
                )
            else:
                results[pos] = VerifiedSyncCommitteeMessage(m, positions)
    for pos, r in enumerate(results):
        if isinstance(r, SyncCommitteeError):
            m = messages[pos]
            flight_recorder.record(
                "sync_rejected", kind="message", reason=r.kind,
                slot=int(m.slot), validator_index=int(m.validator_index),
                root=bytes(m.beacon_block_root),
            )
    return results


def verify_sync_committee_message(chain, msg) -> VerifiedSyncCommitteeMessage:
    """Single sync-committee message from gossip/API; returns positions in
    the full committee (a pubkey may hold several slots)."""
    out = batch_verify_sync_committee_messages(chain, [msg])[0]
    if isinstance(out, SyncCommitteeError):
        raise out
    return out


def verify_sync_contribution(chain, signed) -> VerifiedSyncContribution:
    """SignedContributionAndProof from gossip/API — three signature sets
    in one backend call (reference ``:252-267``). Rejections are
    journaled as ``sync_rejected`` events with slot/aggregator context."""
    try:
        return _verify_sync_contribution_inner(chain, signed)
    except SyncCommitteeError as e:
        c = signed.message.contribution
        flight_recorder.record(
            "sync_rejected", kind="contribution", reason=e.kind,
            slot=int(c.slot), subcommittee_index=int(c.subcommittee_index),
            aggregator_index=int(signed.message.aggregator_index),
            root=bytes(c.beacon_block_root),
        )
        raise


def _verify_sync_contribution_inner(chain, signed) -> VerifiedSyncContribution:
    msg = signed.message
    contribution = msg.contribution
    slot = int(contribution.slot)
    subc = int(contribution.subcommittee_index)
    P = chain.preset
    if not _slot_window_ok(chain, slot):
        raise SyncCommitteeError("OutsideSlotWindow", f"slot {slot}")
    if subc >= P.SYNC_COMMITTEE_SUBNET_COUNT:
        raise SyncCommitteeError("InvalidSubcommittee", str(subc))
    bits = [bool(b) for b in contribution.aggregation_bits]
    if not any(bits):
        raise SyncCommitteeError("EmptyAggregationBits")
    ai = int(msg.aggregator_index)

    with chain._chain_lock:
        state = chain.head_state
        if not 0 <= ai < len(state.validators):
            raise SyncCommitteeError("UnknownValidator", str(ai))
        committee = sync_committee_pubkeys(chain, slot)
        if committee is None:
            raise SyncCommitteeError("UnknownSyncCommittee")
        sub_size = P.sync_subcommittee_size
        sub_pks = committee[subc * sub_size : (subc + 1) * sub_size]
        agg_pk_raw = bytes(state.validators[ai].pubkey)
        if agg_pk_raw not in sub_pks:
            raise SyncCommitteeError("AggregatorNotInSubcommittee", str(ai))
        if not is_sync_committee_aggregator(P, bytes(msg.selection_proof)):
            raise SyncCommitteeError("InvalidSelectionProof")
        obs = _observed(chain)
        bits_key = tuple(bits)
        root = bytes(contribution.beacon_block_root)
        if obs.is_known("aggregators", (slot, subc, ai)):
            raise SyncCommitteeError("AggregatorAlreadyKnown", str(ai))
        if obs.is_known("contributions", (slot, root, subc, bits_key)):
            raise SyncCommitteeError("ContributionAlreadyKnown")

        epoch = slot // P.SLOTS_PER_EPOCH
        t = chain.types
        resolver = chain.pubkey_resolver_by_bytes()

        # set 1: selection proof over SyncAggregatorSelectionData
        sel_domain = get_domain(
            chain.spec, state, DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch
        )
        sel_data = t.SyncAggregatorSelectionData(
            slot=slot, subcommittee_index=subc
        )
        sel_root = compute_signing_root(
            t.SyncAggregatorSelectionData, sel_data, sel_domain
        )
        # set 2: aggregator's signature over the ContributionAndProof
        cap_domain = get_domain(
            chain.spec, state, DOMAIN_CONTRIBUTION_AND_PROOF, epoch
        )
        cap_root = compute_signing_root(t.ContributionAndProof, msg, cap_domain)
        # set 3: the aggregated message signature from the participants
        sc_domain = get_domain(chain.spec, state, DOMAIN_SYNC_COMMITTEE, epoch)
        sc_root = compute_signing_root(None, root, sc_domain)
        participant_pks = []
        participant_indices = []
        for pos, bit in enumerate(bits):
            if not bit:
                continue
            pk_point = resolver(sub_pks[pos])
            if pk_point is None:
                raise SyncCommitteeError("UnknownParticipantPubkey")
            participant_pks.append(pk_point)
            participant_indices.append(subc * sub_size + pos)
        from .pubkey_cache import PubkeyCacheError

        try:
            agg_pk = chain.pubkey_cache.get(ai)
            sel_sig = bls.Signature.deserialize(bytes(msg.selection_proof))
            cap_sig = bls.Signature.deserialize(bytes(signed.signature))
            con_sig = bls.Signature.deserialize(bytes(contribution.signature))
        except (bls.BlsError, PubkeyCacheError) as e:
            raise SyncCommitteeError("InvalidSignature", str(e))
        # pubkey_cache / resolver hand back bls.PublicKey wrappers already
        sets = [
            bls.SignatureSet.single_pubkey(sel_sig, agg_pk, sel_root),
            bls.SignatureSet.single_pubkey(cap_sig, agg_pk, cap_root),
            bls.SignatureSet.multiple_pubkeys(
                con_sig, participant_pks, sc_root
            ),
        ]
    try:
        ok = backend_verify(chain, sets, "sync_contribution")
    except bls.BlsError:
        ok = False
    if not ok:
        raise SyncCommitteeError("InvalidSignature")
    with chain._chain_lock:
        obs = _observed(chain)
        if obs.observe("contributions", (slot, root, subc, bits_key)):
            raise SyncCommitteeError("ContributionAlreadyKnown")
        if obs.observe("aggregators", (slot, subc, ai)):
            raise SyncCommitteeError("AggregatorAlreadyKnown", str(ai))
    return VerifiedSyncContribution(signed, participant_indices)
