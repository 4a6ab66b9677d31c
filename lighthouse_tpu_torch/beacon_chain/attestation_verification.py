"""Gossip attestation verification, single and batched (reference:
``beacon_node/beacon_chain/src/attestation_verification.rs`` and
``attestation_verification/batch.rs:31-222``).

The batch paths are the TPU feeder: N structural-verified attestations
become one backend ``verify_signature_sets`` call (1 set per unaggregated
attestation; 3 per aggregate — ``batch.rs:77-107,182-196``). On a batch
failure, items are re-verified individually so per-item results are
identical to the non-batched path (``batch.rs:1-11,115-119``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..crypto.bls import BlsError
from ..ssz import hash_tree_root
from ..state_transition.helpers import compute_epoch_at_slot
from ..state_transition.signature_sets import (
    aggregate_and_proof_sets,
    indexed_attestation_set,
)
from ..utils import flight_recorder, metrics, tracing
from ..verification_service import backend_verify, backend_verify_each

ATTESTATION_PROPAGATION_SLOT_RANGE = 32
TARGET_AGGREGATORS_PER_COMMITTEE = 16

_BATCH_SETUP = metrics.histogram_vec(
    "attestation_batch_setup_seconds",
    "structural checks + set building for a gossip attestation batch",
    ("kind",),
)
_BATCH_SIG = metrics.histogram_vec(
    "attestation_batch_signature_seconds",
    "backend batch signature verification for a gossip attestation batch",
    ("kind",),
)
_VERIFY_SECONDS = metrics.histogram_vec(
    "attestation_verification_seconds",
    "full gossip-to-verdict wall time (mode=batch: one sample per "
    "N-item batch; mode=single: one per item)",
    ("kind", "mode"),
)
_OUTCOMES = metrics.counter_vec(
    "attestation_verification_outcomes_total",
    "per-item gossip attestation verdicts (outcome = ok or the error kind)",
    ("kind", "outcome"),
)


def _att_data(kind: str, item):
    """The AttestationData of a gossip item, whichever wrapper it wears."""
    return item.data if kind == "unaggregated" else item.message.aggregate.data


def _record_rejection(kind: str, e: "AttestationError", item) -> None:
    """Journal one ``attestation_rejected`` event: reason + slot/root (+
    the validator/aggregator index when the raise site knew it)."""
    try:
        data = _att_data(kind, item)
        where = {
            "slot": int(data.slot),
            "committee_index": int(data.index),
            "root": bytes(data.beacon_block_root),
        }
    except Exception:  # malformed item: the reason is still worth keeping
        where = {}
    flight_recorder.record(
        "attestation_rejected", kind=kind, reason=e.kind, **e.ctx, **where
    )


def _count_outcomes(kind: str, results, items) -> None:
    for r, item in zip(results, items):
        if isinstance(r, AttestationError):
            _OUTCOMES.with_labels(kind, r.kind).inc()
            _record_rejection(kind, r, item)
        else:
            _OUTCOMES.with_labels(kind, "ok").inc()


def _observed(kind: str):
    """Single-item paths: same latency family + outcome accounting as the
    batch paths, so dashboards see one verdict stream per kind."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(chain, item, current_slot):
            with tracing.span("attestation.verify", kind=kind), \
                    _VERIFY_SECONDS.with_labels(kind, "single").time():
                try:
                    out = fn(chain, item, current_slot)
                except AttestationError as e:
                    _OUTCOMES.with_labels(kind, e.kind).inc()
                    _record_rejection(kind, e, item)
                    raise
                _OUTCOMES.with_labels(kind, "ok").inc()
                return out
        return wrapper
    return deco


class AttestationError(ValueError):
    """Structural/gossip-rule rejection; ``kind`` mirrors the reference's
    error enum so batch fallback can report per-item outcomes. ``ctx``
    carries whatever identifying context the raise site had (validator
    index, aggregator index) for the flight-recorder journal."""

    def __init__(self, kind: str, detail: str = "", **ctx):
        super().__init__(f"{kind}{': ' + detail if detail else ''}")
        self.kind = kind
        self.ctx = ctx


@dataclass
class VerifiedUnaggregatedAttestation:
    attestation: object
    indexed: object
    validator_index: int
    committee_index: int


@dataclass
class VerifiedAggregatedAttestation:
    signed_aggregate: object
    indexed: object
    aggregator_index: int


def _committee_for(chain, data):
    epoch = compute_epoch_at_slot(chain.preset, data.slot)
    cache = chain.shuffling_cache.get(chain, epoch, data.target.root)
    count = cache.committees_per_slot
    if data.index >= count:
        raise AttestationError("BadCommitteeIndex", f"{data.index} >= {count}")
    return cache.committee(data.slot, data.index)


def _structural_unaggregated(chain, att, current_slot: int):
    """Everything except the signature; returns (indexed, validator_index)."""
    data = att.data
    if data.target.epoch != compute_epoch_at_slot(chain.preset, data.slot):
        raise AttestationError("BadTargetEpoch")
    if not (
        data.slot <= current_slot <= data.slot + ATTESTATION_PROPAGATION_SLOT_RANGE
    ):
        raise AttestationError(
            "OutsideSlotRange", f"slot {data.slot} vs current {current_slot}"
        )
    bits = list(att.aggregation_bits)
    if sum(bits) != 1:
        raise AttestationError("NotExactlyOneBit")
    if not chain.fork_choice.proto.contains(bytes(data.beacon_block_root)):
        raise AttestationError("UnknownHeadBlock", data.beacon_block_root.hex()[:12])
    if not chain.fork_choice.proto.contains(bytes(data.target.root)):
        raise AttestationError("UnknownTargetRoot")
    committee = _committee_for(chain, data)
    if len(bits) != len(committee):
        raise AttestationError(
            "BitsCommitteeMismatch", f"{len(bits)} != {len(committee)}"
        )
    validator_index = int(committee[bits.index(True)])
    if chain.observed_attesters.is_known(validator_index, data.target.epoch):
        raise AttestationError(
            "PriorAttestationKnown", str(validator_index),
            validator_index=validator_index,
        )
    t = chain.types
    indexed = t.IndexedAttestation(
        attesting_indices=[validator_index], data=data, signature=att.signature
    )
    return indexed, validator_index


@_observed("unaggregated")
def verify_unaggregated_attestation(chain, att, current_slot: int):
    """Single-item gossip path (reference
    ``IndexedUnaggregatedAttestation::verify``)."""
    # Lock discipline (reference: RwLock-guarded caches around a lock-free
    # signature check): structural checks + set building read shared chain
    # state under the chain lock, the BLS call runs WITHOUT it, and the
    # observed-cache commit re-takes it — observe() returning True then
    # catches any racing duplicate.
    with chain._chain_lock:
        indexed, validator_index = _structural_unaggregated(
            chain, att, current_slot
        )
        try:
            s = indexed_attestation_set(
                chain.preset, chain.spec, chain.head_state, indexed,
                chain.pubkey_cache.resolver(),
            )
        except BlsError:
            raise AttestationError("InvalidSignature")
    try:
        ok = backend_verify(chain, [s], "unaggregated")
    except BlsError:  # malformed signature bytes = invalid, never a crash
        ok = False
    if not ok:
        raise AttestationError("InvalidSignature")
    with chain._chain_lock:
        if chain.observed_attesters.observe(validator_index, att.data.target.epoch):
            raise AttestationError(
                "PriorAttestationKnown", validator_index=validator_index
            )
    return VerifiedUnaggregatedAttestation(att, indexed, validator_index, att.data.index)


def batch_verify_unaggregated_attestations(chain, attestations, current_slot: int):
    """One backend call for the whole batch; identical per-item results to
    the single path (reference ``batch.rs:139-222``). Returns a list of
    ``VerifiedUnaggregatedAttestation | AttestationError`` per input.

    The heavy BLS batch runs outside the chain lock so worker threads
    verify concurrently; setup and the observed-cache commit take it."""
    results: list[object] = [None] * len(attestations)
    pending = []  # (pos, att, indexed, validator_index, set)
    with tracing.span(
        "attestation.batch_verify", kind="unaggregated",
        n=len(attestations),
    ), _VERIFY_SECONDS.with_labels("unaggregated", "batch").time():
        with chain._chain_lock, tracing.span("attestation.setup"), \
                _BATCH_SETUP.with_labels("unaggregated").time():
            for pos, att in enumerate(attestations):
                try:
                    indexed, vindex = _structural_unaggregated(chain, att, current_slot)
                    s = indexed_attestation_set(
                        chain.preset, chain.spec, chain.head_state, indexed,
                        chain.pubkey_cache.resolver(),
                    )
                    pending.append((pos, att, indexed, vindex, s))
                except AttestationError as e:
                    results[pos] = e
                except BlsError:
                    results[pos] = AttestationError("InvalidSignature")
        with tracing.span("attestation.signature", n_sets=len(pending)), \
                _BATCH_SIG.with_labels("unaggregated").time():
            # backend_verify routes through the chain's verification
            # scheduler when one is attached (cross-caller fused device
            # batches, verification_service/batcher.py); verdicts are
            # identical to the direct call either way.
            batch_ok = bool(pending) and backend_verify(
                chain, [p[4] for p in pending], "unaggregated"
            )
            # per-item fallback (reference batch.rs:115-119) — still
            # unlocked; submitted together so the retries fuse too
            if batch_ok:
                item_ok = {p[0]: True for p in pending}
            else:
                each = backend_verify_each(
                    chain, [[p[4]] for p in pending], "unaggregated"
                )
                item_ok = {p[0]: ok for p, ok in zip(pending, each)}
        with chain._chain_lock:
            for pos, att, indexed, vindex, s in pending:
                if item_ok[pos]:
                    # observe() returning True = duplicate within this batch or
                    # a racing thread (the pre-batch is_known check ran before
                    # any item was observed); reject it exactly as the
                    # sequential path would.
                    if chain.observed_attesters.observe(vindex, att.data.target.epoch):
                        results[pos] = AttestationError(
                            "PriorAttestationKnown", validator_index=vindex
                        )
                    else:
                        results[pos] = VerifiedUnaggregatedAttestation(
                            att, indexed, vindex, att.data.index
                        )
                else:
                    results[pos] = AttestationError(
                        "InvalidSignature", validator_index=vindex
                    )
    _count_outcomes("unaggregated", results, attestations)
    return results


def _is_aggregator(committee_len: int, selection_proof: bytes) -> bool:
    """Spec ``is_aggregator``: SHA-256 of the proof mod the per-committee
    aggregator modulus."""
    modulo = max(1, committee_len // TARGET_AGGREGATORS_PER_COMMITTEE)
    h = hashlib.sha256(selection_proof).digest()
    return int.from_bytes(h[:8], "little") % modulo == 0


def _structural_aggregated(chain, signed_agg, current_slot: int):
    msg = signed_agg.message
    att = msg.aggregate
    data = att.data
    if data.target.epoch != compute_epoch_at_slot(chain.preset, data.slot):
        raise AttestationError("BadTargetEpoch")
    if not (
        data.slot <= current_slot <= data.slot + ATTESTATION_PROPAGATION_SLOT_RANGE
    ):
        raise AttestationError("OutsideSlotRange")
    att_root = hash_tree_root(att)
    if chain.observed_aggregates.is_known(att_root, data.slot):
        raise AttestationError("AttestationAlreadyKnown")
    if chain.observed_aggregators.is_known(msg.aggregator_index, data.target.epoch):
        raise AttestationError(
            "AggregatorAlreadyKnown", aggregator_index=int(msg.aggregator_index)
        )
    if not chain.fork_choice.proto.contains(bytes(data.beacon_block_root)):
        raise AttestationError("UnknownHeadBlock")
    if not chain.fork_choice.proto.contains(bytes(data.target.root)):
        raise AttestationError("UnknownTargetRoot")
    committee = _committee_for(chain, data)
    bits = list(att.aggregation_bits)
    if len(bits) != len(committee):
        raise AttestationError("BitsCommitteeMismatch")
    if not any(bits):
        raise AttestationError("EmptyAggregationBits")
    if msg.aggregator_index not in [int(i) for i in committee]:
        raise AttestationError("AggregatorNotInCommittee")
    if not _is_aggregator(len(committee), bytes(msg.selection_proof)):
        raise AttestationError("InvalidSelectionProof")
    attesting = [int(v) for v, b in zip(committee, bits) if b]
    t = chain.types
    indexed = t.IndexedAttestation(
        attesting_indices=sorted(attesting), data=data, signature=att.signature
    )
    return indexed, att_root


@_observed("aggregate")
def verify_aggregated_attestation(chain, signed_agg, current_slot: int):
    """Single aggregate: 3 signature sets (reference ``batch.rs:77-107``).
    Same lock discipline as the unaggregated path: BLS runs unlocked."""
    with chain._chain_lock:
        indexed, att_root = _structural_aggregated(chain, signed_agg, current_slot)
        try:
            sets = aggregate_and_proof_sets(
                chain.preset, chain.spec, chain.head_state, signed_agg,
                chain.pubkey_cache.resolver(),
            )
        except BlsError:
            raise AttestationError("InvalidSignature")
    try:
        ok = backend_verify(chain, sets, "aggregate")
    except BlsError:
        ok = False
    if not ok:
        raise AttestationError("InvalidSignature")
    msg = signed_agg.message
    with chain._chain_lock:
        # Root first, and only observe the aggregator for an actually-new
        # aggregate — a rejected duplicate root must not burn the
        # aggregator for the whole epoch (the reference checks
        # observed_aggregates before recording the aggregator).
        if chain.observed_aggregates.observe(att_root, msg.aggregate.data.slot):
            raise AttestationError("AttestationAlreadyKnown")
        if chain.observed_aggregators.observe(
            msg.aggregator_index, msg.aggregate.data.target.epoch
        ):
            raise AttestationError("AggregatorAlreadyKnown")
    return VerifiedAggregatedAttestation(signed_agg, indexed, msg.aggregator_index)


def batch_verify_aggregated_attestations(chain, signed_aggs, current_slot: int):
    """3N sets in one backend call, per-item fallback on failure
    (reference ``batch.rs:31-134``). BLS runs outside the chain lock."""
    results: list[object] = [None] * len(signed_aggs)
    pending = []
    with tracing.span(
        "attestation.batch_verify", kind="aggregate", n=len(signed_aggs),
    ), _VERIFY_SECONDS.with_labels("aggregate", "batch").time():
        _batch_verify_aggregated_inner(
            chain, signed_aggs, current_slot, results, pending
        )
    _count_outcomes("aggregate", results, signed_aggs)
    return results


def _batch_verify_aggregated_inner(
    chain, signed_aggs, current_slot, results, pending
):
    with chain._chain_lock, tracing.span("attestation.setup"), \
            _BATCH_SETUP.with_labels("aggregate").time():
        for pos, sa in enumerate(signed_aggs):
            try:
                indexed, att_root = _structural_aggregated(chain, sa, current_slot)
                sets = aggregate_and_proof_sets(
                    chain.preset, chain.spec, chain.head_state, sa,
                    chain.pubkey_cache.resolver(),
                )
                pending.append((pos, sa, indexed, att_root, sets))
            except AttestationError as e:
                results[pos] = e
            except BlsError:
                results[pos] = AttestationError("InvalidSignature")
    with tracing.span("attestation.signature", n_sets=3 * len(pending)), \
            _BATCH_SIG.with_labels("aggregate").time():
        all_sets = [s for p in pending for s in p[4]]
        batch_ok = bool(pending) and backend_verify(
            chain, all_sets, "aggregate"
        )
        if batch_ok:
            item_ok = {p[0]: True for p in pending}
        else:
            each = backend_verify_each(
                chain, [p[4] for p in pending], "aggregate"
            )
            item_ok = {p[0]: ok for p, ok in zip(pending, each)}
    with chain._chain_lock:
        for pos, sa, indexed, att_root, sets in pending:
            if item_ok[pos]:
                msg = sa.message
                # intra-batch (or cross-thread) duplicates: observe()
                # returns True when the root/aggregator is already
                # recorded. Root first; a duplicate root must not burn
                # the aggregator for the epoch.
                if chain.observed_aggregates.observe(
                    att_root, msg.aggregate.data.slot
                ):
                    results[pos] = AttestationError("AttestationAlreadyKnown")
                elif chain.observed_aggregators.observe(
                    msg.aggregator_index, msg.aggregate.data.target.epoch
                ):
                    results[pos] = AttestationError(
                        "AggregatorAlreadyKnown",
                        aggregator_index=int(msg.aggregator_index),
                    )
                else:
                    results[pos] = VerifiedAggregatedAttestation(
                        sa, indexed, msg.aggregator_index
                    )
            else:
                results[pos] = AttestationError(
                    "InvalidSignature",
                    aggregator_index=int(sa.message.aggregator_index),
                )
    return results
