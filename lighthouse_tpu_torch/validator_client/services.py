"""Validator client services (reference: ``validator_client/src/``
``duties_service.rs:107-110``, ``attestation_service.rs:23-126``,
``block_service.rs``, ``beacon_node_fallback.rs``,
``doppelganger_service.rs:1-30``).

Event loop shape mirrors the reference: a slot tick drives — duties are
polled per epoch; attestations are produced at slot + 1/3 and aggregates
at slot + 2/3; proposals fire at the slot start when a proposer duty
matches. Here the services expose explicit ``on_slot``-style methods so
tests (and the simulator) can drive them deterministically with a
ManualSlotClock; ``run_forever`` wires them to wall-clock time.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field

from ..keys import SlashingProtectionError
from ..eth2_client import BeaconNodeError
from ..ssz import hash_tree_root
from ..utils import metrics

_PUBLISHED_ATTS = metrics.counter("vc_published_attestations_total")
_PUBLISHED_BLOCKS = metrics.counter("vc_published_blocks_total")
_FAILED_DUTIES = metrics.counter("vc_failed_duties_total")

TARGET_AGGREGATORS_PER_COMMITTEE = 16


class BeaconNodeFallback:
    """Health-ranked multi-node redundancy (reference
    ``beacon_node_fallback.rs``): try nodes in order, demote failures."""

    def __init__(self, clients: list):
        if not clients:
            raise ValueError("at least one beacon node required")
        self.clients = list(clients)
        self._lock = threading.Lock()

    def first_healthy(self):
        with self._lock:
            order = list(self.clients)
        for c in order:
            if c.health():
                return c
        return order[0]

    def call(self, fn_name: str, *args, **kwargs):
        last_err = None
        with self._lock:
            order = list(self.clients)
        for i, c in enumerate(order):
            try:
                return getattr(c, fn_name)(*args, **kwargs)
            except BeaconNodeError as e:
                last_err = e
                if i == 0 and len(order) > 1:
                    # demote the failing primary
                    with self._lock:
                        if self.clients and self.clients[0] is c:
                            self.clients.append(self.clients.pop(0))
        raise last_err


@dataclass
class AttesterDuty:
    pubkey: bytes
    validator_index: int
    slot: int
    committee_index: int
    committee_length: int
    committees_at_slot: int
    validator_committee_index: int


@dataclass
class ProposerDuty:
    pubkey: bytes
    validator_index: int
    slot: int


class DutiesService:
    """Polls duties per epoch and resolves validator indices (reference
    ``duties_service.rs``)."""

    def __init__(self, store, nodes: BeaconNodeFallback, preset):
        self.store = store
        self.nodes = nodes
        self.preset = preset
        self.attesters: dict[int, list[AttesterDuty]] = {}
        self.proposers: dict[int, list[ProposerDuty]] = {}

    def resolve_indices(self) -> None:
        for pk in self.store.pubkeys():
            if self.store.index_of(pk) is None:
                found = self.nodes.call(
                    "validators", "head", id="0x" + pk.hex()
                )
                if found:
                    self.store.set_index(pk, int(found[0]["index"]))

    def poll_epoch(self, epoch: int) -> None:
        self.resolve_indices()
        own = {
            self.store.index_of(pk): pk
            for pk in self.store.pubkeys()
            if self.store.index_of(pk) is not None
        }
        if not own:
            return
        att = self.nodes.call("attester_duties", epoch, sorted(own))
        self.attesters[epoch] = [
            AttesterDuty(
                pubkey=bytes.fromhex(d["pubkey"][2:]),
                validator_index=int(d["validator_index"]),
                slot=int(d["slot"]),
                committee_index=int(d["committee_index"]),
                committee_length=int(d["committee_length"]),
                committees_at_slot=int(d["committees_at_slot"]),
                validator_committee_index=int(d["validator_committee_index"]),
            )
            for d in att["data"]
            if int(d["validator_index"]) in own
        ]
        prop = self.nodes.call("proposer_duties", epoch)
        self.proposers[epoch] = [
            ProposerDuty(
                pubkey=bytes.fromhex(d["pubkey"][2:]),
                validator_index=int(d["validator_index"]),
                slot=int(d["slot"]),
            )
            for d in prop["data"]
            if int(d["validator_index"]) in own
        ]
        # prune old epochs
        for e in [e for e in self.attesters if e + 2 < epoch]:
            del self.attesters[e]
            self.proposers.pop(e, None)


class AttestationService:
    """Produce + sign + publish per duty; aggregate when selected
    (reference ``attestation_service.rs``)."""

    def __init__(self, store, nodes: BeaconNodeFallback, duties: DutiesService, types):
        self.store = store
        self.nodes = nodes
        self.duties = duties
        self.t = types

    def attest(self, slot: int) -> int:
        """slot+1/3 work: one attestation per duty at this slot."""
        epoch = slot // self.duties.preset.SLOTS_PER_EPOCH
        published = 0
        for duty in self.duties.attesters.get(epoch, []):
            if duty.slot != slot:
                continue
            try:
                data = self.nodes.call(
                    "attestation_data", slot, duty.committee_index
                )
                sig = self.store.sign_attestation(duty.pubkey, data)
                bits = [
                    i == duty.validator_committee_index
                    for i in range(duty.committee_length)
                ]
                att = self.t.Attestation(
                    aggregation_bits=bits, data=data, signature=sig
                )
                self.nodes.call("publish_attestations", [att])
                published += 1
                _PUBLISHED_ATTS.inc()
            except (BeaconNodeError, SlashingProtectionError, KeyError):
                # KeyError: key disabled/removed (doppelganger) — skip the
                # duty, never kill the loop
                _FAILED_DUTIES.inc()
        return published

    def aggregate(self, slot: int) -> int:
        """slot+2/3 work: publish SignedAggregateAndProof where this
        validator is the committee's aggregator (spec is_aggregator)."""
        epoch = slot // self.duties.preset.SLOTS_PER_EPOCH
        published = 0
        for duty in self.duties.attesters.get(epoch, []):
            if duty.slot != slot:
                continue
            try:
                proof = self.store.selection_proof(duty.pubkey, slot)
                modulo = max(
                    1, duty.committee_length // TARGET_AGGREGATORS_PER_COMMITTEE
                )
                h = hashlib.sha256(proof).digest()
                if int.from_bytes(h[:8], "little") % modulo != 0:
                    continue
                data = self.nodes.call(
                    "attestation_data", slot, duty.committee_index
                )
                agg = self.nodes.call(
                    "aggregate_attestation", slot, hash_tree_root(data)
                )
                msg = self.t.AggregateAndProof(
                    aggregator_index=duty.validator_index,
                    aggregate=agg,
                    selection_proof=proof,
                )
                signed = self.store.sign_aggregate_and_proof(duty.pubkey, msg)
                self.nodes.call("publish_aggregate_and_proofs", [signed])
                published += 1
            except (BeaconNodeError, SlashingProtectionError, KeyError):
                _FAILED_DUTIES.inc()
        return published


class SyncCommitteeService:
    """Sync-committee message production per slot (reference
    ``sync_committee_service.rs``): every duty signs the head block root
    and publishes; contribution aggregation happens node-side via the
    sync-message pool."""

    def __init__(self, store, nodes: BeaconNodeFallback, preset):
        self.store = store
        self.nodes = nodes
        self.preset = preset
        self.duties: dict[int, list[dict]] = {}  # epoch -> duty dicts

    def poll_epoch(self, epoch: int) -> None:
        own = [
            self.store.index_of(pk)
            for pk in self.store.pubkeys()
            if self.store.index_of(pk) is not None
        ]
        if not own:
            self.duties[epoch] = []
            return
        try:
            out = self.nodes.call("sync_duties", epoch, sorted(own))
            self.duties[epoch] = out.get("data", [])
        except BeaconNodeError:
            _FAILED_DUTIES.inc()
            return  # transient: retry next slot instead of caching empty
        for e in [e for e in self.duties if e + 2 < epoch]:
            del self.duties[e]

    def sign_and_publish(self, slot: int) -> int:
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        if epoch not in self.duties:
            self.poll_epoch(epoch)
        duties = self.duties.get(epoch, [])
        if not duties:
            return 0
        published = 0
        try:
            head = self.nodes.call("header", "head")
            root = bytes.fromhex(head["root"][2:])
            msgs = []
            for d in duties:
                pk = bytes.fromhex(d["pubkey"][2:])
                try:
                    sig = self.store.sign_sync_committee_message(pk, slot, root)
                except KeyError:
                    continue
                msgs.append(
                    {
                        "slot": str(slot),
                        "beacon_block_root": "0x" + root.hex(),
                        "validator_index": d["validator_index"],
                        "signature": "0x" + sig.hex(),
                    }
                )
            if msgs:
                self.nodes.call("publish_sync_committee_messages", msgs)
                published = len(msgs)
        except BeaconNodeError:
            _FAILED_DUTIES.inc()
        return published

    def aggregate_and_publish(self, slot: int) -> int:
        """Sync-committee CONTRIBUTION aggregation (reference
        ``sync_committee_service.rs`` at slot+2/3): for every duty whose
        selection proof makes it a subcommittee aggregator, fetch the
        node's aggregated contribution, wrap + sign a
        ContributionAndProof, and publish."""
        from ..beacon_chain.sync_committee_verification import (
            is_sync_committee_aggregator,
        )

        epoch = slot // self.preset.SLOTS_PER_EPOCH
        duties = self.duties.get(epoch, [])
        if not duties:
            return 0
        published = 0
        try:
            head = self.nodes.call("header", "head")
            root = bytes.fromhex(head["root"][2:])
            sub_size = self.preset.sync_subcommittee_size
            signed_out = []
            for d in duties:
                pk = bytes.fromhex(d["pubkey"][2:])
                positions = [
                    int(p) for p in d["validator_sync_committee_indices"]
                ]
                for subc in sorted({p // sub_size for p in positions}):
                    try:
                        proof = self.store.sign_sync_selection_proof(
                            pk, slot, subc
                        )
                    except KeyError:
                        continue
                    if not is_sync_committee_aggregator(self.preset, proof):
                        continue
                    try:
                        contribution = self.nodes.call(
                            "sync_committee_contribution", slot, subc, root
                        )
                    except BeaconNodeError:
                        continue  # nothing collected for this subcommittee
                    msg = self.store.t.ContributionAndProof(
                        aggregator_index=int(d["validator_index"]),
                        contribution=contribution,
                        selection_proof=proof,
                    )
                    signed_out.append(
                        self.store.sign_contribution_and_proof(pk, msg)
                    )
            if signed_out:
                self.nodes.call("publish_contribution_and_proofs", signed_out)
                published = len(signed_out)
        except (BeaconNodeError, SlashingProtectionError, KeyError):
            _FAILED_DUTIES.inc()
        return published


class BlockService:
    """Proposal flow: randao -> produce -> sign -> publish (reference
    ``block_service.rs``)."""

    def __init__(self, store, nodes: BeaconNodeFallback, duties: DutiesService, preset,
                 graffiti_file=None):
        self.store = store
        self.nodes = nodes
        self.duties = duties
        self.preset = preset
        # reference common/graffiti_file: reread per proposal
        self.graffiti_file = graffiti_file

    def propose(self, slot: int) -> int:
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        published = 0
        for duty in self.duties.proposers.get(epoch, []):
            if duty.slot != slot:
                continue
            try:
                randao = self.store.randao_reveal(duty.pubkey, epoch)
                graffiti = bytes(32)
                if self.graffiti_file is not None:
                    graffiti = (
                        self.graffiti_file.graffiti_for(duty.pubkey) or graffiti
                    )
                block = self.nodes.call("produce_block", slot, randao, graffiti)
                signed = self.store.sign_block(duty.pubkey, block)
                self.nodes.call("publish_block", signed)
                published += 1
                _PUBLISHED_BLOCKS.inc()
            except (BeaconNodeError, SlashingProtectionError, KeyError):
                _FAILED_DUTIES.inc()
        return published


class DoppelgangerService:
    """Liveness-based protection (reference
    ``doppelganger_service.rs:1-30``): keys stay disabled for N epochs
    while the BN is polled for evidence they are attesting elsewhere."""

    def __init__(self, store, nodes: BeaconNodeFallback, epochs_to_check: int = 2):
        self.store = store
        self.nodes = nodes
        self.epochs_to_check = epochs_to_check
        self._start_epoch: int | None = None
        self.detection = False

    def begin(self, epoch: int) -> None:
        self._start_epoch = epoch
        with self.store._lock:
            for v in self.store._validators.values():
                v.enabled = False

    def on_epoch(self, epoch: int, seen_validator_indices: set[int]) -> None:
        """``seen_validator_indices``: indices observed attesting on the
        network this epoch (from the BN's liveness endpoint / gossip)."""
        if self._start_epoch is None:
            return
        own = {
            self.store.index_of(pk)
            for pk in list(self.store._validators)
            if self.store.index_of(pk) is not None
        }
        if own & seen_validator_indices:
            # another instance is signing with our keys: shut down
            self.detection = True
            return
        if epoch >= self._start_epoch + self.epochs_to_check:
            with self.store._lock:
                for v in self.store._validators.values():
                    v.enabled = True
            self._start_epoch = None


class ValidatorClient:
    """Wires the services to a slot clock (reference
    ``validator_client/src/lib.rs``)."""

    def __init__(self, store, nodes: BeaconNodeFallback, types, preset, slot_clock,
                 graffiti_file=None):
        self.store = store
        self.nodes = nodes
        self.preset = preset
        self.slot_clock = slot_clock
        self.duties = DutiesService(store, nodes, preset)
        self.attestations = AttestationService(store, nodes, self.duties, types)
        self.blocks = BlockService(
            store, nodes, self.duties, preset, graffiti_file=graffiti_file
        )
        self.sync_committee = SyncCommitteeService(store, nodes, preset)
        from .preparation_service import PreparationService

        self.preparation = PreparationService(store, nodes, preset)
        self._stop = threading.Event()

    def on_slot(self, slot: int) -> None:
        """One deterministic slot of work (tests/simulator drive this)."""
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        try:
            if epoch not in self.duties.attesters:
                self.duties.poll_epoch(epoch)
            if epoch + 1 not in self.duties.attesters and (
                slot % self.preset.SLOTS_PER_EPOCH
            ) >= self.preset.SLOTS_PER_EPOCH // 2:
                self.duties.poll_epoch(epoch + 1)
        except BeaconNodeError:
            _FAILED_DUTIES.inc()
            return
        try:
            self.preparation.prepare_proposers(epoch)
        except BeaconNodeError:
            _FAILED_DUTIES.inc()
        self.blocks.propose(slot)
        self.attestations.attest(slot)
        self.attestations.aggregate(slot)
        self.sync_committee.sign_and_publish(slot)
        self.sync_committee.aggregate_and_publish(slot)

    def run_forever(self) -> None:
        while not self._stop.is_set():
            slot = self.slot_clock.now()
            self.on_slot(slot)
            wait = self.slot_clock.duration_to_next_slot()
            self._stop.wait(max(0.05, wait))

    def stop(self) -> None:
        self._stop.set()
