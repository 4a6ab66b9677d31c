"""Operation pool (reference: ``beacon_node/operation_pool/src/lib.rs``,
``attestation_storage.rs:128-180``, ``max_cover.rs``).

Holds gossip-learned operations for block inclusion:

* attestations, grouped by attestation data, greedily aggregated on
  insert (non-overlapping aggregation via ``signature.add_assign``), and
  selected per block by weighted max-cover over uncovered validators;
* proposer/attester slashings and voluntary exits, deduped by the
  validators they affect, slashings picked by coverage.
"""

from __future__ import annotations

import threading

from ..utils import metrics

_ATTS = metrics.gauge("op_pool_attestations", "pending attestation groups")
_EXITS = metrics.gauge("op_pool_voluntary_exits", "pending voluntary exits")
_ASLASH = metrics.gauge("op_pool_attester_slashings", "pending attester slashings")
_PSLASH = metrics.gauge("op_pool_proposer_slashings", "pending proposer slashings")
_PACKING = metrics.histogram(
    "op_pool_packing_seconds", "max-cover block packing latency"
)
from dataclasses import dataclass

from ..crypto import bls
from ..ssz import hash_tree_root
from ..types.chain_spec import FAR_FUTURE_EPOCH
from ..state_transition.helpers import (
    compute_epoch_at_slot,
    get_beacon_committee,
    get_current_epoch,
    get_previous_epoch,
    is_slashable_attestation_data,
    is_slashable_validator,
)
from .max_cover import maximum_cover


@dataclass
class _CompactAttestation:
    """One (possibly aggregated) attestation over a committee: bit mask +
    signature (reference CompactIndexedAttestation)."""

    aggregation_bits: list
    signature: bytes

    def disjoint(self, other_bits) -> bool:
        return not any(a and b for a, b in zip(self.aggregation_bits, other_bits))


class OperationPool:
    def __init__(self, preset, spec, types, device_agg=None):
        self.preset = preset
        self.spec = spec
        self.types = types
        # opt-in device G2 aggregation: a DeviceAggregator
        # routes the pool's signature point-sums through the device MSM
        # surface; None (the default) keeps every fold on the host —
        # byte-identical output either way (see device_agg.py)
        self._device_agg = device_agg
        self._lock = threading.Lock()
        # (data_root) -> (data, [CompactAttestation])
        self._attestations: dict[bytes, tuple[object, list[_CompactAttestation]]] = {}
        self._proposer_slashings: dict[int, object] = {}
        self._attester_slashings: list[object] = []
        self._voluntary_exits: dict[int, object] = {}
        # (slot, block_root) -> {committee_position: signature}
        self._sync_messages: dict[tuple[int, bytes], dict[int, bytes]] = {}
        # (slot, block_root, subcommittee) -> (bits, aggregated signature)
        self._sync_contributions: dict[tuple, tuple[list, bytes]] = {}

    def set_device_aggregator(self, device_agg) -> None:
        """Attach (or detach with None) the device aggregation path —
        the client wires this after construction so the persistence
        loader's pools pick it up too."""
        self._device_agg = device_agg

    def _aggregate(self, sigs):
        """One AggregateSignature from decoded signatures: the device
        point-sum path when attached and willing, else the
        host ``add_assign`` fold. Both serialize the same group element,
        so the choice is invisible in the pool's outputs."""
        if self._device_agg is not None:
            agg = self._device_agg.aggregate(sigs)
            if agg is not None:
                return agg
        agg = bls.AggregateSignature.infinity()
        for s in sigs:
            agg.add_assign(s)
        return agg

    # -- attestations ----------------------------------------------------

    def _update_size_gauges(self) -> None:
        # caller holds self._lock (reference: op-pool size metrics,
        # beacon_chain/src/metrics.rs OP_POOL_* families)
        _ATTS.set(sum(len(groups) for _, groups in self._attestations.values()))
        _EXITS.set(len(self._voluntary_exits))
        _ASLASH.set(len(self._attester_slashings))
        _PSLASH.set(len(self._proposer_slashings))

    def insert_attestation(self, attestation) -> None:
        """Greedy on-insert aggregation (reference
        ``attestation_storage.rs`` ``aggregate``/``insert``): merge into
        the first disjoint existing aggregate, else keep separately."""
        data_root = hash_tree_root(attestation.data)
        bits = list(attestation.aggregation_bits)
        with self._lock:
            data, groups = self._attestations.setdefault(
                data_root, (attestation.data, [])
            )
            for g in groups:
                if bits == g.aggregation_bits:
                    return  # exact duplicate
                if g.disjoint(bits):
                    merged = self._aggregate(
                        [
                            bls.Signature.deserialize(bytes(g.signature)),
                            bls.Signature.deserialize(
                                bytes(attestation.signature)
                            ),
                        ]
                    )
                    g.aggregation_bits = [
                        a or b for a, b in zip(g.aggregation_bits, bits)
                    ]
                    g.signature = merged.serialize()
                    return
            groups.append(
                _CompactAttestation(bits, bytes(attestation.signature))
            )
            self._update_size_gauges()

    def n_attestations(self) -> int:
        with self._lock:
            return sum(len(g) for _, g in self._attestations.values())

    def attestations_for_block(self, state) -> list:
        """Max-cover selection of up to MAX_ATTESTATIONS attestations
        whose data is includable in a block on ``state``: weight = sum of
        effective balances of not-yet-covered attesting validators."""
        P = self.preset
        t = self.types
        current = get_current_epoch(P, state)
        previous = get_previous_epoch(P, state)

        candidates = []
        with self._lock:
            items = [
                (data, list(groups))
                for data, groups in self._attestations.values()
            ]
        for data, groups in items:
            if data.target.epoch not in (previous, current):
                continue
            if not (
                data.slot + P.MIN_ATTESTATION_INCLUSION_DELAY
                <= state.slot
                <= data.slot + P.SLOTS_PER_EPOCH
            ):
                continue
            # FFG source must match the state's checkpoint for the epoch
            src = (
                state.current_justified_checkpoint
                if data.target.epoch == current
                else state.previous_justified_checkpoint
            )
            if (data.source.epoch, bytes(data.source.root)) != (
                src.epoch,
                bytes(src.root),
            ):
                continue
            committee = get_beacon_committee(P, state, data.slot, data.index)
            for g in groups:
                if len(g.aggregation_bits) != len(committee):
                    continue
                cover = {
                    int(v): state.validators[int(v)].effective_balance
                    for v, bit in zip(committee, g.aggregation_bits)
                    if bit
                }
                att = t.Attestation(
                    aggregation_bits=list(g.aggregation_bits),
                    data=data,
                    signature=g.signature,
                )
                candidates.append((att, cover))
        picked = maximum_cover(candidates, P.MAX_ATTESTATIONS)
        return [att for att, _ in picked]

    # -- slashings / exits ----------------------------------------------

    def insert_proposer_slashing(self, slashing) -> None:
        with self._lock:
            self._proposer_slashings.setdefault(
                slashing.signed_header_1.message.proposer_index, slashing
            )
            self._update_size_gauges()

    def insert_attester_slashing(self, slashing) -> None:
        with self._lock:
            self._attester_slashings.append(slashing)
            self._update_size_gauges()

    def insert_voluntary_exit(self, signed_exit) -> None:
        with self._lock:
            self._voluntary_exits.setdefault(
                signed_exit.message.validator_index, signed_exit
            )
            self._update_size_gauges()

    def _slashable_indices(self, slashing, state) -> dict:
        a = set(slashing.attestation_1.attesting_indices)
        b = set(slashing.attestation_2.attesting_indices)
        epoch = get_current_epoch(self.preset, state)
        if not is_slashable_attestation_data(
            slashing.attestation_1.data, slashing.attestation_2.data
        ):
            return {}
        return {
            int(i): state.validators[int(i)].effective_balance
            for i in a & b
            if int(i) < len(state.validators)
            and is_slashable_validator(state.validators[int(i)], epoch)
        }

    # -- sync committee messages (altair+) -------------------------------
    # (reference: beacon_chain's naive_sync_aggregation_pool + op pool
    # sync contributions)

    def insert_sync_committee_message(self, slot: int, block_root: bytes,
                                      committee_position: int, signature: bytes) -> None:
        with self._lock:
            key = (slot, bytes(block_root))
            self._sync_messages.setdefault(key, {})[committee_position] = bytes(signature)

    def insert_sync_contribution(self, contribution) -> None:
        """Keep the best (highest-participation) contribution per
        (slot, root, subcommittee) — reference op-pool sync contributions
        (``operation_pool/src/sync_aggregate_id.rs`` keying)."""
        bits = [bool(b) for b in contribution.aggregation_bits]
        key = (
            int(contribution.slot),
            bytes(contribution.beacon_block_root),
            int(contribution.subcommittee_index),
        )
        with self._lock:
            prev = self._sync_contributions.get(key)
            if prev is None or sum(bits) > sum(prev[0]):
                self._sync_contributions[key] = (
                    bits, bytes(contribution.signature)
                )

    def sync_contribution_for(self, slot: int, block_root: bytes,
                              subcommittee_index: int):
        """Best SyncCommitteeContribution for ONE subcommittee: the
        aggregate of collected individual messages, or a stored
        gossip-received contribution when it has more participation (a
        node subscribed to the contribution topic but not this subnet has
        only the latter). None when both are empty. (The VC aggregator's
        GET ``sync_committee_contribution`` route.)"""
        sub_size = self.preset.sync_subcommittee_size
        lo = subcommittee_index * sub_size
        key = (slot, bytes(block_root), subcommittee_index)
        with self._lock:
            msgs = self._sync_messages.get((slot, bytes(block_root))) or {}
            sub = {
                pos - lo: raw
                for pos, raw in msgs.items()
                if lo <= pos < lo + sub_size
            }
            stored = self._sync_contributions.get(key)
        bits = [False] * sub_size
        sigs = []
        for pos, raw in sorted(sub.items()):
            try:
                s = bls.Signature.deserialize(raw)
                s.point  # decompress NOW: a bad signature skips, like add_assign
            except bls.BlsError:
                continue
            sigs.append(s)
            bits[pos] = True
        if stored is not None and sum(stored[0]) > sum(bits):
            bits, sig_bytes = list(stored[0]), stored[1]
        elif any(bits):
            sig_bytes = self._aggregate(sigs).serialize()
        else:
            return None
        return self.types.SyncCommitteeContribution(
            slot=slot,
            beacon_block_root=bytes(block_root),
            subcommittee_index=subcommittee_index,
            aggregation_bits=bits,
            signature=sig_bytes,
        )

    def sync_aggregate_for_block(self, slot: int, block_root: bytes):
        """Best-effort SyncAggregate for (slot, root): stored contributions
        cover their subcommittees; individual messages fill positions no
        contribution covers. None when empty (caller uses the empty
        aggregate)."""
        key_root = bytes(block_root)
        with self._lock:
            msgs = dict(self._sync_messages.get((slot, key_root)) or {})
            contribs = {
                k[2]: v
                for k, v in self._sync_contributions.items()
                if k[0] == slot and k[1] == key_root
            }
        if not msgs and not contribs:
            return None
        size = self.preset.SYNC_COMMITTEE_SIZE
        sub_size = self.preset.sync_subcommittee_size
        sigs = []
        covered: set[int] = set()
        for subc, (bits, sig_raw) in contribs.items():
            try:
                s = bls.Signature.deserialize(sig_raw)
                s.point
            except bls.BlsError:
                continue
            sigs.append(s)
            for pos, bit in enumerate(bits):
                if bit:
                    covered.add(subc * sub_size + pos)
        for pos, raw in sorted(msgs.items()):
            if pos in covered:
                continue  # already inside a contribution's aggregate
            try:
                s = bls.Signature.deserialize(raw)
                s.point
            except bls.BlsError:
                continue  # undecodable signature: skip, never break production
            sigs.append(s)
            covered.add(pos)
        if not covered:
            return None
        bits = [p in covered for p in range(size)]
        return self.types.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=self._aggregate(sigs).serialize(),
        )

    def packing_for_block(self, chain, state) -> dict:
        with _PACKING.time():
            return self._packing_for_block(chain, state)

    def _packing_for_block(self, chain, state) -> dict:
        """Everything the block body takes from the pool (reference
        ``produce_block_on_state`` op-pool calls)."""
        P = self.preset
        with self._lock:
            proposer_slashings = list(self._proposer_slashings.values())
            attester_slashings = list(self._attester_slashings)
            exits = list(self._voluntary_exits.values())

        epoch = get_current_epoch(P, state)
        proposer_slashings = [
            s
            for s in proposer_slashings
            if is_slashable_validator(
                state.validators[s.signed_header_1.message.proposer_index], epoch
            )
        ][: P.MAX_PROPOSER_SLASHINGS]

        att_candidates = [
            (s, self._slashable_indices(s, state)) for s in attester_slashings
        ]
        picked = maximum_cover(att_candidates, P.MAX_ATTESTER_SLASHINGS)
        attester_slashings = [s for s, _ in picked]

        exits_out = []
        for e in exits:
            v = state.validators[e.message.validator_index]
            # skip validators already exiting or slashed
            if v.exit_epoch != FAR_FUTURE_EPOCH or v.slashed:
                continue
            exits_out.append(e)
            if len(exits_out) >= P.MAX_VOLUNTARY_EXITS:
                break

        return {
            "attestations": self.attestations_for_block(state),
            "proposer_slashings": proposer_slashings,
            "attester_slashings": attester_slashings,
            "voluntary_exits": exits_out,
        }

    # -- maintenance -----------------------------------------------------

    def contents(self) -> dict:
        """Snapshot of the poolable operations (Beacon API pool dumps +
        persistence consumers) under the pool lock."""
        with self._lock:
            return {
                "voluntary_exits": list(self._voluntary_exits.values()),
                "attester_slashings": list(self._attester_slashings),
                "proposer_slashings": list(self._proposer_slashings.values()),
            }

    def prune(self, state) -> None:
        """Drop everything no longer includable (reference prune_all)."""
        P = self.preset
        current = get_current_epoch(P, state)
        with self._lock:
            self._attestations = {
                r: (d, g)
                for r, (d, g) in self._attestations.items()
                if d.target.epoch + 1 >= current
            }
            self._voluntary_exits = {
                v: e
                for v, e in self._voluntary_exits.items()
                if state.validators[v].exit_epoch == FAR_FUTURE_EPOCH
            }
            self._attester_slashings = [
                s
                for s in self._attester_slashings
                if any(
                    is_slashable_validator(state.validators[int(i)], current)
                    for i in set(s.attestation_1.attesting_indices)
                    & set(s.attestation_2.attesting_indices)
                    if int(i) < len(state.validators)
                )
            ]
            self._proposer_slashings = {
                v: s
                for v, s in self._proposer_slashings.items()
                if is_slashable_validator(state.validators[v], current)
            }
            self._sync_messages = {
                k: v
                for k, v in self._sync_messages.items()
                if k[0] + 2 >= state.slot  # only slot-1 is ever packed
            }
            self._sync_contributions = {
                k: v
                for k, v in self._sync_contributions.items()
                if k[0] + 2 >= state.slot
            }
