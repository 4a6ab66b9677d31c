"""Beacon-state accessors and predicates (spec helpers; reference:
``consensus/state_processing/src/common/`` + ``consensus/types``
``BeaconState`` methods). Pure functions of (preset/spec, state) — no god
object: the state is data, helpers are free functions, which is also what
lets the epoch-processing layer vectorize over columnar views.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

from ..types.chain_spec import ChainSpec, FAR_FUTURE_EPOCH
from ..types.preset import Preset
from .shuffle import compute_shuffled_index, shuffle_list

DOMAIN_BEACON_ATTESTER = 1


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def integer_squareroot(n: int) -> int:
    """Spec Newton iteration (floor sqrt)."""
    x = n
    y = (x + 1) // 2
    while y < x:
        x = y
        y = (x + n // x) // 2
    return x


# -- epochs / slots ---------------------------------------------------------

def compute_epoch_at_slot(preset: Preset, slot: int) -> int:
    return slot // preset.SLOTS_PER_EPOCH


def compute_start_slot_at_epoch(preset: Preset, epoch: int) -> int:
    return epoch * preset.SLOTS_PER_EPOCH


def get_current_epoch(preset: Preset, state) -> int:
    return compute_epoch_at_slot(preset, state.slot)


def get_previous_epoch(preset: Preset, state) -> int:
    cur = get_current_epoch(preset, state)
    return cur - 1 if cur > 0 else 0


def compute_activation_exit_epoch(preset: Preset, epoch: int) -> int:
    return epoch + 1 + preset.MAX_SEED_LOOKAHEAD


# -- validator predicates ---------------------------------------------------

def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and v.activation_epoch <= epoch < v.withdrawable_epoch


def is_eligible_for_activation_queue(preset: Preset, v) -> bool:
    return (
        v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and v.effective_balance == preset.MAX_EFFECTIVE_BALANCE
    )


def is_eligible_for_activation(state, v) -> bool:
    return (
        v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
        and v.activation_epoch == FAR_FUTURE_EPOCH
    )


def is_slashable_attestation_data(d1, d2) -> bool:
    """Double vote or surround vote (spec)."""
    from ..ssz import hash_tree_root

    double = (
        hash_tree_root(type(d1), d1) != hash_tree_root(type(d2), d2)
        and d1.target.epoch == d2.target.epoch
    )
    surround = (
        d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    )
    return double or surround


# -- registry / balances ----------------------------------------------------

def get_active_validator_indices(state, epoch: int) -> list[int]:
    return [
        i for i, v in enumerate(state.validators) if is_active_validator(v, epoch)
    ]


def get_total_balance(preset: Preset, state, indices) -> int:
    total = sum(state.validators[i].effective_balance for i in indices)
    return max(preset.EFFECTIVE_BALANCE_INCREMENT, total)


def get_total_active_balance(preset: Preset, state) -> int:
    return get_total_balance(
        preset, state, get_active_validator_indices(state, get_current_epoch(preset, state))
    )


def get_validator_churn_limit(preset: Preset, spec: ChainSpec, state) -> int:
    active = len(
        get_active_validator_indices(state, get_current_epoch(preset, state))
    )
    return max(spec.min_per_epoch_churn_limit, active // spec.churn_limit_quotient)


def increase_balance(state, index: int, delta: int) -> None:
    state.balances[index] += delta


def decrease_balance(state, index: int, delta: int) -> None:
    state.balances[index] = max(0, state.balances[index] - delta)


# -- randomness / roots -----------------------------------------------------

def get_randao_mix(preset: Preset, state, epoch: int) -> bytes:
    return state.randao_mixes[epoch % preset.EPOCHS_PER_HISTORICAL_VECTOR]


def get_seed(preset: Preset, state, epoch: int, domain_type: int) -> bytes:
    mix = get_randao_mix(
        preset,
        state,
        epoch + preset.EPOCHS_PER_HISTORICAL_VECTOR - preset.MIN_SEED_LOOKAHEAD - 1,
    )
    return _h(domain_type.to_bytes(4, "little") + epoch.to_bytes(8, "little") + mix)


def get_block_root_at_slot(preset: Preset, state, slot: int) -> bytes:
    if not slot < state.slot <= slot + preset.SLOTS_PER_HISTORICAL_ROOT:
        raise ValueError(f"slot {slot} out of block-root range at {state.slot}")
    return state.block_roots[slot % preset.SLOTS_PER_HISTORICAL_ROOT]


def get_block_root(preset: Preset, state, epoch: int) -> bytes:
    return get_block_root_at_slot(
        preset, state, compute_start_slot_at_epoch(preset, epoch)
    )


# -- committees -------------------------------------------------------------

def get_committee_count_per_slot(preset: Preset, state, epoch: int) -> int:
    active = len(get_active_validator_indices(state, epoch))
    return max(
        1,
        min(
            preset.MAX_COMMITTEES_PER_SLOT,
            active // preset.SLOTS_PER_EPOCH // preset.TARGET_COMMITTEE_SIZE,
        ),
    )


def compute_committee(
    preset: Preset, indices, seed: bytes, index: int, count: int
) -> list[int]:
    start = len(indices) * index // count
    end = len(indices) * (index + 1) // count
    perm = shuffle_list(len(indices), seed, preset.SHUFFLE_ROUND_COUNT)
    return [indices[perm[i]] for i in range(start, end)]


class CommitteeCache:
    """Per-epoch committee assignment, computed once from the shuffled
    permutation (the analogue of the reference's ``committee_cache.rs``):
    flat numpy arrays, sliced per (slot, committee)."""

    def __init__(self, preset: Preset, state, epoch: int):
        self.preset = preset
        self.epoch = epoch
        self.active = get_active_validator_indices(state, epoch)
        seed = get_seed(preset, state, epoch, DOMAIN_BEACON_ATTESTER)
        self.seed = seed
        n = len(self.active)
        perm = shuffle_list(n, seed, preset.SHUFFLE_ROUND_COUNT)
        self.shuffled = np.asarray(self.active, np.int64)[perm] if n else perm
        self.committees_per_slot = get_committee_count_per_slot(preset, state, epoch)

    def committee(self, slot: int, index: int) -> np.ndarray:
        P = self.preset
        n = len(self.active)
        count = self.committees_per_slot * P.SLOTS_PER_EPOCH
        which = (slot % P.SLOTS_PER_EPOCH) * self.committees_per_slot + index
        start = n * which // count
        end = n * (which + 1) // count
        return self.shuffled[start:end]


def get_beacon_committee(preset: Preset, state, slot: int, index: int):
    epoch = compute_epoch_at_slot(preset, slot)
    return _epoch_committees(preset, state, epoch).committee(slot, index)


# The last epochs' committees, by what they are a function of: a block's
# attestations ask for the same epoch's committees three times each.
_COMMITTEES: OrderedDict = OrderedDict()
_COMMITTEES_MAX = 8
_COMMITTEES_LOCK = threading.Lock()


def _epoch_committees(preset: Preset, state, epoch: int) -> CommitteeCache:
    """``CommitteeCache(preset, state, epoch)``, kept by (preset, epoch,
    seed, active indices) with its permutation read-only."""
    active = get_active_validator_indices(state, epoch)
    key = (preset.name, epoch, get_seed(preset, state, epoch, DOMAIN_BEACON_ATTESTER),
           np.asarray(active, np.int64).tobytes())
    with _COMMITTEES_LOCK:
        cache = _COMMITTEES.get(key)
        if cache is not None:
            _COMMITTEES.move_to_end(key)
            return cache
    cache = CommitteeCache(preset, state, epoch)
    cache.shuffled.setflags(write=False)
    with _COMMITTEES_LOCK:
        _COMMITTEES[key] = cache
        while len(_COMMITTEES) > _COMMITTEES_MAX:
            _COMMITTEES.popitem(last=False)
    return cache


# -- proposer selection -----------------------------------------------------

def compute_proposer_index(preset: Preset, state, indices, seed: bytes) -> int:
    assert indices
    MAX_RANDOM_BYTE = 255
    i = 0
    total = len(indices)
    while True:
        shuffled = compute_shuffled_index(
            i % total, total, seed, preset.SHUFFLE_ROUND_COUNT
        )
        candidate = indices[shuffled]
        random_byte = _h(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eff = state.validators[candidate].effective_balance
        if eff * MAX_RANDOM_BYTE >= preset.MAX_EFFECTIVE_BALANCE * random_byte:
            return candidate
        i += 1


def get_beacon_proposer_index(preset: Preset, state) -> int:
    return proposer_index_at_slot(preset, state, state.slot)


def proposer_index_at_slot(preset: Preset, state, slot: int) -> int:
    """Proposer for any slot of the state's current epoch — usable for
    whole-epoch duty queries without advancing the state per slot."""
    epoch = compute_epoch_at_slot(preset, slot)
    seed = _h(
        get_seed(preset, state, epoch, 0)  # DOMAIN_BEACON_PROPOSER
        + int(slot).to_bytes(8, "little")
    )
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(preset, state, indices, seed)


# -- attestations -----------------------------------------------------------

def get_attesting_indices(preset: Preset, state, data, aggregation_bits) -> list[int]:
    committee = get_beacon_committee(preset, state, data.slot, data.index)
    if len(aggregation_bits) != len(committee):
        raise ValueError("aggregation bits length != committee size")
    return sorted(int(v) for v, b in zip(committee, aggregation_bits) if b)


def get_indexed_attestation(preset: Preset, state, attestation):
    from ..types.containers import types_for

    t = types_for(preset)
    return t.IndexedAttestation(
        attesting_indices=get_attesting_indices(
            preset, state, attestation.data, attestation.aggregation_bits
        ),
        data=attestation.data,
        signature=attestation.signature,
    )


def is_valid_indexed_attestation_structure(preset: Preset, indexed) -> bool:
    """Structural half of the check (signature half goes through the BLS
    backend via signature_sets)."""
    idx = indexed.attesting_indices
    return bool(idx) and list(idx) == sorted(set(idx))


def latest_block_header_root(state, state_root_hint: bytes | None = None) -> bytes:
    """Block root implied by ``state.latest_block_header``. The in-flight
    header's state_root is zero until the next process_slot fills it;
    hashing it raw would give a root no other node computes, so fill it
    (with ``state_root_hint`` when the caller already knows the state
    root, else by hashing the state)."""
    import copy as _copy

    from ..ssz import hash_tree_root

    header = state.latest_block_header
    if bytes(header.state_root) == bytes(32):
        header = _copy.copy(header)
        header.state_root = (
            state_root_hint if state_root_hint is not None else hash_tree_root(state)
        )
    return hash_tree_root(header)
