"""Genesis state construction (reference: ``beacon_node/genesis`` +
``consensus/state_processing/src/genesis.rs``): from deposits, plus the
deterministic interop genesis used by every multi-node test rig
(``common/eth2_interop_keypairs`` — sk_i = int_le(sha256(i_le32)) mod r).
"""

from __future__ import annotations

import hashlib

from ..crypto import bls
from ..crypto.params import R as CURVE_ORDER
from ..ssz import hash_tree_root
from ..types.chain_spec import ChainSpec, FAR_FUTURE_EPOCH
from ..types.containers import types_for
from ..types.preset import Preset
from .block import apply_deposit
from .epoch import get_next_sync_committee
from .helpers import get_active_validator_indices

GENESIS_EPOCH = 0
BLS_WITHDRAWAL_PREFIX = b"\x00"


def interop_secret_key(index: int) -> bls.SecretKey:
    """Deterministic insecure interop key (eth2.0-pm mocked-start rule)."""
    pre = index.to_bytes(8, "little") + bytes(24)
    k = int.from_bytes(hashlib.sha256(pre).digest(), "little") % CURVE_ORDER
    return bls.SecretKey(k)


def _genesis_core(preset: Preset, spec: ChainSpec, fork_name: str, t):
    state = t.state[fork_name]()
    body = t.block_body[fork_name]()
    state.latest_block_header = t.BeaconBlockHeader(
        body_root=hash_tree_root(body)
    )
    if fork_name == "phase0":
        version = spec.genesis_fork_version
        prev = spec.genesis_fork_version
    elif fork_name == "altair":
        version, prev = spec.altair_fork_version, spec.genesis_fork_version
    else:
        version, prev = spec.bellatrix_fork_version, spec.altair_fork_version
    state.fork = t.Fork(
        previous_version=prev, current_version=version, epoch=GENESIS_EPOCH
    )
    return state


def initialize_beacon_state_from_eth1(
    preset: Preset,
    spec: ChainSpec,
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits,
    fork_name: str = "phase0",
):
    """Spec initialize_beacon_state_from_eth1 (with the per-fork genesis
    variants the reference supports for testnets)."""
    from .merkle import compute_merkle_root

    t = types_for(preset)
    state = _genesis_core(preset, spec, fork_name, t)
    state.genesis_time = eth1_timestamp + spec.genesis_delay
    state.eth1_data = t.Eth1Data(
        deposit_count=len(deposits), block_hash=eth1_block_hash
    )
    state.randao_mixes = [eth1_block_hash] * preset.EPOCHS_PER_HISTORICAL_VECTOR

    # process deposits with an incrementally-updated deposit root
    leaves = [hash_tree_root(t.DepositData, d.data) for d in deposits]
    for i, deposit in enumerate(deposits):
        sub = compute_merkle_root(leaves[: i + 1], preset.DEPOSIT_CONTRACT_TREE_DEPTH)
        from ..ssz.sha256 import hash32_concat

        state.eth1_data.deposit_root = hash32_concat(
            sub, (i + 1).to_bytes(32, "little")
        )
        state.eth1_deposit_index = i
        # bypass the merkle proof (computed root IS the proof target)
        apply_deposit(preset, spec, state, deposit.data, fork_name)
        state.eth1_deposit_index = i + 1

    # activations
    for v in state.validators:
        if v.effective_balance == preset.MAX_EFFECTIVE_BALANCE:
            v.activation_eligibility_epoch = GENESIS_EPOCH
            v.activation_epoch = GENESIS_EPOCH
    validators_tpe = dict(t.state[fork_name].fields)["validators"]
    state.genesis_validators_root = hash_tree_root(validators_tpe, state.validators)
    if fork_name in ("altair", "bellatrix"):
        sync = get_next_sync_committee(preset, state)
        state.current_sync_committee = sync
        state.next_sync_committee = get_next_sync_committee(preset, state)
    return state


def is_valid_genesis_state(preset: Preset, spec: ChainSpec, state) -> bool:
    if state.genesis_time < spec.min_genesis_time:
        return False
    return (
        len(get_active_validator_indices(state, GENESIS_EPOCH))
        >= spec.min_genesis_active_validator_count
    )


def interop_genesis_state(
    preset: Preset,
    spec: ChainSpec,
    validator_count: int,
    genesis_time: int = 0,
    fork_name: str = "phase0",
    eth1_block_hash: bytes = b"\x42" * 32,
    pubkey_fn=None,
):
    """Quick-start genesis: deterministic interop validators, all at max
    effective balance and active from epoch 0 (the reference's interop
    genesis used by ``BeaconChainHarness`` and the simulator).

    ``pubkey_fn(secret_key) -> bytes`` derives each compressed public key
    (default ``sk.public_key().serialize()``, the pure-Python oracle);
    ``testing.harness.native_pubkey`` is the C library's, the same bytes
    at a large registry's speed."""
    t = types_for(preset)
    state = _genesis_core(preset, spec, fork_name, t)
    state.genesis_time = genesis_time
    state.randao_mixes = [eth1_block_hash] * preset.EPOCHS_PER_HISTORICAL_VECTOR
    state.eth1_data = t.Eth1Data(
        deposit_count=validator_count, block_hash=eth1_block_hash
    )
    state.eth1_deposit_index = validator_count

    validators = []
    balances = []
    for i in range(validator_count):
        sk = interop_secret_key(i)
        pk = pubkey_fn(sk) if pubkey_fn else sk.public_key().serialize()
        wc = BLS_WITHDRAWAL_PREFIX + hashlib.sha256(pk).digest()[1:]
        validators.append(
            t.Validator(
                pubkey=pk,
                withdrawal_credentials=wc,
                effective_balance=preset.MAX_EFFECTIVE_BALANCE,
                slashed=False,
                activation_eligibility_epoch=GENESIS_EPOCH,
                activation_epoch=GENESIS_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        )
        balances.append(preset.MAX_EFFECTIVE_BALANCE)
    state.validators = validators
    state.balances = balances
    if fork_name in ("altair", "bellatrix"):
        state.previous_epoch_participation = [0] * validator_count
        state.current_epoch_participation = [0] * validator_count
        state.inactivity_scores = [0] * validator_count

    validators_tpe = dict(t.state[fork_name].fields)["validators"]
    state.genesis_validators_root = hash_tree_root(validators_tpe, state.validators)
    if fork_name in ("altair", "bellatrix"):
        sync = get_next_sync_committee(preset, state)
        state.current_sync_committee = sync
        state.next_sync_committee = get_next_sync_committee(preset, state)
    return state
