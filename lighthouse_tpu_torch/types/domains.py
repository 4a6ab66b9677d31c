"""Domain / signing-root computation (spec helpers the reference keeps on
``ChainSpec`` — ``consensus/types/src/chain_spec.rs`` ``get_domain``/
``compute_domain`` — and in ``signing_root`` helpers)."""

from __future__ import annotations

from ..ssz import hash_tree_root
from .chain_spec import ChainSpec
from .containers import types_for
from .preset import PRESETS


def _fork_data_root(t, current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return hash_tree_root(
        t.ForkData(
            current_version=current_version,
            genesis_validators_root=genesis_validators_root,
        )
    )


def compute_fork_data_root(
    spec: ChainSpec, current_version: bytes, genesis_validators_root: bytes
) -> bytes:
    t = types_for(PRESETS[spec.preset_base])
    return _fork_data_root(t, current_version, genesis_validators_root)


def compute_fork_digest(
    spec: ChainSpec, current_version: bytes, genesis_validators_root: bytes
) -> bytes:
    return compute_fork_data_root(spec, current_version, genesis_validators_root)[:4]


def compute_domain(
    spec: ChainSpec,
    domain_type: int,
    fork_version: bytes,
    genesis_validators_root: bytes,
) -> bytes:
    root = compute_fork_data_root(spec, fork_version, genesis_validators_root)
    return domain_type.to_bytes(4, "little") + root[:28]


def get_domain(
    spec: ChainSpec,
    state,
    domain_type: int,
    epoch: int | None = None,
) -> bytes:
    """Domain at ``epoch`` using the state's fork (spec ``get_domain``)."""
    preset = PRESETS[spec.preset_base]
    if epoch is None:
        epoch = state.slot // preset.SLOTS_PER_EPOCH
    fork = state.fork
    version = (
        fork.previous_version if epoch < fork.epoch else fork.current_version
    )
    return compute_domain(spec, domain_type, version, state.genesis_validators_root)


def compute_signing_root(tpe, obj, domain: bytes) -> bytes:
    """hash_tree_root(SigningData(object_root, domain)) — the 32-byte
    message every BLS signature in the system actually signs."""
    t = types_for(PRESETS["mainnet"])  # SigningData is preset-independent
    root = hash_tree_root(tpe, obj) if not isinstance(obj, bytes) else obj
    return hash_tree_root(t.SigningData(object_root=root, domain=domain))
