"""Consensus types: presets, runtime chain spec, and per-fork containers
(reference layer: ``consensus/types``, see SURVEY.md §2.3)."""

from .chain_spec import (
    ChainSpec,
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_DEPOSIT,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
    FAR_FUTURE_EPOCH,
    mainnet_spec,
    minimal_spec,
)
from .containers import FORK_ORDER, fork_at_least, types_for
from .domains import (
    compute_domain,
    compute_fork_data_root,
    compute_fork_digest,
    compute_signing_root,
    get_domain,
)
from .preset import MAINNET, MINIMAL, PRESETS, Preset

__all__ = [
    "ChainSpec",
    "FAR_FUTURE_EPOCH",
    "FORK_ORDER",
    "MAINNET",
    "MINIMAL",
    "PRESETS",
    "Preset",
    "compute_domain",
    "compute_fork_data_root",
    "compute_fork_digest",
    "compute_signing_root",
    "fork_at_least",
    "get_domain",
    "mainnet_spec",
    "minimal_spec",
    "types_for",
    "DOMAIN_AGGREGATE_AND_PROOF",
    "DOMAIN_BEACON_ATTESTER",
    "DOMAIN_BEACON_PROPOSER",
    "DOMAIN_CONTRIBUTION_AND_PROOF",
    "DOMAIN_DEPOSIT",
    "DOMAIN_RANDAO",
    "DOMAIN_SELECTION_PROOF",
    "DOMAIN_SYNC_COMMITTEE",
    "DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF",
    "DOMAIN_VOLUNTARY_EXIT",
]
