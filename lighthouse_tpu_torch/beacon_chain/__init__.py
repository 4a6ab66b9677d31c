"""L4 core runtime: the BeaconChain and its verification pipelines.

Reference: ``beacon_node/beacon_chain`` (SURVEY.md §2.4).
"""

from .attestation_verification import (
    AttestationError,
    VerifiedAggregatedAttestation,
    VerifiedUnaggregatedAttestation,
    batch_verify_aggregated_attestations,
    batch_verify_unaggregated_attestations,
)
from .block_verification import (
    BlockError,
    ExecutionPendingBlock,
    GossipVerifiedBlock,
    SignatureVerifiedBlock,
)
from .chain import BeaconChain, ShufflingCache, SnapshotCache
from .fork_revert import revert_to_fork_boundary
from .observed import (
    ObservedAggregates,
    ObservedAggregators,
    ObservedAttesters,
    ObservedBlockProducers,
    ObservedOperations,
)
from .pubkey_cache import ValidatorPubkeyCache
from .sync_committee_verification import (
    batch_verify_sync_committee_messages,
    SyncCommitteeError,
    VerifiedSyncCommitteeMessage,
    VerifiedSyncContribution,
    verify_sync_committee_message,
    verify_sync_contribution,
)
from .validator_monitor import ValidatorMonitor

__all__ = [
    "AttestationError",
    "BeaconChain",
    "BlockError",
    "revert_to_fork_boundary",
    "ExecutionPendingBlock",
    "GossipVerifiedBlock",
    "ObservedAggregates",
    "ObservedAggregators",
    "ObservedAttesters",
    "ObservedBlockProducers",
    "ObservedOperations",
    "ShufflingCache",
    "SignatureVerifiedBlock",
    "SnapshotCache",
    "SyncCommitteeError",
    "batch_verify_sync_committee_messages",
    "VerifiedSyncCommitteeMessage",
    "VerifiedSyncContribution",
    "verify_sync_committee_message",
    "verify_sync_contribution",
    "ValidatorMonitor",
    "ValidatorPubkeyCache",
    "VerifiedAggregatedAttestation",
    "VerifiedUnaggregatedAttestation",
    "ValidatorPubkeyCache",
]
