"""L7: validator client — duties/attestation/block services,
slashing-protected ValidatorStore, doppelganger protection, multi-BN
fallback.

Reference: ``validator_client/``.
"""

from .services import (
    AttestationService,
    AttesterDuty,
    BeaconNodeFallback,
    BlockService,
    DoppelgangerService,
    DutiesService,
    ProposerDuty,
    SyncCommitteeService,
    ValidatorClient,
)
from .validator_store import InitializedValidator, ValidatorStore

__all__ = [
    "AttestationService",
    "AttesterDuty",
    "BeaconNodeFallback",
    "BlockService",
    "DoppelgangerService",
    "DutiesService",
    "InitializedValidator",
    "ProposerDuty",
    "SyncCommitteeService",
    "ValidatorClient",
    "ValidatorStore",
]
