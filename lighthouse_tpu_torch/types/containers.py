"""Consensus-spec containers for Base(phase0)/Altair/Bellatrix, built per
preset (the reference's ``consensus/types`` structs, generic over
``EthSpec`` — here generated by :func:`types_for` with the preset's shape
parameters baked into the SSZ descriptors, the same static-shape
discipline the TPU batch planner relies on).

Field names and orders are the public consensus-spec container
definitions; every type maps 1:1 to a reference struct (e.g.
``Attestation`` ~ ``consensus/types/src/attestation.rs``,
``BeaconState*`` ~ ``beacon_state.rs`` superstruct variants).
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

from .. import ssz
from .preset import Preset

FORK_ORDER = ("phase0", "altair", "bellatrix")


def fork_at_least(a: str, b: str) -> bool:
    return FORK_ORDER.index(a) >= FORK_ORDER.index(b)


# Canonical fork <-> wire-byte mapping shared by every component that
# prefixes SSZ payloads with a fork id (store, debug state route, lcli).
FORK_IDS = {"phase0": 0, "altair": 1, "bellatrix": 2}
FORK_NAMES = {v: k for k, v in FORK_IDS.items()}


@lru_cache(maxsize=None)
def types_for(preset: Preset) -> SimpleNamespace:  # noqa: C901 (one big factory)
    P = preset
    u64, Root = ssz.Uint64, ssz.Bytes32

    class Fork(ssz.Container):
        fields = [
            ("previous_version", ssz.Bytes4),
            ("current_version", ssz.Bytes4),
            ("epoch", u64),
        ]

    class ForkData(ssz.Container):
        fields = [
            ("current_version", ssz.Bytes4),
            ("genesis_validators_root", Root),
        ]

    class Checkpoint(ssz.Container):
        fields = [("epoch", u64), ("root", Root)]

    class SigningData(ssz.Container):
        fields = [("object_root", Root), ("domain", Root)]

    class Validator(ssz.Container):
        fields = [
            ("pubkey", ssz.Bytes48),
            ("withdrawal_credentials", Root),
            ("effective_balance", u64),
            ("slashed", ssz.Boolean),
            ("activation_eligibility_epoch", u64),
            ("activation_epoch", u64),
            ("exit_epoch", u64),
            ("withdrawable_epoch", u64),
        ]

    class AttestationData(ssz.Container):
        fields = [
            ("slot", u64),
            ("index", u64),
            ("beacon_block_root", Root),
            ("source", Checkpoint),
            ("target", Checkpoint),
        ]

    class IndexedAttestation(ssz.Container):
        fields = [
            ("attesting_indices", ssz.List(u64, P.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", AttestationData),
            ("signature", ssz.Bytes96),
        ]

    class PendingAttestation(ssz.Container):
        fields = [
            ("aggregation_bits", ssz.Bitlist(P.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", AttestationData),
            ("inclusion_delay", u64),
            ("proposer_index", u64),
        ]

    class Attestation(ssz.Container):
        fields = [
            ("aggregation_bits", ssz.Bitlist(P.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", AttestationData),
            ("signature", ssz.Bytes96),
        ]

    class Eth1Data(ssz.Container):
        fields = [
            ("deposit_root", Root),
            ("deposit_count", u64),
            ("block_hash", Root),
        ]

    class HistoricalBatch(ssz.Container):
        fields = [
            ("block_roots", ssz.Vector(Root, P.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", ssz.Vector(Root, P.SLOTS_PER_HISTORICAL_ROOT)),
        ]

    class DepositMessage(ssz.Container):
        fields = [
            ("pubkey", ssz.Bytes48),
            ("withdrawal_credentials", Root),
            ("amount", u64),
        ]

    class DepositData(ssz.Container):
        fields = [
            ("pubkey", ssz.Bytes48),
            ("withdrawal_credentials", Root),
            ("amount", u64),
            ("signature", ssz.Bytes96),
        ]

    class Deposit(ssz.Container):
        fields = [
            ("proof", ssz.Vector(Root, P.DEPOSIT_CONTRACT_TREE_DEPTH + 1)),
            ("data", DepositData),
        ]

    class BeaconBlockHeader(ssz.Container):
        fields = [
            ("slot", u64),
            ("proposer_index", u64),
            ("parent_root", Root),
            ("state_root", Root),
            ("body_root", Root),
        ]

    class SignedBeaconBlockHeader(ssz.Container):
        fields = [("message", BeaconBlockHeader), ("signature", ssz.Bytes96)]

    class ProposerSlashing(ssz.Container):
        fields = [
            ("signed_header_1", SignedBeaconBlockHeader),
            ("signed_header_2", SignedBeaconBlockHeader),
        ]

    class AttesterSlashing(ssz.Container):
        fields = [
            ("attestation_1", IndexedAttestation),
            ("attestation_2", IndexedAttestation),
        ]

    class VoluntaryExit(ssz.Container):
        fields = [("epoch", u64), ("validator_index", u64)]

    class SignedVoluntaryExit(ssz.Container):
        fields = [("message", VoluntaryExit), ("signature", ssz.Bytes96)]

    class SyncAggregate(ssz.Container):
        fields = [
            ("sync_committee_bits", ssz.Bitvector(P.SYNC_COMMITTEE_SIZE)),
            ("sync_committee_signature", ssz.Bytes96),
        ]

    class SyncCommittee(ssz.Container):
        fields = [
            ("pubkeys", ssz.Vector(ssz.Bytes48, P.SYNC_COMMITTEE_SIZE)),
            ("aggregate_pubkey", ssz.Bytes48),
        ]

    Transaction = ssz.ByteList(P.MAX_BYTES_PER_TRANSACTION)

    class ExecutionPayload(ssz.Container):
        fields = [
            ("parent_hash", Root),
            ("fee_recipient", ssz.Bytes20),
            ("state_root", Root),
            ("receipts_root", Root),
            ("logs_bloom", ssz.ByteVector(P.BYTES_PER_LOGS_BLOOM)),
            ("prev_randao", Root),
            ("block_number", u64),
            ("gas_limit", u64),
            ("gas_used", u64),
            ("timestamp", u64),
            ("extra_data", ssz.ByteList(P.MAX_EXTRA_DATA_BYTES)),
            ("base_fee_per_gas", ssz.Uint256),
            ("block_hash", Root),
            ("transactions", ssz.List(Transaction, P.MAX_TRANSACTIONS_PER_PAYLOAD)),
        ]

    class ExecutionPayloadHeader(ssz.Container):
        fields = [
            ("parent_hash", Root),
            ("fee_recipient", ssz.Bytes20),
            ("state_root", Root),
            ("receipts_root", Root),
            ("logs_bloom", ssz.ByteVector(P.BYTES_PER_LOGS_BLOOM)),
            ("prev_randao", Root),
            ("block_number", u64),
            ("gas_limit", u64),
            ("gas_used", u64),
            ("timestamp", u64),
            ("extra_data", ssz.ByteList(P.MAX_EXTRA_DATA_BYTES)),
            ("base_fee_per_gas", ssz.Uint256),
            ("block_hash", Root),
            ("transactions_root", Root),
        ]

    # -- per-fork block bodies / blocks / states -------------------------

    _body_base = [
        ("randao_reveal", ssz.Bytes96),
        ("eth1_data", Eth1Data),
        ("graffiti", Root),
        ("proposer_slashings", ssz.List(ProposerSlashing, P.MAX_PROPOSER_SLASHINGS)),
        ("attester_slashings", ssz.List(AttesterSlashing, P.MAX_ATTESTER_SLASHINGS)),
        ("attestations", ssz.List(Attestation, P.MAX_ATTESTATIONS)),
        ("deposits", ssz.List(Deposit, P.MAX_DEPOSITS)),
        ("voluntary_exits", ssz.List(SignedVoluntaryExit, P.MAX_VOLUNTARY_EXITS)),
    ]

    class BeaconBlockBodyPhase0(ssz.Container):
        fields = list(_body_base)

    class BeaconBlockBodyAltair(ssz.Container):
        fields = list(_body_base) + [("sync_aggregate", SyncAggregate)]

    class BeaconBlockBodyBellatrix(ssz.Container):
        fields = (
            list(_body_base)
            + [("sync_aggregate", SyncAggregate)]
            + [("execution_payload", ExecutionPayload)]
        )

    def _block_cls(body_cls, name):
        cls = type(
            name,
            (ssz.Container,),
            {
                "fields": [
                    ("slot", u64),
                    ("proposer_index", u64),
                    ("parent_root", Root),
                    ("state_root", Root),
                    ("body", body_cls),
                ]
            },
        )
        return cls

    BeaconBlockPhase0 = _block_cls(BeaconBlockBodyPhase0, "BeaconBlockPhase0")
    BeaconBlockAltair = _block_cls(BeaconBlockBodyAltair, "BeaconBlockAltair")
    BeaconBlockBellatrix = _block_cls(BeaconBlockBodyBellatrix, "BeaconBlockBellatrix")

    # blinded variants (MEV/builder flow; reference
    # consensus/types/src/beacon_block_body.rs BlindedPayload): the
    # execution payload is replaced by its header
    class BlindedBeaconBlockBodyBellatrix(ssz.Container):
        fields = (
            list(_body_base)
            + [("sync_aggregate", SyncAggregate)]
            + [("execution_payload_header", ExecutionPayloadHeader)]
        )

    BlindedBeaconBlockBellatrix = _block_cls(
        BlindedBeaconBlockBodyBellatrix, "BlindedBeaconBlockBellatrix"
    )

    class SignedBlindedBeaconBlockBellatrix(ssz.Container):
        fields = [
            ("message", BlindedBeaconBlockBellatrix),
            ("signature", ssz.Bytes96),
        ]

    def _signed_cls(block_cls, name):
        return type(
            name,
            (ssz.Container,),
            {"fields": [("message", block_cls), ("signature", ssz.Bytes96)]},
        )

    SignedBeaconBlockPhase0 = _signed_cls(BeaconBlockPhase0, "SignedBeaconBlockPhase0")
    SignedBeaconBlockAltair = _signed_cls(BeaconBlockAltair, "SignedBeaconBlockAltair")
    SignedBeaconBlockBellatrix = _signed_cls(
        BeaconBlockBellatrix, "SignedBeaconBlockBellatrix"
    )

    _state_prefix = [
        ("genesis_time", u64),
        ("genesis_validators_root", Root),
        ("slot", u64),
        ("fork", Fork),
        ("latest_block_header", BeaconBlockHeader),
        ("block_roots", ssz.Vector(Root, P.SLOTS_PER_HISTORICAL_ROOT)),
        ("state_roots", ssz.Vector(Root, P.SLOTS_PER_HISTORICAL_ROOT)),
        ("historical_roots", ssz.List(Root, P.HISTORICAL_ROOTS_LIMIT)),
        ("eth1_data", Eth1Data),
        ("eth1_data_votes", ssz.List(Eth1Data, P.eth1_votes_limit)),
        ("eth1_deposit_index", u64),
        ("validators", ssz.List(Validator, P.VALIDATOR_REGISTRY_LIMIT)),
        ("balances", ssz.List(u64, P.VALIDATOR_REGISTRY_LIMIT)),
        ("randao_mixes", ssz.Vector(Root, P.EPOCHS_PER_HISTORICAL_VECTOR)),
        ("slashings", ssz.Vector(u64, P.EPOCHS_PER_SLASHINGS_VECTOR)),
    ]
    _state_suffix = [
        ("justification_bits", ssz.Bitvector(P.JUSTIFICATION_BITS_LENGTH)),
        ("previous_justified_checkpoint", Checkpoint),
        ("current_justified_checkpoint", Checkpoint),
        ("finalized_checkpoint", Checkpoint),
    ]

    class BeaconStatePhase0(ssz.Container):
        fields = (
            list(_state_prefix)
            + [
                (
                    "previous_epoch_attestations",
                    ssz.List(PendingAttestation, P.max_pending_attestations),
                ),
                (
                    "current_epoch_attestations",
                    ssz.List(PendingAttestation, P.max_pending_attestations),
                ),
            ]
            + list(_state_suffix)
        )

    _altair_mid = [
        (
            "previous_epoch_participation",
            ssz.List(ssz.Uint8, P.VALIDATOR_REGISTRY_LIMIT),
        ),
        (
            "current_epoch_participation",
            ssz.List(ssz.Uint8, P.VALIDATOR_REGISTRY_LIMIT),
        ),
    ]
    _altair_suffix = [
        ("inactivity_scores", ssz.List(u64, P.VALIDATOR_REGISTRY_LIMIT)),
        ("current_sync_committee", SyncCommittee),
        ("next_sync_committee", SyncCommittee),
    ]

    class BeaconStateAltair(ssz.Container):
        fields = (
            list(_state_prefix) + _altair_mid + list(_state_suffix) + _altair_suffix
        )

    class BeaconStateBellatrix(ssz.Container):
        fields = (
            list(_state_prefix)
            + _altair_mid
            + list(_state_suffix)
            + _altair_suffix
            + [("latest_execution_payload_header", ExecutionPayloadHeader)]
        )

    # -- aggregation / sync-committee wire types -------------------------

    # -- light-client types (altair; reference consensus/types/src/
    # light_client_{bootstrap,update,finality_update,optimistic_update}.rs)

    class LightClientBootstrap(ssz.Container):
        fields = [
            ("header", BeaconBlockHeader),
            ("current_sync_committee", SyncCommittee),
            ("current_sync_committee_branch", ssz.Vector(Root, 5)),
        ]

    class LightClientUpdate(ssz.Container):
        fields = [
            ("attested_header", BeaconBlockHeader),
            ("next_sync_committee", SyncCommittee),
            ("next_sync_committee_branch", ssz.Vector(Root, 5)),
            ("finalized_header", BeaconBlockHeader),
            ("finality_branch", ssz.Vector(Root, 6)),
            ("sync_aggregate", SyncAggregate),
            ("signature_slot", u64),
        ]

    class LightClientFinalityUpdate(ssz.Container):
        fields = [
            ("attested_header", BeaconBlockHeader),
            ("finalized_header", BeaconBlockHeader),
            ("finality_branch", ssz.Vector(Root, 6)),
            ("sync_aggregate", SyncAggregate),
            ("signature_slot", u64),
        ]

    class LightClientOptimisticUpdate(ssz.Container):
        fields = [
            ("attested_header", BeaconBlockHeader),
            ("sync_aggregate", SyncAggregate),
            ("signature_slot", u64),
        ]

    class AggregateAndProof(ssz.Container):
        fields = [
            ("aggregator_index", u64),
            ("aggregate", Attestation),
            ("selection_proof", ssz.Bytes96),
        ]

    class SignedAggregateAndProof(ssz.Container):
        fields = [("message", AggregateAndProof), ("signature", ssz.Bytes96)]

    class SyncCommitteeMessage(ssz.Container):
        fields = [
            ("slot", u64),
            ("beacon_block_root", Root),
            ("validator_index", u64),
            ("signature", ssz.Bytes96),
        ]

    class SyncCommitteeContribution(ssz.Container):
        fields = [
            ("slot", u64),
            ("beacon_block_root", Root),
            ("subcommittee_index", u64),
            ("aggregation_bits", ssz.Bitvector(P.sync_subcommittee_size)),
            ("signature", ssz.Bytes96),
        ]

    class ContributionAndProof(ssz.Container):
        fields = [
            ("aggregator_index", u64),
            ("contribution", SyncCommitteeContribution),
            ("selection_proof", ssz.Bytes96),
        ]

    class SignedContributionAndProof(ssz.Container):
        fields = [("message", ContributionAndProof), ("signature", ssz.Bytes96)]

    class SyncAggregatorSelectionData(ssz.Container):
        fields = [("slot", u64), ("subcommittee_index", u64)]

    ns = SimpleNamespace(**{k: v for k, v in locals().items() if not k.startswith("_")})
    ns.preset = preset
    ns.block_body = {
        "phase0": BeaconBlockBodyPhase0,
        "altair": BeaconBlockBodyAltair,
        "bellatrix": BeaconBlockBodyBellatrix,
    }
    ns.block = {
        "phase0": BeaconBlockPhase0,
        "altair": BeaconBlockAltair,
        "bellatrix": BeaconBlockBellatrix,
    }
    ns.signed_block = {
        "phase0": SignedBeaconBlockPhase0,
        "altair": SignedBeaconBlockAltair,
        "bellatrix": SignedBeaconBlockBellatrix,
    }
    ns.state = {
        "phase0": BeaconStatePhase0,
        "altair": BeaconStateAltair,
        "bellatrix": BeaconStateBellatrix,
    }
    return ns
