"""Runtime chain configuration (the reference's ``ChainSpec``,
``consensus/types/src/chain_spec.rs``): fork schedule, domains, genesis
and validator-cycle parameters — the knobs that vary per network at
runtime, as opposed to the compile-time ``Preset`` shape parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

FAR_FUTURE_EPOCH = 2**64 - 1

# Domain types (4-byte little-endian tags).
DOMAIN_BEACON_PROPOSER = 0
DOMAIN_BEACON_ATTESTER = 1
DOMAIN_RANDAO = 2
DOMAIN_DEPOSIT = 3
DOMAIN_VOLUNTARY_EXIT = 4
DOMAIN_SELECTION_PROOF = 5
DOMAIN_AGGREGATE_AND_PROOF = 6
DOMAIN_SYNC_COMMITTEE = 7
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = 8
DOMAIN_CONTRIBUTION_AND_PROOF = 9


@dataclass(frozen=True)
class ChainSpec:
    config_name: str = "mainnet"
    preset_base: str = "mainnet"

    # Transition
    terminal_total_difficulty: int = 58750000000000000000000
    terminal_block_hash: bytes = bytes(32)
    terminal_block_hash_activation_epoch: int = FAR_FUTURE_EPOCH

    # Genesis
    min_genesis_active_validator_count: int = 16384
    min_genesis_time: int = 1606824000
    genesis_fork_version: bytes = bytes(4)
    genesis_delay: int = 604800

    # Fork schedule
    altair_fork_version: bytes = bytes([1, 0, 0, 0])
    altair_fork_epoch: int | None = 74240
    bellatrix_fork_version: bytes = bytes([2, 0, 0, 0])
    bellatrix_fork_epoch: int | None = 144896

    # Time
    seconds_per_slot: int = 12
    seconds_per_eth1_block: int = 14
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    eth1_follow_distance: int = 2048

    # Validator cycle
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    ejection_balance: int = 16_000_000_000
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536

    # Fork choice
    proposer_score_boost: int | None = 40

    # Deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes.fromhex(
        "00000000219ab540356cbb839cbe05303d7705fa"
    )

    # -- fork helpers -----------------------------------------------------

    def fork_name_at_epoch(self, epoch: int) -> str:
        if self.bellatrix_fork_epoch is not None and epoch >= self.bellatrix_fork_epoch:
            return "bellatrix"
        if self.altair_fork_epoch is not None and epoch >= self.altair_fork_epoch:
            return "altair"
        return "phase0"

    def fork_version_for(self, fork_name: str) -> bytes:
        return {
            "phase0": self.genesis_fork_version,
            "altair": self.altair_fork_version,
            "bellatrix": self.bellatrix_fork_version,
        }[fork_name]

    def fork_epoch_for(self, fork_name: str) -> int | None:
        return {
            "phase0": 0,
            "altair": self.altair_fork_epoch,
            "bellatrix": self.bellatrix_fork_epoch,
        }[fork_name]

    def fork_version_at_epoch(self, epoch: int) -> bytes:
        return self.fork_version_for(self.fork_name_at_epoch(epoch))

    def to_api_dict(self, preset=None) -> dict:
        """Beacon-API ``/eth/v1/config/spec`` shape: UPPER_SNAKE keys,
        stringified ints, 0x-hex bytes (reference serde of ChainSpec +
        preset into one flat map)."""
        import dataclasses

        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            key = f.name.upper()
            if isinstance(v, bytes):
                out[key] = "0x" + v.hex()
            elif isinstance(v, bool):
                out[key] = str(int(v))
            elif v is None:
                continue
            else:
                out[key] = str(v)
        if preset is not None:
            for name in dir(preset):
                if name.isupper():
                    out[name] = str(getattr(preset, name))
        return out


def mainnet_spec() -> ChainSpec:
    return ChainSpec()


def gnosis_spec() -> ChainSpec:
    """Gnosis chain (reference GnosisEthSpec + gnosis network config):
    mainnet preset values with 5-second slots and its own fork schedule."""
    return ChainSpec(
        config_name="gnosis",
        preset_base="mainnet",
        seconds_per_slot=5,
        genesis_fork_version=bytes([0, 0, 0, 0x64]),
        altair_fork_version=bytes([1, 0, 0, 0x64]),
        altair_fork_epoch=512,
        bellatrix_fork_version=bytes([2, 0, 0, 0x64]),
        bellatrix_fork_epoch=385536,
        min_genesis_time=1638968400,
        min_genesis_active_validator_count=4096,
        churn_limit_quotient=4096,
        deposit_chain_id=100,
        deposit_network_id=100,
        seconds_per_eth1_block=6,
        eth1_follow_distance=1024,
    )


def minimal_spec(**overrides) -> ChainSpec:
    """Minimal-preset test spec (forks at genesis unless overridden)."""
    base = ChainSpec(
        config_name="minimal",
        preset_base="minimal",
        min_genesis_active_validator_count=64,
        seconds_per_slot=6,
        genesis_fork_version=bytes([0, 0, 0, 1]),
        altair_fork_version=bytes([1, 0, 0, 1]),
        altair_fork_epoch=None,
        bellatrix_fork_version=bytes([2, 0, 0, 1]),
        bellatrix_fork_epoch=None,
        shard_committee_period=64,
        eth1_follow_distance=16,
        churn_limit_quotient=32,
    )
    return replace(base, **overrides) if overrides else base
