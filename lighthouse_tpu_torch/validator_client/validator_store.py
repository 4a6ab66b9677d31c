"""ValidatorStore: decrypted keys + slashing-protected signing (reference:
``validator_client/src/validator_store.rs`` + ``signing_method.rs`` —
every signature passes through the slashing DB first).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from ..crypto import bls
from ..keys import SlashingDatabase, SlashingProtectionError, decrypt
from ..ssz import Uint64, hash_tree_root
from ..types.chain_spec import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
)
from ..types.domains import compute_domain, compute_signing_root


@dataclass
class InitializedValidator:
    """A loaded, enabled validator (reference initialized_validators.rs +
    ``signing_method.rs:78-89``: LocalKeystore vs Web3Signer)."""

    pubkey: bytes
    secret_key: Optional[bls.SecretKey] = None  # LocalKeystore
    remote_signer: Optional[object] = None      # Web3Signer client
    index: Optional[int] = None  # validator index once known on-chain
    enabled: bool = True


class ValidatorStore:
    def __init__(
        self,
        spec,
        preset,
        types,
        genesis_validators_root: bytes,
        slashing_db: SlashingDatabase | None = None,
    ):
        self.spec = spec
        self.preset = preset
        self.t = types
        self.genesis_validators_root = genesis_validators_root
        self.slashing_db = slashing_db or SlashingDatabase(
            genesis_validators_root=genesis_validators_root
        )
        self._validators: dict[bytes, InitializedValidator] = {}
        self._lock = threading.Lock()

    # -- key management --------------------------------------------------

    def add_secret_key(self, sk: bls.SecretKey) -> bytes:
        pk = sk.public_key().serialize()
        with self._lock:
            self._validators[pk] = InitializedValidator(pk, secret_key=sk)
        self.slashing_db.register_validator(pk)
        return pk

    def add_remote_key(self, pubkey: bytes, signer) -> bytes:
        """Web3Signer-style remote signing (reference
        ``signing_method.rs`` Web3Signer variant): the private key never
        enters this process. Refuses to replace an existing validator
        (a silent signing-method swap would drop a local secret key)."""
        pubkey = bytes(pubkey)
        if len(pubkey) != 48:
            raise ValueError(f"pubkey must be 48 bytes, got {len(pubkey)}")
        with self._lock:
            if pubkey in self._validators:
                raise ValueError("duplicate: validator already loaded")
            self._validators[pubkey] = InitializedValidator(
                pubkey, remote_signer=signer
            )
        self.slashing_db.register_validator(pubkey)
        return pubkey

    def add_keystore(self, keystore: dict, password: str) -> bytes:
        sk_bytes = decrypt(keystore, password)
        return self.add_secret_key(
            bls.SecretKey(int.from_bytes(sk_bytes, "big"))
        )

    def remove(self, pubkey: bytes) -> bool:
        with self._lock:
            return self._validators.pop(pubkey, None) is not None

    def has(self, pubkey: bytes) -> bool:
        with self._lock:
            return bytes(pubkey) in self._validators

    def is_local(self, pubkey: bytes) -> bool:
        with self._lock:
            v = self._validators.get(bytes(pubkey))
        return v is not None and v.secret_key is not None

    def remote_url(self, pubkey: bytes) -> str:
        with self._lock:
            v = self._validators.get(bytes(pubkey))
        signer = getattr(v, "remote_signer", None) if v else None
        return getattr(signer, "base", "") if signer else ""

    def pubkeys(self) -> list[bytes]:
        with self._lock:
            return [p for p, v in self._validators.items() if v.enabled]

    def set_index(self, pubkey: bytes, index: int) -> None:
        with self._lock:
            if pubkey in self._validators:
                self._validators[pubkey].index = index

    def index_of(self, pubkey: bytes) -> Optional[int]:
        with self._lock:
            v = self._validators.get(pubkey)
            return v.index if v else None

    def _sign(self, pubkey: bytes, signing_root: bytes) -> bytes:
        """Signature bytes via the validator's signing method."""
        with self._lock:
            v = self._validators.get(pubkey)
        if v is None or not v.enabled:
            raise KeyError(f"unknown/disabled validator {pubkey.hex()[:12]}")
        if v.secret_key is not None:
            return v.secret_key.sign(signing_root).serialize()
        return v.remote_signer.sign(pubkey, signing_root)

    # -- domains ---------------------------------------------------------

    def _domain(self, domain_type: int, epoch: int) -> bytes:
        version = self.spec.fork_version_at_epoch(epoch)
        return compute_domain(
            self.spec, domain_type, version, self.genesis_validators_root
        )

    # -- signing (every path slashing-protected where applicable) --------

    def sign_block(self, pubkey: bytes, block):
        epoch = block.slot // self.preset.SLOTS_PER_EPOCH
        domain = self._domain(DOMAIN_BEACON_PROPOSER, epoch)
        root = compute_signing_root(type(block), block, domain)
        self.slashing_db.check_and_insert_block_proposal(
            pubkey, block.slot, root
        )
        sig = self._sign(pubkey, root)
        fork = self.spec.fork_name_at_epoch(epoch)
        return self.t.signed_block[fork](message=block, signature=sig)

    def sign_attestation(self, pubkey: bytes, data):
        domain = self._domain(DOMAIN_BEACON_ATTESTER, data.target.epoch)
        root = compute_signing_root(type(data), data, domain)
        self.slashing_db.check_and_insert_attestation(
            pubkey, data.source.epoch, data.target.epoch, root
        )
        return self._sign(pubkey, root)

    def randao_reveal(self, pubkey: bytes, epoch: int) -> bytes:
        domain = self._domain(DOMAIN_RANDAO, epoch)
        root = compute_signing_root(Uint64, epoch, domain)
        return self._sign(pubkey, root)

    def selection_proof(self, pubkey: bytes, slot: int) -> bytes:
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        domain = self._domain(DOMAIN_SELECTION_PROOF, epoch)
        root = compute_signing_root(Uint64, slot, domain)
        return self._sign(pubkey, root)

    def sign_aggregate_and_proof(self, pubkey: bytes, aggregate_and_proof):
        epoch = aggregate_and_proof.aggregate.data.target.epoch
        domain = self._domain(DOMAIN_AGGREGATE_AND_PROOF, epoch)
        root = compute_signing_root(
            type(aggregate_and_proof), aggregate_and_proof, domain
        )
        return self.t.SignedAggregateAndProof(
            message=aggregate_and_proof,
            signature=self._sign(pubkey, root),
        )

    def sign_sync_committee_message(
        self, pubkey: bytes, slot: int, block_root: bytes
    ) -> bytes:
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        domain = self._domain(DOMAIN_SYNC_COMMITTEE, epoch)
        root = compute_signing_root(None, bytes(block_root), domain)
        return self._sign(pubkey, root)

    def sign_sync_selection_proof(
        self, pubkey: bytes, slot: int, subcommittee_index: int
    ) -> bytes:
        """Selection proof over SyncAggregatorSelectionData (reference
        ``sync_committee_service.rs`` aggregation duty)."""
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        domain = self._domain(DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch)
        data = self.t.SyncAggregatorSelectionData(
            slot=slot, subcommittee_index=subcommittee_index
        )
        root = compute_signing_root(
            self.t.SyncAggregatorSelectionData, data, domain
        )
        return self._sign(pubkey, root)

    def sign_contribution_and_proof(self, pubkey: bytes, message):
        """Sign a ContributionAndProof -> SignedContributionAndProof."""
        epoch = int(message.contribution.slot) // self.preset.SLOTS_PER_EPOCH
        domain = self._domain(DOMAIN_CONTRIBUTION_AND_PROOF, epoch)
        root = compute_signing_root(self.t.ContributionAndProof, message, domain)
        return self.t.SignedContributionAndProof(
            message=message, signature=self._sign(pubkey, root)
        )

    def sign_voluntary_exit(self, pubkey: bytes, exit_msg):
        domain = self._domain(DOMAIN_VOLUNTARY_EXIT, exit_msg.epoch)
        root = compute_signing_root(type(exit_msg), exit_msg, domain)
        return self.t.SignedVoluntaryExit(
            message=exit_msg, signature=self._sign(pubkey, root)
        )
