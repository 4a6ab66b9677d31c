"""Fee-recipient preparation + builder registration (reference:
``validator_client/src/preparation_service.rs``).

Two duties, both idempotent and epoch-periodic:

* ``prepare_proposers`` — POST ``prepare_beacon_proposer`` with every
  known validator's fee recipient so the BN can pass it to the EL in
  ``forkchoice_updated`` payload attributes.
* ``register_validators`` — sign ``ValidatorRegistration`` messages with
  the application-builder domain and POST ``register_validator`` (the
  MEV-boost relay path; the BN forwards to its builder client).
"""

from __future__ import annotations

import time

from ..types.domains import compute_domain, compute_signing_root
from ..utils import metrics

_PREPARED = metrics.counter(
    "vc_preparation_sent_total", "prepare_beacon_proposer payloads sent"
)
_REGISTERED = metrics.counter(
    "vc_registrations_sent_total", "validator registrations sent"
)

# Spec DomainType 0x00000001 for the application builder (not a consensus
# domain — computed over the GENESIS fork with an empty
# genesis_validators_root). The repo encodes domain types as little-endian
# ints, so the byte string 00 00 00 01 is the int 0x01000000.
DOMAIN_APPLICATION_BUILDER = 0x01000000

DEFAULT_GAS_LIMIT = 30_000_000


class PreparationService:
    def __init__(
        self,
        store,
        nodes,
        preset,
        fee_recipient: bytes = b"\x00" * 20,
        per_validator: dict | None = None,
        gas_limit: int = DEFAULT_GAS_LIMIT,
    ):
        self.store = store
        self.nodes = nodes
        self.preset = preset
        self.fee_recipient = bytes(fee_recipient)
        self.per_validator = dict(per_validator or {})  # pubkey -> recipient
        self.gas_limit = gas_limit
        self._last_prepared_epoch = -1
        self._registered = False

    def fee_recipient_for(self, pubkey: bytes) -> bytes:
        return self.per_validator.get(bytes(pubkey), self.fee_recipient)

    def prepare_proposers(self, epoch: int) -> int:
        """Send (validator_index, fee_recipient) pairs; once per epoch."""
        if epoch == self._last_prepared_epoch:
            return 0
        prep = []
        for pk in self.store.pubkeys():
            vi = self.store.index_of(pk)
            if vi is None:
                continue
            prep.append(
                {
                    "validator_index": str(vi),
                    "fee_recipient": "0x" + self.fee_recipient_for(pk).hex(),
                }
            )
        if not prep:
            return 0
        self.nodes.call("prepare_beacon_proposer", prep)
        self._last_prepared_epoch = epoch
        _PREPARED.inc(len(prep))
        return len(prep)

    def register_validators(self) -> int:
        """Builder-path registrations, signed with the application-builder
        domain (reference ``signing_method.rs`` SignableMessage::
        ValidatorRegistration)."""
        domain = compute_domain(
            self.store.spec,
            DOMAIN_APPLICATION_BUILDER,
            self.store.spec.genesis_fork_version,
            b"\x00" * 32,
        )
        regs = []
        ts = int(time.time())
        for pk in self.store.pubkeys():
            message = {
                "fee_recipient": "0x" + self.fee_recipient_for(pk).hex(),
                "gas_limit": str(self.gas_limit),
                "timestamp": str(ts),
                "pubkey": "0x" + bytes(pk).hex(),
            }
            root = _registration_root(message, domain)
            try:
                sig = self.store._sign(bytes(pk), root)
            except KeyError:
                continue
            regs.append({"message": message, "signature": "0x" + sig.hex()})
        if not regs:
            return 0
        self.nodes.call("register_validator", regs)
        self._registered = True
        _REGISTERED.inc(len(regs))
        return len(regs)


def _registration_root(message: dict, domain: bytes) -> bytes:
    """hash_tree_root of the ValidatorRegistrationV1 container under the
    builder domain (fields: fee_recipient:Bytes20, gas_limit:u64,
    timestamp:u64, pubkey:Bytes48)."""
    from ..ssz import core as ssz
    from ..ssz.hash import hash_tree_root

    class _Registration(ssz.Container):
        fields = [
            ("fee_recipient", ssz.ByteVector(20)),
            ("gas_limit", ssz.Uint64),
            ("timestamp", ssz.Uint64),
            ("pubkey", ssz.Bytes48),
        ]

    reg = _Registration(
        fee_recipient=bytes.fromhex(message["fee_recipient"][2:]),
        gas_limit=int(message["gas_limit"]),
        timestamp=int(message["timestamp"]),
        pubkey=bytes.fromhex(message["pubkey"][2:]),
    )
    root = hash_tree_root(_Registration, reg)
    return compute_signing_root(None, root, domain)
