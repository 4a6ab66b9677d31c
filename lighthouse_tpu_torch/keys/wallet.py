"""EIP-2386 hierarchical deterministic wallets (reference:
``crypto/eth2_wallet`` — ``wallet.rs``, ``validator_path.rs``).

A wallet is a password-encrypted seed (same crypto section as an EIP-2335
keystore) plus a ``nextaccount`` counter; validators are derived at
EIP-2334 paths ``m/12381/3600/<account>/0/0``.
"""

from __future__ import annotations

import secrets
import uuid as uuid_mod

from . import keystore as ks
from .derivation import derive_sk_at_path, validator_signing_path, validator_withdrawal_path


class WalletError(ValueError):
    pass


class Wallet:
    def __init__(self, json_obj: dict):
        self.json = json_obj

    # -- creation --------------------------------------------------------

    @classmethod
    def create(
        cls, name: str, password: str, seed: bytes | None = None,
        kdf_work: int | None = None,
    ) -> "Wallet":
        seed = seed or secrets.token_bytes(32)
        enc = ks.encrypt(seed, password, kdf_work=kdf_work)
        obj = {
            "crypto": enc["crypto"],
            "name": name,
            "nextaccount": 0,
            "type": "hierarchical deterministic",
            "uuid": str(uuid_mod.uuid4()),
            "version": 1,
        }
        return cls(obj)

    # -- properties ------------------------------------------------------

    @property
    def name(self) -> str:
        return self.json["name"]

    @property
    def nextaccount(self) -> int:
        return self.json["nextaccount"]

    def decrypt_seed(self, password: str) -> bytes:
        fake_store = {"crypto": self.json["crypto"], "version": 4}
        return ks.decrypt(fake_store, password)

    # -- key derivation --------------------------------------------------

    def next_validator(
        self, wallet_password: str, keystore_password: str,
        kdf_work: int | None = None,
    ) -> tuple[dict, dict]:
        """Derive the next validator's (signing keystore, withdrawal
        keystore) and bump ``nextaccount`` (reference
        ``wallet.rs`` ``next_validator``)."""
        from ..crypto import bls

        seed = self.decrypt_seed(wallet_password)
        account = self.json["nextaccount"]
        out = []
        for path_fn in (validator_signing_path, validator_withdrawal_path):
            path = path_fn(account)
            sk_int = derive_sk_at_path(seed, path)
            sk = bls.SecretKey(sk_int)
            out.append(
                ks.encrypt(
                    sk.serialize(),
                    keystore_password,
                    path=path,
                    pubkey=sk.public_key().serialize(),
                    kdf_work=kdf_work,
                )
            )
        self.json["nextaccount"] = account + 1
        return out[0], out[1]
