"""Key management: EIP-2333 derivation, EIP-2335 keystores, EIP-2386
wallets, EIP-3076 slashing protection.

Reference: ``crypto/eth2_key_derivation``, ``crypto/eth2_keystore``,
``crypto/eth2_wallet``, ``validator_client/slashing_protection``.
"""

from .derivation import (
    derive_child_sk,
    derive_master_sk,
    derive_sk_at_path,
    hkdf_mod_r,
    parse_path,
    validator_signing_path,
    validator_withdrawal_path,
)
from .keystore import KeystoreError, decrypt, encrypt, load, save
from .slashing_protection import SlashingDatabase, SlashingProtectionError
from .wallet import Wallet, WalletError

__all__ = [
    "KeystoreError",
    "SlashingDatabase",
    "SlashingProtectionError",
    "Wallet",
    "WalletError",
    "decrypt",
    "derive_child_sk",
    "derive_master_sk",
    "derive_sk_at_path",
    "encrypt",
    "hkdf_mod_r",
    "load",
    "parse_path",
    "save",
    "validator_signing_path",
    "validator_withdrawal_path",
]
