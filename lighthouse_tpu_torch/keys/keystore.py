"""EIP-2335 keystores (reference: ``crypto/eth2_keystore`` —
``keystore.rs``, ``json_keystore/``): password-encrypted BLS secret keys.

crypto modules: kdf = scrypt (default) or pbkdf2-hmac-sha256; checksum =
sha256(dk[16:32] || ciphertext); cipher = aes-128-ctr keyed by dk[:16].
Passwords are NFKD-normalized with C0/C1 control codepoints stripped, per
the EIP (same rule the reference implements). The port's copy of the JAX
package's ``keystore.py``: AES-128-CTR is the port's own
(``utils/crypto.py``); scrypt and pbkdf2 are ``hashlib``'s.
"""

from __future__ import annotations

import hashlib
import json
import secrets
import unicodedata
import uuid as uuid_mod

from ..utils.crypto import aes128_ctr


class KeystoreError(ValueError):
    pass


def normalize_password(password: str) -> bytes:
    norm = unicodedata.normalize("NFKD", password)
    stripped = "".join(
        c for c in norm
        if not (0x00 <= ord(c) <= 0x1F or 0x7F <= ord(c) <= 0x9F)
    )
    return stripped.encode("utf-8")


def _derive_key(password: bytes, kdf: dict) -> bytes:
    params = kdf["params"]
    salt = bytes.fromhex(params["salt"])
    if kdf["function"] == "scrypt":
        return hashlib.scrypt(
            password,
            salt=salt,
            n=params["n"],
            r=params["r"],
            p=params["p"],
            dklen=params["dklen"],
            maxmem=256 * 1024 * 1024,
        )
    if kdf["function"] == "pbkdf2":
        if params.get("prf", "hmac-sha256") != "hmac-sha256":
            raise KeystoreError("unsupported prf")
        return hashlib.pbkdf2_hmac(
            "sha256", password, salt, params["c"], params["dklen"]
        )
    raise KeystoreError(f"unsupported kdf {kdf['function']!r}")


def encrypt(
    secret: bytes,
    password: str,
    path: str = "",
    kdf: str = "scrypt",
    pubkey: bytes | None = None,
    description: str = "",
    kdf_work: int | None = None,
) -> dict:
    """-> EIP-2335 keystore JSON object. ``kdf_work`` overrides the work
    parameter (scrypt n / pbkdf2 c) — tests use small values."""
    pw = normalize_password(password)
    salt = secrets.token_bytes(32)
    if kdf == "scrypt":
        kdf_module = {
            "function": "scrypt",
            "params": {
                "dklen": 32,
                "n": kdf_work or 262144,
                "r": 8,
                "p": 1,
                "salt": salt.hex(),
            },
            "message": "",
        }
    elif kdf == "pbkdf2":
        kdf_module = {
            "function": "pbkdf2",
            "params": {
                "dklen": 32,
                "c": kdf_work or 262144,
                "prf": "hmac-sha256",
                "salt": salt.hex(),
            },
            "message": "",
        }
    else:
        raise KeystoreError(f"unsupported kdf {kdf!r}")

    dk = _derive_key(pw, kdf_module)
    iv = secrets.token_bytes(16)
    ciphertext = aes128_ctr(dk[:16], iv, secret)
    checksum = hashlib.sha256(dk[16:32] + ciphertext).digest()

    return {
        "crypto": {
            "kdf": kdf_module,
            "checksum": {
                "function": "sha256",
                "params": {},
                "message": checksum.hex(),
            },
            "cipher": {
                "function": "aes-128-ctr",
                "params": {"iv": iv.hex()},
                "message": ciphertext.hex(),
            },
        },
        "description": description,
        "pubkey": pubkey.hex() if pubkey else "",
        "path": path,
        "uuid": str(uuid_mod.uuid4()),
        "version": 4,
    }


def decrypt(keystore: dict, password: str) -> bytes:
    if keystore.get("version") != 4:
        raise KeystoreError("unsupported keystore version")
    crypto = keystore["crypto"]
    pw = normalize_password(password)
    dk = _derive_key(pw, crypto["kdf"])
    ciphertext = bytes.fromhex(crypto["cipher"]["message"])
    if crypto["checksum"]["function"] != "sha256":
        raise KeystoreError("unsupported checksum function")
    want = bytes.fromhex(crypto["checksum"]["message"])
    got = hashlib.sha256(dk[16:32] + ciphertext).digest()
    if got != want:
        raise KeystoreError("invalid password (checksum mismatch)")
    if crypto["cipher"]["function"] != "aes-128-ctr":
        raise KeystoreError("unsupported cipher")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    return aes128_ctr(dk[:16], iv, ciphertext)


def save(keystore: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(keystore, f, indent=2)


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)
