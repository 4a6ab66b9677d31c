"""EIP-2333 BLS key derivation + EIP-2334 paths (reference:
``crypto/eth2_key_derivation`` — ``derived_key.rs``,
``lamport_secret_key.rs``, ``path.rs``).

Tree-KDF: every node key derives 2^32 children via a Lamport-keyed HKDF
construction; validator keys live at EIP-2334 paths
``m/12381/3600/<account>/0/0`` (signing) / ``.../0`` (withdrawal).
"""

from __future__ import annotations

import hashlib
import hmac

from ..crypto.params import R

_SALT0 = b"BLS-SIG-KEYGEN-SALT-"


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    """RFC-style keygen: loop until nonzero mod r (EIP-2333 hkdf_mod_r)."""
    salt = _SALT0
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
    return sk


def _ikm_to_lamport_sk(ikm: bytes, salt: bytes) -> list[bytes]:
    okm = _hkdf_expand(_hkdf_extract(salt, ikm), b"", 255 * 32)
    return [okm[i * 32:(i + 1) * 32] for i in range(255)]


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    not_ikm = bytes(b ^ 0xFF for b in ikm)
    chunks = _ikm_to_lamport_sk(ikm, salt) + _ikm_to_lamport_sk(not_ikm, salt)
    return hashlib.sha256(
        b"".join(hashlib.sha256(c).digest() for c in chunks)
    ).digest()


def derive_master_sk(seed: bytes) -> int:
    if len(seed) < 32:
        raise ValueError("EIP-2333 seed must be >= 32 bytes")
    return hkdf_mod_r(seed)


def derive_child_sk(parent_sk: int, index: int) -> int:
    if not 0 <= index < 2**32:
        raise ValueError("child index out of range")
    return hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def parse_path(path: str) -> list[int]:
    """EIP-2334 path: ``m/12381/3600/<i>/0[/0]``."""
    parts = path.strip().split("/")
    if not parts or parts[0] != "m":
        raise ValueError(f"invalid EIP-2334 path {path!r}")
    out = []
    for p in parts[1:]:
        if not p.isdigit():
            raise ValueError(f"invalid path component {p!r}")
        out.append(int(p))
    return out


def derive_sk_at_path(seed: bytes, path: str) -> int:
    sk = derive_master_sk(seed)
    for index in parse_path(path):
        sk = derive_child_sk(sk, index)
    return sk


def validator_signing_path(account: int) -> str:
    return f"m/12381/3600/{account}/0/0"


def validator_withdrawal_path(account: int) -> str:
    return f"m/12381/3600/{account}/0"
