"""Public BLS API of the port: keys, signatures, signature sets, and the
batch verification entry point.

Wrapper types carry both the serialized bytes and the decompressed point.
Deserialization follows the consensus rules:

* public keys: 48 bytes, must decompress onto the curve, subgroup-checked,
  infinity rejected;
* signatures: 96 bytes, the all-zero encoding (flags ``0xC0``) is the valid
  "empty" (infinity) signature. Decompression is lazy: the device backend
  ships the compressed x to the card and decompresses there.

There is one backend, :class:`~.device.bls.CudaBackend`; no registry.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .cpu.curve import G1Point, G2Point, g1_generator
from .cpu.hash_to_curve import hash_to_g2
from .params import P as P_MOD, DST, PUBLIC_KEY_BYTES, R, SECRET_KEY_BYTES, SIGNATURE_BYTES

INFINITY_SIGNATURE = bytes([0xC0] + [0] * 95)


class BlsError(ValueError):
    pass


class PublicKey:
    """A decompressed, subgroup-checked G1 public key."""

    __slots__ = ("point", "_bytes")

    def __init__(self, point: G1Point, raw: Optional[bytes] = None):
        self.point = point
        self._bytes = raw

    @classmethod
    def deserialize(cls, data: bytes) -> "PublicKey":
        if len(data) != PUBLIC_KEY_BYTES:
            raise BlsError(f"invalid pubkey length {len(data)}")
        try:
            point = G1Point.decompress(data)
        except ValueError as e:
            raise BlsError(str(e)) from e
        if point.is_infinity():
            raise BlsError("infinity public key is invalid")
        if not point.in_subgroup():
            raise BlsError("public key not in subgroup")
        return cls(point, bytes(data))

    def serialize(self) -> bytes:
        if self._bytes is None:
            self._bytes = self.point.compress()
        return self._bytes

    def __eq__(self, o):
        return isinstance(o, PublicKey) and self.serialize() == o.serialize()

    def __hash__(self):
        return hash(self.serialize())

    def __repr__(self):
        return f"PublicKey(0x{self.serialize().hex()})"


def parse_compressed_g2_x(data: bytes) -> tuple[int, int, bool]:
    """Structural parse of a compressed G2 encoding -> (x0, x1,
    sign_larger). Validates length, compression flag and range; the
    on-curve check (the square root) is the device's business."""
    if len(data) != SIGNATURE_BYTES:
        raise BlsError(f"invalid signature length {len(data)}")
    data = bytes(data)
    flags = data[0] >> 5
    if not flags & 0x4:
        raise BlsError("uncompressed G2 encoding not supported")
    if flags & 0x2:
        raise BlsError("infinity encoding has no x")
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P_MOD or x1 >= P_MOD:
        raise BlsError("x out of range")
    return x0, x1, bool(flags & 0x1)


class Signature:
    """A G2 signature that keeps its compressed bytes; ``point`` is None
    for the "empty" (infinity) encoding.

    Decompression is LAZY: ``deserialize`` performs only the structural
    checks (length, flags, x range, infinity well-formedness) and defers
    the square root until ``point`` is touched. The device backend never
    touches it: it decompresses on the card, so an x that is not on the
    curve surfaces there as an invalid batch."""

    __slots__ = ("_point", "_bytes", "_decompressed")

    def __init__(self, point: Optional[G2Point] = None, raw: Optional[bytes] = None):
        self._point = point
        self._bytes = raw
        self._decompressed = point is not None or raw is None

    @property
    def point(self) -> Optional[G2Point]:
        if not self._decompressed:
            if bytes(self._bytes) == INFINITY_SIGNATURE:
                self._point = None
            else:
                try:
                    self._point = G2Point.decompress(self._bytes)
                except ValueError as e:
                    raise BlsError(str(e)) from e
            self._decompressed = True
        return self._point

    @classmethod
    def deserialize(cls, data: bytes) -> "Signature":
        if len(data) != SIGNATURE_BYTES:
            raise BlsError(f"invalid signature length {len(data)}")
        data = bytes(data)
        if (data[0] >> 5) & 0x2:  # infinity must be the canonical encoding
            if data != INFINITY_SIGNATURE:
                raise BlsError("malformed infinity encoding")
            return cls(None, INFINITY_SIGNATURE)
        parse_compressed_g2_x(data)  # structural validation
        return cls(None, data)  # sqrt (on-curve check) deferred

    @classmethod
    def infinity(cls) -> "Signature":
        return cls(None, INFINITY_SIGNATURE)

    def serialize(self) -> bytes:
        if self._bytes is None:
            self._bytes = (
                INFINITY_SIGNATURE if self.point is None else self.point.compress()
            )
        return self._bytes

    def is_infinity(self) -> bool:
        if not self._decompressed and self._bytes is not None:
            return bytes(self._bytes) == INFINITY_SIGNATURE
        return self._point is None or self._point.is_infinity()

    def __eq__(self, o):
        return isinstance(o, Signature) and self.serialize() == o.serialize()

    def __hash__(self):
        return hash(self.serialize())

    def __repr__(self):
        return f"Signature(0x{self.serialize().hex()})"


class SecretKey:
    """A secret scalar with the host signer (pure Python, independent of
    the device hash-to-curve)."""

    __slots__ = ("k",)

    def __init__(self, k: int):
        if not 0 < k < R:
            raise BlsError("secret key out of range")
        self.k = k

    @classmethod
    def deserialize(cls, data: bytes) -> "SecretKey":
        if len(data) != SECRET_KEY_BYTES:
            raise BlsError("invalid secret key length")
        return cls(int.from_bytes(data, "big"))

    def serialize(self) -> bytes:
        return self.k.to_bytes(SECRET_KEY_BYTES, "big")

    def public_key(self) -> PublicKey:
        return PublicKey(g1_generator().mul(self.k))

    def sign(self, message: bytes) -> Signature:
        return Signature(hash_to_g2(bytes(message), DST).mul(self.k))


class SignatureSet:
    """A signature over one message by one or more public keys: the unit
    of batch verification."""

    __slots__ = ("signature", "signing_keys", "message")

    def __init__(
        self,
        signature: Signature,
        signing_keys: Sequence[PublicKey],
        message: bytes,
    ):
        if len(message) != 32:
            raise BlsError("message must be a 32-byte signing root")
        self.signature = signature
        self.signing_keys = list(signing_keys)
        self.message = bytes(message)


def verify_signature_sets(
    sets: Sequence[SignatureSet], device: str = "cuda"
) -> bool:
    """Batch-verify on the card; ``True`` iff every set verifies (modulo
    the standard 2^-64 random-linear-combination soundness).

    The backend receives the Signature objects, so the compressed bytes
    go to the device and are decompressed there. A malformed encoding is
    an ordinary invalid outcome, never an exception."""
    from .device.bls import CudaBackend

    sets = list(sets)
    prepared = [
        (s.signature, [pk.point for pk in s.signing_keys], s.message)
        for s in sets
    ]
    try:
        return CudaBackend(device=device).verify_signature_sets(prepared)
    except BlsError:
        return False


__all__ = [
    "BlsError",
    "DST",
    "INFINITY_SIGNATURE",
    "PublicKey",
    "SecretKey",
    "Signature",
    "SignatureSet",
    "parse_compressed_g2_x",
    "verify_signature_sets",
]
