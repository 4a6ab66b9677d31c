"""Public BLS API of the port: keys, signatures, signature sets, and the
batch verification entry point.

Wrapper types carry both the serialized bytes and the decompressed point.
Deserialization follows the consensus rules:

* public keys: 48 bytes, must decompress onto the curve, subgroup-checked,
  infinity rejected;
* signatures: 96 bytes, the all-zero encoding (flags ``0xC0``) is the valid
  "empty" (infinity) signature. Decompression is lazy: the device backend
  ships the compressed x to the card and decompresses there.

A verifying call that names a ``device`` builds a
:class:`~.device.bls.CudaBackend` there. A call without one goes through
the backend registry (``crypto/backend.py``: ``cuda``, the default, ``cpu``,
``cpu-native`` and ``fake``), as every call of the JAX package's API does.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional, Sequence

from . import backend as _backend_mod
from .cpu.curve import G1Point, G2Point, g1_generator
from .cpu.fields import Fq, Fq2
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
        # Fast path through the C library when a toolchain exists (a
        # pure-Python subgroup check is ~0.2 s a key: a mainnet registry
        # would take hours to admit), as the JAX package's SecretKey
        # does for its signer; a key the C check refuses takes the oracle
        # path below, which raises the oracle's error.
        xy = _native_pubkey_xy(bytes(data))
        if xy is not None:
            return cls(G1Point(Fq(xy[0]), Fq(xy[1])), bytes(data))
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


def _native_pubkey_xy(data: bytes):
    """(x, y) of a valid compressed G1 public key from the C library's
    KeyValidate (decompress, on-curve, subgroup, not infinity); None when
    the key is invalid or the library cannot be built."""
    try:
        from .native import lib

        out = (ctypes.c_uint8 * 96)()
        if lib().bls_g1_pubkey_check(data, out) != 1:
            return None
    except Exception:
        return None
    raw = bytes(out)
    return int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:], "big")


def _native_signature_point(data: bytes):
    """The G2 point of a compressed signature from the C library's
    decompression (the oracle's checks: flags, range, on the curve); None
    when it refuses the encoding or the library cannot be built."""
    try:
        from .native import lib

        out = (ctypes.c_uint8 * 192)()
        if lib().bls_g2_decompress(data, out) != 1:
            return None
    except Exception:
        return None
    raw = bytes(out)
    c0, c1, d0, d1 = (int.from_bytes(raw[i:i + 48], "big") for i in range(0, 192, 48))
    return G2Point(Fq2.from_ints(c0, c1), Fq2.from_ints(d0, d1))


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
                # through the C library when it builds (7 ms a signature
                # in pure Python: a 512-member sync aggregate would pay
                # 3.6 s); an encoding it refuses takes the oracle, which
                # raises the oracle's error
                point = _native_signature_point(bytes(self._bytes))
                if point is None:
                    try:
                        point = G2Point.decompress(self._bytes)
                    except ValueError as e:
                        raise BlsError(str(e)) from e
                self._point = point
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

    def point_or_infinity(self) -> G2Point:
        return G2Point.infinity() if self.point is None else self.point

    def is_infinity(self) -> bool:
        if not self._decompressed and self._bytes is not None:
            return bytes(self._bytes) == INFINITY_SIGNATURE
        return self._point is None or self._point.is_infinity()

    def verify(self, pk: PublicKey, message: bytes, device=None) -> bool:
        return _backend(device).verify(pk.point, message, self.point_or_infinity())

    def __eq__(self, o):
        return isinstance(o, Signature) and self.serialize() == o.serialize()

    def __hash__(self):
        return hash(self.serialize())

    def __repr__(self):
        return f"Signature(0x{self.serialize().hex()})"


class AggregateSignature(Signature):
    """A signature accumulating others by point addition (reference:
    generic_aggregate_signature.rs add_assign / add_assign_aggregate)."""

    @classmethod
    def infinity(cls) -> "AggregateSignature":
        return cls(None, INFINITY_SIGNATURE)

    def add_assign(self, other: Signature) -> None:
        if other.point is None:
            return
        if self.point is None:
            self._point = other.point
        else:
            self._point = self.point + other.point
        self._decompressed = True
        self._bytes = None

    def fast_aggregate_verify(
        self, message: bytes, pks: Sequence[PublicKey], device=None
    ) -> bool:
        if not pks:
            return False
        return _backend(device).fast_aggregate_verify(
            [pk.point for pk in pks], message, self.point_or_infinity()
        )

    def aggregate_verify(
        self, messages: Sequence[bytes], pks: Sequence[PublicKey],
        device=None,
    ) -> bool:
        if not pks or len(pks) != len(messages):
            return False
        return _backend(device).aggregate_verify(
            [pk.point for pk in pks], list(messages), self.point_or_infinity()
        )


class SecretKey:
    """A secret scalar with the host signer (the C library, else the
    pure-Python oracle; both independent of the device hash-to-curve)."""

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
        signer = _native_signer()
        if signer is None:
            return PublicKey(g1_generator().mul(self.k))
        x, y = signer.native_sk_to_pk_xy(self.k)
        return PublicKey(G1Point(Fq(x), Fq(y)))

    def sign(self, message: bytes) -> Signature:
        signer = _native_signer()
        if signer is None:
            return Signature(hash_to_g2(bytes(message), DST).mul(self.k))
        return Signature.deserialize(signer.native_sign(self.k, bytes(message)))


_signer_loaded = False
_signer = None


def _native_signer():
    """The C library's module (``native``) for :class:`SecretKey`, or None
    when it cannot be built or loaded: decided once, the fallback to the
    pure-Python oracle logged once. The C signer is the JAX package's
    too: a validator client signs dozens of messages a slot, and the
    oracle takes 0.14 s a signature, the C one about 2 ms."""
    global _signer, _signer_loaded
    if not _signer_loaded:
        from .. import _native as native_build
        from . import native

        try:
            native.lib()
            _signer = native
        except (native_build.NativeBuildError, native.NativeUnavailable, OSError) as e:
            logging.getLogger(__name__).warning(
                "BLS signer: the C library is unavailable, the pure-Python oracle "
                "signs (%s)", str(e).splitlines()[0] if str(e) else e)
        _signer_loaded = True
    return _signer


class SignatureSet:
    """A signature over one message by one or more public keys: the unit
    of batch verification (reference: generic_signature_set.rs).

    ``signing_indices`` optionally carries the validator indices the keys
    were resolved at: the key table's ``covers_sets`` uses them as a fast
    pre-filter. They are advisory: the backend resolves keys by the
    identity of the host cache's own point objects, so a stale or foreign
    index can cost a raw-plane fallback, never a wrong-key verification."""

    __slots__ = ("signature", "signing_keys", "message", "signing_indices")

    def __init__(
        self,
        signature: Signature,
        signing_keys: Sequence[PublicKey],
        message: bytes,
        signing_indices: Optional[Sequence[int]] = None,
    ):
        if len(message) != 32:
            raise BlsError("message must be a 32-byte signing root")
        self.signature = signature
        self.signing_keys = list(signing_keys)
        self.message = bytes(message)
        if signing_indices is not None:
            signing_indices = [int(i) for i in signing_indices]
            if len(signing_indices) != len(self.signing_keys):
                raise BlsError("signing_indices must match signing_keys one-to-one")
        self.signing_indices = signing_indices

    @classmethod
    def single_pubkey(
        cls, signature: Signature, signing_key: PublicKey, message: bytes,
        signing_index: Optional[int] = None,
    ) -> "SignatureSet":
        return cls(signature, [signing_key], message,
                   None if signing_index is None else [signing_index])

    @classmethod
    def multiple_pubkeys(
        cls, signature: Signature, signing_keys: Sequence[PublicKey],
        message: bytes, signing_indices: Optional[Sequence[int]] = None,
    ) -> "SignatureSet":
        return cls(signature, signing_keys, message, signing_indices)

    def verify(self, device=None) -> bool:
        """Verify just this set (fast_aggregate_verify)."""
        return AggregateSignature(
            self.signature.point, self.signature.serialize()
        ).fast_aggregate_verify(self.message, self.signing_keys, device=device)


def _backend(device):
    """The backend a verifying call runs on: a ``CudaBackend`` on the
    device the caller names, else the registry's active one."""
    if device is None:
        return _backend_mod.active()
    from .device.bls import CudaBackend

    return CudaBackend(device=device)


def verify_signature_sets(sets: Sequence[SignatureSet], device=None) -> bool:
    """Batch-verify; ``True`` iff every set verifies (modulo the standard
    2^-64 random-linear-combination soundness).

    The backend receives the Signature objects, so the device backend
    ships the compressed bytes and decompresses on the card. A malformed
    encoding is an ordinary invalid outcome, never an exception. Without
    a ``device`` the registry's backend decides, after the JAX API's
    pre-screens: an empty batch, and a batch with an "empty" (infinity)
    signature, fail before reaching any backend (reference:
    ``blst.rs:77-83``)."""
    sets = list(sets)
    if device is None and (
        not sets or any(s.signature.is_infinity() for s in sets)
    ):
        return False
    prepared = [
        (s.signature, [pk.point for pk in s.signing_keys], s.message)
        for s in sets
    ]
    try:
        return _backend(device).verify_signature_sets(prepared)
    except BlsError:
        return False


__all__ = [
    "AggregateSignature",
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
