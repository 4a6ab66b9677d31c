"""Backend ``"cpu-native"``: the C BLS12-381 verifier
(``lighthouse_tpu_torch/_native/bls12381.c``), the port's host verifier.

The port's copy of the JAX package's ``crypto/native.py``. The compile
service serves shed flushes through it (``CompileService.fallback_verify``)
while a cold rung's graphs are captured, and the tests hold the device
verdicts against it.

Signatures cross the FFI boundary in their compressed wire form (the C
side decompresses, curve- and subgroup-checks); public keys cross as raw
affine coordinates because they were already decompressed and
KeyValidate'd at admission.
"""

from __future__ import annotations

import ctypes
import secrets

from .params import DST


class NativeUnavailable(RuntimeError):
    pass


_lib = None
_lib_error: Exception | None = None


def lib() -> ctypes.CDLL:
    global _lib, _lib_error
    if _lib_error is not None:
        raise _lib_error  # build/selftest failure is permanent per process
    if _lib is None:
        try:
            return _load()
        except Exception as e:
            _lib_error = e
            raise
    return _lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import _native

        handle = _native.build_and_load("bls12381")
        handle.bls_verify_signature_sets.restype = ctypes.c_int
        handle.bls_aggregate_verify.restype = ctypes.c_int
        handle.bls_g1_pubkey_check.restype = ctypes.c_int
        handle.bls_hash_to_g2.restype = ctypes.c_int
        handle.bls_sign.restype = ctypes.c_int
        handle.bls_sk_to_pk.restype = ctypes.c_int
        handle.bls_selftest.restype = ctypes.c_int
        if handle.bls_selftest() != 1:
            raise NativeUnavailable("bls12381.c selftest failed")
        _lib = handle
    return _lib


def _pk_raw(point) -> bytes:
    """The port's host G1 point (``cpu.curve.G1Point``) -> 96 raw
    big-endian bytes (x || y)."""
    return point.x.n.to_bytes(48, "big") + point.y.n.to_bytes(48, "big")


def _sig_compressed(sig) -> bytes | None:
    """The port's ``bls.Signature`` or a bare ``G2Point`` -> compressed
    bytes; None for a structurally invalid input (treated as a
    verification failure)."""
    from . import bls as _bls

    if isinstance(sig, _bls.Signature):
        return bytes(sig.serialize())
    try:
        return bytes(sig.compress())
    except Exception:
        return None


def _rand8() -> bytes:
    while True:
        r = secrets.token_bytes(8)
        if any(r):
            return r


def native_sk_to_pk_xy(sk_int: int) -> tuple[int, int]:
    """[sk] g1 as affine (x, y) ints via the C library."""
    out = (ctypes.c_uint8 * 96)()
    rc = lib().bls_sk_to_pk(sk_int.to_bytes(32, "big"), out)
    if rc != 1:
        raise NativeUnavailable("bls_sk_to_pk failed")
    raw = bytes(out)
    return int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:], "big")


def native_sign(sk_int: int, signing_root: bytes) -> bytes:
    """[sk] H(root) as compressed bytes via the C library: a fast signer
    for workload generation."""
    out = (ctypes.c_uint8 * 96)()
    rc = lib().bls_sign(
        sk_int.to_bytes(32, "big"), bytes(signing_root), len(signing_root),
        DST, len(DST), out,
    )
    if rc != 1:
        raise NativeUnavailable("bls_sign failed")
    return bytes(out)


class NativeBackend:
    """Host backend ``"cpu-native"``: the same methods as ``CudaBackend``
    (``verify_signature_sets`` over ``(signature, [G1Point], message)``
    triples, ``verify``, ``fast_aggregate_verify``, ``aggregate_verify``)."""

    name = "cpu-native"

    def __init__(self):
        lib()  # build + selftest at construction, not first verify

    # -- batch verification (the hot path) -------------------------------

    def verify_signature_sets(self, sets) -> bool:
        from . import bls as _bls

        sets = list(sets)
        if not sets:
            return False
        sigs = []
        pk_parts = []
        counts = []
        msgs = []
        try:
            for sig, pks, msg in sets:
                pks = list(pks)
                if not pks:
                    return False
                if isinstance(sig, _bls.Signature) and sig.is_infinity():
                    return False
                comp = _sig_compressed(sig)
                if comp is None:
                    return False
                for pk in pks:
                    if pk.is_infinity():
                        return False
                    pk_parts.append(_pk_raw(pk))
                sigs.append(comp)
                counts.append(len(pks))
                msgs.append(bytes(msg))
        except _bls.BlsError:
            return False
        n = len(sets)
        c_counts = (ctypes.c_uint32 * n)(*counts)
        rands = b"".join(_rand8() for _ in range(n))
        rc = lib().bls_verify_signature_sets(
            n,
            b"".join(sigs),
            b"".join(pk_parts),
            c_counts,
            b"".join(msgs),
            rands,
            DST,
            len(DST),
        )
        return rc == 1

    # -- single-set entry points -----------------------------------------

    def verify(self, pk, message, sig) -> bool:
        if pk.is_infinity():
            return False
        return self.verify_signature_sets([(sig, [pk], message)])

    def fast_aggregate_verify(self, pks, message, sig) -> bool:
        pks = list(pks)
        if not pks:
            return False
        return self.verify_signature_sets([(sig, pks, message)])

    def aggregate_verify(self, pks, messages, sig) -> bool:
        pks, messages = list(pks), list(messages)
        if not pks or len(pks) != len(messages):
            return False
        if any(pk.is_infinity() for pk in pks):
            return False
        comp = _sig_compressed(sig)
        if comp is None:
            return False
        rc = lib().bls_aggregate_verify(
            len(pks),
            comp,
            b"".join(_pk_raw(pk) for pk in pks),
            b"".join(bytes(m) for m in messages),
            DST,
            len(DST),
        )
        return rc == 1
