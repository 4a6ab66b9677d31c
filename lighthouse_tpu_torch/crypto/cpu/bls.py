"""min_pk BLS signatures over the pure-Python stack (scheme layer).

Implements the eth2 ciphersuite ``BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_``
with the exact batch-verification semantics of the reference's blst backend
(reference: ``crypto/bls/src/impls/blst.rs:36-119``):

* empty batch => False
* per-set 64-bit nonzero random scalar (random linear combination)
* signature subgroup-checked; "empty" signature => False
* a set with no signing keys => False
* one multi-pairing over all sets decides the batch
"""

from __future__ import annotations

import secrets
from typing import Callable, Iterable, Sequence

from ..params import DST, R
from .curve import G1Point, G2Point, g1_generator
from .fields import Fq12
from .hash_to_curve import hash_to_g2
from .pairing import multi_pairing


def sk_to_pk(sk: int) -> G1Point:
    return g1_generator().mul(sk % R)


def sign(sk: int, message: bytes, dst: bytes = DST) -> G2Point:
    return hash_to_g2(message, dst).mul(sk % R)


def verify(pk: G1Point, message: bytes, sig: G2Point, dst: bytes = DST) -> bool:
    """Single-signature verification: e(pk, H(m)) == e(g1, sig)."""
    if pk.is_infinity() or not pk.in_subgroup():
        return False
    if not sig.is_on_curve() or not sig.in_subgroup():
        return False
    h = hash_to_g2(message, dst)
    return multi_pairing([(pk, h), (-g1_generator(), sig)]) == Fq12.one()


def aggregate(sigs: Sequence[G2Point]) -> G2Point:
    acc = G2Point.infinity()
    for s in sigs:
        acc = acc + s
    return acc


def aggregate_pubkeys(pks: Sequence[G1Point]) -> G1Point:
    acc = G1Point.infinity()
    for p in pks:
        acc = acc + p
    return acc


def fast_aggregate_verify(
    pks: Sequence[G1Point], message: bytes, sig: G2Point, dst: bytes = DST
) -> bool:
    """All pubkeys signed the same message (reference:
    generic_aggregate_signature.rs fast_aggregate_verify; empty pubkeys =>
    False per the generic wrapper)."""
    if not pks:
        return False
    return verify(aggregate_pubkeys(pks), message, sig, dst)


def aggregate_verify(
    pks: Sequence[G1Point], messages: Sequence[bytes], sig: G2Point, dst: bytes = DST
) -> bool:
    """Each pubkey signed its own message."""
    if not pks or len(pks) != len(messages):
        return False
    if any(pk.is_infinity() or not pk.in_subgroup() for pk in pks):
        return False
    if not sig.is_on_curve() or not sig.in_subgroup():
        return False
    pairs = [(pk, hash_to_g2(msg, dst)) for pk, msg in zip(pks, messages)]
    pairs.append((-g1_generator(), sig))
    return multi_pairing(pairs) == Fq12.one()


def _default_rand() -> int:
    # 64-bit nonzero scalar, as in blst.rs:47-67 (RAND_BITS = 64).
    while True:
        r = secrets.randbits(64)
        if r != 0:
            return r


def verify_signature_sets(
    sets: Iterable[tuple[G2Point, Sequence[G1Point], bytes]],
    dst: bytes = DST,
    rand_fn: Callable[[], int] = _default_rand,
) -> bool:
    """Batch verification by random linear combination.

    ``sets`` yields (signature_point, signing_keys, message). Checks:
      prod_i e(r_i * agg_pk_i, H(m_i)) * e(-g1, sum_i r_i * sig_i) == 1
    """
    sets = list(sets)
    if not sets:
        return False

    pairs = []
    sig_acc = G2Point.infinity()
    for sig, pks, msg in sets:
        # "Empty"/infinity signatures fail the batch outright (blst.rs:77-83).
        if sig.is_infinity():
            return False
        if not sig.is_on_curve() or not sig.in_subgroup():
            return False
        if not pks:
            return False
        # Individual pubkeys are expected to be deserialization-checked
        # (subgroup, non-infinity) as in the reference; re-reject infinity
        # cheaply as defense in depth.
        if any(pk.is_infinity() for pk in pks):
            return False
        r = rand_fn()
        agg_pk = aggregate_pubkeys(pks)
        pairs.append((agg_pk.mul(r), hash_to_g2(msg, dst)))
        sig_acc = sig_acc + sig.mul(r)
    pairs.append((-g1_generator(), sig_acc))
    return multi_pairing(pairs) == Fq12.one()
