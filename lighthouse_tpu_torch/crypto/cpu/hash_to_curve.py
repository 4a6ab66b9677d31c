"""Hash-to-curve for G2 on the host: BLS12381G2_XMD:SHA-256_SSWU_RO_
(RFC 9380 §8.8.2).

Pipeline: expand_message_xmd(SHA-256) -> hash_to_field(Fp2, m=2, L=64) ->
simplified SWU on the 3-isogenous curve E2' -> 3-isogeny map
(``crypto/iso3_g2.py``) -> psi-based clear_cofactor (Budroni-Pintore,
RFC 9380 App. G.3). ``expand_message_xmd`` also feeds the device map
(``device/htc.messages_to_u``); ``hash_to_g2`` is the host signer's map,
independent of the device one, so a wrong device map fails verification
instead of agreeing with itself.
"""

from __future__ import annotations

import hashlib

from .. import iso3_g2
from ..params import ISO3_A, ISO3_B, ISO3_Z, P, X
from .curve import G2Point
from .fields import Fq2
from .pairing import psi, psi2

_A = Fq2.from_ints(*ISO3_A)
_B = Fq2.from_ints(*ISO3_B)
_Z = Fq2.from_ints(*ISO3_Z)

_X_NUM = [Fq2.from_ints(*c) for c in iso3_g2.X_NUM]
_X_DEN = [Fq2.from_ints(*c) for c in iso3_g2.X_DEN]
_Y_NUM = [Fq2.from_ints(*c) for c in iso3_g2.Y_NUM]
_Y_DEN = [Fq2.from_ints(*c) for c in iso3_g2.Y_DEN]


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 with H = SHA-256 (b=32, r=64)."""
    b_in_bytes = 32
    r_in_bytes = 64
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd bounds exceeded")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(r_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    prev = b1
    for i in range(2, ell + 1):
        prev = hashlib.sha256(
            bytes(a ^ b for a, b in zip(b0, prev)) + bytes([i]) + dst_prime
        ).digest()
        out.append(prev)
    return b"".join(out)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, dst: bytes, count: int) -> list[Fq2]:
    """RFC 9380 §5.2 with m=2, L=64."""
    length = 64
    uniform = expand_message_xmd(msg, dst, count * 2 * length)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(2):
            off = length * (j + i * 2)
            coeffs.append(int.from_bytes(uniform[off : off + length], "big") % P)
        out.append(Fq2.from_ints(*coeffs))
    return out


def map_to_curve_sswu(u: Fq2) -> tuple[Fq2, Fq2]:
    """Simplified SWU on E2' (RFC 9380 §6.6.2), returning an E2' point."""
    zu2 = _Z * u.square()
    tv1 = zu2.square() + zu2
    if tv1.is_zero():
        x1 = _B * (_Z * _A).inverse()
    else:
        x1 = (-_B) * _A.inverse() * (Fq2.one() + tv1.inverse())
    gx1 = (x1.square() + _A) * x1 + _B
    y = gx1.sqrt()
    if y is not None:
        x = x1
    else:
        x2 = zu2 * x1
        gx2 = (x2.square() + _A) * x2 + _B
        x, y = x2, gx2.sqrt()
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


def _horner(coeffs: list[Fq2], x: Fq2) -> Fq2:
    acc = Fq2.zero()
    for c in reversed(coeffs):
        acc = acc * x + c
    return acc


def iso3_map(x: Fq2, y: Fq2) -> G2Point:
    """Apply the 3-isogeny E2' -> E2."""
    x_out = _horner(_X_NUM, x) * _horner(_X_DEN, x).inverse()
    y_out = y * _horner(_Y_NUM, x) * _horner(_Y_DEN, x).inverse()
    return G2Point(x_out, y_out)


def clear_cofactor(p: G2Point) -> G2Point:
    """Budroni-Pintore: [X^2-X-1]P + [X-1]psi(P) + psi^2([2]P), equivalent to
    multiplication by the standard h_eff (RFC 9380 App. G.3)."""
    xp = p.mul(X)  # X is negative; AffinePoint.mul handles sign
    x2p = xp.mul(X)
    part1 = x2p - xp - p
    part2 = psi(xp - p)
    part3 = psi2(p.double())
    return part1 + part2 + part3


def hash_to_g2(msg: bytes, dst: bytes) -> G2Point:
    u0, u1 = hash_to_field_fq2(msg, dst, 2)
    q0 = iso3_map(*map_to_curve_sswu(u0))
    q1 = iso3_map(*map_to_curve_sswu(u1))
    return clear_cofactor(q0 + q1)
