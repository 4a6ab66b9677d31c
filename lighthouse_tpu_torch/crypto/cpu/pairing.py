"""Optimal ate pairing on BLS12-381 on the host (oracle implementation),
and the psi endomorphism of E2.

Deliberately simple rather than fast: G2 points are untwisted into
E(Fq12) and the Miller loop uses affine line functions, so every formula
is the textbook one. It backs the pure-Python ``cpu`` backend
(``cpu/bls.py``, ``crypto/backend.py``). psi = twist . frobenius .
untwist collapses to coordinate-wise Fq2 maps, used by the host cofactor
clearing (``hash_to_curve.py``) and, as constants, by the device subgroup
check and cofactor clearing.
"""

from __future__ import annotations

from ..params import P, R, X
from .curve import G1Point, G2Point
from .fields import XI, Fq, Fq2, Fq12

# w^2 = v, w^6 = xi. Untwist: (x', y') on E2/Fq2 -> (x'/w^2, y'/w^3) on E/Fq12.
_W2_INV = Fq12.w().pow(2).inverse()
_W3_INV = Fq12.w().pow(3).inverse()

# psi = twist . frobenius . untwist collapses to coordinate-wise Fq2 maps:
#   psi(x, y) = (conj(x) * PSI_CX, conj(y) * PSI_CY)
# with PSI_CX = xi^-((p-1)/3), PSI_CY = xi^-((p-1)/2).
PSI_CX = XI.pow((P - 1) // 3).inverse()
PSI_CY = XI.pow((P - 1) // 2).inverse()


def psi(q: G2Point) -> G2Point:
    """Untwist-Frobenius-twist endomorphism on E2 (used for fast cofactor
    clearing and subgroup checks, RFC 9380 App. G.3 / Budroni-Pintore)."""
    if q.is_infinity():
        return q
    return G2Point(q.x.conjugate() * PSI_CX, q.y.conjugate() * PSI_CY)


def psi2(q: G2Point) -> G2Point:
    return psi(psi(q))


def _untwist(q: G2Point) -> tuple[Fq12, Fq12]:
    x = Fq12.from_fq2(q.x) * _W2_INV
    y = Fq12.from_fq2(q.y) * _W3_INV
    return x, y


def _embed_g1(p: G1Point) -> tuple[Fq12, Fq12]:
    return Fq12.from_fq(p.x), Fq12.from_fq(p.y)


def _line(t_xy, q_xy, at_xy) -> Fq12:
    """Evaluate the line through points T and Q (affine, in E(Fq12)) at the
    point ``at``. Handles T == Q (tangent) and T == -Q (vertical)."""
    (x1, y1), (x2, y2), (xt, yt) = t_xy, q_xy, at_xy
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inverse()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        three = Fq12.from_fq(Fq(3))
        two = Fq12.from_fq(Fq(2))
        m = three * x1.square() * (two * y1).inverse()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _add_affine(a_xy, b_xy):
    """Affine addition in E(Fq12); points are (x, y) tuples, no infinity."""
    (x1, y1), (x2, y2) = a_xy, b_xy
    if x1 == x2 and y1 == y2:
        three = Fq12.from_fq(Fq(3))
        two = Fq12.from_fq(Fq(2))
        m = three * x1.square() * (two * y1).inverse()
    else:
        m = (y2 - y1) * (x2 - x1).inverse()
    x3 = m.square() - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def miller_loop(p: G1Point, q: G2Point) -> Fq12:
    """f_{|X|,Q}(P), conjugated for the negative BLS parameter."""
    if p.is_infinity() or q.is_infinity():
        return Fq12.one()
    q12 = _untwist(q)
    p12 = _embed_g1(p)
    f = Fq12.one()
    t = q12
    for bit in bin(-X)[3:]:  # skip MSB
        f = f.square() * _line(t, t, p12)
        t = _add_affine(t, t)
        if bit == "1":
            f = f * _line(t, q12, p12)
            t = _add_affine(t, q12)
    # X < 0: f_{-|X|} = conj(f_{|X|}) in the final-exp quotient group.
    return f.conjugate()


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12-1)/r). Easy part via Frobenius/conjugation, hard part as a
    plain exponentiation (oracle-grade; the device path uses the x-chain)."""
    # Easy: f^(p^6-1) then ^(p^2+1).
    f = f.conjugate() * f.inverse()
    f = f.frobenius_n(2) * f
    # Hard: ^( (p^4 - p^2 + 1) / r ).
    h = (P**4 - P**2 + 1) // R
    return f.pow(h)


def pairing(p: G1Point, q: G2Point) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs) -> Fq12:
    """prod_i e(P_i, Q_i) with a single shared final exponentiation."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)
