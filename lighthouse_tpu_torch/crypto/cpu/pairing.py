"""The psi endomorphism of E2 on the host (untwist-Frobenius-twist).

psi = twist . frobenius . untwist collapses to coordinate-wise Fq2 maps:
``psi(x, y) = (conj(x) * PSI_CX, conj(y) * PSI_CY)`` with
``PSI_CX = xi^-((p-1)/3)`` and ``PSI_CY = xi^-((p-1)/2)``. Used by the host
cofactor clearing (``hash_to_curve.py``) and, as constants, by the device
subgroup check and cofactor clearing.
"""

from __future__ import annotations

from ..params import P
from .curve import G2Point
from .fields import XI

PSI_CX = XI.pow((P - 1) // 3).inverse()
PSI_CY = XI.pow((P - 1) // 2).inverse()


def psi(q: G2Point) -> G2Point:
    """Untwist-Frobenius-twist endomorphism on E2 (RFC 9380 App. G.3)."""
    if q.is_infinity():
        return q
    return G2Point(q.x.conjugate() * PSI_CX, q.y.conjugate() * PSI_CY)


def psi2(q: G2Point) -> G2Point:
    return psi(psi(q))
