"""Batched hash-to-curve for G2 on the card (RFC 9380
BLS12381G2_XMD:SHA-256_SSWU_RO_).

Split of labour:

* host: ``expand_message_xmd`` (``hashlib`` SHA-256) and the mod-p
  reduction of the 64-byte uniform chunks (:func:`messages_to_u`);
* device (the rest of this module): simplified SWU on the 3-isogenous
  curve E2', the 3-isogeny back to E2, and Budroni-Pintore psi-based
  cofactor clearing, batched and branch-free over the lanes.

The Fp2 square root uses the p == 3 (mod 4) extension-field algorithm
(the host oracle's ``Fq2.sqrt``); its two exponent ladders are Python
loops over constant bits, each step one K3 (square) or K2 (multiply)
launch over the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import iso3_g2
from ..cpu.fields import Fq2
from ..cpu.hash_to_curve import expand_message_xmd
from ..cpu.pairing import PSI_CX, PSI_CY
from ..params import ISO3_A, ISO3_B, ISO3_Z, P, X
from . import curve, fp, fp2

# ---------------------------------------------------------------------------
# Constants (host-derived)
# ---------------------------------------------------------------------------


def _fq2(v) -> Fq2:
    return Fq2.from_ints(*v)


_A2 = _fq2(ISO3_A)
_B2 = _fq2(ISO3_B)
_Z2 = _fq2(ISO3_Z)
_NEG_B_DIV_A = (-_B2) * _A2.inverse()
_B_DIV_ZA = _B2 * (_Z2 * _A2).inverse()


def _dc(q: Fq2, device):
    """Fq2 -> fp2 constant [2, NL] on ``device``."""
    return fp2.const(q.c0.n, q.c1.n, device)


_PSI_CX_D = (PSI_CX.c0.n, PSI_CX.c1.n)
_PSI_CY_D = (PSI_CY.c0.n, PSI_CY.c1.n)

X_ABS = -X


def f2pow(x, e: int):
    """Fp2 fixed-exponent ladder (shared square-and-multiply)."""
    return fp2.pow_const(x, e)


# ---------------------------------------------------------------------------
# Fp2 primitives for the map
# ---------------------------------------------------------------------------

def sgn0(x):
    """RFC 9380 §4.1 sgn0 for m=2, batched -> int32 [...] in {0,1}."""
    d = fp2.canonical(x)  # [..., 2, NL] strict digits
    c0d, c1d = d[..., 0, :], d[..., 1, :]
    sign0 = c0d[..., 0] & 1
    zero0 = torch.all(c0d == 0, dim=-1)
    sign1 = c1d[..., 0] & 1
    return torch.where(zero0, sign1, sign0)


def sqrt(x):
    """Batched Fp2 square root -> (root, is_square). ``root`` is valid
    only where ``is_square``; x == 0 gives (0, True)."""
    a1 = f2pow(x, (P - 3) // 4)
    x0 = fp2.mul(a1, x)
    alpha = fp2.mul(a1, x0)
    dev = x.device
    is_neg1 = fp2.eq(alpha, fp2.const(P - 1, 0, dev))
    # alpha == -1: root = u * x0  ((a+bu)*u = -b + au)
    cand1 = fp2.pack(fp.neg(fp2.c1(x0)), fp2.c0(x0))
    b = f2pow(fp2.add(fp2.const(1, 0, dev), alpha), (P - 1) // 2)
    cand2 = fp2.mul(b, x0)
    root = fp2.select(is_neg1, cand1, cand2)
    ok = fp2.eq(fp2.sq(root), x)
    return root, ok


# ---------------------------------------------------------------------------
# Simplified SWU on E2' (batched, branch-free)
# ---------------------------------------------------------------------------

def sswu_pre(u):
    """Pre-sqrt half of simplified SWU: u -> (x1, x2, g) where
    ``g = [gx1, gx2]`` stacked on dim -3 awaits ONE sqrt ladder (the
    caller may merge it with other square roots)."""
    dev = u.device
    Z, A, B = _dc(_Z2, dev), _dc(_A2, dev), _dc(_B2, dev)
    zu2 = fp2.mul(Z, fp2.sq(u))
    zu2_sq = fp2.sq(zu2)
    tv1 = fp2.add(zu2_sq, zu2)
    tv1_inv = fp2.inv(tv1)  # inv(0) == 0
    x1 = fp2.mul(_dc(_NEG_B_DIV_A, dev), fp2.add(fp2.const(1, 0, dev), tv1_inv))
    x1 = fp2.select(fp2.is_zero(tv1), _dc(_B_DIV_ZA, dev).expand_as(x1), x1)
    gx1 = fp2.add(fp2.mul(fp2.add(fp2.sq(x1), A), x1), B)
    # x2 = Z u^2 x1 and (Z u^2)^3 in one call; gx2 = (Z u^2)^3 gx1
    x2, zu2_3 = fp2.mul_pairs([(zu2, x1), (zu2_sq, zu2)])
    gx2 = fp2.mul(zu2_3, gx1)
    return x1, x2, torch.stack([gx1, gx2], dim=-3)


def sswu_post(u, x1, x2, roots, ok):
    """Post-sqrt half: candidate roots -> affine (x, y) with the RFC 9380
    sign rule. ``roots``/``ok`` are sqrt outputs of ``sswu_pre``'s g."""
    is1 = ok[..., 0]
    x = fp2.select(is1, x1, x2)
    y = fp2.select(is1, roots[..., 0, :, :], roots[..., 1, :, :])
    # sign: sgn0(y) must equal sgn0(u)
    flip = sgn0(u) != sgn0(y)
    y = fp2.select(flip, fp2.neg(y), y)
    return x, y


def map_to_curve_sswu(u):
    """u: fp2 [..., 2, NL] -> affine (x, y) on the iso-curve E2'."""
    x1, x2, g = sswu_pre(u)
    roots, ok = sqrt(g)
    return sswu_post(u, x1, x2, roots, ok)


# ---------------------------------------------------------------------------
# 3-isogeny E2' -> E2
# ---------------------------------------------------------------------------

def _iso3_coeff_table() -> np.ndarray:
    """All four isogeny polynomials padded to a common degree and stacked:
    int32 [max_len, 4, 2, NL], highest coefficient first (Horner order).
    Zero-padding the short polynomial at the top degree is exact."""
    polys = [iso3_g2.X_NUM, iso3_g2.X_DEN, iso3_g2.Y_NUM, iso3_g2.Y_DEN]
    n = max(len(p) for p in polys)
    out = np.zeros((n, 4, 2, fp.NL), np.int32)
    for j, poly in enumerate(polys):
        padded = list(poly) + [(0, 0)] * (n - len(poly))
        for d, c in enumerate(reversed(padded)):  # MSB-first for Horner
            q = _fq2(c)
            out[d, j, 0] = fp.int_to_limbs(q.c0.n)
            out[d, j, 1] = fp.int_to_limbs(q.c1.n)
    return out


_ISO3_TABLE = _iso3_coeff_table()


def iso3_map(x, y):
    """The 3-isogeny: all four polynomials by ONE Horner loop over the
    stacked coefficient table (one fp2 product per degree), the two
    denominator inverses in one batched fp2.inv."""
    table = fp.on_device("iso3", x.device, lambda: _ISO3_TABLE)  # [deg, 4, 2, NL]
    x4 = x.unsqueeze(-3)
    acc = table[0].expand(*x.shape[:-2], 4, 2, fp.NL)
    for c in table[1:]:
        acc = fp2.add(fp2.mul(acc, x4), c)
    xn, xd, yn, yd = (acc[..., j, :, :] for j in range(4))
    dens = fp2.inv(torch.stack([xd, yd], dim=-3))
    x_out, yyn = fp2.mul_pairs([(xn, dens[..., 0, :, :]), (y, yn)])
    y_out = fp2.mul(yyn, dens[..., 1, :, :])
    return x_out, y_out


# ---------------------------------------------------------------------------
# psi endomorphism + Budroni-Pintore cofactor clearing
# ---------------------------------------------------------------------------

def psi_jac(pt):
    """(X, Y, Z) -> (conj(X) CX, conj(Y) CY, conj(Z)): the same map as the
    subgroup check's psi (``device/bls.py``)."""
    x, y, z = pt
    dev = x.device
    cx, cy = fp2.const(*_PSI_CX_D, dev), fp2.const(*_PSI_CY_D, dev)
    px, py = fp2.mul_pairs([(fp2.conjugate(x), cx), (fp2.conjugate(y), cy)])
    return (px, py, fp2.conjugate(z))


def clear_cofactor(pt):
    """[X^2-X-1]P + [X-1]psi(P) + psi^2([2]P) (RFC 9380 App. G.3)."""
    xp = curve.neg(fp2, curve.scalar_mul_const(fp2, pt, X_ABS))    # [X]P
    x2p = curve.neg(fp2, curve.scalar_mul_const(fp2, xp, X_ABS))   # [X^2]P
    neg_p = curve.neg(fp2, pt)
    neg_xp = curve.neg(fp2, xp)
    part1 = curve.add(fp2, curve.add(fp2, x2p, neg_xp), neg_p)
    part2 = psi_jac(curve.add(fp2, xp, neg_p))
    part3 = psi_jac(psi_jac(curve.dbl(fp2, pt)))
    return curve.add(fp2, curve.add(fp2, part1, part2), part3)


# ---------------------------------------------------------------------------
# The batched map: u values -> G2 projective points
# ---------------------------------------------------------------------------

def map_to_g2_post(u, x1, x2, roots, ok):
    """Post-sqrt remainder of the RO map: SSWU sign-pick, isogeny, the
    count-axis add, cofactor clearing."""
    x, y = sswu_post(u, x1, x2, roots, ok)
    x, y = iso3_map(x, y)
    q = curve.from_affine(fp2, x, y)
    q0 = tuple(c[..., 0, :, :] for c in q)
    q1 = tuple(c[..., 1, :, :] for c in q)
    return clear_cofactor(curve.add(fp2, q0, q1))


def map_to_g2(u):
    """u: fp2 [..., 2 (count), 2, NL] -> G2 point [...]: two SSWU maps,
    isogeny, one add, cofactor clearing."""
    x1, x2, g = sswu_pre(u)              # batched over [..., 2]
    roots, ok = sqrt(g)
    return map_to_g2_post(u, x1, x2, roots, ok)


# ---------------------------------------------------------------------------
# Host half: messages -> u limbs
# ---------------------------------------------------------------------------

def messages_to_u(messages, dst: bytes) -> np.ndarray:
    """[m_0..m_{B-1}] -> int32 [B, 2, 2, NL] of hash_to_field outputs."""
    L = 64
    values = []
    for msg in messages:
        uniform = expand_message_xmd(msg, dst, 2 * 2 * L)
        values += [int.from_bytes(uniform[off:off + L], "big") % P
                   for off in range(0, 4 * L, L)]
    return curve.ints_to_limbs(values).reshape(len(messages), 2, 2, fp.NL)
