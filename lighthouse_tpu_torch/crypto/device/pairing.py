"""Batched optimal-ate pairing on BLS12-381, on the card.

Everything is batched over leading dims. The structure follows the JAX
package's ``pairing.py``: shared Miller loops, one product, one final
exponentiation. The Miller-loop steps have the JAX package's two
spellings, chosen by the line engine (``LIGHTHOUSE_TPU_LINE_IMPL`` read at
import, :func:`set_line_impl` or the :func:`line_impl` context; captured
graphs are keyed on it, ``graphs.engines``):

* ``fused`` (the default): each step's products in dependency-leveled
  ``fp2.mul_pairs`` / ``fp2.sq_batch`` batches, the additive glue between
  them as one ``LinMap`` per level;
* ``composed``: each step as its individual Fp2 operations (about 13-15
  ``fp2`` calls per step).

Both give the same canonical values.

* G2 points stay on the twist E'(Fp2) in Jacobian form inside the loop,
  so there are no inversions.
* Lines are evaluated in sparse form: with T = (X, Y, Z) and P = (xP, yP),

      dbl step:  s0 = -2YZ^3 yP * xi,  s_v = 2Y^2 - 3X^3,  s_v2 = 3X^2 Z^2 xP
      add step:  s0 = -HZ yP * xi,     s_v = HZ y2 - R x2, s_v2 = R xP
                 with H = x2 Z^2 - X, R = y2 Z^3 - Y

  occupying Fp12 slots (c0.c0, c1.c1, c1.c2), so a line multiplies a
  general Fp12 element in 18 Fp2 products (one K2 launch).
* Each step's products are grouped in dependency levels into
  ``fp2.mul_pairs`` / ``fp2.sq_batch`` batches: one launch per level.
* The loop's bits are the constant |x|, so the add step runs only on the
  six set bits (a Python branch), not as a computed-then-selected branch.
* The final-exponentiation decision uses the 3h multi-exponentiation
  over the Frobenius powers (``final_exp_is_one``).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..params import P, R, X
from . import curve, fp, fp2, linear, tower

X_ABS = -X  # 0xd201000000010000, the positive BLS parameter


# ---------------------------------------------------------------------------
# Line-step engine switch
# ---------------------------------------------------------------------------

IMPL_LINE_COMPOSED = "composed"
IMPL_LINE_FUSED = "fused"

_LINE_IMPLS = (IMPL_LINE_COMPOSED, IMPL_LINE_FUSED)

_active_line_impl = os.environ.get("LIGHTHOUSE_TPU_LINE_IMPL", IMPL_LINE_FUSED)
if _active_line_impl not in _LINE_IMPLS:
    raise KeyError(f"LIGHTHOUSE_TPU_LINE_IMPL={_active_line_impl!r} unknown; "
                   f"have {sorted(_LINE_IMPLS)}")


def get_line_impl() -> str:
    return _active_line_impl


def set_line_impl(name: str) -> None:
    """Select the Miller-loop step spelling for later calls (same
    contract as ``fp.set_impl``)."""
    global _active_line_impl
    if name not in _LINE_IMPLS:
        raise KeyError(f"unknown line impl {name!r}; have {sorted(_LINE_IMPLS)}")
    _active_line_impl = name


@contextlib.contextmanager
def line_impl(name: str):
    """Scoped line-engine switch (restores the previous choice)."""
    prev = _active_line_impl
    set_line_impl(name)
    try:
        yield
    finally:
        set_line_impl(prev)


# ---------------------------------------------------------------------------
# Sparse line element: (s0, sv, sv2) occupying Fp12 slots c0.c0, c1.c1, c1.c2
# ---------------------------------------------------------------------------

def _s_line(p):
    """Symbolic recombination of mul_by_line's 18 products."""
    xi = linear.xi
    a_l0 = np.stack([p[0], p[1], p[2]])
    b_l0 = np.stack([p[3], p[4], p[5]])
    bl1 = np.stack([xi(p[6] + p[7]), p[8] + xi(p[9]), p[10] + p[11]])
    al1 = np.stack([xi(p[12] + p[13]), p[14] + xi(p[15]), p[16] + p[17]])
    return np.stack([a_l0 + tower._s_f6_mul_by_v(bl1), al1 + b_l0])


def _compile_step_maps() -> dict:
    """The additive glue of the Miller-loop steps, one LinMap per level."""
    xi = linear.xi
    X, A, B = linear.units(3, 2)
    A2, C, XB2, F, Y = linear.units(5, 2)
    EdX, C3, B3, EX = linear.units(4, 2)
    R2, HHH, V = linear.units(3, 2)
    t0, t1, t2, t3 = linear.units(4, 2)
    (s,) = linear.units(1, 2)
    return {
        "line": linear.compile_map([_s_line(linear.units(18, 2))]),
        # dbl: (X, A=X^2, B=Y^2) -> the second squaring batch's operands
        "dbl_l2": linear.compile_map([np.stack([B, X + B, 3 * A])]),
        # (A, C, XB2, F, Y) -> E, D - X3, 2Y, X3 with D = 2(XB2 - A - C)
        "dbl_l3": linear.compile_map([np.stack([
            3 * A2, 6 * (XB2 - A2 - C) - F, 2 * Y, F - 4 * (XB2 - A2 - C)])]),
        # (EdX, C, B, EX) -> Y3 = EdX - 8C, sv = 2B - EX
        "dbl_l4": linear.compile_map([np.stack([EdX - 8 * C3, 2 * B3 - EX])]),
        # add: (R2, HHH, V) -> X3 = R2 - HHH - 2V, V - X3
        "add_x3": linear.compile_map([np.stack([R2 - HHH - 2 * V, 3 * V - R2 + HHH])]),
        # (t0, t1, t2, t3) -> Y3 = t0 - t1, sv = t2 - t3
        "add_y3": linear.compile_map([np.stack([t0 - t1, t2 - t3])]),
        # s0 = -xi(s0c)
        "neg_xi": linear.compile_map([-xi(s)]),
    }


_STEP = _compile_step_maps()


def _glue(name, elems):
    return linear.apply(_STEP[name], linear.stack(elems, 2), 2)


def _at(t, i):
    return t[..., i, :, :]


def mul_by_line(f, s0, sv, sv2):
    """General Fp12 times the sparse line element: the 18 Fp2 products in
    one K2 launch, then one linear recombination."""
    a, b = tower.c0(f), tower.c1(f)  # Fp6 halves
    a0, a1, a2 = tower.f6_c(a, 0), tower.f6_c(a, 1), tower.f6_c(a, 2)
    b0, b1, b2 = tower.f6_c(b, 0), tower.f6_c(b, 1), tower.f6_c(b, 2)
    prods = tower._products(
        [
            (a0, s0), (a1, s0), (a2, s0),        # a*L0
            (b0, s0), (b1, s0), (b2, s0),        # b*L0
            (b1, sv2), (b2, sv), (b0, sv), (b2, sv2), (b0, sv2), (b1, sv),  # b*L1
            (a1, sv2), (a2, sv), (a0, sv), (a2, sv2), (a0, sv2), (a1, sv),  # a*L1
        ]
    )
    out = linear.apply(_STEP["line"], prods, 2)
    return out.reshape(*out.shape[:-3], 2, 3, 2, fp.NL)


def _scale_batch(pairs):
    """[(fp2 elem, fp scalar)] -> [elem * scalar] with every component
    product in ONE fp.mul (one K1 launch)."""
    xs = fp2._bstack([x for x, _ in pairs], -3)
    ks = fp2._bstack([k.unsqueeze(-2) for _, k in pairs], -3)
    t = fp.mul(xs, ks)
    return [t[..., i, :, :] for i in range(len(pairs))]


def _dbl_step(T, xP, yP):
    """Jacobian doubling of T on E'(Fp2) + sparse line coefficients at
    P = (xP, yP) in G1 affine, under the active line engine. Returns
    (T2, s0, sv, sv2)."""
    if _active_line_impl == IMPL_LINE_FUSED:
        return _dbl_step_fused(T, xP, yP)
    return _dbl_step_composed(T, xP, yP)


def _dbl_step_composed(T, xP, yP):
    """The doubling and its line as individual Fp2 operations."""
    Xc, Yc, Zc = T
    A = fp2.sq(Xc)              # X^2
    B = fp2.sq(Yc)              # Y^2
    C = fp2.sq(B)               # Y^4
    D = fp2.sub(fp2.sq(fp2.add(Xc, B)), fp2.add(A, C))
    D = fp2.add(D, D)           # 4XY^2
    E = fp2.add(fp2.add(A, A), A)  # 3X^2
    F = fp2.sq(E)
    X3 = fp2.sub(F, fp2.add(D, D))
    Y3 = fp2.sub(fp2.mul(E, fp2.sub(D, X3)), fp2.mul_small(C, 8))
    Z3 = fp2.mul(fp2.add(Yc, Yc), Zc)  # 2YZ
    Z2 = fp2.sq(Zc)
    # s0 = -2YZ^3 * yP * xi; 2YZ^3 = Z3 * Z2
    z3z2 = fp2.mul(Z3, Z2)
    s0 = fp2.mul_by_u_plus_1(fp2.neg(fp2.scale(z3z2, yP)))
    # sv = 2Y^2 - 3X^3
    sv = fp2.sub(fp2.add(B, B), fp2.mul(E, Xc))
    # sv2 = 3X^2 Z^2 * xP
    sv2 = fp2.scale(fp2.mul(E, Z2), xP)
    return (X3, Y3, Z3), s0, sv, sv2


def _dbl_step_fused(T, xP, yP):
    """Jacobian doubling of T on E'(Fp2) + sparse line coefficients at
    P = (xP, yP) in G1 affine, in dependency-leveled batches: 3 squaring
    or product batches + 1 product + 1 scale batch, with the additive glue
    between them as LinMaps. Returns (T2, s0, sv, sv2)."""
    Xc, Yc, Zc = T
    A, B, Z2 = fp2.sq_batch([Xc, Yc, Zc])
    C, XB2, F = fp2.sq_batch(list(_glue("dbl_l2", [Xc, A, B]).unbind(-3)))
    E, DmX3, Y2, X3 = _glue("dbl_l3", [A, C, XB2, F, Yc]).unbind(-3)
    EdX, Z3, EX, EZ2 = fp2.mul_pairs([(E, DmX3), (Y2, Zc), (E, Xc), (E, Z2)])
    Y3, sv = _glue("dbl_l4", [EdX, C, B, EX]).unbind(-3)
    (z3z2,) = fp2.mul_pairs([(Z3, Z2)])      # 2YZ^3
    s0c, sv2 = _scale_batch([(z3z2, yP), (EZ2, xP)])
    s0 = _at(_glue("neg_xi", [s0c]), 0)
    return (X3, Y3, Z3), s0, sv, sv2


def _add_line(T, xQ, yQ, xP, yP):
    """Mixed addition T + Q with sparse line coefficients at P, under the
    active line engine."""
    if _active_line_impl == IMPL_LINE_FUSED:
        return _add_line_fused(T, xQ, yQ, xP, yP)
    return _add_line_composed(T, xQ, yQ, xP, yP)


def _add_line_composed(T, xQ, yQ, xP, yP):
    """The mixed addition and its line as individual Fp2 operations."""
    Xc, Yc, Zc = T
    Z2 = fp2.sq(Zc)
    U2 = fp2.mul(xQ, Z2)
    S2 = fp2.mul(yQ, fp2.mul(Zc, Z2))
    H = fp2.sub(U2, Xc)
    Rr = fp2.sub(S2, Yc)
    HH = fp2.sq(H)
    HHH = fp2.mul(H, HH)
    V = fp2.mul(Xc, HH)
    X3 = fp2.sub(fp2.sub(fp2.sq(Rr), HHH), fp2.add(V, V))
    Y3 = fp2.sub(fp2.mul(Rr, fp2.sub(V, X3)), fp2.mul(Yc, HHH))
    Z3 = fp2.mul(Zc, H)  # = HZ
    s0 = fp2.mul_by_u_plus_1(fp2.neg(fp2.scale(Z3, yP)))
    sv = fp2.sub(fp2.mul(Z3, yQ), fp2.mul(Rr, xQ))
    sv2 = fp2.scale(Rr, xP)
    return (X3, Y3, Z3), s0, sv, sv2


def _add_line_fused(T, xQ, yQ, xP, yP):
    """Mixed addition T + Q with sparse line coefficients at P, in
    dependency-leveled batches: 1 squaring + 4 product batches + 1 scale
    batch."""
    Xc, Yc, Zc = T
    Z2 = fp2.sq(Zc)
    U2, ZZ2 = fp2.mul_pairs([(xQ, Z2), (Zc, Z2)])
    H = fp2.sub(U2, Xc)
    S2, HH = fp2.mul_pairs([(yQ, ZZ2), (H, H)])
    Rr = fp2.sub(S2, Yc)
    HHH, V, R2, Z3 = fp2.mul_pairs(
        [(H, HH), (Xc, HH), (Rr, Rr), (Zc, H)]
    )
    X3, VmX3 = _glue("add_x3", [R2, HHH, V]).unbind(-3)
    t = fp2.mul_pairs(
        [(Rr, VmX3), (Yc, HHH), (Z3, yQ), (Rr, xQ)]
    )
    Y3, sv = _glue("add_y3", t).unbind(-3)
    s0c, sv2 = _scale_batch([(Z3, yP), (Rr, xP)])
    s0 = _at(_glue("neg_xi", [s0c]), 0)
    return (X3, Y3, Z3), s0, sv, sv2


# ---------------------------------------------------------------------------
# Miller loop (batched)
# ---------------------------------------------------------------------------

_XBITS = [int(b) for b in bin(X_ABS)[2:]]


def miller_loop(g1_aff, g2_aff):
    """f_{|x|,Q}(P) conjugated (negative parameter), batched.

    ``g1_aff = (x, y, inf)`` with x,y fp [..., 32]; ``g2_aff = (x, y, inf)``
    with x,y fp2 [..., 2, 32]. Lanes where either point is at infinity
    yield one (so they do not affect a product of Miller values)."""
    xP, yP, infP = g1_aff
    xQ, yQ, infQ = g2_aff
    batch = xP.shape[:-1]
    dev = xP.device

    T = (xQ, yQ, fp2.ones(batch, dev))
    f = tower.ones(batch, dev)
    for bit in _XBITS[1:]:
        f = tower.sq(f)
        T, s0, sv, sv2 = _dbl_step(T, xP, yP)
        f = mul_by_line(f, s0, sv, sv2)
        if bit:
            T, a0, av, av2 = _add_line(T, xQ, yQ, xP, yP)
            f = mul_by_line(f, a0, av, av2)
    f = tower.conjugate(f)  # negative x
    return tower.select(infP | infQ, tower.ones(batch, dev), f)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------

def _exp_pos(f, e: int):
    """f^e for fixed positive e (square-and-multiply)."""
    return tower.pow_const(f, e)


def _conj_exp(f, e: int):
    """f^e for fixed NEGATIVE e on a unitary f: conj(f^|e|)."""
    return tower.conjugate(_exp_pos(f, -e))


def final_exponentiation(f):
    """f^((p^12-1)/r), batched, exact: easy part then the x-chain
    ``d = (x-1)^2 (x+p) (x^2+p^2-1)/3 + 1``. Used where the VALUE
    matters; the verification path uses :func:`final_exp_is_one`."""
    t = _easy_part(f)
    lam = (X - 1) // 3  # negative
    a = _conj_exp(t, lam)          # t^((x-1)/3)
    a = _conj_exp(a, X - 1)        # t^((x-1)^2/3)
    b = tower.mul(_conj_exp(a, X), tower.frobenius(a))        # a^(x+p)
    c = _conj_exp(_conj_exp(b, X), X)                         # b^(x^2)
    c = tower.mul(c, tower.frobenius_n(b, 2))                 # * b^(p^2)
    c = tower.mul(c, tower.conjugate(b))                      # * b^(-1)
    return tower.mul(c, t)                                    # * t  (the +1)


def _easy_part(f):
    """f^((p^6-1)(p^2+1)); the output is unitary (conj == inverse)."""
    t = tower.mul(tower.conjugate(f), tower.inv(f))
    return tower.mul(tower.frobenius_n(t, 2), t)


# The decision "f^((p^12-1)/r) == 1" exponentiates by 3*(hard part)
# instead (r is prime != 3, so cubing is a bijection on the r-torsion):
#   3h = lam0 + lam1 p + lam2 p^2 + lam3 p^3
#   lam0 = (x-1)^2 (x^3-x) + 3,  lam1 = (x-1)^2 (x^2-1),
#   lam2 = (x-1)^2 x,            lam3 = (x-1)^2
# evaluated as ONE shared-squaring multi-exponentiation over the Frobenius
# powers t^(p^i).

_LAM = [
    (X - 1) ** 2 * (X**3 - X) + 3,
    (X - 1) ** 2 * (X**2 - 1),
    (X - 1) ** 2 * X,
    (X - 1) ** 2,
]
assert (
    sum(l * P**i for i, l in enumerate(_LAM)) == 3 * (P**4 - P**2 + 1) // R
), "multi-exp hard-part decomposition is wrong"


def _multiexp_bits() -> np.ndarray:
    """Per-step subset indices: bit i of step s selects base i (MSB
    first). int32 [n_steps]."""
    mags = [abs(l) for l in _LAM]
    n = max(m.bit_length() for m in mags)
    idx = np.zeros(n, np.int32)
    for i, m in enumerate(mags):
        for s in range(n):
            bit = (m >> (n - 1 - s)) & 1
            idx[s] |= bit << i
    return idx


_MULTIEXP_IDX = [int(i) for i in _multiexp_bits()]
assert _MULTIEXP_IDX[0] != 0, "the leading step must select a base"

# Subset products built in dependency order: table[d] = table[a] * table[b].
_TABLE_STEPS = (
    (3, 1, 2), (5, 1, 4), (9, 1, 8), (6, 2, 4), (10, 2, 8),
    (12, 4, 8), (7, 3, 4), (11, 3, 8), (13, 5, 8), (14, 6, 8),
    (15, 7, 8),
)


def final_exp_is_one(f):
    """True iff final_exponentiation(f) == 1, via the 3h multi-exp."""
    t = _easy_part(f)
    bases = [t]
    for _ in range(3):
        bases.append(tower.frobenius(bases[-1]))
    # negative exponents on unitary values: conjugate the base
    bases = [
        tower.conjugate(b) if lam < 0 else b
        for b, lam in zip(bases, _LAM)
    ]
    table = {1: bases[0], 2: bases[1], 4: bases[2], 8: bases[3]}
    # The 11 composite subsets in 3 dependency levels, one batched Fp12
    # product each.
    for level in (_TABLE_STEPS[:6], _TABLE_STEPS[6:10], _TABLE_STEPS[10:]):
        prods = tower.mul(
            torch.stack([table[a] for _, a, _ in level]),
            torch.stack([table[b] for _, _, b in level]),
        )
        for i, (d, _, _) in enumerate(level):
            table[d] = prods[i]
    acc = table[_MULTIEXP_IDX[0]]
    for i in _MULTIEXP_IDX[1:]:
        acc = tower.sq(acc)
        if i:
            acc = tower.mul(acc, table[i])
    return tower.is_one(acc)


# ---------------------------------------------------------------------------
# Multi-pairing
# ---------------------------------------------------------------------------

def _product(f, axis: int):
    return curve.tree_reduce(
        f, axis, tower.mul, lambda device: tower.ones((), device)
    )


def multi_pairing(g1_aff, g2_aff, axis: int = 0):
    """prod_i e(P_i, Q_i) over a batch axis: batched Miller loops, the
    product, one exact final exponentiation. Returns the Fp12 value."""
    return final_exponentiation(_product(miller_loop(g1_aff, g2_aff), axis))


def multi_pairing_is_one(g1_aff, g2_aff, axis: int = 0):
    """prod_i e(P_i, Q_i) == 1: batched Miller loops, the product, and the
    multi-exp final-exponentiation decision."""
    return final_exp_is_one(_product(miller_loop(g1_aff, g2_aff), axis))


def pairing(g1_aff, g2_aff):
    """e(P, Q), batched elementwise (no reduction)."""
    return final_exponentiation(miller_loop(g1_aff, g2_aff))
