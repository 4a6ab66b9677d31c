"""Extension-field tower Fp6 / Fp12 on the card, for the BLS12-381 pairing.

Layouts (leading dims are batch dims, broadcast everywhere):

* Fp6  = Fp2[v]/(v^3 - xi), xi = 1+u:  ``int32[..., 3, 2, 32]``
* Fp12 = Fp6[w]/(w^2 - v):             ``int32[..., 2, 3, 2, 32]``

The same algorithms as the JAX package's ``tower.py``. Every Fp6/Fp12
product stacks its Fp2 products into one ``fp2.mul`` call, i.e. one K2
launch (27 products for an Fp12 multiply, 18 for a square), and its
additive recombination is one :class:`fp.LinMap` compiled from the
symbolic formula (``linear.py``). Frobenius constants come from the host
oracle (``crypto/cpu/fields.GAMMA*``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cpu.fields import GAMMA6_1, GAMMA6_2, GAMMA12, Fq2, Fq6, Fq12
from ..params import P
from . import fp, fp2, linear

# ---------------------------------------------------------------------------
# Fp6
# ---------------------------------------------------------------------------

def f6_pack(c0, c1, c2):
    return torch.stack([c0, c1, c2], dim=-3)


def f6_c(x, i):
    return x[..., i, :, :]


def f6_zeros(shape, device):
    return torch.zeros((*shape, 3, 2, fp.NL), dtype=torch.int32, device=device)


def f6_ones(shape, device):
    return f6_pack(
        fp2.ones(shape, device), fp2.zeros(shape, device), fp2.zeros(shape, device)
    )


def f6_add(x, y):
    return fp.add(x, y)


def f6_sub(x, y):
    return fp.sub(x, y)


def f6_neg(x):
    return fp.neg(x)


def _f6_prod_terms(x, y):
    """The 9 Fp2 operand pairs of a schoolbook Fp6 product."""
    a = [f6_c(x, i) for i in range(3)]
    b = [f6_c(y, i) for i in range(3)]
    return [
        (a[0], b[0]),
        (a[0], b[1]), (a[1], b[0]),
        (a[0], b[2]), (a[1], b[1]), (a[2], b[0]),
        (a[1], b[2]), (a[2], b[1]),
        (a[2], b[2]),
    ]


def _s_f6_combine(p):
    """Symbolic recombination of the 9 products with v^3 = xi folding
    (oracle Fq6.__mul__): p are 9 Fp2 forms -> an Fp6 form [3, 2, I]."""
    t0 = p[0]
    t1 = p[1] + p[2]
    t2 = p[3] + p[4] + p[5]
    t3 = p[6] + p[7]
    t4 = p[8]
    return np.stack([t0 + linear.xi(t3), t1 + linear.xi(t4), t2])


def _s_f6_mul_by_v(x):
    """Symbolic (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return np.stack([linear.xi(x[2]), x[0], x[1]])


def _f12_map(n_prods, combine):
    return linear.compile_map([combine(linear.units(n_prods, 2))])


# The additive glue of each product, compiled once: one reduction each.
_F6_MUL = _f12_map(9, _s_f6_combine)


def _m12(p):
    t0, t1, m = _s_f6_combine(p[0:9]), _s_f6_combine(p[9:18]), _s_f6_combine(p[18:27])
    return np.stack([t0 + _s_f6_mul_by_v(t1), m - t0 - t1])


def _s12(p):
    t, u = _s_f6_combine(p[0:9]), _s_f6_combine(p[9:18])  # ab, (a+b)(a+vb)
    return np.stack([u - t - _s_f6_mul_by_v(t), t + t])


_F12_MUL = _f12_map(27, _m12)
_F12_SQ = _f12_map(18, _s12)


def _s12_pre(u):
    """(a, b) -> (a + b, a + v b): the operands of the complex squaring."""
    a, b = np.stack(u[0:3]), np.stack(u[3:6])
    return np.stack([a + b, a + _s_f6_mul_by_v(b)])


_F12_SQ_PRE = linear.compile_map([_s12_pre(linear.units(6, 2))])


def _products(terms):
    """Fp2 operand pairs -> their products stacked [..., n, 2, NL]."""
    xs = fp2._bstack([a for a, _ in terms], -3)
    ys = fp2._bstack([b for _, b in terms], -3)
    return fp2.mul(xs, ys)


def f6_mul(x, y):
    """Schoolbook over Fp2: the 9 products in one K2 launch, then one
    linear recombination."""
    return linear.apply(_F6_MUL, _products(_f6_prod_terms(x, y)), 2)


def f6_sq(x):
    return f6_mul(x, x)


def f6_scale(x, k):
    """Multiply every Fp2 coefficient by the fp2 element ``k``."""
    return f6_pack(*fp2.mul_pairs([(f6_c(x, i), k) for i in range(3)]))


def f6_mul_by_v(x):
    """(c0, c1, c2) -> (xi*c2, c0, c1)."""
    return f6_pack(fp2.mul_by_u_plus_1(f6_c(x, 2)), f6_c(x, 0), f6_c(x, 1))


def f6_inv(x):
    a0, a1, a2 = f6_c(x, 0), f6_c(x, 1), f6_c(x, 2)
    p = fp2.mul_pairs(
        [(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1), (a0, a2)]
    )
    t0 = fp2.sub(p[0], fp2.mul_by_u_plus_1(p[1]))
    t1 = fp2.sub(fp2.mul_by_u_plus_1(p[2]), p[3])
    t2 = fp2.sub(p[4], p[5])
    q = fp2.mul_pairs([(a0, t0), (a2, t1), (a1, t2)])
    den = fp2.add(q[0], fp2.mul_by_u_plus_1(fp2.add(q[1], q[2])))
    d = fp2.inv(den)
    r = fp2.mul_pairs([(t0, d), (t1, d), (t2, d)])
    return f6_pack(*r)


# ---------------------------------------------------------------------------
# Fp12
# ---------------------------------------------------------------------------

def pack(c0, c1):
    return torch.stack([c0, c1], dim=-4)


def c0(x):
    return x[..., 0, :, :, :]


def c1(x):
    return x[..., 1, :, :, :]


def zeros(shape, device):
    return torch.zeros((*shape, 2, 3, 2, fp.NL), dtype=torch.int32, device=device)


def ones(shape, device):
    return pack(f6_ones(shape, device), f6_zeros(shape, device))


def add(x, y):
    return fp.add(x, y)


def sub(x, y):
    return fp.sub(x, y)


def neg(x):
    return fp.neg(x)


def mul(x, y):
    """Karatsuba over Fp6: the 3 Fp6 products' 27 Fp2 products go through
    ONE K2 launch, then one linear recombination."""
    x, y = torch.broadcast_tensors(x, y)
    s = fp.add(torch.stack([c0(x), c0(y)]), torch.stack([c1(x), c1(y)]))
    terms = (
        _f6_prod_terms(c0(x), c0(y))
        + _f6_prod_terms(c1(x), c1(y))
        + _f6_prod_terms(s[0], s[1])
    )
    out = linear.apply(_F12_MUL, _products(terms), 2)
    return out.reshape(*out.shape[:-3], 2, 3, 2, fp.NL)


def sq(x):
    """Dedicated squaring: (a + bw)^2 = (a^2 + v b^2) + 2ab w via the
    complex trick: 2 Fp6 products (18 Fp2 products in one K2 launch) vs
    27 for the generic multiply."""
    a, b = c0(x), c1(x)
    pre = linear.apply(_F12_SQ_PRE, x.reshape(*x.shape[:-4], 6, 2, fp.NL), 2)
    apb, apvb = pre[..., 0:3, :, :], pre[..., 3:6, :, :]
    terms = _f6_prod_terms(a, b) + _f6_prod_terms(apb, apvb)
    out = linear.apply(_F12_SQ, _products(terms), 2)
    return out.reshape(*out.shape[:-3], 2, 3, 2, fp.NL)


def conjugate(x):
    """x^(p^6): negate the w component. Inverse of unitary elements."""
    return pack(c0(x), f6_neg(c1(x)))


def inv(x):
    a, b = c0(x), c1(x)
    d = f6_inv(f6_sub(f6_sq(a), f6_mul_by_v(f6_sq(b))))
    return pack(f6_mul(a, d), f6_neg(f6_mul(b, d)))


def select(mask, a, b):
    return torch.where(mask[..., None, None, None, None], a, b)


def canonical(x):
    return fp.canonical(x)


def is_one(x):
    one = canonical(ones((), x.device))
    return (canonical(x) == one).flatten(-4).all(dim=-1)


def eq(x, y):
    return (canonical(x) == canonical(y)).flatten(-4).all(dim=-1)


def from_fp2(a):
    """Embed an fp2 element into Fp12 (constant coefficient)."""
    out = zeros(a.shape[:-2], a.device)
    out[..., 0, 0, :, :] = a
    return out


# Frobenius gamma constants (public, derived from xi = 1+u).
_G6_1 = (GAMMA6_1.c0.n, GAMMA6_1.c1.n)
_G6_2 = (GAMMA6_2.c0.n, GAMMA6_2.c1.n)
_G12 = (GAMMA12.c0.n, GAMMA12.c1.n)
_G61_12 = ((GAMMA6_1 * GAMMA12).c0.n, (GAMMA6_1 * GAMMA12).c1.n)
_G62_12 = ((GAMMA6_2 * GAMMA12).c0.n, (GAMMA6_2 * GAMMA12).c1.n)


def frobenius(x):
    """x -> x^p (oracle Fq12.frobenius); gamma products in one batch."""
    dev = x.device
    g61 = fp2.const(*_G6_1, dev)
    g62 = fp2.const(*_G6_2, dev)
    g12 = fp2.const(*_G12, dev)
    g6112 = fp2.const(*_G61_12, dev)
    g6212 = fp2.const(*_G62_12, dev)
    xc = fp2.conjugate(x)  # every Fp2 coefficient at once
    ca = [f6_c(c0(xc), i) for i in range(3)]
    cb = [f6_c(c1(xc), i) for i in range(3)]
    p = fp2.mul_pairs(
        [
            (ca[1], g61), (ca[2], g62),
            (cb[0], g12),
            (cb[1], g6112), (cb[2], g6212),
        ]
    )
    return pack(f6_pack(ca[0], p[0], p[1]), f6_pack(p[2], p[3], p[4]))


def frobenius_n(x, n: int):
    for _ in range(n):
        x = frobenius(x)
    return x


def pow_const(x, e: int):
    """x**e for fixed non-negative e; e == 0 -> one. Negative exponents are
    the caller's job (conjugate for unitary elements, inv otherwise)."""
    assert e >= 0
    if e == 0:
        return ones(x.shape[:-4], x.device)
    return fp.square_multiply(x, e, sq, mul)


# ---------------------------------------------------------------------------
# Host packing: Fq12 values <-> device arrays
# ---------------------------------------------------------------------------

def pack_f12(vals) -> np.ndarray:
    """Host Fq12 values (``c0/c1`` Fq6 of ``c0/c1/c2`` Fq2 of ``c0/c1``
    with ``.n``) -> int32[n, 2, 3, 2, 32]."""
    return np.stack([
        np.stack([
            np.stack([np.stack([fp.int_to_limbs(c.c0.n), fp.int_to_limbs(c.c1.n)])
                      for c in (h.c0, h.c1, h.c2)])
            for h in (v.c0, v.c1)])
        for v in vals])


def unpack_f12(arr) -> list:
    """Device Fp12 array [..., 2, 3, 2, 32] (any relaxed limbs, any
    device) -> list of host :class:`~..cpu.fields.Fq12`."""
    d = canonical(torch.as_tensor(arr)).cpu().numpy().reshape(-1, 2, 3, 2, fp.NL)

    def f2(c):
        return Fq2.from_ints(fp.limbs_to_int(c[0]) % P, fp.limbs_to_int(c[1]) % P)

    return [Fq12(*(Fq6(*(f2(c) for c in h)) for h in v)) for v in d]
