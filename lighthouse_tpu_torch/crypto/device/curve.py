"""Curve arithmetic on the card for G1/E1(Fp) and G2/E2(Fp2), batched.

Points are homogeneous projective triples ``(X, Y, Z)`` of field elements
(``x = X/Z``, ``y = Y/Z``; infinity = (0 : 1 : 0), iff ``Z == 0``). Every
function is generic over the field module ``F`` (:mod:`.fp` for G1,
:mod:`.fp2` for G2); both expose the same batched API, so one set of
formulas serves both groups.

The group law is the Renes-Costello-Batina COMPLETE addition for a = 0
short-Weierstrass curves (eprint 2015/1060, algs. 7/9): one branch-free
formula covers generic add, doubling, P + (-P) and infinity operands. Its
12 field products batch into two ``F.mul`` calls (one kernel launch each).
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp as _fp
from . import linear


def infinity(F, shape, device):
    """The canonical infinity representative (0 : 1 : 0)."""
    return (F.zeros(shape, device), F.ones(shape, device), F.zeros(shape, device))


def is_infinity(F, pt):
    return F.is_zero(pt[2])


def neg(F, pt):
    x, y, z = pt
    return (x, F.neg(y), z)


def select(F, mask, a, b):
    return tuple(F.select(mask, ca, cb) for ca, cb in zip(a, b))


def _batch_shape(F, x):
    """Leading batch dims of a field element array."""
    return x.shape[: x.dim() - F.ELEM_NDIM]


def _mul_batch(F, pairs):
    """One fused F.mul over stacked operand pairs: n products cost one
    kernel launch instead of n."""
    xs = torch.stack(torch.broadcast_tensors(*[a for a, _ in pairs]))
    ys = torch.stack(torch.broadcast_tensors(*[b for _, b in pairs]))
    xs, ys = torch.broadcast_tensors(xs, ys)
    out = F.mul(xs, ys)
    return [out[i] for i in range(len(pairs))]


def eq(F, p, q):
    """Projective equality by cross-multiplication: X1 Z2 == X2 Z1 and
    Y1 Z2 == Y2 Z1. Complete, infinity lanes included."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    a, b, c, d = _mul_batch(F, [(x1, z2), (x2, z1), (y1, z2), (y2, z1)])
    return F.eq(a, b) & F.eq(c, d)


def _s_b3(a, d: int):
    """Symbolic multiply by 3b: 12 on E (b = 4), 12(1+u) on E' (b = 4(1+u))."""
    return 12 * a if d == 1 else linear.xi(12 * a)


def _compile_maps(d: int) -> dict:
    """The additive glue of the RCB formulas over elements of degree d,
    each chain compiled into one LinMap (see ``linear.py``)."""
    x1, y1, z1, x2, y2, z2 = linear.units(6, d)
    t0, t1, t2, t3m, t4m, x3m = linear.units(6, d)
    t3 = t3m - t0 - t1                   # X1Y2 + X2Y1
    t4 = t4m - t1 - t2                   # Y1Z2 + Y2Z1
    y3 = x3m - t0 - t2                   # X1Z2 + X2Z1
    t0_ = 3 * t0                         # 3 X1X2
    t2_ = _s_b3(t2, d)                   # 3b Z1Z2
    z3 = t1 + t2_                        # Y1Y2 + 3b Z1Z2
    t1_ = t1 - t2_                       # Y1Y2 - 3b Z1Z2
    y3_ = _s_b3(y3, d)                   # 3b (X1Z2 + X2Z1)
    x3a, t2b, y3a, t1b, t0c, z3c = linear.units(6, d)
    # dbl: products t0 = Y^2, t1 = YZ, t2 = Z^2, xy = XY
    d0, d1, d2, dxy = linear.units(4, d)
    b3z2 = _s_b3(d2, d)
    dz3 = 8 * d0
    dy3 = d0 + b3z2
    dt0 = d0 - 3 * b3z2
    e0, e1, e2, e3 = linear.units(4, d)  # x3, z3_out, y3b, xt
    return {
        "add_pre": linear.compile_map([np.stack(
            [x1, y1, z1, x1 + y1, y1 + z1, x1 + z1, x2, y2, z2, x2 + y2, y2 + z2, x2 + z2])]),
        "add_mid": linear.compile_map([np.stack(
            [t4, t3, y3_, t1_, t0_, z3, y3_, t1_, t0_, z3, t3, t4])]),
        "add_post": linear.compile_map([np.stack([t2b - x3a, t1b + y3a, z3c + t0c])]),
        "dbl_mid": linear.compile_map([np.stack(
            [b3z2, d1, dt0, dt0, dz3, dz3, dy3, dxy])]),
        "dbl_post": linear.compile_map([np.stack([2 * e3, e0 + e2])]),
    }


_MAPS = {d: _compile_maps(d) for d in (1, 2)}


def _glue(F, name, stacked):
    """Apply the named glue map to elements of F stacked on dim -1-ELEM_NDIM."""
    return linear.apply(_MAPS[F.ELEM_NDIM][name], stacked, F.ELEM_NDIM)


def _split(F, t, lo, hi):
    ax = t.dim() - 1 - F.ELEM_NDIM
    return t.narrow(ax, lo, hi - lo)


def _items(F, t):
    ax = t.dim() - 1 - F.ELEM_NDIM
    return [t.select(ax, i) for i in range(t.shape[ax])]


def dbl(F, pt):
    """Complete doubling, RCB alg. 9 (a = 0). Maps (0:1:0) to itself.
    Two product batches (one kernel launch each) and two glue maps."""
    x, y, z = pt
    e = F.ELEM_NDIM
    p1 = F.mul(linear.stack([y, y, z, x], e), linear.stack([y, z, z, y], e))
    mid = _glue(F, "dbl_mid", p1)
    p2 = F.mul(_split(F, mid, 0, 4), _split(F, mid, 4, 8))   # x3, z3, y3b, xt
    x3, y3 = _items(F, _glue(F, "dbl_post", p2))
    return (x3, y3, _items(F, p2)[1])


def add(F, p, q):
    """COMPLETE addition, RCB alg. 7 (a = 0): valid for every input pair
    including P == Q, P == -Q and infinity, with no comparisons. 12
    general multiplications in two product batches; three glue maps."""
    pre = _glue(F, "add_pre", linear.stack([*p, *q], F.ELEM_NDIM))
    p1 = F.mul(_split(F, pre, 0, 6), _split(F, pre, 6, 12))
    mid = _glue(F, "add_mid", p1)
    p2 = F.mul(_split(F, mid, 0, 6), _split(F, mid, 6, 12))
    return tuple(_items(F, _glue(F, "add_post", p2)))


def scalar_mul_bits(F, pt, bits):
    """Per-lane scalar mul: ``bits`` is int32 [..., n] MSB-first, batched
    alongside the point's batch dims. Double-and-add with a branch-free
    select per bit (the bits live on the device)."""
    x = pt[0]
    acc = tuple(
        c.expand_as(o) for c, o in
        zip(infinity(F, _batch_shape(F, x), x.device), pt)
    )
    for i in range(bits.shape[-1]):
        acc = dbl(F, acc)
        acc = select(F, bits[..., i] == 1, add(F, acc, pt), acc)
    return acc


def scalar_mul_const(F, pt, k: int):
    """Fixed Python-int scalar mul shared by the batch: a Python branch per
    bit, so a zero bit costs no addition."""
    if k < 0:
        return scalar_mul_const(F, neg(F, pt), -k)
    if k == 0:
        x = pt[0]
        return infinity(F, _batch_shape(F, x), x.device)
    acc = pt
    for bit in bin(k)[3:]:
        acc = dbl(F, acc)
        if bit == "1":
            acc = add(F, acc, pt)
    return acc


def to_affine(F, pt):
    """-> (x, y, inf_mask); (0, 0) at infinity (F.inv(0) == 0)."""
    x, y, z = pt
    zi = F.inv(z)
    ax, ay = _mul_batch(F, [(x, zi), (y, zi)])
    return F.canonical(ax), F.canonical(ay), is_infinity(F, pt)


def from_affine(F, x, y, inf_mask=None):
    """Affine coords (+ optional infinity mask) -> projective triple
    (infinity lanes become the canonical (0 : 1 : 0))."""
    shape = _batch_shape(F, x)
    z = F.ones(shape, x.device)
    if inf_mask is not None:
        zero = F.zeros(shape, x.device)
        z = F.select(inf_mask, zero, z)
        x = F.select(inf_mask, zero, x)
        y = F.select(inf_mask, F.ones(shape, x.device), y)
    return (x, y, z)


def tree_reduce(x, axis: int, combine, identity):
    """Reduce a tensor, or a tuple of tensors, along ``axis`` by pairwise
    halving: log2(N) batched ``combine`` calls. ``identity(device)`` gives
    the unbatched identity element(s), broadcast when N == 0. ``combine``
    must be associative and commutative (the group law, the Fp12
    product), so the order may differ from the reference's scan."""
    single = isinstance(x, torch.Tensor)
    xs = tuple(c.movedim(axis, 0) for c in ((x,) if single else x))
    n = xs[0].shape[0]
    if n == 0:
        ident = identity(xs[0].device)
        ident = (ident,) if single else ident
        out = tuple(i.expand(c.shape[1:]).clone() for i, c in zip(ident, xs))
        return out[0] if single else out

    def call(a, b):
        r = combine(a[0], b[0]) if single else combine(a, b)
        return (r,) if single else tuple(r)

    while n > 1:
        h = n // 2
        r = call(tuple(c[:h] for c in xs), tuple(c[h:2 * h] for c in xs))
        if n % 2:
            r = tuple(torch.cat([rc, c[2 * h:]], dim=0) for rc, c in zip(r, xs))
        xs = r
        n = h + n % 2
    out = tuple(c[0] for c in xs)
    return out[0] if single else out


def sum_points(F, pt, axis: int = 0):
    """Sum a batch of points along ``axis`` with the complete group law."""
    return tree_reduce(
        pt, axis, lambda a, b: add(F, a, b),
        lambda device: infinity(F, (), device),
    )


# ---------------------------------------------------------------------------
# Host packing: oracle affine points -> limb arrays (byte-identical to the
# JAX package's pack_g1 / pack_g2)
# ---------------------------------------------------------------------------

def ints_to_limbs(values) -> np.ndarray:
    """Python ints in [0, 2**384) -> strict 12-bit limbs int32[n, 32], in
    one vectorized pass (three little-endian bytes hold two limbs)."""
    raw = b"".join(int(v).to_bytes(48, "little") for v in values)
    b = np.frombuffer(raw, np.uint8).reshape(-1, 16, 3).astype(np.int32)
    lo = b[..., 0] | ((b[..., 1] & 0xF) << 8)
    hi = (b[..., 1] >> 4) | (b[..., 2] << 4)
    return np.stack([lo, hi], axis=-1).reshape(-1, _fp.NL)


def pack_g1(points) -> tuple[np.ndarray, np.ndarray]:
    """cpu G1Point list -> (xy int32[n, 2, 32], inf bool[n])."""
    points = list(points)
    infs = np.array([p.is_infinity() for p in points], bool)
    coords = []
    for p in points:
        coords += (0, 0) if p.is_infinity() else (p.x.n, p.y.n)
    xy = ints_to_limbs(coords).reshape(len(points), 2, _fp.NL)
    return xy, infs


def pack_g2(points) -> tuple[np.ndarray, np.ndarray]:
    """cpu G2Point list -> (xy int32[n, 2, 2, 32], inf bool[n])."""
    points = list(points)
    infs = np.array([p.is_infinity() for p in points], bool)
    coords = []
    for p in points:
        coords += (0, 0, 0, 0) if p.is_infinity() else (
            p.x.c0.n, p.x.c1.n, p.y.c0.n, p.y.c1.n)
    xy = ints_to_limbs(coords).reshape(len(points), 2, 2, _fp.NL)
    return xy, infs


def unpack_g1(xy, inf) -> list:
    """Affine limb arrays (xy int32[n, 2, 32], inf bool[n]) -> cpu
    G1Point list."""
    from ..cpu.curve import G1Point
    from ..cpu.fields import Fq

    xy, inf = np.asarray(xy), np.asarray(inf)
    return [G1Point.infinity() if inf[i] else
            G1Point(Fq(_fp.limbs_to_int(xy[i, 0])), Fq(_fp.limbs_to_int(xy[i, 1])))
            for i in range(xy.shape[0])]


def unpack_g2(xy, inf) -> list:
    """Affine limb arrays (xy int32[n, 2, 2, 32], inf bool[n]) -> cpu
    G2Point list."""
    from ..cpu.curve import G2Point
    from ..cpu.fields import Fq2

    xy, inf = np.asarray(xy), np.asarray(inf)
    return [G2Point.infinity() if inf[i] else G2Point(
        Fq2.from_ints(_fp.limbs_to_int(xy[i, 0, 0]), _fp.limbs_to_int(xy[i, 0, 1])),
        Fq2.from_ints(_fp.limbs_to_int(xy[i, 1, 0]), _fp.limbs_to_int(xy[i, 1, 1])))
        for i in range(xy.shape[0])]
