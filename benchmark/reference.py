"""The plain reference of the benchmark: which signature sets verify.

Plain Python integers, independent of the program and of the C library
that signs the inputs. A set of validators ``members`` over message ``m``
with signature ``sig`` verifies under BLS (min_pk,
``BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_``) exactly when

    e(sum of the members' public keys, H(m)) == e(g1, sig).

The registry's public key of validator i is [i + 1] g1, so the left side
is e(g1, [a] H(m)) with a = sum(i + 1) mod r, and the pairing being
non-degenerate on groups of prime order r, the equation holds exactly when
sig is [a] H(m). Compressed encodings are canonical, so the reference
computes H(m) (RFC 9380 hash to G2: expand_message_xmd with SHA-256, hash
to Fp2, simplified SWU on the 3-isogenous curve, the 3-isogeny, the
psi-based cofactor clearing), multiplies it by a, compresses, and compares
bytes. A submission verifies when all of its sets do.

Fp2 elements are pairs of ints (c0, c1), c0 + c1 u with u^2 = -1; G2
points are Jacobian triples with Z = 0 at infinity. Constants are the
curve's published ones (RFC 9380 section 8.8.2, the BLS12-381 draft).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_ABS = 0xD201000000010000  # the curve parameter is -X_ABS
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
G1 = (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
      0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)

ISO_A = (0, 240)
ISO_B = (1012, 1012)
ISO_Z = (P - 2, P - 1)
X_NUM = [
    (0x05c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97d6,
     0x05c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97d6),
    (0, 0x11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71a),
    (0x11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71e,
     0x08ab05f8bdd54cde190937e76bc3e447cc27c3d6fbd7063fcd104635a790520c0a395554e5c6aaaa9354ffffffffe38d),
    (0x171d6541fa38ccfaed6dea691f5fb614cb14b4e7f4e810aa22d6108f142b85757098e38d0f671c7188e2aaaaaaaa5ed1, 0),
]
X_DEN = [
    (0, 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa63),
    (0xc, 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa9f),
    (1, 0),
]
Y_NUM = [
    (0x1530477c7ab4113b59a4c18b076d11930f7da5d4a07f649bf54439d87d27e500fc8c25ebf8c92f6812cfc71c71c6d706,
     0x1530477c7ab4113b59a4c18b076d11930f7da5d4a07f649bf54439d87d27e500fc8c25ebf8c92f6812cfc71c71c6d706),
    (0, 0x05c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97be),
    (0x11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71c,
     0x08ab05f8bdd54cde190937e76bc3e447cc27c3d6fbd7063fcd104635a790520c0a395554e5c6aaaa9354ffffffffe38f),
    (0x124c9ad43b6cf79bfbf7043de3811ad0761b0f37a1e26286b0e977c69aa274524e79097a56dc4bd9e1b371c71c718b10, 0),
]
Y_DEN = [
    (0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffa8fb,
     0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffa8fb),
    (0, 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffa9d3),
    (0x12, 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa99),
    (1, 0),
]

F2 = Tuple[int, int]
ZERO: F2 = (0, 0)
ONE: F2 = (1, 0)


def add(a: F2, b: F2) -> F2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def sub(a: F2, b: F2) -> F2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def neg(a: F2) -> F2:
    return (-a[0] % P, -a[1] % P)


def mul(a: F2, b: F2) -> F2:
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def sqr(a: F2) -> F2:
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def inv(a: F2) -> F2:
    d = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return (a[0] * d % P, -a[1] * d % P)


def power(a: F2, e: int) -> F2:
    out = ONE
    for bit in bin(e)[2:]:
        out = sqr(out)
        if bit == "1":
            out = mul(out, a)
    return out


def sqrt(a: F2):
    """A square root of ``a`` (p = 3 mod 4), or None."""
    if a == ZERO:
        return ZERO
    a1 = power(a, (P - 3) // 4)
    x0 = mul(a1, a)
    alpha = mul(a1, x0)
    if alpha == (P - 1, 0):
        out = (-x0[1] % P, x0[0])
    else:
        out = mul(power(add(ONE, alpha), (P - 1) // 2), x0)
    return out if sqr(out) == a else None


def sgn0(a: F2) -> int:
    return (a[0] & 1) | (int(a[0] == 0) & (a[1] & 1))


XI = (1, 1)
PSI_CX = inv(power(XI, (P - 1) // 3))
PSI_CY = inv(power(XI, (P - 1) // 2))

# -- G2, Jacobian -----------------------------------------------------------

INF = (ONE, ONE, ZERO)


def dbl(p):
    x, y, z = p
    if z == ZERO:
        return INF
    a = sqr(x)
    b = sqr(y)
    c = sqr(b)
    d = sub(sqr(add(x, b)), add(a, c))
    d = add(d, d)
    e = add(add(a, a), a)
    f = sqr(e)
    x3 = sub(f, add(d, d))
    c8 = add(c, c)
    c8 = add(c8, c8)
    c8 = add(c8, c8)
    y3 = sub(mul(e, sub(d, x3)), c8)
    yz = mul(y, z)
    return (x3, y3, add(yz, yz))


def padd(p, q):
    if p[2] == ZERO:
        return q
    if q[2] == ZERO:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = sqr(z1)
    z2z2 = sqr(z2)
    u1 = mul(x1, z2z2)
    u2 = mul(x2, z1z1)
    s1 = mul(mul(y1, z2), z2z2)
    s2 = mul(mul(y2, z1), z1z1)
    if u1 == u2:
        return dbl(p) if s1 == s2 else INF
    h = sub(u2, u1)
    i = sqr(add(h, h))
    j = mul(h, i)
    r = sub(s2, s1)
    r = add(r, r)
    v = mul(u1, i)
    x3 = sub(sub(sqr(r), j), add(v, v))
    s1j = mul(s1, j)
    y3 = sub(mul(r, sub(v, x3)), add(s1j, s1j))
    z3 = mul(sub(sqr(add(z1, z2)), add(z1z1, z2z2)), h)
    return (x3, y3, z3)


def pneg(p):
    return (p[0], neg(p[1]), p[2])


def smul(p, k: int):
    """[k] p for k >= 0, four bits at a time."""
    table = [INF, p]
    for _ in range(14):
        table.append(padd(table[-1], p))
    out = INF
    for digit in "%x" % k:
        out = dbl(dbl(dbl(dbl(out))))
        d = int(digit, 16)
        if d:
            out = padd(out, table[d])
    return out


def psi(p):
    x, y, z = p
    return (mul((x[0], -x[1] % P), PSI_CX), mul((y[0], -y[1] % P), PSI_CY), (z[0], -z[1] % P))


def affine(p):
    zi = inv(p[2])
    zi2 = sqr(zi)
    return mul(p[0], zi2), mul(p[1], mul(zi2, zi))


def compress(p) -> bytes:
    if p[2] == ZERO:
        return bytes([0xC0]) + bytes(95)
    x, y = affine(p)
    flag = 0xA0 if (y[1], y[0]) > (-y[1] % P, -y[0] % P) else 0x80
    raw = x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big")
    return bytes([raw[0] | flag]) + raw[1:]


# -- hash to G2 (RFC 9380) --------------------------------------------------

def expand_message_xmd(msg: bytes, dst: bytes, n: int) -> bytes:
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(bytes(64) + msg + n.to_bytes(2, "big") + b"\x00" + dst_prime).digest()
    out = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, (n + 31) // 32 + 1):
        prev = bytes(a ^ b for a, b in zip(b0, out[-1]))
        out.append(hashlib.sha256(prev + bytes([i]) + dst_prime).digest())
    return b"".join(out)[:n]


def _horner(coeffs, x: F2) -> F2:
    acc = ZERO
    for c in reversed(coeffs):
        acc = add(mul(acc, x), c)
    return acc


def map_to_curve(u: F2):
    """Simplified SWU on E2', then the 3-isogeny to E2: a Jacobian point."""
    zu2 = mul(ISO_Z, sqr(u))
    tv1 = add(sqr(zu2), zu2)
    if tv1 == ZERO:
        x1 = mul(ISO_B, inv(mul(ISO_Z, ISO_A)))
    else:
        x1 = mul(mul(neg(ISO_B), inv(ISO_A)), add(ONE, inv(tv1)))
    gx1 = add(mul(add(sqr(x1), ISO_A), x1), ISO_B)
    y = sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x = mul(zu2, x1)
        y = sqrt(add(mul(add(sqr(x), ISO_A), x), ISO_B))
    if sgn0(u) != sgn0(y):
        y = neg(y)
    xo = mul(_horner(X_NUM, x), inv(_horner(X_DEN, x)))
    yo = mul(mul(y, _horner(Y_NUM, x)), inv(_horner(Y_DEN, x)))
    return (xo, yo, ONE)


def mul_x(p):
    """[x] p for the curve parameter x = -X_ABS."""
    return pneg(smul(p, X_ABS))


def hash_to_g2(msg: bytes, dst: bytes = DST):
    uni = expand_message_xmd(msg, dst, 256)
    u = [(int.from_bytes(uni[128 * i:128 * i + 64], "big") % P,
          int.from_bytes(uni[128 * i + 64:128 * i + 128], "big") % P) for i in range(2)]
    p = padd(map_to_curve(u[0]), map_to_curve(u[1]))
    # Budroni-Pintore: [x^2 - x - 1] p + [x - 1] psi(p) + psi^2([2] p)
    xp = mul_x(p)
    x2p = mul_x(xp)
    part1 = padd(padd(x2p, pneg(xp)), pneg(p))
    part2 = psi(padd(xp, pneg(p)))
    part3 = psi(psi(dbl(p)))
    return padd(padd(part1, part2), part3)


# -- verdicts ---------------------------------------------------------------

def expected_signature(members: Sequence[int], msg: bytes, h=None) -> bytes:
    """The one signature that verifies for validators ``members`` over
    ``msg``: [sum(i + 1)] H(msg), compressed."""
    a = (sum(members) + len(members)) % R
    return compress(smul(h if h is not None else hash_to_g2(msg), a))


def set_verifies(sig: bytes, members: Sequence[int], msg: bytes, h=None) -> bool:
    return bool(members) and bytes(sig) == expected_signature(members, msg, h)


def verdicts(sets: Sequence[Tuple[bytes, Sequence[int], bytes]]) -> List[bool]:
    """Per set (signature, members, message): does it verify? Each
    message is hashed once."""
    hashed: Dict[bytes, tuple] = {}
    out = []
    for sig, members, msg in sets:
        h = hashed.get(msg)
        if h is None:
            h = hashed[msg] = hash_to_g2(msg)
        out.append(set_verifies(sig, members, msg, h))
    return out
