"""BLS12-381 curve groups G1/E1(Fq) and G2/E2(Fq2) on the host: affine
point arithmetic, subgroup checks and the ZCash-style compressed
serialization the consensus layer standardised (48-byte G1 public keys,
96-byte G2 signatures). The port's own copy of the JAX package's host
oracle; the device stack is held against it.
"""

from __future__ import annotations

from typing import Generic, TypeVar

from ..params import (
    B1,
    B2,
    G1_X,
    G1_Y,
    G2_X0,
    G2_X1,
    G2_Y0,
    G2_Y1,
    P,
    R,
)
from .fields import Fq, Fq2

F = TypeVar("F")


class AffinePoint(Generic[F]):
    """Affine short-Weierstrass point y^2 = x^3 + b, with the point at
    infinity encoded by ``inf=True``. Field-generic: works over Fq and Fq2."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x, y, inf: bool = False):
        self.x = x
        self.y = y
        self.inf = inf

    # -- group law -----------------------------------------------------------

    def is_infinity(self) -> bool:
        return self.inf

    def __eq__(self, o) -> bool:
        if not isinstance(o, AffinePoint):
            return NotImplemented
        if self.inf or o.inf:
            return self.inf and o.inf
        return self.x == o.x and self.y == o.y

    def __hash__(self):
        return hash((type(self).__name__, self.inf, None if self.inf else (self.x, self.y)))

    def __neg__(self):
        if self.inf:
            return self
        return type(self)(self.x, -self.y)

    def double(self):
        if self.inf or self.y.is_zero():
            return type(self).infinity()
        # lambda = 3x^2 / 2y  (a = 0)
        x2 = self.x.square()
        lam = (x2 + x2 + x2) * (self.y + self.y).inverse()
        x3 = lam.square() - self.x - self.x
        y3 = lam * (self.x - x3) - self.y
        return type(self)(x3, y3)

    def __add__(self, o):
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if self.y == o.y:
                return self.double()
            return type(self).infinity()
        lam = (o.y - self.y) * (o.x - self.x).inverse()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return type(self)(x3, y3)

    def __sub__(self, o):
        return self + (-o)

    def mul(self, k: int):
        """Scalar multiplication (double-and-add, MSB-first)."""
        if k < 0:
            return (-self).mul(-k)
        acc = type(self).infinity()
        if k == 0 or self.inf:
            return acc
        for bit in bin(k)[2:]:
            acc = acc.double()
            if bit == "1":
                acc = acc + self
        return acc

    def in_subgroup(self) -> bool:
        return self.mul(R).is_infinity()

    # -- subclass hooks ------------------------------------------------------

    @classmethod
    def infinity(cls):
        raise NotImplementedError

    def is_on_curve(self) -> bool:
        raise NotImplementedError


class G1Point(AffinePoint):
    @classmethod
    def infinity(cls) -> "G1Point":
        return cls(Fq(0), Fq(0), inf=True)

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        return self.y.square() == self.x.square() * self.x + Fq(B1)

    # ZCash compressed encoding: 48 bytes big-endian x with flag bits in the
    # top 3 bits of byte 0: 0x80 compressed, 0x40 infinity, 0x20 y is the
    # lexicographically larger root.
    def compress(self) -> bytes:
        if self.inf:
            return bytes([0xC0] + [0] * 47)
        flags = 0x80
        if self.y.n * 2 > P:
            flags |= 0x20
        raw = self.x.n.to_bytes(48, "big")
        return bytes([raw[0] | flags]) + raw[1:]

    @classmethod
    def decompress(cls, data: bytes) -> "G1Point":
        if len(data) != 48:
            raise ValueError("G1 compressed point must be 48 bytes")
        flags = data[0] >> 5
        if not flags & 0x4:
            raise ValueError("uncompressed G1 encoding not supported")
        x_int = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
        if flags & 0x2:  # infinity
            if x_int != 0 or flags & 0x1:
                raise ValueError("malformed infinity encoding")
            return cls.infinity()
        if x_int >= P:
            raise ValueError("x out of range")
        x = Fq(x_int)
        y = (x.square() * x + Fq(B1)).sqrt()
        if y is None:
            raise ValueError("x not on curve")
        greater = y.n * 2 > P
        if bool(flags & 0x1) != greater:
            y = -y
        return cls(x, y)


class G2Point(AffinePoint):
    @classmethod
    def infinity(cls) -> "G2Point":
        return cls(Fq2.zero(), Fq2.zero(), inf=True)

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        return self.y.square() == self.x.square() * self.x + Fq2.from_ints(*B2)

    def psi(self) -> "G2Point":
        from .pairing import psi  # local import to avoid cycle

        return psi(self)

    def compress(self) -> bytes:
        if self.inf:
            return bytes([0xC0] + [0] * 95)
        flags = 0x80
        # Lexicographic order on (c1, c0).
        if (self.y.c1.n, self.y.c0.n) > (((P - self.y.c1.n) % P), ((P - self.y.c0.n) % P)):
            flags |= 0x20
        raw = self.x.c1.n.to_bytes(48, "big") + self.x.c0.n.to_bytes(48, "big")
        return bytes([raw[0] | flags]) + raw[1:]

    @classmethod
    def decompress(cls, data: bytes) -> "G2Point":
        if len(data) != 96:
            raise ValueError("G2 compressed point must be 96 bytes")
        flags = data[0] >> 5
        if not flags & 0x4:
            raise ValueError("uncompressed G2 encoding not supported")
        x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
        x0 = int.from_bytes(data[48:], "big")
        if flags & 0x2:  # infinity
            if x0 != 0 or x1 != 0 or flags & 0x1:
                raise ValueError("malformed infinity encoding")
            return cls.infinity()
        if x0 >= P or x1 >= P:
            raise ValueError("x out of range")
        x = Fq2.from_ints(x0, x1)
        y = (x.square() * x + Fq2.from_ints(*B2)).sqrt()
        if y is None:
            raise ValueError("x not on curve")
        neg = -y
        greater = (y.c1.n, y.c0.n) > (neg.c1.n, neg.c0.n)
        if bool(flags & 0x1) != greater:
            y = neg
        return cls(x, y)


def g1_generator() -> G1Point:
    return G1Point(Fq(G1_X), Fq(G1_Y))


def g2_generator() -> G2Point:
    return G2Point(Fq2.from_ints(G2_X0, G2_X1), Fq2.from_ints(G2_Y0, G2_Y1))
