"""BLS12-381 base field Fq and its quadratic extension Fq2 over Python
integers: the port's host oracle.

Fq2 = Fq[u]/(u^2+1); the sextic non-residue is xi = 1+u. Plain
(non-Montgomery) arithmetic. The device stack (``crypto/device``) uses
12-bit limb arithmetic and is tested against this module. Only what the
port uses is kept: the Frobenius constants of the Fp6/Fp12 tower are
computed here and embedded by ``device/tower.py``, and :class:`Fq6` /
:class:`Fq12` only hold the values ``device/tower.py`` packs and unpacks.
"""

from __future__ import annotations

from ..params import P


class Fq:
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o: "Fq") -> "Fq":
        return Fq(self.n + o.n)

    def __sub__(self, o: "Fq") -> "Fq":
        return Fq(self.n - o.n)

    def __mul__(self, o: "Fq") -> "Fq":
        return Fq(self.n * o.n)

    def __neg__(self) -> "Fq":
        return Fq(-self.n)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq) and self.n == o.n

    def __hash__(self):
        return hash(("Fq", self.n))

    def __repr__(self):
        return f"Fq(0x{self.n:x})"

    def is_zero(self) -> bool:
        return self.n == 0

    def square(self) -> "Fq":
        return Fq(self.n * self.n)

    def inverse(self) -> "Fq":
        if self.n == 0:
            raise ZeroDivisionError("Fq inverse of zero")
        return Fq(pow(self.n, P - 2, P))

    def pow(self, e: int) -> "Fq":
        return Fq(pow(self.n, e, P))

    def is_square(self) -> bool:
        return self.n == 0 or pow(self.n, (P - 1) // 2, P) == 1

    def sqrt(self) -> "Fq | None":
        # p == 3 (mod 4): candidate root is x^((p+1)/4).
        c = pow(self.n, (P + 1) // 4, P)
        if c * c % P != self.n:
            return None
        return Fq(c)

    def sgn0(self) -> int:
        return self.n & 1

    @staticmethod
    def zero() -> "Fq":
        return Fq(0)

    @staticmethod
    def one() -> "Fq":
        return Fq(1)


class Fq2:
    """c0 + c1*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq, c1: Fq):
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def from_ints(c0: int, c1: int) -> "Fq2":
        return Fq2(Fq(c0), Fq(c1))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fq2", self.c0.n, self.c1.n))

    def __repr__(self):
        return f"Fq2(0x{self.c0.n:x}, 0x{self.c1.n:x})"

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def square(self) -> "Fq2":
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        a0, a1 = self.c0, self.c1
        t = a0 * a1
        return Fq2((a0 + a1) * (a0 - a1), t + t)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def scale(self, k: Fq) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def inverse(self) -> "Fq2":
        # (a - bu) / (a^2 + b^2)
        d = (self.c0.square() + self.c1.square()).inverse()
        return Fq2(self.c0 * d, -(self.c1 * d))

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_square(self) -> bool:
        # norm = a^2 + b^2 must be a square in Fq (x^((p^2-1)/2) = norm^((p-1)/2)).
        return (self.c0.square() + self.c1.square()).is_square()

    def sqrt(self) -> "Fq2 | None":
        """Square root via the p == 3 (mod 4) extension-field algorithm."""
        if self.is_zero():
            return self
        a1 = self.pow((P - 3) // 4)
        x0 = a1 * self
        alpha = a1 * x0
        if alpha == Fq2(Fq(P - 1), Fq(0)):
            # sqrt = u * x0
            out = Fq2(-x0.c1, x0.c0)
        else:
            b = (Fq2.one() + alpha).pow((P - 1) // 2)
            out = b * x0
        if out.square() == self:
            return out
        return None

    def sgn0(self) -> int:
        # RFC 9380 §4.1 sgn0 for m=2.
        s0 = self.c0.n & 1
        z0 = self.c0.n == 0
        s1 = self.c1.n & 1
        return s0 | (int(z0) & s1)

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(Fq(0), Fq(0))

    @staticmethod
    def one() -> "Fq2":
        return Fq2(Fq(1), Fq(0))


# Non-residue used for the sextic extension: xi = 1 + u.
XI = Fq2.from_ints(1, 1)


class Fq6:
    """c0 + c1*v + c2*v^2 over Fq2 with v^3 = xi: a value holder for the
    device tower's host unpacking (``device/tower.unpack_f12``)."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0 = c0
        self.c1 = c1
        self.c2 = c2

    def __eq__(self, o) -> bool:
        return (isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1
                and self.c2 == o.c2)

    def __hash__(self):
        return hash(("Fq6", self.c0, self.c1, self.c2))


class Fq12:
    """c0 + c1*w over Fq6 with w^2 = v (a value holder, as :class:`Fq6`)."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0 = c0
        self.c1 = c1

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fq12", self.c0, self.c1))


# Frobenius constants, computed once at import (derivable public values).
#   gamma6_1 = xi^((p-1)/3), gamma6_2 = xi^(2(p-1)/3)  (Fq6 Frobenius)
#   gamma12  = xi^((p-1)/6)                            (Fq12 Frobenius)
GAMMA6_1 = XI.pow((P - 1) // 3)
GAMMA6_2 = XI.pow(2 * (P - 1) // 3)
GAMMA12 = XI.pow((P - 1) // 6)
