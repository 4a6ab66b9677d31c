"""BLS12-381 quadratic extension Fp2 = Fp[u]/(u^2+1) on the card.

An Fp2 element is ``int32[..., 2, 32]``: axis -2 stacks (c0, c1), axis -1
is the 12-bit limb axis of :mod:`.fp`. All ops broadcast over leading batch
dims and mirror the host oracle ``crypto/cpu/fields.Fq2``.

:func:`mul` and :func:`sq` are the Fp2 funnels. They run the active
engine, the JAX package's switch and names:

* ``fused_pallas`` (the default): kernels K2 and K3 (``kernels.fp2_mul`` /
  ``kernels.fp2_sq``), which run the operand sums, the products, their
  reduction and the Karatsuba combine in one launch;
* ``composed``: the Karatsuba recombination as separate ops around one
  batched :func:`fp.mul`, so it inherits the active ``fp.mul`` engine.

Select with ``LIGHTHOUSE_TPU_FP2_IMPL`` (read at import), :func:`set_impl`
or the :func:`impl` context; captured graphs are keyed on the engine
(``graphs.engines``). :func:`mul_pairs` and :func:`sq_batch` stack many
products into one call.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from . import fp
from . import kernels

# Trailing element dims of an fp2 array: (2, NL).
ELEM_NDIM = 2


def pack(c0, c1):
    """Two fp elements [..., 32] -> one fp2 element [..., 2, 32]."""
    return torch.stack([c0, c1], dim=-2)


def c0(x):
    return x[..., 0, :]


def c1(x):
    return x[..., 1, :]


def const(v0: int, v1: int, device):
    """A fixed Fp2 value as int32[2, 32] on ``device`` (cached)."""
    v0, v1 = v0 % fp.P, v1 % fp.P
    return fp.on_device(("fp2", v0, v1), device,
                        lambda: np.stack([fp.int_to_limbs(v0), fp.int_to_limbs(v1)]))


def zeros(shape, device):
    return torch.zeros((*shape, 2, fp.NL), dtype=torch.int32, device=device)


def ones(shape, device):
    return pack(fp.ones(shape, device), fp.zeros(shape, device))


def add(x, y):
    return fp.add(x, y)  # limbwise; fp ops broadcast over the (2,) axis


def sub(x, y):
    return fp.sub(x, y)


def neg(x):
    return fp.neg(x)


def mul_small(x, k: int):
    return fp.mul_small(x, k)


def _bstack(elems, dim):
    """Stack with broadcasting to a common shape (constants vs batches)."""
    elems = torch.broadcast_tensors(*elems)
    return torch.stack(elems, dim=dim)


def _mul_composed(x, y):
    """(a0 + a1 u)(b0 + b1 u) by Karatsuba, the three Fp products stacked
    into ONE batched ``fp.mul``."""
    a0, a1 = c0(x), c1(x)
    b0, b1 = c0(y), c1(y)
    xs = _bstack([a0, a1, fp.add(a0, a1)], -2)
    ys = _bstack([b0, b1, fp.add(b0, b1)], -2)
    t = fp.mul(xs, ys)
    t0, t1, m = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    return pack(fp.sub(t0, t1), fp.sub(m, fp.add(t0, t1)))


def _sq_composed(x):
    """(a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u (one batched fp.mul)."""
    a0, a1 = c0(x), c1(x)
    xs = _bstack([fp.add(a0, a1), a0], -2)
    ys = _bstack([fp.sub(a0, a1), a1], -2)
    t = fp.mul(xs, ys)
    t2 = t[..., 1, :]
    return pack(t[..., 0, :], fp.add(t2, t2))


IMPL_COMPOSED = "composed"
IMPL_FUSED_PALLAS = "fused_pallas"

_IMPLS = {
    IMPL_COMPOSED: (_mul_composed, _sq_composed),
    IMPL_FUSED_PALLAS: (kernels.fp2_mul, kernels.fp2_sq),
}

_active_impl = os.environ.get("LIGHTHOUSE_TPU_FP2_IMPL", IMPL_FUSED_PALLAS)
if _active_impl not in _IMPLS:
    raise KeyError(f"LIGHTHOUSE_TPU_FP2_IMPL={_active_impl!r} unknown; "
                   f"have {sorted(_IMPLS)}")


def get_impl() -> str:
    return _active_impl


def set_impl(name: str) -> None:
    """Select the Fp2 engine for later calls (same contract as
    ``fp.set_impl``)."""
    global _active_impl
    if name not in _IMPLS:
        raise KeyError(f"unknown fp2 impl {name!r}; have {sorted(_IMPLS)}")
    _active_impl = name


@contextlib.contextmanager
def impl(name: str):
    """Scoped engine switch (restores the previous choice)."""
    prev = _active_impl
    set_impl(name)
    try:
        yield
    finally:
        set_impl(prev)


def mul(x, y):
    """Fp2 product under the active engine (K2 by default)."""
    return _IMPLS[_active_impl][0](x, y)


def sq(x):
    """Fp2 square under the active engine (K3 by default)."""
    return _IMPLS[_active_impl][1](x)


def mul_pairs(pairs):
    """[(x_i, y_i)] -> [x_i * y_i] with ALL products in one batched call
    (an Fp12 multiply is 27 Fp2 products in one K2 launch)."""
    xs = _bstack([p[0] for p in pairs], -3)
    ys = _bstack([p[1] for p in pairs], -3)
    out = mul(xs, ys)
    return [out[..., i, :, :] for i in range(len(pairs))]


def sq_batch(elems):
    """[x_i] -> [x_i^2] with all squarings in one batched call."""
    out = sq(_bstack(elems, -3))
    return [out[..., i, :, :] for i in range(len(elems))]


def conjugate(x):
    return pack(c0(x), fp.neg(c1(x)))


def scale(x, k):
    """Multiply both components by an fp element ``k`` [..., 32]."""
    return fp.mul(x, k.unsqueeze(-2))


def mul_by_u_plus_1(x):
    """Multiply by the sextic non-residue xi = 1 + u:
    (a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u."""
    a0, a1 = c0(x), c1(x)
    return pack(fp.sub(a0, a1), fp.add(a0, a1))


def inv(x):
    """(a0 - a1 u) / (a0^2 + a1^2); inv(0) = 0 (callers mask)."""
    s = fp.mul(x, x)
    d = fp.inv(fp.add(s[..., 0, :], s[..., 1, :]))
    t = fp.mul(x, d.unsqueeze(-2))
    return pack(t[..., 0, :], fp.neg(t[..., 1, :]))


def canonical(x):
    return fp.canonical(x)


def is_zero(x):
    return torch.all(canonical(x) == 0, dim=-1).all(dim=-1)


def eq(x, y):
    return torch.all(canonical(x) == canonical(y), dim=-1).all(dim=-1)


def select(mask, a, b):
    """mask [...] bool -> elementwise fp2 select."""
    return torch.where(mask[..., None, None], a, b)


def pow_const(x, e: int):
    """x**e for a fixed Python-int exponent (shared ladder in fp)."""
    return fp.square_multiply(x, e, sq, mul)
