"""Symbolic linear forms over stacked field elements, compiled into
:class:`fp.LinMap` s.

The JAX package spells the additive glue of its formulas (the Karatsuba
and tower recombinations, the curve formulas between their product
batches, the Miller-loop steps) as chains of ``fp.add``/``fp.sub``, each
reduced on its own, and leaves them to XLA's fusion. In eager torch each
reduced add is a dozen small launches, so the port writes every such
chain once, symbolically, over unit forms of its inputs; the resulting
integer matrix is applied by one ``LinMap`` (one multiply-sum and one
reduction). Values are the chain's mod p; relaxed limbs may differ.

A symbolic element of degree d (1 for Fp, 2 for Fp2) is an int64 array
``[..., d, I]``: row c holds the coefficients of component c over the I
input components.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp


def units(n: int, d: int):
    """Symbolic forms of n stacked input elements of degree d."""
    e = np.eye(n * d, dtype=np.int64)
    return [e[k * d:(k + 1) * d] for k in range(n)]


def xi(a):
    """Multiply an Fp2 form by 1 + u: (a0 - a1, a0 + a1)."""
    return np.stack([a[..., 0, :] - a[..., 1, :], a[..., 0, :] + a[..., 1, :]], axis=-2)


def compile_map(outputs) -> fp.LinMap:
    """Symbolic outputs (each [..., I]) -> the LinMap over flattened rows."""
    return fp.LinMap(np.concatenate([o.reshape(-1, o.shape[-1]) for o in outputs]))


def apply(lm: fp.LinMap, xs, elem_ndim: int):
    """Apply ``lm`` to inputs stacked on dim -1-elem_ndim ([..., n, *E])
    -> [..., J, *E] where E are the element dims (limbs last)."""
    elem = xs.shape[xs.dim() - elem_ndim:]
    lead = xs.shape[: xs.dim() - elem_ndim - 1]
    flat = xs.reshape(*lead, -1, fp.NL)
    out = lm(flat)
    return out.reshape(*lead, -1, *elem)


def stack(elems, elem_ndim: int):
    """Stack elements (broadcasting batch dims) on dim -1-elem_ndim."""
    return torch.stack(torch.broadcast_tensors(*elems), dim=-1 - elem_ndim)
