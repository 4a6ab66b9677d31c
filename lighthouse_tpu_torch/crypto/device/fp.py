"""BLS12-381 base field Fp on the card: 12-bit x 32 limb arithmetic in int32.

The layout is the JAX package's, so the two are held against each other on
the same arrays:

* An Fp element is ``int32[..., 32]``: 32 little-endian limbs of 12 bits.
  Leading dims are batch dims; every op broadcasts.
* Values are kept *relaxed*: limbs in ``[0, LIMB_MAX]``, only congruent
  mod p. :func:`canonical` produces the unique strict representative.
* A product is 63 exact schoolbook columns (peak ``32 * 8191**2 < 2**31``)
  reduced mod p by :func:`reduce_cols`: parallel carry rounds and folds of
  the limbs >= 32 through the ``2**(12 i) mod p`` table ``FOLD``. The
  carry/fold schedule is planned in plain Python from exact per-column
  bounds (:func:`plan`), with an int32-overflow assert on every
  intermediate. The same plans are compiled into the CUDA kernels
  (``kernels.py``), so kernel and plain version agree limb for limb.
* Subtraction adds the "saturated" multiple ``SAT`` of p (every digit
  >= LIMB_MAX), so ``x - y + SAT`` is limb-wise non-negative.

:func:`mul` is the funnel every Fp2/Fp6/Fp12/curve/pairing product drains
into. It runs the active engine, the JAX package's switch and names:

* ``pallas_int8`` (the default): kernel K1 (``kernels.fp_mul``), the port
  of the Pallas kernel;
* ``toeplitz_int32``: the banded-Toeplitz schoolbook product as two
  16-limb half dots with one carry round each;
* ``matmul_int8``: both operands split into int8 halves, four half
  products recombined with shifts (the TPU's MXU shape).

The two composed engines are plain torch: CUDA torch has no integer
matmul, so their dots are broadcast multiply-sums in int32, as K1's plain
version is. Select with ``LIGHTHOUSE_TPU_FP_IMPL`` (read at import),
:func:`set_impl` or the :func:`impl` context. A captured CUDA graph holds
the engine it was captured under, and its key names that engine
(``graphs.engines``); ``crypto.device.reset_compiled_state()`` drops the
graphs and the warm-shape registry after a switch. Everything else here
is plain torch on whatever device its inputs lie on.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..params import P

# ---------------------------------------------------------------------------
# Layout constants
# ---------------------------------------------------------------------------

ELEM_NDIM = 1             # trailing element dims of an fp array: (NL,)
W = 12                    # bits per limb
NL = 32                   # limbs per element (384 bits >= 381)
MASK = (1 << W) - 1       # 0xFFF
LIMB_MAX = 8191           # relaxed per-limb bound maintained by reduce_cols
NCOLS = 2 * NL - 1        # full-product column count

# The int8 limb split of the TPU's MXU engines: the smallest shift whose
# high half fits a signed int8 (hi = limb >> 6 <= 127, lo = limb & 63).
# The Hopper kernels do not split limbs; the ``matmul_int8`` engine does.
_INT8_MAX = 127
SPLIT_SHIFT = next(s for s in range(1, 13) if (LIMB_MAX >> s) <= _INT8_MAX)
SPLIT_MASK = (1 << SPLIT_SHIFT) - 1


# ---------------------------------------------------------------------------
# Host-side packing helpers
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> strict little-endian 12-bit limbs, int32[32]."""
    assert 0 <= x < 1 << (W * NL)
    return np.array([(x >> (W * i)) & MASK for i in range(NL)], np.int32)


def limbs_to_int(a) -> int:
    """Limb array (any relaxed representation) -> Python int value."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return sum(int(v) << (W * i) for i, v in enumerate(a.reshape(-1).tolist()))


def _digits(x: int, n: int) -> list[int]:
    return [(x >> (W * i)) & MASK for i in range(n)]


# ---------------------------------------------------------------------------
# Tables (numpy on the host; one tensor copy per device on first use)
# ---------------------------------------------------------------------------

# FOLD[i] = limbs of 2**(W*(NL+i)) mod p, for high limb NL+i.
_FOLD_HI = 64
FOLD = np.stack(
    [int_to_limbs(pow(1 << W, NL + i, P)) for i in range(_FOLD_HI)]
)  # [64, 32] int32, strict digits

# Banded-Toeplitz gather index/mask: band[a, c] = y[c - a] inside the band.
BAND_IDX = np.zeros((NL, NCOLS), np.int32)
BAND_MASK = np.zeros((NL, NCOLS), np.int32)
for _a in range(NL):
    for _c in range(NCOLS):
        _d = _c - _a
        if 0 <= _d < NL:
            BAND_IDX[_a, _c] = _d
            BAND_MASK[_a, _c] = 1


def _saturated_multiple() -> tuple[np.ndarray, int]:
    """SAT: digits all in [LIMB_MAX, ...], value = m * p (small search)."""
    S = sum(1 << (W * i) for i in range(NL))  # all-ones weight sum
    for m in range(10, 64):
        t = m * P - LIMB_MAX * S
        if t < 0:
            continue
        d = _digits(t, NL)
        if sum(v << (W * i) for i, v in enumerate(d)) != t:
            continue  # does not fit in 32 digits
        sat = [LIMB_MAX + v for v in d]
        if max(sat) * 2 < 2 ** 20:  # comfortably small
            return np.array(sat, np.int32), m
    raise AssertionError("no saturated multiple of p found")


SAT, _SAT_M = _saturated_multiple()
assert limbs_to_int(SAT) == _SAT_M * P

# Strict digits of 2**384 - k*p for the canonical conditional subtraction.
_CSUB_KS = (8, 4, 2, 1)
CSUB = np.stack([np.array(_digits((1 << (W * NL)) - k * P, NL), np.int32)
                 for k in _CSUB_KS])

ZERO = int_to_limbs(0)
ONE = int_to_limbs(1)

_HOST_TABLES = {
    "FOLD": FOLD,
    "SAT": SAT,
    "CSUB": CSUB,
    "BAND_IDX": BAND_IDX.astype(np.int64),
    "BAND_MASK": BAND_MASK,
}
_ON_DEVICE: dict = {}
# Guards the fills of the device caches (this one and ``LinMap``'s): a
# CUDA graph's warm-up fills them, and warm-ups run on more than one
# thread (``graphs.py``). A filled entry is read without the lock.
_FILL_LOCK = threading.Lock()


def on_device(key, device, make) -> torch.Tensor:
    """One device copy per (key, device) of the host array ``make()``.
    The copy is made at first use; a CUDA graph's capture only reads
    entries its warm-up made."""
    k = (key, torch.device(device))
    t = _ON_DEVICE.get(k)
    if t is None:
        with _FILL_LOCK:
            t = _ON_DEVICE.get(k)
            if t is None:
                t = torch.from_numpy(np.ascontiguousarray(make())).to(device)
                _ON_DEVICE[k] = t
    return t


def table(name: str, device) -> torch.Tensor:
    """The named host table as a tensor on ``device``."""
    return on_device(name, device, lambda: _HOST_TABLES[name])


# ---------------------------------------------------------------------------
# Reduction: columns -> relaxed 32-limb representative (mod p)
# ---------------------------------------------------------------------------

def _carry_bounds(bounds):
    """Bounds after one parallel carry round (widens by one limb)."""
    assert all(b < 2 ** 31 for b in bounds), f"int32 overflow risk: {bounds}"
    rb = [min(b, MASK) for b in bounds] + [0]
    cb = [0] + [b >> W for b in bounds]
    return [a + b for a, b in zip(rb, cb)]


def _fold_bounds(bounds):
    """Bounds after folding the limbs >= NL through FOLD."""
    k = len(bounds) - NL
    assert k > 0
    ob = [bounds[i] + sum(bounds[NL + h] * int(FOLD[h, i]) for h in range(k))
          for i in range(NL)]
    assert all(b < 2 ** 31 for b in ob), f"fold overflow risk: {ob}"
    return ob


def _fold_safe(bounds) -> bool:
    k = len(bounds) - NL
    if k <= 0:
        return False
    return all(
        bounds[i] + sum(bounds[NL + h] * int(FOLD[h, i]) for h in range(k))
        < 2 ** 31
        for i in range(NL)
    )


@functools.lru_cache(maxsize=None)
def plan(bounds: tuple) -> tuple:
    """The reduction schedule for columns with these exact upper bounds:
    a tuple of steps, ``0`` for a carry round and ``k > 0`` for a fold of
    the ``k`` limbs at and above NL. The same decisions as the JAX
    package's ``reduce_cols``; every intermediate is asserted < 2**31."""
    bounds = list(bounds)
    steps = []
    for _ in range(32):
        if len(bounds) == NL and max(bounds) <= LIMB_MAX:
            return tuple(steps)
        if _fold_safe(bounds):
            steps.append(len(bounds) - NL)
            bounds = _fold_bounds(bounds)
        else:
            steps.append(0)
            bounds = _carry_bounds(bounds)
    raise AssertionError(f"reduction did not converge: {bounds}")


def _carry_round(cols):
    """new[i] = (cols[i] & MASK) + (cols[i-1] >> W); one limb wider."""
    return F.pad(cols & MASK, (0, 1)) + F.pad(cols >> W, (1, 0))


def _fold_round(cols, k: int):
    """Fold limbs NL..NL+k-1 through the 2**(12i) mod p table (exact)."""
    fold = table("FOLD", cols.device)[:k]
    hi = cols[..., NL:].unsqueeze(-1) * fold            # [..., k, NL]
    return cols[..., :NL] + hi.sum(-2, dtype=torch.int32)


def _carry_fold1(cols):
    """A carry round on 32 limbs followed by the fold of the one new limb,
    in one expression: the same integers as the two steps, fewer ops."""
    c = cols >> W
    fold0 = table("FOLD", cols.device)[0]
    return (cols & MASK) + F.pad(c[..., :-1], (1, 0)) + c[..., -1:] * fold0


def reduce_cols(cols, bounds):
    """Reduce arbitrary non-negative columns to the relaxed 32-limb form.

    ``bounds`` is a tuple (or list) of exact per-column upper bounds; the
    schedule comes from :func:`plan`."""
    if not isinstance(bounds, tuple):
        bounds = tuple(int(b) for b in bounds)
    assert cols.shape[-1] == len(bounds)
    steps = plan(bounds)
    i, n = 0, len(bounds)
    while i < len(steps):
        k = steps[i]
        if k == 0 and n == NL and i + 1 < len(steps) and steps[i + 1] == 1:
            cols = _carry_fold1(cols)
            i += 2
        elif k:
            cols, n, i = _fold_round(cols, k), NL, i + 1
        else:
            cols, n, i = _carry_round(cols), n + 1, i + 1
    return cols


def _overlap(c: int, lo: int, hi: int) -> int:
    """Number of a in [lo, hi) with 0 <= c - a < NL (terms in column c)."""
    return max(0, min(c, hi - 1) - max(lo, c - (NL - 1)) + 1)


# Exact per-column bound of the full 32-term schoolbook band
# (peak 32 * 8191**2 = 2,146,959,392 < 2**31).
MUL_COL_BOUNDS = tuple(_overlap(c, 0, NL) * LIMB_MAX ** 2 for c in range(NCOLS))
assert max(MUL_COL_BOUNDS) < 2 ** 31, "full-band columns must fit int32"

ADD_BOUNDS = (2 * LIMB_MAX,) * NL
SUB_BOUNDS = tuple(LIMB_MAX + int(v) for v in SAT)
SUB2_BOUNDS = tuple(LIMB_MAX + 2 * int(v) for v in SAT)


# ---------------------------------------------------------------------------
# Field operations (all broadcast over leading dims)
# ---------------------------------------------------------------------------

def add(x, y):
    return reduce_cols(x + y, ADD_BOUNDS)


def sub(x, y):
    return reduce_cols(x + (table("SAT", x.device) - y), SUB_BOUNDS)


NEG_BOUNDS = tuple(int(v) for v in SAT)


def neg(x):
    return reduce_cols(table("SAT", x.device) - x, NEG_BOUNDS)


def mul_small(x, k: int):
    """Multiply by a small non-negative Python int (k * LIMB_MAX < 2**31)."""
    assert 0 <= k and k * LIMB_MAX < 2 ** 31
    return reduce_cols(x * k, (k * LIMB_MAX,) * NL)


class LinMap:
    """A fixed linear map with small integer coefficients over stacked Fp
    elements, applied with ONE reduction:

        out[..., j, :] = sum_i C[j, i] * x[..., i, :]   (mod p)

    Negative coefficients are paid for with ``SAT`` so every column stays
    non-negative: ``C x + n_j SAT`` with ``n_j`` the sum of row j's
    negative magnitudes. The column bounds (max over the rows) are exact
    and feed :func:`plan`. It replaces a chain of add/sub/neg/mul_small
    calls, each with its own reduction, by one multiply-sum and one
    reduction; the value mod p is the chain's."""

    def __init__(self, coeffs):
        c = np.asarray(coeffs, np.int64)
        assert c.ndim == 2
        neg_n = (-np.minimum(c, 0)).sum(axis=1)
        pos_n = np.maximum(c, 0).sum(axis=1)
        offset = neg_n[:, None] * SAT.astype(np.int64)[None, :]
        bounds = pos_n[:, None] * LIMB_MAX + offset
        assert int(bounds.max()) < 2 ** 31 and int(np.abs(c).sum(1).max()) * 2 ** 13 < 2 ** 31
        self.bounds = tuple(int(b) for b in bounds.max(axis=0))
        self._host = (c.astype(np.int32), offset.astype(np.int32))
        self._dev: dict = {}

    def __call__(self, xs):
        """xs [..., I, NL] relaxed -> [..., J, NL] relaxed."""
        key = xs.device
        t = self._dev.get(key)
        if t is None:
            with _FILL_LOCK:
                t = self._dev.get(key)
                if t is None:
                    c, off = self._host
                    t = (torch.from_numpy(c).to(key).unsqueeze(-1),
                         torch.from_numpy(off).to(key))
                    self._dev[key] = t
        c, off = t
        out = (xs.unsqueeze(-3) * c).sum(-2, dtype=torch.int32) + off
        return reduce_cols(out, self.bounds)


# ---------------------------------------------------------------------------
# Multiplication engines and their switch
# ---------------------------------------------------------------------------

_H = NL // 2
# Exact column bounds of the two 16-limb halves of the schoolbook band.
_HALF_BOUNDS = (
    tuple(_overlap(c, 0, _H) * LIMB_MAX ** 2 for c in range(NCOLS)),
    tuple(_overlap(c, _H, NL) * LIMB_MAX ** 2 for c in range(NCOLS)),
)
# The shifted high-high partial is the largest recombination intermediate.
assert (NL * (LIMB_MAX >> SPLIT_SHIFT) ** 2 << (2 * SPLIT_SHIFT)) < 2 ** 31, \
    "hh<<2S recombination must fit int32"


def band_matrix(y):
    """Gather ``y`` into the ``[..., NL, NCOLS]`` banded-Toeplitz matrix
    (``band[a, c] = y[c - a]`` inside the band) every engine contracts."""
    return y[..., table("BAND_IDX", y.device)] * table("BAND_MASK", y.device)


def _dot(x, band):
    """``cols[..., c] = sum_a x[..., a] band[..., a, c]``, int32 products
    and sums (no integer matmul on CUDA)."""
    return (x.unsqueeze(-1) * band).sum(-2, dtype=torch.int32)


def _mul_toeplitz_int32(x, y):
    """Banded-Toeplitz schoolbook product, split into two 16-limb dots;
    each half gets one carry round before the halves are added and
    reduced (the JAX package's per-half schedule and bounds)."""
    x, y = torch.broadcast_tensors(x, y)
    band = band_matrix(y)
    cols, bounds = [], []
    for sl, hb in zip((slice(0, _H), slice(_H, NL)), _HALF_BOUNDS):
        cols.append(_carry_round(_dot(x[..., sl], band[..., sl, :])))
        bounds.append(_carry_bounds(hb))
    return reduce_cols(cols[0] + cols[1], tuple(a + b for a, b in zip(*bounds)))


def split_int8(a):
    """Stack the int8-ranged halves of limb array ``a`` on a NEW leading
    axis: ``out[0] = a >> SPLIT_SHIFT`` (<= 127), ``out[1] = a &
    SPLIT_MASK`` (<= 63). Valid for any value in [0, LIMB_MAX]."""
    return torch.stack([a >> SPLIT_SHIFT, a & SPLIT_MASK], dim=0).to(torch.int8)


def recombine_int8_passes(passes):
    """``passes[i, j] = (x half i) . (band half j)`` int32 columns ->
    the exact product columns via shifts (peak ``max(MUL_COL_BOUNDS)``)."""
    hh, hl = passes[0, 0], passes[0, 1]
    lh, ll = passes[1, 0], passes[1, 1]
    return (hh << (2 * SPLIT_SHIFT)) + ((hl + lh) << SPLIT_SHIFT) + ll


def _mul_matmul_int8(x, y):
    """The int8 decomposition: both operands split into int8 halves, the
    four half products ``x_i . band_j`` recombined with shifts into the
    exact columns, reduced with the full-band bounds. torch multiplies
    int8 by int8 in int8 (it wraps), so the halves are widened to int32
    before every product and sum."""
    x, y = torch.broadcast_tensors(x, y)
    xs = split_int8(x).to(torch.int32)                # [2, ..., NL]
    bs = split_int8(band_matrix(y)).to(torch.int32)   # [2, ..., NL, NCOLS]
    passes = _dot(xs.unsqueeze(1), bs.unsqueeze(0))   # [2, 2, ..., NCOLS]
    return reduce_cols(recombine_int8_passes(passes), MUL_COL_BOUNDS)


def _mul_pallas_int8(x, y):
    """Kernel K1 on the card, its plain version on the CPU."""
    return _kernels.fp_mul(x, y)


IMPL_TOEPLITZ_INT32 = "toeplitz_int32"
IMPL_MATMUL_INT8 = "matmul_int8"
IMPL_PALLAS_INT8 = "pallas_int8"

_MUL_IMPLS = {
    IMPL_TOEPLITZ_INT32: _mul_toeplitz_int32,
    IMPL_MATMUL_INT8: _mul_matmul_int8,
    IMPL_PALLAS_INT8: _mul_pallas_int8,
}

_active_impl = os.environ.get("LIGHTHOUSE_TPU_FP_IMPL", IMPL_PALLAS_INT8)
if _active_impl not in _MUL_IMPLS:
    raise KeyError(f"LIGHTHOUSE_TPU_FP_IMPL={_active_impl!r} unknown; "
                   f"have {sorted(_MUL_IMPLS)}")


def get_impl() -> str:
    return _active_impl


def set_impl(name: str) -> None:
    """Select the ``fp.mul`` engine for later calls. Captured graphs keep
    the engine they hold, under a key that names it."""
    global _active_impl
    if name not in _MUL_IMPLS:
        raise KeyError(f"unknown fp impl {name!r}; have {sorted(_MUL_IMPLS)}")
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
    """Product mod p under the active engine."""
    return _MUL_IMPLS[_active_impl](x, y)


def sq(x):
    return mul(x, x)


# ---------------------------------------------------------------------------
# Canonicalization and predicates
# ---------------------------------------------------------------------------

def _seq_carry(cols):
    """Exact carry over limbs -> (strict digits, carry_out): the result of
    a sequential carry, in a fixed number of parallel steps. Three
    parallel carry rounds bring any non-negative int32 limbs to [0, 4096]
    (bounds 2**31 -> 4095 + 2**19 -> 4095 + 128 -> 4096); the remaining
    ripple of a 4096 through a run of 4095s is resolved by carry
    lookahead: the carry into limb i is set iff the last limb before i
    that is not 4095 is a 4096."""
    carry = torch.zeros_like(cols[..., 0])
    for _ in range(3):
        c = cols >> W
        carry = carry + c[..., -1]
        cols = (cols & MASK) + F.pad(c[..., :-1], (1, 0))
    gen = cols > MASK
    pos = torch.arange(cols.shape[-1], device=cols.device)
    last = torch.where(cols == MASK, -1, pos).cummax(dim=-1).values
    # before[..., i]: the last limb < i that is not 4095 (-1: none)
    before = F.pad(last, (1, 0), value=-1)                  # [..., n + 1]
    k = (before[..., :-1] >= 0) & torch.gather(gen, -1, before[..., :-1].clamp(min=0))
    k_out = (before[..., -1] >= 0) & torch.gather(gen, -1, last[..., -1:].clamp(min=0))[..., 0]
    return (cols + k) & MASK, carry + k_out


def canonical(x):
    """Unique strict representative in [0, p), digits in [0, 4095]."""
    d, c = _seq_carry(x)
    # Relaxed values are < 2.0003 * 2**384, so the first carry-out is at
    # most 2; two fold-and-recarry rounds bring the value below 2**384.
    fold0 = table("FOLD", x.device)[0]
    for _ in range(2):
        d = d + c[..., None] * fold0
        d, c = _seq_carry(d)
    # Now x < 2**384 < 16p: conditional cascade subtract 8p, 4p, 2p, p.
    csub = table("CSUB", x.device)
    for i in range(len(_CSUB_KS)):
        s, c = _seq_carry(d + csub[i])
        d = torch.where((c == 1)[..., None], s, d)
    return d


def is_zero(x):
    """Boolean [...] mask: value == 0 mod p."""
    return torch.all(canonical(x) == 0, dim=-1)


def eq(x, y):
    return torch.all(canonical(x) == canonical(y), dim=-1)


def select(mask, a, b):
    """mask [...] bool -> elementwise field select."""
    return torch.where(mask[..., None], a, b)


# ---------------------------------------------------------------------------
# Exponentiation (fixed Python-int exponent) and inversion
# ---------------------------------------------------------------------------

def square_multiply(x, e: int, sq_fn, mul_fn):
    """Fixed-exponent square-and-multiply, MSB first, shared by every
    pow_const of the device stack. The exponent is a Python constant, so
    each bit is a Python branch: a zero bit costs no multiply."""
    assert e >= 1
    acc = x
    for bit in bin(e)[3:]:
        acc = sq_fn(acc)
        if bit == "1":
            acc = mul_fn(acc, x)
    return acc


def pow_const(x, e: int):
    return square_multiply(x, e, sq, mul)


def inv(x):
    """Fermat inverse x**(p-2); inv(0) = 0 (callers mask separately)."""
    return pow_const(x, P - 2)


# ---------------------------------------------------------------------------
# Constants on a device
# ---------------------------------------------------------------------------

def const(v: int, device):
    """A fixed field value as int32[32] on ``device`` (cached)."""
    v %= P
    return on_device(("fp", v), device, lambda: int_to_limbs(v))


def zeros(shape, device):
    return torch.zeros((*shape, NL), dtype=torch.int32, device=device)


def ones(shape, device):
    return const(1, device).expand(*shape, NL).clone()


from . import kernels as _kernels  # noqa: E402  (kernels imports this module)
