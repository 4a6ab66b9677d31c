"""Windowed multi-scalar multiplication (Pippenger) on the card: the port
of the JAX package's ``crypto/device/msm.py``.

``sum_i s_i * P_i`` over G1 with 64-bit scalars (the duty lookahead's
committee sums, with all scalars one), restated branch-free for a batch
machine:

* scalars split into ``N_WINDOWS`` windows of ``WINDOW_BITS`` bits (most
  significant window first);
* bucket sums ``B[w, j] = sum of P_i where digit_w(s_i) == j``, one masked
  tree reduction over the point axis batched over all
  ``N_WINDOWS x N_BUCKETS`` buckets at once (no scatter, no sort): K1 runs
  over ``[16, 15, N/2]``-lane products in its first round;
* per-window weighted sums ``W_w = sum_j j * B[w, j]`` by the running-sum
  trick (a Python loop over the buckets, highest first, where the JAX
  package scans);
* the Horner fold ``acc = 2^WINDOW_BITS * acc + W_w`` over the windows
  (a Python loop where the JAX package scans).

The complete group law makes masked, duplicate and infinity lanes safe
without branches. :func:`point_sum` (all scalars one) serves G2 sums,
where ``curve.add`` over :mod:`.fp2` runs K2 and K3.
"""

from __future__ import annotations

import torch

from ...compile_service.service import MSM_RUNGS
from . import curve, fp, fp2

WINDOW_BITS = 4
N_WINDOWS = 64 // WINDOW_BITS        # 16, most significant first
N_BUCKETS = (1 << WINDOW_BITS) - 1   # 15; digit 0 occupies no bucket


def msm_rung(n: int):
    """The smallest rung of the compile service's ``MSM_RUNGS`` (the
    padded point counts the MSM and G2 sum are warmed at) holding ``n``
    points, or None above the ladder."""
    return next((r for r in MSM_RUNGS if r >= n), None)


def window_digits(scalars):
    """int32[..., 2] (hi, lo) words of a u64 -> int32[..., N_WINDOWS]
    window digits, most significant window first. The words are widened
    to int64 and masked to their unsigned value before shifting."""
    words = scalars.to(torch.int64) & 0xFFFFFFFF
    hi, lo = words[..., 0], words[..., 1]
    mask = (1 << WINDOW_BITS) - 1
    digs = []
    for w in range(N_WINDOWS):
        bit = 64 - (w + 1) * WINDOW_BITS
        word = hi if bit >= 32 else lo
        digs.append((word >> (bit % 32)) & mask)
    return torch.stack(digs, dim=-1).to(torch.int32)


def _bucket_points(F, proj, digits, n):
    """Masked bucket occupancy: the projective batch broadcast to
    ``[N_WINDOWS, N_BUCKETS, n]``, infinity wherever the point's window
    digit is not the bucket's index."""
    dev = digits.device
    j = torch.arange(1, N_BUCKETS + 1, dtype=torch.int32, device=dev)
    sel = digits.T[:, None, :] == j[None, :, None]   # [W, B, n]
    shape = (N_WINDOWS, N_BUCKETS, n)
    broad = tuple(c.expand(shape + c.shape[1:]) for c in proj)
    inf = tuple(c.expand(shape + c.shape) for c in curve.infinity(F, (), dev))
    return curve.select(F, sel, broad, inf)


def msm(F, pt_aff, scalars):
    """Windowed MSM over field module ``F``: ``pt_aff = (x, y, inf)``
    affine batch [n, ...], ``scalars`` int32 [n, 2] u64 words -> the
    projective result point (batch dims reduced)."""
    x, y, inf = pt_aff
    n = x.shape[0]
    dev = x.device
    proj = curve.from_affine(F, x, y, inf)
    digits = window_digits(scalars)                  # [n, W]
    masked = _bucket_points(F, proj, digits, n)      # [W, B, n] points
    buckets = curve.sum_points(F, masked, axis=2)    # [W, B] points

    # W_w = sum_j j * B[w, j] via running sums, highest bucket first:
    # run_k = sum_{j >= k} B_j, acc = sum_k run_k
    run = acc = curve.infinity(F, (N_WINDOWS,), dev)
    for j in range(N_BUCKETS - 1, -1, -1):
        run = curve.add(F, run, tuple(c[:, j] for c in buckets))
        acc = curve.add(F, acc, run)

    # Horner across the windows (most significant first)
    out = curve.infinity(F, (), dev)
    for w in range(N_WINDOWS):
        for _ in range(WINDOW_BITS):
            out = curve.dbl(F, out)
        out = curve.add(F, out, tuple(c[w] for c in acc))
    return out


def point_sum(F, pt_aff):
    """Masked affine point sum (all scalars one)."""
    x, y, inf = pt_aff
    return curve.sum_points(F, curve.from_affine(F, x, y, inf), axis=0)


def msm_g1_fn(pt_xy, pt_inf, scalars):
    """G1 windowed MSM: pt_xy int32[N, 2, NL] affine, pt_inf bool[N],
    scalars int32[N, 2] -> (xy int32[2, NL] canonical affine, inf bool[])."""
    acc = msm(fp, (pt_xy[:, 0], pt_xy[:, 1], pt_inf), scalars)
    ax, ay, ainf = curve.to_affine(fp, acc)
    return torch.stack([ax, ay], dim=0), ainf


def sum_g2_fn(pt_xy, pt_inf):
    """G2 masked point sum: pt_xy int32[N, 2, 2, NL] affine, pt_inf
    bool[N] -> (xy int32[2, 2, NL], inf bool[])."""
    acc = point_sum(fp2, (pt_xy[:, 0], pt_xy[:, 1], pt_inf))
    ax, ay, ainf = curve.to_affine(fp2, acc)
    return torch.stack([ax, ay], dim=0), ainf
