"""Batched BLS signature-set verification on the card.

The port of the JAX package's staged verifier (``_staged_verify`` and its
three stages) and of its raw packer:

    per set i (batch lane i):
      agg_pk_i = sum of the set's pubkeys          (masked sum)
      sig subgroup check: psi(sig) == [x] sig      (64-bit ladder)
      r_i agg_pk_i, r_i sig_i                      (64-bit random scalars)
    sig_acc = sum_i r_i sig_i
    ok = FE( prod_i ML(r_i agg_pk_i, H(m_i)) * ML(-g1, sig_acc) ) == 1
         AND all subgroup checks AND all signature x on the curve

* stage 1 decompresses the signatures and maps the messages to G2, with
  the decompression square root and the 4M SSWU candidate roots in one
  shared ladder;
* stage 2 sums the pubkeys, checks the G2 subgroup and applies the
  random scalars;
* stage 3 runs the multi-Miller loop and the final exponentiation down to
  one bool.

Shapes (B sets, K max pubkeys per set, M distinct messages), as packed by
:func:`pack_signature_sets_raw`:

  pk_xy int32[B, K, 2, 32]   pk_mask bool[B, K]
  sig_x int32[B, 2, 32]      sig_larger bool[B]
  msg_u int32[M, 2, 2, 32]   msg_idx int32[B]
  rand  int32[B, 2]          (hi, lo) words of nonzero 64-bit scalars
  set_mask bool[B]           False = padding lane (must not affect result)

The whole path stays on the device; the only read back is the verdict.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..bls import parse_compressed_g2_x
from ..cpu.curve import g2_generator
from ..params import DST, G1_X, G1_Y, P
from . import curve, fp, fp2, htc, pairing
from .pairing import X_ABS

# -g1 generator.
_NEG_G1 = (G1_X, (P - G1_Y) % P)


def _psi_jacobian(pt):
    """Untwist-Frobenius-twist endomorphism on projective G2 points:
    (X, Y, Z) -> (conj(X) CX, conj(Y) CY, conj(Z))."""
    return htc.psi_jac(pt)


def g2_in_subgroup(pt):
    """Scott's membership test for G2 on BLS12-381: Q in G2 iff
    psi(Q) == [x]Q. Infinity passes."""
    xq = curve.neg(fp2, curve.scalar_mul_const(fp2, pt, X_ABS))  # x < 0
    return curve.eq(fp2, _psi_jacobian(pt), xq) | curve.is_infinity(fp2, pt)


def _bits64(r):
    """int32[..., 2] (hi, lo) -> MSB-first bits int32[..., 64]. The words
    are read as signed int32: an arithmetic shift, then ``& 1``."""
    hi, lo = r[..., 0], r[..., 1]
    shifts = torch.arange(31, -1, -1, dtype=torch.int32, device=r.device)
    hb = (hi[..., None] >> shifts) & 1
    lb = (lo[..., None] >> shifts) & 1
    return torch.cat([hb, lb], dim=-1)


_XBITS64 = np.array([(X_ABS >> (63 - i)) & 1 for i in range(64)], np.int32)
assert X_ABS.bit_length() == 64


def _fp_gt(a_digits, b_digits):
    """Strict canonical digits [..., NL] -> a > b (big-endian
    lexicographic: the most significant differing limb decides)."""
    diff = a_digits != b_digits
    gt = a_digits > b_digits
    idx = torch.arange(1, fp.NL + 1, dtype=torch.int64, device=a_digits.device)
    msd = torch.where(diff, idx, 0).amax(dim=-1)  # 0 == all equal
    pick = torch.gather(gt, -1, (msd - 1).clamp(min=0).unsqueeze(-1))[..., 0]
    return (msd > 0) & pick


def _decompress_pre(sig_x):
    """g(x) = x^3 + 4(1+u): the radicand awaiting a sqrt ladder."""
    return fp2.add(fp2.mul(fp2.sq(sig_x), sig_x), fp2.const(4, 4, sig_x.device))


def _decompress_post(sign_larger, y, ok):
    """Sign selection by the compressed flag's lexicographic-larger rule
    (c1 decides, then c0); ``y, ok`` are the sqrt outputs for
    ``_decompress_pre``'s radicand."""
    neg_y = fp2.neg(y)
    yc, negc = fp2.canonical(torch.stack([y, neg_y]))
    c1_gt = _fp_gt(yc[..., 1, :], negc[..., 1, :])
    c1_eq = torch.all(yc[..., 1, :] == negc[..., 1, :], dim=-1)
    c0_gt = _fp_gt(yc[..., 0, :], negc[..., 0, :])
    y_is_larger = c1_gt | (c1_eq & c0_gt)
    y_final = fp2.select(y_is_larger == sign_larger, y, neg_y)
    return y_final, ok


def _stage1_fn(sig_x, sig_larger, msg_u):
    """Decompression + hash-to-curve (all square roots in one ladder)."""
    B = sig_x.shape[0]
    M = msg_u.shape[0]
    gx_sig = _decompress_pre(sig_x)
    x1, x2, g = htc.sswu_pre(msg_u)
    stacked = torch.cat([gx_sig, g.reshape(4 * M, 2, fp.NL)], dim=0)
    roots, root_ok = htc.sqrt(stacked)
    y, sig_ok = _decompress_post(sig_larger, roots[:B], root_ok[:B])
    sig_xy = torch.stack([sig_x, y], dim=1)
    msg_pts = htc.map_to_g2_post(
        msg_u,
        x1,
        x2,
        roots[B:].reshape(M, 2, 2, 2, fp.NL),
        root_ok[B:].reshape(M, 2, 2),
    )
    mx, my, minf = curve.to_affine(fp2, msg_pts)
    return sig_xy, mx, my, minf, sig_ok


def _stage2_fn(pk_xy, pk_mask, sig_xy, rand_bits, set_mask):
    """Aggregation + subgroup checks + random scaling -> affine pairing
    inputs for the G1 side and the G2 signature accumulator."""
    B = pk_xy.shape[0]
    dev = pk_xy.device
    pk_pts = curve.from_affine(fp, pk_xy[..., 0, :], pk_xy[..., 1, :], ~pk_mask)
    agg_pk = curve.sum_points(fp, pk_pts, axis=1)

    sig_pts = curve.from_affine(fp2, sig_xy[..., 0, :, :], sig_xy[..., 1, :, :])
    bits = _bits64(rand_bits) if rand_bits.shape[-1] == 2 else rand_bits
    xbits = torch.from_numpy(_XBITS64).to(dev).expand(B, 64)
    # the subgroup check's [|x|]Q and the randomizer's [r]Q share one
    # double-and-add loop over the stacked [2B] lanes
    both = curve.scalar_mul_bits(
        fp2,
        tuple(torch.cat([c, c], dim=0) for c in sig_pts),
        torch.cat([xbits, bits], dim=0),
    )
    xq = curve.neg(fp2, tuple(c[:B] for c in both))
    r_sig = tuple(c[B:] for c in both)
    sub_ok = (
        curve.eq(fp2, _psi_jacobian(sig_pts), xq)
        | curve.is_infinity(fp2, sig_pts)
        | ~set_mask
    )
    subgroup_ok = torch.all(sub_ok)

    r_pk = curve.scalar_mul_bits(fp, agg_pk, bits)
    # padding lanes must not contribute to the signature accumulator
    inf2 = curve.infinity(fp2, (B,), dev)
    r_sig = curve.select(fp2, set_mask, r_sig, inf2)
    sig_acc = curve.sum_points(fp2, r_sig, axis=0)

    pk_x, pk_y, pk_inf = curve.to_affine(fp, r_pk)
    pk_inf = pk_inf | ~set_mask
    acc_x, acc_y, acc_inf = curve.to_affine(fp2, sig_acc)
    # a real lane whose aggregate pubkey degenerated to infinity must fail
    agg_inf_bad = torch.any(curve.is_infinity(fp, agg_pk) & set_mask)
    return pk_x, pk_y, pk_inf, acc_x, acc_y, acc_inf, subgroup_ok & ~agg_inf_bad


def _stage3_fn(pk_x, pk_y, pk_inf, msg_aff_x, msg_aff_y, msg_aff_inf,
               acc_x, acc_y, acc_inf):
    """The multi-pairing decision over B+1 lanes."""
    dev = pk_x.device
    g1_x = torch.cat([pk_x, fp.const(_NEG_G1[0], dev)[None]], dim=0)
    g1_y = torch.cat([pk_y, fp.const(_NEG_G1[1], dev)[None]], dim=0)
    g1_inf = torch.cat([pk_inf, torch.zeros((1,), dtype=torch.bool, device=dev)])
    g2_x = torch.cat([msg_aff_x, acc_x[None]], dim=0)
    g2_y = torch.cat([msg_aff_y, acc_y[None]], dim=0)
    g2_inf = torch.cat([msg_aff_inf, acc_inf[None]], dim=0)
    return pairing.multi_pairing_is_one(
        (g1_x, g1_y, g1_inf), (g2_x, g2_y, g2_inf)
    )


def _staged_verify(
    pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand_bits, set_mask
):
    """The three stages over packed planes -> a 0-dim bool tensor on the
    device (no host sync inside)."""
    sig_xy, mx, my, minf, sig_ok = _stage1_fn(sig_x, sig_larger, msg_u)
    pk_x, pk_y, pk_inf, acc_x, acc_y, acc_inf, flags_ok = _stage2_fn(
        pk_xy, pk_mask, sig_xy, rand_bits, set_mask
    )
    idx = msg_idx.long()
    pair_ok = _stage3_fn(
        pk_x, pk_y, pk_inf, mx[idx], my[idx], minf[idx], acc_x, acc_y, acc_inf
    )
    return pair_ok & flags_ok & torch.all(sig_ok | ~set_mask)


# ---------------------------------------------------------------------------
# Host packing
# ---------------------------------------------------------------------------

# 48/96/192 are intermediate rungs for bin-packed sub-batches; the ladder
# is the JAX package's, so both pad to the same shapes.
def _round_up(
    n: int,
    choices=(1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256, 512, 1024),
) -> int:
    for c in choices:
        if n <= c:
            return c
    return ((n + 1023) // 1024) * 1024


def _rand_scalar_words() -> tuple[int, int]:
    """A nonzero 64-bit scalar from ``secrets`` as (hi, lo) 32-bit words."""
    while True:
        r = secrets.randbits(64)
        if r:
            return (r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF


def _pad_sig_lanes(sig_x, n_live: int) -> None:
    """Padding lanes get the G2 generator's x (a valid curve x) so the
    device decompression stays uniform; ``set_mask`` masks their result."""
    if sig_x.shape[0] <= n_live:
        return
    g = g2_generator()
    sig_x[n_live:, 0] = fp.int_to_limbs(g.x.c0.n)
    sig_x[n_live:, 1] = fp.int_to_limbs(g.x.c1.n)


def _dedup_messages(messages, pad_m: int | None):
    """-> (unique-message list padded to M with b"", per-item index)."""
    uniq: dict[bytes, int] = {}
    idx = np.zeros((len(messages),), np.int32)
    for i, m in enumerate(messages):
        idx[i] = uniq.setdefault(bytes(m), len(uniq))
    M = pad_m or _round_up(len(uniq))
    if len(uniq) > M:
        raise ValueError(f"pad_m={M} smaller than {len(uniq)} distinct messages")
    msgs = sorted(uniq, key=uniq.get) + [b""] * (M - len(uniq))
    return msgs, idx


def pack_signature_sets_raw(
    sets, pad_b: int | None = None, pad_k: int | None = None,
    pad_m: int | None = None, *, rand_words=_rand_scalar_words,
    device="cuda",
):
    """``(Signature, [G1Point], message)`` triples -> the eight planes of
    :func:`_staged_verify` on ``device``. Signatures stay compressed: only
    their bytes are parsed here. ``rand_words()`` gives one nonzero 64-bit
    scalar per set as (hi, lo) words; the default draws from ``secrets``.
    Byte-identical to the JAX package's packer for the same words."""
    sets = list(sets)
    B = pad_b or _round_up(len(sets))
    K = pad_k or _round_up(max(len(pks) for _, pks, _ in sets))

    pk_xy = np.zeros((B, K, 2, fp.NL), np.int32)
    pk_mask = np.zeros((B, K), bool)
    sig_x = np.zeros((B, 2, fp.NL), np.int32)
    sig_larger = np.zeros((B,), bool)
    rand = np.zeros((B, 2), np.int32)
    set_mask = np.zeros((B,), bool)
    for i, (sig, pks, _msg) in enumerate(sets):
        x0, x1, larger = parse_compressed_g2_x(sig.serialize())
        hi, lo = rand_words()
        xy, _ = curve.pack_g1(pks)
        pk_xy[i, : len(pks)] = xy
        pk_mask[i, : len(pks)] = True
        sig_x[i, 0] = fp.int_to_limbs(x0)
        sig_x[i, 1] = fp.int_to_limbs(x1)
        sig_larger[i] = larger
        rand[i] = (np.int32(np.uint32(hi)), np.int32(np.uint32(lo)))
        set_mask[i] = True
    _pad_sig_lanes(sig_x, len(sets))

    msgs, idx = _dedup_messages([m for _, _, m in sets], pad_m)
    msg_idx = np.zeros((B,), np.int32)
    msg_idx[: len(sets)] = idx
    msg_u = htc.messages_to_u(msgs, DST)

    return tuple(
        torch.from_numpy(a).to(device)
        for a in (pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand,
                  set_mask)
    )


class CudaBackend:
    """Batch verifier on one device (``cuda`` by default; the tests pass
    ``cpu``, which runs every kernel's plain version).

    Edge semantics are the reference's: an empty batch, a set without
    keys, an infinity signature or an infinity pubkey all give False.
    Pubkeys are trusted to be subgroup-checked at deserialization, as in
    the reference; the device still rejects an aggregate that degenerates
    to infinity."""

    name = "cuda"

    def __init__(self, device="cuda", rand_words=_rand_scalar_words):
        self.device = torch.device(device)
        self.rand_words = rand_words

    def verify_signature_sets(self, sets) -> bool:
        """``sets``: (Signature, [G1Point], message) triples."""
        sets = list(sets)
        if not sets:
            return False
        for sig, pks, _msg in sets:
            if not pks or sig.is_infinity():
                return False
            if any(pk.is_infinity() for pk in pks):
                return False
        args = pack_signature_sets_raw(
            sets, rand_words=self.rand_words, device=self.device
        )
        return bool(_staged_verify(*args))
