"""Batched BLS signature-set verification on the card.

The port of the JAX package's staged verifier (``_staged_verify`` and its
three stages), its packers and its backend:

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

Three ways in, chosen by :class:`CudaBackend`:

* raw (:func:`pack_signature_sets_raw` -> :func:`_staged_verify`):
  compressed signatures, G1 limb planes shipped per batch;
* gathered (:func:`pack_signature_sets_indexed` ->
  :func:`verify_batch_raw_staged_gather`): the same, but the pubkey
  planes are gathered on the device from the key table
  (``key_table.py``) through a ``(B, K)`` index plane;
* hashed (:func:`pack_signature_sets_hashed` ->
  :func:`verify_batch_hashed_fn`): bare G2 points, decompressed on the
  host, messages mapped to G2 on the device.

Shapes (B sets, K max pubkeys per set, M distinct messages), as packed by
:func:`pack_signature_sets_raw`:

  pk_xy int32[B, K, 2, 32]   pk_mask bool[B, K]   (indexed: pk_idx int32[B, K])
  sig_x int32[B, 2, 32]      sig_larger bool[B]   (hashed: sig_xy int32[B, 2, 2, 32])
  msg_u int32[M, 2, 2, 32]   msg_idx int32[B]
  rand  int32[B, 2]          (hi, lo) words of nonzero 64-bit scalars
  set_mask bool[B]           False = padding lane (must not affect result)

The whole path stays on the device; the only read back is the verdict.
The G1 MSM and G2 sum helpers (:func:`device_msm_g1`,
:func:`device_sum_g2`) run ``msm.py`` on the device for host callers.
"""

from __future__ import annotations

import secrets
import time

import numpy as np
import torch

from ..bls import BlsError, Signature, parse_compressed_g2_x
from ..cpu.curve import g2_generator
from ..cpu.hash_to_curve import hash_to_g2
from ..params import DST, G1_X, G1_Y, P
from . import curve, fp, fp2, htc, key_table, pairing
from . import msm as msm_mod
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


def _verify_core(pk_xy, pk_mask, sig_xy, msg_aff, rand_bits, set_mask):
    """Stages 2 and 3 over decompressed signatures ``sig_xy`` and the
    per-lane message points ``msg_aff = (x, y, inf)`` in G2 affine -> a
    0-dim bool tensor."""
    pk_x, pk_y, pk_inf, acc_x, acc_y, acc_inf, flags_ok = _stage2_fn(
        pk_xy, pk_mask, sig_xy, rand_bits, set_mask
    )
    return _stage3_fn(pk_x, pk_y, pk_inf, *msg_aff, acc_x, acc_y, acc_inf) & flags_ok


def _take_messages(mx, my, minf, msg_idx):
    idx = msg_idx.long()
    return mx[idx], my[idx], minf[idx]


def _staged_verify(
    pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand_bits, set_mask
):
    """The three stages over the raw packer's planes -> a 0-dim bool tensor
    on the device (no host sync inside). The counterpart of the JAX
    package's ``_staged_verify`` and of its one-program twin
    ``verify_batch_raw_fn``, which computes the same."""
    sig_xy, mx, my, minf, sig_ok = _stage1_fn(sig_x, sig_larger, msg_u)
    core = _verify_core(pk_xy, pk_mask, sig_xy, _take_messages(mx, my, minf, msg_idx),
                        rand_bits, set_mask)
    return core & torch.all(sig_ok | ~set_mask)


def verify_batch_fn(pk_xy, pk_mask, sig_xy, msg_xy, rand_bits, set_mask):
    """Pre-hashed program: decompressed signatures and message points
    hashed on the host (:func:`pack_signature_sets`) -> verdict."""
    B = pk_xy.shape[0]
    msg_aff = (msg_xy[:, 0], msg_xy[:, 1],
               torch.zeros((B,), dtype=torch.bool, device=pk_xy.device))
    return _verify_core(pk_xy, pk_mask, sig_xy, msg_aff, rand_bits, set_mask)


def verify_batch_hashed_fn(pk_xy, pk_mask, sig_xy, msg_u, msg_idx, rand_bits, set_mask):
    """Hashed program: decompressed signatures, and the unique messages'
    ``hash_to_field`` outputs ``msg_u`` mapped to G2 on the device
    (:func:`pack_signature_sets_hashed`) -> verdict."""
    mx, my, minf = curve.to_affine(fp2, htc.map_to_g2(msg_u))
    return _verify_core(pk_xy, pk_mask, sig_xy, _take_messages(mx, my, minf, msg_idx),
                        rand_bits, set_mask)


def _gather_fn(table, agg, pk_idx):
    """Device-side pubkey gather: the ``(B, K)`` int32 index plane ->
    the ``[B, K, 2, NL]`` limb planes from the key table. Indices below
    ``table.shape[0]`` address the validator rows, indices at or above it
    the aggregate region ``agg``: two clipped ``index_select``s and a
    ``where`` (the JAX package's two ``jnp.take``s and its select), so the
    regions stay separate tensors. Masked lanes gather row 0, a real key;
    stage 2 forces masked lanes to infinity whatever their coordinates."""
    B, K = pk_idx.shape
    flat = pk_idx.reshape(-1).long()
    base = table.shape[0]
    from_val = table.index_select(0, flat.clamp(0, base - 1))
    from_agg = agg.index_select(0, (flat - base).clamp(0, agg.shape[0] - 1))
    rows = torch.where((flat < base)[:, None, None], from_val, from_agg)
    return rows.reshape(B, K, *table.shape[1:])


def verify_batch_raw_staged_gather(
    table, agg, pk_idx, pk_mask, sig_x, sig_larger, msg_u, msg_idx,
    rand_bits, set_mask,
):
    """Gathered variant of :func:`_staged_verify`: the pubkey planes come
    from the key table through :func:`_gather_fn`; the stages are the raw
    path's, so the verdict is too. The table must lie on the planes'
    device: a table on another device raises, it is never gathered there."""
    for name, t in (("table", table), ("aggregate region", agg)):
        if t.device != pk_idx.device:
            raise key_table.KeyTableError(
                f"key {name} lies on {t.device}, the batch on {pk_idx.device}"
            )
    pk_xy = _gather_fn(table, agg, pk_idx)
    return _staged_verify(pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx,
                          rand_bits, set_mask)


# ---------------------------------------------------------------------------
# MSM family: host helpers
# ---------------------------------------------------------------------------

def _u64_words(s: int) -> np.ndarray:
    """u64 -> (hi, lo) two's-complement int32 words."""
    return np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], np.uint32).view(np.int32)


def device_msm_g1(points, scalars, pad_n: int | None = None, device="cuda"):
    """cpu G1Point list and u64 scalars -> their MSM on ``device`` as a cpu
    G1Point. N pads to ``pad_n`` (a rung of ``msm.MSM_RUNGS``) or the
    bucket ladder; padding lanes are infinity with zero scalars."""
    pts, sc = list(points), list(scalars)
    if len(pts) != len(sc):
        raise ValueError(f"{len(pts)} points but {len(sc)} scalars")
    N = pad_n or _round_up(max(len(pts), 1))
    xy = np.zeros((N, 2, fp.NL), np.int32)
    inf = np.ones((N,), bool)
    sw = np.zeros((N, 2), np.int32)
    if pts:
        xy[: len(pts)], inf[: len(pts)] = curve.pack_g1(pts)
    for i, s in enumerate(sc):
        sw[i] = _u64_words(s)
    oxy, oinf = msm_mod.msm_g1_fn(*_to_device((xy, inf, sw), device))
    return curve.unpack_g1(oxy.cpu()[None].numpy(), oinf.cpu()[None].numpy())[0]


def device_sum_g2(points, pad_n: int | None = None, device="cuda"):
    """cpu G2Point list -> their sum on ``device`` as a cpu G2Point.
    Padding lanes are infinity; an empty list gives infinity."""
    pts = list(points)
    N = pad_n or _round_up(max(len(pts), 1))
    xy = np.zeros((N, 2, 2, fp.NL), np.int32)
    inf = np.ones((N,), bool)
    if pts:
        xy[: len(pts)], inf[: len(pts)] = curve.pack_g2(pts)
    oxy, oinf = msm_mod.sum_g2_fn(*_to_device((xy, inf), device))
    return curve.unpack_g2(oxy.cpu()[None].numpy(), oinf.cpu()[None].numpy())[0]


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


def _rand_row(rand_words) -> tuple:
    hi, lo = rand_words()
    return np.int32(np.uint32(hi)), np.int32(np.uint32(lo))


def _to_device(arrays, device):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _pad_sig_lanes(sig_x, n_live: int) -> None:
    """Padding lanes get the G2 generator's x (a valid curve x) so the
    device decompression stays uniform; ``set_mask`` masks their result.
    One definition for the raw and the indexed packer, which must stay
    byte-identical in every non-pubkey plane."""
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


def _pack_message_planes(sets, B: int, pad_m: int | None):
    """The message half of the raw, indexed and hashed packers: dedup, the
    padded per-lane index plane and the ``hash_to_field`` u-values.
    -> (msg_u int32[M, 2, 2, NL], msg_idx int32[B])."""
    msgs, idx = _dedup_messages([m for _, _, m in sets], pad_m)
    msg_idx = np.zeros((B,), np.int32)
    msg_idx[: len(sets)] = idx
    return htc.messages_to_u(msgs, DST), msg_idx


def _pack_common(sets, B: int, K: int, rand_words):
    """The per-set planes of the packers over bare points: pubkeys,
    decompressed signatures, randomness, mask. Padding lanes hold the G2
    generator (their result is masked by ``set_mask``)."""
    pk_xy = np.zeros((B, K, 2, fp.NL), np.int32)
    pk_mask = np.zeros((B, K), bool)
    sig_xy = np.zeros((B, 2, 2, fp.NL), np.int32)
    rand = np.zeros((B, 2), np.int32)
    set_mask = np.zeros((B,), bool)
    for i, (sig, pks, _msg) in enumerate(sets):
        xy, _ = curve.pack_g1(pks)
        pk_xy[i, : len(pks)] = xy
        pk_mask[i, : len(pks)] = True
        sig_xy[i] = curve.pack_g2([sig])[0][0]
        rand[i] = _rand_row(rand_words)
        set_mask[i] = True
    if B > len(sets):
        sig_xy[len(sets):] = curve.pack_g2([g2_generator()])[0][0]
    return pk_xy, pk_mask, sig_xy, rand, set_mask


def _geometry(sets, pad_b, pad_k):
    B = pad_b or _round_up(len(sets))
    K = pad_k or _round_up(max(len(pks) for _, pks, _ in sets))
    return B, K


def pack_signature_sets(
    sets, pad_b: int | None = None, pad_k: int | None = None, *,
    rand_words=_rand_scalar_words, device="cuda",
):
    """``(G2Point, [G1Point], message)`` triples -> the six planes of
    :func:`verify_batch_fn`, the messages hashed to G2 on the host (pure
    Python, about 0.3 s each). Byte-identical to the JAX packer for the
    same random words."""
    sets = list(sets)
    B, K = _geometry(sets, pad_b, pad_k)
    pk_xy, pk_mask, sig_xy, rand, set_mask = _pack_common(sets, B, K, rand_words)
    msg_xy = np.zeros((B, 2, 2, fp.NL), np.int32)
    cache: dict[bytes, np.ndarray] = {}
    for i, (_sig, _pks, msg) in enumerate(sets):
        if msg not in cache:
            cache[msg] = curve.pack_g2([hash_to_g2(msg, DST)])[0][0]
        msg_xy[i] = cache[msg]
    if B > len(sets):
        msg_xy[len(sets):] = sig_xy[len(sets)]  # the padding signature's point
    return _to_device((pk_xy, pk_mask, sig_xy, msg_xy, rand, set_mask), device)


def pack_signature_sets_hashed(
    sets, pad_b: int | None = None, pad_k: int | None = None,
    pad_m: int | None = None, *, rand_words=_rand_scalar_words, device="cuda",
):
    """``(G2Point, [G1Point], message)`` triples -> the seven planes of
    :func:`verify_batch_hashed_fn`: messages stay raw, the host computes
    only their ``hash_to_field`` u-values. Byte-identical to the JAX
    packer for the same random words."""
    sets = list(sets)
    B, K = _geometry(sets, pad_b, pad_k)
    pk_xy, pk_mask, sig_xy, rand, set_mask = _pack_common(sets, B, K, rand_words)
    msg_u, msg_idx = _pack_message_planes(sets, B, pad_m)
    return _to_device((pk_xy, pk_mask, sig_xy, msg_u, msg_idx, rand, set_mask), device)


def _pack_compressed(sets, B: int, rand_words):
    """The signature half of the raw and indexed packers: compressed x
    limbs, the sign flag, randomness and the set mask."""
    sig_x = np.zeros((B, 2, fp.NL), np.int32)
    sig_larger = np.zeros((B,), bool)
    rand = np.zeros((B, 2), np.int32)
    set_mask = np.zeros((B,), bool)
    for i, (sig, _pks, _msg) in enumerate(sets):
        x0, x1, larger = parse_compressed_g2_x(sig.serialize())
        rand[i] = _rand_row(rand_words)
        sig_x[i, 0] = fp.int_to_limbs(x0)
        sig_x[i, 1] = fp.int_to_limbs(x1)
        sig_larger[i] = larger
        set_mask[i] = True
    _pad_sig_lanes(sig_x, len(sets))
    return sig_x, sig_larger, rand, set_mask


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
    B, K = _geometry(sets, pad_b, pad_k)
    pk_xy = np.zeros((B, K, 2, fp.NL), np.int32)
    pk_mask = np.zeros((B, K), bool)
    for i, (_sig, pks, _msg) in enumerate(sets):
        pk_xy[i, : len(pks)] = curve.pack_g1(pks)[0]
        pk_mask[i, : len(pks)] = True
    sig_x, sig_larger, rand, set_mask = _pack_compressed(sets, B, rand_words)
    msg_u, msg_idx = _pack_message_planes(sets, B, pad_m)
    return _to_device(
        (pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand, set_mask), device)


def pack_signature_sets_indexed(
    sets, indices, pad_b: int | None = None, pad_k: int | None = None,
    pad_m: int | None = None, *, rand_words=_rand_scalar_words,
    device="cuda",
):
    """The raw packer for sets whose pubkeys all resolved to key-table
    indices (``key_table.DeviceKeyTable.resolve_sets``): a ``(B, K)`` int32
    index plane and its mask instead of the ``(B, K, 2, NL)`` limb planes,
    5 bytes per pubkey slot instead of 257. ``indices`` holds one index
    list per set (a collapsed committee carries one index). Every other
    plane is the raw packer's, byte for byte."""
    sets, indices = list(sets), list(indices)
    if len(indices) != len(sets):
        # a real raise: a silent truncation would leave trailing sets
        # masked out, unverified, under a True verdict
        raise ValueError(f"indices must match sets one-to-one "
                         f"({len(indices)} vs {len(sets)})")
    B = pad_b or _round_up(len(sets))
    K = pad_k or _round_up(max((len(ix) for ix in indices), default=1))
    pk_idx = np.zeros((B, K), np.int32)
    pk_mask = np.zeros((B, K), bool)
    for i, ix in enumerate(indices):
        pk_idx[i, : len(ix)] = ix
        pk_mask[i, : len(ix)] = True
    sig_x, sig_larger, rand, set_mask = _pack_compressed(sets, B, rand_words)
    msg_u, msg_idx = _pack_message_planes(sets, B, pad_m)
    return _to_device(
        (pk_idx, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand, set_mask), device)


def _active_key_table():
    """The process-global device key table when one is attached with
    resident rows."""
    return key_table.get_active_table()


def _device_of(device) -> torch.device:
    """``device`` with a bare ``cuda`` read as the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _nbytes(args) -> int:
    return sum(a.numel() * a.element_size() for a in args)


class CudaBackend:
    """Batch verifier on one device (``cuda`` by default; the tests pass
    ``cpu``, which runs every kernel's plain version).

    Edge semantics are the reference's: an empty batch, a set without
    keys, an infinity signature or an infinity pubkey all give False.
    Pubkeys are trusted to be subgroup-checked at deserialization, as in
    the reference; the device still rejects an aggregate that degenerates
    to infinity.

    ``last_batch`` describes the latest batch of
    :meth:`verify_signature_sets`: its path, padded shape, collapsed sets,
    host seconds to resolve and pack, and bytes copied to the device."""

    name = "cuda"

    def __init__(self, device="cuda", rand_words=_rand_scalar_words):
        self.device = torch.device(device)
        self.rand_words = rand_words
        self.last_batch: dict = {}

    def verify_signature_sets(self, sets) -> bool:
        """``sets``: (Signature | G2Point, [G1Point], message) triples.

        Signature objects keep their compressed bytes and are decompressed
        on the device: through the key table's gather when one is attached
        (:func:`~.key_table.set_table`) and holds every pubkey of the
        batch, else through the raw limb planes. Bare points (oracle
        callers) take the hashed path; any Signature object in such a
        batch is decompressed on the host."""
        sets = list(sets)
        if not sets:
            return False
        for sig, pks, _msg in sets:
            if not pks or sig.is_infinity():
                return False
            if any(pk.is_infinity() for pk in pks):
                return False
        raw_mode = all(isinstance(s, Signature) for s, _, _ in sets)
        t0 = time.perf_counter()
        resolved = None
        n_collapsed = 0
        path = "raw_staged" if raw_mode else "hashed"
        table = _active_key_table()
        if raw_mode and table is not None:
            # before resolving: a batch that cannot gather inserts and counts nothing
            if _device_of(table.device) != _device_of(self.device):
                raise key_table.KeyTableError(
                    f"key table lies on {table.device}, the backend on {self.device}"
                )
            res = table.resolve_sets(sets)
            if res is not None:
                resolved, table_dev, agg_dev, n_collapsed = res
                path = "raw_gather"
        elif table is not None:
            table.count_raw(len(sets))  # bare points never gather
        t1 = time.perf_counter()
        kw = dict(rand_words=self.rand_words, device=self.device)
        if resolved is not None:
            table.count_shipped(len(sets) - n_collapsed, n_collapsed)
            args = pack_signature_sets_indexed(sets, resolved, **kw)
        elif raw_mode:
            args = pack_signature_sets_raw(sets, **kw)
        else:
            try:
                points = [(s.point_or_infinity() if isinstance(s, Signature) else s,
                           pks, m) for s, pks, m in sets]
            except BlsError:
                return False  # a signature x that is not on the curve
            args = pack_signature_sets_hashed(points, **kw)
        self.last_batch = {
            "path": path, "n_sets": len(sets), "b": int(args[0].shape[0]),
            "k": int(args[0].shape[1]), "m": int(args[4 if raw_mode else 3].shape[0]),
            "collapsed": n_collapsed, "resolve_s": t1 - t0,
            "pack_s": time.perf_counter() - t1, "h2d_bytes": _nbytes(args),
            "pubkey_bytes": _nbytes(args[:2]),
        }
        if resolved is not None:
            out = verify_batch_raw_staged_gather(table_dev, agg_dev, *args)
        elif raw_mode:
            out = _staged_verify(*args)
        else:
            out = verify_batch_hashed_fn(*args)
        return bool(out)

    # -- single-set entry points (the batch path at B = 1) ------------------

    def verify(self, pk, message, sig) -> bool:
        if pk.is_infinity():
            return False
        return self._verify_one(sig, [pk], message)

    def fast_aggregate_verify(self, pks, message, sig) -> bool:
        """The pubkeys are summed on the device (the masked K-axis sum); an
        aggregate that degenerates to infinity fails there."""
        pks = list(pks)
        if not pks:
            return False
        return self._verify_one(sig, pks, message)

    def aggregate_verify(self, pks, messages, sig) -> bool:
        """One signature over per-pubkey messages: prod e(pk_i, H(m_i)) *
        e(-g1, sig) == 1 with a subgroup-checked signature; the messages
        are mapped to G2 on the device."""
        pks, messages = list(pks), list(messages)
        if not pks or len(pks) != len(messages):
            return False
        if any(pk.is_infinity() for pk in pks):
            return False
        if isinstance(sig, Signature):
            sig = sig.point_or_infinity()
        sxy, s_inf = curve.pack_g2([sig])
        if s_inf[0]:
            return False
        n = len(pks)
        Bn = _round_up(n)
        pk_xy = np.zeros((Bn, 2, fp.NL), np.int32)
        pk_inf = np.ones((Bn,), bool)
        pk_xy[:n] = curve.pack_g1(pks)[0]
        pk_inf[:n] = False
        msgs, idx = _dedup_messages(messages, None)
        msg_idx = np.zeros((Bn,), np.int32)
        msg_idx[:n] = idx
        msg_u = htc.messages_to_u(msgs, DST)
        return bool(_aggregate_verify_device(
            *_to_device((pk_xy, pk_inf, msg_u, msg_idx, sxy[0]), self.device)))

    def _verify_one(self, sig, pks, message) -> bool:
        if sig.is_infinity():
            return False
        return self.verify_signature_sets([(sig, pks, message)])


def _aggregate_verify_device(pk_xy, pk_inf, msg_u, msg_idx, sig_xy):
    """The multi-pairing of :meth:`CudaBackend.aggregate_verify`: the
    signature's subgroup check, the messages mapped to G2, and one
    pairing check over the pubkey lanes plus (-g1, sig). Padding pubkey
    lanes are infinity (Miller value 1)."""
    sig_pt = curve.from_affine(fp2, sig_xy[0], sig_xy[1])
    sub_ok = g2_in_subgroup(sig_pt)
    mx, my, minf = curve.to_affine(fp2, htc.map_to_g2(msg_u))
    sx, sy, sinf = curve.to_affine(fp2, sig_pt)
    pair_ok = _stage3_fn(pk_xy[:, 0], pk_xy[:, 1], pk_inf,
                         *_take_messages(mx, my, minf, msg_idx), sx, sy, sinf)
    return pair_ok & sub_ok
