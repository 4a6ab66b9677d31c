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

Dispatch, as the JAX package's: each stage, the hashed program, the
aggregate-verify program, the MSM and the G2 sum is one program per
argument shape, here a CUDA graph captured at its first call
(``graphs.CapturedProgram``, the port's ``jax.jit``, keyed also on the
active engines) and replayed after. :func:`_run_stage` dispatches a
stage, syncs the caller's stream at its boundary and says whether its
shape was fresh (a capture). No lock is held across a batch: a capture
on another thread (the compile service's worker) holds no lock a replay
needs. The gather and the message ``take`` between stages 2 and 3 stay
eager. With a compile service
attached (``compile_service``), :class:`CudaBackend` pads each batch to a
rung whose graphs are already captured.

Telemetry, under the JAX package's names and labels: the
``bls_device_stage_seconds``, ``_verify_seconds``, ``_recompiles_total``,
``_batch_lanes_total``, ``_padding_waste_ratio`` and
``_verify_outcomes_total`` families; one ``bls_stage_verify`` journal
event per staged verify; the packers' phase clocks and bytes in the
transfer ledger (``utils/transfer_ledger.py``); each dispatch's busy
interval in the pipeline profiler (``utils/pipeline_profiler.py``);
:func:`stage_latency_summary` reads them back. Every hook sits outside
the stage programs.
"""

from __future__ import annotations

import math
import secrets
import threading
import time

import numpy as np
import torch

from ...compile_service import service as _csvc
from ...utils import (
    fault_injection,
    flight_recorder,
    metrics,
    pipeline_profiler,
    tracing,
    transfer_ledger,
)
from ...verification_service import planner as _planner
from ...verification_service.planner import round_up_bucket
from ..bls import BlsError, Signature, parse_compressed_g2_x
from ..cpu.curve import g2_generator
from ..cpu.hash_to_curve import hash_to_g2
from ..params import DST, G1_X, G1_Y, P
from . import curve, fp, fp2, graphs, htc, key_table, pairing
from . import mesh as _mesh
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


def decompress_g2(sig_x, sign_larger):
    """Device G2 decompression: y = sqrt(x^3 + 4(1+u)), the sign chosen by
    the compressed flag's lexicographic-larger rule. ``sig_x``: fp2
    [..., 2, NL]; ``sign_larger``: bool [...]. -> (y, ok), ``ok`` False
    for an x not on the curve. Stage 1 runs the same two halves around its
    shared square-root ladder."""
    y, ok = htc.sqrt(_decompress_pre(sig_x))
    return _decompress_post(sign_larger, y, ok)


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
    # cached on the device: a copy from host memory cannot be captured
    xbits = fp.on_device("XBITS64", dev, lambda: _XBITS64).expand(B, 64)
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
    pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand_bits, set_mask,
    stages: dict | None = None, gather_record=None,
):
    """The three stage programs over the raw packer's planes, each through
    :func:`_run_stage` -> a 0-dim bool tensor on the device. The message
    ``take`` between stages 2 and 3 and the final ``&`` stay outside the
    programs, as in the JAX package's ``_staged_verify``; its one-program
    twin ``verify_batch_raw_fn`` computes the same. ``stages``, when
    given, receives ``{stage: {"seconds", "fresh"}}``.

    Each call journals one ``bls_stage_verify`` event (geometry,
    ``fp_impl``, per-stage seconds, verdict, whether a stage was fresh;
    ``gather_record`` adds the gather's), commits this thread's staged
    transfer-ledger row (on a raise too, with no verdict), and a False
    verdict calls ``flight_recorder.dump_on_failure``. None of it runs
    inside a stage program: a captured body runs its Python only at
    capture."""
    try:
        (sig_xy, mx, my, minf, sig_ok), s1, f1 = _run_stage(
            "stage1", _stage1, sig_x, sig_larger, msg_u)
        outs, s2, f2 = _run_stage(
            "stage2", _stage2, pk_xy, pk_mask, sig_xy, rand_bits, set_mask)
        pk_x, pk_y, pk_inf, acc_x, acc_y, acc_inf, flags_ok = outs
        msg_aff = _take_messages(mx, my, minf, msg_idx)
        pair_ok, s3, f3 = _run_stage(
            "stage3", _stage3, pk_x, pk_y, pk_inf, *msg_aff, acc_x, acc_y, acc_inf)
    except BaseException:
        # the pack's bytes already crossed and were counted: its ledger
        # row lands (no verdict, nothing read back), one row per pack
        transfer_ledger.commit_verify(None, d2h_bytes=0)
        raise
    if stages is not None:
        for name, sec, fresh in (("stage1", s1, f1), ("stage2", s2, f2),
                                 ("stage3", s3, f3)):
            stages[name] = {"seconds": sec, "fresh": fresh}
    out = pair_ok & flags_ok & torch.all(sig_ok | ~set_mask)
    # every stage already synced its stream: the verdict read is cheap
    verdict = bool(out)
    geometry = {
        "b": int(pk_xy.shape[0]),
        "k": int(pk_xy.shape[1]),
        "m": int(msg_u.shape[0]),
        "fp_impl": fp.get_impl(),
    }
    gather_fields = {}
    recompiled = bool(f1 or f2 or f3)
    if gather_record is not None:
        sg, fg = gather_record
        gather_fields = {"gathered": True, "gather_s": round(sg, 6)}
        recompiled = recompiled or bool(fg)
    flight_recorder.record(
        "bls_stage_verify",
        stage1_s=round(s1, 6), stage2_s=round(s2, 6), stage3_s=round(s3, 6),
        recompiled=recompiled, verdict=verdict, **gather_fields, **geometry,
    )
    # the verdict is the only device-to-host read of a staged verify
    transfer_ledger.commit_verify(verdict, d2h_bytes=out.numel() * out.element_size())
    if not verdict:
        flight_recorder.dump_on_failure("stage_verify_failure", **geometry)
    return out


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
    rand_bits, set_mask, stages: dict | None = None,
):
    """Gathered variant of :func:`_staged_verify`: the pubkey planes come
    from the key table through :func:`_gather_fn`; the stages are the raw
    path's, so the verdict is too. The table must lie on the planes'
    device: a table on another device raises, it is never gathered there.

    The gather runs through :func:`_run_stage` under the JAX package's
    stage label "gather", but eagerly, not as a graph: it is 3 launches,
    and the table replaces its tensors whenever it grows (a copy on the
    card) or inserts an aggregate (the region is cloned, so a held
    snapshot never changes). A graph would keep the old addresses and
    gather from freed memory. Its output is copied into stage 2's static
    ``pk_xy`` like any other argument. The ``bls_stage_verify`` event
    carries its seconds as ``gather_s``."""
    try:
        for name, t in (("table", table), ("aggregate region", agg)):
            if t.device != pk_idx.device:
                raise key_table.KeyTableError(
                    f"key {name} lies on {t.device}, the batch on {pk_idx.device}"
                )
        pk_xy, sg, fg = _run_stage("gather", _gather_fn, table, agg, pk_idx)
    except BaseException:
        # the raise contract of _staged_verify: the pack's row lands
        transfer_ledger.commit_verify(None, d2h_bytes=0)
        raise
    if stages is not None:
        stages["gather"] = {"seconds": sg, "fresh": fg}
    return _staged_verify(pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx,
                          rand_bits, set_mask, stages=stages,
                          gather_record=(sg, fg))


# ---------------------------------------------------------------------------
# The programs, one CUDA graph per argument shape (the JAX package's
# ``jax.jit`` objects), and their dispatch
# ---------------------------------------------------------------------------

_stage1 = graphs.CapturedProgram(_stage1_fn, "stage1")
_stage2 = graphs.CapturedProgram(_stage2_fn, "stage2")
_stage3 = graphs.CapturedProgram(_stage3_fn, "stage3")
verify_batch_hashed = graphs.CapturedProgram(verify_batch_hashed_fn, "verify_batch_hashed")
# the MSM family: keyed on its own point-count rung, never on (B, K, M)
_msm = graphs.CapturedProgram(msm_mod.msm_g1_fn, "msm_g1")
_g2sum = graphs.CapturedProgram(msm_mod.sum_g2_fn, "sum_g2")

# ---------------------------------------------------------------------------
# Hot-path telemetry: the JAX package's families, names and labels
# (reference: beacon_chain/src/metrics.rs label-vector families). A stage's
# wall is measured from dispatch to the caller's stream sync. Every hook
# sits in _run_stage, the packers and the backend, never inside a stage
# program: a captured body runs its Python once, at capture.
# ---------------------------------------------------------------------------

_STAGE_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)
_STAGE_SECONDS = metrics.histogram_vec(
    "bls_device_stage_seconds",
    "staged device BLS verifier: per-stage wall time, dispatch to the "
    "caller's stream sync (the first observation per shape includes the "
    "eager warm-up and the CUDA-graph capture)",
    ("stage", "fp_impl"),
    buckets=_STAGE_BUCKETS,
)
_VERIFY_SECONDS = metrics.histogram_vec(
    "bls_device_verify_seconds",
    "end-to-end verify_signature_sets wall time (pack + all stages)",
    ("path", "fp_impl"),
    buckets=_STAGE_BUCKETS,
)
# bls_device_pack_seconds is the transfer ledger's phase-labelled family:
# the raw and indexed packers observe their phases + total; the hashed
# packer observes total only, through this handle
_PACK_TOTAL = transfer_ledger.PACK_SECONDS.with_labels("total")
_RECOMPILES = metrics.counter_vec(
    "bls_device_recompiles_total",
    "fresh (shape, dtype, engines, shard) argument signatures per staged "
    "program: each one costs an eager warm-up and a CUDA-graph capture "
    "on the card, assuming callers switch engines only through "
    "device.reset_compiled_state()",
    ("stage",),
)
_LANES = metrics.counter_vec(
    "bls_device_batch_lanes_total",
    "batch geometry: requested vs padded lane counts per dimension "
    "(B sets, K pubkey slots, M unique messages)",
    ("dim", "kind"),
)
_PAD_WASTE = metrics.gauge(
    "bls_device_padding_waste_ratio",
    "1 - live lanes / padded lanes (B*K*M) for the most recent packed "
    "batch: the same formula as verification_scheduler_padding_waste_"
    "ratio (verification_service/planner.py). Values differ under a "
    "planned multi-sub-batch flush: this gauge holds the LAST packed "
    "batch, the scheduler gauge the whole plan",
)
_OUTCOMES = metrics.counter_vec(
    "bls_device_verify_outcomes_total",
    "verify_signature_sets verdicts (rejected = host pre-screen)",
    ("outcome",),
)

# Arguments' (stage, device, (shape, dtype)...) seen by _run_stage: a
# first sighting is "fresh", a capture (the JAX package's recompile).
_seen_stage_shapes: set = set()
_seen_lock = threading.Lock()

# per thread: True while a compile-service warm-up dispatches (warming())
_tls = threading.local()


def reset_recompile_tracking() -> None:
    """Forget the seen argument signatures (``graphs.reset()`` drops the
    graphs themselves)."""
    with _seen_lock:
        _seen_stage_shapes.clear()


class warming:
    """Scope of a compile-service warm-up on this thread
    (``compile_service/lowering.py``): the pipeline profiler sees the
    whole scope as ``compile`` activity, opened at entry and closed at
    exit, and its dispatches through :func:`_run_stage` as no busy
    interval on any shard. A warm-up on the card (eager run, capture,
    check replay) occupies the card, but it is not traffic. Nested
    scopes are one."""

    __slots__ = ("_prev", "_t0")

    def __enter__(self):
        self._prev = getattr(_tls, "warming", False)
        _tls.warming = True
        if not self._prev:
            self._t0 = time.perf_counter()
            pipeline_profiler.note_compile_begin(self._t0)
        return self

    def __exit__(self, *exc):
        _tls.warming = self._prev
        if not self._prev:
            pipeline_profiler.note_compile_wall(self._t0, time.perf_counter())
        return False


def _run_stage(stage: str, fn, *args):
    """One staged dispatch, the counterpart of the JAX package's
    ``_run_stage``: ``fn(*args)``, then a sync of the caller's stream at
    the stage boundary (as ``block_until_ready``; never a device-wide
    sync, which would wait on another thread's capture). No lock is held
    here: a captured program takes its own (``graphs.py``). "Fresh" is
    the first sighting of the stage, device, engine triple, mesh shard
    and argument signature, in place of the recompile counter; it is
    recorded only after a dispatch that succeeded. The
    ``staged_dispatch`` fault point fires first, inside the caller's
    shard scope, where a real card failure would surface.

    Telemetry, all outside ``fn``: a ``bls.<stage>`` span, the
    ``bls_device_stage_seconds{stage,fp_impl}`` histogram,
    ``bls_device_recompiles_total`` on a fresh key, and the pipeline
    profiler's busy interval on the shard (none inside :class:`warming`,
    which the profiler sees as ``compile`` activity). Returns ``(out,
    elapsed_s, fresh)``."""
    fault_injection.fire("staged_dispatch")
    dev = args[0].device
    impl = fp.get_impl()
    shard = _mesh.current_shard() or 0
    key = (stage, str(dev), graphs.engines(), shard,
           tuple((tuple(a.shape), str(a.dtype)) for a in args))
    with tracing.span(f"bls.{stage}", fp_impl=impl, shard=shard):
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        elapsed = time.perf_counter() - t0
        _STAGE_SECONDS.with_labels(stage, impl).observe(elapsed)
    with _seen_lock:
        fresh = key not in _seen_stage_shapes
        _seen_stage_shapes.add(key)
    if fresh:
        _RECOMPILES.with_labels(stage).inc()
    if not getattr(_tls, "warming", False):
        pipeline_profiler.note_stage_wall(stage, shard, t0, t0 + elapsed,
                                          fresh=fresh)
    return out, elapsed, fresh


def stage_latency_summary(impl: str | None = None) -> dict:
    """Rows of {fp_impl, p50_s, p99_s, mean_s, count} read from the
    ``bls_device_stage_seconds`` family. With ``impl`` the rows are keyed
    by stage; with ``impl=None`` every engine is reported, keyed
    ``stage:fp_impl``. Quantiles are histogram-bucket upper bounds (None
    = beyond the top bucket); count says how many dispatches (captures
    included) each row aggregates.

    Also: the end-to-end ``bls_device_verify_seconds`` rows (keyed
    ``verify:<path>``), the host-pack phases of the transfer ledger
    (``pack:<phase>``, engine-independent, no ``fp_impl``), and the
    pipeline profiler's bubbles (``bubble:<cause>``: sum_s, count and
    mean_s; counters, so no quantiles)."""
    def _finite(q):
        return q if math.isfinite(q) else None  # keep the JSON strict

    def _row(child, child_impl):
        total, sum_, _cum = child.snapshot()
        if not total:
            return None
        return {
            "fp_impl": child_impl,
            "p50_s": _finite(child.quantile(0.5)),
            "p99_s": _finite(child.quantile(0.99)),
            "mean_s": round(sum_ / total, 4),
            "count": total,
        }

    out = {}
    for (stage, child_impl), child in sorted(_STAGE_SECONDS.children().items()):
        if impl is not None and child_impl != impl:
            continue
        row = _row(child, child_impl)
        if row:
            out[stage if impl is not None else f"{stage}:{child_impl}"] = row
    for (path, child_impl), child in sorted(_VERIFY_SECONDS.children().items()):
        if impl is not None and child_impl != impl:
            continue
        row = _row(child, child_impl)
        if row:
            key = (
                f"verify:{path}"
                if impl is not None
                else f"verify:{path}:{child_impl}"
            )
            out[key] = row
    for (phase,), child in sorted(transfer_ledger.PACK_SECONDS.children().items()):
        row = _row(child, "-")
        if row:
            row.pop("fp_impl", None)
            out[f"pack:{phase}"] = row
    for cause, row in pipeline_profiler.bubble_rows().items():
        out[f"bubble:{cause}"] = row
    return out


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
    N = pad_n or round_up_bucket(max(len(pts), 1))
    xy = np.zeros((N, 2, fp.NL), np.int32)
    inf = np.ones((N,), bool)
    sw = np.zeros((N, 2), np.int32)
    if pts:
        xy[: len(pts)], inf[: len(pts)] = curve.pack_g1(pts)
    for i, s in enumerate(sc):
        sw[i] = _u64_words(s)
    # data-movement attribution: live lanes count as point and scalar
    # bytes, padding lanes as padding; the labels sum to the bytes copied
    live = len(pts)
    pk_b = live * (xy.nbytes // N + inf.nbytes // N)
    aux_b = live * (sw.nbytes // N)
    transfer_ledger.note_op_bytes(
        {"pubkeys": pk_b, "aux": aux_b,
         "padding": xy.nbytes + inf.nbytes + sw.nbytes - pk_b - aux_b},
        kind="msm",
    )
    (oxy, oinf), _s, _f = _run_stage("msm", _msm, *_to_device((xy, inf, sw), device))
    oxy, oinf = oxy.cpu(), oinf.cpu()
    return curve.unpack_g1(oxy[None].numpy(), oinf[None].numpy())[0]


def device_sum_g2(points, pad_n: int | None = None, device="cuda"):
    """cpu G2Point list -> their sum on ``device`` as a cpu G2Point.
    Padding lanes are infinity; an empty list gives infinity."""
    pts = list(points)
    N = pad_n or round_up_bucket(max(len(pts), 1))
    xy = np.zeros((N, 2, 2, fp.NL), np.int32)
    inf = np.ones((N,), bool)
    if pts:
        xy[: len(pts)], inf[: len(pts)] = curve.pack_g2(pts)
    # G2 points are signature points: the signatures operand
    live_b = len(pts) * (xy.nbytes // N + inf.nbytes // N)
    transfer_ledger.note_op_bytes(
        {"signatures": live_b, "padding": xy.nbytes + inf.nbytes - live_b},
        kind="msm",
    )
    (oxy, oinf), _s, _f = _run_stage("msm", _g2sum, *_to_device((xy, inf), device))
    oxy, oinf = oxy.cpu(), oinf.cpu()
    return curve.unpack_g2(oxy[None].numpy(), oinf[None].numpy())[0]


# ---------------------------------------------------------------------------
# Host packing
# ---------------------------------------------------------------------------

def _rand_scalar_words() -> tuple[int, int]:
    """A nonzero 64-bit scalar from ``secrets`` as (hi, lo) 32-bit words."""
    while True:
        r = secrets.randbits(64)
        if r:
            return (r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF


def _rand_row(rand_words) -> tuple:
    hi, lo = rand_words()
    return np.int32(np.uint32(hi)), np.int32(np.uint32(lo))


def _to_device(arrays, device, sync: bool = False):
    """Host arrays -> tensors on ``device``. ``sync`` ends with a sync of
    the caller's stream on a CUDA device, so that the transfer ledger's
    ``device_put`` phase times the copy, not its enqueue; never a
    device-wide sync."""
    out = tuple(torch.from_numpy(a).to(device) for a in arrays)
    dev = out[0].device
    if sync and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return out


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
    M = pad_m or round_up_bucket(len(uniq))
    if len(uniq) > M:
        raise ValueError(f"pad_m={M} smaller than {len(uniq)} distinct messages")
    msgs = sorted(uniq, key=uniq.get) + [b""] * (M - len(uniq))
    return msgs, idx


def _pack_message_planes(sets, B: int, pad_m: int | None):
    """The message half of the raw, indexed and hashed packers: dedup, the
    padded per-lane index plane and the ``hash_to_field`` u-values.
    -> (msg_u int32[M, 2, 2, NL], msg_idx int32[B], distinct live
    messages)."""
    msgs, idx = _dedup_messages([m for _, _, m in sets], pad_m)
    m_req = int(idx.max()) + 1 if len(idx) else 1
    msg_idx = np.zeros((B,), np.int32)
    msg_idx[: len(sets)] = idx
    return htc.messages_to_u(msgs, DST), msg_idx, m_req


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
    B = pad_b or round_up_bucket(len(sets))
    K = pad_k or round_up_bucket(max(len(pks) for _, pks, _ in sets))
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
    msg_u, msg_idx, _m_req = _pack_message_planes(sets, B, pad_m)
    return _to_device((pk_xy, pk_mask, sig_xy, msg_u, msg_idx, rand, set_mask), device)


def _pack_compressed(sets, B: int, rand_words):
    """The signature half of the raw and indexed packers: compressed x
    limbs, the sign flag, randomness and the set mask. -> (the four
    planes, the seconds of its ``decode`` (byte parsing, randomness),
    ``limb_split`` (limbs, array fill) and ``pad`` (allocation, padding
    lanes) phases)."""
    t0 = time.perf_counter()
    sig_x = np.zeros((B, 2, fp.NL), np.int32)
    sig_larger = np.zeros((B,), bool)
    rand = np.zeros((B, 2), np.int32)
    set_mask = np.zeros((B,), bool)
    t_pad = time.perf_counter() - t0
    t_decode = t_fill = 0.0
    for i, (sig, _pks, _msg) in enumerate(sets):
        t0 = time.perf_counter()
        x0, x1, larger = parse_compressed_g2_x(sig.serialize())
        r = _rand_row(rand_words)
        t1 = time.perf_counter()
        t_decode += t1 - t0
        rand[i] = r
        sig_x[i, 0] = fp.int_to_limbs(x0)
        sig_x[i, 1] = fp.int_to_limbs(x1)
        sig_larger[i] = larger
        set_mask[i] = True
        t_fill += time.perf_counter() - t1
    t0 = time.perf_counter()
    _pad_sig_lanes(sig_x, len(sets))
    t_pad += time.perf_counter() - t0
    phases = {"decode": t_decode, "limb_split": t_fill, "pad": t_pad}
    return (sig_x, sig_larger, rand, set_mask), phases


def _ship(planes, device, t_start: float, phases: dict, n_sets: int,
          pk_slots: int, m_req: int, pubkey_blobs, indexed: bool):
    """The last phase of the raw and indexed packers: the ``device_put``
    fault point, the copy of the eight ``planes`` to ``device`` (timed to
    the caller's stream sync when the transfer ledger is on), and the
    pack's report: ``bls_device_pack_seconds{phase}``, the ledger's staged
    row (:func:`transfer_ledger.note_pack`, committed by
    :func:`_staged_verify`) and the pack as host activity in the pipeline
    profiler."""
    ledger_on = transfer_ledger.enabled()
    t0 = time.perf_counter()
    fault_injection.fire("device_put")
    args = _to_device(planes, device, sync=ledger_on)
    phases["device_put"] = time.perf_counter() - t0
    total_s = time.perf_counter() - t_start
    transfer_ledger.observe_pack_phases(phases, total_s)
    pk, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand, set_mask = planes
    transfer_ledger.note_pack(
        n_sets=n_sets, b=pk.shape[0], k=pk.shape[1], m=msg_u.shape[0],
        pk_slots=pk_slots, m_req=m_req, phases=phases, total_s=total_s,
        operand_nbytes={
            "pubkeys": pk.nbytes + pk_mask.nbytes,
            "signatures": sig_x.nbytes + sig_larger.nbytes,
            "messages": msg_u.nbytes + msg_idx.nbytes,
            "aux": rand.nbytes + set_mask.nbytes,
        },
        pubkey_blobs=pubkey_blobs, indexed=indexed,
    )
    pipeline_profiler.note_pack_wall(t_start, t_start + total_s)
    return args


def pack_signature_sets_raw(
    sets, pad_b: int | None = None, pad_k: int | None = None,
    pad_m: int | None = None, *, rand_words=_rand_scalar_words,
    device="cuda",
):
    """``(Signature, [G1Point], message)`` triples -> the eight planes of
    :func:`_staged_verify` on ``device``. Signatures stay compressed: only
    their bytes are parsed here. ``rand_words()`` gives one nonzero 64-bit
    scalar per set as (hi, lo) words; the default draws from ``secrets``.
    Byte-identical to the JAX package's packer for the same words.

    Timed by phase (``decode``, ``limb_split``, ``pad``, ``hash``,
    ``device_put``) for the transfer ledger, which also gets the operand
    bytes and, when it is on, each pubkey row for its re-upload sketch."""
    t_start = time.perf_counter()
    sets = list(sets)
    B, K = _geometry(sets, pad_b, pad_k)
    pk_xy = np.zeros((B, K, 2, fp.NL), np.int32)
    pk_mask = np.zeros((B, K), bool)
    t_pad = time.perf_counter() - t_start
    # with the ledger off the packer does not pay for the row copies
    ledger_on = transfer_ledger.enabled()
    pk_blobs: list = []
    pk_slots = 0
    t0 = time.perf_counter()
    for i, (_sig, pks, _msg) in enumerate(sets):
        xy = curve.pack_g1(pks)[0]
        pk_xy[i, : len(pks)] = xy
        pk_mask[i, : len(pks)] = True
        pk_slots += len(pks)
        if ledger_on:
            pk_blobs.extend(row.tobytes() for row in xy)
    t_limb = time.perf_counter() - t0
    (sig_x, sig_larger, rand, set_mask), phases = _pack_compressed(
        sets, B, rand_words)
    phases["limb_split"] += t_limb
    phases["pad"] += t_pad
    t0 = time.perf_counter()
    msg_u, msg_idx, m_req = _pack_message_planes(sets, B, pad_m)
    phases["hash"] = time.perf_counter() - t0
    return _ship((pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand, set_mask),
                 device, t_start, phases, len(sets), pk_slots, m_req, pk_blobs,
                 indexed=False)


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
    plane is the raw packer's, byte for byte, and so are the phase clocks;
    its ledger row is marked ``indexed`` (the pubkey operand is the index
    plane, and no G1 row crosses)."""
    t_start = time.perf_counter()
    sets, indices = list(sets), list(indices)
    if len(indices) != len(sets):
        # a real raise: a silent truncation would leave trailing sets
        # masked out, unverified, under a True verdict
        raise ValueError(f"indices must match sets one-to-one "
                         f"({len(indices)} vs {len(sets)})")
    B = pad_b or round_up_bucket(len(sets))
    K = pad_k or round_up_bucket(max((len(ix) for ix in indices), default=1))
    pk_idx = np.zeros((B, K), np.int32)
    pk_mask = np.zeros((B, K), bool)
    t_pad = time.perf_counter() - t_start
    t0 = time.perf_counter()
    for i, ix in enumerate(indices):
        pk_idx[i, : len(ix)] = ix
        pk_mask[i, : len(ix)] = True
    pk_slots = sum(len(ix) for ix in indices)
    t_fill = time.perf_counter() - t0
    (sig_x, sig_larger, rand, set_mask), phases = _pack_compressed(
        sets, B, rand_words)
    phases["limb_split"] += t_fill
    phases["pad"] += t_pad
    t0 = time.perf_counter()
    msg_u, msg_idx, m_req = _pack_message_planes(sets, B, pad_m)
    phases["hash"] = time.perf_counter() - t0
    return _ship((pk_idx, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand, set_mask),
                 device, t_start, phases, len(sets), pk_slots, m_req, (),
                 indexed=True)


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
    :meth:`verify_signature_sets`: its path, padded rung, whether every
    stage replayed a captured graph (``warm``), each stage's seconds,
    collapsed sets, host seconds to resolve and pack, and bytes copied to
    the device."""

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
        batch is decompressed on the host.

        With a mesh attached (``mesh.set_mesh``) and this thread in a
        shard's scope (``mesh.dispatch_to``), the batch is packed and
        dispatched on that shard's device, gathers from that shard's key
        table replica, and routes and marks warmth in that shard's
        registry; otherwise it runs on ``self.device`` (shard 0)."""
        sets = list(sets)
        if not sets:
            _OUTCOMES.with_labels("rejected").inc()
            return False
        for sig, pks, _msg in sets:
            if not pks or sig.is_infinity():
                _OUTCOMES.with_labels("rejected").inc()
                return False
            if any(pk.is_infinity() for pk in pks):
                _OUTCOMES.with_labels("rejected").inc()
                return False
        raw_mode = all(isinstance(s, Signature) for s, _, _ in sets)
        # no lock around the batch: captures run in CUDA's thread-local
        # mode, so this thread's inserts, copies, replays and syncs may run
        # beside another thread's capture (graphs.py)
        t0 = time.perf_counter()
        scoped = _mesh.current_shard()
        shard = scoped or 0
        device = _mesh.device_of(scoped, self.device)
        resolved = None
        n_collapsed = 0
        path = "raw_staged" if raw_mode else "hashed"
        impl = fp.get_impl()
        table = _active_key_table()
        if raw_mode and table is not None:
            # before resolving: a batch that cannot gather inserts and
            # counts nothing. The replica checked is the one this shard
            # gathers from
            replica, _agg = table.device_arrays(scoped)
            if replica is not None and _device_of(replica.device) != _device_of(device):
                raise key_table.KeyTableError(
                    f"key table replica lies on {replica.device}, the batch on {device}"
                )
            res = table.resolve_sets(sets)
            if res is not None:
                resolved, table_dev, agg_dev, n_collapsed = res
                path = "raw_gather"
        elif table is not None:
            table.count_raw(len(sets))  # bare points never gather
        # the requested geometry, for routing and the lane accounting; the
        # gathered path pays the collapsed K axis (a cached sum is one slot)
        if resolved is not None:
            k_req = max(len(ix) for ix in resolved)
            pk_slots = sum(len(ix) for ix in resolved)
        else:
            k_req = max(len(pks) for _, pks, _ in sets)
            pk_slots = sum(len(pks) for _, pks, _ in sets)
        m_req = len({bytes(m) for _, _, m in sets})
        # warm-shape routing: with a compile service attached, pad up to a
        # rung whose stage graphs are captured (the collapsed K counts)
        svc = _csvc.get_active_service() if raw_mode else None
        pad_b = pad_k = pad_m = warm_epoch = None
        if svc is not None:
            warm_epoch = svc.registry.epoch  # before the dispatch
            rung = svc.pads_for(len(sets), k_req, m_req, device=shard)
            if rung is not None:
                pad_b, pad_k, pad_m = rung
        t1 = time.perf_counter()
        if not raw_mode:
            try:
                points = [(s.point_or_infinity() if isinstance(s, Signature) else s,
                           pks, m) for s, pks, m in sets]
            except BlsError:
                # a signature x that is not on the curve
                _OUTCOMES.with_labels("rejected").inc()
                return False
        kw = dict(pad_b=pad_b, pad_k=pad_k, rand_words=self.rand_words,
                  device=device)
        stages: dict = {}
        with tracing.span(
            "bls.verify_signature_sets", path=path, n_sets=len(sets)
        ) as sp, _VERIFY_SECONDS.with_labels(path, impl).time():
            with tracing.span("bls.pack"):
                if resolved is not None:
                    table.count_shipped(len(sets) - n_collapsed, n_collapsed)
                    args = pack_signature_sets_indexed(sets, resolved, pad_m=pad_m, **kw)
                elif raw_mode:
                    args = pack_signature_sets_raw(sets, pad_m=pad_m, **kw)
                else:
                    with _PACK_TOTAL.time():
                        args = pack_signature_sets_hashed(points, **kw)
            t2 = time.perf_counter()
            self._record_geometry(args, len(sets), k_req, m_req, pk_slots)
            if resolved is not None:
                out = verify_batch_raw_staged_gather(table_dev, agg_dev, *args,
                                                     stages=stages)
            elif raw_mode:
                out = _staged_verify(*args, stages=stages)
            else:
                out, sec, fresh = _run_stage("hashed", verify_batch_hashed, *args)
                stages["hashed"] = {"seconds": sec, "fresh": fresh}
            verdict = bool(out)
            sp.set(verdict=verdict)
        rung = (int(args[0].shape[0]), int(args[0].shape[1]),
                int(args[4 if raw_mode else 3].shape[0]))
        self.last_batch = {
            "path": path, "n_sets": len(sets), "b": rung[0], "k": rung[1],
            "m": rung[2], "rung": rung,
            # the gather is eager by design: "warm" is about the graphs
            "warm": not any(st["fresh"] for name, st in stages.items()
                            if name != "gather"),
            "stages": {name: st["seconds"] for name, st in stages.items()},
            "collapsed": n_collapsed, "resolve_s": t1 - t0, "pack_s": t2 - t1,
            "h2d_bytes": _nbytes(args), "pubkey_bytes": _nbytes(args[:2]),
        }
        if svc is not None:
            # organic warmth: the rung's graphs exist now, whatever the
            # verdict; the cost feed is the pack plus the dispatch
            svc.note_rung_verified(*rung, epoch=warm_epoch, device=shard,
                                   seconds=time.perf_counter() - t1,
                                   n_sets=len(sets))
        _OUTCOMES.with_labels("ok" if verdict else "fail").inc()
        return verdict

    @staticmethod
    def _record_geometry(args, n_sets: int, k_req: int, m_req: int,
                         pk_slots: int) -> None:
        """Batch-geometry accounting: requested vs padded B/K/M lanes
        (``bls_device_batch_lanes_total``) and the padding-waste fraction
        (``bls_device_padding_waste_ratio``, the planner's formula).
        ``pk_slots`` is the live pubkey-slot count (a collapsed committee
        occupies ONE slot on the gathered path)."""
        b_pad, k_pad = int(args[0].shape[0]), int(args[0].shape[1])
        # the raw and indexed packers put msg_u at index 4, the hashed at 3
        m_pad = int(args[4 if len(args) == 8 else 3].shape[0])
        for dim, req, pad in (
            ("b", n_sets, b_pad), ("k", k_req, k_pad), ("m", m_req, m_pad)
        ):
            _LANES.with_labels(dim, "requested").inc(req)
            _LANES.with_labels(dim, "padded").inc(pad)
        _PAD_WASTE.set(
            _planner.padding_waste_ratio(
                _planner.live_lanes(pk_slots, m_req),
                _planner.padded_lanes(b_pad, k_pad, m_pad),
            )
        )

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
        Bn = round_up_bucket(n)
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


def _aggregate_verify_device_fn(pk_xy, pk_inf, msg_u, msg_idx, sig_xy):
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


_aggregate_verify_device = graphs.CapturedProgram(_aggregate_verify_device_fn,
                                                  "aggregate_verify")
