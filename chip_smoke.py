"""Chip smoke check of lighthouse_tpu_torch on one NVIDIA GPU (H100).

Drives the port's main path, BLS batch verification of signature sets,
through the entry point a node calls (``CudaBackend.verify_signature_sets``)
on its raw, gathered (device key table) and collapsed paths, at mainnet
shapes, and holds each of its three CUDA kernels against its
plain torch version on the card. Phases, in order; any failure raises:

1. device: require CUDA, print the card's name and power limit, build the
   kernels from ``lighthouse_tpu_torch/csrc`` and print the build time and
   what ptxas reports (registers, spills);
2. kernels: K1 ``fp_mul_cols`` (raw columns and reduced limbs equal),
   K2 ``fp2_mul`` and K3 ``fp2_sq`` (canonical-equal, limbs in [0, 8191])
   against their plain versions at 1, 3, 5, 1170 and 3474 lanes, with the
   all-8191 and all-zero worst cases, a broadcast operand and an empty
   batch;
3. gossip batch: 64 single-signer attestations from 8 committees of one
   slot (K = 1, M = 8): valid -> True, one message tampered -> False; the
   decompressed signatures and the device hash-to-G2 of this batch are
   also held against the host oracle;
4. block batch: 128 aggregate attestations with 180..229 signers each plus
   the proposal and RANDAO sets (B = 130 on the 192 rung, K <= 256,
   M = 130): valid -> True, one non-subgroup signature -> False;
5. key table: a registry of 2^19 validators (secrets 1..N, built in
   Jacobian coordinates with one batch inversion), the first half synced
   at startup, the rest delta-admitted, which grows the table to the
   next rung by a device copy; each sync's seconds, upload bytes and
   status;
6. gathered verifies: gossip and block batches redrawn from the
   registry's own points, verified on the gathered path (collapse held
   off): valid -> True, non-subgroup -> False; a block batch with one
   foreign key falls back to the raw path and still verifies; the
   gathered pubkey planes equal the raw planes on live slots;
7. collapse: a fresh block batch seen three times with the table's
   default ``agg_min_repeats`` (2): the second sighting pays the host
   sums (seconds printed) and ships K = 1, the third hits; a poisoned
   signature over the collapsed rows -> False;
8. msm: ``device_msm_g1`` at N = 512 with random u64 scalars and
   ``device_sum_g2`` at N = 128 equal to the host fold; one committee's
   all-ones MSM equal to the table's host sum; a committee inserted with
   ``insert_precomputed`` ships K = 1 at its first sighting -> True;
9. kernel timings where the path runs them: each kernel checked again and
   timed (device ms per launch, launches queued back to back behind a
   device sleep, CUDA events) with its plain version and its bound at 1
   lane, at the most frequent and at the largest lane count of the block
   batch's valid verify (K3 at every lane count either batch launched),
   and at the shapes earlier versions timed; beside them the launch
   floor, the device time per launch of a one-element in-place add
   queued the same way;
10. one more valid verify of each raw batch, of the gathered block batch
   and of the collapsed block batch under torch.profiler: the device busy
   share, and for the raw batches each kernel's device ms per verify
   beside its lanes per verify and the bound summed over them.

Each batch is verified three times (median wall printed); every verify
prints its path, padded shape, host resolve and pack seconds and the
bytes it copied to the card.

The counts of kernel launches (and the lanes they carry) are set to 0
just before each verify and read just after it. The kernels line reports
the launches of the valid block-batch verify. Keys and messages are made
from ``--seed``; the host signer (pure Python) is independent of the
device hash-to-curve.

    python3 chip_smoke.py            # the full check (one card)
    python3 chip_smoke.py --quick    # build, kernel checks and timings, tiny verifies and MSM
    python3 chip_smoke.py --time-only DIR   # time the kernels of the checkout at DIR
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MEM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
INT32_MAC_RATE = 16.75e12  # int32 multiply-adds/s: 64 INT32 lanes/SM x 132 SMs x 1.98 GHz
SLEEP_HZ = 2.0e9           # cycles per second for torch.cuda._sleep (above the SM clock)

KERNELS = ("fp_mul_cols", "fp2_mul", "fp2_sq")
REPLACES = {
    "fp_mul_cols": "lighthouse_tpu/crypto/device/pallas_fp.py:60",
    "fp2_mul": "lighthouse_tpu/crypto/device/pallas_fp2.py:145",
    "fp2_sq": "lighthouse_tpu/crypto/device/pallas_fp2.py:159",
}
# the kernel's name in the profiler's rows
PROFILE_NAME = {"fp_mul_cols": "::fp_mul_kernel", "fp2_mul": "::fp2_mul_kernel",
                "fp2_sq": "::fp2_sq_kernel"}
# bytes one lane reads and writes: two (one) operands and the result
LANE_BYTES = {"fp_mul_cols": 3 * 32 * 4, "fp2_mul": 3 * 64 * 4, "fp2_sq": 2 * 64 * 4}
# The key table's registry: 2^19 validators, the order of mainnet's
# registry when the reference's v3.3.0 shipped.
REGISTRY_SIZE = 1 << 19
# The MSM phase's point counts: the top MSM rung (a mainnet committee) for
# G1 with random u64 scalars, and 128 points for the G2 sum.
MSM_N = 512
G2_N = 128
# Lane counts every kernel is checked at: 1, ragged blocks, and the
# largest K2 launch of the block batch.
CHECK_LANES = (1, 3, 5, 1170, 3474)
# Timing shapes of --quick, which runs no batch: 1 lane, the most frequent
# and the largest lane count of the block batch (seed 0), and for K3 every
# count the gossip and block verifies launch. The full run times at the
# counts its own verifies launched.
QUICK_LANES = {"fp_mul_cols": (1, 192, 147456), "fp2_mul": (1, 18, 960, 3474),
               "fp2_sq": (1, 96, 195, 579, 960)}
# The shapes earlier versions of this script timed (an Fp12 product's 81
# Fp lanes at 65 Miller lanes; 27 Fp2 lanes at 193): the path does not
# launch these counts; they are timed to compare with those times.
EARLIER_LANES = {"fp_mul_cols": 81 * 65, "fp2_mul": 27 * 193, "fp2_sq": 27 * 193}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls queued behind a
    device-side sleep, so that the card runs them back to back whatever the
    host's speed, timed by CUDA events; the median of ``rounds``. Raises if
    the host did not finish queueing before the sleep ended."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = 3 * reps * (time.perf_counter() - t0) + 1e-3
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_s = time.perf_counter() - t0
        b.synchronize()
        if queued_s > sleep_s:
            raise RuntimeError(f"timing: queueing took {queued_s:.4f} s, longer "
                               f"than the {sleep_s:.4f} s device sleep")
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def launch_floor(dev, card: str) -> float:
    """Print and return the device ms per launch of the smallest torch
    kernel, a one-element in-place add, queued back to back as the kernels
    are timed: the card's own cost of a launch, against which a kernel's
    1-lane time reads."""
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = device_ms(lambda: x.add_(1))
    log(f"launch floor: {ms:.4f} ms per launch (one-element in-place add, "
        f"queued back to back) on {card}")
    return ms


def bound(name: str, lanes: int):
    """(ms, "bytes" or "operations"): the least time the card could take for
    ``lanes`` lanes of kernel ``name``."""
    from lighthouse_tpu_torch.crypto.device import kernels

    byte_s = lanes * LANE_BYTES[name] / MEM_RATE
    op_s = lanes * kernels.macs_per_lane(name) / INT32_MAC_RATE
    return max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations"


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def operands(rng, name: str, lanes: int, dev):
    """Random relaxed limbs for ``lanes`` lanes of kernel ``name``, with the
    all-8191 worst case in lane 0 and zeros in lane 1."""
    from lighthouse_tpu_torch.crypto.device import fp

    shape = (lanes, fp.NL) if name == "fp_mul_cols" else (lanes, 2, fp.NL)
    out = []
    for _ in range(1 if name == "fp2_sq" else 2):
        a = rng.integers(0, fp.LIMB_MAX + 1, size=shape, dtype=np.int32)
        a[0] = fp.LIMB_MAX
        a[1:2] = 0
        out.append(torch.from_numpy(a).to(dev))
    return out


def calls(name: str):
    """(kernel wrapper, plain version) of the main path's mode of ``name``."""
    from lighthouse_tpu_torch.crypto.device import kernels

    return {
        "fp_mul_cols": (kernels.fp_mul, kernels.fp_mul_plain),
        "fp2_mul": (kernels.fp2_mul, kernels.fp2_mul_plain),
        "fp2_sq": (kernels.fp2_sq, kernels.fp2_sq_plain),
    }[name]


def check_kernel(name: str, args) -> tuple[int, bool]:
    """Hold one launch against the plain version: K1's raw columns and
    reduced limbs must be equal; K2 and K3 canonical-equal with limbs in
    [0, 8191]. Returns (max abs canonical error, limbs equal)."""
    from lighthouse_tpu_torch.crypto.device import fp, kernels

    fn, plain = calls(name)
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    if name == "fp_mul_cols":
        if not torch.equal(kernels.fp_mul_cols(*args), kernels.fp_mul_cols_plain(*args)):
            raise AssertionError("fp_mul_cols: raw columns differ from the plain version")
        if not torch.equal(got, want):
            raise AssertionError("fp_mul_cols: reduced limbs differ from the plain version")
        return 0, True
    if got.numel() and (int(got.min()) < 0 or int(got.max()) > fp.LIMB_MAX):
        raise AssertionError(f"{name}: limbs outside [0, {fp.LIMB_MAX}]")
    err = int((fp.canonical(got) - fp.canonical(want)).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: canonical values differ (max {err})")
    return err, bool(torch.equal(got, want))


def check_kernels(rng, dev) -> dict:
    """Every kernel at CHECK_LANES, with broadcast operands and an empty
    batch. Returns {name: max abs error}."""
    from lighthouse_tpu_torch.crypto.device import kernels

    errs = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        exact = []
        for lanes in CHECK_LANES:
            args = operands(rng, name, lanes, dev)
            err, eq = check_kernel(name, args)
            errs[name] = max(errs[name], err)
            exact.append(eq)
            if len(args) == 2:  # one operand broadcast over the lanes
                check_kernel(name, (args[0], args[1][:1]))
        fn, _ = calls(name)
        empty = operands(rng, name, 2, dev)
        if fn(*(a[:0] for a in empty)).shape[0] != 0:
            raise AssertionError(f"{name}: an empty batch gave a non-empty result")
        log(f"kernel {name}: equal to its plain version at {CHECK_LANES} lanes, "
            f"broadcast and empty (limbs equal: {all(exact)})")
    kernels.reset_launches()
    return errs


def time_kernels(rng, dev, shapes: dict, errs: dict) -> dict:
    """Check and time each kernel and its plain version at the given lane
    counts. Returns {name: [timing dict, ...]}."""
    out = {}
    for name in KERNELS:
        fn, plain = calls(name)
        rows = []
        for lanes in shapes[name]:
            args = operands(rng, name, lanes, dev)
            err, _ = check_kernel(name, args)
            errs[name] = max(errs[name], err)
            ms = device_ms(lambda: fn(*args))
            plain_ms = device_ms(lambda: plain(*args), reps=5, rounds=3)
            b_ms, b_by = bound(name, lanes)
            rows.append(dict(lanes=lanes, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by))
            log(f"  {name} at {lanes} lanes: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
                f"bound {b_ms:.3g} ms ({b_by}), at {b_ms / ms:.2%} of the bound")
            del args
        out[name] = rows
    return out


def lane_summary(label: str, hist: dict) -> None:
    for name in KERNELS:
        h = hist[name]
        n, lanes = sum(h.values()), sum(k * v for k, v in h.items())
        top = ", ".join(f"{k}: {v}" for k, v in sorted(h.items(), key=lambda kv: -kv[1])[:6])
        log(f"lanes {label} {name}: {lanes} lanes in {n} launches (mean "
            f"{lanes / max(n, 1):.1f}, max {max(h, default=0)}); most frequent "
            f"(lanes: launches) {top}")


# A path that launches a kernel at no more than this many distinct lane
# counts has each of them checked and timed (K3 in the verifies, K2 in the
# G2 sum); otherwise its most frequent count and its largest.
FEW_COUNTS = 8


def path_shapes(hists: dict) -> dict:
    """The lane counts each kernel is checked and timed at: 1 lane, the
    earlier versions' shape, and for every path of this run that launched
    the kernel (``hists``: {path: {kernel: {lanes: launches}}}) its most
    frequent lane count and its largest, or all of its counts when there
    are few."""
    out = {}
    for name in KERNELS:
        shapes = {1, EARLIER_LANES[name]}
        for hist in hists.values():
            h = hist.get(name)
            if not h:
                continue
            shapes |= set(h) if len(h) <= FEW_COUNTS else {mode_of(hist, name), max(h)}
        out[name] = sorted(shapes)
    return out


def mode_of(hist: dict, name: str) -> int:
    """The most frequent lane count of ``name`` (the larger one on a tie)."""
    return max(hist[name].items(), key=lambda kv: (kv[1], kv[0]))[0]


def print_shapes(shapes: dict, hists: dict) -> None:
    """Which paths launched each checked lane count."""
    for name in KERNELS:
        by = {n: [p for p, h in hists.items() if n in h.get(name, {})] for n in shapes[name]}
        log(f"  {name} lane counts: " + "; ".join(
            f"{n} ({', '.join(ps) or ('checked always' if n == 1 else 'earlier shape')})"
            for n, ps in by.items()))


# ---------------------------------------------------------------------------
# Batches (host signer)
# ---------------------------------------------------------------------------

def make_keys(s0: int, n: int):
    """Secrets s0 + i and their pubkeys by repeated addition of G1."""
    from lighthouse_tpu_torch.crypto.cpu.curve import g1_generator

    g = g1_generator()
    pk = g.mul(s0)
    pks = []
    for _ in range(n):
        pks.append(pk)
        pk = pk + g
    return pks


def registry_points(n: int):
    """[1]G, ..., [n]G (the keys of secrets 1..n) as cpu G1Points, built in
    Jacobian coordinates, P_{i+1} = P_i + G, with one Montgomery batch
    inversion for the affine conversion: an affine addition per key would
    pay one field inversion each."""
    from lighthouse_tpu_torch.crypto.cpu.curve import G1Point
    from lighthouse_tpu_torch.crypto.cpu.fields import Fq
    from lighthouse_tpu_torch.crypto.params import G1_X, G1_Y, P

    gx, gy = G1_X, G1_Y
    # P_2 = 2G in affine, then mixed additions of G (P_i != +-G for i >= 2)
    lam = 3 * gx * gx * pow(2 * gy, P - 2, P) % P
    x2 = (lam * lam - 2 * gx) % P
    X, Y, Z = x2, (lam * (gx - x2) - gy) % P, 1
    xs, ys, zs = [gx], [gy], [1]
    for _ in range(1, n):
        xs.append(X)
        ys.append(Y)
        zs.append(Z)
        zz = Z * Z % P
        h = (gx * zz - X) % P
        r = (gy * zz * Z - Y) % P
        hh = h * h % P
        hhh = h * hh % P
        v = X * hh % P
        X = (r * r - hhh - 2 * v) % P
        Y = (r * (v - X) - Y * hhh) % P
        Z = Z * h % P
    prefix, acc = [], 1
    for z in zs:
        prefix.append(acc)
        acc = acc * z % P
    inv = pow(acc, P - 2, P)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        zi = inv * prefix[i] % P
        inv = inv * zs[i] % P
        zi2 = zi * zi % P
        out[i] = G1Point(Fq(xs[i] * zi2), Fq(ys[i] * zi2 * zi))
    return out


def keys_for(s0: int, n: int, registry=None):
    """The pubkeys of secrets s0 .. s0+n-1: the registry's own point
    objects (secret i is registry row i-1) when one is given."""
    if registry is None:
        return make_keys(s0, n)
    return registry[s0 - 1: s0 - 1 + n]


def gossip_sets(rng, s0: int, registry=None):
    """64 unaggregated attestations, 8 committees of 8 in one slot."""
    from lighthouse_tpu_torch.crypto.bls import Signature
    from lighthouse_tpu_torch.crypto.cpu.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.params import DST, R

    pks = keys_for(s0, 64, registry)
    msgs = [rng.bytes(32) for _ in range(8)]
    hs = [hash_to_g2(m, DST) for m in msgs]
    sets = []
    for c in range(8):
        sig = hs[c].mul((s0 + 8 * c) % R)
        for j in range(8):
            i = 8 * c + j
            sets.append((Signature.deserialize(sig.compress()), [pks[i]], msgs[c]))
            sig = sig + hs[c]
    return sets, msgs, hs


def committee_set(rng, s0: int, pks):
    """One set signed by the secrets s0 .. s0+k-1 of ``pks`` over a random
    message: the signature of their aggregate secret."""
    from lighthouse_tpu_torch.crypto.bls import Signature
    from lighthouse_tpu_torch.crypto.cpu.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.params import DST, R

    k = len(pks)
    m = rng.bytes(32)
    sig = hash_to_g2(m, DST).mul((k * s0 + k * (k - 1) // 2) % R)
    return Signature.deserialize(sig.compress()), list(pks), m


def block_sets(rng, s0: int, registry=None):
    """128 aggregates (K in [180, 229]) + proposal + RANDAO (K = 1)."""
    ks = [int(k) for k in rng.integers(180, 230, size=128)] + [1, 1]
    pks = keys_for(s0, sum(ks), registry)
    sets, start = [], 0
    for k in ks:
        sets.append(committee_set(rng, s0 + start, pks[start:start + k]))
        start += k
    return sets


def non_subgroup_signature(rng):
    """A point on E2 outside G2, compressed."""
    from lighthouse_tpu_torch.crypto.bls import Signature
    from lighthouse_tpu_torch.crypto.cpu.curve import G2Point
    from lighthouse_tpu_torch.crypto.cpu.fields import Fq2
    from lighthouse_tpu_torch.crypto.params import B2, P

    while True:
        x = Fq2.from_ints(int.from_bytes(rng.bytes(48), "big") % P,
                          int.from_bytes(rng.bytes(48), "big") % P)
        y = (x.square() * x + Fq2.from_ints(*B2)).sqrt()
        if y is not None:
            pt = G2Point(x, y)
            assert not pt.in_subgroup()
            return Signature.deserialize(pt.compress())


def batch_line(backend) -> str:
    """The backend's description of its latest batch, for the log."""
    lb = backend.last_batch
    return (f"path {lb['path']}, B={lb['b']} K={lb['k']} M={lb['m']}, "
            f"{lb['collapsed']} of {lb['n_sets']} sets collapsed, host resolve "
            f"{lb['resolve_s']:.4f} s, host pack {lb['pack_s']:.4f} s, H2D "
            f"{lb['h2d_bytes']} B of which pubkey planes {lb['pubkey_bytes']} B")


def timed_verify(backend, sets, label, expect, reps: int = 3, path=None):
    """``reps`` verifies of one batch, each with the launch counts set to 0
    just before it and read just after it; prints every wall time and the
    median, the batch's path and shape, and its host and copy costs.
    ``path``, when given, is the path every verify must take. Returns
    (median wall, launch counts and lane histograms {kernel: {lanes:
    launches}} of the last run)."""
    from lighthouse_tpu_torch.crypto.device import kernels

    walls, counts, hist = [], None, None
    for _ in range(reps):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        verdict = backend.verify_signature_sets(sets)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if verdict is not expect:
            raise AssertionError(f"{label}: verdict {verdict}, expected {expect}")
        if path is not None and backend.last_batch["path"] != path:
            raise AssertionError(f"{label}: path {backend.last_batch['path']}, "
                                 f"expected {path}")
        if counts is not None and counts != kernels.launches:
            raise AssertionError(f"{label}: launch counts differ between runs")
        counts = dict(kernels.launches)
        hist = {k: dict(h) for k, h in kernels.lane_hist.items()}
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    wall = statistics.median(walls)
    log(f"{label}: verdict {expect} x{reps}; {wall:.3f} s per verify (median of "
        f"{', '.join(f'{w:.3f}' for w in walls)}); launches {json.dumps(counts)}; "
        f"lanes {json.dumps(dict(kernels.lanes))}")
    log(f"  {label}: {batch_line(backend)}")
    return wall, counts, hist


def check_stage1_against_host(sets, msgs, hs, dev):
    """Decompressed signatures and device hash-to-G2 vs the host oracle."""
    from lighthouse_tpu_torch.crypto.device import bls as dbls, fp

    args = dbls.pack_signature_sets_raw(sets, device=dev)
    sig_xy, mx, my, minf, sig_ok = dbls._stage1_fn(args[2], args[3], args[4])
    if not bool(sig_ok[: len(sets)].all()):
        raise AssertionError("stage 1: a valid signature failed decompression")
    sig_c = fp.canonical(sig_xy).cpu().numpy()
    for i in range(4):
        pt = sets[i][0].point
        want = [pt.x.c0.n, pt.x.c1.n, pt.y.c0.n, pt.y.c1.n]
        got = [fp.limbs_to_int(sig_c[i, a, b]) for a in range(2) for b in range(2)]
        if got != want:
            raise AssertionError(f"stage 1: signature {i} decompressed wrong")
    mxc, myc = mx.cpu().numpy(), my.cpu().numpy()
    for j, h in enumerate(hs):
        got = [fp.limbs_to_int(mxc[j, 0]), fp.limbs_to_int(mxc[j, 1]),
               fp.limbs_to_int(myc[j, 0]), fp.limbs_to_int(myc[j, 1])]
        if got != [h.x.c0.n, h.x.c1.n, h.y.c0.n, h.y.c1.n] or bool(minf[j]):
            raise AssertionError(f"stage 1: hash_to_g2 of message {j} differs from the host")
    log(f"stage 1 vs host oracle: 4 decompressed signatures and {len(hs)} "
        "message points equal")


def profile_verify(backend, sets, label, wall):
    """One more verify under torch.profiler: the device time by kernel
    name, and the device's busy share of ``wall`` (the unprofiled median).
    Returns {kernel: device ms} for the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        backend.verify_signature_sets(sets)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host-side op rows repeat their kernels' device time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"profile {label}: device busy {busy_s:.4f} s in {sum(r[1] for r in rows)} "
        f"device ops; idle share {1 - busy_s / wall:.3f} of the {wall:.3f} s median wall")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3:9.3f} ms {count:7d}x  {key[:80]}")
    return {name: sum(r[0] for r in rows if PROFILE_NAME[name] in r[2]) / 1e3
            for name in KERNELS}


# ---------------------------------------------------------------------------
# The key table, the gathered and collapsed paths, the MSM
# ---------------------------------------------------------------------------

class held_collapse:
    """Raise the table's ``agg_min_repeats`` above any sighting count for a
    block of verifies, so every set ships its K indices (the gathered path
    without the aggregate collapse)."""

    def __init__(self, table):
        self.table = table

    def __enter__(self):
        self.prev = self.table.agg_min_repeats
        self.table.agg_min_repeats = 1 << 30

    def __exit__(self, *exc):
        self.table.agg_min_repeats = self.prev


def key_table_phase(registry, dev):
    """Sync the first half of the registry at startup, then delta-admit the
    rest, which grows the table to the next rung by a device copy. Prints
    each sync's seconds, upload bytes and status; holds rows at both ends
    of each half against the host pack. Returns the table."""
    from types import SimpleNamespace

    from lighthouse_tpu_torch.crypto.bls import PublicKey
    from lighthouse_tpu_torch.crypto.device import curve, key_table

    n, half = len(registry), len(registry) // 2
    cache = SimpleNamespace(pubkeys=[PublicKey(p) for p in registry[:half]])
    table = key_table.DeviceKeyTable(cache, device=dev)
    for reason in ("startup", "delta"):
        if reason == "delta":
            cache.pubkeys.extend(PublicKey(p) for p in registry[half:])
        t0 = time.perf_counter()
        added = table.sync(reason=reason)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = table.status()
        log(f"key table {reason} sync: {added} rows in {dt:.3f} s, upload "
            f"{st['upload_bytes'][reason]} B, capacity {st['validator_capacity']} rows "
            f"({st['validator_capacity'] * key_table.G1_ROW_BYTES} B of validator rows "
            f"on the card, {st['device_bytes']} B with the aggregate region)")
        log(f"  status {json.dumps(st)}")
    if table.status()["validator_capacity"] != key_table.table_capacity(n):
        raise AssertionError("key table: capacity is not the registry's rung")
    rows = [0, half - 1, half, n - 1]
    tdev, _ = table.device_arrays()
    want = curve.pack_g1([registry[i] for i in rows])[0]
    if tdev.device != dev or not np.array_equal(tdev[rows].cpu().numpy(), want):
        raise AssertionError("key table: device rows differ from the host pack")
    log(f"key table rows {rows} equal to the host pack, on {tdev.device}")
    return table


def gathered_phase(rng, registry, table, backend, dev):
    """Gossip and block batches drawn from the registry's own points on the
    gathered path (collapse held off), a poisoned one, one with a foreign
    key (raw fallback), and the gathered planes against the raw planes on
    the card. Returns (block sets, median wall of the block verify, lane
    histograms of the valid verifies by path)."""
    from lighthouse_tpu_torch.crypto.cpu.curve import G1Point
    from lighthouse_tpu_torch.crypto.cpu.fields import Fq
    from lighthouse_tpu_torch.crypto.device import bls as dbls

    t0 = time.perf_counter()
    gsets, _msgs, _hs = gossip_sets(rng, 1000, registry)
    bsets = block_sets(rng, 100_000, registry)
    log(f"host signing from the registry: {time.perf_counter() - t0:.2f} s")
    walls, hists = {}, {}
    with held_collapse(table):
        for label, sets in (("gossip", gsets), ("block", bsets)):
            wall, _counts, hist = timed_verify(
                backend, sets, f"gathered {label} valid", True, path="raw_gather")
            walls[label] = wall
            hists[f"gathered {label}"] = hist
            resolved, tdev, tagg, _ = table.resolve_sets(sets)
            idx = dbls.pack_signature_sets_indexed(sets, resolved, device=dev)[0]
            gather_ms = device_ms(lambda: dbls._gather_fn(tdev, tagg, idx))
            log(f"  gathered {label}: gather {gather_ms:.4f} device ms at "
                f"{tuple(idx.shape)} indices")
            lane_summary(f"gathered {label} valid", hist)
        poisoned = list(bsets)
        poisoned[5] = (non_subgroup_signature(rng), bsets[5][1], bsets[5][2])
        timed_verify(backend, poisoned, "gathered block non-subgroup signature", False,
                     path="raw_gather")
        foreign = list(bsets)
        sig, pks, m = foreign[1]
        p = pks[0]
        foreign[1] = (sig, [G1Point(Fq(p.x.n), Fq(p.y.n))] + pks[1:], m)
        raw0 = table.status()["sets"]["raw"]
        timed_verify(backend, foreign, "block with one foreign key", True,
                     path="raw_staged")
        raw = table.status()["sets"]["raw"] - raw0
        if raw <= 0:
            raise AssertionError("foreign key: the raw fallback was not counted")
        log(f"  foreign key: count_raw +{raw} sets (table sets {table.status()['sets']})")

        # the gathered pubkey planes against the raw planes, on the card
        resolved, tdev, tagg, _ = table.resolve_sets(bsets)
        words = seeded_words(7)
        idx_args = dbls.pack_signature_sets_indexed(bsets, resolved, rand_words=words(),
                                                    device=dev)
        raw_args = dbls.pack_signature_sets_raw(bsets, rand_words=words(), device=dev)
        gathered = dbls._gather_fn(tdev, tagg, idx_args[0])
        mask = idx_args[1]
        if not (torch.equal(mask, raw_args[1])
                and torch.equal(gathered[mask], raw_args[0][mask])
                and all(torch.equal(a, b) for a, b in zip(idx_args[2:], raw_args[2:]))):
            raise AssertionError("gathered planes differ from the raw planes")
        log(f"gathered pubkey planes equal to the raw planes on {int(mask.sum())} live "
            f"slots, on {gathered.device}; the other six planes equal")
    return bsets, walls["block"], hists


def seeded_words(seed: int):
    """A factory of seeded stand-ins for the packers' random words: each
    call gives a fresh generator from the same seed."""
    def make():
        rng = np.random.default_rng(seed)

        def words():
            r = int(rng.integers(1, 2 ** 63, dtype=np.int64))
            return (r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF
        return words
    return make


def collapse_phase(rng, registry, table, backend):
    """A fresh block batch verified three times with the default
    ``agg_min_repeats`` (2): the second sighting pays the host sums and
    ships K = 1, the third hits the cached rows. Then a poisoned signature
    over the collapsed rows. Returns (sets, median wall of three verifies
    after the third sighting, their lane histograms)."""
    from lighthouse_tpu_torch.crypto.device import kernels

    t0 = time.perf_counter()
    csets = block_sets(rng, 200_000, registry)
    log(f"host signing: {time.perf_counter() - t0:.2f} s; {len(csets)} sets from "
        f"registry rows 199,999 on")
    n_comm = sum(1 for _, pks, _ in csets if len(pks) > 1)
    n_adds = sum(len(pks) - 1 for _, pks, _ in csets if len(pks) > 1)
    for sighting in (1, 2, 3):
        sum0 = table.status()["aggregate_sum_seconds"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        verdict = backend.verify_signature_sets(csets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lb = backend.last_batch
        k1_max = max(kernels.lane_hist["fp_mul_cols"])
        log(f"collapse sighting {sighting}: verdict {verdict}; K rung {lb['k']}; "
            f"{lb['collapsed']} of {lb['n_sets']} sets collapsed; K1 lane maximum "
            f"{k1_max}; {wall:.3f} s; launches {json.dumps(dict(kernels.launches))}")
        log(f"  collapse sighting {sighting}: {batch_line(backend)}")
        if verdict is not True or lb["path"] != "raw_gather":
            raise AssertionError(f"collapse sighting {sighting}: {verdict} on {lb['path']}")
        if sighting > 1:
            if lb["k"] != 1 or lb["collapsed"] != n_comm:
                raise AssertionError(f"collapse sighting {sighting}: not collapsed")
        if sighting == 2:
            log(f"collapse host sums (second sighting): "
                f"{table.status()['aggregate_sum_seconds'] - sum0:.3f} s for {n_adds} "
                f"affine additions over {n_comm} committees")
    # the steady state: every committee hits its cached row
    wall, _counts, hist = timed_verify(backend, csets, "collapsed block valid", True,
                                       path="raw_gather")
    lane_summary("collapsed block valid", hist)
    poisoned = list(csets)
    poisoned[5] = (non_subgroup_signature(rng), csets[5][1], csets[5][2])
    timed_verify(backend, poisoned, "collapsed block non-subgroup signature", False,
                 path="raw_gather", reps=1)
    if backend.last_batch["collapsed"] != n_comm:
        raise AssertionError("poisoned collapsed batch: rows were not collapsed")
    st = table.status()
    log(f"  table after collapse: {st['aggregates_resident']} aggregate rows, "
        f"{st['aggregate_inserts']} inserts, {st['aggregate_hits']} hits, "
        f"upload {st['upload_bytes']['aggregate']} B")
    return csets, wall, hist


def msm_phase(rng, registry, table, backend, dev, csets):
    """The G1 MSM at N = 512 and the G2 sum at N = 128 against the host
    fold; one committee's all-ones MSM against the table's host sum; and a
    committee inserted ahead of time whose first sighting ships K = 1.
    Returns the lane histograms of the three device sums by path."""
    from lighthouse_tpu_torch.crypto.cpu.curve import G1Point, G2Point, g2_generator
    from lighthouse_tpu_torch.crypto.device import bls as dbls, curve, kernels, msm

    hists = {}

    def counted(label, fn, path_kernels):
        """Run one device sum with the counts set to 0 just before it and
        read just after; every kernel of ``path_kernels`` must launch."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"{label}: {dt:.3f} s on the card; launches {json.dumps(dict(kernels.launches))}")
        missing = [k for k in path_kernels if kernels.launches[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        hists[label] = {k: dict(h) for k, h in kernels.lane_hist.items()}
        lane_summary(label, hists[label])
        return out

    pts = registry[:MSM_N]
    sc = [int(s) for s in rng.integers(0, 2 ** 64, size=MSM_N, dtype=np.uint64)]
    sc[0] = (1 << 64) - 1
    got = counted(f"msm g1 N={MSM_N}",
                  lambda: dbls.device_msm_g1(pts, sc, pad_n=MSM_N, device=dev),
                  ["fp_mul_cols"])
    t0 = time.perf_counter()
    want = G1Point.infinity()
    for p, s in zip(pts, sc):
        want = want + p.mul(s)
    log(f"msm g1 host fold: {time.perf_counter() - t0:.3f} s")
    if got.compress() != want.compress():
        raise AssertionError("msm g1: differs from the host fold")
    log(f"msm g1 N={MSM_N} (random u64 scalars, one all-ones): equal to the host fold")

    g2 = g2_generator()
    q = g2.mul(int(rng.integers(1, 2 ** 62)))
    pts2 = []
    for _ in range(G2_N):
        pts2.append(q)
        q = q + g2
    got2 = counted(f"sum g2 N={G2_N}",
                   lambda: dbls.device_sum_g2(pts2, pad_n=G2_N, device=dev),
                   ["fp_mul_cols", "fp2_mul"])
    want2 = G2Point.infinity()
    for p in pts2:
        want2 = want2 + p
    if got2.compress() != want2.compress():
        raise AssertionError("sum g2: differs from the host fold")
    log(f"sum g2 N={G2_N}: equal to the host fold")

    # one committee of the collapsed batch: the duty lookahead's all-ones MSM
    # against the row the table summed on the host
    _sig, pks, _m = csets[0]
    rung = msm.msm_rung(len(pks))
    dsum = counted(f"msm g1 committee K={len(pks)} at rung {rung}",
                   lambda: dbls.device_msm_g1(pks, [1] * len(pks), pad_n=rung, device=dev),
                   ["fp_mul_cols"])
    resolved, tdev, tagg, collapsed = table.resolve_sets([csets[0]])
    if collapsed != 1:
        raise AssertionError("committee: not cached in the table")
    row = tagg[resolved[0][0] - tdev.shape[0]].cpu().numpy()
    if not np.array_equal(row, curve.pack_g1([dsum])[0][0]):
        raise AssertionError("committee: device MSM differs from the table's host sum")
    log(f"msm g1 committee K={len(pks)}: equal to the table's host-summed row")

    # a committee never seen: inserted ahead of time, first sighting K = 1
    s0 = len(registry) - 250
    fset = committee_set(rng, s0, registry[s0 - 1: s0 + 199])
    point = dbls.device_msm_g1(fset[1], [1] * 200, pad_n=msm.msm_rung(200), device=dev)
    log(f"precomputed committee: K=200 summed by the device MSM at rung {msm.msm_rung(200)}")
    outcome = table.insert_precomputed([table.index_of_point(p) for p in fset[1]], point)
    if outcome != "inserted":
        raise AssertionError(f"insert_precomputed: {outcome}")
    timed_verify(backend, [fset], "precomputed committee, first sighting", True,
                 path="raw_gather", reps=1)
    if backend.last_batch["k"] != 1 or backend.last_batch["collapsed"] != 1:
        raise AssertionError("precomputed committee: first sighting did not ship K=1")
    return hists


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="build, kernel checks and timings, one tiny verify")
    ap.add_argument("--time-only", metavar="ROOT",
                    help="only check and time the kernels of the checkout at ROOT "
                         "(--quick's lane counts and the earlier shapes) and print "
                         "them as one JSON line: to compare two trees in one run")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.time_only:
        sys.path.insert(0, str(Path(args.time_only).resolve()))
    from lighthouse_tpu_torch.crypto.device import bls as dbls, kernels, key_table
    from lighthouse_tpu_torch.utils import slot_clock

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1 device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    kernels.build()
    info = kernels.build_info
    log(f"kernel build: {info['seconds']:.2f} s ({info['library']})")
    for line in info.get("log", "").splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    rng = np.random.default_rng(args.seed)
    if args.time_only:
        shapes = {k: sorted({*QUICK_LANES[k], EARLIER_LANES[k]}) for k in KERNELS}
        timings = time_kernels(rng, dev, shapes, dict.fromkeys(KERNELS, 0))
        floor_ms = launch_floor(dev, card)
        log(card)
        print(json.dumps({"root": args.time_only, "source": str(kernels.SOURCE),
                          "launch_floor_ms": floor_ms, "timings": timings}), flush=True)
        return 0
    log("phase 2 kernels vs plain versions")
    errs = check_kernels(rng, dev)

    backend = dbls.CudaBackend(device=dev)
    if args.quick:
        log("kernel timings (device ms per launch, launches queued back to back)")
        time_kernels(rng, dev, QUICK_LANES, errs)
        launch_floor(dev, card)
        sets, msgs, hs = gossip_sets(rng, 1000)
        sets = sets[:2]
        timed_verify(backend, sets, "quick verify (B=2)", True, reps=1)
        bad = [sets[0], (sets[1][0], sets[1][1], bytes(32))]
        timed_verify(backend, bad, "quick verify tampered", False, reps=1)
        registry = registry_points(64)
        table = key_table_phase(registry, dev)
        key_table.set_table(table)
        timed_verify(backend, gossip_sets(rng, 1, registry)[0][:2],
                     "quick gathered verify (B=2)", True, reps=1, path="raw_gather")
        key_table.clear_table(table)
        sc = [int(s) for s in rng.integers(0, 2 ** 64, size=8, dtype=np.uint64)]
        want = registry[0].mul(sc[0])
        for p, s in zip(registry[1:8], sc[1:]):
            want = want + p.mul(s)
        if dbls.device_msm_g1(registry[:8], sc, device=dev) != want:
            raise AssertionError("quick msm: differs from the host fold")
        log("quick msm g1 N=8: equal to the host fold")
        log(card)
        log("quick run complete")
        return 0

    log("phase 3 gossip batch: 64 attestations, 8 committees (K=1, M=8)")
    t0 = time.perf_counter()
    sets, msgs, hs = gossip_sets(rng, 1000)
    log(f"host signing: {time.perf_counter() - t0:.2f} s")
    check_stage1_against_host(sets, msgs, hs, dev)
    t0 = time.perf_counter()
    dbls.pack_signature_sets_raw(sets, device=dev)
    torch.cuda.synchronize()
    log(f"gossip host pack (parse, limbs, hash_to_field, copy): {time.perf_counter() - t0:.3f} s")
    gwall, gcounts, ghist = timed_verify(backend, sets, "gossip valid", True)
    tampered = list(sets)
    sig, pks, m = tampered[17]
    tampered[17] = (sig, pks, bytes([m[0] ^ 1]) + m[1:])
    timed_verify(backend, tampered, "gossip tampered message", False)
    log(card)

    log("phase 4 block batch: 128 aggregates (K 180..229) + proposal + RANDAO")
    t0 = time.perf_counter()
    bsets = block_sets(rng, 100_000)
    log(f"host signing: {time.perf_counter() - t0:.2f} s; B={len(bsets)} "
        f"K<={max(len(s[1]) for s in bsets)} M={len({s[2] for s in bsets})}")
    t0 = time.perf_counter()
    dbls.pack_signature_sets_raw(bsets, device=dev)
    torch.cuda.synchronize()
    log(f"block host pack (parse, limbs, hash_to_field, copy): {time.perf_counter() - t0:.3f} s")
    bwall, counts, bhist = timed_verify(backend, bsets, "block valid", True)
    poisoned = list(bsets)
    poisoned[5] = (non_subgroup_signature(rng), bsets[5][1], bsets[5][2])
    timed_verify(backend, poisoned, "block non-subgroup signature", False)
    lane_summary("gossip valid", ghist)
    lane_summary("block valid", bhist)
    log(card)

    n_reg = REGISTRY_SIZE
    log(f"phase 5 key table: a registry of {n_reg} validators (secrets 1..{n_reg})")
    t0 = time.perf_counter()
    registry = registry_points(n_reg)
    log(f"registry host build (Jacobian additions, one batch inversion): "
        f"{time.perf_counter() - t0:.2f} s")
    # chain time is the test's own: no epoch rolls over while it runs
    slot_clock.set_clock(slot_clock.ManualSlotClock())
    table = key_table_phase(registry, dev)
    key_table.set_table(table)
    log(card)

    log("phase 6 gathered verifies (registry keys, collapse held off)")
    gbsets, gbwall, hists = gathered_phase(rng, registry, table, backend, dev)
    log(card)

    log("phase 7 collapse: a fresh block batch seen three times (agg_min_repeats 2)")
    csets, cwall, hists["collapsed block"] = collapse_phase(rng, registry, table, backend)
    log(card)

    log("phase 8 msm: G1 MSM and G2 sum against the host fold; precomputed committee")
    hists.update(msm_phase(rng, registry, table, backend, dev, csets))
    log(card)

    log("phase 9 every kernel checked against its plain version and timed at "
        "each path's lane counts (device ms per launch, launches queued back to back)")
    hists = {"gossip": ghist, "block": bhist, **hists}
    shapes = path_shapes(hists)
    print_shapes(shapes, hists)
    timings = time_kernels(rng, dev, shapes, errs)
    launch_floor(dev, card)
    # profiled after every timed run: a torch.profiler session slows the
    # launches that follow it (35-45% on an H100)
    log("phase 10 profiles")
    key_table.clear_table(table)  # the raw batches' keys are not the registry's
    gdev = profile_verify(backend, sets, "gossip valid", gwall)
    bdev = profile_verify(backend, bsets, "block valid", bwall)
    key_table.set_table(table)
    with held_collapse(table):
        profile_verify(backend, gbsets, "gathered block valid", gbwall)
    profile_verify(backend, csets, "collapsed block valid", cwall)
    key_table.clear_table(table)
    per_verify = {}
    for label, dev_ms, cnt, hist in (("gossip", gdev, gcounts, ghist),
                                     ("block", bdev, counts, bhist)):
        for k in KERNELS:
            lanes = sum(n * c for n, c in hist[k].items())
            b_ms = sum(bound(k, n)[0] * c for n, c in hist[k].items())
            log(f"per {label} verify {k}: {dev_ms[k]:.3f} device ms in {cnt[k]} "
                f"launches ({1e3 * dev_ms[k] / cnt[k]:.2f} us each), {lanes} lanes, "
                f"bound over those lanes {b_ms:.4f} ms ({b_ms / dev_ms[k]:.2%})")
            if label == "block":
                per_verify[k] = dict(lanes=lanes, device_ms=dev_ms[k], bound_ms=b_ms)
    log(card)

    rows = []
    for k in KERNELS:
        at = {r["lanes"]: r for r in timings[k]}[mode_of(bhist, k)]
        rows.append({
            "name": k, "route": "cuda",
            "source": "lighthouse_tpu_torch/csrc/fp_kernels.cu",
            "replaces": REPLACES[k], "launches": counts[k],
            "max_abs_err": errs[k], "lanes": at["lanes"], "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": None,
            "lanes_per_verify": per_verify[k]["lanes"],
            "device_ms_per_verify": per_verify[k]["device_ms"],
            "bound_ms_per_verify": per_verify[k]["bound_ms"],
            "timings": timings[k],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
