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
9. warm dispatch: the graphs captured on first use in phases 3-8 are
   dropped; a ``CompileService`` over the rungs those batches landed on,
   then the first ``WARM_DEFAULT_RUNGS`` of ``DEFAULT_RUNGS``, with the MSM
   ladder on, captures every stage graph ahead of traffic (per rung and
   stage: capture and eager warm-up seconds, node count, pool bytes); with
   the service attached the gossip, raw block, gathered block and
   collapsed block batches are verified again, every stage replaying its
   graph, their credited launches and lanes equal to the eager run's; a
   stale-input sequence (valid, poisoned, valid, other signers valid and
   poisoned) on one rung; the MSM and G2 sum through their graphs equal to
   the host fold;
10. concurrent warm: the phase-9 service's worker is asked for two cold
   rungs of ``DEFAULT_RUNGS`` and captures them while this thread serves
   the warm gossip and gathered block batches in turns: each wall (under
   ``WARM_WALL_LIMIT_S``), the lock waits, each capture's span and how far
   the verifies overlapped the captures; the counters must end at the
   verifies' eager counts plus the worker's warm-ups;
11. engines: the gossip batch verified under each of ``ENGINE_TRIPLES``
   (the composed Fp2 and line steps over each ``fp.mul`` engine): valid
   (a capture, then a replay) and poisoned, each triple's capture
   seconds, nodes and walls; then the default triple's graphs replay
   with no new capture;
12. serve: the port's ``VerificationScheduler`` with the phase-9 compile
   service attached and its default verifier (the card), replaying
   ``traffic.gossip_steady`` (``SERVE_DURATION_S`` seconds at the
   generator's mainnet-shaped rates) three times, each event submitted at
   its time as a real signed set of its kind: a cold pass (flushes route
   warm, or padded onto a warm rung while the worker warms their exact
   rungs), ``wait_idle``, a warm pass with one attestation signed over the
   wrong message and the phase-4 and phase-6 block batches through
   ``verify_now`` (with ``--planner-off`` run again with the flush planner
   off, every flush one rung, to compare), and a shed pass through a
   second compile service that holds only ``SERVE_SHED_RUNG``: the first
   flush of each geometry sheds to the C fallback while that service's
   worker warms its rung. Per pass: submissions, flushes, sub-batches,
   routes and fallback calls, each kind's p50/p99 submit-to-verdict
   latency and miss ratio by path, bisections, the K1-K3 launches
   credited, the graphs captured and the ``verify_now`` walls; each
   pass's lane counts join phase 13's. Every verdict must be right (the
   poisoned one alone False), the warm pass must shed nothing and launch
   K1-K3, the shed pass must serve a shed flush on the fallback, and the
   fallback is ``cpu-native``. The phase ends when the service is idle;
13. kernel timings where the path runs them: each kernel checked again and
   timed (device ms per launch, launches queued back to back behind a
   device sleep, CUDA events) with its plain version and its bound at 1
   lane, at the most frequent and at the largest lane count of the block
   batch's valid verify (K3 at every lane count either batch launched),
   and at the shapes earlier versions timed; beside them the launch
   floor, the device time per launch of a one-element in-place add
   queued the same way;
14. two more valid verifies, graph replays, of each raw batch, of the
   gathered block batch and of the collapsed block batch: one timed by
   CUDA events around the replays, one under torch.profiler (which sees
   the kernels inside the graphs): the device busy share, and for the raw
   batches each kernel's device ms per verify beside its lanes per verify
   and the bound summed over them.

Each stage is one CUDA graph per rung (``graphs.CapturedProgram``): a
rung's first verify runs the eager warm-ups and captures, later ones
replay, and the counts of the two must be equal. Each batch is verified
three times (median wall printed); every verify prints its path, padded
rung, whether it replayed, its per-stage walls, host resolve and pack
seconds and the bytes it copied to the card.

The counts of kernel launches (and the lanes they carry) are set to 0
just before each verify and read just after it. The kernels line reports
the launches of the valid block-batch verify. Keys and messages are made
from ``--seed``; the host signer (pure Python) is independent of the
device hash-to-curve.

    python3 chip_smoke.py            # the full check (one card)
    python3 chip_smoke.py --quick    # build, kernel checks and timings, graphs, tiny verifies,
                                     # a concurrent warm-up, the engine triples, MSM
    python3 chip_smoke.py --time-only DIR   # time the kernels of the checkout at DIR
"""

from __future__ import annotations

import argparse
import gc
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
# The warm phase's compile service walks the batches' rungs, then this many
# of the default rungs (a rung's three captures take about 10 s on an H100,
# so the whole ladder would take minutes); and waits this long for them.
WARM_DEFAULT_RUNGS = 3
WARM_TIMEOUT_S = 600
# The concurrent-warm phase queues these rungs of DEFAULT_RUNGS (by index;
# cold after phase 9) on the compile service's worker while this thread
# serves warm batches, whose walls must stay under WARM_WALL_LIMIT_S (a
# stage-3 capture alone takes 2.4 s or more on an H100).
CONCURRENT_COLD = (3, 5)
WARM_WALL_LIMIT_S = 1.0
# The engine phase's (fp, fp2, line) engine triples, each verified on the
# gossip batch (its first verify captures the rung under that triple).
ENGINE_TRIPLES = (("toeplitz_int32", "composed", "composed"),
                  ("matmul_int8", "composed", "composed"),
                  ("pallas_int8", "composed", "composed"))
# The serve phase's trace: traffic.gossip_steady at its own mainnet-shaped
# rates (40 unaggregated, 12 aggregates, 6 sync messages per second) for
# this many seconds; its pools: committees of 8 signers (one attestation
# message each) and sync-committee signers over one block root.
SERVE_DURATION_S = 8.0
SERVE_COMMITTEES = 7
SERVE_SYNC = 16
# the shed pass's second compile service warms only this rung: the
# precomputed committee's (phase 8), which phase 9 captures
SERVE_SHED_RUNG = (1, 1, 1)
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
    host's speed, timed by CUDA events; the median of ``rounds``. A round
    counts only if the host finished queueing before the sleep ended: one
    that did not is run again behind a sleep twice as long (the garbage
    collector is held off while a round queues), and the third such round
    in a row raises."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = 3 * reps * (time.perf_counter() - t0) + 1e-3
    times, late = [], 0
    while len(times) < rounds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
        gc.disable()
        try:
            t0 = time.perf_counter()
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            queued_s = time.perf_counter() - t0
        finally:
            gc.enable()
        b.synchronize()
        if queued_s > sleep_s:
            late += 1
            if late == 3:
                raise RuntimeError(f"timing: queueing took {queued_s:.4f} s, longer "
                                   f"than the {sleep_s:.4f} s device sleep, 3 rounds in a row")
            sleep_s *= 2
            continue
        late = 0
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
    stages = ", ".join(f"{k} {v:.4f}" for k, v in lb["stages"].items())
    return (f"path {lb['path']}, B={lb['b']} K={lb['k']} M={lb['m']}, "
            f"{'graphs replayed' if lb['warm'] else 'a stage captured'} (stage s: "
            f"{stages}), {lb['collapsed']} of {lb['n_sets']} sets collapsed, host "
            f"resolve {lb['resolve_s']:.4f} s, host pack {lb['pack_s']:.4f} s, H2D "
            f"{lb['h2d_bytes']} B of which pubkey planes {lb['pubkey_bytes']} B")


def timed_verify(backend, sets, label, expect, reps: int = 3, path=None,
                 warm=None, record=None):
    """``reps`` verifies of one batch, each with the launch counts set to 0
    just before it and read just after it; prints every wall time and the
    median, the batch's path, rung and per-stage walls, and its host and
    copy costs. A rung's first verify runs each stage's eager warm-up and
    captures its graph; later ones replay it: their counts must be equal.
    ``path``, when given, is the path every verify must take; ``warm``,
    when True, requires every verify to replay graphs only. ``record``,
    when given, receives the per-stage seconds of each verify. Returns
    (median wall, launch counts and lane histograms {kernel: {lanes:
    launches}} of the last run)."""
    from lighthouse_tpu_torch.crypto.device import kernels

    walls, counts, hist, kinds, stage_s = [], None, None, [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        verdict = backend.verify_signature_sets(sets)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        lb = backend.last_batch
        if verdict is not expect:
            raise AssertionError(f"{label}: verdict {verdict}, expected {expect}")
        if path is not None and lb["path"] != path:
            raise AssertionError(f"{label}: path {lb['path']}, expected {path}")
        if warm and not lb["warm"]:
            raise AssertionError(f"{label}: a stage was captured, not replayed")
        if counts is not None and counts != kernels.launches:
            raise AssertionError(f"{label}: launch counts differ between runs "
                                 f"({counts} then {kernels.launches})")
        counts = dict(kernels.launches)
        hist = {k: dict(h) for k, h in kernels.lane_hist.items()}
        kinds.append("replay" if lb["warm"] else "capture")
        stage_s.append(lb["stages"])
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    wall = statistics.median(walls)
    med = {k: statistics.median(s[k] for s in stage_s) for k in stage_s[-1]}
    if record is not None:
        record.update(walls=walls, stages=med, kinds=kinds)
    log(f"{label}: verdict {expect} x{reps} ({', '.join(kinds)}); {wall:.3f} s per "
        f"verify (median of {', '.join(f'{w:.3f}' for w in walls)}); per-stage median "
        f"s {json.dumps({k: round(v, 4) for k, v in med.items()})}; launches "
        f"{json.dumps(counts)}; lanes {json.dumps(dict(kernels.lanes))}")
    log(f"  {label}: {batch_line(backend)}")
    return wall, counts, hist


def check_stage1_against_host(sets, msgs, hs, dev):
    """Decompressed signatures and device hash-to-G2 vs the host oracle."""
    from lighthouse_tpu_torch.crypto.device import bls as dbls, fp

    args = dbls.pack_signature_sets_raw(sets, device=dev)
    sig_xy, mx, my, minf, sig_ok = dbls._stage1(args[2], args[3], args[4])
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
    """Two more verifies, their stages replaying their graphs: one with
    CUDA events around each replay (the graphs' device time, gaps between
    their nodes included), then one under torch.profiler (the device time
    by kernel name, which the profiler reads inside the graphs). Prints
    the device's busy share of ``wall`` (the unprofiled median). Returns
    {kernel: device ms} for the port's kernels (None where the profiler
    saw none)."""
    from torch.profiler import ProfilerActivity, profile

    from lighthouse_tpu_torch.crypto.device import graphs

    torch.cuda.synchronize()
    graphs.set_event_timing(True)
    backend.verify_signature_sets(sets)
    replay_s = graphs.replay_device_ms() / 1e3
    graphs.set_event_timing(False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        backend.verify_signature_sets(sets)
        torch.cuda.synchronize()
    if not backend.last_batch["warm"]:
        raise AssertionError(f"profile {label}: a stage was captured, not replayed")
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
        f"device ops (profiler); graph replays {replay_s:.4f} s of device time (CUDA "
        f"events, gaps inside the graphs included); idle share "
        f"{1 - busy_s / wall:.3f} (profiler) / {1 - replay_s / wall:.3f} (events) of "
        f"the {wall:.4f} s median wall")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3:9.3f} ms {count:7d}x  {key[:80]}")
    per = {name: sum(r[0] for r in rows if PROFILE_NAME[name] in r[2]) / 1e3
           for name in KERNELS}
    return {name: ms or None for name, ms in per.items()}


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
    Returns the lane histograms of the three device sums by path, and the
    inputs and host folds of the G1 MSM and the G2 sum."""
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
    refs = {"g1": (pts, sc, want), "g2": (None, None, None)}
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
    refs["g2"] = (pts2, None, want2)
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
    return hists, refs


# ---------------------------------------------------------------------------
# The warm staged dispatch: each stage a CUDA graph per rung, captured by the
# compile service ahead of traffic
# ---------------------------------------------------------------------------

def check_captured_k1(rng, dev) -> None:
    """One K1 launch from the ctypes library captured into a graph on the
    torch stream: the capture's own replay equals the eager warm-up (the
    wrapper checks), and a replay on new inputs equals an eager launch."""
    from lighthouse_tpu_torch.crypto.device import graphs, kernels

    x, y, x2, y2 = (operands(rng, "fp_mul_cols", 192, dev)[0] for _ in range(4))
    prog = graphs.CapturedProgram(kernels.fp_mul, "check_k1")
    if not torch.equal(prog(x, y), kernels.fp_mul_plain(x, y)):
        raise AssertionError("captured K1: the capture differs from the plain version")
    if not torch.equal(prog(x2, y2), kernels.fp_mul(x2, y2)):
        raise AssertionError("captured K1: a replay differs from an eager launch")
    g = prog.graph_for(x, y)
    log(f"captured K1 at 192 lanes: capture and replay equal to eager; {g.nodes} "
        f"graph nodes, capture {g.capture_s:.4f} s, pool {g.pool_bytes} B")
    prog.reset()
    kernels.reset_launches()


def start_service(plan, dev):
    """Start a compile service over ``plan`` with the MSM ladder on, attach
    it, and wait until it has warmed every rung. Returns (service, wall)."""
    from lighthouse_tpu_torch.compile_service import service as csvc

    svc = csvc.CompileService(rungs=plan, device=dev)
    csvc.set_msm_warm_enabled(True)
    csvc.set_service(svc)
    t0 = time.perf_counter()
    svc.start()
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"compile service not idle after {WARM_TIMEOUT_S} s: "
                             f"{json.dumps(svc.status(), default=str)[:2000]}")
    wall = time.perf_counter() - t0
    st = svc.status()
    cold = [r for r in plan if [*r, svc._impl()] not in st["warm_rungs"]]
    if st["failed_total"] or cold:
        raise AssertionError(f"compile service: rungs {cold} cold, "
                             f"{st['failed_total']} failures: {st['last_error']}")
    return svc, wall


def capture_table(plan, msm_rungs, dev) -> dict:
    """Print each rung's stage graphs (and the MSM ladder's): capture
    seconds, eager warm-up seconds, node count, pool bytes; a graph two
    rungs share is printed once. Returns the rows by 'BxKxM stage'."""
    from lighthouse_tpu_torch.compile_service import lowering
    from lighthouse_tpu_torch.crypto.device import bls as dbls, fp

    progs = lowering.staged_captured()
    out, seen = {}, {}

    def row(label, g):
        if g is None:
            raise AssertionError(f"{label}: no graph captured")
        if id(g) in seen:  # stage 1 keys on (B, M), stage 2 on (B, K), stage 3 on B
            out[label] = {"same_as": seen[id(g)]}
            log(f"  {label}: the graph of {seen[id(g)]}")
            return
        seen[id(g)] = label
        out[label] = dict(capture_s=g.capture_s, instantiate_s=g.instantiate_s,
                          warmup_s=g.warmup_s, nodes=g.nodes,
                          pool_bytes=g.pool_bytes, launches=g.record()["launches"])
        log(f"  {label}: capture {g.capture_s:.3f} s (instantiate {g.instantiate_s:.3f}), "
            f"eager warm-up {g.warmup_s:.3f} s, "
            f"{g.nodes} nodes, pool {g.pool_bytes} B, launches {json.dumps(out[label]['launches'])}")

    for rung in plan:
        args = lowering.staged_dummy_args(*rung, device=dev)
        for stage in lowering.STAGES:
            row(f"{'x'.join(map(str, rung))} {stage}", progs[stage].graph_for(*args[stage]))
    for n in msm_rungs:
        z = lambda *shape, dt=torch.int32: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        row(f"msm N={n}", dbls._msm.graph_for(z(n, 2, fp.NL), z(n, dt=torch.bool), z(n, 2)))
        row(f"g2sum N={n}", dbls._g2sum.graph_for(z(n, 2, 2, fp.NL), z(n, dt=torch.bool)))
    return out


def graph_summary(label: str) -> dict:
    """Print and return the totals of every captured graph."""
    from lighthouse_tpu_torch.crypto.device import graphs

    st = graphs.status()
    log(f"{label}: {st['graphs']} graphs, {st['nodes']} nodes, {st['pool_bytes']} B of "
        f"graph pools on the card (reserved {torch.cuda.memory_reserved()} B in all); "
        f"lock waits {json.dumps(st['lock_wait_s'])}")
    return {k: st[k] for k in ("graphs", "nodes", "pool_bytes", "lock_wait_s")}


def stale_input_check(rng, backend, sets) -> None:
    """On one rung (``sets``: a gossip batch, its first two sets of one
    committee): valid, poisoned (the first two signatures swapped: same
    message, wrong signers), valid, a second valid batch with other
    signers, then that batch with a non-subgroup signature. Each verdict
    must be right and each verify must replay the rung's graphs (stale
    inputs would repeat a verdict)."""
    swapped = list(sets)
    swapped[0] = (sets[1][0], sets[0][1], sets[0][2])
    swapped[1] = (sets[0][0], sets[1][1], sets[1][2])
    other, _m, _h = gossip_sets(rng, 5000)
    other = other[: len(sets)]
    other_bad = list(other)
    other_bad[-1] = (non_subgroup_signature(rng), other[-1][1], other[-1][2])
    rung = None
    seq = (("valid", sets, True), ("poisoned", swapped, False), ("valid", sets, True),
           ("other signers valid", other, True),
           ("other signers poisoned", other_bad, False))
    for label, batch, want in seq:
        got = backend.verify_signature_sets(batch)
        lb = backend.last_batch
        rung = rung or lb["rung"]
        if got is not want or not lb["warm"] or lb["rung"] != rung:
            raise AssertionError(f"stale-input check, {label}: verdict {got} (want {want}), "
                                 f"warm {lb['warm']}, rung {lb['rung']} (want {rung})")
    log(f"stale-input check on rung {rung}: " + ", ".join(
        f"{label} {want}" for label, _b, want in seq) + " (all replays)")


def served_verify(backend, sets, label, expect, path, eager_hist) -> dict:
    """Three verifies with the service attached, all replays; their
    credited launches and lanes must equal the eager run's."""
    rec = {}
    wall, counts, hist = timed_verify(backend, sets, label, expect, path=path,
                                      warm=True, record=rec)
    if hist != eager_hist:
        raise AssertionError(f"{label}: credited lane counts differ from the eager run")
    log(f"  {label}: credited launches and lanes equal the eager run's")
    return dict(wall=wall, walls=rec["walls"], stages=rec["stages"], launches=counts,
                rung=backend.last_batch["rung"])


def served_sum(label, fn, want, eager_hist) -> None:
    """One device sum with the service attached: equal to the host fold,
    its credited counts equal the eager run's."""
    from lighthouse_tpu_torch.crypto.device import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = fn()
    dt = time.perf_counter() - t0
    hist = {k: dict(h) for k, h in kernels.lane_hist.items()}
    if got.compress() != want.compress():
        raise AssertionError(f"{label}: differs from the host fold")
    if hist != eager_hist:
        raise AssertionError(f"{label}: credited lane counts differ from the eager run")
    log(f"{label} through its graph: equal to the host fold, {dt:.4f} s; credited "
        f"launches {json.dumps(dict(kernels.launches))} equal the eager run's")


def _add_hist(into: dict, hist: dict) -> None:
    """Add a lane histogram {kernel: {lanes: launches}} into ``into``."""
    for k, h in hist.items():
        for n, c in h.items():
            into.setdefault(k, {})
            into[k][n] = into[k].get(n, 0) + c


def concurrent_warm_phase(svc, backend, cold_rungs, traffic, dev) -> dict:
    """Queue ``cold_rungs`` on the attached service's worker and, while it
    warms and captures them, verify the warm ``traffic`` batches from this
    thread in turns, ``(label, sets, want, path, eager lane histogram)``
    each. Prints every wall, the lock waits and how far the verifies
    overlapped the captures. Fails on a wrong verdict, a verify that
    captured or took another path, a wall of WARM_WALL_LIMIT_S or more, no
    verify overlapping a capture, or counters other than the verifies'
    eager counts plus the worker's warm-ups (each equal to its graph's
    credit)."""
    from lighthouse_tpu_torch.compile_service import lowering
    from lighthouse_tpu_torch.crypto.device import graphs, kernels

    progs = lowering.staged_captured()

    def stage_graphs():
        return [progs[st].graph_for(*lowering.staged_dummy_args(*r, device=dev)[st])
                for r in cold_rungs for st in lowering.STAGES]

    if any(g is not None for g in stage_graphs()):
        raise AssertionError(f"concurrent warm: a stage of {cold_rungs} is captured already")
    before = {id(g) for p in list(graphs._PROGRAMS) for g in p._graphs.values()}
    waits0 = graphs.status()["lock_wait_s"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_start = time.perf_counter()
    for r in cold_rungs:
        svc.request(*r)
    verifies, want_hist = [], {}
    while True:
        st = svc.status()
        if st["in_flight"] is None and not st["queue"]:
            break
        for label, sets, want, path, hist in traffic:
            t0 = time.perf_counter()
            got = backend.verify_signature_sets(sets)
            t1 = time.perf_counter()
            lb = backend.last_batch
            if got is not want or not lb["warm"] or lb["path"] != path:
                raise AssertionError(f"concurrent warm, {label}: verdict {got} (want {want}), "
                                     f"warm {lb['warm']}, path {lb['path']}")
            stages = {"resolve": lb["resolve_s"], "pack": lb["pack_s"], **lb["stages"]}
            stages["rest"] = t1 - t0 - sum(stages.values())
            verifies.append((label, t0, t1, stages))
            _add_hist(want_hist, hist)
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("concurrent warm: the service did not finish its rungs")
    span = time.perf_counter() - t_start
    st = svc.status()
    if st["failed_total"] or any([*r, svc._impl()] not in st["warm_rungs"] for r in cold_rungs):
        raise AssertionError(f"concurrent warm: rungs not warmed: {st['last_error']}")
    # every graph the worker captured in this phase: the rungs' stages and
    # the extras it warms with them (an MSM rung not yet warm)
    cold = [g for p in list(graphs._PROGRAMS) for g in p._graphs.values()
            if id(g) not in before]
    if any(g not in cold for g in stage_graphs()):
        raise AssertionError("concurrent warm: a stage graph of the cold rungs is missing")
    for g in cold:
        _add_hist(want_hist, {k: dict(h) for k, (_n, _l, h) in g.credit.items()})
    got_hist = {k: dict(h) for k, h in kernels.lane_hist.items() if h}
    if got_hist != {k: h for k, h in want_hist.items() if h}:
        raise AssertionError("concurrent warm: the counters differ from the verifies' eager "
                             "counts plus the worker's warm-ups")
    spans = sorted((g.steps["warmup"][0], g.steps["check"][1]) for g in cold)
    overlap = [sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in spans)
               for _l, t0, t1, _s in verifies]
    walls = [t1 - t0 for _l, t0, t1, _s in verifies]
    busy = sum(b - a for a, b in spans)

    def beside(t0, t1):
        """The capture steps (and seconds) a verify ran beside."""
        out = {}
        for g in cold:
            for step, (a, b) in g.steps.items():
                ov = min(t1, b) - max(t0, a)
                if ov > 0:
                    out[step] = round(out.get(step, 0.0) + ov, 4)
        return out

    waits = graphs.status()["lock_wait_s"]
    dwaits = {kind: {d: v - waits0.get(kind, {}).get(d, 0.0) for d, v in per.items()}
              for kind, per in waits.items()}
    for (label, t0, t1, stages), ov in zip(verifies, overlap):
        log(f"  concurrent {label}: {t1 - t0:.4f} s at +{t0 - t_start:.2f} s "
            f"({ov:.4f} s beside a capture: {json.dumps(beside(t0, t1))}); host and stage s "
            f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    for p in sorted(graphs._PROGRAMS, key=lambda p: p.name):
        for key, g in list(p._graphs.items()):
            if g in cold:
                shapes = " ".join("x".join(map(str, shape)) for shape, _dt in key[2])
                steps = ", ".join(f"{k} +{a - t_start:.2f}..+{b - t_start:.2f}"
                                  for k, (a, b) in g.steps.items())
                log(f"  worker captured {p.name} [{shapes}]: warm-up {g.warmup_s:.3f} s, "
                    f"capture {g.capture_s:.3f} s (instantiate {g.instantiate_s:.3f}), "
                    f"{g.nodes} nodes; steps (s) {steps}")
    n_over = sum(1 for ov in overlap if ov > 0)
    by_label = {}
    for (label, *_r), w in zip(verifies, walls):
        by_label.setdefault(label, []).append(w)
    log(f"concurrent warm: {len(verifies)} warm verifies in {span:.2f} s while the worker "
        f"warmed {cold_rungs} ({busy:.2f} s of warm-ups and captures); {n_over} verifies "
        f"overlapped a capture for {sum(overlap):.2f} s; walls max {max(walls):.4f} s, "
        f"median by batch {json.dumps({k: round(statistics.median(v), 4) for k, v in by_label.items()})}; "
        f"lock waits in this phase {json.dumps(dwaits)}; verdicts right, counters equal "
        f"the eager counts plus the warm-ups")
    if n_over == 0:
        raise AssertionError("concurrent warm: no verify overlapped a capture")
    if max(walls) >= WARM_WALL_LIMIT_S:
        raise AssertionError(f"concurrent warm: a warm verify took {max(walls):.3f} s "
                             f"(limit {WARM_WALL_LIMIT_S} s)")
    return {"cold_rungs": [list(r) for r in cold_rungs], "span_s": span,
            "capture_busy_s": busy, "verifies": len(verifies), "overlapping": n_over,
            "overlap_s": sum(overlap), "wall_max_s": max(walls),
            "walls": {k: v for k, v in by_label.items()}, "lock_waits_s": dwaits}


def engine_phase(backend, sets, dev) -> dict:
    """The gossip batch verified under each of ENGINE_TRIPLES: a first
    valid verify (which captures the rung's stage graphs under the
    triple), a replayed valid verify and a replayed poisoned one (the
    first two signatures swapped: one committee, so the same messages and
    rung, wrong signers); prints the captures' seconds and nodes and each
    wall. Then the default triple's graphs must still replay, with no new
    capture."""
    from lighthouse_tpu_torch.compile_service import lowering
    from lighthouse_tpu_torch.crypto.device import fp, fp2, graphs, kernels, pairing

    bad = list(sets)
    bad[0] = (sets[1][0], sets[0][1], sets[0][2])
    bad[1] = (sets[0][0], sets[1][1], sets[1][2])
    progs = lowering.staged_captured()
    out = {}
    n0 = graphs.status()["graphs"]
    for triple in ENGINE_TRIPLES:
        walls = []
        with fp.impl(triple[0]), fp2.impl(triple[1]), pairing.line_impl(triple[2]):
            for label, batch, want in (("first", sets, True), ("valid", sets, True),
                                       ("poisoned", bad, False)):
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                got = backend.verify_signature_sets(batch)
                walls.append(time.perf_counter() - t0)
                lb = backend.last_batch
                if got is not want or lb["warm"] is not (label != "first"):
                    raise AssertionError(f"engines {triple}, {label}: verdict {got} (want "
                                         f"{want}), warm {lb['warm']}")
            launches = dict(kernels.launches)
            args = lowering.staged_dummy_args(*lb["rung"], device=dev)
            gs = [progs[stg].graph_for(*args[stg]) for stg in lowering.STAGES]
        rec = {"rung": list(lb["rung"]),
               "capture_s": sum(g.capture_s for g in gs),
               "warmup_s": sum(g.warmup_s for g in gs),
               "nodes": sum(g.nodes for g in gs),
               "stage_nodes": [g.nodes for g in gs],
               "first_wall_s": walls[0], "wall_s": walls[1], "poisoned_wall_s": walls[2],
               "launches": launches}
        out["/".join(triple)] = rec
        log(f"  engines {'/'.join(triple)} at rung {lb['rung']}: captures "
            f"{rec['capture_s']:.3f} s (eager warm-ups {rec['warmup_s']:.3f} s), "
            f"{rec['nodes']} nodes {rec['stage_nodes']}; walls: first {walls[0]:.3f} s, "
            f"replay {walls[1]:.4f} s, poisoned {walls[2]:.4f} s (False); launches per "
            f"replay {json.dumps(launches)}")
    n1 = graphs.status()["graphs"]
    got = backend.verify_signature_sets(sets)
    if got is not True or not backend.last_batch["warm"] or graphs.status()["graphs"] != n1:
        raise AssertionError("engines: the default triple's graphs did not replay as before")
    log(f"engines: {len(ENGINE_TRIPLES)} triples right, valid and poisoned; "
        f"{n1 - n0} new graphs; the default triple "
        f"{'/'.join(graphs.engines())} still replays with no new capture")
    return out


# ---------------------------------------------------------------------------
# The verification scheduler serving gossip traffic on the card
# ---------------------------------------------------------------------------

def serve_pools(rng, s0: int):
    """Signed sets for the serve phase, as the scheduler's callers hand
    them over (``bls.SignatureSet``), one pool per caller kind of
    ``traffic.gossip_steady``: 56 unaggregated attestations of 7
    committees of 8 (K = 1), each committee's aggregate of its 8 (K = 8),
    and 16 sync-committee messages over one block root (K = 1). The 7
    attestation messages and the block root keep a flush's distinct
    messages within 8, the M of the warm gossip rungs. Also returns one
    attestation signed over the wrong message (another committee's)."""
    from lighthouse_tpu_torch.crypto.bls import PublicKey, Signature, SignatureSet
    from lighthouse_tpu_torch.crypto.cpu.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.params import DST, R

    keys = [PublicKey(p) for p in make_keys(s0, SERVE_COMMITTEES * 8 + SERVE_SYNC)]
    msgs = [rng.bytes(32) for _ in range(SERVE_COMMITTEES + 1)]
    hs = [hash_to_g2(m, DST) for m in msgs]
    pools = {"unaggregated": [], "aggregate": [], "sync_message": []}
    for c in range(SERVE_COMMITTEES):
        sig = hs[c].mul((s0 + 8 * c) % R)
        total = None
        for j in range(8):
            i = 8 * c + j
            pools["unaggregated"].append(SignatureSet(
                Signature.deserialize(sig.compress()), [keys[i]], msgs[c]))
            total = sig if total is None else total + sig
            sig = sig + hs[c]
        pools["aggregate"].append(SignatureSet(
            Signature.deserialize(total.compress()), keys[8 * c: 8 * c + 8], msgs[c]))
    s_sync = s0 + 8 * SERVE_COMMITTEES
    sig = hs[-1].mul(s_sync % R)
    for j in range(SERVE_SYNC):
        pools["sync_message"].append(SignatureSet(
            Signature.deserialize(sig.compress()), [keys[8 * SERVE_COMMITTEES + j]],
            msgs[-1]))
        sig = sig + hs[-1]
    good = pools["unaggregated"][0]
    poisoned = SignatureSet(good.signature, good.signing_keys, msgs[1])
    return pools, poisoned


def _route_counts(svc) -> dict:
    st = svc.status()
    return {**st["cold_routes"], "fallback_calls": st["fallback"]["calls"]}


def serve_pass(label, svc, events, pools, extra=(), bypass=(), **sched_kw):
    """Replay ``events`` (a ``traffic`` trace) through a fresh
    ``VerificationScheduler`` with ``svc`` attached, its default
    ``verify_fn`` (the port's ``bls.verify_signature_sets``, on the card)
    and ``sched_kw``:
    this thread submits each event at its time ``t``, a set drawn in turn
    from its kind's pool; ``extra`` holds (t, kind, set, verdict) to
    submit as well; a second thread calls ``verify_now`` with each
    (t, sets) of ``bypass``. Every verdict must be right. Prints and
    returns the pass's counts, routes (``warm`` is every routed dispatch,
    sub-batches and ``verify_now`` calls, less the padded and shed ones),
    latencies, captures and the kernels' lane histogram (``lane_hist``)."""
    import threading

    from lighthouse_tpu_torch.crypto.device import graphs, kernels
    from lighthouse_tpu_torch.verification_service import VerificationScheduler

    drawn = dict.fromkeys(pools, 0)
    items = []
    for ev in events:
        pool = pools[ev["kind"]]
        items.append((ev["t"], ev["kind"], pool[drawn[ev["kind"]] % len(pool)], True))
        drawn[ev["kind"]] += 1
    items = sorted([*items, *extra], key=lambda it: it[0])
    routes0, stages0 = _route_counts(svc), dict(svc.status()["stages"])
    graphs0 = graphs.status()["programs"]
    sched = VerificationScheduler(compile_service=svc, **sched_kw).start()
    walls_now, errors = [], []

    def blocks():
        for t, sets in bypass:
            time.sleep(max(0.0, t0 + t - time.perf_counter()))
            w0 = time.perf_counter()
            try:
                if sched.verify_now(sets, "block") is not True:
                    errors.append(f"verify_now at t={t}: False for a valid block batch")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"verify_now at t={t}: {e!r}")
            walls_now.append(time.perf_counter() - w0)

    # this stream only: a device-wide sync is refused while the compile
    # service's worker captures, and invalidates that capture
    torch.cuda.current_stream().synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    blocker = threading.Thread(target=blocks, name="serve-blocks")
    blocker.start()
    futs = []
    for t, kind, s, want in items:
        time.sleep(max(0.0, t0 + t - time.perf_counter()))
        futs.append((t, kind, want, sched.submit([s], kind)))
    submitted_s = time.perf_counter() - t0
    for t, kind, want, f in futs:
        got = f.result(timeout=WARM_TIMEOUT_S)
        if got is not want:
            errors.append(f"{kind} submitted at t={t}: verdict {got}, expected {want}")
    blocker.join()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    hist = {k: dict(h) for k, h in kernels.lane_hist.items()}
    sched.stop()
    if errors:
        raise AssertionError(f"serve {label}: " + "; ".join(errors[:10]))
    st, slo = sched.status(), sched.slo_summary()
    routes1 = _route_counts(svc)
    routes = {k: routes1[k] - routes0[k] for k in routes1}
    routes = {"warm": st["fused_batches_total"] + len(bypass) - routes["padded"]
              - routes["shed"], **routes}
    stages1 = svc.status()["stages"]
    warmed = {r: round(sum(v["seconds"] for v in recs.values()), 3)
              for r, recs in stages1.items() if r not in stages0}
    new_graphs = {}
    for prog, recs in graphs.status()["programs"].items():
        for key, rec in recs.items():
            if key not in graphs0.get(prog, {}):
                new_graphs[f"{prog} {key.split(' ', 2)[-1]}"] = round(rec["capture_s"], 3)
    out = {
        "submissions": len(futs) + len(bypass),
        "flushes": st["planner"]["plans_planned_total"] + st["planner"]["plans_single_total"],
        "sub_batches": st["fused_batches_total"],
        "planned_flushes": st["planner"]["plans_planned_total"],
        "buckets_seen": st["buckets_seen"],
        "routes": routes,
        "bisections": st["bisections_total"],
        "launches": launches,
        "wall_s": wall,
        "submit_s": submitted_s,
        "verify_now_walls_s": walls_now,
        "rungs_warmed": warmed,
        "graphs_captured": new_graphs,
        "slo": {k: {f: v[f] for f in ("count_total", "p50_ms", "p99_ms", "max_ms",
                                      "window_miss_ratio")} | {
                    "paths": {p: [d["count"], d["p50_ms"], d["p99_ms"]]
                              for p, d in v["paths"].items()}}
                for k, v in slo["kinds"].items()},
        "budget_ms": slo["budget_ms"],
        "lane_hist": hist,
    }
    log(f"serve {label}: {out['submissions']} submissions ({len(futs)} submitted over "
        f"{submitted_s:.2f} s, {len(bypass)} verify_now), {out['flushes']} flushes "
        f"({out['planned_flushes']} planned), {out['sub_batches']} sub-batches, buckets "
        f"{out['buckets_seen']}; wall {wall:.2f} s; every verdict right")
    log(f"  routes {json.dumps(routes)}; bisections {out['bisections']}; K1-K3 launches "
        f"credited {json.dumps(launches)}")
    for kind, v in out["slo"].items():
        log(f"  {kind}: {v['count_total']} verdicts, p50 {v['p50_ms']} ms, p99 "
            f"{v['p99_ms']} ms, max {v['max_ms']} ms, miss ratio {v['window_miss_ratio']} "
            f"(budget {out['budget_ms']} ms); by path [count, p50, p99] "
            f"{json.dumps(v['paths'])}")
    log(f"  verify_now walls {[round(w, 4) for w in walls_now]} s")
    log(f"  rungs the worker warmed during the pass (stage seconds): {json.dumps(warmed)}")
    log(f"  graphs captured during the pass: {len(new_graphs)}, capture s "
        f"{json.dumps(new_graphs)}")
    log(f"  {card_line()}")
    return out


def shed_pass(events, pools, rung, dev) -> dict:
    """The trace again, through a second compile service whose ladder is
    only ``rung`` (a rung phase 9 captured, so it is warm at once). It is
    not the attached service, so ``decide_flush`` downgrades ``padded`` to
    ``shed``: the first flush of every other geometry is served by
    ``fallback_verify`` on the C verifier while this service's worker
    warms the flush's exact rung (graphs the earlier passes captured, so
    each warm-up is a replay); later flushes of that geometry run on the
    card. Holds every verdict, at least one shed flush served by the
    fallback, and the fallback backend ``cpu-native``."""
    from lighthouse_tpu_torch.compile_service import service as csvc

    csvc.set_msm_warm_enabled(False)  # the MSM ladder is the attached service's
    shed_svc = csvc.CompileService(rungs=[rung], device=dev).start()
    if not shed_svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"serve shed pass: the second service did not warm {rung}")
    out = serve_pass(f"shed pass (a second service, ladder [{rung}])", shed_svc, events,
                     pools)
    if not shed_svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("serve shed pass: the second service is not idle")
    shed_svc.stop()
    csvc.set_msm_warm_enabled(True)
    fb = shed_svc.status()["fallback"]
    if fb["backend"] != "cpu-native":
        raise AssertionError(f"serve shed pass: the fallback backend is {fb['backend']}")
    if not out["routes"]["shed"] or not out["routes"]["fallback_calls"]:
        raise AssertionError(f"serve shed pass: routes {out['routes']}: no shed served")
    out["fallback"] = fb
    paths = {k: v["paths"]["fallback"] for k, v in out["slo"].items()
             if "fallback" in v["paths"]}
    log(f"  fallback {fb['backend']}: {fb['calls']} calls, {fb['sets']} sets, "
        f"{fb['seconds']:.4f} s in all; fallback path by kind [count, p50 ms, p99 ms] "
        f"{json.dumps(paths)}")
    return out


def serve_phase(rng, svc, block_batches, dev, planner_off=False) -> dict:
    """The port's ``VerificationScheduler`` on the card, with the phase-9
    compile service attached and the default ``verify_fn``: a replay of
    ``traffic.gossip_steady(duration_s=SERVE_DURATION_S, seed=0)`` in
    three passes. The cold pass meets whatever rungs its flushes ask for
    (warm, or padded onto a larger warm rung while the worker warms the
    exact one); after ``svc.wait_idle()`` the warm pass adds one poisoned
    attestation and two block batches through ``verify_now`` (with
    ``planner_off`` it runs again with the flush planner off, every flush
    one rung, to compare); the shed pass (:func:`shed_pass`) routes flushes
    to the C fallback. Ends when the service is idle. Holds every verdict,
    no shed in the warm pass, K1-K3 launched in the warm pass, and the
    fallback backend ``cpu-native``."""
    from lighthouse_tpu_torch.crypto.bls import PublicKey, SignatureSet
    from lighthouse_tpu_torch.verification_service import traffic

    events = traffic.gossip_steady(duration_s=SERVE_DURATION_S, seed=0, rate_scale=1.0)
    counts = {k: sum(1 for e in events if e["kind"] == k)
              for k in ("unaggregated", "aggregate", "sync_message")}
    t0 = time.perf_counter()
    pools, poisoned = serve_pools(rng, 300_000)
    log(f"serve trace: gossip_steady({SERVE_DURATION_S} s, seed 0): {len(events)} "
        f"submissions {json.dumps(counts)}; pools signed on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    st = svc.status()["fallback"]
    if st["backend"] != "cpu-native":
        raise AssertionError(f"serve: the fallback backend is {st['backend']}")
    t0 = time.perf_counter()
    ok = svc.fallback_verify(pools["aggregate"][:2])
    bad = svc.fallback_verify([pools["unaggregated"][1], poisoned])
    if ok is not True or bad is not False:
        raise AssertionError(f"serve: fallback_verify gave {ok}, {bad} (want True, False)")
    log(f"fallback {st['backend']} (C build and two batches) {time.perf_counter() - t0:.3f} s: "
        "valid True, poisoned False")
    out = {"trace": {"events": len(events), **counts}}
    out["cold"] = serve_pass("cold pass", svc, events, pools)
    t0 = time.perf_counter()
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"serve: the compile service is not idle after {WARM_TIMEOUT_S} s")
    out["wait_idle_s"] = time.perf_counter() - t0
    log(f"serve: the worker finished the rungs the cold pass asked for in "
        f"{out['wait_idle_s']:.2f} s more; warm rungs {svc.status()['warm_rungs']}")
    to_sets = [[SignatureSet(sig, [PublicKey(p) for p in pks], m) for sig, pks, m in batch]
               for batch in block_batches]
    half = SERVE_DURATION_S / 2
    warm_kw = dict(extra=[(half, "unaggregated", poisoned, False)],
                   bypass=[(half / 2, to_sets[0]), (half * 1.5, to_sets[1])])
    out["warm"] = serve_pass("warm pass", svc, events, pools, **warm_kw)
    w = out["warm"]
    if w["routes"]["shed"] or w["routes"]["fallback_calls"]:
        raise AssertionError(f"serve warm pass: routes {w['routes']}: a shed")
    missing = [k for k in KERNELS if not w["launches"].get(k)]
    if missing:
        raise AssertionError(f"serve warm pass: kernels never launched: {missing}")
    if planner_off:
        out["warm_single"] = serve_pass(
            "warm pass, single-rung plans (plan_flushes=False)", svc, events, pools,
            plan_flushes=False, **warm_kw)
    out["shed"] = shed_pass(events, pools, SERVE_SHED_RUNG, dev)
    # no capture of a rung the passes queued may overlap the timed phases
    t0 = time.perf_counter()
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"serve: the compile service is not idle after {WARM_TIMEOUT_S} s")
    out["end_wait_idle_s"] = time.perf_counter() - t0
    log(f"serve: the attached service was idle {out['end_wait_idle_s']:.2f} s after "
        "the last pass")
    out["fallback"] = svc.status()["fallback"]
    return out


def warm_phase(rng, dev, backend, table, batches, path_rungs, eager, refs) -> dict:
    """Drop the graphs the earlier phases captured on first use, start a
    compile service over the batches' rungs then ``DEFAULT_RUNGS`` (the
    first ``WARM_DEFAULT_RUNGS`` of them), print the capture table, then
    verify every path with the service attached, run the stale-input
    check and the MSM and G2 sum through their graphs."""
    from lighthouse_tpu_torch.compile_service.service import DEFAULT_RUNGS
    from lighthouse_tpu_torch.crypto.device import bls as dbls, graphs, key_table

    graphs.reset()
    dbls.reset_recompile_tracking()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    plan = list(dict.fromkeys([*path_rungs, *DEFAULT_RUNGS[:WARM_DEFAULT_RUNGS]]))
    log(f"compile service plan: the batches' rungs {path_rungs}, then "
        f"{WARM_DEFAULT_RUNGS} of the {len(DEFAULT_RUNGS)} default rungs "
        f"({len(plan)} rungs); MSM ladder on")
    svc, wall = start_service(plan, dev)
    log(f"compile service warmed {len(plan)} rungs and the MSM ladder in {wall:.2f} s")
    table_rows = capture_table(plan, svc.status()["msm_warm"], dev)
    summary = graph_summary("captured graphs after the warm-up")
    out = {"warm_s": wall, "plan": plan, "captures": table_rows, "graphs": summary,
           "paths": {}}

    key_table.clear_table(table)  # the raw batches' keys are not the registry's
    for label in ("gossip", "block"):
        sets, path = batches[label]
        out["paths"][label] = served_verify(backend, sets, f"served {label} valid", True,
                                            path, eager[label])
    stale_input_check(rng, backend, batches["gossip"][0])
    key_table.set_table(table)
    with held_collapse(table):
        sets, path = batches["gathered block"]
        out["paths"]["gathered block"] = served_verify(
            backend, sets, "served gathered block valid", True, path,
            eager["gathered block"])
    sets, path = batches["collapsed block"]
    out["paths"]["collapsed block"] = served_verify(
        backend, sets, "served collapsed block valid", True, path,
        eager["collapsed block"])
    pts, sc, want = refs["g1"]
    served_sum(f"msm g1 N={MSM_N}",
               lambda: dbls.device_msm_g1(pts, sc, pad_n=MSM_N, device=dev), want,
               eager[f"msm g1 N={MSM_N}"])
    pts2, _sc, want2 = refs["g2"]
    served_sum(f"sum g2 N={G2_N}",
               lambda: dbls.device_sum_g2(pts2, pad_n=G2_N, device=dev), want2,
               eager[f"sum g2 N={G2_N}"])
    out["graphs_after"] = graph_summary("captured graphs after the served verifies")
    out["service"] = svc
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="build, kernel checks and timings, one tiny verify")
    ap.add_argument("--planner-off", action="store_true",
                    help="serve phase: also replay the warm pass with the flush "
                         "planner off (every flush one rung), to compare")
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
        from lighthouse_tpu_torch.compile_service import service as csvc
        from lighthouse_tpu_torch.crypto.device import graphs

        log("kernel timings (device ms per launch, launches queued back to back)")
        time_kernels(rng, dev, QUICK_LANES, errs)
        launch_floor(dev, card)
        check_captured_k1(rng, dev)
        gsets, msgs, hs = gossip_sets(rng, 1000)
        sets = gsets[:2]
        timed_verify(backend, sets, "quick verify (B=2)", True)
        bad = [sets[0], (sets[0][0], sets[1][1], sets[1][2])]  # wrong signer
        timed_verify(backend, bad, "quick verify wrong signer", False, reps=1, warm=True)
        graphs.reset()
        dbls.reset_recompile_tracking()
        plan = [(2, 1, 1), (64, 1, 8), (192, 256, 192)]
        svc, wall = start_service(plan, dev)
        log(f"compile service warmed {plan} and {svc.status()['msm_warm']} of the MSM "
            f"ladder in {wall:.2f} s")
        capture_table(plan, svc.status()["msm_warm"], dev)
        graph_summary("captured graphs")
        stale_input_check(rng, backend, sets)
        gwall, _c, ghist = timed_verify(backend, gsets, "quick gossip (B=64) served", True,
                                        warm=True)
        concurrent_warm_phase(svc, backend, [(32, 1, 8)],
                              [("gossip", gsets, True, "raw_staged", ghist)], dev)
        engine_phase(backend, gsets, dev)
        profile_verify(backend, gsets, "quick gossip served", gwall)
        registry = registry_points(64)
        table = key_table_phase(registry, dev)
        key_table.set_table(table)
        timed_verify(backend, gossip_sets(rng, 1, registry)[0][:2],
                     "quick gathered verify (B=2)", True, path="raw_gather", warm=True)
        key_table.clear_table(table)
        sc = [int(s) for s in rng.integers(0, 2 ** 64, size=8, dtype=np.uint64)]
        want = registry[0].mul(sc[0])
        for p, s in zip(registry[1:8], sc[1:]):
            want = want + p.mul(s)
        for rep in ("capture", "replay"):
            if dbls.device_msm_g1(registry[:8], sc, device=dev) != want:
                raise AssertionError(f"quick msm ({rep}): differs from the host fold")
        log("quick msm g1 N=8: capture and replay equal to the host fold")
        svc.stop()
        csvc.clear_service(svc)
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
    path_rungs = [backend.last_batch["rung"]]
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
    path_rungs.append(backend.last_batch["rung"])
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
    path_rungs.append(backend.last_batch["rung"])
    log(card)

    log("phase 8 msm: G1 MSM and G2 sum against the host fold; precomputed committee")
    msm_hists, refs = msm_phase(rng, registry, table, backend, dev, csets)
    hists.update(msm_hists)
    path_rungs.append(backend.last_batch["rung"])
    log(card)

    log("phase 9 warm dispatch: the compile service captures each rung's stage graphs; "
        "every path verified through the graphs, with the service attached")
    hists = {"gossip": ghist, "block": bhist, **hists}
    batches = {"gossip": (sets, "raw_staged"), "block": (bsets, "raw_staged"),
               "gathered block": (gbsets, "raw_gather"),
               "collapsed block": (csets, "raw_gather")}
    warm = warm_phase(rng, dev, backend, table, batches,
                      list(dict.fromkeys(path_rungs)), hists, refs)
    log(card)

    from lighthouse_tpu_torch.compile_service.service import DEFAULT_RUNGS

    cold = [DEFAULT_RUNGS[i] for i in CONCURRENT_COLD]
    log(f"phase 10 concurrent warm: the service's worker captures the cold rungs {cold} "
        "while this thread serves warm gossip and gathered block batches")
    key_table.set_table(table)
    with held_collapse(table):
        warm["concurrent"] = concurrent_warm_phase(
            warm["service"], backend, cold,
            [("gossip", sets, True, "raw_staged", ghist),
             ("gathered block", gbsets, True, "raw_gather", hists["gathered block"])], dev)
    key_table.clear_table(table)
    log(card)

    log("phase 11 engines: the gossip batch under the composed engine triples")
    warm["engines"] = engine_phase(backend, sets, dev)
    log(card)

    log("phase 12 serve: the verification scheduler on the card, the phase-9 compile "
        "service attached, replaying gossip_steady cold, warm, then shed to the C fallback")
    warm["serve"] = serve_phase(rng, warm["service"], [bsets, gbsets], dev,
                                args.planner_off)
    for p in ("cold", "warm", "warm_single", "shed"):
        if p in warm["serve"]:
            hists[f"serve {p}"] = warm["serve"][p].pop("lane_hist")
    log(card)

    log("phase 13 every kernel checked against its plain version and timed at "
        "each path's lane counts (device ms per launch, launches queued back to back)")
    gc.collect()  # the engine phase's garbage, before the timed queueing
    shapes = path_shapes(hists)
    print_shapes(shapes, hists)
    timings = time_kernels(rng, dev, shapes, errs)
    launch_floor(dev, card)
    # profiled after every timed run: a torch.profiler session slows the
    # launches that follow it (35-45% on an H100)
    log("phase 14 profiles (graph replays)")
    key_table.clear_table(table)  # the raw batches' keys are not the registry's
    served = {k: v["wall"] for k, v in warm["paths"].items()}
    gdev = profile_verify(backend, sets, "gossip valid", served["gossip"])
    bdev = profile_verify(backend, bsets, "block valid", served["block"])
    key_table.set_table(table)
    with held_collapse(table):
        profile_verify(backend, gbsets, "gathered block valid", served["gathered block"])
    profile_verify(backend, csets, "collapsed block valid", served["collapsed block"])
    key_table.clear_table(table)
    per_verify = {}
    for label, dev_ms, cnt, hist in (("gossip", gdev, gcounts, ghist),
                                     ("block", bdev, counts, bhist)):
        for k in KERNELS:
            lanes = sum(n * c for n, c in hist[k].items())
            b_ms = sum(bound(k, n)[0] * c for n, c in hist[k].items())
            ms = dev_ms[k]
            seen = (f"{ms:.3f} device ms in {cnt[k]} launches ({1e3 * ms / cnt[k]:.2f} us "
                    f"each)" if ms else f"not seen by the profiler ({cnt[k]} launches)")
            log(f"per {label} verify {k}: {seen}, {lanes} lanes, bound over those "
                f"lanes {b_ms:.4f} ms" + (f" ({b_ms / ms:.2%})" if ms else ""))
            if label == "block":
                per_verify[k] = dict(lanes=lanes, device_ms=ms, bound_ms=b_ms)
    svc = warm.pop("service")
    svc.stop()
    from lighthouse_tpu_torch.compile_service import service as csvc
    csvc.clear_service(svc)
    warm["paths"] = {k: {**v, "rung": list(v["rung"])} for k, v in warm["paths"].items()}
    print(json.dumps({"warm_dispatch": warm}, default=str), flush=True)
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
