"""Chip smoke check of lighthouse_tpu_torch on one NVIDIA GPU (H100).

Drives the port's main path, BLS batch verification of signature sets,
through the entry point a node calls (``CudaBackend.verify_signature_sets``),
at mainnet shapes, and holds each of its three CUDA kernels against its
plain torch version on the card. Phases, in order; any failure raises:

1. device: require CUDA, print the card's name and power limit, build the
   kernels from ``lighthouse_tpu_torch/csrc`` and print the build time;
2. kernels: K1 ``fp_mul_cols`` (raw columns bit-exact, reduced limbs
   canonical-equal), K2 ``fp2_mul`` and K3 ``fp2_sq`` (canonical-equal,
   limbs in [0, 8191]) against their plain versions at the main path's
   lane counts, then CUDA-event timings (median of 25);
3. gossip batch: 64 single-signer attestations from 8 committees of one
   slot (K = 1, M = 8): valid -> True, one message tampered -> False; the
   decompressed signatures and the device hash-to-G2 of this batch are
   also held against the host oracle;
4. block batch: 128 aggregate attestations with 180..229 signers each plus
   the proposal and RANDAO sets (B = 130 on the 192 rung, K <= 256,
   M = 130): valid -> True, one non-subgroup signature -> False.

Each batch is verified three times (median wall printed); at the end one
more valid verify of each runs under torch.profiler for the device busy
share.

The counts of kernel launches are set to 0 just before each verify and
read just after it. The kernels line reports the launches of the valid
block-batch verify. Keys and messages are made from ``--seed``; the host
signer (pure Python) is independent of the device hash-to-curve.

    python3 chip_smoke.py            # the full check (one card)
    python3 chip_smoke.py --quick    # build + kernel checks + a tiny verify
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MEM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
INT32_MAC_RATE = 16.75e12  # int32 multiply-adds/s: 64 INT32 lanes/SM x 132 SMs x 1.98 GHz
K1_LANES = 81 * 65         # an Fp12 product's 81 Fp lanes at 65 Miller lanes
K23_LANES = 27 * 193       # an Fp12 mul_pairs' 27 Fp2 lanes at the block batch's B+1


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(rng, dev):
    from lighthouse_tpu_torch.crypto.device import fp, kernels

    def limbs(*shape):
        a = rng.integers(0, fp.LIMB_MAX + 1, size=(*shape, fp.NL), dtype=np.int32)
        a[0] = fp.LIMB_MAX   # the worst case: every limb at LIMB_MAX
        a[1] = 0
        return torch.from_numpy(a).to(dev)

    def check_reduced(got, want, name):
        if int(got.min()) < 0 or int(got.max()) > fp.LIMB_MAX:
            raise AssertionError(f"{name}: limbs outside [0, {fp.LIMB_MAX}]")
        gc, wc = fp.canonical(got), fp.canonical(want)
        err = int((gc - wc).abs().max())
        if err:
            raise AssertionError(f"{name}: canonical values differ (max {err})")
        return err, bool(torch.equal(got, want))

    rows = []
    x, y = limbs(K1_LANES), limbs(K1_LANES)
    raw = kernels.fp_mul_cols(x, y)
    raw_plain = kernels.fp_mul_cols_plain(x, y)
    torch.cuda.synchronize()
    if not torch.equal(raw, raw_plain):
        raise AssertionError("fp_mul_cols: raw columns differ from the plain version")
    err1, exact1 = check_reduced(kernels.fp_mul(x, y), kernels.fp_mul_plain(x, y),
                                 "fp_mul_cols (reduced)")
    rows.append(dict(
        name="fp_mul_cols", fn=lambda: kernels.fp_mul(x, y),
        plain=lambda: kernels.fp_mul_plain(x, y), lanes=K1_LANES,
        bytes=K1_LANES * 3 * fp.NL * 4, err=err1, exact=exact1,
        replaces="lighthouse_tpu/crypto/device/pallas_fp.py:60",
        shape=f"x, y int32[{K1_LANES}, 32] -> [{K1_LANES}, 32] (raw [.., 63] bit-exact)",
    ))
    a, b = limbs(K23_LANES, 2), limbs(K23_LANES, 2)
    err2, exact2 = check_reduced(kernels.fp2_mul(a, b), kernels.fp2_mul_plain(a, b), "fp2_mul")
    rows.append(dict(
        name="fp2_mul", fn=lambda: kernels.fp2_mul(a, b),
        plain=lambda: kernels.fp2_mul_plain(a, b), lanes=K23_LANES,
        bytes=K23_LANES * 3 * 2 * fp.NL * 4, err=err2, exact=exact2,
        replaces="lighthouse_tpu/crypto/device/pallas_fp2.py:145",
        shape=f"x, y int32[{K23_LANES}, 2, 32] -> [{K23_LANES}, 2, 32]",
    ))
    err3, exact3 = check_reduced(kernels.fp2_sq(a), kernels.fp2_sq_plain(a), "fp2_sq")
    rows.append(dict(
        name="fp2_sq", fn=lambda: kernels.fp2_sq(a),
        plain=lambda: kernels.fp2_sq_plain(a), lanes=K23_LANES,
        bytes=K23_LANES * 2 * 2 * fp.NL * 4, err=err3, exact=exact3,
        replaces="lighthouse_tpu/crypto/device/pallas_fp2.py:159",
        shape=f"x int32[{K23_LANES}, 2, 32] -> [{K23_LANES}, 2, 32]",
    ))
    for r in rows:
        r["ms"] = median_ms(r["fn"])
        r["plain_ms"] = median_ms(r["plain"])
        byte_s = r["bytes"] / MEM_RATE
        op_s = r["lanes"] * kernels.macs_per_lane(r["name"]) / INT32_MAC_RATE
        r["bound_ms"] = max(byte_s, op_s) * 1e3
        r["bound_by"] = "bytes" if byte_s >= op_s else "operations"
        log(f"kernel {r['name']}: {r['shape']}; max_abs_err {r['err']} "
            f"(limbs bit-exact: {r['exact']}); {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


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


def gossip_sets(rng, s0: int):
    """64 unaggregated attestations, 8 committees of 8 in one slot."""
    from lighthouse_tpu_torch.crypto.bls import Signature
    from lighthouse_tpu_torch.crypto.cpu.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.params import DST, R

    pks = make_keys(s0, 64)
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


def block_sets(rng, s0: int):
    """128 aggregates (K in [180, 229]) + proposal + RANDAO (K = 1)."""
    from lighthouse_tpu_torch.crypto.bls import Signature
    from lighthouse_tpu_torch.crypto.cpu.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.params import DST, R

    ks = [int(k) for k in rng.integers(180, 230, size=128)] + [1, 1]
    pks = make_keys(s0, sum(ks))
    sets, start = [], 0
    for k in ks:
        m = rng.bytes(32)
        sk_sum = (k * (s0 + start) + k * (k - 1) // 2) % R
        sig = hash_to_g2(m, DST).mul(sk_sum)
        sets.append((Signature.deserialize(sig.compress()), pks[start:start + k], m))
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


def timed_verify(backend, sets, label, expect, reps: int = 3):
    """``reps`` verifies of one batch, each with the launch counts set to 0
    just before it and read just after it; prints every wall time and the
    median. Returns (median wall, counts of the last run)."""
    from lighthouse_tpu_torch.crypto.device import kernels

    walls, counts = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        verdict = backend.verify_signature_sets(sets)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if verdict is not expect:
            raise AssertionError(f"{label}: verdict {verdict}, expected {expect}")
        if counts is not None and counts != kernels.launches:
            raise AssertionError(f"{label}: launch counts differ between runs")
        counts = dict(kernels.launches)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    wall = statistics.median(walls)
    log(f"{label}: verdict {expect} x{reps}; {wall:.3f} s per verify (median of "
        f"{', '.join(f'{w:.3f}' for w in walls)}); launches {json.dumps(counts)}")
    return wall, counts


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
    name, and the device's busy share of ``wall`` (the unprofiled median)."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="build, kernel checks and one tiny verify only")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from lighthouse_tpu_torch.crypto.device import bls as dbls, kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1 device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    kernels.build()
    info = kernels.build_info
    log(f"kernel build: {info['seconds']:.2f} s ({info['library']})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    rng = np.random.default_rng(args.seed)
    log("phase 2 kernels vs plain versions")
    rows = check_kernels(rng, dev)

    backend = dbls.CudaBackend(device=dev)
    if args.quick:
        sets, msgs, hs = gossip_sets(rng, 1000)
        sets = sets[:2]
        timed_verify(backend, sets, "quick verify (B=2)", True, reps=1)
        bad = [sets[0], (sets[1][0], sets[1][1], bytes(32))]
        timed_verify(backend, bad, "quick verify tampered", False, reps=1)
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
    gwall, _ = timed_verify(backend, sets, "gossip valid", True)
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
    bwall, counts = timed_verify(backend, bsets, "block valid", True)
    poisoned = list(bsets)
    poisoned[5] = (non_subgroup_signature(rng), bsets[5][1], bsets[5][2])
    timed_verify(backend, poisoned, "block non-subgroup signature", False)
    # profiled after every timed run: a torch.profiler session slows the
    # launches that follow it (35-45% on an H100)
    profile_verify(backend, sets, "gossip valid", gwall)
    profile_verify(backend, bsets, "block valid", bwall)
    log(card)

    print(json.dumps({"kernels": [
        {
            "name": r["name"], "route": "cuda",
            "source": "lighthouse_tpu_torch/csrc/fp_kernels.cu",
            "replaces": r["replaces"], "launches": counts[r["name"]],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        }
        for r in rows
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
