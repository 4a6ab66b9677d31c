"""The benchmark's input maker: the registry's public keys and the
signatures of a run's sets, from the frozen C library in
``benchmark/native/`` (never the program's).

The library is built with the system C compiler at first use into
``benchmark/_build/native-<digest>/`` (the digest covers the sources, so
an edited source rebuilds), through a temporary file that ``os.replace``
moves into place. Signing runs in a pool of worker processes, one message
per task: the message is hashed to G2 once and every scalar of that
message multiplies the hashed point (``bench_sign_many``).
"""

from __future__ import annotations

import ctypes
import hashlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

from .generator import R, SetSpec

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

_lib = None


def build() -> Path:
    """Compile ``bench_inputs.c`` once per digest of the sources; the
    path of the shared library."""
    digest = hashlib.sha256()
    for name in ("bench_inputs.c", "bls12381.c", "bls12381_tables.h"):
        digest.update((NATIVE_DIR / name).read_bytes())
    out_dir = BUILD_DIR / f"native-{digest.hexdigest()[:16]}"
    so = out_dir / "libbench_inputs.so"
    if so.exists():
        return so
    cc = next((c for c in (os.environ.get("CC"), "cc", "gcc", "clang") if c and shutil.which(c)), None)
    if cc is None:
        raise RuntimeError("no C compiler found (set CC, or put cc on PATH)")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libbench_inputs.{os.getpid()}.tmp.so"
    cmd = [cc, "-O3", "-fPIC", "-shared", "-I", str(NATIVE_DIR),
           str(NATIVE_DIR / "bench_inputs.c"), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed on bench_inputs.c:\n{(res.stdout + res.stderr)[-4000:]}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        handle.bench_g1_range.restype = ctypes.c_int
        handle.bench_g1_range.argtypes = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_char_p]
        handle.bench_sign_many.restype = ctypes.c_int
        handle.bench_sign_many.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p]
        _lib = handle
    return _lib


def registry_xy(n: int) -> bytes:
    """The public keys of validators 0 .. n-1 (secrets 1 .. n) as raw
    affine x || y, 96 big-endian bytes each; kept beside the library that
    built them, so that only a checkout's first run builds them."""
    cache = build().parent / f"registry-{n}.bin"
    if cache.exists() and cache.stat().st_size == 96 * n:
        return cache.read_bytes()
    out = ctypes.create_string_buffer(96 * n)
    if lib().bench_g1_range(1, n, out) != 1:
        raise RuntimeError("bench_g1_range failed")
    tmp = cache.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(out.raw)
    os.replace(tmp, cache)
    return out.raw


def sign_message(msg: bytes, scalars: Sequence[int]) -> List[bytes]:
    """Compressed signatures [s] H(msg) for each scalar s."""
    n = len(scalars)
    if n == 0:
        return []
    buf = b"".join((int(s) % R).to_bytes(32, "big") for s in scalars)
    out = ctypes.create_string_buffer(96 * n)
    if lib().bench_sign_many(msg, len(msg), DST, len(DST), n, buf, out) != 1:
        raise RuntimeError("bench_sign_many failed")
    raw = out.raw
    return [raw[96 * j:96 * (j + 1)] for j in range(n)]


def _sign_task(task):
    return [sign_message(msg, scalars) for msg, scalars in task]


def sign_sets(specs: Sequence[SetSpec], workers: int) -> List[bytes]:
    """The signature of every set of ``specs``, in order, signed in
    ``workers`` processes (1 = this process)."""
    by_msg: Dict[bytes, List[int]] = {}
    for i, s in enumerate(specs):
        by_msg.setdefault(s.msg, []).append(i)
    msgs = list(by_msg)
    jobs = [(m, [specs[i].scalar() for i in by_msg[m]]) for m in msgs]
    if workers <= 1 or len(jobs) < 2 * workers:
        results = _sign_task(jobs)
    else:
        lib()  # build before the workers start, so they only load it
        # a cost-balanced split: a message's cost is its hash plus one
        # multiplication per scalar (a table's worth when it has many)
        tasks = [[] for _ in range(workers * 4)]
        load = [0.0] * len(tasks)
        order = sorted(range(len(jobs)), key=lambda j: -len(jobs[j][1]))
        slot_of = {}
        for j in order:
            k = min(range(len(tasks)), key=load.__getitem__)
            slot_of[j] = (k, len(tasks[k]))
            tasks[k].append(jobs[j])
            n = len(jobs[j][1])
            load[k] += 2.0 + (n if n < 4 else 1.0 + 0.25 * n)
        # an executor, not a Pool: a worker that dies raises here instead
        # of being replaced forever
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_sign_task, tasks))
        results = [done[k][p] for j in range(len(jobs)) for k, p in [slot_of[j]]]
    sigs: List[bytes] = [b""] * len(specs)
    for (m, _), res in zip(jobs, results):
        for i, sig in zip(by_msg[m], res):
            sigs[i] = sig
    return sigs
