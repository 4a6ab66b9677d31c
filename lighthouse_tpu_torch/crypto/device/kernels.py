"""The three hand-written Hopper kernels of the field funnels, their plain
torch versions, the build and the ctypes binding.

| kernel | wrapper(s) | replaces (JAX package) |
| --- | --- | --- |
| K1 ``fp_mul_cols`` | :func:`fp_mul_cols` (raw columns), :func:`fp_mul` (reduced) | ``crypto/device/pallas_fp.py::mul_cols_int8`` and its caller ``fp._mul_pallas_int8`` |
| K2 ``fp2_mul`` | :func:`fp2_mul` | ``crypto/device/pallas_fp2.py::mul2`` |
| K3 ``fp2_sq`` | :func:`fp2_sq` | ``crypto/device/pallas_fp2.py::sq2`` |

The CUDA C++ source is ``lighthouse_tpu_torch/csrc/fp_kernels.cu``. At
first use on the card, :func:`build` writes the reduction tables and the
carry/fold plans of ``fp.plan`` into a generated header, compiles the
source with ``nvcc`` for ``sm_90a`` into a shared library under
``lighthouse_tpu_torch/_build/`` and loads it with ``ctypes``. Nothing is
built or imported from the build at module import, so the package imports
on a machine without ``nvcc`` or a card.

Each wrapper takes its plain version only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises: there is no
fallback. ``launches`` counts kernel launches, one per launch and nowhere
else; ``lanes`` sums the lanes (Fp or Fp2 elements) of those launches and
``lane_hist`` counts launches by lane count, updated at the same place.
The one exception is a CUDA graph (``graphs.py``): while a thread runs a
capture or its eager warm-up, that thread counts into the capture's own
sink (:func:`counting_into`, thread-local), never into these dicts. The
warm-up's counts are then added once (its launches ran), and the
capture's are added again by :func:`credit` on every replay, which
launches the captured kernels. Counts from other threads (their own
launches, their replays' credits) go on landing in the dicts exactly,
under one lock, while a capture runs.
K1 reduces inside the kernel (the ``reduce`` flag), so ``fp.mul`` on the
card is one launch; the raw-column mode exists to hold the kernel against
``mul_cols_int8`` column for column.

Block shapes (the source's note says why): K1 is one warp per lane, four
lanes to a block; K2 one lane per block of three warps, its three
products at once; K3 one lane per block of two warps, c0 on warp 0 and
c1 on warp 1 with no block barrier between them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

import torch

from . import fp

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
SOURCE = PACKAGE_ROOT / "csrc" / "fp_kernels.cu"
BUILD_DIR = PACKAGE_ROOT / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The carry/fold plans compiled into the kernels, by the bounds they serve.
PLANS = {
    "Mul": fp.MUL_COL_BOUNDS,
    "Add": fp.ADD_BOUNDS,
    "Sub": fp.SUB_BOUNDS,
    "Sub2": fp.SUB2_BOUNDS,
}
_MAX_LIMBS = 96  # a warp holds limbs t, t+32, t+64 of a lane

launches = {"fp_mul_cols": 0, "fp2_mul": 0, "fp2_sq": 0}
lanes = dict.fromkeys(launches, 0)
lane_hist = {k: Counter() for k in launches}
_COUNT_LOCK = threading.Lock()   # the global counters, from any thread
_tls = threading.local()         # .sink: this thread's capture sink, or None


def reset_launches() -> None:
    """Set ``launches``, ``lanes`` and ``lane_hist`` to zero."""
    with _COUNT_LOCK:
        for k in launches:
            launches[k] = 0
            lanes[k] = 0
            lane_hist[k].clear()


def _count(name: str, n: int) -> None:
    """Record one launch of kernel ``name`` over ``n`` lanes: into this
    thread's capture sink when it has one, else into the global counters."""
    sink = getattr(_tls, "sink", None)
    if sink is not None:
        c, s, hist = sink[name]
        sink[name] = (c + 1, s + n, hist)
        hist[n] += 1
        return
    with _COUNT_LOCK:
        launches[name] += 1
        lanes[name] += n
        lane_hist[name][n] += 1


@contextlib.contextmanager
def counting_into():
    """Count this thread's launches into a fresh sink instead of the
    global counters while the block runs (a capture and its warm-up,
    ``graphs.py``). Yields the sink, ``{kernel: (launches, lanes, lane
    histogram)}``, :func:`snapshot`'s form. Other threads are unaffected."""
    prev = getattr(_tls, "sink", None)
    sink = {k: (0, 0, Counter()) for k in launches}
    _tls.sink = sink
    try:
        yield sink
    finally:
        _tls.sink = prev


def snapshot() -> dict:
    """A copy of the counters: {kernel: (launches, lanes, lane histogram)}."""
    with _COUNT_LOCK:
        return {k: (launches[k], lanes[k], Counter(lane_hist[k])) for k in launches}


def credit(delta: dict) -> None:
    """Add ``delta`` (in :func:`snapshot`'s form) to the global counters:
    the launches of one replay of a CUDA graph, counted into the capture's
    sink when the graph was captured (``graphs.py``), or the real launches
    of a capture's warm-up."""
    with _COUNT_LOCK:
        for k, (n, l, h) in delta.items():
            launches[k] += n
            lanes[k] += l
            lane_hist[k].update(h)


# ---------------------------------------------------------------------------
# Plain versions (plain torch; the CPU path and the card-side yardstick)
# ---------------------------------------------------------------------------

def fp_mul_cols_plain(x, y):
    """Exact schoolbook columns ``col[c] = sum_i x[i] y[c-i]`` of two Fp
    limb arrays [..., 32] -> int32 [..., 63], by broadcast-multiply-sum over
    the banded-Toeplitz gather of ``y`` (no integer GEMM on CUDA)."""
    x, y = torch.broadcast_tensors(x, y)
    return fp._dot(x, fp.band_matrix(y))


def fp_mul_plain(x, y):
    """Product mod p as relaxed limbs: the columns, then ``reduce_cols``."""
    return fp.reduce_cols(fp_mul_cols_plain(x, y), fp.MUL_COL_BOUNDS)


def fp2_mul_plain(x, y):
    """Fused Fp2 Karatsuba product [..., 2, 32]: rows (a0, a1, a0+a1) x
    (b0, b1, b0+b1), each product reduced, then ``c0 = t0 - t1`` and
    ``c1 = m - t0 - t1`` through the saturated multiple ``SAT``."""
    x, y = torch.broadcast_tensors(x, y)
    a0, a1 = x[..., 0, :], x[..., 1, :]
    b0, b1 = y[..., 0, :], y[..., 1, :]
    xr = torch.stack([a0, a1, fp.add(a0, a1)], dim=-2)
    yr = torch.stack([b0, b1, fp.add(b0, b1)], dim=-2)
    t = fp_mul_plain(xr, yr)
    t0, t1, m = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    sat = fp.table("SAT", x.device)
    c0 = fp.reduce_cols(t0 + (sat - t1), fp.SUB_BOUNDS)
    c1 = fp.reduce_cols(m + (2 * sat - t0 - t1), fp.SUB2_BOUNDS)
    return torch.stack([c0, c1], dim=-2)


def fp2_sq_plain(x):
    """Fused Fp2 square [..., 2, 32]: rows (a0+a1, a0) x (a0-a1, a1) give
    t0 and t1; ``c0 = t0`` and ``c1 = 2 t1``."""
    a0, a1 = x[..., 0, :], x[..., 1, :]
    xr = torch.stack([fp.add(a0, a1), a0], dim=-2)
    yr = torch.stack([fp.sub(a0, a1), a1], dim=-2)
    t = fp_mul_plain(xr, yr)
    t0, t1 = t[..., 0, :], t[..., 1, :]
    return torch.stack([t0, fp.add(t1, t1)], dim=-2)


# ---------------------------------------------------------------------------
# Work per lane (for the bound the chip check reports)
# ---------------------------------------------------------------------------

def _plan_macs(bounds) -> int:
    """Multiply-adds of one reduction: 32 per folded high limb."""
    return sum(fp.NL * k for k in fp.plan(tuple(bounds)))


def macs_per_lane(name: str) -> int:
    """int32 multiply-adds one lane of the kernel does: 1024 schoolbook
    products per Fp product plus the folds of its reductions."""
    prod = fp.NL * fp.NL
    mul = prod + _plan_macs(PLANS["Mul"])
    add = _plan_macs(PLANS["Add"])
    if name == "fp_mul_cols":
        return mul
    if name == "fp2_mul":
        return 3 * mul + 2 * add + _plan_macs(PLANS["Sub"]) + _plan_macs(PLANS["Sub2"])
    if name == "fp2_sq":
        return 2 * mul + 2 * add + _plan_macs(PLANS["Sub"])
    raise KeyError(name)


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

def _c_array(name: str, ctype: str, rows) -> str:
    body = ",\n  ".join(
        "{" + ", ".join(str(int(v)) for v in row) + "}" if hasattr(row, "__len__")
        else str(int(row))
        for row in rows
    )
    dims = f"[{len(rows)}]" + (f"[{len(rows[0])}]" if hasattr(rows[0], "__len__") else "")
    return f"__device__ const {ctype} {name}{dims} = {{\n  {body}\n}};\n"


def tables_header() -> str:
    """The generated header: the FOLD rows the plans use, SAT, and each
    reduction plan as a compile-time type ``Plan<input limbs, steps...>``
    (0 a carry round, k > 0 a fold of k high limbs), which the kernels
    unroll. Checks that every plan stays inside the warp's 96 limbs."""
    fold_rows = max(max(fp.plan(tuple(b)), default=1) for b in PLANS.values())
    assert fold_rows <= fp.FOLD.shape[0]
    out = [
        "// Generated by lighthouse_tpu_torch.crypto.device.kernels.tables_header()\n",
        "// from the port's fp module: reduction tables and carry/fold plans.\n",
        "#pragma once\n",
        f"constexpr int kFoldRows = {fold_rows};\n",
        _c_array("kFold", "unsigned int", fp.FOLD[:fold_rows].tolist()),
        _c_array("kSat", "unsigned int", fp.SAT.tolist()),
    ]
    for name, bounds in PLANS.items():
        steps = fp.plan(tuple(bounds))
        n = len(bounds)
        for k in steps:
            n = fp.NL if k else n + 1
            assert n <= _MAX_LIMBS, f"plan {name} needs {n} limbs"
        args = ", ".join(str(v) for v in (len(bounds), *steps))
        out.append(f"using Plan{name} = Plan<{args}>;\n")
    return "".join(out)


def _find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc on PATH")


_LIB = None
_LOCK = threading.Lock()
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per source+tables digest) and load the kernels."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.perf_counter()
        header = tables_header().encode()
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + header).hexdigest()[:16]
        out_dir = BUILD_DIR / tag
        so = out_dir / "libfp_kernels.so"
        log = ""
        compiled = not so.exists()
        if compiled:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / "fp_tables.h").write_bytes(header)
            tmp = out_dir / f"libfp_kernels.{os.getpid()}.tmp.so"
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-I", str(out_dir),
                   "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
            os.replace(tmp, so)
            (out_dir / "build.log").write_text(log)
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lh_fp_mul.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.lh_fp2_mul.argtypes = [vp, vp, vp, ci, vp]
        lib.lh_fp2_sq.argtypes = [vp, vp, ci, vp]
        for fn in (lib.lh_fp_mul, lib.lh_fp2_mul, lib.lh_fp2_sq):
            fn.restype = ci
        build_info.update(
            seconds=time.perf_counter() - t0, library=str(so), log=log,
            compiled=compiled,
        )
        _LIB = lib
        return lib


def _cuda_operand(t, tail: tuple) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"kernel operand on {t.device}: expected a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"kernel operand dtype {t.dtype}: expected int32")
    if tuple(t.shape[t.dim() - len(tail):]) != tail:
        raise ValueError(f"kernel operand shape {tuple(t.shape)}: expected [..., {tail}]")
    if t.device.index != torch.cuda.current_device():
        raise ValueError("kernel operands must lie on the current CUDA device")
    return t.contiguous()


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _is_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _launch_fp_mul(x, y, reduce: bool):
    lib = build()
    x, y = torch.broadcast_tensors(x, y)
    x = _cuda_operand(x, (fp.NL,))
    y = _cuda_operand(y, (fp.NL,))
    lead = x.shape[:-1]
    out = torch.empty((*lead, fp.NL if reduce else fp.NCOLS),
                      dtype=torch.int32, device=x.device)
    n = out.numel() // out.shape[-1] if out.numel() else 0
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib.lh_fp_mul(x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                         int(reduce), stream), "fp_mul_cols")
    _count("fp_mul_cols", n)
    return out


def fp_mul_cols(x, y):
    """K1, raw mode: exact int32 product columns [..., 63]."""
    if _is_cpu(x, y):
        return fp_mul_cols_plain(x, y)
    return _launch_fp_mul(x, y, reduce=False)


def fp_mul(x, y):
    """K1, reduced mode: the product mod p as relaxed limbs [..., 32]."""
    if _is_cpu(x, y):
        return fp_mul_plain(x, y)
    return _launch_fp_mul(x, y, reduce=True)


def fp2_mul(x, y):
    """K2: fused Fp2 product [..., 2, 32] (relaxed limbs)."""
    if _is_cpu(x, y):
        return fp2_mul_plain(x, y)
    lib = build()
    x, y = torch.broadcast_tensors(x, y)
    x = _cuda_operand(x, (2, fp.NL))
    y = _cuda_operand(y, (2, fp.NL))
    out = torch.empty_like(x)
    n = x.numel() // (2 * fp.NL)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib.lh_fp2_mul(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, stream),
           "fp2_mul")
    _count("fp2_mul", n)
    return out


def fp2_sq(x):
    """K3: fused Fp2 square [..., 2, 32] (relaxed limbs)."""
    if _is_cpu(x):
        return fp2_sq_plain(x)
    lib = build()
    x = _cuda_operand(x, (2, fp.NL))
    out = torch.empty_like(x)
    n = x.numel() // (2 * fp.NL)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib.lh_fp2_sq(x.data_ptr(), out.data_ptr(), n, stream), "fp2_sq")
    _count("fp2_sq", n)
    return out
