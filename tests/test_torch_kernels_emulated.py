"""The CUDA source of the port's kernels, built for the CPU, against the
plain versions.

``lighthouse_tpu_torch/csrc/fp_kernels.cu`` uses only warp shuffles,
``__syncwarp``, ``__syncthreads``, shared memory and ``__ldg``.
``tests/cuda_emu/cuda_emu.h`` maps those onto ``std::thread`` and
``std::barrier`` (one thread per CUDA thread, one barrier per warp, the
blocks of a launch one after another), so ``g++`` builds the same source,
with the same generated header, for the CPU; each ``<<<...>>>`` launch is
rewritten into a call of ``emu_launch``. The library is called through
the same C entry points the card's wrappers call. This checks the
kernels' arithmetic, indexing and synchronisation on every CPU run; what
``nvcc`` accepts and how fast the card runs it are the card tests' part
(``test_torch_kernels_cuda.py``). Skipped where there is no ``g++``.

Tolerances, as on the card: K1 raw columns and reduced limbs and K3's
limbs equal to the plain versions; K2 canonical-equal with limbs in
[0, 8191].
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.device import fp, kernels

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
# 1 lane and ragged blocks of K1's four lanes
LANES = (1, 3, 5, 13)
# K3 (one lane per block of two warps) also at the gossip verify's most
# frequent K3 launch
K3_LANES = (*LANES, 96)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernels' source for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "fp_tables.h").write_text(kernels.tables_header())
    src = kernels.SOURCE.read_text().replace(
        "#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<\s*([^,]+?),\s*([^,]+?),\s*0,\s*(.+?)>>>\(",
                     r"emu_launch(\1, \2, \3, ", src, flags=re.S)
    assert n >= 3, "no kernel launches found in the source"
    (out / "fp_kernels_emu.cpp").write_text(src)
    so = out / "libfp_kernels_emu.so"
    res = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-I", str(EMU_DIR), "-I", str(out), "-o", str(so), str(out / "fp_kernels_emu.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lh_fp_mul.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.lh_fp2_mul.argtypes = [vp, vp, vp, ci, vp]
    lib.lh_fp2_sq.argtypes = [vp, vp, ci, vp]
    return lib


def _limbs(rng, *shape):
    """Random relaxed limbs with the all-8191 worst case and zeros."""
    a = rng.integers(0, fp.LIMB_MAX + 1, size=(*shape, fp.NL), dtype=np.int32)
    a[0] = fp.LIMB_MAX
    a[1:2] = 0
    return a


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@pytest.mark.parametrize("lanes", LANES)
def test_k1_source_matches_plain(lib, lanes):
    rng = np.random.default_rng(21 + lanes)
    x, y = _limbs(rng, lanes), _limbs(rng, lanes)
    raw = np.zeros((lanes, fp.NCOLS), np.int32)
    red = np.zeros((lanes, fp.NL), np.int32)
    assert lib.lh_fp_mul(_ptr(x), _ptr(y), _ptr(raw), lanes, 0, None) == 0
    assert lib.lh_fp_mul(_ptr(x), _ptr(y), _ptr(red), lanes, 1, None) == 0
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert torch.equal(torch.from_numpy(raw), kernels.fp_mul_cols_plain(tx, ty))
    assert torch.equal(torch.from_numpy(red), kernels.fp_mul_plain(tx, ty))


@pytest.mark.parametrize("lanes", LANES)
def test_k2_source_matches_plain(lib, lanes):
    rng = np.random.default_rng(22 + lanes)
    a, b = _limbs(rng, lanes, 2), _limbs(rng, lanes, 2)
    k2 = np.zeros_like(a)
    assert lib.lh_fp2_mul(_ptr(a), _ptr(b), _ptr(k2), lanes, None) == 0
    got = torch.from_numpy(k2)
    assert int(got.min()) >= 0 and int(got.max()) <= fp.LIMB_MAX
    want = kernels.fp2_mul_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(fp.canonical(got), fp.canonical(want))


@pytest.mark.parametrize("lanes", K3_LANES)
def test_k3_source_matches_plain(lib, lanes):
    rng = np.random.default_rng(22 + lanes)
    a = _limbs(rng, lanes, 2)
    k3 = np.zeros_like(a)
    assert lib.lh_fp2_sq(_ptr(a), _ptr(k3), lanes, None) == 0
    # limb for limb, both halves (stronger than K2's canonical equality)
    assert torch.equal(torch.from_numpy(k3), kernels.fp2_sq_plain(torch.from_numpy(a)))
