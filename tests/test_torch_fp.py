"""The port's Fp field and kernel K1 against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its Pallas engine (``fp.impl("pallas_int8")``) in interpret
mode, as its own tests do; the port runs on the CPU, i.e. through the
plain version of each kernel. Tolerances: K1's raw columns and the
relaxed limbs of ``reduce_cols`` must be EQUAL (exact integers; both
packages run the same reduction plan); every other function must give
the same canonical value, with every port limb in [0, LIMB_MAX].
"""

import re

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.device import fp as jfp
from lighthouse_tpu.crypto.device import pallas_fp
from lighthouse_tpu.crypto.params import P
from lighthouse_tpu_torch.crypto.device import fp, kernels

SEED = 20261017


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs
    several worker processes side by side."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _limbs(rng, n, hi=fp.LIMB_MAX):
    return rng.integers(0, hi + 1, size=(n, fp.NL), dtype=np.int32)


@pytest.fixture(scope="module")
def operands():
    """Random relaxed limbs, the all-8191 worst case and zeros, in a
    batch of 13 (not a multiple of the TPU kernel's 8-lane tile)."""
    rng = np.random.default_rng(SEED)
    x, y = _limbs(rng, 13), _limbs(rng, 13)
    x[0] = y[0] = fp.LIMB_MAX
    x[1] = 0
    y[2] = 0
    return x, y


def _vals(a):
    a = np.asarray(a)
    return [fp.limbs_to_int(r) % P for r in a.reshape(-1, fp.NL)]


def _bounded(t):
    return int(t.min()) >= 0 and int(t.max()) <= fp.LIMB_MAX


def test_tables_equal_jax():
    assert np.array_equal(fp.FOLD, jfp.FOLD)
    assert np.array_equal(fp.SAT, jfp.SAT)
    assert np.array_equal(fp.CSUB, jfp.CSUB)
    assert np.array_equal(fp.BAND_IDX, jfp._IDX)
    assert np.array_equal(fp.BAND_MASK, jfp._BANDMASK)
    assert (fp.W, fp.NL, fp.LIMB_MAX, fp.NCOLS, fp.SPLIT_SHIFT) == (
        jfp.W, jfp.NL, jfp.LIMB_MAX, jfp.NCOLS, jfp.SPLIT_SHIFT
    )
    assert list(fp.MUL_COL_BOUNDS) == list(jfp.MUL_COL_BOUNDS)


def test_k1_raw_columns_equal_pallas(operands):
    x, y = operands
    want = np.asarray(pallas_fp.mul_cols_int8(x, y))
    got = kernels.fp_mul_cols(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.int32 and got.shape == (13, fp.NCOLS)
    assert np.array_equal(got.numpy(), want)
    # the worst-case column is the documented int32 peak
    assert int(got[0].max()) == max(fp.MUL_COL_BOUNDS) == 32 * 8191 ** 2


def test_reduce_cols_relaxed_limbs_equal_jax(operands):
    x, y = operands
    cols = np.asarray(pallas_fp.mul_cols_int8(x, y))
    want = np.asarray(jfp.reduce_cols(cols, jfp.MUL_COL_BOUNDS))
    got = fp.reduce_cols(torch.tensor(cols), fp.MUL_COL_BOUNDS)
    assert np.array_equal(got.numpy(), want)
    for bounds in (fp.ADD_BOUNDS, fp.SUB_BOUNDS, fp.SUB2_BOUNDS):
        s = np.minimum(cols[:, : fp.NL], np.array(bounds, np.int32))
        want = np.asarray(jfp.reduce_cols(s, list(bounds)))
        assert np.array_equal(fp.reduce_cols(torch.from_numpy(s), bounds).numpy(), want)


def test_field_ops_match_jax_canonical(operands):
    x, y = operands
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with jfp.impl(jfp.IMPL_PALLAS_INT8):
        cases = {
            "mul": (fp.mul(tx, ty), jfp.mul(x, y)),
            "sq": (fp.sq(tx), jfp.sq(x)),
            "add": (fp.add(tx, ty), jfp.add(x, y)),
            "sub": (fp.sub(tx, ty), jfp.sub(x, y)),
            "neg": (fp.neg(tx), jfp.neg(x)),
            "mul_small": (fp.mul_small(tx, 12), jfp.mul_small(x, 12)),
        }
        for name, (got, want) in cases.items():
            assert _bounded(got), name
            assert _vals(got) == _vals(want), name
        canon = fp.canonical(tx)
        assert np.array_equal(canon.numpy(), np.asarray(jfp.canonical(x)))
        assert int(canon.max()) <= fp.MASK
    # the values themselves, against Python integers
    ix, iy = _vals(x), _vals(y)
    assert _vals(fp.mul(tx, ty)) == [a * b % P for a, b in zip(ix, iy)]


def test_inv_pow_and_predicates(operands):
    x, _ = operands
    x = x[:4]
    tx = torch.from_numpy(x)
    with jfp.impl(jfp.IMPL_PALLAS_INT8):
        want = _vals(jfp.inv(x))
    got = fp.inv(tx)
    assert _bounded(got)
    assert _vals(got) == want == [pow(v, P - 2, P) for v in _vals(x)]
    assert _vals(fp.pow_const(tx, 5)) == [pow(v, 5, P) for v in _vals(x)]
    # x = p (relaxed, nonzero limbs) is zero; eq sees through relaxed forms
    p_limbs = torch.from_numpy(fp.int_to_limbs(P))
    assert bool(fp.is_zero(p_limbs)) and not bool(fp.is_zero(fp.const(1, "cpu")))
    two_p_plus_3 = torch.from_numpy(fp.int_to_limbs(2 * P + 3))
    assert bool(fp.eq(two_p_plus_3, fp.const(3, "cpu")))
    mask = torch.tensor([True, False, True, False])
    sel = fp.select(mask, tx, fp.zeros((4,), "cpu"))
    assert _vals(sel) == [v if m else 0 for v, m in zip(_vals(x), mask.tolist())]


def test_plans_fit_the_kernel_warp():
    """The generated header carries every plan as a compile-time type
    ``Plan<input limbs, steps...>``, in order, each inside the warp's 96
    limbs and inside the FOLD rows the header holds."""
    header = kernels.tables_header()
    rows = int(re.search(r"constexpr int kFoldRows = (\d+);", header).group(1))
    assert f"kFold[{rows}][{fp.NL}]" in header
    at = -1
    for name, bounds in kernels.PLANS.items():
        steps = fp.plan(tuple(bounds))
        args = ", ".join(str(v) for v in (len(bounds), *steps))
        line = f"using Plan{name} = Plan<{args}>;"
        assert header.find(line) > at, line
        at = header.find(line)
        n = len(bounds)
        for k in steps:
            assert k <= rows and (k == 0 or n == fp.NL + k)
            n = fp.NL if k else n + 1
            assert n <= 96, f"plan {name} needs {n} limbs"
        assert n == fp.NL
    assert fp.plan(fp.MUL_COL_BOUNDS)[:3] == (0, 0, 33)


def test_lane_counters_follow_launches():
    """``lanes`` and ``lane_hist`` move with ``launches`` and reset with it."""
    kernels.reset_launches()
    try:
        for n in (1, 192, 192):
            kernels._count("fp_mul_cols", n)
        kernels._count("fp2_mul", 18)
        assert kernels.launches == {"fp_mul_cols": 3, "fp2_mul": 1, "fp2_sq": 0}
        assert kernels.lanes == {"fp_mul_cols": 385, "fp2_mul": 18, "fp2_sq": 0}
        assert kernels.lane_hist["fp_mul_cols"] == {1: 1, 192: 2}
    finally:
        kernels.reset_launches()
    assert kernels.lanes == dict.fromkeys(kernels.launches, 0)
    assert not any(kernels.lane_hist.values())


def test_wrappers_never_fall_back_off_the_cpu(operands):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel launch, which raises here (no nvcc, no card) instead of
    quietly computing on the CPU."""
    x = torch.from_numpy(operands[0]).to("meta")
    x2 = x[:12].reshape(6, 2, fp.NL)
    for call in (lambda: kernels.fp_mul(x, x), lambda: kernels.fp_mul_cols(x, x),
                 lambda: kernels.fp2_mul(x2, x2), lambda: kernels.fp2_sq(x2)):
        with pytest.raises((RuntimeError, ValueError)):
            call()
    assert kernels.launches == {"fp_mul_cols": 0, "fp2_mul": 0, "fp2_sq": 0}
