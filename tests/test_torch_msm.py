"""The port's windowed G1 MSM and G2 point sum against the JAX package and
the host group law (the cases of ``tests/test_device_msm.py`` at a small N).

* ``window_digits`` equals the JAX function's, a scalar with its top bit
  set included (its hi word is a negative int32);
* ``device_msm_g1`` and ``device_sum_g2`` on ``device="cpu"`` are
  byte-identical in their compressed encoding to the JAX package's host
  fold (``lighthouse_tpu.crypto.cpu.curve``) on the same points and
  scalars, with an infinity lane, a zero scalar, an empty batch and an
  all-infinity batch.

Every tolerance is exact. The JAX ``msm_g1_fn`` itself compiles for
minutes on XLA:CPU, so the test that compares with it is ``slow``.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.compile_service.service import MSM_RUNGS as JMSM_RUNGS
from lighthouse_tpu.crypto.cpu.curve import G1Point as JG1Point
from lighthouse_tpu.crypto.cpu.curve import G2Point as JG2Point
from lighthouse_tpu.crypto.cpu.curve import g1_generator as jg1
from lighthouse_tpu.crypto.cpu.curve import g2_generator as jg2
from lighthouse_tpu.crypto.device import msm as jmsm
from lighthouse_tpu_torch.crypto.cpu.curve import G1Point, g1_generator
from lighthouse_tpu_torch.crypto.device import bls as dbls
from lighthouse_tpu_torch.crypto.device import curve, fp, msm

from test_torch_bls_api import _g1, _g2

TOP = (1 << 64) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def _scalars(rng, n):
    return [int(rng.integers(1, 2 ** 63, dtype=np.int64)) * 2 + 1 for _ in range(n)]


def _words(scalars) -> np.ndarray:
    return np.stack([dbls._u64_words(s) for s in scalars])


def test_window_digits_match_jax(rng):
    sc = [TOP, 1 << 63, 0, 1, 0x0123456789ABCDEF] + _scalars(rng, 3)
    w = _words(sc)
    assert w[0, 0] < 0 and w[1, 0] < 0  # top bit set: negative hi words
    got = msm.window_digits(torch.from_numpy(w))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jmsm.window_digits(w)))
    assert got[0].tolist() == [15] * 16 and got[1].tolist() == [8] + [0] * 15
    # digits re-assemble each scalar
    for s, row in zip(sc, got.tolist()):
        assert sum(d << (4 * (15 - i)) for i, d in enumerate(row)) == s


def test_rungs_match_jax():
    assert msm.MSM_RUNGS == tuple(JMSM_RUNGS)
    assert [msm.msm_rung(n) for n in (1, 64, 65, 512, 513)] == [64, 64, 128, 512, None]


def test_msm_g1_matches_host_fold(rng):
    """Points and the reference fold from the JAX package's host curve; the
    port's MSM on the same points and scalars gives the same bytes."""
    g = jg1()
    jpts = [g.mul(int(rng.integers(1, 2 ** 62))) for _ in range(4)]
    jpts += [JG1Point.infinity(), jpts[0]]
    sc = [TOP, 1 << 63] + _scalars(rng, 2) + [7, 0]  # infinity lane, zero scalar
    want = JG1Point.infinity()
    for p, s in zip(jpts, sc):
        want = want + p.mul(s)
    pts = [_g1(p) for p in jpts]
    got = dbls.device_msm_g1(pts, sc, device="cpu")
    assert got.compress() == want.compress()
    assert dbls.device_msm_g1(pts[:1], [1], pad_n=4, device="cpu").compress() == \
        jpts[0].compress()
    with pytest.raises(ValueError):
        dbls.device_msm_g1(pts, sc[:2], device="cpu")


def test_msm_g1_empty_and_all_infinity():
    inf = JG1Point.infinity().compress()
    assert dbls.device_msm_g1([], [], device="cpu").compress() == inf
    out = dbls.device_msm_g1([G1Point.infinity()] * 3, [1, 2, 3], device="cpu")
    assert out.is_infinity() and out.compress() == inf


def test_g2_sum_matches_host_fold(rng):
    g = jg2()
    jpts = [g.mul(int(rng.integers(1, 2 ** 62))) for _ in range(5)] + [JG2Point.infinity()]
    want = JG2Point.infinity()
    for p in jpts:
        want = want + p
    pts = [_g2(p) for p in jpts]
    assert dbls.device_sum_g2(pts, device="cpu").compress() == want.compress()
    inf = JG2Point.infinity().compress()
    assert dbls.device_sum_g2([], device="cpu").compress() == inf
    # P + (-P): the complete law's infinity
    assert dbls.device_sum_g2([pts[0], -pts[0]], device="cpu").compress() == inf


@pytest.mark.slow
def test_msm_g1_fn_matches_jax(rng):
    """The port's ``msm_g1_fn`` against the JAX staged program on the same
    planes at N = 8 (an XLA:CPU compile of minutes)."""
    import jax

    g = g1_generator()
    pts = [g.mul(int(rng.integers(1, 2 ** 62))) for _ in range(7)] + [G1Point.infinity()]
    xy, inf = curve.pack_g1(pts)
    w = _words([TOP] + _scalars(rng, 7))
    oxy, oinf = msm.msm_g1_fn(*(torch.from_numpy(a) for a in (xy, inf, w)))
    jxy, jinf = jax.jit(jmsm.msm_g1_fn)(xy, inf, w)
    assert np.array_equal(oxy.numpy(), np.asarray(fp.canonical(torch.from_numpy(np.asarray(jxy)))))
    assert bool(oinf) is bool(jinf)
