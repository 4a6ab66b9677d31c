"""The port's composed engines, their switches and the helpers of the JAX
package's device algebra, against the JAX package and its host oracle.

Inputs are seeded numpy limb arrays (1-8 lanes, with the relaxed worst
case: every limb 8191) fed to both packages. The port runs on the CPU,
where K1-K3 run their plain versions. Tolerances, per test:

* ``fp.mul`` under each engine: limb for limb (``np.array_equal``) with
  JAX's ``fp.mul`` under the same ``fp.impl``: both spell the same
  schedule (the same half dots, carry rounds and reduction plan);
* ``fp2.mul``/``fp2.sq`` composed, the composed line steps, the tower
  helpers, ``map_to_curve_sswu`` and ``decompress_g2``: canonical equality
  (the port's glue reduces in other places than JAX's);
* ``multi_pairing``: equal to the host oracle's Fq12;
* the backend under ``(toeplitz_int32, composed, composed)``: the same
  verdicts as ``cpu-native``, valid and poisoned.
"""

import jax
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto.cpu import pairing as host_pairing
from lighthouse_tpu.crypto.cpu.curve import g1_generator, g2_generator
from lighthouse_tpu.crypto.cpu.fields import Fq2, Fq6, Fq12
from lighthouse_tpu.crypto.device import bls as jdbls
from lighthouse_tpu.crypto.device import fp as jfp
from lighthouse_tpu.crypto.device import fp2 as jfp2
from lighthouse_tpu.crypto.device import htc as jhtc
from lighthouse_tpu.crypto.device import pairing as jpairing
from lighthouse_tpu.crypto.device import tower as jtower
from lighthouse_tpu.crypto.native import NativeBackend
from lighthouse_tpu.crypto.params import P
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.cpu.curve import G1Point
from lighthouse_tpu_torch.crypto.cpu.fields import Fq
from lighthouse_tpu_torch.crypto.device import bls as dbls
from lighthouse_tpu_torch.crypto.device import curve, fp, fp2, pairing, tower
from lighthouse_tpu_torch.crypto.device import htc

SEED = 2026
FP_ENGINES = ("toeplitz_int32", "matmul_int8", "pallas_int8")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs
    several worker processes side by side."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _limbs(rng, *shape):
    """Random relaxed limbs [*shape, NL], lane 0 the all-8191 worst case,
    lane 1 zero."""
    a = rng.integers(0, fp.LIMB_MAX + 1, size=(*shape, fp.NL), dtype=np.int32)
    a[0] = fp.LIMB_MAX
    a[1] = 0
    return a


def _canon(x):
    """Canonical digits of a port tensor or a JAX array, as numpy."""
    if isinstance(x, torch.Tensor):
        return fp.canonical(x).numpy()
    return np.asarray(jfp.canonical(x))


def _bounded(t):
    return int(t.min()) >= 0 and int(t.max()) <= fp.LIMB_MAX


def _rand_fp2(rng, n):
    return np.stack([np.stack([fp.int_to_limbs(int.from_bytes(rng.bytes(48), "big") % P)
                               for _ in range(2)]) for _ in range(n)])


# ---------------------------------------------------------------------------
# fp.mul engines
# ---------------------------------------------------------------------------

def test_engine_pieces_equal_jax():
    rng = np.random.default_rng(SEED)
    y = _limbs(rng, 5)
    band = fp.band_matrix(torch.from_numpy(y))
    assert np.array_equal(band.numpy(), np.asarray(jfp.band_matrix(y)))
    halves = fp.split_int8(torch.from_numpy(y))
    assert halves.dtype == torch.int8
    assert np.array_equal(halves.numpy(), np.asarray(jfp.split_int8(y)))
    passes = rng.integers(0, 2 ** 20, size=(2, 2, 3, fp.NCOLS), dtype=np.int32)
    assert np.array_equal(fp.recombine_int8_passes(torch.from_numpy(passes)).numpy(),
                          np.asarray(jfp.recombine_int8_passes(passes)))
    assert [list(b) for b in fp._HALF_BOUNDS] == jfp._HALF_BOUNDS
    assert fp.SPLIT_MASK == jfp.SPLIT_MASK


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("engine", FP_ENGINES)
def test_fp_mul_engine_equals_jax_limb_for_limb(engine, lanes):
    rng = np.random.default_rng(SEED + lanes)
    x, y = _limbs(rng, max(lanes, 2))[:lanes], _limbs(rng, max(lanes, 2))[:lanes]
    x[0], y[0] = fp.LIMB_MAX, fp.LIMB_MAX
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with fp.impl(engine), jfp.impl(engine):
        got = fp.mul(tx, ty)
        want = np.asarray(jfp.mul(x, y))
        bcast = fp.mul(tx, ty[:1])  # a broadcast operand
        want_b = np.asarray(jfp.mul(x, y[:1]))
    assert fp.get_impl() == "pallas_int8"  # the context restored the default
    assert got.dtype == torch.int32 and _bounded(got)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(bcast.numpy(), want_b)
    # every engine is the same product mod p
    assert np.array_equal(_canon(got), _canon(fp.mul(tx, ty)))


def test_fp_switch_rejects_unknown_engines():
    with pytest.raises(KeyError):
        fp.set_impl("nope")
    with pytest.raises(KeyError):
        fp2.set_impl("nope")
    with pytest.raises(KeyError):
        pairing.set_line_impl("nope")
    assert (fp.get_impl(), fp2.get_impl(), pairing.get_line_impl()) == (
        "pallas_int8", "fused_pallas", "fused")


# ---------------------------------------------------------------------------
# Fp2 composed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", FP_ENGINES)
def test_fp2_composed_equals_jax_and_fused(engine):
    rng = np.random.default_rng(SEED + 2)
    x, y = _limbs(rng, 8, 2), _limbs(rng, 8, 2)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    fused = fp2.mul(tx, ty), fp2.sq(tx)
    with fp.impl(engine), fp2.impl("composed"):
        got = fp2.mul(tx, ty), fp2.sq(tx)
    with jfp.impl(engine), jfp2.impl("composed"):
        want = jfp2.mul(x, y), jfp2.sq(x)
    for g, w, f in zip(got, want, fused):
        assert _bounded(g)
        assert np.array_equal(_canon(g), _canon(w))
        assert np.array_equal(_canon(g), _canon(f))


# ---------------------------------------------------------------------------
# Line steps, composed
# ---------------------------------------------------------------------------

def test_composed_line_steps_equal_jax_and_fused():
    rng = np.random.default_rng(SEED + 3)
    n = 4
    T = tuple(_rand_fp2(rng, n) for _ in range(3))
    T[0][0] = fp.LIMB_MAX  # a relaxed worst-case lane
    xQ, yQ = _rand_fp2(rng, n), _rand_fp2(rng, n)
    xP, yP = (_rand_fp2(rng, n)[:, 0] for _ in range(2))
    tT = tuple(torch.from_numpy(a) for a in T)
    tq = torch.from_numpy(xQ), torch.from_numpy(yQ)
    tp = torch.from_numpy(xP), torch.from_numpy(yP)

    def flat(res):
        (X, Y, Z), s0, sv, sv2 = res
        return [X, Y, Z, s0, sv, sv2]

    with pairing.line_impl("composed"):
        got = flat(pairing._dbl_step(tT, *tp)) + flat(pairing._add_line(tT, *tq, *tp))
    fused = flat(pairing._dbl_step(tT, *tp)) + flat(pairing._add_line(tT, *tq, *tp))
    want = (flat(jpairing._dbl_step_composed(T, xP, yP))
            + flat(jpairing._add_line_composed(T, xQ, yQ, xP, yP)))
    for i, (g, w, f) in enumerate(zip(got, want, fused)):
        assert _bounded(g), i
        assert np.array_equal(_canon(g), _canon(w)), i
        assert np.array_equal(_canon(g), _canon(f)), i


# ---------------------------------------------------------------------------
# Tower helpers, multi_pairing
# ---------------------------------------------------------------------------

def _host_f12(rng):
    def f2():
        return Fq2.from_ints(int.from_bytes(rng.bytes(48), "big") % P,
                             int.from_bytes(rng.bytes(48), "big") % P)
    return Fq12(Fq6(f2(), f2(), f2()), Fq6(f2(), f2(), f2()))


def _f12_ints(v):
    return [c.c0.n % P for h in (v.c0, v.c1) for c in (h.c0, h.c1, h.c2)] + \
           [c.c1.n % P for h in (v.c0, v.c1) for c in (h.c0, h.c1, h.c2)]


def test_tower_helpers_equal_jax():
    rng = np.random.default_rng(SEED + 4)
    vals = [_host_f12(rng) for _ in range(3)]
    packed = tower.pack_f12(vals)
    assert packed.dtype == np.int32
    assert np.array_equal(packed, jtower.pack_f12(vals))
    assert [_f12_ints(v) for v in tower.unpack_f12(torch.from_numpy(packed))] == \
        [_f12_ints(v) for v in vals]
    t = torch.from_numpy(packed)
    a, b = t[..., 0, :, :, :], t[..., 1, :, :, :]  # two Fp6 rows
    k = t[:, 0, 1]                                  # an Fp2 per lane
    checks = {
        "f6_add": (tower.f6_add(a, b), jtower.f6_add(a.numpy(), b.numpy())),
        "f6_scale": (tower.f6_scale(a, k), jtower.f6_scale(a.numpy(), k.numpy())),
        "from_fp2": (tower.from_fp2(k), jtower.from_fp2(k.numpy())),
    }
    for name, (g, w) in checks.items():
        assert _bounded(g), name
        assert np.array_equal(_canon(g), _canon(w)), name
    y = torch.from_numpy(jtower.pack_f12([vals[0], vals[1], vals[0]]))
    assert tower.eq(t, y).tolist() == np.asarray(jtower.eq(packed, y.numpy())).tolist() \
        == [True, True, False]
    # a relaxed representative is still equal
    relaxed = fp.add(t, torch.from_numpy(np.zeros_like(packed)))
    assert tower.eq(relaxed, t).all()


def test_multi_pairing_value_matches_host():
    g1, g2 = g1_generator(), g2_generator()
    P1, aP = g1, g1.mul(0x5EED)
    Q, bQ = g2, g2.mul(0x0B0E)

    def aff(pack, pts):
        xy, inf = pack(pts)
        xy = torch.tensor(xy)
        return xy[:, 0], xy[:, 1], torch.tensor(inf)

    got = pairing.multi_pairing(aff(curve.pack_g1, [aP, P1]), aff(curve.pack_g2, [Q, bQ]))
    assert got.shape == (2, 3, 2, fp.NL)
    want = host_pairing.multi_pairing([(aP, Q), (P1, bQ)])
    assert [_f12_ints(v) for v in tower.unpack_f12(got)] == [_f12_ints(want)]


# ---------------------------------------------------------------------------
# Standalone SSWU map and G2 decompression
# ---------------------------------------------------------------------------

def test_map_to_curve_sswu_equals_jax():
    rng = np.random.default_rng(SEED + 5)
    u = _rand_fp2(rng, 3)
    u[0] = fp.LIMB_MAX
    x, y = htc.map_to_curve_sswu(torch.from_numpy(u))
    jx, jy = jax.jit(jhtc.map_to_curve_sswu)(u)
    assert np.array_equal(_canon(x), _canon(jx))
    assert np.array_equal(_canon(y), _canon(jy))


def test_decompress_g2_equals_jax():
    pts = [g2_generator().mul(k) for k in (3, 0x1234567)]
    xs, larger = [], []
    for p in pts:
        x0, x1, flag = bls.parse_compressed_g2_x(p.compress())
        xs.append(np.stack([fp.int_to_limbs(x0), fp.int_to_limbs(x1)]))
        larger.append(flag)
    # an x not on the curve: the first k with k^3 + 4(1+u) not a square
    k = next(k for k in range(1, 100)
             if (Fq2.from_ints(k, 0).pow(3) + Fq2.from_ints(4, 4)).sqrt() is None)
    xs.append(np.stack([fp.int_to_limbs(k), fp.int_to_limbs(0)]))
    larger.append(False)
    sig_x, sign = np.stack(xs), np.array(larger)
    y, ok = dbls.decompress_g2(torch.from_numpy(sig_x), torch.from_numpy(sign))
    jy, jok = jax.jit(jdbls.decompress_g2)(sig_x, sign)
    assert ok.tolist() == np.asarray(jok).tolist() == [True, True, False]
    assert np.array_equal(_canon(y)[:2], _canon(jy)[:2])
    assert [(fp.limbs_to_int(r[0]), fp.limbs_to_int(r[1])) for r in _canon(y)[:2]] == \
        [(p.y.c0.n, p.y.c1.n) for p in pts]


# ---------------------------------------------------------------------------
# The backend under the composed engines
# ---------------------------------------------------------------------------

M1, M2 = b"\x51" * 32, b"\x52" * 32


def _gossip_sets(poison: bool):
    """Four single-signer attestations over two messages (rung (4, 1, 2));
    poisoned, set 2 is signed by the wrong key."""
    sks = [jbls.SecretKey(61 + i) for i in range(4)]
    pks = [sk.public_key().point for sk in sks]
    msgs = [M1, M1, M2, M2]
    signers = [0, 1, 3 if poison else 2, 3]
    raws = [sks[s].sign(m).serialize() for s, m in zip(signers, msgs)]
    jsets = [(jbls.Signature.deserialize(r), [pks[i]], m)
             for i, (r, m) in enumerate(zip(raws, msgs))]
    ppks = [G1Point(Fq(p.x.n), Fq(p.y.n)) for p in pks]
    psets = [(bls.Signature.deserialize(r), [ppks[i]], m)
             for i, (r, m) in enumerate(zip(raws, msgs))]
    return jsets, psets


@pytest.mark.parametrize("poison", [False, True])
def test_backend_verdicts_under_composed_engines_match_cpu_native(poison):
    jsets, psets = _gossip_sets(poison)
    want = NativeBackend().verify_signature_sets(jsets)
    assert want is (not poison)
    backend = dbls.CudaBackend(device="cpu")
    with fp.impl("toeplitz_int32"), fp2.impl("composed"), pairing.line_impl("composed"):
        assert backend.verify_signature_sets(psets) is want
    assert backend.last_batch["path"] == "raw_staged"
    assert backend.last_batch["rung"] == (4, 1, 2)
