"""The port's curve arithmetic and hash-to-G2 against the JAX package.

Points come from the JAX package's host oracle (``crypto/cpu``) and go to
both packages as numpy limb arrays. The port runs on the CPU. Tolerances:
packed limb planes and hash_to_field outputs must be byte-identical;
affine results canonical-equal to the oracle; square roots canonical-equal
to JAX ``htc.sqrt`` run under its Pallas kernel engines.
"""

import jax
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.cpu import curve as jcurve_host
from lighthouse_tpu.crypto.cpu.fields import Fq2
from lighthouse_tpu.crypto.cpu.hash_to_curve import hash_to_g2
from lighthouse_tpu.crypto.device import curve as jcurve
from lighthouse_tpu.crypto.device import fp as jfp
from lighthouse_tpu.crypto.device import fp2 as jfp2
from lighthouse_tpu.crypto.device import htc as jhtc
from lighthouse_tpu.crypto.params import DST, P
from lighthouse_tpu_torch.crypto.device import curve, fp, fp2, htc

SEED = 4242


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs
    several worker processes side by side."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scalars(rng, n, bits=48):
    return [int.from_bytes(rng.bytes(bits // 8), "big") | 1 for _ in range(n)]


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(SEED)
    g1, g2 = jcurve_host.g1_generator(), jcurve_host.g2_generator()
    a, b = _scalars(rng, 3), _scalars(rng, 3)
    return (
        [g1.mul(k) for k in a], [g1.mul(k) for k in b],
        [g2.mul(k) for k in a], [g2.mul(k) for k in b],
    )


def _proj(F, pack, pts):
    xy, inf = pack(pts)
    xy = torch.tensor(xy)
    return curve.from_affine(F, xy[:, 0], xy[:, 1], torch.tensor(inf))


def _affine_ints(F, pt):
    x, y, inf = curve.to_affine(F, pt)
    x, y = x.numpy(), y.numpy()
    out = []
    for i in range(x.shape[0]):
        if bool(inf[i]):
            out.append(None)
        elif F is fp:
            out.append((fp.limbs_to_int(x[i]), fp.limbs_to_int(y[i])))
        else:
            out.append(tuple(fp.limbs_to_int(c[j]) for c in (x[i], y[i]) for j in (0, 1)))
    return out


def _host(pts):
    out = []
    for p in pts:
        if p.is_infinity():
            out.append(None)
        elif hasattr(p.x, "n"):
            out.append((p.x.n, p.y.n))
        else:
            out.append((p.x.c0.n, p.x.c1.n, p.y.c0.n, p.y.c1.n))
    return out


def test_pack_g1_g2_byte_identical(points):
    a1, _, a2, _ = points
    g1s = a1 + [jcurve_host.G1Point.infinity()]
    g2s = a2 + [jcurve_host.G2Point.infinity()]
    for mine, theirs, pts in ((curve.pack_g1, jcurve.pack_g1, g1s),
                              (curve.pack_g2, jcurve.pack_g2, g2s)):
        (xy, inf), (jxy, jinf) = mine(pts), theirs(pts)
        assert xy.dtype == jxy.dtype and xy.tobytes() == jxy.tobytes()
        assert np.array_equal(inf, jinf)
    assert curve.pack_g1([])[0].shape == jcurve.pack_g1([])[0].shape


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_group_law_matches_host(points, group):
    a1, b1, a2, b2 = points
    F, pack, a, b = (fp, curve.pack_g1, a1, b1) if group == "g1" else (
        fp2, curve.pack_g2, a2, b2)
    pa, pb = _proj(F, pack, a), _proj(F, pack, b)
    assert _affine_ints(F, curve.add(F, pa, pb)) == _host([u + v for u, v in zip(a, b)])
    assert _affine_ints(F, curve.dbl(F, pa)) == _host([u.double() for u in a])
    # P + (-P) = infinity, infinity + P = P (complete formulas)
    assert _affine_ints(F, curve.add(F, pa, curve.neg(F, pa))) == [None] * 3
    inf = curve.infinity(F, (3,), "cpu")
    assert _affine_ints(F, curve.add(F, inf, pb)) == _host(b)
    k = 0x1D2F
    assert _affine_ints(F, curve.scalar_mul_const(F, pa, k)) == _host([u.mul(k) for u in a])
    bits_int = [5, 0, 0xB3]
    bits = torch.tensor([[(v >> (7 - i)) & 1 for i in range(8)] for v in bits_int],
                        dtype=torch.int32)
    got = _affine_ints(F, curve.scalar_mul_bits(F, pa, bits))
    assert got == _host([u.mul(v) for u, v in zip(a, bits_int)])
    assert bool(curve.eq(F, pa, pa).all()) and not bool(curve.eq(F, pa, pb).any())
    # masked sum over a K axis: lane 1 masked out
    xy, _ = pack(a)
    stacked = torch.tensor(xy)[None].expand(2, -1, *xy.shape[1:])
    mask = torch.tensor([[False, True, False], [False, False, False]])
    pts = curve.from_affine(F, stacked[:, :, 0], stacked[:, :, 1], mask)
    total = curve.sum_points(F, pts, axis=1)
    want = a[0] + a[2]
    assert _affine_ints(F, total) == _host([want, want + a[1]])


def test_messages_to_u_byte_identical():
    msgs = [b"", b"\x31" * 32, bytes(range(32))]
    mine, theirs = htc.messages_to_u(msgs, DST), jhtc.messages_to_u(msgs, DST)
    assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes()


def test_sqrt_matches_jax():
    rng = np.random.default_rng(SEED + 1)
    vals = [(int.from_bytes(rng.bytes(48), "big") % P,
             int.from_bytes(rng.bytes(48), "big") % P) for _ in range(5)]
    squares = [(Fq2.from_ints(*v).square().c0.n, Fq2.from_ints(*v).square().c1.n)
               for v in vals[:3]]
    xs = vals[3:] + squares + [(0, 0), (P - 1, 0)]
    x = np.stack([np.stack([fp.int_to_limbs(a), fp.int_to_limbs(b)]) for a, b in xs])
    root, ok = htc.sqrt(torch.tensor(x))
    with jfp.impl(jfp.IMPL_PALLAS_INT8), jfp2.impl(jfp2.IMPL_FUSED_PALLAS):
        jroot, jok = jax.jit(jhtc.sqrt)(x)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    okm = ok.numpy()
    assert np.array_equal(fp2.canonical(root).numpy()[okm],
                          np.asarray(jfp2.canonical(jroot))[okm])
    assert okm[2:].all()  # the squares, zero and -1 (a square in Fp2)
    for i in np.nonzero(okm)[0]:
        r = fp2.canonical(root[i]).numpy()
        rq = Fq2.from_ints(fp.limbs_to_int(r[0]), fp.limbs_to_int(r[1]))
        assert rq.square() == Fq2.from_ints(*xs[i])


def test_map_to_g2_matches_host_hash_to_g2():
    msgs = [b"\x31" * 32, b"abc"]
    u = torch.tensor(htc.messages_to_u(msgs, DST))
    got = _affine_ints(fp2, htc.map_to_g2(u))
    assert got == _host([hash_to_g2(m, DST) for m in msgs])
