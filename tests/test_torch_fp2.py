"""The port's Fp2 (kernels K2, K3) and Fp6/Fp12 tower against the JAX
package and its host oracle.

The JAX side runs the fused Pallas Fp2 kernels (``fp2.impl("fused_pallas")``,
interpret mode off-TPU, as ``test_zgate1_fp2_fused_matrix.py`` does); the
port runs on the CPU through the kernels' plain versions. Tolerance:
canonical equality, and every port limb in [0, LIMB_MAX]. The tower is
held against the JAX package's host ``Fq12`` oracle (a JAX compile of the
tower is minutes on the CPU).
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.cpu.fields import Fq2, Fq6, Fq12
from lighthouse_tpu.crypto.device import fp as jfp
from lighthouse_tpu.crypto.device import fp2 as jfp2
from lighthouse_tpu.crypto.device import pallas_fp2
from lighthouse_tpu.crypto.params import P
from lighthouse_tpu_torch.crypto.device import fp, fp2, kernels, tower

SEED = 1017


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs
    several worker processes side by side."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
# the edge set of tests/test_device_fp2.py
EDGES = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1), (1, P - 1), (P - 2, 3)]


def _rand_ints(rng, n):
    return [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n)]


def _pack(pairs):
    return np.stack(
        [np.stack([fp.int_to_limbs(a), fp.int_to_limbs(b)]) for a, b in pairs]
    )


def _val(arr):
    arr = np.asarray(arr)
    return [
        (fp.limbs_to_int(e[0]) % P, fp.limbs_to_int(e[1]) % P)
        for e in arr.reshape(-1, 2, fp.NL)
    ]


def _bounded(t):
    return int(t.min()) >= 0 and int(t.max()) <= fp.LIMB_MAX


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(SEED)
    r = _rand_ints(rng, 24)
    xs = list(zip(r[:6], r[6:12])) + EDGES
    ys = EDGES + list(zip(r[12:18], r[18:24]))
    x, y = _pack(xs), _pack(ys)
    # the relaxed worst case: every limb at LIMB_MAX
    full = np.full((1, 2, fp.NL), fp.LIMB_MAX, np.int32)
    return np.concatenate([x, full]), np.concatenate([y, full])


def test_k2_k3_plain_match_pallas(operands):
    x, y = operands
    tx, ty = torch.tensor(x), torch.tensor(y)
    got_mul = kernels.fp2_mul(tx, ty)
    got_sq = kernels.fp2_sq(tx)
    assert _bounded(got_mul) and _bounded(got_sq)
    assert _val(got_mul) == _val(pallas_fp2.mul2(x, y))
    assert _val(got_sq) == _val(pallas_fp2.sq2(x))
    ox = [Fq2.from_ints(*v) for v in _val(x)]
    oy = [Fq2.from_ints(*v) for v in _val(y)]
    assert _val(got_mul) == [((a * b).c0.n, (a * b).c1.n) for a, b in zip(ox, oy)]
    assert _val(got_sq) == [(a.square().c0.n, a.square().c1.n) for a in ox]


def test_fp2_ops_match_jax(operands):
    x, y = operands
    tx, ty = torch.tensor(x), torch.tensor(y)
    with jfp.impl(jfp.IMPL_PALLAS_INT8), jfp2.impl(jfp2.IMPL_FUSED_PALLAS):
        cases = {
            "mul_pairs": (fp2.mul_pairs([(tx, ty), (ty, ty)])[1], jfp2.mul(y, y)),
            "sq_batch": (fp2.sq_batch([ty, tx])[1], jfp2.sq(x)),
            "inv": (fp2.inv(tx[:4]), jfp2.inv(x[:4])),
            "conjugate": (fp2.conjugate(tx), jfp2.conjugate(x)),
            "mul_by_u_plus_1": (fp2.mul_by_u_plus_1(tx), jfp2.mul_by_u_plus_1(x)),
            "scale": (fp2.scale(tx, ty[:, 0]), jfp2.scale(x, y[:, 0])),
            "pow_const": (fp2.pow_const(tx[:4], 11), jfp2.pow_const(x[:4], 11)),
        }
        for name, (got, want) in cases.items():
            assert _bounded(got), name
            assert _val(got) == _val(want), name
    assert np.array_equal(fp2.canonical(tx).numpy(), np.asarray(jfp2.canonical(x)))
    assert fp2.eq(tx, tx + torch.tensor(_pack([(P, P)]))).all()
    assert fp2.is_zero(torch.tensor(_pack([(0, 0), (P, 0)]))).all()


def _f12(rng):
    ints = _rand_ints(rng, 12)
    it = iter(ints)
    return Fq12(*[Fq6(*[Fq2.from_ints(next(it), next(it)) for _ in range(3)])
                  for _ in range(2)])


def _pack_f12(vals):
    return torch.tensor(np.stack([
        np.stack([
            np.stack([np.stack([fp.int_to_limbs(c.c0.n), fp.int_to_limbs(c.c1.n)])
                      for c in (h.c0, h.c1, h.c2)])
            for h in (v.c0, v.c1)
        ])
        for v in vals
    ]))


def _unpack_f12(t):
    a = fp.canonical(t).numpy().reshape(-1, 2, 3, 2, fp.NL)
    out = []
    for v in a:
        halves = [Fq6(*[Fq2.from_ints(fp.limbs_to_int(c[0]), fp.limbs_to_int(c[1]))
                        for c in h]) for h in v]
        out.append(Fq12(*halves))
    return out


def test_tower_matches_host_fq12():
    rng = np.random.default_rng(SEED + 1)
    a = [_f12(rng) for _ in range(2)]
    b = [_f12(rng) for _ in range(2)]
    ta, tb = _pack_f12(a), _pack_f12(b)
    assert _unpack_f12(tower.mul(ta, tb)) == [u * v for u, v in zip(a, b)]
    sq = tower.sq(ta)
    assert _bounded(sq)
    assert _unpack_f12(sq) == [u * u for u in a]
    assert _unpack_f12(tower.frobenius(ta)) == [u.frobenius() for u in a]
    assert _unpack_f12(tower.conjugate(ta)) == [u.conjugate() for u in a]
    assert _unpack_f12(tower.inv(ta)) == [u.inverse() for u in a]
    one = tower.mul(ta, tower.inv(ta))
    assert bool(tower.is_one(one).all()) and not bool(tower.is_one(ta).any())
    assert _unpack_f12(tower.pow_const(ta, 5)) == [u.pow(5) for u in a]
