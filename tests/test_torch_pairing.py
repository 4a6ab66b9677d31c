"""The port's pairing against the JAX package's host pairing oracle
(``lighthouse_tpu/crypto/cpu/pairing.py``).

The port runs on the CPU. Tolerances: the pairing VALUE (after the final
exponentiation) must equal the oracle's Fq12, canonically; the
``*_is_one`` decisions must equal the oracle's verdicts, including the
bilinearity identity e(aP, Q) * e(-P, aQ) = 1 and infinity lanes.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.cpu import pairing as host_pairing
from lighthouse_tpu.crypto.cpu.curve import G1Point, G2Point, g1_generator, g2_generator
from lighthouse_tpu.crypto.cpu.fields import Fq2, Fq6, Fq12
from lighthouse_tpu_torch.crypto.device import curve, fp, pairing, tower

A, B = 0x5EED, 0x0B0E


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs
    several worker processes side by side."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _aff(pack, pts):
    xy, inf = pack(pts)
    xy = torch.tensor(xy)
    return xy[:, 0], xy[:, 1], torch.tensor(inf)


def _unpack_f12(t):
    a = tower.canonical(t).numpy().reshape(-1, 2, 3, 2, fp.NL)
    return [
        Fq12(*[Fq6(*[Fq2.from_ints(fp.limbs_to_int(c[0]), fp.limbs_to_int(c[1]))
                     for c in h]) for h in v])
        for v in a
    ]


@pytest.fixture(scope="module")
def pts():
    g1, g2 = g1_generator(), g2_generator()
    return g1.mul(A), g1, g2, g2.mul(A), g2.mul(B)


def test_pairing_value_matches_host(pts):
    aP, P1, Q, _, _ = pts
    got = pairing.pairing(_aff(curve.pack_g1, [aP]), _aff(curve.pack_g2, [Q]))
    assert _unpack_f12(got) == [host_pairing.pairing(aP, Q)]


def test_multi_pairing_is_one_bilinearity(pts):
    aP, P1, Q, aQ, bQ = pts
    negP = -P1
    g1 = _aff(curve.pack_g1, [aP, negP, aP, negP, G1Point.infinity(), aP])
    g2 = _aff(curve.pack_g2, [Q, aQ, Q, bQ, Q, G2Point.infinity()])

    def lanes(idx):
        return tuple(c[idx] for c in g1), tuple(c[idx] for c in g2)

    # e(aP, Q) e(-P, aQ) = 1, with two infinity lanes (each one) alongside
    ok = pairing.multi_pairing_is_one(*lanes([0, 1, 4, 5]))
    bad = pairing.multi_pairing_is_one(*lanes([2, 3]))
    assert bool(ok) is True and bool(bad) is False
    host_bad = host_pairing.multi_pairing([(aP, Q), (negP, bQ)])
    assert (host_bad == Fq12.one()) is False


def test_final_exp_is_one_matches_host(pts):
    aP, P1, Q, aQ, _ = pts
    f = pairing.miller_loop(_aff(curve.pack_g1, [aP, -P1]), _aff(curve.pack_g2, [Q, aQ]))
    prod = tower.mul(f[0], f[1])
    assert bool(pairing.final_exp_is_one(prod)) is True
    assert bool(pairing.final_exp_is_one(f[0])) is False
    # the value route agrees: FE(prod) == 1, FE(f0) == e(aP, Q)
    both = pairing.final_exponentiation(torch.stack([prod, f[0]]))
    assert _unpack_f12(both) == [Fq12.one(), host_pairing.pairing(aP, Q)]
