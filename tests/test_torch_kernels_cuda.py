"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a card: the
kernels are CUDA C++ with no CPU mode. This file imports neither JAX nor
the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 raw columns and reduced limbs equal to the plain versions
(exact integers, same reduction plan); K2/K3 canonical-equal with limbs
in [0, 8191]; verdicts as expected.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.device import fp, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA with no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _limbs(rng, *shape):
    """Random relaxed limbs with the all-8191 worst case and zeros."""
    a = rng.integers(0, fp.LIMB_MAX + 1, size=(*shape, fp.NL), dtype=np.int32)
    a[0] = fp.LIMB_MAX
    a[1] = 0
    return a


def test_k1_matches_plain(dev):
    rng = np.random.default_rng(11)
    x, y = (torch.from_numpy(_limbs(rng, 13)).to(dev) for _ in range(2))
    assert torch.equal(kernels.fp_mul_cols(x, y), kernels.fp_mul_cols_plain(x, y))
    got = kernels.fp_mul(x, y)
    assert torch.equal(got, kernels.fp_mul_plain(x, y))
    assert int(got.min()) >= 0 and int(got.max()) <= fp.LIMB_MAX
    # broadcasting and an empty batch
    assert torch.equal(kernels.fp_mul(x, y[:1]), kernels.fp_mul_plain(x, y[:1]))
    assert kernels.fp_mul(x[:0], y[:0]).shape == (0, fp.NL)


def test_k2_k3_match_plain(dev):
    rng = np.random.default_rng(12)
    a, b = (torch.from_numpy(_limbs(rng, 37, 2)).to(dev) for _ in range(2))
    for got, want in ((kernels.fp2_mul(a, b), kernels.fp2_mul_plain(a, b)),
                      (kernels.fp2_sq(a), kernels.fp2_sq_plain(a))):
        assert int(got.min()) >= 0 and int(got.max()) <= fp.LIMB_MAX
        assert torch.equal(fp.canonical(got), fp.canonical(want))


def test_kernels_reject_bad_operands(dev):
    x = torch.zeros((4, fp.NL), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        kernels.fp_mul(x, x)
    with pytest.raises(ValueError):
        kernels.fp2_sq(torch.zeros((4, 3, fp.NL), dtype=torch.int32, device=dev))


def test_verify_on_card_counts_launches(dev):
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.device.bls import CudaBackend

    sks = [bls.SecretKey(77 + i) for i in range(2)]
    pks = [sk.public_key().point for sk in sks]
    m1, m2 = b"\x31" * 32, b"\x32" * 32
    agg = bls.SecretKey(77 + 78).sign(m2)
    sets = [(sks[0].sign(m1), [pks[0]], m1), (agg, pks, m2)]
    sets = [(bls.Signature.deserialize(s.serialize()), k, m) for s, k, m in sets]
    backend = CudaBackend(device=dev)
    kernels.reset_launches()
    assert backend.verify_signature_sets(sets) is True
    assert all(n > 0 for n in kernels.launches.values()), kernels.launches
    bad = [sets[0], (sets[1][0], sets[1][1], m1)]
    assert backend.verify_signature_sets(bad) is False
