"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a card: the
kernels are CUDA C++ with no CPU mode. This file imports neither JAX nor
the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 raw columns and reduced limbs equal to the plain versions
(exact integers, same reduction plan); K2/K3 canonical-equal with limbs
in [0, 8191]; verdicts as expected. Lane counts 1 to 3474 cover one lane,
ragged blocks and the largest K2 launch of the verify path; K3 is also
held limb for limb at every lane count the verify path launches it with.
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


# 1 lane, ragged blocks of K1's four lanes, and the block batch's
# largest K2 launch
LANES = (1, 3, 5, 1170, 3474)
# K3's lane counts on the verify path: gossip 96 and 195, block 960 and 579
K3_PATH_LANES = (96, 195, 579, 960)


def _limbs(rng, *shape):
    """Random relaxed limbs with the all-8191 worst case and zeros."""
    a = rng.integers(0, fp.LIMB_MAX + 1, size=(*shape, fp.NL), dtype=np.int32)
    a[0] = fp.LIMB_MAX
    a[1:2] = 0
    return a


def _canonical_equal(got, want):
    assert int(got.min()) >= 0 and int(got.max()) <= fp.LIMB_MAX
    assert torch.equal(fp.canonical(got), fp.canonical(want))


@pytest.mark.parametrize("lanes", LANES)
def test_k1_matches_plain(dev, lanes):
    rng = np.random.default_rng(11 + lanes)
    x, y = (torch.from_numpy(_limbs(rng, lanes)).to(dev) for _ in range(2))
    assert torch.equal(kernels.fp_mul_cols(x, y), kernels.fp_mul_cols_plain(x, y))
    got = kernels.fp_mul(x, y)
    assert torch.equal(got, kernels.fp_mul_plain(x, y))
    assert int(got.min()) >= 0 and int(got.max()) <= fp.LIMB_MAX
    # broadcasting and an empty batch
    assert torch.equal(kernels.fp_mul(x, y[:1]), kernels.fp_mul_plain(x, y[:1]))
    assert torch.equal(kernels.fp_mul_cols(x[:1], y), kernels.fp_mul_cols_plain(x[:1], y))
    assert kernels.fp_mul(x[:0], y[:0]).shape == (0, fp.NL)


@pytest.mark.parametrize("lanes", LANES)
def test_k2_k3_match_plain(dev, lanes):
    rng = np.random.default_rng(12 + lanes)
    a, b = (torch.from_numpy(_limbs(rng, lanes, 2)).to(dev) for _ in range(2))
    _canonical_equal(kernels.fp2_mul(a, b), kernels.fp2_mul_plain(a, b))
    _canonical_equal(kernels.fp2_sq(a), kernels.fp2_sq_plain(a))
    # broadcasting and empty batches
    _canonical_equal(kernels.fp2_mul(a, b[:1]), kernels.fp2_mul_plain(a, b[:1]))
    assert kernels.fp2_mul(a[:0], b[:0]).shape == (0, 2, fp.NL)
    assert kernels.fp2_sq(a[:0]).shape == (0, 2, fp.NL)


@pytest.mark.parametrize("lanes", K3_PATH_LANES)
def test_k3_matches_plain_at_path_lanes(dev, lanes):
    rng = np.random.default_rng(13 + lanes)
    a = torch.from_numpy(_limbs(rng, lanes, 2)).to(dev)
    assert torch.equal(kernels.fp2_sq(a), kernels.fp2_sq_plain(a))


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
    for name, n in kernels.launches.items():
        hist = kernels.lane_hist[name]
        assert sum(hist.values()) == n
        assert sum(k * v for k, v in hist.items()) == kernels.lanes[name] >= n
    bad = [sets[0], (sets[1][0], sets[1][1], m1)]
    assert backend.verify_signature_sets(bad) is False


def test_key_table_grown_on_card_gathers_as_on_cpu(dev):
    """A table synced on the card and grown across one capacity rung (1024
    -> 4096 rows, copied on the device) gathers the same rows, aggregate
    region included, as the same table on the CPU: torch.equal."""
    import types

    from lighthouse_tpu_torch.crypto.cpu.curve import g1_generator
    from lighthouse_tpu_torch.crypto.device.bls import _gather_fn
    from lighthouse_tpu_torch.crypto.device.key_table import DeviceKeyTable

    g = g1_generator()
    pts, p = [], g
    for _ in range(1100):
        pts.append(types.SimpleNamespace(point=p))
        p = p + g
    caches = [types.SimpleNamespace(pubkeys=pts[:1000]) for _ in range(2)]
    tables = [DeviceKeyTable(c, agg_min_repeats=1, upload_chunk_rows=300, device=d)
              for c, d in zip(caches, (dev, "cpu"))]
    committee = (None, [pts[i].point for i in (3, 4, 5)], b"\x00" * 32)
    for t, c in zip(tables, caches):
        t.sync(reason="startup")
        assert t.resolve_sets([committee])[3] == 1
        c.pubkeys.extend(pts[1000:])
        assert t.sync() == 100
        assert t.status()["validator_capacity"] == 4096
    (gdev, gagg), (cdev, cagg) = (t.device_arrays() for t in tables)
    assert gdev.device.type == "cuda" and gagg.device.type == "cuda"
    idx = torch.tensor([[0, 999, 1000, 1099], [4096, 4097, 5, 9999]], dtype=torch.int32)
    got = _gather_fn(gdev, gagg, idx.to(dev))
    assert torch.equal(got.cpu(), _gather_fn(cdev, cagg, idx))
    assert torch.equal(gdev.cpu(), cdev)
