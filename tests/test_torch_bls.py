"""The port's BLS batch verification, the slice as a whole, against the
JAX package.

* The raw packer's planes must be BYTE-IDENTICAL to the JAX packer's on the
  same sets, with both fed the same seeded random words (the JAX
  ``_rand_scalar_words`` is monkeypatched in the test; nothing in the JAX
  package changes).
* ``CudaBackend(device="cpu").verify_signature_sets`` verdicts must equal
  the JAX package's ``cpu-native`` backend (the C verifier) on valid,
  wrong-signer, tampered, off-curve, non-subgroup, empty and infinity
  batches, at the shapes of ``test_device_e2e_gate.py`` (B=2, K=2, M=2).
* One ``slow`` test holds the port's stage 1/2/3 outputs (canonical)
  against the JAX stage functions under the kernel engines at B=2.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto.cpu.curve import G2Point as JG2Point
from lighthouse_tpu.crypto.cpu.fields import Fq2 as JFq2
from lighthouse_tpu.crypto.device import bls as jdbls
from lighthouse_tpu.crypto.native import NativeBackend
from lighthouse_tpu.crypto.params import B2, P, R
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.cpu.curve import G1Point
from lighthouse_tpu_torch.crypto.cpu.fields import Fq
from lighthouse_tpu_torch.crypto.device import bls as dbls
from lighthouse_tpu_torch.crypto.device import curve, fp2

SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs
    several worker processes side by side."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def seeded_words(seed):
    """A seeded stand-in for ``secrets``: nonzero 64-bit scalars as (hi, lo)
    words; the first one has its top bit set (a negative int32 hi word)."""
    rng = np.random.default_rng(seed)
    first = [True]

    def words():
        r = int(rng.integers(1, 2 ** 63, dtype=np.int64))
        if first[0]:
            r |= 1 << 63
            first[0] = False
        return (r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF

    return words


M1, M2, M3 = b"\x31" * 32, b"\x32" * 32, b"\x33" * 32


@pytest.fixture(scope="module")
def keys():
    sks = [jbls.SecretKey(77 + i) for i in range(2)]
    return sks, [sk.public_key().point for sk in sks]


def _sets(keys, signer0=0, msg1=M2, sig0=None):
    """(JAX sets, port sets) over the same bytes: set 0 one signer on M1,
    set 1 both signers (aggregate secret) on M2."""
    sks, pks = keys
    raw0 = sig0 if sig0 is not None else sks[signer0].sign(M1).serialize()
    raw1 = jbls.SecretKey((77 + 78) % R).sign(M2).serialize()
    jsets = [
        (jbls.Signature.deserialize(raw0), [pks[0]], M1),
        (jbls.Signature.deserialize(raw1), pks, msg1),
    ]
    ppks = [G1Point(Fq(p.x.n), Fq(p.y.n)) for p in pks]
    psets = [
        (bls.Signature.deserialize(raw0), [ppks[0]], M1),
        (bls.Signature.deserialize(raw1), ppks, msg1),
    ]
    return jsets, psets


def _verdicts(jsets, psets):
    native = NativeBackend().verify_signature_sets(jsets)
    port = dbls.CudaBackend(device="cpu", rand_words=seeded_words(SEED)).verify_signature_sets(psets)
    return native, port


def test_round_up_and_bits64_match_jax():
    for n in list(range(1, 300)) + [511, 512, 513, 1500, 5000]:
        assert dbls._round_up(n) == jdbls._round_up(n)
    words = np.array([[-2 ** 31, 5], [-1, -2], [0x7FFFFFFF, 0], [0x1234, -0x5678]],
                     np.int32)
    got = dbls._bits64(torch.tensor(words)).numpy()
    assert np.array_equal(got, np.asarray(jdbls._bits64(words)))
    assert got[0, 0] == 1 and got[0, 1:32].sum() == 0  # hi word >= 2**31


def test_packer_planes_byte_identical(keys, monkeypatch):
    jsets, psets = _sets(keys)
    jsets = jsets + [jsets[0]]
    psets = psets + [psets[0]]
    monkeypatch.setattr(jdbls, "_rand_scalar_words", seeded_words(SEED))
    want = jdbls.pack_signature_sets_raw(jsets, pad_b=4, pad_k=2, pad_m=4)
    got = dbls.pack_signature_sets_raw(
        psets, pad_b=4, pad_k=2, pad_m=4, rand_words=seeded_words(SEED), device="cpu"
    )
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    # a hi word >= 2**31 went through as a negative int32
    assert int(got[6][0, 0]) < 0
    # default ladder padding: 3 sets -> B=4, M=2 -> M rung 2
    auto = dbls.pack_signature_sets_raw(psets, rand_words=seeded_words(1), device="cpu")
    assert tuple(auto[0].shape[:2]) == (4, 2) and auto[4].shape[0] == 2


def test_verdicts_valid_and_wrong_signer(keys):
    assert _verdicts(*_sets(keys)) == (True, True)
    assert _verdicts(*_sets(keys, signer0=1)) == (False, False)


def test_verdicts_tampered_message(keys):
    assert _verdicts(*_sets(keys, msg1=M3)) == (False, False)


def test_verdicts_off_curve_x(keys):
    sks, _ = keys
    raw = bytearray(sks[0].sign(M1).serialize())
    raw[50] ^= 1
    with pytest.raises(ValueError):
        JG2Point.decompress(bytes(raw))  # x is not on the curve
    assert _verdicts(*_sets(keys, sig0=bytes(raw))) == (False, False)


def test_verdicts_non_subgroup_signature(keys):
    x0 = 5
    while True:
        x = JFq2.from_ints(x0, 1)
        y = (x.square() * x + JFq2.from_ints(*B2)).sqrt()
        if y is not None:
            break
        x0 += 1
    pt = JG2Point(x, y)
    assert not pt.in_subgroup()
    assert _verdicts(*_sets(keys, sig0=pt.compress())) == (False, False)
    # the device membership test itself: G2 point, E2 \ G2 point, infinity
    g2 = keys[0][0].sign(M1).point
    xy, inf = curve.pack_g2([g2, pt, JG2Point.infinity()])
    xy = torch.tensor(xy)
    proj = curve.from_affine(fp2, xy[:, 0], xy[:, 1], torch.tensor(inf))
    assert dbls.g2_in_subgroup(proj).tolist() == [True, False, True]


def test_verdicts_empty_and_infinity(keys):
    backend = dbls.CudaBackend(device="cpu", rand_words=seeded_words(SEED))
    assert backend.verify_signature_sets([]) is False
    assert NativeBackend().verify_signature_sets([]) is False
    jsets, psets = _sets(keys)
    jinf = [(jbls.Signature.infinity(), jsets[0][1], M1), jsets[1]]
    pinf = [(bls.Signature.infinity(), psets[0][1], M1), psets[1]]
    assert _verdicts(jinf, pinf) == (False, False)
    # a set without keys, and the public entry point on SignatureSets
    assert backend.verify_signature_sets([(psets[1][0], [], M2)]) is False
    assert bls.verify_signature_sets([], device="cpu") is False


@pytest.mark.slow
def test_stages_match_jax_kernel_engines(keys):
    """Stage 1/2/3 outputs against the JAX stage functions under
    ``pallas_int8`` / ``fused_pallas`` / fused lines (whole-stage XLA:CPU
    compiles: minutes)."""
    import jax

    from lighthouse_tpu.crypto.device import fp as jfp
    from lighthouse_tpu.crypto.device import fp2 as jfp2
    from lighthouse_tpu.crypto.device import pairing as jpairing
    from lighthouse_tpu_torch.crypto.device import fp

    jsets, psets = _sets(keys)
    args = dbls.pack_signature_sets_raw(
        psets, pad_b=2, pad_k=2, pad_m=2, rand_words=seeded_words(SEED), device="cpu"
    )
    nps = [a.numpy() for a in args]
    pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand, set_mask = nps

    def canon(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return a
        return fp.canonical(torch.tensor(a)).numpy()

    with jfp.impl(jfp.IMPL_PALLAS_INT8), jfp2.impl(jfp2.IMPL_FUSED_PALLAS), \
            jpairing.line_impl(jpairing.IMPL_LINE_FUSED):
        j1 = jax.jit(jdbls._stage1_fn)(sig_x, sig_larger, msg_u)
        p1 = dbls._stage1_fn(*args[2:5])
        for a, b in zip(p1, j1):
            assert np.array_equal(canon(a), canon(b))
        sig_xy = np.asarray(j1[0])
        j2 = jax.jit(jdbls._stage2_fn)(pk_xy, pk_mask, sig_xy, rand, set_mask)
        p2 = dbls._stage2_fn(args[0], args[1], p1[0], args[6], args[7])
        for a, b in zip(p2, j2):
            assert np.array_equal(canon(a), canon(b))
        idx = msg_idx
        s3 = (np.asarray(j2[0]), np.asarray(j2[1]), np.asarray(j2[2]),
              np.asarray(j1[1])[idx], np.asarray(j1[2])[idx], np.asarray(j1[3])[idx],
              np.asarray(j2[3]), np.asarray(j2[4]), np.asarray(j2[5]))
        j3 = jax.jit(jdbls._stage3_fn)(*s3)
        p3 = dbls._stage3_fn(*(torch.tensor(a) for a in s3))
        assert bool(p3) == bool(j3) is True
