"""The rest of the port's BLS API against the JAX package and ``cpu-native``
(the C verifier):

* bare-point sets (``(G2Point, [G1Point], msg)``, as the JAX backend's
  oracle callers pass them) take the hashed path and give ``cpu-native``'s
  verdict. Before the port had that path, ``CudaBackend`` raised
  ``AttributeError: 'G2Point' object has no attribute 'serialize'`` on them;
* ``pack_signature_sets`` and ``pack_signature_sets_hashed`` are
  byte-identical to the JAX packers for the same random words;
* ``Signature.verify``, ``AggregateSignature`` (``add_assign``,
  ``fast_aggregate_verify``, ``aggregate_verify``) and ``SignatureSet``
  (``single_pubkey``, ``multiple_pubkeys``, ``verify``) give ``cpu-native``'s
  verdicts, at the reference's edges too: empty keys, a length mismatch,
  an infinity pubkey and an infinity signature.

Every tolerance is exact: byte-equal planes and equal verdicts. The one
test that compiles a whole JAX program is ``slow``.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto.cpu.curve import G1Point as JG1Point
from lighthouse_tpu.crypto.cpu.curve import G2Point as JG2Point
from lighthouse_tpu.crypto.cpu.curve import g1_generator as jg1
from lighthouse_tpu.crypto.cpu.curve import g2_generator as jg2
from lighthouse_tpu.crypto.device import bls as jdbls
from lighthouse_tpu.crypto.native import NativeBackend
from lighthouse_tpu.crypto.params import R
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.cpu.curve import G1Point, G2Point, g1_generator, g2_generator
from lighthouse_tpu_torch.crypto.cpu.fields import Fq, Fq2
from lighthouse_tpu_torch.crypto.device import bls as dbls

from test_torch_bls import seeded_words

SEED = 5
M1, M2 = b"\x41" * 32, b"\x42" * 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _g1(p) -> G1Point:
    return G1Point.infinity() if p.is_infinity() else G1Point(Fq(p.x.n), Fq(p.y.n))


def _g2(p) -> G2Point:
    if p.is_infinity():
        return G2Point.infinity()
    return G2Point(Fq2.from_ints(p.x.c0.n, p.x.c1.n), Fq2.from_ints(p.y.c0.n, p.y.c1.n))


@pytest.fixture(scope="module")
def keys():
    """Two keys: (JAX secret keys, JAX points, port PublicKeys)."""
    sks = [jbls.SecretKey(91 + i) for i in range(2)]
    jpks = [sk.public_key().point for sk in sks]
    return sks, jpks, [bls.PublicKey(_g1(p)) for p in jpks]


def _bare_sets(keys, signer0=0):
    """(JAX sets, port sets) of bare points: set 0 by one signer on M1,
    set 1 by both (the aggregate secret) on M2."""
    sks, jpks, ppks = keys
    s0 = sks[signer0].sign(M1).point
    s1 = jbls.SecretKey((sks[0].k + sks[1].k) % R).sign(M2).point
    jsets = [(s0, [jpks[0]], M1), (s1, jpks, M2)]
    psets = [(_g2(s0), [ppks[0].point], M1), (_g2(s1), [p.point for p in ppks], M2)]
    return jsets, psets


def test_bare_point_sets_give_cpu_natives_verdict(keys):
    backend = dbls.CudaBackend(device="cpu", rand_words=seeded_words(SEED))
    jsets, psets = _bare_sets(keys)
    assert NativeBackend().verify_signature_sets(jsets) is True
    assert backend.verify_signature_sets(psets) is True
    assert backend.last_batch["path"] == "hashed"
    # the batch that raised AttributeError before the hashed path existed
    jbad = [(jg2(), [jg1()], bytes(32))]
    pbad = [(g2_generator(), [g1_generator()], bytes(32))]
    assert NativeBackend().verify_signature_sets(jbad) is False
    assert backend.verify_signature_sets(pbad) is False


def test_packers_byte_identical_to_jax(keys, monkeypatch):
    jsets, psets = _bare_sets(keys)
    jsets, psets = jsets + [jsets[0]], psets + [psets[0]]
    monkeypatch.setattr(jdbls, "_rand_scalar_words", seeded_words(SEED))
    want = jdbls.pack_signature_sets_hashed(jsets, pad_b=4, pad_k=2, pad_m=4)
    got = dbls.pack_signature_sets_hashed(
        psets, pad_b=4, pad_k=2, pad_m=4, rand_words=seeded_words(SEED), device="cpu")
    monkeypatch.setattr(jdbls, "_rand_scalar_words", seeded_words(SEED + 1))
    want2 = jdbls.pack_signature_sets(jsets, pad_b=4, pad_k=2)
    got2 = dbls.pack_signature_sets(
        psets, pad_b=4, pad_k=2, rand_words=seeded_words(SEED + 1), device="cpu")
    assert len(got) == len(want) == 7 and len(got2) == len(want2) == 6
    for g, w in zip(got + got2, want + want2):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.numpy().shape == w.shape
        assert g.numpy().tobytes() == w.tobytes()
    # default ladder padding: 3 sets -> B = 4, K = 2, M = 2
    auto = dbls.pack_signature_sets_hashed(psets, rand_words=seeded_words(1), device="cpu")
    assert tuple(auto[0].shape[:2]) == (4, 2) and auto[3].shape[0] == 2


def test_signature_verify_wrong_message(keys):
    sks, jpks, ppks = keys
    raw = sks[0].sign(M1).serialize()
    sig = bls.Signature.deserialize(raw)
    native = NativeBackend().verify(jpks[0], M2, jbls.Signature.deserialize(raw).point)
    assert native is False
    assert sig.verify(ppks[0], M2, device="cpu") is False


def test_aggregate_signature_set_verifies(keys):
    """add_assign folds two signatures over one message; SignatureSet.verify
    runs fast_aggregate_verify over both keys."""
    sks, jpks, ppks = keys
    agg = bls.AggregateSignature.infinity()
    jagg = jbls.AggregateSignature.infinity()
    for sk in sks:
        raw = sk.sign(M1).serialize()
        agg.add_assign(bls.Signature.deserialize(raw))
        jagg.add_assign(jbls.Signature.deserialize(raw))
    agg.add_assign(bls.Signature.infinity())  # a no-op
    assert agg.serialize() == jagg.serialize()
    assert NativeBackend().fast_aggregate_verify(jpks, M1, jagg.point) is True
    s = bls.SignatureSet.multiple_pubkeys(agg, ppks, M1, signing_indices=[0, 1])
    assert s.verify(device="cpu") is True


@pytest.mark.parametrize("messages,want", [((M1, M2), True), ((M2, M1), False)])
def test_aggregate_verify_distinct_messages(keys, messages, want):
    sks, jpks, ppks = keys
    jagg = jbls.AggregateSignature.infinity()
    for sk, m in zip(sks, (M1, M2)):
        jagg.add_assign(jbls.Signature.deserialize(sk.sign(m).serialize()))
    agg = bls.AggregateSignature.deserialize(jagg.serialize())
    assert NativeBackend().aggregate_verify(jpks, list(messages), jagg.point) is want
    assert agg.aggregate_verify(list(messages), ppks, device="cpu") is want


def test_edges_are_false_without_the_device(keys):
    """The reference's edges, each False on both sides: empty keys, a
    length mismatch, an infinity pubkey and an infinity signature."""
    sks, jpks, ppks = keys
    native = NativeBackend()
    raw = sks[0].sign(M1).serialize()
    jsig, sig = jbls.Signature.deserialize(raw), bls.Signature.deserialize(raw)
    agg = bls.AggregateSignature.deserialize(raw)
    pinf, jpinf = bls.PublicKey(G1Point.infinity()), JG1Point.infinity()
    cases = [
        # (port verdict, cpu-native verdict)
        (agg.fast_aggregate_verify(M1, [], device="cpu"),
         native.fast_aggregate_verify([], M1, jsig.point)),
        (bls.SignatureSet(sig, [], M1).verify(device="cpu"),
         native.verify_signature_sets([(jsig, [], M1)])),
        (agg.aggregate_verify([M1, M2], ppks[:1], device="cpu"),
         native.aggregate_verify(jpks[:1], [M1, M2], jsig.point)),
        (agg.aggregate_verify([], [], device="cpu"), native.aggregate_verify([], [], jsig.point)),
        (sig.verify(pinf, M1, device="cpu"), native.verify(jpinf, M1, jsig.point)),
        (agg.aggregate_verify([M1], [pinf], device="cpu"),
         native.aggregate_verify([jpinf], [M1], jsig.point)),
        (bls.Signature.infinity().verify(ppks[0], M1, device="cpu"),
         native.verify(jpks[0], M1, JG2Point.infinity())),
        (bls.AggregateSignature.infinity().fast_aggregate_verify(M1, ppks, device="cpu"),
         native.fast_aggregate_verify(jpks, M1, JG2Point.infinity())),
        (bls.AggregateSignature.infinity().aggregate_verify([M1, M2], ppks, device="cpu"),
         native.aggregate_verify(jpks, [M1, M2], JG2Point.infinity())),
        (dbls.CudaBackend(device="cpu").verify_signature_sets(
            [(G2Point.infinity(), [ppks[0].point], M1)]),
         native.verify_signature_sets([(JG2Point.infinity(), [jpks[0]], M1)])),
    ]
    assert [p for p, _ in cases] == [n for _, n in cases] == [False] * len(cases)
    assert bls.Signature.infinity().point_or_infinity().is_infinity()
    assert sig.point_or_infinity() == _g2(jsig.point)
    with pytest.raises(bls.BlsError):
        bls.SignatureSet.single_pubkey(sig, ppks[0], M1[:31])


@pytest.mark.slow
def test_hashed_and_aggregate_programs_match_jax(keys):
    """The hashed program's and ``_aggregate_verify_device``'s verdicts
    against the JAX programs on the same planes (whole-program XLA:CPU
    compiles: minutes)."""
    jsets, psets = _bare_sets(keys)
    args = dbls.pack_signature_sets_hashed(psets, rand_words=seeded_words(SEED), device="cpu")
    want = jdbls.verify_batch_hashed(*(a.numpy() for a in args))
    assert bool(dbls.verify_batch_hashed_fn(*args)) is bool(want) is True
    sks, jpks, ppks = keys
    backend = dbls.CudaBackend(device="cpu")
    jagg = jbls.AggregateSignature.infinity()
    for sk, m in zip(sks, (M1, M2)):
        jagg.add_assign(jbls.Signature.deserialize(sk.sign(m).serialize()))
    assert backend.aggregate_verify([p.point for p in ppks], [M1, M2], _g2(jagg.point)) is True
    assert jdbls.TpuBackend().aggregate_verify(jpks, [M1, M2], jagg.point) is True
