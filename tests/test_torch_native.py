"""The port's C verifier (``cpu-native``) and the compile service's shed
fallback against the JAX package's, on the same seeded bytes.

Sets are made with the C signer from seeded secrets and messages and
deserialized into each package's own objects. Cases: valid batches
(single and multi-signer), a signature over the wrong message, a
signature whose x is off the curve (malformed bytes that pass the
structural parse), the infinity signature, a point on E2 outside G2, a
bare G2 point as signature, and an empty batch. Verdicts must be equal,
and False wherever the JAX package says False.
"""

from __future__ import annotations

import random

import pytest

from lighthouse_tpu.compile_service import CompileService as JaxService
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto import native as jnative
from lighthouse_tpu_torch.compile_service import CompileService as TorchService
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch.crypto import native as tnative
from lighthouse_tpu_torch.crypto.cpu.curve import G1Point, G2Point
from lighthouse_tpu_torch.crypto.cpu.fields import Fq, Fq2
from lighthouse_tpu_torch.crypto.params import B2, P, R


def _pk_bytes(sk: int) -> bytes:
    x, y = tnative.native_sk_to_pk_xy(sk)
    return G1Point(Fq(x), Fq(y)).compress()


def _off_curve(sig: bytes) -> bytes:
    """``sig`` with its x nudged until x^3 + b has no square root: the
    bytes parse, the decompression fails."""
    b = bytearray(sig)
    while True:
        b[95] = (b[95] + 1) % 256
        x1 = int.from_bytes(bytes([b[0] & 0x1F]) + bytes(b[1:48]), "big")
        x0 = int.from_bytes(bytes(b[48:]), "big")
        x = Fq2.from_ints(x0, x1)
        if (x.square() * x + Fq2.from_ints(*B2)).sqrt() is None:
            return bytes(b)


def _non_subgroup(r: random.Random) -> bytes:
    while True:
        x = Fq2.from_ints(r.randrange(P), r.randrange(P))
        y = (x.square() * x + Fq2.from_ints(*B2)).sqrt()
        if y is not None:
            pt = G2Point(x, y)
            assert not pt.in_subgroup()
            return pt.compress()


@pytest.fixture(scope="module")
def cases():
    """name -> [(pubkey bytes list, signature bytes, message)] batches."""
    r = random.Random(21)
    sks = [r.randrange(1, R) for _ in range(5)]
    pks = [_pk_bytes(sk) for sk in sks]
    msgs = [r.randbytes(32) for _ in range(4)]
    sign = tnative.native_sign
    one = [([pks[i]], sign(sks[i], msgs[i % 3]), msgs[i % 3]) for i in range(3)]
    agg = ([pks[3], pks[4]], sign((sks[3] + sks[4]) % R, msgs[3]), msgs[3])
    return {
        "valid": one + [agg],
        "valid_single": [one[0]],
        "wrong_message": one + [([pks[4]], sign(sks[4], msgs[0]), msgs[1])],
        "wrong_signer": [([pks[2], pks[4]], agg[1], agg[2])],
        "off_curve": one[:2] + [([pks[2]], _off_curve(one[2][1]), one[2][2])],
        "infinity": one[:1] + [([pks[1]], tbls.INFINITY_SIGNATURE, msgs[1])],
        "non_subgroup": one[:1] + [([pks[1]], _non_subgroup(r), msgs[1])],
    }


_PKS: dict = {}


def _pk(bls_mod, data: bytes):
    """One deserialized (subgroup-checked) key per package and bytes."""
    key = (bls_mod.__name__, data)
    if key not in _PKS:
        _PKS[key] = bls_mod.PublicKey.deserialize(data)
    return _PKS[key]


def _sets(bls_mod, batch):
    return [bls_mod.SignatureSet(bls_mod.Signature.deserialize(sig),
                                 [_pk(bls_mod, pk) for pk in pks], msg)
            for pks, sig, msg in batch]


def _triples(sets):
    return [(s.signature, [pk.point for pk in s.signing_keys], s.message) for s in sets]


def test_native_backend_matches_jax(cases):
    jb, tb = jnative.NativeBackend(), tnative.NativeBackend()
    got = {}
    for name, batch in cases.items():
        want = jb.verify_signature_sets(_triples(_sets(jbls, batch)))
        have = tb.verify_signature_sets(_triples(_sets(tbls, batch)))
        got[name] = (have, want)
    assert all(h == w for h, w in got.values()), got
    assert {k for k, (h, _w) in got.items() if h} == {"valid", "valid_single"}
    assert tb.verify_signature_sets([]) is jb.verify_signature_sets([]) is False
    # a bare G2 point as the signature, and the single-set entry points
    pks, sig, msg = cases["valid"][0]
    for bare_sig, want in ((sig, True), (cases["wrong_message"][-1][1], False)):
        jp, tp = jbls.G2Point.decompress(bare_sig), G2Point.decompress(bare_sig)
        jpk, tpk = _pk(jbls, pks[0]).point, _pk(tbls, pks[0]).point
        assert jb.verify_signature_sets([(jp, [jpk], msg)]) is want
        assert tb.verify_signature_sets([(tp, [tpk], msg)]) is want
        assert tb.verify(tpk, msg, tp) is jb.verify(jpk, msg, jp) is want
    apks, asig, amsg = cases["valid"][3]
    t_apks = [_pk(tbls, p).point for p in apks]
    j_apks = [_pk(jbls, p).point for p in apks]
    for m, want in ((amsg, True), (msg, False)):
        assert (tb.fast_aggregate_verify(t_apks, m, tbls.Signature.deserialize(asig))
                is jb.fast_aggregate_verify(j_apks, m, jbls.Signature.deserialize(asig))
                is want)
    # aggregate_verify: one signature over two different messages
    r = random.Random(5)
    sks = [r.randrange(1, R) for _ in range(2)]
    ms = [r.randbytes(32) for _ in range(2)]
    g2 = [G2Point.decompress(tnative.native_sign(sk, m)) for sk, m in zip(sks, ms)]
    agg_sig = (g2[0] + g2[1]).compress()
    pk2 = [_pk_bytes(sk) for sk in sks]
    for msgs_in, want in ((ms, True), (ms[::-1], False)):
        assert tb.aggregate_verify([_pk(tbls, p).point for p in pk2],
                                   msgs_in, tbls.Signature.deserialize(agg_sig)) is want
        assert jb.aggregate_verify([_pk(jbls, p).point for p in pk2],
                                   msgs_in, jbls.Signature.deserialize(agg_sig)) is want


def test_malformed_bytes_raise_in_both_parsers():
    for data in (b"\x00" * 95, bytes([0xE0]) + b"\x00" * 95, b"\x80" + b"\xff" * 95):
        for mod in (jbls, tbls):
            with pytest.raises(mod.BlsError):
                mod.Signature.deserialize(data)


def test_fallback_verify_matches_jax(cases):
    jsvc = JaxService(rungs=[(1, 1, 1)])
    tsvc = TorchService(rungs=[(1, 1, 1)], device="cpu")
    for name, batch in cases.items():
        want = jsvc.fallback_verify(_sets(jbls, batch))
        assert tsvc.fallback_verify(_sets(tbls, batch)) is want, name
    assert tsvc.fallback_verify([]) is jsvc.fallback_verify([]) is False
    st = tsvc.status()["fallback"]
    assert st["backend"] == "cpu-native" and st["built"]
    assert st["calls"] == len(cases) + 1 and st["sets"] == sum(map(len, cases.values()))
    injected = TorchService(rungs=[(1, 1, 1)], device="cpu",
                            fallback_verify_fn=lambda sets: len(sets) == 2)
    assert injected.fallback_verify([1, 2]) is True
    assert injected.status()["fallback"]["backend"] == "injected"


def test_a_failed_c_build_raises(tmp_path, monkeypatch):
    """No fallback hides a broken toolchain: a compiler that fails, or a
    missing source, raises ``NativeBuildError`` (the port has no
    pure-Python pairing to fall back to)."""
    from lighthouse_tpu_torch import _native

    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(_native.NativeBuildError, match="failed"):
        _native._build_and_load_uncached("bls12381")
    assert not list(tmp_path.rglob("*.so"))
    with pytest.raises(_native.NativeBuildError, match="missing source"):
        _native._build_and_load_uncached("no_such_source")


def test_secret_key_decides_its_signer_once(monkeypatch, caplog):
    """``SecretKey`` signs with the C library, loaded once; when it cannot
    be loaded the pure-Python oracle signs the same bytes, with one
    warning for the process, and a fault of the C signer itself raises."""
    sk = tbls.SecretKey(random.Random(7).randrange(1, R))
    msg = bytes(range(32))
    c_sig, c_pk = sk.sign(msg).serialize(), sk.public_key().serialize()
    assert tbls._native_signer() is tnative

    def unavailable():
        raise tnative.NativeUnavailable("no C library here")

    monkeypatch.setattr(tnative, "lib", unavailable)
    monkeypatch.setattr(tbls, "_signer_loaded", False)
    monkeypatch.setattr(tbls, "_signer", None)
    with caplog.at_level("WARNING", logger=tbls.__name__):
        assert sk.sign(msg).serialize() == c_sig
        assert sk.public_key().serialize() == c_pk
    assert [r.getMessage() for r in caplog.records].count(
        "BLS signer: the C library is unavailable, the pure-Python oracle signs "
        "(no C library here)") == 1
    monkeypatch.setattr(tbls, "_signer_loaded", True)
    monkeypatch.setattr(tbls, "_signer", tnative)
    with pytest.raises(tnative.NativeUnavailable):
        sk.sign(msg)
