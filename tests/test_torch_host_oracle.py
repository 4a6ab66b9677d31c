"""The port's host oracle (item 17): the pure-Python pairing behind the
``cpu`` backend, the backend registry, the compile service's last-resort
fallback, and the C library's signer and key derivation that the
harness can be handed.

Exact equality throughout:

* the port's ``CpuBackend`` gives the JAX package's ``CpuBackend``
  verdicts and ``cpu-native``'s on seeded sets: valid, tampered message,
  wrong key, an infinity signature, an empty batch (a pure-Python
  multi-pairing costs about 2 s);
* the registry has the four names, reads ``LIGHTHOUSE_TPU_BLS_BACKEND``
  and defaults to ``cuda``, checked in fresh interpreters;
* ``CompileService.fallback_verify`` with the C build failing verifies on
  the pure-Python oracle, counted and journaled as any fallback;
* the C signer, its aggregate over one root, and the C key derivation
  give the pure-Python oracle's bytes on the first 64 interop keys (the
  scalar multiples by a Jacobian double-and-add over the oracle's field
  classes, held to the oracle's affine ``mul`` on the first keys).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu_torch.compile_service import CompileService
from lighthouse_tpu_torch.crypto import backend as tbackend
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch._native import NativeBuildError
from lighthouse_tpu_torch.crypto.native import NativeBackend
from lighthouse_tpu_torch.state_transition.genesis import interop_secret_key
from lighthouse_tpu_torch.testing.harness import native_pubkey, native_signer
from lighthouse_tpu_torch.utils import flight_recorder

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sets(pkg, case: str):
    """A seeded batch of two sets in ``pkg``'s types (JAX or port)."""
    bls = jbls if pkg == "jax" else tbls
    sk = [interop_secret_key(i).k for i in (3, 4)]
    msgs = [bytes([7 + i]) * 32 for i in range(2)]
    pks = [bls.PublicKey.deserialize(native_pubkey(tbls.SecretKey(k))) for k in sk]
    sigs = [bls.Signature.deserialize(native_signer([tbls.SecretKey(k)], m))
            for k, m in zip(sk, msgs)]
    if case == "empty":
        return []
    if case == "tampered":
        msgs[1] = b"\x00" + msgs[1][1:]
    if case == "wrong key":
        pks = [pks[1], pks[0]]
    if case == "infinity":
        sigs[0] = bls.Signature.infinity()
    return [(s, [pk.point], m) for s, pk, m in zip(sigs, pks, msgs)]


CASES = {"valid": True, "tampered": False, "wrong key": False, "infinity": False,
         "empty": False}


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_backend_agrees_with_jax_and_cpu_native(case):
    port = tbackend.CpuBackend.verify_signature_sets(_sets("torch", case))
    native = NativeBackend().verify_signature_sets(_sets("torch", case))
    jax = jbackend.CpuBackend.verify_signature_sets(_sets("jax", case))
    assert port is native is jax is CASES[case]


def test_single_set_entry_points_on_the_cpu_backend():
    sk = tbls.SecretKey(interop_secret_key(9).k)
    pk = tbls.PublicKey.deserialize(native_pubkey(sk))
    msg = b"\x21" * 32
    sig = tbls.Signature.deserialize(native_signer([sk], msg))
    saved = (tbackend._active, tbackend._active_name)
    tbackend.set_backend("cpu")
    try:
        assert sig.verify(pk, msg) is True
        agg = tbls.AggregateSignature(sig.point, sig.serialize())
        assert agg.fast_aggregate_verify(msg, []) is False
        assert tbls.verify_signature_sets([]) is False
        assert tbls.verify_signature_sets(
            [tbls.SignatureSet(tbls.Signature.infinity(), [pk], msg)]) is False
    finally:
        tbackend._active, tbackend._active_name = saved


def _fresh(code: str, env: dict) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})\n" + code],
        capture_output=True, text=True, timeout=120, check=True, cwd=str(ROOT), env=env)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_registry_names_env_knob_and_cuda_default():
    code = """
import json
from lighthouse_tpu_torch.crypto import backend
b = backend.active()
out = {"name": backend.active_name(), "type": type(b).__name__,
       "device": str(getattr(b, "device", "")), "names": sorted(backend._REGISTRY)}
try:
    backend.set_backend("nope")
except KeyError:
    out["unknown"] = "KeyError"
print(json.dumps(out))
"""
    env = {k: v for k, v in os.environ.items() if k != tbackend.ENV}
    default = _fresh(code, env)
    assert default == {"name": "cuda", "type": "CudaBackend", "device": "cuda",
                       "names": ["cpu", "cpu-native", "cuda", "fake"], "unknown": "KeyError"}
    for name, kind in (("fake", "FakeBackend"), ("cpu", "CpuBackend"),
                       ("cpu-native", "NativeBackend")):
        got = _fresh(code, {**env, tbackend.ENV: name})
        assert (got["name"], got["type"]) == (name, kind)


def test_fallback_verify_falls_back_to_the_oracle_when_the_c_build_fails(monkeypatch):
    def broken():
        raise NativeBuildError("no C compiler found")

    monkeypatch.setitem(tbackend._REGISTRY, "cpu-native", broken)
    flight_recorder.clear()
    svc = CompileService(rungs=[], device="cpu", compile_rung_fn=lambda *a, **k: None)
    sk = tbls.SecretKey(interop_secret_key(5).k)
    pk = tbls.PublicKey.deserialize(native_pubkey(sk))
    msg = b"\x33" * 32
    sig = tbls.Signature.deserialize(native_signer([sk], msg))
    assert svc.fallback_verify([tbls.SignatureSet(sig, [pk], msg)]) is True
    assert isinstance(svc._fallback_backend, tbackend.CpuBackend)
    assert svc.fallback_verify([tbls.SignatureSet(tbls.Signature.infinity(), [pk], msg)]) \
        is False
    st = svc.status()["fallback"]
    assert st["calls"] == 2 and st["sets"] == 2
    rows = flight_recorder.events(kinds=("transfer_ledger",))
    assert [(r["fields"]["n_sets"], r["fields"]["h2d_bytes_total"]) for r in rows] == \
        [(1, 0), (1, 0)]


def _jacobian_mul(pt, k: int):
    """[k]pt for 0 < k < r on the oracle's points and field classes, by
    MSB-first double-and-add in Jacobian coordinates (a = 0): one field
    inversion at the end instead of one for every step of the affine
    ``mul``. Every intermediate multiple lies strictly between 1 and r, so
    the doubling and the mixed addition meet no special case."""
    x, y = pt.x, pt.y
    X, Y, Z = x, y, x * x.inverse()
    for bit in bin(k)[3:]:
        a, b = X.square(), Y.square()
        c = b.square()
        d = (X + b).square() - a - c
        d = d + d
        e = a + a + a
        c8 = c + c
        c8 = c8 + c8
        c8 = c8 + c8
        X3 = e.square() - d - d
        yz = Y * Z
        Y, Z = e * (d - X3) - c8, yz + yz
        X = X3
        if bit == "1":
            zz = Z.square()
            h = x * zz - X
            hh = h.square()
            i = hh + hh
            i = i + i
            j = h * i
            r = y * Z * zz - Y
            r = r + r
            v = X * i
            X3 = r.square() - j - v - v
            yj = Y * j
            Y, Z = r * (v - X3) - yj - yj, (Z + h).square() - zz - hh
            X = X3
    zi = Z.inverse()
    zi2 = zi.square()
    return type(pt)(X * zi2, Y * zi2 * zi)


def test_c_signer_and_keys_equal_the_oracle_on_64_interop_keys():
    """The C library's keys and signatures (``native_pubkey``,
    ``native_signer``, and ``SecretKey``, which takes them when the library
    builds) against the pure-Python oracle's, computed here: [k]G and
    [k]H(m) (the oracle's affine ``mul`` on the first two keys, the
    Jacobian double-and-add, held equal to it there, on all 64)."""
    msg = b"\x5a" * 32
    keys = [tbls.SecretKey(interop_secret_key(i).k) for i in range(64)]
    g, h = tbls.g1_generator(), tbls.hash_to_g2(msg, tbls.DST)
    for k in keys[:2]:
        assert _jacobian_mul(g, k.k) == g.mul(k.k)
        assert _jacobian_mul(h, k.k) == h.mul(k.k)
    for k in keys:
        want = tbls.PublicKey(_jacobian_mul(g, k.k)).serialize()
        assert native_pubkey(k) == k.public_key().serialize() == want
    agg = tbls.AggregateSignature.infinity()
    for i, k in enumerate(keys):
        want = tbls.Signature(_jacobian_mul(h, k.k))
        assert native_signer([k], msg) == k.sign(msg).serialize() == want.serialize()
        if i < 3:
            agg.add_assign(want)
    assert native_signer(keys[:3], msg) == agg.serialize()
