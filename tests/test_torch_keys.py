"""The port's keys (``lighthouse_tpu_torch/keys``) against the JAX
package's: EIP-2333 derivation (the spec's vectors and seeded paths),
EIP-2335 keystores (each package decrypts the other's; with the same
random draws both write the same JSON), the EIP-2386 wallet, and the
EIP-3076 slashing-protection database (rules and interchange export).
Small work factors, as the JAX tests use."""

from __future__ import annotations

import json
import secrets
import uuid

import numpy as np
import pytest
import torch

import lighthouse_tpu.keys as jkeys
import lighthouse_tpu.keys.derivation as jderiv
import lighthouse_tpu_torch.keys as tkeys
import lighthouse_tpu_torch.keys.derivation as tderiv
from lighthouse_tpu_torch.keys.keystore import KeystoreError, normalize_password

KDF_WORK = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


EIP2333_VECTORS = [  # (seed, master SK, child index, child SK), test cases 0-3
    ("c55257c360c07c72029aebc1b53c05ed0362ada38ead3e3e9efa3708e53495531f09a6"
     "987599d18264c1e1c92f2cf141630c7a3c4ab7c81b2f001698e7463b04",
     6083874454709270928345386274498605044986640685124978867557563392430687146096,
     0,
     20397789859736650942317412262472558107875392172444076792671091975210932703118),
    ("3141592653589793238462643383279502884197169399375105820974944592",
     29757020647961307431480504535336562678282505419141012933316116377660817309383,
     3141592653,
     25457201688850691947727629385191704516744796114925897962676248250929345014287),
    ("0099FF991111002299DD7744EE3355BBDD8844115566CC55663355668888CC00",
     27580842291869792442942448775674722299803720648445448686099262467207037398656,
     4294967295,
     29358610794459428860402234341874281240803786294062035874021252734817515685787),
    ("d4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3",
     19022158461524446591288038168518313374041767046816487870552872741050760015818,
     42,
     31372231650479070279774297061823572166496564838472787488249775572789064611981),
]
SEED = bytes.fromhex(EIP2333_VECTORS[0][0])


@pytest.mark.parametrize("seed, master, index, child", EIP2333_VECTORS)
def test_eip2333_spec_vectors(seed, master, index, child):
    m = tkeys.derive_master_sk(bytes.fromhex(seed))
    assert m == master
    assert tkeys.derive_child_sk(m, index) == child


def test_seeded_derivations_equal_jax():
    rng = np.random.default_rng(3)
    for _ in range(4):
        seed = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        for account in (0, 1, 17):
            paths = (tderiv.validator_signing_path(account),
                     tderiv.validator_withdrawal_path(account))
            assert paths == (jderiv.validator_signing_path(account),
                             jderiv.validator_withdrawal_path(account))
            for path in paths:
                assert tkeys.derive_sk_at_path(seed, path) == jkeys.derive_sk_at_path(seed, path)
    for mod in (tkeys, jkeys):
        with pytest.raises(ValueError):
            mod.derive_sk_at_path(SEED, "x/12381")
        with pytest.raises(ValueError):
            mod.derive_master_sk(b"short")


class _Draws:
    """``secrets.token_bytes`` and ``uuid.uuid4`` from a seed, so that both
    packages' keystores draw the same salt, IV and UUID."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def token_bytes(self, n=32):
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def uuid4(self):
        return uuid.UUID(bytes=self.token_bytes(16), version=4)


def _seeded(monkeypatch, seed: int):
    draws = _Draws(seed)
    monkeypatch.setattr(secrets, "token_bytes", draws.token_bytes)
    monkeypatch.setattr(uuid, "uuid4", draws.uuid4)


@pytest.mark.parametrize("kdf", ["scrypt", "pbkdf2"])
def test_keystores_cross_decrypt_and_equal_jax_with_the_same_draws(kdf, monkeypatch):
    secret = bytes(range(32))
    path = "m/12381/3600/0/0/0"
    jstore = jkeys.encrypt(secret, "correct horse", kdf=kdf, kdf_work=KDF_WORK, path=path)
    tstore = tkeys.encrypt(secret, "correct horse", kdf=kdf, kdf_work=KDF_WORK, path=path)
    assert tkeys.decrypt(json.loads(json.dumps(jstore)), "correct horse") == secret
    assert jkeys.decrypt(json.loads(json.dumps(tstore)), "correct horse") == secret
    for mod, store in ((tkeys, jstore), (jkeys, tstore)):
        with pytest.raises(ValueError):
            mod.decrypt(store, "wrong password")
    _seeded(monkeypatch, 5)
    a = tkeys.encrypt(secret, "pässword\x7f", kdf=kdf, kdf_work=KDF_WORK, path=path)
    _seeded(monkeypatch, 5)
    b = jkeys.encrypt(secret, "pässword\x7f", kdf=kdf, kdf_work=KDF_WORK, path=path)
    assert a == b and a["version"] == 4
    with pytest.raises(KeystoreError):
        tkeys.decrypt({**a, "version": 3}, "pässword")


def test_password_normalization_equals_jax():
    from lighthouse_tpu.keys.keystore import normalize_password as jnorm

    for pw in ("test\x7fpassword\x00", "Ångström", "Ångström", "𝔱𝔢𝔰𝔱", ""):
        assert normalize_password(pw) == jnorm(pw)
    assert normalize_password("test\x7fpassword\x00") == b"testpassword"


def test_wallet_create_and_derive_equal_jax(monkeypatch):
    out = {}
    for name, mod in (("port", tkeys), ("jax", jkeys)):
        _seeded(monkeypatch, 9)
        w = mod.Wallet.create("w1", "wallet-pass", seed=SEED, kdf_work=KDF_WORK)
        keystores = [w.next_validator("wallet-pass", "ks-pass", kdf_work=KDF_WORK)
                     for _ in range(2)]
        out[name] = (w.json, keystores)
    assert out["port"] == out["jax"]
    wjson, keystores = out["port"]
    assert wjson["nextaccount"] == 2
    signing, withdrawal = keystores[1]
    assert (signing["path"], withdrawal["path"]) == ("m/12381/3600/1/0/0", "m/12381/3600/1/0")
    want = tkeys.derive_sk_at_path(SEED, signing["path"])
    assert int.from_bytes(tkeys.decrypt(signing, "ks-pass"), "big") == want
    from lighthouse_tpu_torch.crypto import bls

    assert signing["pubkey"] == bls.SecretKey(want).public_key().serialize().hex()
    # a wallet written by JAX opens in the port
    assert tkeys.Wallet(out["jax"][0]).decrypt_seed("wallet-pass") == SEED


PK = b"\xaa" * 48
GVR = b"\x11" * 32


def _history(mod):
    """One signing history, refusals included; the database and what each
    step raised."""
    db = mod.SlashingDatabase(genesis_validators_root=GVR)
    db.register_validator(PK)
    db.register_validator(b"\xbb" * 48)
    steps = [("block", PK, 10, b"\x01" * 32), ("block", PK, 10, b"\x01" * 32),
             ("block", PK, 10, b"\x02" * 32), ("block", PK, 5, b"\x03" * 32),
             ("block", PK, 11, b"\x04" * 32), ("att", PK, 2, 3, b"\x01" * 32),
             ("att", PK, 2, 3, b"\x02" * 32), ("att", PK, 1, 4, b"\x03" * 32),
             ("att", PK, 3, 5, b"\x04" * 32), ("att", PK, 4, 4, b"\x05" * 32),
             ("att", PK, 9, 8, b"\x06" * 32), ("block", b"\xbb" * 48, 7, b"\x07" * 32),
             ("att", b"\xbb" * 48, 0, 1, b"\x08" * 32)]
    raised = []
    for kind, *args in steps:
        fn = (db.check_and_insert_block_proposal if kind == "block"
              else db.check_and_insert_attestation)
        try:
            fn(*args)
            raised.append(None)
        except mod.SlashingProtectionError:
            raised.append("refused")
    return db, raised


def test_slashing_protection_rules_and_interchange_equal_jax():
    tdb, traised = _history(tkeys)
    jdb, jraised = _history(jkeys)
    assert traised == jraised
    assert traised.count("refused") == 6
    assert json.loads(tdb.export_json()) == json.loads(jdb.export_json())
    assert tdb.export_interchange()["metadata"]["interchange_format_version"] == "5"
    # JAX's export imports into the port and enforces the same history
    db2 = tkeys.SlashingDatabase(genesis_validators_root=GVR)
    db2.import_json(jdb.export_json())
    with pytest.raises(tkeys.SlashingProtectionError):
        db2.check_and_insert_block_proposal(PK, 11, b"\x99" * 32)
    with pytest.raises(tkeys.SlashingProtectionError):
        db2.check_and_insert_attestation(PK, 3, 5, b"\x99" * 32)
    db2.check_and_insert_attestation(PK, 5, 6, b"\x03" * 32)
    with pytest.raises(tkeys.SlashingProtectionError):
        tkeys.SlashingDatabase(genesis_validators_root=b"\x22" * 32).import_json(
            tdb.export_json())
