"""The port's wire stack against the JAX package's: snappy, the crypto
under the Noise sessions, the transport and the network service.

* snappy: the port's C and pure-Python codecs give the JAX codecs' bytes,
  and each package decodes the other's, on empty, one-byte, repetitive,
  incompressible and over-64-KiB inputs, raw blocks and frames;
* crypto (``utils/crypto.py``, where JAX calls ``cryptography``): the
  RFC 7748 X25519 vectors, the RFC 8439 AEAD vector, seeded inputs equal
  to ``cryptography``, and the C ChaCha20-Poly1305 equal to its
  pure-Python twin;
* transport: a port ``Transport`` and a JAX ``Transport`` complete the
  Noise XX handshake both ways and exchange gossip and an RPC;
* network: a JAX node and a port node over localhost, each on ``fake``,
  import each other's published blocks to equal heads, and a late port
  node range-syncs from the JAX node; the port's ``LocalNetwork`` of
  three nodes propagates blocks and attestations and finalizes.

Socket readiness is waited for with bounded polls, never bare sleeps.
"""

from __future__ import annotations

import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.network import noise as jnoise
from lighthouse_tpu.network.transport import Transport as JTransport
from lighthouse_tpu.testing.simulator import LocalNetwork as JLocalNetwork
from lighthouse_tpu.utils import snappy as jsnappy
from lighthouse_tpu_torch.crypto import backend as tbackend
from lighthouse_tpu_torch.network import noise as tnoise
from lighthouse_tpu_torch.network.service import PROTO_BLOCKS_BY_RANGE
from lighthouse_tpu_torch.network.transport import Transport as TTransport
from lighthouse_tpu_torch.ssz import hash_tree_root
from lighthouse_tpu_torch.testing.simulator import LocalNetwork as TLocalNetwork
from lighthouse_tpu_torch.testing.simulator import LocalNode as TLocalNode
from lighthouse_tpu_torch.utils import crypto, snappy as tsnappy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fake_backends():
    saved = [(m, m._active, m._active_name) for m in (jbackend, tbackend)]
    jbackend.set_backend("fake")
    tbackend.set_backend("fake")
    yield
    for m, active, name in saved:
        m._active, m._active_name = active, name


def _wait(cond, timeout: float = 10.0, what: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# snappy
# ---------------------------------------------------------------------------

def _snappy_input(kind: str) -> bytes:
    rng = np.random.default_rng(7)
    return {
        "empty": b"",
        "one_byte": b"\x5a",
        "repetitive": bytes(rng.integers(0, 256, 32, dtype=np.uint8)) * 500,
        "incompressible": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "over_64KiB": (b"beacon block " * 12_000)[:150_001],
    }[kind]


SNAPPY_KINDS = ("empty", "one_byte", "repetitive", "incompressible", "over_64KiB")


@pytest.mark.parametrize("kind", SNAPPY_KINDS)
def test_snappy_equals_jax_and_cross_decodes(kind):
    data = _snappy_input(kind)
    assert tsnappy._native_lib() is not None and jsnappy._native_lib() is not None
    c_port, c_jax = tsnappy.compress_raw(data), jsnappy.compress_raw(data)
    py_port, py_jax = tsnappy._compress_raw_py(data), jsnappy._compress_raw_py(data)
    assert c_port == c_jax and py_port == py_jax
    for blob in (c_jax, py_jax):
        assert tsnappy.decompress_raw(blob) == data
        assert tsnappy._decompress_raw_py(blob) == data
    for blob in (c_port, py_port):
        assert jsnappy.decompress_raw(blob) == data
    framed = tsnappy.compress_frames(data)
    assert framed == jsnappy.compress_frames(data)
    assert jsnappy.decompress(framed) == data and tsnappy.decompress(framed) == data
    if kind == "repetitive":
        assert len(c_port) < len(data) // 10


def test_snappy_rejects_malformed_streams_as_jax_does():
    good = tsnappy.compress_raw(b"hello world " * 100)
    for bad in (good[:3], good[:-5], b"\xff" * 40, bytes([good[0] + 1]) + good[1:]):
        for mod in (tsnappy, jsnappy):
            with pytest.raises(mod.SnappyError):
                mod.decompress_raw(bad)


# ---------------------------------------------------------------------------
# crypto
# ---------------------------------------------------------------------------

RFC7748 = [  # §5.2 and §6.1 (Alice's and Bob's keys and their shared secret)
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
    ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
     "0900000000000000000000000000000000000000000000000000000000000000",
     "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"),
    ("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
     "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a",
     "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"),
]


@pytest.mark.parametrize("k, u, want", RFC7748)
def test_x25519_rfc7748_vectors(k, u, want):
    assert crypto.x25519(bytes.fromhex(k), bytes.fromhex(u)).hex() == want


def test_x25519_refuses_a_small_order_point():
    with pytest.raises(ValueError):
        crypto.x25519(os.urandom(32), bytes(32))
    with pytest.raises(tnoise.HandshakeError):
        tnoise._dh(os.urandom(32), bytes(32))


RFC8439_KEY = bytes(range(0x80, 0xA0))
RFC8439_NONCE = bytes.fromhex("070000004041424344454647")
RFC8439_AD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC8439_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one "
              b"tip for the future, sunscreen would be it.")
RFC8439_CT = bytes.fromhex(
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d63dbea45e8ca967128"
    "2fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b3692ddbd7f2d778b8c9803aee328091b58fab"
    "324e4fad675945585808b4831d7bc3ff4def08e4b7a9de576d26586cec64b6116"
    "1ae10b594f09e26a7e902ecbd0600691")


@pytest.mark.parametrize("impl", ("c", "python"))
def test_aead_rfc8439_vector(impl):
    if impl == "c":
        assert crypto._native() is not None
        aead = crypto.ChaCha20Poly1305(RFC8439_KEY)
        seal, open_ = aead.encrypt, aead.decrypt
    else:
        def seal(n, d, a):
            return crypto._py_seal(RFC8439_KEY, n, d, a)

        def open_(n, d, a):
            return crypto._py_open(RFC8439_KEY, n, d, a)
    assert seal(RFC8439_NONCE, RFC8439_PT, RFC8439_AD) == RFC8439_CT
    assert open_(RFC8439_NONCE, RFC8439_CT, RFC8439_AD) == RFC8439_PT
    for i in (0, len(RFC8439_CT) - 1):
        bad = bytearray(RFC8439_CT)
        bad[i] ^= 1
        with pytest.raises(crypto.InvalidTag):
            open_(RFC8439_NONCE, bytes(bad), RFC8439_AD)


AEAD_LENGTHS = (0, 1, 15, 16, 17, 64, 65, 1000, 100_003)


def test_c_aead_equals_its_python_twin_on_seeded_inputs():
    rng = np.random.default_rng(11)
    for n in AEAD_LENGTHS[:-1]:
        for adlen in (0, 1, 32, 33):
            key, nonce, data, ad = (rng.integers(0, 256, m, dtype=np.uint8).tobytes()
                                    for m in (32, 12, n, adlen))
            ct = crypto.ChaCha20Poly1305(key).encrypt(nonce, data, ad)
            assert ct == crypto._py_seal(key, nonce, data, ad)
            assert crypto._py_open(key, nonce, ct, ad) == data


def test_crypto_equals_cryptography_on_seeded_inputs():
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey)
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    rng = np.random.default_rng(12)

    def draw(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    for _ in range(8):
        a, b = draw(32), draw(32)
        pub_b = X25519PrivateKey.from_private_bytes(b).public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        assert crypto.x25519_public(b) == pub_b
        assert crypto.x25519(a, pub_b) == X25519PrivateKey.from_private_bytes(a).exchange(
            X25519PublicKey.from_public_bytes(pub_b))
    for n in AEAD_LENGTHS:
        key, nonce, data, ad = draw(32), draw(12), draw(n), draw(n % 41)
        want = ChaCha20Poly1305(key).encrypt(nonce, data, ad)
        assert crypto.ChaCha20Poly1305(key).encrypt(nonce, data, ad) == want
        assert crypto.ChaCha20Poly1305(key).decrypt(nonce, want, ad) == data
    for n in (0, 1, 16, 32, 33, 100):
        key, iv, data = draw(16), draw(16), draw(n)
        enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
        assert crypto.aes128_ctr(key, iv, data) == enc.update(data) + enc.finalize()
    iv = b"\xff" * 16  # the counter wraps as one 128-bit integer
    key, data = draw(16), draw(48)
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    assert crypto.aes128_ctr(key, iv, data) == enc.update(data) + enc.finalize()


def test_noise_identities_and_handshake_interoperate_with_jax():
    """A seed names one node id in both packages, and a port initiator and
    a JAX responder (then the other way round) agree on the session."""
    import socket

    for seed in (b"a", b"node-7"):
        assert tnoise.Identity.from_seed(seed).node_id == jnoise.Identity.from_seed(seed).node_id
    for ini_mod, resp_mod in ((tnoise, jnoise), (jnoise, tnoise)):
        a_id, b_id = ini_mod.Identity.from_seed(b"a"), resp_mod.Identity.from_seed(b"b")
        sa, sb = socket.socketpair()
        out = {}
        th = threading.Thread(target=lambda: out.update(
            b=resp_mod.handshake_responder(sb, b_id)))
        th.start()
        try:
            sess_a = ini_mod.handshake_initiator(sa, a_id)
            th.join(10)
            assert not th.is_alive()
            sess_b = out["b"]
            assert sess_a.remote_node_id == b_id.node_id
            assert sess_b.remote_node_id == a_id.node_id
            assert sess_b.recv.decrypt(sess_a.send.encrypt(b"hello")) == b"hello"
            assert sess_a.recv.decrypt(sess_b.send.encrypt(b"world")) == b"world"
        finally:
            sa.close()
            sb.close()


# ---------------------------------------------------------------------------
# transport across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dialer", ("port", "jax"))
def test_transports_handshake_gossip_and_rpc_across_packages(dialer):
    port_t, jax_t = TTransport(), JTransport()
    a, b = (port_t, jax_t) if dialer == "port" else (jax_t, port_t)
    got = []
    b.on_gossip = lambda peer, topic, payload: got.append((topic, payload))
    b.on_request = lambda peer, proto, payload: payload[::-1]
    try:
        peer = a.dial("127.0.0.1", b.port)
        assert peer is not None and peer.node_id == b.node_id
        _wait(lambda: b.peer_count() == 1, what="the inbound peer")
        payload = bytes(range(256)) * 300  # several snappy blocks
        assert a.publish("/eth2/00000000/beacon_block/ssz_snappy", payload) == 1
        _wait(lambda: got, what="the gossip message")
        assert got == [("/eth2/00000000/beacon_block/ssz_snappy", payload)]
        assert peer.request(b"/eth2/beacon_chain/req/ping/1", b"abc", timeout=10) == b"cba"
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# nodes across packages
# ---------------------------------------------------------------------------

def _set_slot(nets, slot):
    for net in nets:
        net.clock.set_slot(slot)
        for node in net.nodes:
            node.chain.on_tick(slot)


def test_jax_and_port_nodes_import_each_others_blocks_and_a_late_port_node_syncs(
        fake_backends):
    jnet, tnet = JLocalNetwork(1, validator_count=8), TLocalNetwork(1, validator_count=8)
    late = None
    try:
        jnode, tnode = jnet.nodes[0], tnet.nodes[0]
        assert tnode.chain.head_block_root == jnode.chain.head_block_root
        assert tnode.net.connect("127.0.0.1", jnode.net.port) is not None
        _wait(lambda: jnode.net.transport.peer_count() == 1, what="the JAX node's peer")
        h, t = jnet.h, tnet.h.t
        fork = "phase0"
        for slot in range(1, 7):
            _set_slot((jnet, tnet), slot)
            sb = h.produce_block(slot)
            h.process_block(sb, strategy="none")
            raw = type(sb).encode(sb)
            if slot % 2:  # published by the JAX node
                jnode.chain.process_block(jnode.chain.verify_block_for_gossip(sb))
                jnode.net.publish_block(sb)
            else:  # the same bytes, published by the port node
                tsb = t.signed_block[fork].decode(raw)
                tnode.chain.process_block(tnode.chain.verify_block_for_gossip(tsb))
                tnode.net.publish_block(tsb)
            want = hash_tree_root(t.signed_block[fork].decode(raw).message)

            def both_at_head():
                for node in (jnode, tnode):
                    node.chain.recompute_head()
                return jnode.chain.head_block_root == tnode.chain.head_block_root == want
            _wait(both_at_head, what=f"both heads at slot {slot}")
        # a late port node: its status exchange with the JAX node starts a
        # range sync (blocks_by_range over the Noise transport)
        late = TLocalNode(tnet.h, tnet.genesis, tnet.clock)
        assert late.net.connect("127.0.0.1", jnode.net.port) is not None

        def synced():
            late.chain.recompute_head()
            return late.chain.head_block_root == jnode.chain.head_block_root
        _wait(synced, timeout=20, what="the late node's range sync")
        assert late.chain.head_state.slot == 6
        peer = late.net.transport.peers_snapshot()[0]
        raw = peer.request(PROTO_BLOCKS_BY_RANGE.encode(), struct.pack("<QQ", 1, 10), timeout=10)
        count, i = 0, 0
        while i + 4 <= len(raw):
            (n,) = struct.unpack_from("<I", raw, i)
            i += 4 + n
            count += 1
        assert count == 6
    finally:
        if late is not None:
            late.close()
        jnet.close()
        tnet.close()


def test_local_network_of_three_propagates_attestations_and_finalizes(fake_backends):
    net = TLocalNetwork(3, validator_count=8)
    try:
        P = net.h.preset
        for _ in range(4):
            net.tick_slot(attest=False)
        head = net.check_all_heads_equal()
        for n in net.nodes:
            assert n.chain.store.get_block(head) is not None
        for _ in range(4 * P.SLOTS_PER_EPOCH - 4):
            net.tick_slot(attest=True)
        net.check_all_heads_equal()
        net.check_finalization(1)
        for n in net.nodes:  # every validator's vote reached every node
            assert len(n.chain.fork_choice.proto.votes) == 8
    finally:
        net.close()
