"""Noise-XX authenticated key exchange + AEAD framing for the transport.

The reference's libp2p layer authenticates and encrypts every connection
with the Noise protocol before any application bytes flow
(``beacon_node/lighthouse_network/src/service/behaviour.rs:17-30`` wires
the transport; libp2p-noise is the session layer), and peer scoring is
keyed by the cryptographic peer id, not the socket address
(``src/peer_manager/peerdb.rs``). This module gives the TCP transport the
same properties:

* **Noise XX** handshake (3 messages) over X25519 + HKDF-SHA256 +
  ChaCha20-Poly1305: mutual authentication of *static* keys, forward
  secrecy from ephemerals, and a transcript hash binding every message.
* **Identity**: a node's id is ``sha256(static_pub)`` — unforgeable
  without the private key; scores/bans key on it (``Peer.node_id``).
* **Transport phase**: every frame is AEAD-sealed with a per-direction
  key and a strictly-increasing counter nonce — on-path tampering,
  reflection, and replay (within or across sessions — ephemerals differ)
  all fail authentication and kill the connection.

The state machine follows the Noise spec's SymmetricState/CipherState
objects (MixHash / MixKey / EncryptAndHash / Split) so each step is
checkable against the spec; only the XX pattern is implemented. The port's
copy of the JAX package's ``noise.py``: X25519 and ChaCha20-Poly1305 come
from ``utils/crypto.py`` (the AEAD in C), so the wire bytes are the same and
no ``cryptography`` package is needed.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

from ..utils.crypto import (
    ChaCha20Poly1305,
    InvalidTag,
    x25519,
    x25519_private,
    x25519_public,
)

PROTOCOL_NAME = b"Noise_XX_25519_ChaChaPoly_SHA256"
DHLEN = 32
TAGLEN = 16
MAX_NOISE_MSG = 1 << 16


class HandshakeError(Exception):
    pass


def _hkdf2(ck: bytes, ikm: bytes) -> tuple[bytes, bytes]:
    """Noise HKDF with two outputs (spec §4.3)."""
    temp = hmac.new(ck, ikm, hashlib.sha256).digest()
    out1 = hmac.new(temp, b"\x01", hashlib.sha256).digest()
    out2 = hmac.new(temp, out1 + b"\x02", hashlib.sha256).digest()
    return out1, out2


def _pub_bytes(priv: bytes) -> bytes:
    return x25519_public(priv)


def _dh(priv: bytes, pub: bytes) -> bytes:
    # a small-order remote key gives an all-zero secret: a failed handshake
    try:
        return x25519(priv, pub)
    except ValueError as e:
        raise HandshakeError(str(e)) from e


class Identity:
    """A node's static X25519 keypair (the 32-byte private scalar);
    ``node_id`` is the wire identity."""

    def __init__(self, priv: bytes | None = None):
        self._priv = priv or x25519_private()
        self.public = _pub_bytes(self._priv)
        self.node_id = node_id(self.public)

    @classmethod
    def from_seed(cls, seed: bytes) -> "Identity":
        """Deterministic identity (tests / stable node keys on disk); the
        same derivation as the JAX package's, so a seed names one node id
        in both."""
        return cls(hashlib.sha256(b"lighthouse-tpu-node-key" + seed).digest())


def node_id(static_pub: bytes) -> str:
    return hashlib.sha256(static_pub).hexdigest()[:40]


class CipherState:
    """One direction of the transport: AEAD key + counter nonce."""

    __slots__ = ("_aead", "_n")

    def __init__(self, key: bytes):
        self._aead = ChaCha20Poly1305(key)
        self._n = 0

    def _nonce(self) -> bytes:
        n = struct.pack("<4xQ", self._n)
        self._n += 1
        if self._n >= 2**64 - 1:
            raise HandshakeError("nonce exhausted")
        return n

    def encrypt(self, plaintext: bytes, ad: bytes = b"") -> bytes:
        return self._aead.encrypt(self._nonce(), plaintext, ad)

    def decrypt(self, ciphertext: bytes, ad: bytes = b"") -> bytes:
        try:
            return self._aead.decrypt(self._nonce(), ciphertext, ad)
        except InvalidTag as e:
            raise HandshakeError("AEAD authentication failed") from e


class _Symmetric:
    """Noise SymmetricState (spec §5.2), SHA-256 / ChaChaPoly."""

    def __init__(self):
        self.h = hashlib.sha256(PROTOCOL_NAME).digest()
        self.ck = self.h
        self._cipher: CipherState | None = None

    def mix_hash(self, data: bytes) -> None:
        self.h = hashlib.sha256(self.h + data).digest()

    def mix_key(self, ikm: bytes) -> None:
        self.ck, k = _hkdf2(self.ck, ikm)
        self._cipher = CipherState(k)

    def encrypt_and_hash(self, plaintext: bytes) -> bytes:
        if self._cipher is None:
            ct = plaintext
        else:
            ct = self._cipher.encrypt(plaintext, ad=self.h)
        self.mix_hash(ct)
        return ct

    def decrypt_and_hash(self, ct: bytes) -> bytes:
        if self._cipher is None:
            pt = ct
        else:
            pt = self._cipher.decrypt(ct, ad=self.h)
        self.mix_hash(ct)
        return pt

    def split(self) -> tuple[CipherState, CipherState]:
        k1, k2 = _hkdf2(self.ck, b"")
        return CipherState(k1), CipherState(k2)


def _send_msg(sock, payload: bytes) -> None:
    sock.sendall(struct.pack("<H", len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise HandshakeError("connection closed during handshake")
        buf += chunk
    return buf


def _recv_msg(sock) -> bytes:
    (ln,) = struct.unpack("<H", _recv_exact(sock, 2))
    return _recv_exact(sock, ln)


class Session:
    """Completed handshake: per-direction cipher states + remote identity."""

    __slots__ = ("send", "recv", "remote_static", "remote_node_id")

    def __init__(self, send: CipherState, recv: CipherState, remote_static: bytes):
        self.send = send
        self.recv = recv
        self.remote_static = remote_static
        self.remote_node_id = node_id(remote_static)


def handshake_initiator(sock, identity: Identity) -> Session:
    """XX initiator: -> e ; <- e, ee, s, es ; -> s, se."""
    sym = _Symmetric()
    sym.mix_hash(b"")  # empty prologue
    e = x25519_private()
    e_pub = _pub_bytes(e)

    # -> e
    sym.mix_hash(e_pub)
    _send_msg(sock, e_pub)

    # <- e, ee, s, es
    msg2 = _recv_msg(sock)
    if len(msg2) != DHLEN + DHLEN + TAGLEN:
        raise HandshakeError("bad handshake message 2")
    re_pub, ct_s = msg2[:DHLEN], msg2[DHLEN:]
    sym.mix_hash(re_pub)
    sym.mix_key(_dh(e, re_pub))                    # ee
    rs_pub = sym.decrypt_and_hash(ct_s)            # s
    sym.mix_key(_dh(e, rs_pub))                    # es (initiator: DH(e, rs))

    # -> s, se
    ct_si = sym.encrypt_and_hash(identity.public)  # s
    sym.mix_key(_dh(identity._priv, re_pub))       # se (initiator: DH(s, re))
    _send_msg(sock, ct_si)

    send, recv = sym.split()
    return Session(send, recv, rs_pub)


def handshake_responder(sock, identity: Identity) -> Session:
    sym = _Symmetric()
    sym.mix_hash(b"")
    e = x25519_private()
    e_pub = _pub_bytes(e)

    # <- e
    msg1 = _recv_msg(sock)
    if len(msg1) != DHLEN:
        raise HandshakeError("bad handshake message 1")
    re_pub = msg1
    sym.mix_hash(re_pub)

    # -> e, ee, s, es
    sym.mix_hash(e_pub)
    sym.mix_key(_dh(e, re_pub))                    # ee
    ct_s = sym.encrypt_and_hash(identity.public)   # s
    sym.mix_key(_dh(identity._priv, re_pub))       # es (responder: DH(s, re))
    _send_msg(sock, e_pub + ct_s)

    # <- s, se
    msg3 = _recv_msg(sock)
    if len(msg3) != DHLEN + TAGLEN:
        raise HandshakeError("bad handshake message 3")
    rs_pub = sym.decrypt_and_hash(msg3)            # s
    sym.mix_key(_dh(e, rs_pub))                    # se (responder: DH(e, rs))

    recv_c, send_c = sym.split()  # initiator's send is our recv
    return Session(send_c, recv_c, rs_pub)
