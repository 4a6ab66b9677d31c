"""TCP transport: Noise-encrypted, framed, snappy-compressed messages.

Reference: ``beacon_node/lighthouse_network`` — libp2p over TCP with a
Noise session layer, gossipsub (snappy-compressed SSZ payloads) and
SSZ-snappy req/resp (``src/rpc/protocol.rs:143-220``, codec
``rpc/codec/ssz_snappy.rs``).

This transport keeps the reference's WIRE SEMANTICS (topic strings,
SSZ-snappy payloads, request/response protocol names) over a simple
length-prefixed TCP framing instead of libp2p's multistream negotiation.
Every connection starts with a **Noise XX handshake** (``noise.py``):
mutual static-key authentication, after which each frame is sealed
end-to-end:

    wire  := u32-le ct_len | AEAD(frame)
    frame := u8 kind | u16-le name_len | u32-le req_id | name | payload

kind: 0 = gossip publish (name = topic, req_id = 0), 1 = rpc request,
2 = rpc response (req_id echoes the request so late responses can never
be mis-delivered to a newer request). Payloads are snappy raw blocks.
``Peer.node_id`` (hash of the remote static key) is the identity peer
scoring and bans key on — spoofing it requires the private key.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils import snappy
from . import noise

KIND_GOSSIP = 0
KIND_REQUEST = 1
KIND_RESPONSE = 2

_HDR = struct.Struct("<BHI")
_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 24  # 16 MiB ceiling, like the reference's max_chunk_size
MAX_INFLIGHT_HANDLERS = 4  # concurrent request handlers per peer
HANDSHAKE_TIMEOUT_S = 5.0


class Peer:
    """One authenticated remote; owns the socket + reader thread. Created
    only AFTER the Noise handshake succeeded (``session``)."""

    def __init__(self, sock: socket.socket, addr, on_frame, on_close,
                 session: noise.Session):
        self.sock = sock
        self.addr = addr
        self.session = session
        self.node_id = session.remote_node_id
        self.remote_listen_port: Optional[int] = None
        self._on_frame = on_frame
        self._on_close = on_close
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._req_counter = 0
        # rid -> [event, response]: any number of outstanding requests
        # (reference multiplexes substreams, rpc/protocol.rs:143-220)
        self._pending: dict[int, list] = {}
        self._inflight_handlers = 0  # server-side, capped per peer
        self._closed = False
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    # -- sending ---------------------------------------------------------

    def send(self, kind: int, name: bytes, payload: bytes, req_id: int = 0) -> bool:
        comp = snappy.compress_raw(payload)
        frame = _HDR.pack(kind, len(name), req_id) + name + comp
        try:
            # encrypt INSIDE the lock: the AEAD nonce is a strict counter,
            # so ciphertexts must hit the socket in encryption order
            with self._send_lock:
                ct = self.session.send.encrypt(frame)
                self.sock.sendall(_LEN.pack(len(ct)) + ct)
            return True
        except (OSError, noise.HandshakeError):
            self.close()
            return False

    @property
    def closed(self) -> bool:
        return self._closed

    # -- server-side handler accounting ----------------------------------

    def try_begin_handler(self) -> bool:
        """Reserve a request-handler slot; False when the per-peer cap is
        reached (caller should answer busy rather than queue unboundedly)."""
        with self._state_lock:
            if self._inflight_handlers >= MAX_INFLIGHT_HANDLERS:
                return False
            self._inflight_handlers += 1
            return True

    def end_handler(self) -> None:
        with self._state_lock:
            self._inflight_handlers -= 1

    def request(self, protocol: bytes, payload: bytes, timeout: float = 10.0) -> Optional[bytes]:
        """Any number of concurrent in-flight requests per peer, matched
        by request id (the reference multiplexes substreams the same way;
        single-flight serialization head-of-line-blocked range sync vs
        backfill vs lookups). A late answer to a
        timed-out request is dropped instead of satisfying a newer one."""
        ev = threading.Event()
        entry = [ev, None]
        with self._state_lock:
            self._req_counter += 1
            rid = self._req_counter
            self._pending[rid] = entry
        if not self.send(KIND_REQUEST, protocol, payload, req_id=rid):
            with self._state_lock:
                self._pending.pop(rid, None)
            return None
        ok = ev.wait(timeout)
        with self._state_lock:
            self._pending.pop(rid, None)
        # read from the LOCAL entry: a response recorded just before the
        # peer closed must still be delivered (close() swaps the dict)
        return entry[1] if ok else None

    # -- receiving -------------------------------------------------------

    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _read_loop(self) -> None:
        try:
            while True:
                ln_raw = self._read_exact(_LEN.size)
                if ln_raw is None:
                    break
                (ct_len,) = _LEN.unpack(ln_raw)
                if ct_len > MAX_FRAME or ct_len < _HDR.size + noise.TAGLEN:
                    break
                ct = self._read_exact(ct_len)
                if ct is None:
                    break
                try:
                    frame = self.session.recv.decrypt(ct)
                except noise.HandshakeError:
                    break  # tampered/replayed ciphertext: kill the session
                kind, name_len, req_id = _HDR.unpack(frame[: _HDR.size])
                body = frame[_HDR.size:]
                if name_len > len(body):
                    break
                name = body[:name_len]
                try:
                    payload = snappy.decompress_raw(body[name_len:])
                except snappy.SnappyError:
                    continue
                if kind == KIND_RESPONSE:
                    with self._state_lock:
                        entry = self._pending.get(req_id)
                        if entry is not None:
                            entry[1] = payload
                            entry[0].set()
                        # else: stale response for a timed-out request — drop
                else:
                    self._on_frame(self, kind, name, payload, req_id)
        except OSError:
            pass
        finally:
            self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass
        # wake every waiter immediately (response stays None) instead of
        # letting each ride out its full timeout on a dead peer
        with self._state_lock:
            pending, self._pending = self._pending, {}
        for ev, _ in pending.values():
            ev.set()
        self._on_close(self)


class Transport:
    """Listener + authenticated peer set. ``on_gossip(peer, topic,
    payload)``, ``on_request(peer, protocol, payload) -> bytes``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 identity: noise.Identity | None = None):
        self.identity = identity or noise.Identity()
        self.node_id = self.identity.node_id
        self.on_gossip: Callable = lambda *a: None
        self.on_request: Callable = lambda *a: b""
        self.on_peer_connected: Callable = lambda peer: None
        self.on_peer_removed: Callable = lambda peer: None
        self._server = socket.create_server((host, port))
        self.host = host
        self.port = self._server.getsockname()[1]
        self.peers: list[Peer] = []
        self._lock = threading.Lock()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._running = True
        self._accept_thread.start()

    # -- peer management -------------------------------------------------

    def dial(self, host: str, port: int) -> Optional[Peer]:
        if not self._running:
            return None  # a closed transport must not open new sockets
        with self._lock:
            for p in self.peers:
                if p.remote_listen_port == port and p.addr[0] == host:
                    return p
        try:
            sock = socket.create_connection((host, port), timeout=5)
        except OSError:
            return None
        try:
            sock.settimeout(HANDSHAKE_TIMEOUT_S)
            session = noise.handshake_initiator(sock, self.identity)
            # the handshake timeout must not linger: it would turn any 5s
            # idle period into a recv timeout that kills the connection
            sock.settimeout(None)
        except (OSError, noise.HandshakeError):
            try:
                sock.close()  # a failed handshake must not leak the fd
            except OSError:
                pass
            return None
        if session.remote_node_id == self.node_id:
            sock.close()  # self-dial (or key reuse): refuse
            return None
        peer = self._add_peer(sock, (host, port), session)
        peer.remote_listen_port = port
        self.on_peer_connected(peer)
        return peer

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, addr = self._server.accept()
            except OSError:
                if not self._running:
                    return
                # transient accept error (e.g. ECONNABORTED from a reset
                # queued connection) must not kill the listener; back off
                # so persistent errors (fd exhaustion) cannot busy-spin
                time.sleep(0.05)
                continue
            # handshake runs off the accept loop: a stalling dialer must
            # not block further accepts (libp2p upgrades concurrently too)
            threading.Thread(
                target=self._handshake_inbound, args=(sock, addr), daemon=True
            ).start()

    def _handshake_inbound(self, sock: socket.socket, addr) -> None:
        try:
            sock.settimeout(HANDSHAKE_TIMEOUT_S)
            session = noise.handshake_responder(sock, self.identity)
            sock.settimeout(None)
        except (OSError, noise.HandshakeError):
            try:
                sock.close()
            except OSError:
                pass
            return
        if not self._running or session.remote_node_id == self.node_id:
            sock.close()
            return
        peer = self._add_peer(sock, addr, session)
        try:
            self.on_peer_connected(peer)
        except Exception:
            peer.close()  # a handler bug must not kill the accept path

    def _add_peer(self, sock: socket.socket, addr, session: noise.Session) -> Peer:
        peer = Peer(sock, addr, self._dispatch, self._remove_peer, session)
        with self._lock:
            self.peers.append(peer)
        return peer

    def _remove_peer(self, peer: Peer) -> None:
        with self._lock:
            if peer in self.peers:
                self.peers.remove(peer)
        try:
            self.on_peer_removed(peer)
        except Exception:
            pass  # a cleanup-hook bug must not break peer teardown

    def peer_count(self) -> int:
        with self._lock:
            return len(self.peers)

    def peers_snapshot(self) -> list:
        """Consistent copy of the peer list for out-of-loop consumers
        (discovery walk, metrics) — no reaching into ``_lock``."""
        with self._lock:
            return list(self.peers)

    # -- dispatch --------------------------------------------------------

    def _dispatch(self, peer: Peer, kind: int, name: bytes, payload: bytes, req_id: int) -> None:
        if kind == KIND_GOSSIP:
            self.on_gossip(peer, name.decode(), payload)
        elif kind == KIND_REQUEST:
            # handle off the read loop so concurrent requests from one
            # peer execute concurrently and never stall its gossip —
            # bounded PER PEER so (a) a request flood cannot queue
            # unbounded payloads (the old inline path's TCP backpressure
            # analogue) and (b) slow handlers for one peer never starve
            # another peer's requests (per-peer isolation, as when the
            # read loop itself served them)
            if not peer.try_begin_handler():
                # busy: answer empty immediately (the reference returns an
                # RPC error) so the requester fails fast instead of riding
                # out its timeout
                peer.send(KIND_RESPONSE, name, b"", req_id=req_id)
                return
            threading.Thread(
                target=self._handle_request,
                args=(peer, name, payload, req_id),
                daemon=True,
            ).start()

    def _handle_request(self, peer: Peer, name: bytes, payload: bytes, req_id: int) -> None:
        try:
            try:
                resp = self.on_request(peer, name.decode(), payload)
            except Exception:
                resp = b""
            peer.send(KIND_RESPONSE, name, resp or b"", req_id=req_id)
        finally:
            peer.end_handler()

    # -- broadcast -------------------------------------------------------

    def publish(self, topic: str, payload: bytes, exclude: Peer | None = None) -> int:
        n = 0
        with self._lock:
            targets = list(self.peers)
        for p in targets:
            if p is exclude:
                continue
            if p.send(KIND_GOSSIP, topic.encode(), payload):
                n += 1
        return n

    def close(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            peers = list(self.peers)
        for p in peers:
            p.close()
