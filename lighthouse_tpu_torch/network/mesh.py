"""Gossipsub-style mesh control (reference:
``lighthouse_network/src/service/`` gossipsub behaviour + the degree
parameters in ``gossipsub_scoring_parameters.rs``).

Per-topic overlay meshes with degree targets: a heartbeat GRAFTs the
highest-scoring peers into under-full meshes and PRUNEs the
lowest-scoring out of over-full ones; relayed messages are forwarded to
mesh members only. Originated messages are flood-published (the
reference enables flood-publish for its latency-critical topics), so
mesh state bounds RELAY fan-out without ever gating first-hop delivery.

Control wire: a direct (non-flooded) gossip frame on the reserved topic
``_ctl`` with payload ``b"G"``/``b"P"`` + topic bytes — the
multistream-free analogue of gossipsub's GRAFT/PRUNE control messages.

IHAVE/IWANT repair (gossipsub's lazy-pull leg): each heartbeat sends a
digest of recently relayed message ids per topic to a few NON-mesh
peers (``b"H"`` + topic-length + topic + 20-byte ids); a peer missing
any of them pulls with ``b"W"`` + ids and receives the full frames.
Without this, a peer whose GRAFTs were all refused (remote meshes at
D_HIGH) would only ever see first-hop flood-published messages.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque

from .transport import KIND_GOSSIP

CTL_TOPIC = "_ctl"
GRAFT = b"G"
PRUNE = b"P"
IHAVE = b"H"
IWANT = b"W"

MSG_ID_LEN = 20


class MeshRouter:
    # degree targets sized for the in-process simulators (reference
    # mainnet: D=8, D_low=6, D_high=12)
    D_LOW = 2
    D = 4
    D_HIGH = 8
    MAX_TOPICS = 256          # locally-tracked topics (subnets x forks fit)
    PRUNE_BACKOFF_S = 30.0    # gossipsub prune backoff analogue
    GOSSIP_LAZY = 3           # non-mesh peers receiving IHAVE per heartbeat
    MCACHE_CAP = 512          # retained full messages for IWANT service
    MCACHE_MAX_BYTES = 8 << 20  # byte budget (block frames can be large)
    IHAVE_MAX_IDS = 16        # digest size bound (also caps IWANT replies)
    IHAVE_WINDOW_S = 30.0     # only advertise recent ids (gossipsub's
    #                           ~3-heartbeat history window analogue)

    def __init__(self, service):
        self.service = service
        self._lock = threading.Lock()
        # topic -> set of grafted peers; keys created ONLY by track()
        # (recognized local topics), never by remote control frames
        self.mesh: dict[str, set] = {}
        # (id(peer), topic) -> monotonic time until which GRAFT is banned
        self._backoff: dict[tuple[int, str], float] = {}
        # message cache for the IHAVE/IWANT pull leg: id -> (topic,
        # payload, monotonic); bounded by count AND bytes
        self._mcache: OrderedDict[bytes, tuple[str, bytes, float]] = OrderedDict()
        self._mcache_bytes = 0
        # topic -> recent (message id, monotonic) for IHAVE digests
        self._recent: dict[str, deque] = {}

    # -- routing ---------------------------------------------------------

    def relay_peers(self, topic: str, exclude=None) -> list | None:
        """Peers to forward a RELAYED message on ``topic`` to (sender
        already removed), or None to flood (mesh too thin — the sender
        does not count toward the delivery-trust threshold)."""
        with self._lock:
            members = [
                p for p in self.mesh.get(topic, ())
                if not p.closed and p is not exclude
            ]
        if len(members) < self.D_LOW:
            return None
        return members

    # -- control ---------------------------------------------------------

    def remember(self, topic: str, msg_id: bytes, payload: bytes) -> None:
        """Cache a published/relayed message so IWANT can serve it and the
        next heartbeat's IHAVE digests advertise it."""
        import time as _time

        if len(topic.encode()) > 255:
            return  # digest frames carry a 1-byte topic length
        now = _time.monotonic()
        with self._lock:
            old = self._mcache.pop(msg_id, None)
            if old is not None:
                self._mcache_bytes -= len(old[1])
            self._mcache[msg_id] = (topic, payload, now)
            self._mcache_bytes += len(payload)
            while self._mcache and (
                len(self._mcache) > self.MCACHE_CAP
                or self._mcache_bytes > self.MCACHE_MAX_BYTES
            ):
                _, (_, old_payload, _) = self._mcache.popitem(last=False)
                self._mcache_bytes -= len(old_payload)
            dq = self._recent.get(topic)
            if dq is None:
                if len(self._recent) >= self.MAX_TOPICS:
                    return
                dq = self._recent[topic] = deque(maxlen=self.IHAVE_MAX_IDS)
            dq.append((msg_id, now))

    def on_control(self, peer, payload: bytes) -> None:
        if not payload:
            return
        import time as _time

        action = payload[:1]
        if action == IHAVE:
            return self._on_ihave(peer, payload[1:])
        if action == IWANT:
            return self._on_iwant(peer, payload[1:])
        topic = payload[1:].decode(errors="replace")
        send_refusal = False
        with self._lock:
            members = self.mesh.get(topic)
            if members is None:
                # unknown topic: refuse — remote control frames must not
                # create mesh state (junk-topic contamination would
                # propagate via heartbeats otherwise)
                if action == GRAFT:
                    send_refusal = True
            elif action == GRAFT:
                if len(members) >= self.D_HIGH and peer not in members:
                    send_refusal = True  # full: refuse symmetrically
                else:
                    members.add(peer)
            elif action == PRUNE:
                members.discard(peer)
                self._backoff[(id(peer), topic)] = (
                    _time.monotonic() + self.PRUNE_BACKOFF_S
                )
        if send_refusal:
            self._send_ctl(peer, PRUNE, topic)

    def _send_ctl(self, peer, action: bytes, topic: str) -> None:
        try:
            peer.send(KIND_GOSSIP, CTL_TOPIC.encode(), action + topic.encode())
        except Exception:
            pass

    # -- IHAVE / IWANT ---------------------------------------------------

    def _on_ihave(self, peer, body: bytes) -> None:
        """b"H" + tlen(1) + topic + ids: pull any ids we have not seen."""
        if not body:
            return
        tlen = body[0]
        ids_raw = body[1 + tlen:]
        ids = [
            ids_raw[i : i + MSG_ID_LEN]
            for i in range(0, len(ids_raw), MSG_ID_LEN)
        ][: self.IHAVE_MAX_IDS]
        missing = [m for m in ids if len(m) == MSG_ID_LEN
                   and not self.service.has_seen(m)]
        if missing:
            try:
                peer.send(
                    KIND_GOSSIP, CTL_TOPIC.encode(), IWANT + b"".join(missing)
                )
            except Exception:
                pass

    def _on_iwant(self, peer, body: bytes) -> None:
        """b"W" + ids: serve cached full messages as normal gossip frames
        (the receiver dedups through its seen-cache like any gossip)."""
        ids = [
            body[i : i + MSG_ID_LEN] for i in range(0, len(body), MSG_ID_LEN)
        ][: self.IHAVE_MAX_IDS]
        with self._lock:
            hits = [self._mcache.get(m) for m in ids]
        for hit in hits:
            if hit is None:
                continue
            topic, payload, _ts = hit
            try:
                peer.send(KIND_GOSSIP, topic.encode(), payload)
            except Exception:
                pass

    def track(self, topic: str) -> None:
        """Make ``topic`` mesh-managed (called on first publish or first
        RECOGNIZED receive — callers validate the topic)."""
        if topic == CTL_TOPIC:
            return
        with self._lock:
            if topic not in self.mesh and len(self.mesh) >= self.MAX_TOPICS:
                return  # bounded; overflow topics just flood
            self.mesh.setdefault(topic, set())

    # -- maintenance -----------------------------------------------------

    def heartbeat(self) -> None:
        """Degree maintenance (gossipsub heartbeat analogue): drop closed
        peers, GRAFT the best-scoring non-members up to D, PRUNE the
        worst-scoring members down to D when above D_HIGH."""
        transport = self.service.transport
        pm = self.service.peer_manager
        all_peers = transport.peers_snapshot()
        with self._lock:
            topics = list(self.mesh.keys())
        for topic in topics:
            with self._lock:
                members = {p for p in self.mesh.get(topic, ()) if not p.closed}
                self.mesh[topic] = members
                current = set(members)
            if len(current) < self.D:
                import time as _time

                now = _time.monotonic()
                with self._lock:
                    self._backoff = {
                        k: t for k, t in self._backoff.items() if t > now
                    }
                    backoff = dict(self._backoff)
                candidates = sorted(
                    (
                        p for p in all_peers
                        if p not in current
                        and not p.closed
                        and backoff.get((id(p), topic), 0) <= now
                    ),
                    key=lambda p: pm.score(p),
                    reverse=True,
                )
                for p in candidates[: self.D - len(current)]:
                    with self._lock:
                        self.mesh[topic].add(p)
                    self._send_ctl(p, GRAFT, topic)
            elif len(current) > self.D_HIGH:
                victims = sorted(current, key=lambda p: pm.score(p))
                for p in victims[: len(current) - self.D]:
                    with self._lock:
                        self.mesh[topic].discard(p)
                    self._send_ctl(p, PRUNE, topic)
            # lazy-pull leg: advertise recent ids to a few NON-mesh peers
            # so a peer kept out of every mesh (all GRAFTs refused) still
            # learns of — and can pull — relayed messages
            tb = topic.encode()
            if len(tb) > 255:
                continue  # remember() filters these too; belt-and-braces
            import time as _time2

            cutoff = _time2.monotonic() - self.IHAVE_WINDOW_S
            with self._lock:
                dq = self._recent.get(topic)
                ids = [m for m, ts in dq if ts > cutoff] if dq else []
            if not ids:
                continue
            import random as _random

            outsiders = [
                p for p in all_peers if p not in current and not p.closed
            ]
            digest = (
                IHAVE + bytes([len(tb)]) + tb
                + b"".join(ids[-self.IHAVE_MAX_IDS:])
            )
            for p in _random.sample(
                outsiders, min(self.GOSSIP_LAZY, len(outsiders))
            ):
                try:
                    p.send(KIND_GOSSIP, CTL_TOPIC.encode(), digest)
                except Exception:
                    pass

    def remove_peer(self, peer) -> None:
        with self._lock:
            for members in self.mesh.values():
                members.discard(peer)
