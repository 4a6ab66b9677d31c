"""Peer scoring + req/resp rate limiting (reference:
``lighthouse_network/src/service/gossipsub_scoring_parameters.rs:56-83``
for the score shape — decaying penalties with greylist/disconnect
thresholds — and ``rpc/rate_limiter.rs:59`` for the per-protocol token
buckets).

The transport trusts nobody: every inbound gossip frame and RPC request
passes through the PeerManager first; verification failures reported by
the BeaconProcessor feed back as penalties. A peer whose score sinks
below ``BAN_THRESHOLD`` is disconnected and its address refused on
re-dial until the ban decays.
"""

from __future__ import annotations

import threading
import time

from ..utils import flight_recorder, logging, metrics

_PENALTIES = metrics.counter(
    "network_peer_penalties_total", "scoring penalties applied"
)
_BANS = metrics.counter("network_peer_bans_total", "peers banned")
_RATE_LIMITED = metrics.counter(
    "network_rate_limited_total", "requests dropped by rate limiting"
)

# Offence weights (shape follows the reference's P4 invalid-message
# penalty dominating the score).
OFFENCES = {
    "invalid_message": -10.0,   # signature/structural verification failed
    "undecodable": -4.0,        # bytes that do not decode at all
    "rate_limit": -2.0,         # token bucket exceeded
    "protocol": -6.0,           # malformed RPC / unknown protocol abuse
}

DISCONNECT_THRESHOLD = -20.0   # peer gets disconnected
BAN_THRESHOLD = -40.0          # address refused on re-dial
SCORE_HALFLIFE_S = 60.0        # exponential decay toward 0
BAN_DURATION_S = 300.0


class TokenBucket:
    """Leaky token bucket: ``rate`` tokens/s, burst up to ``capacity``."""

    __slots__ = ("capacity", "rate", "tokens", "_last")

    def __init__(self, capacity: float, rate: float):
        self.capacity = float(capacity)
        self.rate = float(rate)
        self.tokens = float(capacity)
        self._last = time.monotonic()

    def allow(self, cost: float = 1.0) -> bool:
        now = time.monotonic()
        self.tokens = min(
            self.capacity, self.tokens + (now - self._last) * self.rate
        )
        self._last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


# Per-protocol-class request budgets (reference rate_limiter.rs quotas:
# expensive by-range requests get small budgets, pings large ones).
DEFAULT_RPC_QUOTAS = {
    "blocks_by_range": (16, 2.0),
    "blocks_by_root": (32, 4.0),
    "status": (8, 1.0),
    "ping": (16, 2.0),
    "default": (64, 8.0),
}
GOSSIP_QUOTA = (512, 128.0)  # frames (burst, per-second)


class _PeerState:
    __slots__ = ("score", "buckets", "gossip_bucket", "_last_decay")

    def __init__(self):
        self.score = 0.0
        self.buckets: dict[str, TokenBucket] = {}
        self.gossip_bucket = TokenBucket(*GOSSIP_QUOTA)
        self._last_decay = time.monotonic()

    def decay(self) -> None:
        now = time.monotonic()
        dt = now - self._last_decay
        if dt > 0.0:
            self.score *= 0.5 ** (dt / SCORE_HALFLIFE_S)
            self._last_decay = now


def _rpc_class(protocol: str) -> str:
    for key in DEFAULT_RPC_QUOTAS:
        if key in protocol:
            return key
    return "default"


class PeerManager:
    MAX_TRACKED = 4096

    def __init__(self, quotas: dict | None = None):
        # merge so a partial override cannot KeyError an unnamed class
        self.quotas = {**DEFAULT_RPC_QUOTAS, **(quotas or {})}
        self._lock = threading.Lock()
        # Scores are keyed by the peer's NOISE IDENTITY (hash of its
        # static key, Peer.node_id) — unforgeable without the private key,
        # so a misbehaving peer that reconnects resumes its decayed score
        # under the same identity, like the reference peerdb's
        # PeerId-keyed records. Minting a fresh keypair buys a fresh
        # score (sybil), which the reference accepts too; the IP is kept
        # as fallback for identity-less callers (unit tests).
        self._peers: dict[str, _PeerState] = {}
        self._banned: dict[str, float] = {}          # ban key -> expiry
        self.on_disconnect = lambda peer: None       # set by the service
        self.ban_key = (
            lambda peer: getattr(peer, "node_id", None) or peer.addr[0]
        )

    # -- lifecycle -------------------------------------------------------

    def _state(self, peer) -> _PeerState:
        key = self.ban_key(peer)
        st = self._peers.get(key)
        if st is None:
            if len(self._peers) >= self.MAX_TRACKED:
                # evict decayed/benign entries; tracked state is bounded
                stale = []
                for k, s in self._peers.items():
                    s.decay()
                    if s.score > -1.0:
                        stale.append(k)
                for k in stale:
                    del self._peers[k]
            st = self._peers[key] = _PeerState()
        return st

    def is_banned(self, key: str) -> bool:
        with self._lock:
            expiry = self._banned.get(key)
            if expiry is None:
                return False
            if time.monotonic() > expiry:
                del self._banned[key]
                return False
            return True

    def score(self, peer) -> float:
        with self._lock:
            st = self._state(peer)
            st.decay()
            return st.score

    # -- admission -------------------------------------------------------

    def allow_gossip(self, peer) -> bool:
        with self._lock:
            st = self._state(peer)
            if not st.gossip_bucket.allow():
                _RATE_LIMITED.inc()
                self._penalize_locked(peer, st, "rate_limit")
                return False
            return True

    def allow_request(self, peer, protocol: str) -> bool:
        cls = _rpc_class(protocol)
        with self._lock:
            st = self._state(peer)
            bucket = st.buckets.get(cls)
            if bucket is None:
                bucket = st.buckets[cls] = TokenBucket(*self.quotas[cls])
            if not bucket.allow():
                _RATE_LIMITED.inc()
                self._penalize_locked(peer, st, "rate_limit")
                return False
            return True

    # -- scoring ---------------------------------------------------------

    def report(self, peer, offence: str) -> None:
        """Apply a penalty; disconnect/ban when thresholds are crossed."""
        with self._lock:
            st = self._state(peer)
            self._penalize_locked(peer, st, offence)

    def _penalize_locked(self, peer, st: _PeerState, offence: str) -> None:
        st.decay()
        st.score += OFFENCES[offence]
        _PENALTIES.inc()
        flight_recorder.record(
            "peer_penalty", peer=self.ban_key(peer), offence=offence,
            score=round(st.score, 3),
        )
        if st.score <= BAN_THRESHOLD:
            key = self.ban_key(peer)
            if key and key not in self._banned:
                self._banned[key] = time.monotonic() + BAN_DURATION_S
                _BANS.inc()
                flight_recorder.record(
                    "peer_ban", peer=key, score=round(st.score, 3),
                    offence=offence, duration_s=BAN_DURATION_S,
                )
                logging.log("warn", "peer banned", peer=key,
                            score=st.score, offence=offence)
        if st.score <= DISCONNECT_THRESHOLD:
            # callback outside the lock would be cleaner, but peer.close()
            # only flags + closes a socket — no re-entry into the manager
            self.on_disconnect(peer)
