"""Peer discovery: random-walk address learning + target-count
maintenance — the transport-native replacement for the reference's
discv5 service (``lighthouse_network/src/discovery/``; same role:
keep the node at its target peer count by continuously learning and
dialing new addresses, not just the boot nodes).

The walk piggybacks on the peer-exchange RPC: every round below target,
one random connected peer is asked for its peer list; unknown addresses
enter the table and get dialed until the target is met. The address
table is exportable/importable so a restarting node can re-bootstrap
from the peers it knew (the analogue of persisted ENRs).
"""

from __future__ import annotations

import json
import random
import threading
import time


class Discovery:
    TARGET_PEERS = 16
    MAX_TABLE = 512
    WALK_INTERVAL_S = 10.0

    def __init__(self, service):
        self.service = service
        self._lock = threading.Lock()
        # (host, port) -> monotonic last-seen
        self.table: dict[tuple[str, int], float] = {}
        # (host, port) -> consecutive dial failures
        self._fails: dict[tuple[str, int], int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> "Discovery":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    # -- address table ---------------------------------------------------

    FAIL_EVICT = 3  # consecutive dial failures before an address is dropped

    def learn(self, host: str, port: int) -> None:
        # self-filter on (host, port): a REMOTE node on the same port
        # number must still be learnable
        if port == self.service.port and host in (
            "127.0.0.1", "localhost", self.service.transport.host,
        ):
            return
        with self._lock:
            if (host, port) not in self.table and len(self.table) >= self.MAX_TABLE:
                # evict the stalest entry
                oldest = min(self.table, key=self.table.get)
                del self.table[oldest]
            self.table[(host, int(port))] = time.monotonic()
            self._fails.pop((host, int(port)), None)

    def learn_from_px(self, raw: bytes) -> None:
        """Parse one peer-exchange response (the single copy of the wire
        format both the handshake and the walk use)."""
        try:
            for host, port in json.loads(raw):
                if port:
                    self.learn(str(host), int(port))
        except (ValueError, TypeError):
            pass

    def addresses(self) -> list[list]:
        with self._lock:
            return [[h, p] for (h, p) in self.table]

    def import_addresses(self, addrs) -> None:
        for h, p in addrs:
            self.learn(str(h), int(p))

    # -- the walk --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.WALK_INTERVAL_S):
            try:
                self.round()
            except Exception:
                pass

    def round(self) -> int:
        """One maintenance round; returns the number of dials made."""
        transport = self.service.transport
        need = self.TARGET_PEERS - transport.peer_count()
        if need <= 0:
            return 0
        from .service import PROTO_PEER_EXCHANGE

        peers = transport.peers_snapshot()
        if peers:
            # the PX walk runs off the round's critical path: a slow peer
            # (timeout 2s) must not delay the maintenance dials below —
            # its addresses simply feed the NEXT round
            target = random.choice(peers)

            def _walk():
                raw = target.request(
                    PROTO_PEER_EXCHANGE.encode(), b"[]", timeout=2
                )
                if raw:
                    self.learn_from_px(raw)

            threading.Thread(target=_walk, daemon=True).start()
        connected = {
            (p.addr[0], p.remote_listen_port)
            for p in peers
            if p.remote_listen_port
        }
        dials = 0
        attempts = 0
        candidates = [a for a in self.addresses() if tuple(a) not in connected]
        random.shuffle(candidates)
        for host, port in candidates:
            # bound the round: failed dials block up to the connect
            # timeout each, so they count toward the attempt budget
            if dials >= need or attempts >= need + 3 or self._stop.is_set():
                break
            attempts += 1
            if self.service.connect(host, port) is not None:
                dials += 1
                continue
            with self._lock:
                key = (host, int(port))
                self._fails[key] = self._fails.get(key, 0) + 1
                if self._fails[key] >= self.FAIL_EVICT:
                    self.table.pop(key, None)
                    self._fails.pop(key, None)
        return dials
