"""Network service: gossip topics, req/resp protocols, peer exchange,
router into the BeaconProcessor, and range sync.

Reference mapping:

* topics mirror ``lighthouse_network/src/types/topics.rs:47-72``:
  ``/eth2/{fork_digest}/beacon_block/ssz_snappy``,
  ``.../beacon_aggregate_and_proof/...``,
  ``.../beacon_attestation_{subnet}/...``, voluntary_exit, slashings;
* req/resp protocols mirror ``rpc/protocol.rs:143-155``: status, goodbye,
  ping, metadata, beacon_blocks_by_range, beacon_blocks_by_root;
* the Router + work queues mirror ``network/src/router`` +
  ``beacon_processor`` (gossip items become Work batches);
* discovery is peer-exchange over an extra ``peers`` protocol (discv5's
  niche: learning listen addresses of more peers) + static bootnodes;
* range sync mirrors ``network/src/sync/range_sync``: on a Status showing
  a peer ahead, batches of blocks_by_range feed CHAIN_SEGMENT work.
"""

from __future__ import annotations

import json
import struct
import threading
import time
from typing import Optional

from ..beacon_processor import BeaconProcessor, Work, WorkKind
from ..ssz import hash_tree_root
from ..state_transition.epoch import fork_of
from ..types.domains import compute_fork_digest
from ..utils import metrics
from .peer_manager import PeerManager
from .transport import KIND_GOSSIP, Peer, Transport

_GOSSIP_RX = metrics.counter("network_gossip_received_total")
_GOSSIP_TX = metrics.counter("network_gossip_published_total")
_SYNC_BATCHES = metrics.counter(
    "sync_range_batches_total", "range-sync batches fetched"
)
_SYNC_BLOCKS = metrics.counter(
    "sync_range_blocks_total", "blocks imported by range sync"
)
_BACKFILL_BLOCKS = metrics.counter(
    "sync_backfill_blocks_total", "blocks stored by backfill sync"
)
_LOOKUPS = metrics.counter(
    "sync_block_lookups_total", "parent-chain lookups started"
)
_LOOKUP_BLOCKS = metrics.counter(
    "sync_block_lookup_blocks_fetched_total", "blocks fetched by root"
)

ATTESTATION_SUBNET_COUNT = 64


class Topics:
    def __init__(self, fork_digest: bytes):
        self.prefix = f"/eth2/{fork_digest.hex()}"

    def block(self) -> str:
        return f"{self.prefix}/beacon_block/ssz_snappy"

    def aggregate(self) -> str:
        return f"{self.prefix}/beacon_aggregate_and_proof/ssz_snappy"

    def attestation(self, subnet: int) -> str:
        return f"{self.prefix}/beacon_attestation_{subnet}/ssz_snappy"

    def sync_committee(self, subnet: int) -> str:
        return f"{self.prefix}/sync_committee_{subnet}/ssz_snappy"

    def sync_contribution(self) -> str:
        return (
            f"{self.prefix}/sync_committee_contribution_and_proof/ssz_snappy"
        )

    def voluntary_exit(self) -> str:
        return f"{self.prefix}/voluntary_exit/ssz_snappy"

    def attester_slashing(self) -> str:
        return f"{self.prefix}/attester_slashing/ssz_snappy"

    def proposer_slashing(self) -> str:
        return f"{self.prefix}/proposer_slashing/ssz_snappy"


PROTO_STATUS = "/eth2/beacon_chain/req/status/1"
PROTO_GOODBYE = "/eth2/beacon_chain/req/goodbye/1"
PROTO_PING = "/eth2/beacon_chain/req/ping/1"
PROTO_METADATA = "/eth2/beacon_chain/req/metadata/1"
PROTO_BLOCKS_BY_RANGE = "/eth2/beacon_chain/req/beacon_blocks_by_range/1"
PROTO_BLOCKS_BY_ROOT = "/eth2/beacon_chain/req/beacon_blocks_by_root/1"
PROTO_PEER_EXCHANGE = "/eth2/beacon_chain/req/peers/1"


class NetworkService:
    """Wires a BeaconChain + BeaconProcessor to the transport."""

    def __init__(
        self,
        chain,
        processor: BeaconProcessor,
        host: str = "127.0.0.1",
        port: int = 0,
        subnets: Optional[set[int]] = None,
    ):
        self.chain = chain
        self.processor = processor
        self.subnets = subnets if subnets is not None else set(range(ATTESTATION_SUBNET_COUNT))
        gvr = bytes(chain.head_state.genesis_validators_root)
        # One Topics per scheduled fork: gossip is ACCEPTED for any of
        # them, PUBLISHED on the wall-clock epoch's digest, so nodes on
        # either side of a fork transition still exchange messages.
        self._topics_by_fork = {
            fork: Topics(compute_fork_digest(
                chain.spec, chain.spec.fork_version_for(fork), gvr
            ))
            for fork in ("phase0", "altair", "bellatrix")
        }
        self.transport = Transport(host, port)
        self.peer_manager = PeerManager()
        self.peer_manager.on_disconnect = lambda p: p.close()
        self._seen: dict[bytes, float] = {}  # gossip message-id dedup
        self._seen_lock = threading.Lock()
        from .mesh import MeshRouter

        self.mesh_router = MeshRouter(self)
        self._mesh_stop = threading.Event()
        self._mesh_thread = threading.Thread(
            target=self._mesh_heartbeat_loop, daemon=True
        )
        self._mesh_thread.start()
        self.sync = RangeSync(self)
        self.backfill = BackfillSync(self)
        self.lookups = BlockLookups(self)
        from .discovery import Discovery

        self.discovery = Discovery(self).start()
        # callbacks are wired LAST: the accept thread is live from the
        # Transport constructor, and an early inbound handshake must not
        # race attributes (sync/discovery/mesh) into AttributeErrors —
        # until here such peers just get the transport's no-op handlers
        self.transport.on_gossip = self._on_gossip
        self.transport.on_request = self._on_request
        self.transport.on_peer_connected = self._on_peer_connected
        self.transport.on_peer_removed = (
            lambda peer: self.mesh_router.remove_peer(peer)
        )
        # the HTTP API's /node/identity + /node/peers read this
        chain.network = self

    @property
    def topics(self) -> Topics:
        """Topics for the current wall-clock epoch's fork digest."""
        return self._topics_by_fork[
            self.chain.spec.fork_name_at_epoch(self.chain.epoch())
        ]

    # -- lifecycle -------------------------------------------------------

    @property
    def port(self) -> int:
        return self.transport.port

    def connect(self, host: str, port: int) -> Optional[Peer]:
        if self.peer_manager.is_banned(host):
            return None
        peer = self.transport.dial(host, port)
        if peer is not None:
            self.discovery.learn(host, port)
        return peer

    def close(self) -> None:
        self.discovery.stop()
        self._mesh_stop.set()
        self.transport.close()

    def _mesh_heartbeat_loop(self) -> None:
        # gossipsub heartbeat analogue (reference heartbeat_interval ~0.7s)
        while not self._mesh_stop.wait(1.0):
            try:
                self.mesh_router.heartbeat()
            except Exception:
                pass

    # -- gossip out ------------------------------------------------------

    def publish_block(self, signed_block) -> None:
        self._publish(self.topics.block(), type(signed_block).encode(signed_block))

    def publish_attestation(self, attestation, subnet: int) -> None:
        self._publish(
            self.topics.attestation(subnet % ATTESTATION_SUBNET_COUNT),
            type(attestation).encode(attestation),
        )

    def publish_aggregate(self, signed_aggregate) -> None:
        self._publish(
            self.topics.aggregate(), type(signed_aggregate).encode(signed_aggregate)
        )

    def publish_sync_committee_message(self, msg, subnet: int) -> None:
        self._publish(
            self.topics.sync_committee(
                subnet % self.chain.preset.SYNC_COMMITTEE_SUBNET_COUNT
            ),
            type(msg).encode(msg),
        )

    def publish_sync_contribution(self, signed_contribution) -> None:
        self._publish(
            self.topics.sync_contribution(),
            type(signed_contribution).encode(signed_contribution),
        )

    def publish_voluntary_exit(self, signed_exit) -> None:
        self._publish(
            self.topics.voluntary_exit(), type(signed_exit).encode(signed_exit)
        )

    def publish_attester_slashing(self, slashing) -> None:
        self._publish(
            self.topics.attester_slashing(), type(slashing).encode(slashing)
        )

    def publish_proposer_slashing(self, slashing) -> None:
        self._publish(
            self.topics.proposer_slashing(), type(slashing).encode(slashing)
        )

    def _publish(self, topic: str, payload: bytes) -> None:
        mid = self._msg_id(topic, payload)
        self._mark_seen(topic, payload, mid)
        _GOSSIP_TX.inc()
        # originated messages flood-publish (reference flood_publish for
        # latency-critical topics); the mesh bounds RELAY fan-out only
        self.mesh_router.track(topic)
        self.mesh_router.remember(topic, mid, payload)
        self.transport.publish(topic, payload)

    # -- gossip in -------------------------------------------------------

    def _msg_id(self, topic: str, payload: bytes) -> bytes:
        from ..ssz.sha256 import hash_bytes

        return hash_bytes(topic.encode() + payload)[:20]

    def _mark_seen(self, topic: str, payload: bytes, mid: bytes | None = None) -> bool:
        """True if already seen. Prunes entries older than 10 minutes.
        ``mid`` lets hot paths reuse an already-computed message id (the
        sha256 runs over the full payload — blocks are large)."""
        if mid is None:
            mid = self._msg_id(topic, payload)
        now = time.monotonic()
        with self._seen_lock:
            if mid in self._seen:
                return True
            self._seen[mid] = now
            if len(self._seen) > 1 << 16:
                cutoff = now - 600
                self._seen = {
                    k: ts for k, ts in self._seen.items() if ts > cutoff
                }
            return False

    def has_seen(self, msg_id: bytes) -> bool:
        """IHAVE digest check (mesh router): seen-cache membership by id."""
        with self._seen_lock:
            return msg_id in self._seen

    # Verification-failure kinds that are NOT the sender's fault (clock
    # skew, duplicates seen first from another peer, not-yet-synced heads)
    _BENIGN_KINDS = frozenset(
        {
            "PriorAttestationKnown",
            "AttestationAlreadyKnown",
            "AggregatorAlreadyKnown",
            "ContributionAlreadyKnown",
            "PriorMessageKnown",
            "OutsideSlotRange",
            "OutsideSlotWindow",
            "UnknownHeadBlock",
            "UnknownTargetRoot",
            "UnknownSyncCommittee",
            "ParentUnknown",
            "BlockIsAlreadyKnown",
            "RepeatProposal",
            "FutureSlot",
        }
    )

    def _feedback(self, peer: Peer):
        """Done-callback reporting invalid gossip back to the scorer
        (reference: the processor's invalid-message penalties feeding
        gossipsub peer scores)."""

        def done(result):
            kind = getattr(result, "kind", None)
            if (
                isinstance(result, Exception)
                and kind is not None
                and kind not in self._BENIGN_KINDS
            ):
                self.peer_manager.report(peer, "invalid_message")

        return done

    def _on_gossip(self, peer: Peer, topic: str, payload: bytes) -> None:
        from .mesh import CTL_TOPIC

        # rate limiting applies to control frames too: GRAFT/PRUNE spam
        # must hit the same token bucket + penalties as any gossip
        if not self.peer_manager.allow_gossip(peer):
            return  # rate-limited: dropped, not forwarded
        if topic == CTL_TOPIC:  # GRAFT/PRUNE control: per-link, not flooded
            self.mesh_router.on_control(peer, payload)
            return
        mid = self._msg_id(topic, payload)
        if self._mark_seen(topic, payload, mid):
            return
        _GOSSIP_RX.inc()
        t = self.chain.types
        # match against every scheduled fork's topic set
        kinds = {}
        for tp in self._topics_by_fork.values():
            kinds[tp.block()] = "block"
            kinds[tp.aggregate()] = "aggregate"
            kinds[tp.sync_contribution()] = "sync_contribution"
            kinds[tp.voluntary_exit()] = "voluntary_exit"
            kinds[tp.attester_slashing()] = "attester_slashing"
            kinds[tp.proposer_slashing()] = "proposer_slashing"
        kind = kinds.get(topic)
        if kind is None and "/beacon_attestation_" in topic:
            kind = "attestation"
        if kind is None and "/sync_committee_" in topic:
            kind = "sync_message"
        if kind is not None:
            # only RECOGNIZED topics become mesh-managed: junk topics from
            # a hostile peer must never enter (or propagate through) the
            # mesh control plane
            self.mesh_router.track(topic)
        fb = self._feedback(peer)
        try:
            if kind == "block":
                fork = fork_of(self.chain.head_state)
                sb = t.signed_block[fork].decode(payload)

                def block_done(result, _fb=fb, _sb=sb):
                    _fb(result)
                    self._after_block(result, _sb)

                self.processor.submit(
                    Work(WorkKind.GOSSIP_BLOCK, sb, done=block_done)
                )
            elif kind == "aggregate":
                sa = t.SignedAggregateAndProof.decode(payload)
                self.processor.submit(
                    Work(WorkKind.GOSSIP_AGGREGATE, sa, done=fb)
                )
            elif kind == "attestation":
                att = t.Attestation.decode(payload)
                self.processor.submit(
                    Work(WorkKind.GOSSIP_ATTESTATION, att, done=fb)
                )
            elif kind == "sync_message":
                sm = t.SyncCommitteeMessage.decode(payload)
                self.processor.submit(
                    Work(WorkKind.GOSSIP_SYNC_MESSAGE, sm, done=fb)
                )
            elif kind == "sync_contribution":
                sc = t.SignedContributionAndProof.decode(payload)
                self.processor.submit(
                    Work(WorkKind.GOSSIP_SYNC_CONTRIBUTION, sc, done=fb)
                )
            elif kind == "voluntary_exit":
                ex = t.SignedVoluntaryExit.decode(payload)
                if self.chain.op_pool is not None:
                    self.chain.op_pool.insert_voluntary_exit(ex)
            elif kind == "attester_slashing":
                sl = t.AttesterSlashing.decode(payload)
                if self.chain.op_pool is not None:
                    self.chain.op_pool.insert_attester_slashing(sl)
            elif kind == "proposer_slashing":
                sl = t.ProposerSlashing.decode(payload)
                if self.chain.op_pool is not None:
                    self.chain.op_pool.insert_proposer_slashing(sl)
            else:
                return
        except Exception:
            self.peer_manager.report(peer, "undecodable")
            return
        # relay to the topic mesh (flood fallback while the mesh is
        # thinner than D_low), minus the sender; remember the message so
        # heartbeat IHAVE digests let non-mesh peers pull it
        self.mesh_router.remember(topic, mid, payload)
        members = self.mesh_router.relay_peers(topic, exclude=peer)
        if members is None:
            self.transport.publish(topic, payload, exclude=peer)
        else:
            for p in members:
                p.send(KIND_GOSSIP, topic.encode(), payload)

    def _after_block(self, result, sb=None) -> None:
        """Unknown-parent blocks trigger an active parent lookup (and
        range sync as the catch-up fallback); others are done."""
        from ..beacon_chain import BlockError

        if isinstance(result, BlockError) and result.kind == "ParentUnknown":
            if sb is not None:
                self.lookups.search(bytes(sb.message.parent_root), orphan=sb)
            self.sync.trigger()

    # -- req/resp --------------------------------------------------------

    def _on_peer_connected(self, peer: Peer) -> None:
        if self.peer_manager.is_banned(self.peer_manager.ban_key(peer)):
            peer.close()
            return
        # handshake: status + peer exchange, off-thread (dial returns fast)
        threading.Thread(
            target=self._handshake, args=(peer,), daemon=True
        ).start()

    def _handshake(self, peer: Peer) -> None:
        status = peer.request(
            PROTO_STATUS.encode(), json.dumps(self.local_status()).encode()
        )
        if status:
            try:
                self.sync.on_status(peer, json.loads(status))
            except (ValueError, KeyError):
                pass
        px = peer.request(PROTO_PEER_EXCHANGE.encode(), b"[]")
        if px:
            self.discovery.learn_from_px(px)
            try:
                for host, port in json.loads(px):
                    if port != self.port and self.transport.peer_count() < 32:
                        self.transport.dial(host, port)
            except (ValueError, TypeError):
                pass

    def local_status(self) -> dict:
        """Status payload (reference StatusMessage)."""
        chain = self.chain
        fin = chain.fork_choice.store.finalized_checkpoint
        return {
            "fork_digest": self.topics.prefix.split("/")[-1],
            "finalized_epoch": fin[0],
            "finalized_root": fin[1].hex(),
            "head_slot": chain.head_state.slot,
            "head_root": chain.head_block_root.hex(),
            "listen_port": self.port,
        }

    def _on_request(self, peer: Peer, protocol: str, payload: bytes) -> bytes:
        if not self.peer_manager.allow_request(peer, protocol):
            return b""  # rate-limited (reference rpc/rate_limiter.rs)
        chain = self.chain
        if protocol == PROTO_STATUS:
            try:
                theirs = json.loads(payload)
                peer.remote_listen_port = theirs.get("listen_port")
                self.sync.on_status(peer, theirs)
            except (ValueError, KeyError):
                pass
            return json.dumps(self.local_status()).encode()
        if protocol == PROTO_PING or protocol == PROTO_GOODBYE:
            return b"pong"
        if protocol == PROTO_METADATA:
            return json.dumps(
                {"attnets": sorted(self.subnets), "seq_number": 0}
            ).encode()
        if protocol == PROTO_PEER_EXCHANGE:
            peers = [
                [p.addr[0], p.remote_listen_port]
                for p in self.transport.peers_snapshot()
                if p.remote_listen_port
            ]
            return json.dumps(peers).encode()
        if protocol == PROTO_BLOCKS_BY_RANGE:
            start, count = struct.unpack("<QQ", payload[:16])
            out = []
            from ..store.iter import block_roots_iter

            wanted = range(start, start + min(count, 64))
            roots = {}
            for slot, root in block_roots_iter(chain.store, chain.head_block_root):
                if slot < start:
                    break
                if slot in wanted:
                    roots[slot] = root
            for slot in sorted(roots):
                block = chain.store.get_block(roots[slot])
                if block is not None:
                    enc = type(block).encode(block)
                    out.append(struct.pack("<I", len(enc)) + enc)
            return b"".join(out)
        if protocol == PROTO_BLOCKS_BY_ROOT:
            out = []
            for i in range(0, len(payload), 32):
                block = chain.store.get_block(payload[i:i + 32])
                if block is not None:
                    enc = type(block).encode(block)
                    out.append(struct.pack("<I", len(enc)) + enc)
            return b"".join(out)
        return b""


class BlockLookups:
    """Active unknown-parent block lookups (reference
    ``network/src/sync/block_lookups``): when a gossip block references an
    unknown parent, fetch the parent chain by root from the best-scored
    peers (retry across peers, downscore bad responders), import the
    recovered segment oldest-first, then replay the orphan. Range sync
    only helps when a peer's STATUS shows it ahead; a same-height fork or
    a missed gossip block needs this root-addressed path."""

    MAX_CHAIN = 16   # parent-depth bound (reference PARENT_DEPTH_TOLERANCE)
    PEER_TRIES = 3   # distinct peers asked per root before giving up
    MAX_INFLIGHT = 8  # concurrent lookup threads (reference bounds these
    #                   too: cheap ParentUnknown gossip must not fan out
    #                   unbounded threads or by-root request storms)
    NEG_CACHE_S = 30.0  # roots that failed recently are not re-searched

    def __init__(self, service: NetworkService):
        self.service = service
        self._lock = threading.Lock()
        self._inflight: set[bytes] = set()
        self._neg_cache: dict[bytes, float] = {}
        self._metric = _LOOKUPS
        self._fetched = _LOOKUP_BLOCKS

    def search(self, root: bytes, orphan=None) -> None:
        """Fire-and-forget lookup of ``root`` and its unknown ancestors;
        ``orphan`` (the block whose parent is missing) is replayed after
        the segment imports."""
        chain = self.service.chain
        now = time.monotonic()
        with self._lock:
            if root in self._inflight or len(self._inflight) >= self.MAX_INFLIGHT:
                return
            if self._neg_cache.get(root, 0.0) > now:
                return
            if len(self._neg_cache) > 1024:
                self._neg_cache = {
                    k: t for k, t in self._neg_cache.items() if t > now
                }
            self._inflight.add(root)
        if chain.store.get_block(root) is not None:
            with self._lock:
                self._inflight.discard(root)
            return
        self._metric.inc()
        threading.Thread(
            target=self._run, args=(root, orphan), daemon=True
        ).start()

    # -- internals -------------------------------------------------------

    def _best_peers(self) -> list[Peer]:
        pm = self.service.peer_manager
        peers = [
            p for p in self.service.transport.peers_snapshot() if not p.closed
        ]
        return sorted(peers, key=pm.score, reverse=True)

    def _request_block(self, root: bytes):
        """Ask up to PEER_TRIES best peers for one block by root; verify
        the response IS the requested block (hash_tree_root) and
        downscore peers that answer with garbage."""
        for peer in self._best_peers()[: self.PEER_TRIES]:
            raw = peer.request(PROTO_BLOCKS_BY_ROOT.encode(), root, timeout=10)
            if not raw:
                continue  # empty/timeout: try the next peer, no penalty
            try:
                (n,) = struct.unpack_from("<I", raw, 0)
                chunk = raw[4:4 + n]
                t = self.service.chain.types
                sb = None
                for fork in ("bellatrix", "altair", "phase0"):
                    try:
                        sb = t.signed_block[fork].decode(chunk)
                        break
                    except Exception:
                        continue
                if sb is None or hash_tree_root(sb.message) != root:
                    raise ValueError("wrong or undecodable block")
            except Exception:
                self.service.peer_manager.report(peer, "protocol")
                continue
            self._fetched.inc()
            return sb
        return None

    def _run(self, root: bytes, orphan) -> None:
        try:
            chain = self.service.chain
            segment = []  # newest -> oldest
            want = root
            for _ in range(self.MAX_CHAIN):
                if want == bytes(32) or chain.store.get_block(want) is not None:
                    break
                sb = self._request_block(want)
                if sb is None:
                    # nobody could serve it: negative-cache so repeat
                    # ParentUnknown gossip cannot re-trigger immediately
                    with self._lock:
                        self._neg_cache[root] = (
                            time.monotonic() + self.NEG_CACHE_S
                        )
                    return
                segment.append(sb)
                want = bytes(sb.message.parent_root)
            else:
                # chain deeper than the bound: that is range sync's job
                self.service.sync.trigger()
                return
            if not segment:
                return
            segment.reverse()  # oldest first for CHAIN_SEGMENT
            done = threading.Event()
            result = {}

            def _done(r, _ev=done, _res=result):
                _res["r"] = r
                _ev.set()

            self.service.processor.submit(
                Work(WorkKind.CHAIN_SEGMENT, segment, done=_done)
            )
            if not done.wait(timeout=60) or isinstance(result.get("r"), Exception):
                return
            if orphan is not None:
                # replay the orphan now that its ancestry is in the store
                self.service.processor.submit(
                    Work(WorkKind.GOSSIP_BLOCK, orphan, done=lambda r: None)
                )
        finally:
            with self._lock:
                self._inflight.discard(root)


class BackfillSync:
    """Reverse sync below a checkpoint anchor (reference
    ``network/src/sync/backfill_sync``): pull descending batches with
    blocks_by_range, check hash-linkage to the known anchor chain, batch
    proposal-signature verification with per-epoch fork domains (correct
    across any number of fork boundaries), then store."""

    BATCH = 32

    def __init__(self, service: NetworkService):
        self.service = service
        self.complete = False

    def _proposal_set(self, chain, anchor_state, sb, block_root):
        """Proposal signature set with the domain computed from the
        block's OWN epoch's fork version (get_domain on a state only
        knows one fork back; historical blocks need the schedule)."""
        from ..crypto import bls
        from ..types.chain_spec import DOMAIN_BEACON_PROPOSER
        from ..types.domains import compute_domain, compute_signing_root

        epoch = sb.message.slot // chain.preset.SLOTS_PER_EPOCH
        domain = compute_domain(
            chain.spec,
            DOMAIN_BEACON_PROPOSER,
            chain.spec.fork_version_at_epoch(epoch),
            bytes(anchor_state.genesis_validators_root),
        )
        root = compute_signing_root(None, block_root, domain)
        pk = chain.pubkey_cache.get(sb.message.proposer_index)
        return bls.SignatureSet.single_pubkey(
            bls.Signature.deserialize(bytes(sb.signature)), pk, root
        )

    def run(self, peer: Peer) -> int:
        """Blocking backfill from the oldest stored block downwards.
        Returns the number of blocks stored."""
        from ..store.iter import block_roots_iter

        chain = self.service.chain
        stored = 0
        oldest_root = None
        oldest_slot = None
        for slot, root in block_roots_iter(chain.store, chain.head_block_root):
            oldest_root, oldest_slot = root, slot
        if oldest_root is None or oldest_slot == 0:
            self.complete = True
            return 0
        block = chain.store.get_block(oldest_root)
        want = bytes(block.message.parent_root)
        anchor_state = chain.head_state
        next_below = oldest_slot  # request strictly below this slot
        while want != bytes(32):
            start = max(0, next_below - self.BATCH)
            count = next_below - start
            if count <= 0:
                break
            raw = peer.request(
                PROTO_BLOCKS_BY_RANGE.encode(),
                struct.pack("<QQ", start, count),
                timeout=30,
            )
            if not raw:
                return stored
            blocks = self._decode_blocks_any_fork(raw)
            if not blocks:
                return stored
            # walk the batch backwards, checking hash linkage to `want`
            verified = []
            sets = []
            for sb in reversed(blocks):
                root = hash_tree_root(sb.message)
                if root != want:
                    continue  # forked/extra block in response
                if sb.message.slot > 0:
                    sets.append(
                        self._proposal_set(chain, anchor_state, sb, root)
                    )
                verified.append((root, sb))
                want = bytes(sb.message.parent_root)
            if not verified:
                return stored
            # historical proposal signatures are the textbook bulk-class
            # workload: deadline-insensitive, contiguous,
            # self-paced — the scheduler fuses them onto the big warm
            # rungs at gossip idle; without a scheduler this is the same
            # direct call as before
            from ..verification_service import backend_verify_bulk

            if sets and not backend_verify_bulk(chain, sets, kind="backfill"):
                return stored
            for root, sb in verified:
                chain.store.put_block(root, sb)
                stored += 1
            _BACKFILL_BLOCKS.inc(len(verified))
            next_below = verified[-1][1].message.slot
            if verified[-1][1].message.slot == 0:
                break
        self.complete = True
        return stored

    def _decode_blocks_any_fork(self, raw: bytes) -> list:
        """Length-prefixed blocks; each tried against every scheduled
        fork's type (historical batches span fork boundaries)."""
        t = self.service.chain.types
        out = []
        i = 0
        while i + 4 <= len(raw):
            (n,) = struct.unpack_from("<I", raw, i)
            i += 4
            if i + n > len(raw):
                break
            chunk = raw[i:i + n]
            i += n
            for fork in ("bellatrix", "altair", "phase0"):
                try:
                    out.append(t.signed_block[fork].decode(chunk))
                    break
                except Exception:
                    continue
        return out


class RangeSync:
    """Forward range sync (reference ``network/src/sync/range_sync``):
    when a peer's status is ahead, pull batches of blocks_by_range and
    feed them as CHAIN_SEGMENT work until caught up."""

    BATCH = 32

    def __init__(self, service: NetworkService):
        self.service = service
        self._lock = threading.Lock()
        self._active = False
        self._best: Optional[tuple[int, Peer]] = None  # (head_slot, peer)

    def on_status(self, peer: Peer, status: dict) -> None:
        their_head = int(status.get("head_slot", 0))
        with self._lock:
            best = self._best
            if (
                best is None
                or their_head > best[0]
                or best[1].closed  # a dead best peer must never wedge sync
            ):
                self._best = (their_head, peer)
        if their_head > self.service.chain.head_state.slot:
            self.trigger()

    def trigger(self) -> None:
        with self._lock:
            if self._active:
                return
            self._active = True
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        try:
            chain = self.service.chain
            while True:
                with self._lock:
                    best = self._best
                if best is None or best[0] <= chain.head_state.slot:
                    return
                target_slot, peer = best
                if peer.closed:
                    with self._lock:
                        if self._best is best:
                            self._best = None
                    return
                start = chain.head_state.slot + 1
                payload = struct.pack("<QQ", start, self.BATCH)
                raw = peer.request(PROTO_BLOCKS_BY_RANGE.encode(), payload, timeout=30)
                if not raw:
                    with self._lock:
                        if self._best is best:
                            self._best = None  # failed peer: re-learn from statuses
                    return
                blocks = self._decode_blocks(raw)
                if not blocks:
                    return
                _SYNC_BATCHES.inc()
                _SYNC_BLOCKS.inc(len(blocks))
                done = threading.Event()
                result = {}

                def _done(r, _ev=done, _res=result):
                    _res["r"] = r
                    _ev.set()

                self.service.processor.submit(
                    Work(WorkKind.CHAIN_SEGMENT, blocks, done=_done)
                )
                if not done.wait(timeout=60):
                    return
                if isinstance(result.get("r"), Exception):
                    return
        finally:
            with self._lock:
                self._active = False

    def _decode_blocks(self, raw: bytes) -> list:
        t = self.service.chain.types
        fork = fork_of(self.service.chain.head_state)
        out = []
        i = 0
        while i + 4 <= len(raw):
            (n,) = struct.unpack_from("<I", raw, i)
            i += 4
            if i + n > len(raw):
                break
            out.append(t.signed_block[fork].decode(raw[i:i + n]))
            i += n
        return out
