"""The BeaconChain runtime (reference:
``beacon_node/beacon_chain/src/beacon_chain.rs`` — the god object wiring
store, fork choice, caches, and verification pipelines; ``process_block``
at :2495, ``produce_block_on_state`` :3364, ``process_chain_segment``
:2340, head recompute ``canonical_head.rs:449``).

This is the consumer that feeds the TPU BLS backend its real workload:
block imports batch every block signature through
``SignatureVerifiedBlock``; gossip attestations batch through
``attestation_verification``.
"""

from __future__ import annotations

import copy
import threading
from collections import OrderedDict

from ..fork_choice.fork_choice import ForkChoice
from ..fork_choice.proto_array import ExecutionStatus
from ..ssz import hash_tree_root
from ..ssz.cache import CachedRootComputer
from ..state_transition import (
    CommitteeCache,
    get_indexed_attestation,
    partial_state_advance,
    process_block as st_process_block,
    get_beacon_proposer_index,
)
from ..state_transition.epoch import fork_of
from ..state_transition.helpers import compute_epoch_at_slot
from ..utils import metrics
from ..utils.slot_clock import SlotClock
from .attestation_verification import (
    batch_verify_aggregated_attestations,
    batch_verify_unaggregated_attestations,
    verify_aggregated_attestation,
    verify_unaggregated_attestation,
)
from .block_verification import (
    BlockError,
    ExecutionPendingBlock,
    GossipVerifiedBlock,
    SignatureVerifiedBlock,
)
from .observed import (
    ObservedAggregates,
    ObservedAggregators,
    ObservedAttesters,
    ObservedBlockProducers,
    ObservedOperations,
)
from .pubkey_cache import ValidatorPubkeyCache

_BLOCK_PROCESSING = metrics.histogram(
    "block_processing_seconds", "full block import wall time"
)
_HEAD_RECOMPUTE = metrics.counter("head_recompute_total", "get_head invocations")
_BLOCK_OBSERVED_TO_HEAD = metrics.histogram(
    "beacon_block_observed_to_head_seconds",
    "gossip-observed to set-as-head delay (block_times_cache)",
)


class SnapshotCache:
    """Post-states of recent blocks by block root (reference
    ``snapshot_cache.rs``, DEFAULT_SNAPSHOT_CACHE_SIZE=4)."""

    def __init__(self, cap: int = 4):
        self.cap = cap
        self._map: OrderedDict[bytes, object] = OrderedDict()
        # get() is a mutating read (move_to_end) on a plain OrderedDict and
        # is reached from HTTP/timer threads outside the chain lock.
        self._lock = threading.Lock()

    def insert(self, block_root: bytes, state) -> None:
        with self._lock:
            self._map[block_root] = state
            self._map.move_to_end(block_root)
            while len(self._map) > self.cap:
                self._map.popitem(last=False)

    def get(self, block_root: bytes):
        with self._lock:
            state = self._map.get(block_root)
            if state is not None:
                self._map.move_to_end(block_root)
            return state


class ShufflingCache:
    """Committee caches keyed by (epoch, target root) (reference
    ``shuffling_cache.rs``)."""

    def __init__(self, cap: int = 16):
        self.cap = cap
        self._map: OrderedDict[tuple, CommitteeCache] = OrderedDict()
        # Double-checked locking: the lock guards only dict access; a
        # cold-miss committee build (deepcopy + epoch of state advance,
        # potentially seconds) runs UNLOCKED so an HTTP duties request
        # can never stall a worker that holds the chain lock and blocks
        # here. The price is an occasional duplicate build.
        self._lock = threading.Lock()

    def get(self, chain, epoch: int, target_root: bytes) -> CommitteeCache:
        key = (epoch, bytes(target_root))
        with self._lock:
            hit = self._map.get(key)
            if hit is not None:
                self._map.move_to_end(key)
                return hit
        # The shuffling must come from a state on the TARGET's chain — the
        # head may be on a competing fork with a different RANDAO seed.
        # Advance the target block's post-state to the epoch if needed.
        try:
            state = chain.state_at_block_root(bytes(target_root))
        except Exception:
            state = chain.head_state  # pre-genesis targets / missing state
        target_epoch_slot = epoch * chain.preset.SLOTS_PER_EPOCH
        if state.slot < target_epoch_slot:
            state = partial_state_advance(
                chain.preset, chain.spec, copy.deepcopy(state),
                target_epoch_slot,
            )
        cache = CommitteeCache(chain.preset, state, epoch)
        with self._lock:
            existing = self._map.get(key)
            if existing is not None:
                return existing
            self._map[key] = cache
            while len(self._map) > self.cap:
                self._map.popitem(last=False)
        return cache


class BeaconChain:
    def __init__(self, preset, spec, types, store, genesis_state, slot_clock=None):
        self.preset = preset
        self.spec = spec
        self.types = types
        self.store = store
        self.slot_clock = slot_clock or SlotClock(
            genesis_state.genesis_time, spec.seconds_per_slot
        )

        self.genesis_state_root = hash_tree_root(genesis_state)
        genesis_block_root = _anchor_block_root(genesis_state)
        self.genesis_block_root = genesis_block_root

        self.fork_choice = ForkChoice(
            preset,
            spec,
            genesis_state.slot,
            genesis_block_root,
            (
                genesis_state.current_justified_checkpoint.epoch,
                genesis_block_root,
            ),
            (genesis_state.finalized_checkpoint.epoch, genesis_block_root),
            [v.effective_balance for v in genesis_state.validators],
        )

        self.pubkey_cache = ValidatorPubkeyCache(store)
        self.pubkey_cache.import_new_pubkeys(genesis_state)
        self.observed_attesters = ObservedAttesters()
        self.observed_aggregators = ObservedAggregators()
        self.observed_aggregates = ObservedAggregates()
        self.observed_block_producers = ObservedBlockProducers()
        self.observed_operations = ObservedOperations()
        self.snapshot_cache = SnapshotCache()
        self.shuffling_cache = ShufflingCache()
        self.root_computer = CachedRootComputer()
        from .caches import (
            AttesterCache,
            BeaconProposerCache,
            BlockTimesCache,
            EarlyAttesterCache,
        )

        self.early_attester_cache = EarlyAttesterCache()
        self.beacon_proposer_cache = BeaconProposerCache()
        self.attester_cache = AttesterCache()
        self.block_times_cache = BlockTimesCache()
        # state pre-advanced to the next slot by the state-advance timer:
        # (head_block_root, state) — see advance_head_state_to()
        self._advanced: tuple[bytes, object] | None = None
        self.op_pool = None  # attached by the client builder when present
        self.slasher = None  # attached by the client builder when enabled
        self.validator_monitor = None  # attached when monitoring is on
        # cross-caller batching scheduler (verification_service/batcher.py),
        # attached by the client builder; None = direct backend calls
        self.verification_scheduler = None

        # (root, state) swapped as ONE tuple so unlocked readers (HTTP
        # routes, duty production) always see a consistent pair; exposed
        # via the head_block_root / head_state properties.
        self._head = (genesis_block_root, genesis_state)
        self._last_finalized_epoch = genesis_state.finalized_checkpoint.epoch
        # Serializes every chain-mutating path (block import, attestation
        # verification bookkeeping, head recompute). The BeaconProcessor
        # runs multiple worker threads plus the slot-timer and HTTP
        # threads; the fork-choice proto-array, observed_* caches, and
        # snapshot/shuffling caches are plain dicts with no internal
        # locking — the reference guards the equivalents with RwLocks
        # (canonical_head.rs). Reentrant: process_chain_segment →
        # _import_block → recompute_head all take it.
        self._chain_lock = threading.RLock()

        # Materialize the anchor block implied by the state's header (an
        # interop/spec genesis has an empty body); lets block_id lookups
        # resolve "head" from slot 0. A checkpoint-sync anchor whose real
        # body is unknown simply skips this (root would not match).
        fork = fork_of(genesis_state)
        header = genesis_state.latest_block_header
        anchor = types.block[fork](
            slot=header.slot,
            proposer_index=header.proposer_index,
            parent_root=bytes(header.parent_root),
            state_root=(
                self.genesis_state_root
                if bytes(header.state_root) == bytes(32)
                else bytes(header.state_root)
            ),
            body=types.block_body[fork](),
        )
        if hash_tree_root(anchor) == genesis_block_root:
            store.put_block(
                genesis_block_root, types.signed_block[fork](message=anchor)
            )
        self.snapshot_cache.insert(genesis_block_root, genesis_state)
        store.put_state_snapshot(self.genesis_state_root, genesis_state)
        # The anchor may be a resumed HEAD, not genesis: never clobber an
        # existing genesis-root record.
        if store.get_genesis_state_root() is None:
            store.put_genesis_state_root(self.genesis_state_root)
        store.put_head(genesis_block_root)

    # -- clock / lookup ---------------------------------------------------

    @property
    def head_block_root(self) -> bytes:
        return self._head[0]

    @property
    def head_state(self):
        return self._head[1]

    def head_info(self):
        """Consistent (head_block_root, head_state) pair for readers."""
        return self._head

    def set_head(self, root: bytes, state) -> None:
        """Atomic head replacement (fork_revert, checkpoint resume)."""
        with self._chain_lock:
            self._head = (root, state)

    def slot(self) -> int:
        return self.slot_clock.now()

    def epoch(self) -> int:
        return compute_epoch_at_slot(self.preset, self.slot())

    def state_at_block_root(self, block_root: bytes):
        """Post-state of a block: snapshot cache, then store."""
        state = self.snapshot_cache.get(block_root)
        if state is not None:
            return state
        block = self.store.get_block(block_root)
        if block is None:
            raise BlockError("ParentUnknown", block_root.hex()[:12])
        state = self.store.get_state(bytes(block.message.state_root))
        if state is None:
            raise BlockError("MissingParentState", block_root.hex()[:12])
        return state

    def pubkey_resolver_by_bytes(self):
        cache = self.pubkey_cache

        def _resolve(raw: bytes):
            idx = cache.get_index(bytes(raw))
            return cache.get(idx) if idx is not None else None

        return _resolve

    # -- block pipeline ---------------------------------------------------

    def verify_block_for_gossip(self, signed_block) -> GossipVerifiedBlock:
        # Mutates observed_block_producers and reads fork-choice/snapshot
        # state; gossip blocks arrive ~1/slot, so holding the lock across
        # the single proposal-signature check costs nothing.
        with self._chain_lock:
            gossip = GossipVerifiedBlock.new(self, signed_block)
        self.block_times_cache.set_observed(gossip.block_root)
        return gossip

    def process_block(self, block, execution_status=ExecutionStatus.IRRELEVANT):
        """Import a block through the full pipeline. Accepts a raw
        SignedBeaconBlock, a GossipVerifiedBlock, or a
        SignatureVerifiedBlock; returns the block root."""
        with self._chain_lock, _BLOCK_PROCESSING.time():
            if isinstance(block, GossipVerifiedBlock):
                sv = SignatureVerifiedBlock.from_gossip(block, self)
            elif isinstance(block, SignatureVerifiedBlock):
                sv = block
            else:
                sv = SignatureVerifiedBlock.new(self, block)
            return self._import_block(sv, execution_status)

    def _import_block(self, sv: SignatureVerifiedBlock, execution_status):
        signed_block = sv.signed_block
        block = signed_block.message
        state = sv.state  # advanced to block.slot, pre-block

        st_process_block(
            self.preset, self.spec, state, signed_block, fork_of(state),
            signature_strategy="none",
        )
        post_root = self.root_computer.hash_tree_root(state)
        if post_root != bytes(block.state_root):
            raise BlockError(
                "StateRootMismatch",
                f"{post_root.hex()[:12]} != {bytes(block.state_root).hex()[:12]}",
            )

        # fork choice: block + its attestations + slashings
        self.fork_choice.on_block(
            self.slot(), block, sv.block_root, state, execution_status
        )
        for att in block.body.attestations:
            try:
                indexed = get_indexed_attestation(self.preset, state, att)
                self.fork_choice.on_attestation(
                    self.slot(), indexed, is_from_block=True
                )
            except Exception:
                pass  # fork-choice-irrelevant (e.g. old target); state transition accepted it
        for slashing in block.body.attester_slashings:
            self.fork_choice.on_attester_slashing(
                slashing.attestation_1, slashing.attestation_2
            )

        self.pubkey_cache.import_new_pubkeys(state)
        if self.validator_monitor is not None:
            self.validator_monitor.process_block(self, signed_block, state)
        self.store.put_block(sv.block_root, signed_block)
        self.store.put_state(post_root, state)
        self.snapshot_cache.insert(sv.block_root, state)

        # early-attester template: attesting to THIS block this epoch
        # needs no state access (reference beacon_chain.rs:1496-1512)
        epoch = compute_epoch_at_slot(self.preset, block.slot)
        epoch_start = epoch * self.preset.SLOTS_PER_EPOCH
        target_root = (
            sv.block_root
            if block.slot == epoch_start
            else bytes(
                state.block_roots[epoch_start % self.preset.SLOTS_PER_HISTORICAL_ROOT]
            )
        )
        self.early_attester_cache.add(
            epoch,
            sv.block_root,
            (
                state.current_justified_checkpoint.epoch,
                bytes(state.current_justified_checkpoint.root),
            ),
            target_root,
        )
        self.block_times_cache.set_imported(sv.block_root)

        self.recompute_head()
        return sv.block_root

    def process_chain_segment(self, blocks) -> list[bytes]:
        """Sync-time import: EVERY signature of the whole segment verified
        in ONE backend batch before any block is imported (reference
        ``process_chain_segment`` ``beacon_chain.rs:2340`` +
        ``signature_verify_chain_segment`` ``block_verification.rs:525``
        — the widest batch the device sees)."""
        blocks = list(blocks)
        if not blocks:
            return []
        # The segment-wide BLS batch (the slowest single operation in the
        # system) runs on deep-copied state OUTSIDE the chain lock; only
        # the per-block imports lock, so gossip verification and ticks can
        # interleave with a long sync segment.
        verified = self.signature_verify_chain_segment(blocks)
        out = []
        for sv in verified:
            with self._chain_lock:
                out.append(self._import_block(sv, ExecutionStatus.IRRELEVANT))
        return out

    def signature_verify_chain_segment(self, blocks) -> list[SignatureVerifiedBlock]:
        """Accumulate signature sets across all blocks of a contiguous
        segment, verify once, and return per-block SignatureVerifiedBlock
        evidence (with each block's advanced pre-state)."""
        from ..crypto import bls
        from ..ssz import hash_tree_root as htr
        from ..state_transition import BlockSignatureAccumulator

        parent_root = bytes(blocks[0].message.parent_root)
        state = copy.deepcopy(self.state_at_block_root(parent_root))
        all_sets = []
        out = []
        for sb in blocks:
            state = partial_state_advance(
                self.preset, self.spec, state, sb.message.slot
            )
            block_root = htr(sb.message)
            acc = BlockSignatureAccumulator(
                self.preset, self.spec, state, self.pubkey_cache.resolver(),
                resolver_by_pubkey_bytes=self.pubkey_resolver_by_bytes(),
            )
            acc.include_all(sb, block_root=block_root)
            all_sets.extend(acc.sets)
            out.append(
                SignatureVerifiedBlock(sb, block_root, copy.deepcopy(state))
            )
            # apply so the next block's sets build on the right state
            st_process_block(
                self.preset, self.spec, state, sb, fork_of(state),
                signature_strategy="none",
            )
        # segment import is deadline-INSENSITIVE (the syncing caller is
        # self-paced on the whole range): the bulk QoS class,
        # which flushes at gossip idle onto the big warm rungs under
        # admission control — a saturating range sync can no longer ride
        # the synchronous verify_now bypass head-on against gossip's
        # deadline class. Gossip block import keeps the bypass
        # (block_verification.py): a proposal on the wire IS
        # latency-critical.
        from ..verification_service import backend_verify_bulk

        if not backend_verify_bulk(self, all_sets, kind="chain_segment"):
            raise BlockError("InvalidSignature", "chain segment batch")
        return out

    # -- attestation pipeline ---------------------------------------------

    # The verify functions take the chain lock internally at the right
    # granularity (setup + commit locked, the BLS call unlocked) so the
    # heavy signature work of concurrent workers is not serialized.

    def verify_unaggregated_attestation_for_gossip(self, att):
        return verify_unaggregated_attestation(self, att, self.slot())

    def batch_verify_unaggregated_attestations_for_gossip(self, atts):
        return batch_verify_unaggregated_attestations(self, atts, self.slot())

    def verify_aggregated_attestation_for_gossip(self, signed_agg):
        return verify_aggregated_attestation(self, signed_agg, self.slot())

    def batch_verify_aggregated_attestations_for_gossip(self, signed_aggs):
        return batch_verify_aggregated_attestations(
            self, signed_aggs, self.slot()
        )

    def apply_attestation_to_fork_choice(self, verified) -> None:
        with self._chain_lock:
            self.fork_choice.on_attestation(self.slot(), verified.indexed)

    def on_tick(self, slot: int) -> None:
        """Slot-timer entry: advance fork choice's clock and re-evaluate
        the head, all under the chain lock (the timer runs on its own
        thread)."""
        with self._chain_lock:
            self.fork_choice.on_tick(slot)
            self._recompute_head_locked()

    def on_attester_slashing(self, slashing) -> None:
        """Record an attester slashing's equivocation evidence in fork
        choice (HTTP-pool and gossip paths; locked — mutates proto-array
        state)."""
        with self._chain_lock:
            self.fork_choice.on_attester_slashing(
                slashing.attestation_1, slashing.attestation_2
            )

    # -- head / finalization ----------------------------------------------

    def recompute_head(self) -> bytes:
        with self._chain_lock:
            return self._recompute_head_locked()

    def _recompute_head_locked(self) -> bytes:
        _HEAD_RECOMPUTE.inc()
        head_root = self.fork_choice.get_head()
        if head_root != self.head_block_root:
            state = self.snapshot_cache.get(head_root)
            if state is None:
                head_block = self.store.get_block(head_root)
                state = self.store.get_state(bytes(head_block.message.state_root))
            self._head = (head_root, state)  # atomic pair swap
            self.store.put_head(head_root)
            self.block_times_cache.set_became_head(head_root)
            # the pre-advanced state belongs to the previous head; entries
            # are keyed by root so a stale one is merely unused, but drop
            # it so the timer re-advances for the new head promptly
            if self._advanced is not None and self._advanced[0] != head_root:
                self._advanced = None
            delays = self.block_times_cache.delays(head_root)
            if "observed_to_head" in delays:
                _BLOCK_OBSERVED_TO_HEAD.observe(delays["observed_to_head"])
        # Finalization is advanced by fork_choice.on_block, so compare
        # against the chain's own last-seen epoch, not a before/after of
        # the fork-choice store within this call.
        new_finalized = self.fork_choice.store.finalized_checkpoint
        if new_finalized[0] > self._last_finalized_epoch:
            self._last_finalized_epoch = new_finalized[0]
            self._on_finalization(new_finalized)
        return head_root

    def _on_finalization(self, finalized_checkpoint) -> None:
        """Prune memory caches + migrate the store split (reference
        ``migrate.rs`` + per-cache prune calls)."""
        epoch, root = finalized_checkpoint
        fin_slot = epoch * self.preset.SLOTS_PER_EPOCH
        self.observed_attesters.prune(epoch)
        self.observed_aggregators.prune(epoch)
        self.observed_aggregates.prune(fin_slot)
        self.observed_block_producers.prune(fin_slot)
        obs_sync = getattr(self, "observed_sync_items", None)
        if obs_sync is not None:
            obs_sync.prune(fin_slot)
        self.fork_choice.prune()
        block = self.store.get_block(root)
        if block is not None:
            state = self.store.get_state(bytes(block.message.state_root))
            if state is not None:
                self.store.migrate(bytes(block.message.state_root), state)
        # Persist fork choice now, not only at shutdown: the store's HEAD
        # advances on every recompute_head, so a crash between shutdowns
        # would otherwise restore an old DAG that lacks the persisted head
        # and stall on ParentUnknown (reference persists on finalization
        # too, ``beacon_chain.rs:400-440``). Already under the chain RLock.
        try:
            from ..store.kv import Column

            self.store.put_blob(
                Column.FORK_CHOICE, b"fork_choice", self.fork_choice_bytes()
            )
        except Exception:
            pass  # persistence must never break finalization handling

    # -- production --------------------------------------------------------

    def produce_block_on_state(self, slot: int, randao_reveal: bytes, graffiti: bytes = bytes(32)):
        """Unsigned block proposal on the canonical head (reference
        ``produce_block_on_state`` ``beacon_chain.rs:3364``); op-pool
        selection when a pool is attached."""
        state = copy.deepcopy(self.head_state)
        state = partial_state_advance(self.preset, self.spec, state, slot)
        proposer = get_beacon_proposer_index(self.preset, state)
        fork = fork_of(state)
        t = self.types

        body_kwargs = dict(
            randao_reveal=randao_reveal,
            eth1_data=state.eth1_data,
            graffiti=graffiti,
        )
        if self.op_pool is not None:
            packing = self.op_pool.packing_for_block(self, state)
            body_kwargs.update(packing)
        if fork in ("altair", "bellatrix") and "sync_aggregate" not in body_kwargs:
            from ..crypto.bls import INFINITY_SIGNATURE

            agg = None
            if self.op_pool is not None and slot >= 1:
                agg = self.op_pool.sync_aggregate_for_block(
                    slot - 1, self.head_block_root
                )
            body_kwargs["sync_aggregate"] = agg or t.SyncAggregate(
                sync_committee_signature=INFINITY_SIGNATURE
            )
        body = t.block_body[fork](**body_kwargs)
        block = t.block[fork](
            slot=slot,
            proposer_index=proposer,
            parent_root=self.head_block_root,
            state_root=bytes(32),
            body=body,
        )
        trial = copy.deepcopy(state)
        st_process_block(
            self.preset, self.spec, trial,
            t.signed_block[fork](message=block), fork, signature_strategy="none",
        )
        block.state_root = hash_tree_root(trial)
        return block, proposer

    def produce_unaggregated_attestation(self, slot: int, committee_index: int):
        """AttestationData for a duty (reference
        ``produce_unaggregated_attestation`` ``beacon_chain.rs:1496``).

        Fast paths, in order: the early-attester template (filled at
        block import — zero state access), then the attester cache
        (cross-epoch FFG info), then the state-advance-timer's
        pre-advanced state, then a fresh copy+advance (which refills the
        attester cache)."""
        t = self.types
        epoch = compute_epoch_at_slot(self.preset, slot)
        head_root, head_state = self.head_info()  # consistent pair

        item = self.early_attester_cache.try_attest(epoch, head_root)
        if item is not None:
            return t.AttestationData(
                slot=slot,
                index=committee_index,
                beacon_block_root=item.beacon_block_root,
                source=t.Checkpoint(epoch=item.source[0], root=item.source[1]),
                target=t.Checkpoint(epoch=epoch, root=item.target_root),
            )

        state = head_state
        if compute_epoch_at_slot(self.preset, state.slot) < epoch:
            # epoch boundary between head and duty slot: the justified
            # checkpoint changes at the boundary
            info = self.attester_cache.get(epoch, head_root)
            if info is not None:
                return t.AttestationData(
                    slot=slot,
                    index=committee_index,
                    beacon_block_root=head_root,
                    source=t.Checkpoint(epoch=info.source[0], root=info.source[1]),
                    target=t.Checkpoint(epoch=epoch, root=info.target_root),
                )
            advanced = self._advanced
            if (
                advanced is not None
                and advanced[0] == head_root
                and compute_epoch_at_slot(self.preset, advanced[1].slot) >= epoch
            ):
                state = advanced[1]  # read-only use
            else:
                state = partial_state_advance(
                    self.preset, self.spec, copy.deepcopy(state), slot
                )
        target_slot = epoch * self.preset.SLOTS_PER_EPOCH
        if state.slot > target_slot:
            hist = state.block_roots[
                target_slot % self.preset.SLOTS_PER_HISTORICAL_ROOT
            ]
            target_root = bytes(hist)
        else:
            target_root = head_root
        from .caches import AttesterDutyInfo

        self.attester_cache.insert(
            epoch,
            head_root,
            AttesterDutyInfo(
                source=(
                    state.current_justified_checkpoint.epoch,
                    bytes(state.current_justified_checkpoint.root),
                ),
                target_root=target_root,
            ),
        )
        return t.AttestationData(
            slot=slot,
            index=committee_index,
            beacon_block_root=head_root,
            source=state.current_justified_checkpoint,
            target=t.Checkpoint(epoch=epoch, root=target_root),
        )

    def fork_choice_bytes(self) -> bytes:
        """Serialize fork choice under the chain lock — concurrent
        on_block/on_attestation mutation otherwise tears the snapshot
        (found by tests/test_concurrency_stress.py: 'dictionary changed
        size during iteration')."""
        from ..fork_choice.persistence import fork_choice_to_bytes

        with self._chain_lock:
            return fork_choice_to_bytes(self.fork_choice)

    def advance_head_state_to(self, slot: int) -> bool:
        """State-advance timer body (reference
        ``state_advance_timer.rs:93-231``): near the end of a slot,
        pre-advance a COPY of the head state to the next slot so block
        verification and attestation production at the slot boundary skip
        the per-slot (and at boundaries, per-epoch) processing spike.
        Returns True when an advance was performed. The copy + advance run
        OUTSIDE the chain lock (the whole point is not to stall gossip and
        import during the boundary spike); the result is published only if
        the head did not move meanwhile."""
        head_root, head_state = self.head_info()
        advanced = self._advanced
        if advanced is not None and advanced[0] == head_root and (
            advanced[1].slot >= slot
        ):
            return False
        if head_state.slot >= slot:
            return False
        state = partial_state_advance(
            self.preset, self.spec, copy.deepcopy(head_state), slot
        )
        with self._chain_lock:
            if self._head[0] != head_root:
                return False  # advanced a stale head: discard
            self._advanced = (head_root, state)
        return True

    def advanced_state_for(self, parent_root: bytes, slot: int):
        """The pre-advanced state when it matches (root, <=slot); None
        otherwise. Callers must deepcopy before mutating."""
        advanced = self._advanced
        if (
            advanced is not None
            and advanced[0] == parent_root
            and advanced[1].slot <= slot
        ):
            return advanced[1]
        return None

    def proposers_for_epoch(self, epoch: int) -> list[int]:
        """Proposer index for every slot of ``epoch``, cached on
        (epoch, head root) (reference ``beacon_proposer_cache.rs``)."""
        head_root, head_state = self.head_info()  # consistent pair
        cached = self.beacon_proposer_cache.get(epoch, head_root)
        if cached is not None:
            return cached
        from ..state_transition.helpers import proposer_index_at_slot

        P = self.preset
        start = epoch * P.SLOTS_PER_EPOCH
        state = head_state
        if state.slot < start:
            state = self.advanced_state_for(head_root, start)
            if state is None or compute_epoch_at_slot(P, state.slot) < epoch:
                state = partial_state_advance(
                    P, self.spec, copy.deepcopy(head_state), start
                )
        proposers = [
            proposer_index_at_slot(P, state, s)
            for s in range(start, start + P.SLOTS_PER_EPOCH)
        ]
        self.beacon_proposer_cache.insert(epoch, head_root, proposers)
        return proposers


def _anchor_block_root(state) -> bytes:
    """Root of the anchor (genesis) block implied by a state whose
    latest_block_header.state_root may be unfilled."""
    from ..state_transition.helpers import latest_block_header_root

    return latest_block_header_root(state)
