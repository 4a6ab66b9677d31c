"""Client builder: assembles a running beacon node (reference:
``beacon_node/client/src/builder.rs:56-128,676,825`` — store -> chain ->
network/processor -> HTTP API -> timers; plus ``timer`` and
``state_advance_timer``): the port of the JAX package's ``client.py``.

The device wiring is the JAX builder's, in its order, for the ``cuda``
backend: the operation pool's ``DeviceAggregator``, the mesh, the key
table with its delta listener, the duty lookahead, the compile service,
then the scheduler. ``ClientConfig.device`` says where they run
(``cuda`` unless the caller asks for the CPU, as the tests do). The
slasher (``ClientConfig.slasher``) is wired as in JAX: it persists in
the node's store and the slot timer drains its evidence into the
operation pool, fork choice and the network.
"""

from __future__ import annotations

import copy
import json
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch

from .crypto.backend import DEFAULT as _DEFAULT_BACKEND
from .beacon_chain import BeaconChain, VerifiedAggregatedAttestation, VerifiedUnaggregatedAttestation
from .beacon_processor import BeaconProcessor, Work, WorkKind
from .http_api import BeaconApiServer
from .operation_pool import OperationPool
from .state_transition import store_replayer
from .store import HotColdDB, MemoryStore, SqliteStore
from .types.chain_spec import ChainSpec
from .types.containers import types_for
from .types.preset import PRESETS
from .utils.slot_clock import SlotClock, SystemTimeSlotClock


@dataclass
class ClientConfig:
    preset_base: str = "mainnet"
    datadir: Optional[str] = None  # None = in-memory store
    http_host: str = "127.0.0.1"
    http_port: int = 5052
    http_enabled: bool = True
    # cuda | cpu | cpu-native | fake — the north-star flag
    bls_backend: str = _DEFAULT_BACKEND
    # where the cuda backend's wiring runs (backend, aggregator, mesh,
    # key table, lookahead, compile service): "cuda", or "cpu" when the
    # caller asks for the CPU
    device: str = "cuda"
    n_workers: int = 2
    slots_per_snapshot: int = 32
    # None = off; "auto" = monitor every validator; or a list of indices
    monitor_validators: object = None
    slasher: bool = False  # store-backed min-max-span slashing detection
    # None = no p2p network (library/tests); 0 = listen on a free port
    listen_port: object = None
    listen_host: str = "127.0.0.1"
    boot_nodes: tuple = ()  # "host:port" strings dialed at startup
    monitoring_endpoint: Optional[str] = None  # remote metrics push URL
    # cross-caller continuous batching for BLS verification
    # (verification_service/batcher.py); False = direct backend calls
    verification_scheduler: bool = True
    scheduler_deadline_ms: float = 25.0
    scheduler_max_batch_sets: int = 256
    scheduler_max_queue_sets: int = 2048
    # shape-aware flush planner (verification_service/planner.py):
    # kind-homogeneous bin-packed sub-batches when they beat the legacy
    # single-rung flush. None = LIGHTHOUSE_TPU_SCHED_PLANNER env
    # (default on); False pins the legacy plan.
    scheduler_plan_flushes: Optional[bool] = None
    # bulk QoS class (verification_service/batcher.py + admission.py):
    # chain-segment backfill / historical sync submit with
    # qos="bulk" — a separate bounded queue flushed only at gossip idle
    # onto the biggest warm rungs, paused by headroom-driven admission
    # control (capacity_headroom_ratio below the floor, or a gossip
    # slo_burn latch) and resumed with hysteresis. None = env knobs
    # LIGHTHOUSE_TPU_SCHED_MAX_BULK_QUEUE (default 8192) /
    # …_SCHED_BULK_FLUSH_SETS (512) / …_SCHED_BULK_LINGER_MS (100) /
    # …_SCHED_BULK_HEADROOM_FLOOR (0.10) / …_SCHED_BULK_RESUME_HEADROOM
    # (0.20).
    scheduler_bulk_max_queue_sets: Optional[int] = None
    scheduler_bulk_flush_sets: Optional[int] = None
    scheduler_bulk_linger_ms: Optional[float] = None
    scheduler_bulk_headroom_floor: Optional[float] = None
    scheduler_bulk_resume_headroom: Optional[float] = None
    # AOT warmup + warm-shape routing for the staged device pipeline
    # (compile_service/); only effective with bls_backend="cuda". No
    # persistent cache: a CUDA graph cannot be written to disk. Empty
    # rungs = the default ladder.
    compile_service: bool = True
    compile_rungs: tuple = ()
    # device-resident validator pubkey table (crypto/device/key_table.py):
    # uploaded once from the chain's ValidatorPubkeyCache,
    # delta-synced on deposit admission; signature sets whose keys are
    # resident ship (B, K) indices instead of G1 limb planes. Only
    # effective with bls_backend="cuda"; LIGHTHOUSE_TPU_KEY_TABLE=0
    # disables at the env level.
    device_key_table: bool = True
    # None = LIGHTHOUSE_TPU_KEY_TABLE_MAX_AGG env (default 4096); 0
    # disables the aggregate-sum region
    key_table_max_aggregates: Optional[int] = None
    # served dp mesh width (crypto/device/mesh.py): how many
    # devices the flush planner shards (dp x rung) plans across. None =
    # env LIGHTHOUSE_TPU_DP_DEVICES (integer, or "all" to discover every
    # local device; unset = 1 — per-card health without multi-card
    # capture load). With device="cpu" every shard is the CPU.
    # Only effective with bls_backend="cuda"; LIGHTHOUSE_TPU_DP_MESH=0
    # disables the mesh entirely.
    dp_devices: Optional[int] = None
    # the watchtower (utils/watchtower.py): the background
    # evaluator walking the detector catalogue over the timeseries
    # store + slot ledger, latching incidents and writing correlated
    # forensic bundles. None = env LIGHTHOUSE_TPU_WATCHTOWER (default
    # on); evaluator cadence/bundle knobs stay env-tunable
    # (LIGHTHOUSE_TPU_WT_INTERVAL_S / _WT_COOLDOWN_S / _WT_BUNDLE /
    # _WT_BUNDLE_DIR / _WT_MAX_INCIDENTS, docs/OBSERVABILITY.md).
    watchtower: Optional[bool] = None
    # device-side operation_pool aggregation: route the
    # pool's G2 signature point-sums through the windowed-MSM surface
    # (operation_pool/device_agg.py; programs warmed on the compile
    # service's MSM ladder). OFF by default: the host fold is correct
    # and byte-identical — this only buys the batched-sum speedup. Only
    # effective with bls_backend="cuda".
    device_msm: bool = False
    # duty-lookahead precompute: a builder-owned background
    # worker that, past the trigger point inside each epoch, walks the
    # NEXT epoch's committee shuffle and pre-inserts every committee's
    # aggregate-sum G1 row into the key table's (epoch-tagged)
    # aggregate region — so a committee's FIRST sighting already ships
    # K=1 with zero host EC adds inside any verify span. None = env
    # LIGHTHOUSE_TPU_DUTY_LOOKAHEAD (default on); trigger/poll/backoff
    # knobs stay env-tunable (LIGHTHOUSE_TPU_DUTY_LOOKAHEAD_*,
    # docs/DUTY_LOOKAHEAD.md). Only effective when the device key
    # table came up — without a table there is nothing to pre-insert.
    duty_lookahead: Optional[bool] = None


class Client:
    """A built beacon node: chain + processor + API + slot timer."""

    def __init__(self, chain, processor, api, slot_clock, timer):
        self.chain = chain
        self.processor = processor
        self.api = api
        self.network = None  # attached by the builder when listening
        self.monitoring = None  # attached when a monitoring endpoint is set
        self.slot_clock = slot_clock
        self._timer = timer
        self._stop = threading.Event()

    def start(self):
        if self.api is not None:
            self.api.start()
        # capacity & saturation observability: the background
        # sampler that feeds /lighthouse/timeseries and the headroom
        # estimate in the health `capacity` block. No-op (free) when
        # LIGHTHOUSE_TPU_TIMESERIES=0.
        from .utils import timeseries, watchtower

        if timeseries.enabled():
            timeseries.start_sampler()
        # the watchtower: background detector evaluation
        # over the store the sampler just started feeding; incident
        # bundles snapshot the same (TTL-cached) health document the
        # endpoint serves. No-op when LIGHTHOUSE_TPU_WATCHTOWER=0 or
        # config.watchtower=False.
        if watchtower.enabled():
            if self.api is not None:
                watchtower.set_health_provider(self.api._health_doc)
            watchtower.start_evaluator()
        self._timer.start()
        return self

    def stop(self):
        try:
            self._stop.set()
            from .utils import timeseries, watchtower

            # evaluator before sampler: a final tick against a live
            # store beats one against a stopping one; the provider is
            # cleared so bundles never call a stopped server's cache
            watchtower.stop_evaluator()
            watchtower.set_health_provider(None)
            timeseries.stop_sampler()
            if self.api is not None:
                self.api.stop()
            monitor = getattr(self.chain, "validator_monitor", None)
            if monitor is not None:
                monitor.detach()  # stop feeding a dead client's monitor
            sched = getattr(self.chain, "verification_scheduler", None)
            if sched is not None:
                # drain BEFORE the processor joins its workers: stop()
                # resolves every queued future, and post-stop submissions
                # degrade to synchronous direct calls
                sched.stop()
            csvc = getattr(self.chain, "compile_service", None)
            if csvc is not None:
                # after the scheduler drain: in-flight flushes may still
                # route through the warm-shape registry
                from .compile_service import clear_service

                csvc.stop()
                clear_service(csvc)
            lookahead = getattr(self.chain, "duty_lookahead", None)
            if lookahead is not None:
                # before the key table closes: an in-flight warm may
                # still be pre-inserting rows into it (bounded join —
                # stop() during a warm must never wedge)
                lookahead.stop()
            ktable = getattr(self.chain, "device_key_table", None)
            if ktable is not None:
                # after the drain too: a draining flush may still pack
                # against the table. Detach only OUR table — a racing
                # rebuild must not lose its fresh one — and drop the
                # admission listener so the cache stops syncing (and
                # keeping alive) a table nothing routes to.
                from .crypto.device import key_table as _key_table

                _key_table.clear_table(ktable)
                listener = getattr(self.chain, "_key_table_listener", None)
                if listener is not None:
                    self.chain.pubkey_cache.unsubscribe(listener)
                    self.chain._key_table_listener = None
                # cancel any pending re-sync retry timer: a stopped
                # client's table must not keep syncing in the background
                ktable.close()
            mesh = getattr(self.chain, "device_mesh", None)
            if mesh is not None:
                # last: everything above may still dispatch through the
                # mesh while draining. Detach only OUR mesh — a racing
                # rebuild must not lose its fresh one. The recovery
                # worker stops FIRST with a bounded join — stop() during
                # an active probation probe must never wedge.
                from .crypto.device import mesh as _mesh_mod

                mesh.stop_recovery()
                _mesh_mod.clear_mesh(mesh)
            self.processor.shutdown()
            self.persist()
            if self.monitoring is not None:
                self.monitoring.stop()
            if self.network is not None:
                self.network.close()
        finally:
            lock = getattr(self, "_lock", None)
            if lock is not None:
                lock.release()

    def persist(self):
        """Write fork choice + op pool + slasher state to the store
        (reference shutdown persistence: ``beacon_chain.rs:400-440``,
        ``operation_pool/src/persistence.rs``)."""
        from .operation_pool.persistence import pool_to_bytes
        from .store.kv import Column

        # independent try/excepts: one failed write must not discard the
        # others, and persistence must never block shutdown
        store = self.chain.store
        try:
            store.put_blob(
                Column.FORK_CHOICE,
                b"fork_choice",
                self.chain.fork_choice_bytes(),  # chain-locked snapshot
            )
        except Exception:
            pass
        try:
            if self.chain.op_pool is not None:
                store.put_blob(
                    Column.OP_POOL, b"pool", pool_to_bytes(self.chain.op_pool)
                )
        except Exception:
            pass
        try:
            if self.chain.slasher is not None:
                self.chain.slasher.flush()
        except Exception:
            pass
        try:
            if self.network is not None:
                store.put_blob(
                    Column.METADATA,
                    b"known_peers",
                    json.dumps(self.network.discovery.addresses()).encode(),
                )
        except Exception:
            pass


class ClientBuilder:
    def __init__(self, config: ClientConfig, spec: ChainSpec | None = None):
        self.config = config
        self.preset = PRESETS[config.preset_base]
        self.spec = spec or (
            ChainSpec() if config.preset_base == "mainnet" else _minimal()
        )
        self.types = types_for(self.preset)
        self.genesis_state = None
        self.slot_clock: SlotClock | None = None

    def with_genesis_state(self, state):
        self.genesis_state = state
        return self

    def with_interop_genesis(self, validator_count: int, genesis_time: int = 0):
        from .state_transition import interop_genesis_state

        self.genesis_state = interop_genesis_state(
            self.preset, self.spec, validator_count, genesis_time=genesis_time
        )
        return self

    def with_slot_clock(self, clock: SlotClock):
        self.slot_clock = clock
        return self

    def with_checkpoint_sync(self, remote_url: str):
        """Bootstrap from a remote BN's finalized state instead of genesis
        (reference checkpoint sync, ``client/src/builder.rs:128-350``);
        history below the anchor is backfilled by the network layer."""
        from .eth2_client import BeaconNodeClient

        from .state_transition.helpers import latest_block_header_root

        remote = BeaconNodeClient(remote_url, self.types)
        state = remote.state_ssz("finalized")
        self.genesis_state = state
        # fetch the block by the root the STATE implies — "finalized" could
        # have advanced between the two requests
        anchor_root = latest_block_header_root(state)
        try:
            self._checkpoint_block = remote.block("0x" + anchor_root.hex())
        except Exception:
            self._checkpoint_block = None  # anchor block lookups 404 until synced
        return self

    def build(self) -> Client:
        cfg = self.config

        # the north-star seam: runtime backend selection
        from .crypto import backend as bls_backend

        bls_backend.set_backend(cfg.bls_backend, device=cfg.device)

        lock = None
        if cfg.datadir:
            from .utils import Lockfile

            lock = Lockfile(f"{cfg.datadir}/beacon.lock").acquire()
        try:
            return self._build_locked(cfg, lock)
        except BaseException:
            if lock is not None:
                lock.release()  # a failed build must not wedge the datadir
            raise

    def _build_locked(self, cfg, lock) -> Client:
        kv = (
            SqliteStore(f"{cfg.datadir}/chain.sqlite")
            if cfg.datadir
            else MemoryStore()
        )
        store = HotColdDB(
            kv,
            self.types,
            self.spec,
            store_replayer(self.preset, self.spec),
            slots_per_snapshot=cfg.slots_per_snapshot,
        )

        genesis = self.genesis_state
        if genesis is None:
            # resume from the store: anchor the chain at the persisted
            # HEAD's post-state (reference resume path in
            # ``client/src/builder.rs``: resume_from_db), not at genesis.
            head_root = store.get_head()
            anchor = None
            if head_root is not None:
                head_block = store.get_block(head_root)
                if head_block is not None:
                    anchor = store.get_state(bytes(head_block.message.state_root))
            if anchor is None:
                root = store.get_genesis_state_root()
                if root is None:
                    raise ValueError(
                        "no genesis state provided and none found in the store"
                    )
                anchor = store.get_state(root)
            genesis = anchor

        clock = self.slot_clock or SystemTimeSlotClock(
            genesis.genesis_time, self.spec.seconds_per_slot
        )
        chain = BeaconChain(
            self.preset, self.spec, self.types, store, genesis, slot_clock=clock
        )

        # restore persisted fork choice + op pool (reference resume:
        # beacon_chain.rs:400-440, operation_pool/src/persistence.rs)
        from .store.kv import Column

        fc_blob = store.get_blob(Column.FORK_CHOICE, b"fork_choice")
        if fc_blob is not None:
            from .fork_choice.persistence import fork_choice_from_bytes

            try:
                restored = fork_choice_from_bytes(
                    self.preset, self.spec, fc_blob
                )
            except Exception:
                restored = None  # corrupt/old blob: keep the anchor-built one
            if restored is not None:
                chain.fork_choice = restored
                # The store's HEAD advances on every recompute_head but the
                # blob is written only on finalization/shutdown: after a
                # crash the restored DAG may predate the persisted head, and
                # new blocks building on it would stall as ParentUnknown.
                # Replay the store blocks between the DAG tip and HEAD.
                # Replay failures get their OWN handler: the blob is already
                # installed, so a swallowed error here would silently keep a
                # partially-replayed DAG — log it instead.
                try:
                    _replay_fork_choice_gap(chain, store)
                except Exception as e:
                    from .utils import logging as tlog

                    tlog.log(
                        "warn", "fork-choice crash-gap replay failed",
                        error=repr(e)[:120],
                    )

        pool_blob = store.get_blob(Column.OP_POOL, b"pool")
        if pool_blob is not None:
            from .operation_pool.persistence import pool_from_bytes

            try:
                chain.op_pool = pool_from_bytes(
                    self.preset, self.spec, self.types, pool_blob
                )
            except Exception:
                chain.op_pool = OperationPool(self.preset, self.spec, self.types)
        else:
            chain.op_pool = OperationPool(self.preset, self.spec, self.types)

        if cfg.bls_backend == "cuda" and cfg.device_msm:
            # device-side pool aggregation: attach AFTER
            # construction so the persistence-restored pool gets it too;
            # also opt the compile service's AOT walk into warming the
            # MSM ladder so the first real aggregate pays no compile
            from .compile_service.service import set_msm_warm_enabled
            from .operation_pool import DeviceAggregator

            chain.op_pool.set_device_aggregator(DeviceAggregator(device=cfg.device))
            set_msm_warm_enabled(True)

        if cfg.slasher:
            from .slasher import Slasher

            # found slashings are drained into the op pool by the slot
            # timer (reference: slasher/service/src/service.rs)
            chain.slasher = Slasher(
                self.types,
                slots_per_epoch=self.preset.SLOTS_PER_EPOCH,
                store=kv,
            )
        if cfg.monitor_validators is not None:
            from .beacon_chain import ValidatorMonitor

            monitor = ValidatorMonitor(auto=cfg.monitor_validators == "auto")
            if isinstance(cfg.monitor_validators, (list, tuple, set)):
                for i in cfg.monitor_validators:
                    monitor.add_validator(int(i))
            chain.validator_monitor = monitor.attach()
        # checkpoint sync: store the anchor block so lookups resolve and
        # backfill has a starting parent
        cp_block = getattr(self, "_checkpoint_block", None)
        if cp_block is not None:
            from .ssz import hash_tree_root as _htr

            store.put_block(_htr(cp_block.message), cp_block)

        mesh = None
        if cfg.bls_backend == "cuda":
            from .crypto.device import mesh as mesh_mod

            if mesh_mod.env_enabled():
                try:
                    # mesh FIRST: the key table replicates per mesh
                    # shard and the compile service walks the mesh
                    # ladder — both read the seam at their own startup
                    want = cfg.dp_devices
                    if want is None:
                        env_n = mesh_mod.env_devices()
                        want = None if env_n == "all" else (env_n or 1)
                    if torch.device(cfg.device).type == "cuda":
                        mesh = mesh_mod.DeviceMesh(n_devices=want)
                    else:  # the caller's device for every shard
                        mesh = mesh_mod.DeviceMesh(
                            devices=[cfg.device] * (want or 1)
                        )
                    mesh_mod.set_mesh(mesh)
                    if mesh_mod.recovery_env_enabled():
                        # self-healing: lost chips enter
                        # probation and a background probe re-admits
                        # them (canary -> re-warm -> key-table re-sync)
                        mesh.start_recovery()
                except Exception as e:
                    from .utils import logging as tlog

                    tlog.log(
                        "warn", "device mesh unavailable",
                        error=repr(e)[:120],
                    )
                    mesh = None
        chain.device_mesh = mesh

        ktable = None
        if cfg.bls_backend == "cuda" and cfg.device_key_table:
            from .crypto.device import key_table as _key_table

            if _key_table.env_enabled():
                try:
                    # one upload at startup mirrors the loaded cache
                    # (restart-from-store included); import_new_pubkeys
                    # admissions delta-sync through the subscription
                    ktable = _key_table.DeviceKeyTable(
                        chain.pubkey_cache,
                        max_aggregates=cfg.key_table_max_aggregates,
                        device=cfg.device,
                    )
                    ktable.sync(reason="startup")
                    _key_table.set_table(ktable)
                    # sync_or_schedule: a failed delta
                    # schedules a full-sync retry with backoff instead
                    # of degrading batches to raw packs forever
                    listener = (
                        lambda _cache, _t=ktable:
                        _t.sync_or_schedule(reason="delta")
                    )
                    chain.pubkey_cache.subscribe(listener)
                    # stop() must be able to detach it, or admissions
                    # would keep a dead client's table alive + syncing
                    chain._key_table_listener = listener
                except Exception as e:
                    from .utils import logging as tlog

                    tlog.log(
                        "warn", "device key table unavailable",
                        error=repr(e)[:120],
                    )
                    ktable = None
        chain.device_key_table = ktable

        lookahead = None
        if ktable is not None:
            # duty-lookahead precompute: only with a live key
            # table — the worker exists to pre-insert aggregate rows
            from . import duty_lookahead as _lookahead

            want = (
                _lookahead.enabled()
                if cfg.duty_lookahead is None else cfg.duty_lookahead
            )
            if want:
                lookahead = _lookahead.DutyLookahead(
                    _lookahead.chain_duty_source(chain),
                    key_table=ktable,
                    pubkey_cache=chain.pubkey_cache,
                    device=cfg.device,
                ).start()
        chain.duty_lookahead = lookahead

        csvc = None
        if cfg.bls_backend == "cuda" and cfg.compile_service:
            from .compile_service import CompileService, set_service
            from .compile_service.service import env_enabled

            if env_enabled():
                # capture the staged rung ladder's graphs off the hot path
                # and route cold-rung traffic around captures
                csvc = CompileService(
                    rungs=cfg.compile_rungs or None,
                    device=cfg.device,
                ).start()
                set_service(csvc)  # the seam CudaBackend pads against
        chain.compile_service = csvc

        if cfg.verification_scheduler:
            # the continuous-batching layer: gossip verifiers submit
            # through chain.verification_scheduler and their signature
            # sets fuse into shared device batches across callers
            from .verification_service import VerificationScheduler

            bulk_admission = None
            if (
                cfg.scheduler_bulk_headroom_floor is not None
                or cfg.scheduler_bulk_resume_headroom is not None
            ):
                # explicit admission thresholds: build the controller
                # here; unset = the scheduler's own (env-tunable) one
                from .verification_service import BulkAdmissionController

                bulk_admission = BulkAdmissionController(
                    floor=cfg.scheduler_bulk_headroom_floor,
                    resume_headroom=cfg.scheduler_bulk_resume_headroom,
                )
            chain.verification_scheduler = VerificationScheduler(
                deadline_ms=cfg.scheduler_deadline_ms,
                max_batch_sets=cfg.scheduler_max_batch_sets,
                max_queue_sets=cfg.scheduler_max_queue_sets,
                compile_service=csvc,
                plan_flushes=cfg.scheduler_plan_flushes,
                bulk_max_queue_sets=cfg.scheduler_bulk_max_queue_sets,
                bulk_flush_sets=cfg.scheduler_bulk_flush_sets,
                bulk_linger_ms=cfg.scheduler_bulk_linger_ms,
                bulk_admission=bulk_admission,
            ).start()

        processor = _build_processor(chain, cfg.n_workers)

        network = None
        if cfg.listen_port is not None:
            from .network.service import NetworkService

            network = NetworkService(
                chain, processor, host=cfg.listen_host, port=int(cfg.listen_port)
            )
            known = store.get_blob(Column.METADATA, b"known_peers")
            if known is not None:
                try:
                    network.discovery.import_addresses(json.loads(known))
                except Exception:
                    pass
            for addr in cfg.boot_nodes:
                try:
                    host, port = addr.rsplit(":", 1)
                    network.connect(host, int(port))
                except (ValueError, OSError):
                    pass
        # the watchtower config seam: an explicit
        # cfg.watchtower overrides the LIGHTHOUSE_TPU_WATCHTOWER env
        # default; None leaves the env knob in charge
        if cfg.watchtower is not None:
            from .utils import watchtower as _watchtower

            _watchtower.configure(enabled=cfg.watchtower)
        api = (
            BeaconApiServer(chain, cfg.http_host, cfg.http_port)
            if cfg.http_enabled
            else None
        )
        stop = threading.Event()
        timer = threading.Thread(
            target=_slot_timer, args=(chain, clock, stop), daemon=True
        )
        client = Client(chain, processor, api, clock, timer)
        client.network = network
        if cfg.monitoring_endpoint:
            from .utils.monitoring import MonitoringService

            client.monitoring = MonitoringService(
                chain, cfg.monitoring_endpoint
            ).start()
        client._stop = stop
        client._lock = lock
        return client


def _replay_fork_choice_gap(chain, store) -> None:
    """Walk back from the store's persisted HEAD to the first block the
    restored fork choice knows, then replay the gap (oldest first) into
    it so the resumed node can extend its own pre-crash head."""
    head_root = store.get_head()
    proto = chain.fork_choice.proto
    if head_root is None or proto.contains(head_root):
        return
    gap = []
    root = head_root
    while root is not None and not proto.contains(root):
        block = store.get_block(root)
        if block is None:
            return  # chain of unknown ancestry: keep the blob's DAG as-is
        gap.append((root, block))
        parent = bytes(block.message.parent_root)
        root = parent if any(parent) else None
    if root is None:
        return  # walked past genesis without meeting the DAG
    for blk_root, block in reversed(gap):
        state = store.get_state(bytes(block.message.state_root))
        if state is None:
            return
        chain.fork_choice.on_block(
            int(block.message.slot), block.message, blk_root, state
        )


def _build_processor(chain, n_workers: int) -> BeaconProcessor:
    """Wire the gossip work kinds to the chain's batch verifiers
    (reference ``worker/gossip_methods.rs`` entry points)."""

    def on_attestation_batch(items):
        results = chain.batch_verify_unaggregated_attestations_for_gossip(items)
        for r in results:
            if isinstance(r, VerifiedUnaggregatedAttestation):
                chain.apply_attestation_to_fork_choice(r)
                if chain.op_pool is not None:
                    chain.op_pool.insert_attestation(r.attestation)
                if chain.slasher is not None:
                    chain.slasher.accept_attestation(r.indexed)
        return results

    def on_aggregate_batch(items):
        results = chain.batch_verify_aggregated_attestations_for_gossip(items)
        for r in results:
            if isinstance(r, VerifiedAggregatedAttestation):
                chain.apply_attestation_to_fork_choice(r)
                if chain.op_pool is not None:
                    chain.op_pool.insert_attestation(r.signed_aggregate.message.aggregate)
                if chain.slasher is not None:
                    chain.slasher.accept_attestation(r.indexed)
        return results

    def on_block(item):
        # the slasher must see the header BEFORE gossip verification: an
        # equivocating second block is rejected there as RepeatProposal,
        # which is exactly the event that yields a ProposerSlashing
        if chain.slasher is not None:
            msg = item.message
            from .ssz import hash_tree_root as _htr

            header = chain.types.SignedBeaconBlockHeader(
                message=chain.types.BeaconBlockHeader(
                    slot=msg.slot,
                    proposer_index=msg.proposer_index,
                    parent_root=msg.parent_root,
                    state_root=msg.state_root,
                    body_root=_htr(msg.body),
                ),
                signature=item.signature,
            )
            found = chain.slasher.check_block_header(header)
            if found is not None and chain.op_pool is not None:
                chain.op_pool.insert_proposer_slashing(found)
        gossip = chain.verify_block_for_gossip(item)
        return chain.process_block(gossip)

    def on_chain_segment(item):
        return chain.process_chain_segment(item)

    def on_sync_message_batch(items):
        from .beacon_chain.sync_committee_verification import (
            VerifiedSyncCommitteeMessage,
            batch_verify_sync_committee_messages,
        )

        results = batch_verify_sync_committee_messages(chain, items)
        if chain.op_pool is not None:
            for v in results:
                if isinstance(v, VerifiedSyncCommitteeMessage):
                    m = v.message
                    for pos in v.positions:
                        chain.op_pool.insert_sync_committee_message(
                            int(m.slot),
                            bytes(m.beacon_block_root),
                            pos,
                            bytes(m.signature),
                        )
        return results

    def on_sync_contribution(item):
        from .beacon_chain import verify_sync_contribution

        v = verify_sync_contribution(chain, item)
        if chain.op_pool is not None:
            chain.op_pool.insert_sync_contribution(item.message.contribution)
        return v

    processor = BeaconProcessor(
        {
            WorkKind.GOSSIP_ATTESTATION: on_attestation_batch,
            WorkKind.GOSSIP_AGGREGATE: on_aggregate_batch,
            WorkKind.GOSSIP_SYNC_MESSAGE: on_sync_message_batch,
            WorkKind.GOSSIP_SYNC_CONTRIBUTION: on_sync_contribution,
            WorkKind.GOSSIP_BLOCK: on_block,
            WorkKind.CHAIN_SEGMENT: on_chain_segment,
        },
        n_workers=n_workers,
    )
    # the /lighthouse/health surface reads queue depths off the chain
    chain.beacon_processor = processor
    return processor


def _slot_timer(chain, clock, stop: threading.Event) -> None:
    """Per-slot tick (reference ``timer/src/lib.rs``): advance fork
    choice's clock and re-evaluate the head each slot, until stopped."""
    last = -1
    last_pruned_epoch = [0]
    while not stop.is_set():
        slot = clock.now()
        if slot != last:
            try:
                chain.on_tick(slot)
            except Exception:
                pass
            if chain.slasher is not None:
                # periodic batch processing + evidence → op pool, and
                # pruning on finalization advance (reference:
                # slasher/service/src/service.rs)
                try:
                    chain.slasher.process_queued()
                    net = getattr(chain, "network", None)
                    while chain.slasher.found_attester_slashings:
                        s = chain.slasher.found_attester_slashings.pop(0)
                        if chain.op_pool is not None:
                            chain.op_pool.insert_attester_slashing(s)
                        # equivocators lose fork-choice weight immediately,
                        # same as evidence submitted via the API pool route
                        chain.on_attester_slashing(s)
                        if net is not None:
                            net.publish_attester_slashing(s)
                    while chain.slasher.found_proposer_slashings:
                        s = chain.slasher.found_proposer_slashings.pop(0)
                        if chain.op_pool is not None:
                            chain.op_pool.insert_proposer_slashing(s)
                        if net is not None:
                            net.publish_proposer_slashing(s)
                    fin = chain.fork_choice.store.finalized_checkpoint[0]
                    if fin > last_pruned_epoch[0]:
                        chain.slasher.prune(fin)
                        last_pruned_epoch[0] = fin
                except Exception:
                    pass
            last = slot
        # state-advance timer (reference state_advance_timer.rs:93-231):
        # in the last quarter of the slot, pre-advance the head state to
        # the next slot so the boundary spike is paid off-path
        remaining = clock.duration_to_next_slot()
        seconds_per_slot = getattr(clock, "seconds_per_slot", 12)
        if remaining < seconds_per_slot / 4:
            try:
                chain.advance_head_state_to(slot + 1)
            except Exception:
                pass
        stop.wait(min(1.0, max(0.05, remaining)))


def _minimal() -> ChainSpec:
    from .types.chain_spec import minimal_spec

    return minimal_spec()
