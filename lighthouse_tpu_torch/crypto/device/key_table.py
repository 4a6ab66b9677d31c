"""Device-resident validator pubkey table: the port of the JAX package's
``crypto/device/key_table.py``.

* **One device tensor, index-keyed.** Limb-packed G1 affine rows
  (``int32[cap, 2, NL]``, the layout ``curve.pack_g1`` produces and
  ``_stage2_fn`` consumes), uploaded once from a host pubkey cache and
  delta-updated as deposits are admitted. Row index == validator index,
  append-only (an exited validator keeps its row). Uploads are chunked
  (``upload_chunk_rows`` rows per host-to-device copy); capacity moves on
  :data:`CAPACITY_LADDER`, and growth copies the resident rows on the
  device (nothing is uploaded again).
* **Identity pinned to the host cache.** Pubkey points resolve through an
  ``id(point) -> index`` map built only from the cache's own point
  objects (the cache list is append-only and the table holds the cache
  alive, so a hit proves the argument IS that object). A set built from
  any other point, even a byte-equal one, misses the map and the batch
  falls back to the raw limb-plane pack.
* **Aggregate-pubkey rows.** A committee whose index tuple repeats
  collapses to ONE row of a small aggregate region holding the host-summed
  point, so a K-wide set ships one index (K = 1). Sums are inserted on the
  ``agg_min_repeats``-th sighting of a tuple; each entry is tagged with
  the epoch it serves (the port's slot clock) and evicted two epochs
  later onto a free list; a wholesale reset is the last resort when the
  region fills inside one epoch. :meth:`DeviceKeyTable.insert_precomputed`
  lets a caller insert a committee sum ahead of time (the duty
  lookahead's entry), so its first sighting already ships K = 1.

Snapshot semantics (the JAX table gets them from functional updates):
a ``(table, agg)`` pair that :meth:`~DeviceKeyTable.resolve_sets` returned
never changes under a batch that still holds it.

* An aggregate-region insert writes a NEW tensor (a clone of the region,
  about 1 MB at 4,096 slots), never in place: a freed slot can be reused
  while a queued batch still gathers from the old row.
* Validator rows at or above the resident count are never indexed, so a
  delta writes them in place; growth allocates the next rung and copies
  on the device.
* Sync is all-or-nothing: if a delta fails part-way, ``len(table)`` and
  the identity map do not change.

The verdict is identical by construction: gathered rows are the limbs
the raw packer ships, and an aggregate row is the group element the
device's masked K-axis sum produces (a sum that is infinity is never
cached, so it keeps failing through the device's ``agg_inf_bad`` screen).

Threads and CUDA graph captures. :meth:`~DeviceKeyTable.sync`, the
aggregate inserts and growth write to the card from the calling thread,
on that thread's current stream: host-to-device copies from pageable
memory, new tensors, device-side copies. They take no device lock and
need none. A capture (``graphs.py``) runs in CUDA's "thread_local" mode,
which bars only the capturing thread from such calls, and the caching
allocator sends only the capture stream's allocations to the graph's
private pool; so a sync, an insert or a growth on another thread may run
while the compile service's worker captures, and none of its memory
lands in a graph. No graph reads the table's tensors: the gather stays
eager (``bls.verify_batch_raw_staged_gather`` says why).

Replicas. Without a mesh one replica (shard 0) lives on the table's
``device`` (``cuda`` by default). With a mesh attached (``mesh.py``) at
the first sync, the table keeps one replica per mesh shard, each on its
shard's device (the table's ``device`` for a placeholder shard), pinned
for the table's life. Every sync, insert and growth applies to every
replica, all-or-nothing; upload bytes are counted per replica; and
:meth:`~DeviceKeyTable.resolve_sets` serves the replica of the calling
thread's dispatch shard (``mesh.current_shard()``, else the lowest).
The process-global seam (:func:`set_table` / :func:`get_active_table`)
lets :class:`~.bls.CudaBackend` reach the table without a handle.

Telemetry, as the JAX table's: six ``bls_device_key_table_*`` families
(entries, device bytes, upload bytes, sets by shipping path, re-syncs,
aggregate-cache events), one ``key_table_sync`` journal event per sync
that added rows, ``key_table_reset`` when retention evicts or recycles
aggregate rows, and each committee consult noted to the slot ledger as a
first sighting or a hit.
"""

from __future__ import annotations

import hashlib
import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils import fault_injection, flight_recorder, metrics, slot_clock, slot_ledger
from . import curve
from . import mesh as _mesh

# limbs per field element (== fp.NL)
NL = 32
G1_ROW_SHAPE = (2, NL)          # affine (x, y) limb rows
G1_ROW_BYTES = 2 * NL * 4       # int32

# Validator-region capacity ladder: capacity moves in coarse steps, so a
# table grows a handful of times between genesis and a 1M registry.
CAPACITY_LADDER = (1024, 4096, 16384, 65536, 262144, 1048576)

_ENV_ENABLED = "LIGHTHOUSE_TPU_KEY_TABLE"
_ENV_MAX_AGG = "LIGHTHOUSE_TPU_KEY_TABLE_MAX_AGG"
_ENV_CHUNK = "LIGHTHOUSE_TPU_KEY_TABLE_CHUNK"
# re-sync retry: a failed admission delta schedules a full-sync retry with
# capped exponential backoff and jitter (sync always catches the mirror up
# to the whole host cache, so one retry covers any number of missed deltas)
_ENV_RESYNC_BASE = "LIGHTHOUSE_TPU_KEY_TABLE_RESYNC_BASE_S"
_ENV_RESYNC_MAX = "LIGHTHOUSE_TPU_KEY_TABLE_RESYNC_MAX_S"

DEFAULT_MAX_AGGREGATES = 4096
DEFAULT_UPLOAD_CHUNK_ROWS = 65536
DEFAULT_AGG_MIN_REPEATS = 2
DEFAULT_RESYNC_BASE_S = 1.0
DEFAULT_RESYNC_MAX_S = 60.0
# the repeat-counting sketch is bounded: past this many distinct tuples it
# resets wholesale (it only gates inserts; losing it costs one sighting)
_AGG_SEEN_CAP = 65536

_log = logging.getLogger(__name__)


def table_capacity(n: int) -> int:
    """Validator-region capacity for ``n`` resident rows: the smallest
    ladder rung covering it (beyond the ladder: the next 1M multiple)."""
    for c in CAPACITY_LADDER:
        if n <= c:
            return c
    top = CAPACITY_LADDER[-1]
    return ((n + top - 1) // top) * top


def env_enabled() -> bool:
    return os.environ.get(_ENV_ENABLED, "1") not in ("", "0")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Telemetry: the JAX table's families, under the bls_device_ prefix
# ---------------------------------------------------------------------------

_ENTRIES = metrics.gauge_vec(
    "bls_device_key_table_entries",
    "rows resident in the device pubkey table, by region (validators = "
    "index-identical mirror of the host pubkey cache, append-only; "
    "aggregates = cached epoch-stable aggregate-pubkey sums)",
    ("region",),
)
_DEVICE_BYTES = metrics.gauge(
    "bls_device_key_table_device_bytes",
    "device bytes held by the pubkey table's tensors (validator capacity "
    "+ aggregate region, limb-packed G1 rows, every replica)",
)
_UPLOAD_BYTES = metrics.counter_vec(
    "bls_device_key_table_upload_bytes_total",
    "host-to-device bytes uploaded into the key table, by reason "
    "(startup = initial mirror, delta = deposit admissions, aggregate = "
    "cached committee sums; counted per replica). Capacity growth copies "
    "on the device and uploads nothing",
    ("reason",),
)
_SETS = metrics.counter_vec(
    "bls_device_key_table_sets_total",
    "signature sets by pubkey-shipping path: indexed = shipped as table "
    "indices (device gather), collapsed = shipped as ONE cached "
    "aggregate-sum index (K=1), raw = table attached but at least one "
    "key not resident, so the whole batch fell back to the G1 limb "
    "plane. hit ratio = (indexed+collapsed) / all",
    ("path",),
)
_RESYNCS = metrics.counter_vec(
    "bls_device_key_table_resyncs_total",
    "full-sync retries after a failed mirror sync: scheduled = a retry "
    "timer armed with backoff, ok = a retry caught the mirror up, error "
    "= a retry failed (and re-scheduled)",
    ("outcome",),
)
_AGG_EVENTS = metrics.counter_vec(
    "bls_device_key_table_agg_events_total",
    "aggregate-sum cache LOOKUP events: hit (cached tuple found), miss "
    "(tuple not cached), insert (host sum computed + row uploaded), "
    "precomputed (insert_precomputed), evict (entry dropped by two-epoch "
    "retention, slot freed), reset (region recycled wholesale, the "
    "same-epoch-full last resort)",
    ("event",),
)


class KeyTableError(RuntimeError):
    """Host-cache/device-table identity cannot be maintained (gap,
    shrunken cache, invalid row). Raised before any table state commits:
    sync is all-or-nothing."""


class DeviceKeyTable:
    """Device mirror of a host pubkey cache (see the module docstring).

    ``cache`` needs only a ``pubkeys`` list of objects with a ``.point``
    (``bls.PublicKey`` qualifies) that is append-only for the table's
    lifetime. The table holds ``cache`` alive, which is what makes the
    ``id(point)`` identity map sound."""

    def __init__(
        self,
        cache,
        max_aggregates: Optional[int] = None,
        upload_chunk_rows: Optional[int] = None,
        agg_min_repeats: int = DEFAULT_AGG_MIN_REPEATS,
        device="cuda",
    ):
        self.cache = cache
        self.device = torch.device(device)
        if max_aggregates is None:
            max_aggregates = _env_int(_ENV_MAX_AGG, DEFAULT_MAX_AGGREGATES)
        if upload_chunk_rows is None:
            upload_chunk_rows = _env_int(_ENV_CHUNK, DEFAULT_UPLOAD_CHUNK_ROWS)
        self.max_aggregates = max(0, int(max_aggregates))
        self.upload_chunk_rows = max(1, int(upload_chunk_rows))
        self.agg_min_repeats = max(1, int(agg_min_repeats))
        self._lock = threading.Lock()
        # TWO tensors per replica (dicts shard -> tensor, key 0 without a
        # mesh): the validator mirror [cap_v, 2, NL] and the small
        # aggregate region [max(1, max_agg), 2, NL]. Separate so an
        # aggregate insert clones ~1 MB per replica, not the (up to
        # 256 MB) validator table, and so cached sums survive
        # validator-capacity growth (the encoded index cap_v + slot is
        # recomputed on every resolve). Both dicts are replaced wholesale
        # at a commit, never mutated, so a snapshot stays whole.
        self._dev: Dict[int, torch.Tensor] = {}
        self._agg_dev: Dict[int, torch.Tensor] = {}
        self._cap_v = 0                     # validator-region capacity
        self._n = 0                         # validator rows resident
        self._point_ids: Dict[int, int] = {}
        # aggregate region (slots live at index cap_v + slot). Resets are
        # DEFERRED to the start of the next resolve_sets call and guarded
        # by a generation counter: a slot handed out earlier in a batch
        # must stay valid until that batch's snapshot is taken.
        self._agg_slots: Dict[bytes, Optional[int]] = {}  # None = never cache
        self._agg_seen: Dict[bytes, int] = {}
        self._agg_next = 0                  # slot high-water mark
        self._agg_resets = 0
        self._agg_gen = 0
        self._agg_reset_pending = False
        # epoch-tagged retention: each entry carries the epoch it serves;
        # entries two epochs old move to the free list at the epoch roll
        self._agg_epochs: Dict[bytes, int] = {}
        self._agg_free: List[int] = []
        self._agg_resident = 0
        self._agg_epoch_seen: Optional[int] = None
        self._agg_evictions = 0
        self._agg_precomputed = 0
        # shadow counters for status()
        self._uploads = {"startup": 0, "delta": 0, "aggregate": 0}
        self._sets = {"indexed": 0, "collapsed": 0, "raw": 0}
        self._agg_hits = 0
        self._agg_inserts = 0
        self._agg_sum_s = 0.0               # host seconds spent on sums
        # re-sync retry state: one pending timer at a time, backoff grows
        # with consecutive failures, close() cancels
        self._resync_lock = threading.Lock()
        self._resync_base_s = _env_float(_ENV_RESYNC_BASE, DEFAULT_RESYNC_BASE_S)
        self._resync_max_s = _env_float(_ENV_RESYNC_MAX, DEFAULT_RESYNC_MAX_S)
        self._resync_failures = 0
        self._resync_timer: Optional[threading.Timer] = None
        self._resyncs = {"scheduled": 0, "ok": 0, "error": 0}
        self._closed = False

    # -- mesh replicas ------------------------------------------------------

    def _replica_shards(self) -> List[int]:
        """The shards this table mirrors onto: every mesh shard (lost ones
        included: a restored card must find its rows), else shard 0.
        Pinned to the first sync's answer."""
        if self._dev:
            return sorted(self._dev)
        mesh = _mesh.get_active_mesh()
        if mesh is not None:
            return mesh.all_shards()
        return [0]

    def _resolve_shard_locked(self) -> Optional[int]:
        """The replica the calling thread gathers from: its dispatch shard
        when set, else the lowest replica; None when that shard has no
        replica (the caller then packs raw planes)."""
        shard = _mesh.current_shard()
        if shard is None:
            return min(self._dev) if self._dev else None
        return shard if shard in self._dev else None

    # -- sync (startup + delta admission) ---------------------------------

    def sync(self, reason: str = "delta") -> int:
        """Mirror host-cache rows [resident, len(cache)) onto every
        replica. ALL-OR-NOTHING across the replicas: rows are validated
        and packed, and the new rows written past the resident count (or
        into a grown tensor) on every replica, before any table state
        commits; a gap or invalid row raises :class:`KeyTableError` and
        leaves the table as it was. Returns the number of rows added.

        Packing and the upload run outside the table lock against
        snapshots; the commit re-checks them and redoes the work if a
        concurrent sync committed first. The ``key_table_sync`` fault
        point fires first, before any state is touched."""
        fault_injection.fire("key_table_sync")
        shards = self._replica_shards()
        for _attempt in range(16):
            with self._lock:
                n_start = self._n
                cap_start = self._cap_v
                dev_start = dict(self._dev)
                pubkeys = list(self.cache.pubkeys)
            n_host = len(pubkeys)
            if n_host < n_start:
                raise KeyTableError(
                    f"host cache shrank to {n_host} rows below the "
                    f"{n_start} resident device rows: the cache contract "
                    f"is append-only"
                )
            if n_host == n_start:
                return 0
            rows, points = self._pack_rows(pubkeys[n_start:n_host], n_start)
            new_dev: Dict[int, torch.Tensor] = {}
            cap_v = cap_start
            grew = False
            for s in shards:
                dev, cap_v, grew_s = self._grown_array(
                    dev_start.get(s), cap_start, n_start, n_host,
                    _mesh.device_of(s, self.device),
                )
                grew = grew or grew_s
                self._write_rows(dev, n_start, rows)
                new_dev[s] = dev
            fresh_agg = None
            if not self._agg_dev:
                # max(1, ...): a zero-row region would make the gather's
                # index_select degenerate; with max_aggregates=0 no
                # aggregate index is ever issued
                fresh_agg = {
                    s: torch.zeros(
                        (max(1, self.max_aggregates), *G1_ROW_SHAPE),
                        dtype=torch.int32, device=_mesh.device_of(s, self.device),
                    )
                    for s in shards
                }
            with self._lock:
                if self._n != n_start or any(
                    self._dev.get(s) is not dev_start.get(s) for s in shards
                ):
                    continue  # a concurrent sync committed first: redo
                self._dev = new_dev
                if not self._agg_dev:
                    self._agg_dev = fresh_agg
                self._cap_v = cap_v
                for i, p in enumerate(points):
                    self._point_ids[id(p)] = n_start + i
                self._n = n_host
                nbytes = int(rows.nbytes) * len(shards)
                self._uploads[reason] = self._uploads.get(reason, 0) + nbytes
                device_rows = sum(int(t.shape[0]) for t in (*self._dev.values(),
                                                            *self._agg_dev.values()))
            _ENTRIES.with_labels("validators").set(n_host)
            _DEVICE_BYTES.set(device_rows * G1_ROW_BYTES)
            _UPLOAD_BYTES.with_labels(reason).inc(nbytes)
            flight_recorder.record(
                "key_table_sync",
                reason=reason,
                added=n_host - n_start,
                resident=n_host,
                capacity=cap_v,
                upload_bytes=nbytes,
                replicas=len(shards),
                grew=grew,
            )
            return n_host - n_start
        raise KeyTableError("sync starved by concurrent syncs")

    def _pack_rows(self, new: Sequence, base_index: int):
        """Validate and limb-pack host pubkeys into int32[n, 2, NL] rows.
        Raises before any device state is touched."""
        points = []
        for off, pk in enumerate(new):
            point = getattr(pk, "point", None)
            if point is None or point.is_infinity():
                raise KeyTableError(
                    f"invalid pubkey at cache index {base_index + off}: "
                    f"{'infinity' if point is not None else 'no point'}; "
                    f"admission must reject it before the device mirror"
                )
            points.append(point)
        rows, inf = curve.pack_g1(points)
        if inf.any():
            raise KeyTableError("infinity row survived packing")
        return np.ascontiguousarray(rows, np.int32), points

    def _grown_array(self, dev_start, cap_start: int, n_start: int, n_host: int,
                     device: torch.device):
        """(tensor sized for n_host, cap_v, grew) for one replica: the
        snapshot tensor when its capacity suffices, else the next ladder
        rung allocated on the replica's ``device`` with the resident rows
        copied device-side."""
        cap_v = table_capacity(n_host)
        if dev_start is not None and cap_v <= cap_start:
            return dev_start, cap_start, False
        dev = torch.zeros((cap_v, *G1_ROW_SHAPE), dtype=torch.int32,
                          device=device)
        if dev_start is not None and n_start:
            dev[:n_start].copy_(dev_start[:n_start])
        return dev, cap_v, dev_start is not None

    def _write_rows(self, dev: torch.Tensor, offset: int, rows: np.ndarray) -> None:
        """Host-to-device upload of ``rows`` into ``dev`` at ``offset``, one
        copy per ``upload_chunk_rows`` rows. Only rows at or above the
        resident count are written, which no snapshot indexes."""
        for i in range(0, len(rows), self.upload_chunk_rows):
            part = torch.from_numpy(rows[i: i + self.upload_chunk_rows])
            dev[offset + i: offset + i + len(part)].copy_(part)

    def _agg_with_rows(self, writes: List[Tuple[int, np.ndarray]]) -> Dict[int, torch.Tensor]:
        """NEW aggregate-region tensors, one per replica: each current one
        cloned on its device with ``writes`` ((slot, row int32[1, 2, NL])
        pairs) applied, in one upload per replica. The old tensors stay as
        they were for any batch that still holds them."""
        slots = torch.tensor([s for s, _ in writes], dtype=torch.int64)
        rows = torch.from_numpy(np.concatenate([r for _, r in writes]))
        out = {}
        for s, region in self._agg_dev.items():
            agg = region.clone()
            agg.index_copy_(0, slots.to(agg.device), rows.to(agg.device))
            out[s] = agg
        return out

    # -- re-sync retry ------------------------------------------------------

    def sync_or_schedule(self, reason: str = "delta") -> Optional[int]:
        """The admission listener's entry: try the sync; on failure
        schedule a full-sync retry with backoff and return None instead of
        raising into the admission path. Meanwhile non-resident keys fall
        back to the raw pack (same verdict)."""
        try:
            n = self.sync(reason=reason)
        except Exception as e:
            self._schedule_resync(e)
            return None
        with self._resync_lock:
            self._resync_failures = 0
        return n

    def _schedule_resync(self, error: BaseException) -> None:
        with self._resync_lock:
            if self._closed:
                return
            self._resync_failures += 1
            fails = self._resync_failures
            if self._resync_timer is not None:
                return  # one pending retry at a time; it re-syncs fully
            delay = min(
                self._resync_max_s,
                self._resync_base_s * (2.0 ** (fails - 1)),
            ) * random.uniform(0.5, 1.0)
            t = threading.Timer(delay, self._resync_run)
            t.daemon = True
            self._resync_timer = t
            self._resyncs["scheduled"] += 1
            t.start()
        _RESYNCS.with_labels("scheduled").inc()
        _log.warning("key-table sync failed (%d in a row), full-sync retry in "
                     "%.3f s: %r", fails, delay, error)

    def _resync_run(self) -> None:
        with self._resync_lock:
            self._resync_timer = None
            if self._closed:
                return
        try:
            self.sync(reason="recovery")
        except Exception as e:
            with self._resync_lock:
                self._resyncs["error"] += 1
            _RESYNCS.with_labels("error").inc()
            self._schedule_resync(e)
            return
        with self._resync_lock:
            self._resync_failures = 0
            self._resyncs["ok"] += 1
        _RESYNCS.with_labels("ok").inc()

    def close(self) -> None:
        """Stop the retry machinery: cancel any pending re-sync timer and
        refuse new ones."""
        with self._resync_lock:
            self._closed = True
            t = self._resync_timer
            self._resync_timer = None
        if t is not None:
            t.cancel()

    # -- resolution ---------------------------------------------------------

    def index_of_point(self, point) -> Optional[int]:
        """Validator index of ``point`` IF it is the host cache's own
        object (identity, not equality)."""
        return self._point_ids.get(id(point))

    def resolve_sets(self, sets):
        """Resolve prepared ``(sig, [G1Point...], msg)`` triples to table
        indices. Returns ``None`` when ANY pubkey is not resident (the
        caller falls back to the raw pack), else ``(per_set_index_lists,
        validator_tensor, aggregate_tensor, n_collapsed)``, where the two
        snapshots hold every returned index. Two-phase: every set's
        indices resolve before any aggregate-cache mutation, so a batch
        that falls back raw pays no host sums or row uploads.

        The indexed/collapsed accounting is the dispatcher's
        (:meth:`count_shipped`); only the raw fallback is counted here."""
        with self._lock:
            if not self._dev:
                return None
            # the replica the calling thread's dispatch shard gathers
            # from, resolved first: a shard with no replica falls back
            # raw before any aggregate-cache work
            shard = self._resolve_shard_locked()
            if shard is None:
                self._sets["raw"] += len(sets)
                _SETS.with_labels("raw").inc(len(sets))
                return None
            # epoch-tagged retention, applied only HERE, before any slot
            # of this batch is handed out: at an epoch roll, entries two
            # epochs old move to the free list; the wholesale reset fires
            # only when the region filled and eviction freed nothing
            cur_epoch = slot_clock.get_clock().current_epoch()
            if self._agg_epoch_seen != cur_epoch:
                self._agg_epoch_seen = cur_epoch
                self._evict_stale_locked(cur_epoch, journal=True)
            if self._agg_reset_pending:
                self._agg_reset_pending = False
                if not self._agg_free and not self._evict_stale_locked(
                        cur_epoch, journal=True):
                    self._reset_aggregates_locked(journal=True)
            resolved: List[List[int]] = []
            for _sig, pks, _msg in sets:
                idxs = []
                for p in pks:
                    i = self._point_ids.get(id(p))
                    if i is None:
                        self._sets["raw"] += len(sets)
                        _SETS.with_labels("raw").inc(len(sets))
                        return None
                    idxs.append(i)
                resolved.append(idxs)
            # the batch is fully resident: NOW consult the aggregate cache.
            # Hits record the RAW slot; encoding against the validator
            # capacity happens in the commit lock, because a concurrent
            # capacity-growing sync between the phases moves the base
            hits: Dict[int, int] = {}          # set position -> raw slot
            miss_positions: Dict[bytes, List[int]] = {}
            cand_keys: Dict[bytes, list] = {}  # key -> pks, ONE sum per key
            if self.max_aggregates:
                for j, (idxs, (_sig, pks, _msg)) in enumerate(zip(resolved, sets)):
                    if len(idxs) <= 1:
                        continue
                    key = self._agg_key(idxs)
                    slot = self._agg_slots.get(key, -1)
                    if slot is None:
                        continue  # known uncacheable (the sum is infinity)
                    if slot >= 0:
                        self._agg_hits += 1
                        _AGG_EVENTS.with_labels("hit").inc()
                        # chain time: a collapsed K=1 row served this
                        # committee (the per-epoch dial's numerator)
                        slot_ledger.note_committee_sighting("hit")
                        hits[j] = slot
                        continue
                    _AGG_EVENTS.with_labels("miss").inc()
                    # a first sighting: host EC sum territory (first +
                    # hits = committee sightings)
                    slot_ledger.note_committee_sighting("first")
                    miss_positions.setdefault(key, []).append(j)
                    if len(self._agg_seen) >= _AGG_SEEN_CAP:
                        self._agg_seen.clear()
                    seen = self._agg_seen.get(key, 0) + 1
                    self._agg_seen[key] = seen
                    if seen >= self.agg_min_repeats:
                        # N repeats of one tuple in one batch pay ONE sum
                        cand_keys.setdefault(key, list(pks))
            gen = self._agg_gen
        # host EC sums and packing WITHOUT the lock: a 512-member sum is
        # hundreds of pure-Python point adds
        t0 = time.perf_counter()
        prepared: List[Tuple[bytes, Optional[np.ndarray]]] = []
        for key, pks in cand_keys.items():
            agg = pks[0]
            for p in pks[1:]:
                agg = agg + p
            if agg.is_infinity():
                # never cache: the raw path fails this set through the
                # device's agg_inf_bad screen; keep ONE behaviour
                prepared.append((key, None))
            else:
                rows, _inf = curve.pack_g1([agg])
                prepared.append((key, np.ascontiguousarray(rows, np.int32)))
        sum_s = time.perf_counter() - t0
        with self._lock:
            self._agg_sum_s += sum_s
            if self._agg_gen != gen:
                # a reset raced this batch: every slot assigned above may
                # have been recycled; ship K indices (correct, not collapsed)
                hits = {}
            else:
                writes: List[Tuple[int, np.ndarray]] = []
                for key, row in prepared:
                    if row is None:
                        self._agg_slots[key] = None
                        continue
                    slot = self._agg_slots.get(key, -1)
                    if slot is None:
                        continue
                    if slot < 0:
                        if self._agg_free:
                            # slots freed by eviction are reused first
                            slot = self._agg_free.pop()
                        elif self._agg_next < self.max_aggregates:
                            slot = self._agg_next
                            self._agg_next += 1
                        else:
                            # region full: recycle at the START of the next
                            # batch (eviction first, wholesale reset last)
                            self._agg_reset_pending = True
                            continue
                        writes.append((slot, row))
                        self._agg_slots[key] = slot
                        self._agg_epochs[key] = cur_epoch
                        self._agg_resident += 1
                        self._agg_inserts += 1
                        # per replica: the row crossed to every card
                        row_bytes = G1_ROW_BYTES * len(self._agg_dev)
                        self._uploads["aggregate"] += row_bytes
                        _AGG_EVENTS.with_labels("insert").inc()
                        _UPLOAD_BYTES.with_labels("aggregate").inc(row_bytes)
                        _ENTRIES.with_labels("aggregates").set(self._agg_resident)
                    # slot >= 0 also covers a raced duplicate insert: reuse
                    # that row for every position of this tuple
                    for j in miss_positions.get(key, ()):
                        hits[j] = slot
                if writes:
                    self._agg_dev = self._agg_with_rows(writes)
            # encode against the CURRENT base, inside the lock the
            # snapshots are taken under
            for j, slot in hits.items():
                resolved[j] = [self._cap_v + slot]
            # dicts are replaced wholesale, so the phase-1 shard is there
            return resolved, self._dev[shard], self._agg_dev[shard], len(hits)

    def covers_sets(self, sets) -> bool:
        """Would :meth:`resolve_sets` succeed for these sets? Accepts
        ``SignatureSet`` objects or ``(sig, pks, msg)`` triples.
        ``signing_indices`` is a fast pre-filter; the identity map is the
        ground truth either way."""
        if self._n == 0:
            return False
        for item in sets:
            keys = getattr(item, "signing_keys", None)
            if keys is None and isinstance(item, (tuple, list)) and len(item) == 3:
                keys = item[1]
            if not keys:
                return False
            idxs = getattr(item, "signing_indices", None)
            if idxs is not None and any(not 0 <= int(i) < self._n for i in idxs):
                return False
            for pk in keys:
                point = getattr(pk, "point", pk)
                if id(point) not in self._point_ids:
                    return False
        return True

    # -- aggregate-sum cache --------------------------------------------------

    @staticmethod
    def _agg_key(idxs: Sequence[int]) -> bytes:
        # order-insensitive: the sum is commutative, so two aggregates over
        # the same participants share one row
        h = hashlib.blake2b(digest_size=16)
        for i in sorted(idxs):
            h.update(int(i).to_bytes(8, "little"))
        return h.digest()

    def insert_precomputed(self, idxs, point, epoch: Optional[int] = None) -> str:
        """Insert the aggregate sum ``point`` for validator-index tuple
        ``idxs``, computed off the hot path and tagged for ``epoch``
        (default: the clock's NEXT epoch). Bypasses ``agg_min_repeats``,
        so the committee's first sighting already ships K = 1. Never
        forces the wholesale reset: when the region is full and eviction
        frees nothing, the insert is declined (``"full"``).

        Returns ``inserted`` | ``exists`` (already cached; retention
        extended through the target epoch) | ``infinity`` (never cached) |
        ``never_cache`` (marked infinity before) | ``full`` | ``unsynced``
        (no device region yet) | ``disabled``."""
        idxs = [int(i) for i in idxs]
        if self.max_aggregates <= 0 or len(idxs) <= 1:
            return "disabled"
        key = self._agg_key(idxs)
        if point is None or point.is_infinity():
            with self._lock:
                self._agg_slots[key] = None
            return "infinity"
        rows, inf = curve.pack_g1([point])
        if inf.any():
            return "infinity"
        row = np.ascontiguousarray(rows, np.int32)
        with self._lock:
            if not self._agg_dev:
                return "unsynced"
            cur_epoch = slot_clock.get_clock().current_epoch()
            tag = (cur_epoch + 1) if epoch is None else int(epoch)
            existing = self._agg_slots.get(key, -1)
            if existing is None:
                return "never_cache"
            if existing >= 0:
                self._agg_epochs[key] = max(self._agg_epochs.get(key, tag), tag)
                return "exists"
            if self._agg_free:
                slot = self._agg_free.pop()
            elif self._agg_next < self.max_aggregates:
                slot = self._agg_next
                self._agg_next += 1
            else:
                self._evict_stale_locked(cur_epoch, journal=True)
                if not self._agg_free:
                    return "full"
                slot = self._agg_free.pop()
            self._agg_dev = self._agg_with_rows([(slot, row)])
            self._agg_slots[key] = slot
            self._agg_epochs[key] = tag
            self._agg_resident += 1
            self._agg_precomputed += 1
            row_bytes = G1_ROW_BYTES * len(self._agg_dev)
            self._uploads["aggregate"] += row_bytes
            resident = self._agg_resident
        _AGG_EVENTS.with_labels("precomputed").inc()
        _UPLOAD_BYTES.with_labels("aggregate").inc(row_bytes)
        _ENTRIES.with_labels("aggregates").set(resident)
        return "inserted"

    def _evict_stale_locked(self, cur_epoch: int, journal: bool) -> int:
        """Two-epoch retention: drop every entry whose epoch tag is two or
        more epochs behind ``cur_epoch`` onto the free list. The
        generation bump tells any batch that already took slots to ship
        K indices instead. Returns the entries evicted; ``journal``
        records a ``key_table_reset`` event when any were."""
        stale = [k for k, e in self._agg_epochs.items() if e + 2 <= cur_epoch]
        if not stale:
            return 0
        dropped_epochs = sorted({self._agg_epochs[k] for k in stale})
        for k in stale:
            slot = self._agg_slots.pop(k, None)
            del self._agg_epochs[k]
            if slot is not None and slot >= 0:
                self._agg_free.append(slot)
        freed = len(stale)
        self._agg_resident = max(0, self._agg_resident - freed)
        self._agg_evictions += freed
        self._agg_gen += 1
        _AGG_EVENTS.with_labels("evict").inc(freed)
        _ENTRIES.with_labels("aggregates").set(self._agg_resident)
        if journal:
            flight_recorder.record(
                "key_table_reset",
                region="aggregates",
                mode="evict_epochs",
                dropped=freed,
                epochs=",".join(str(e) for e in dropped_epochs),
                retained=self._agg_resident,
                current_epoch=cur_epoch,
            )
        return freed

    def _reset_aggregates_locked(self, journal: bool) -> None:
        """Recycle the aggregate region wholesale: the last resort when it
        filled inside one epoch and eviction freed nothing. ``_agg_seen``
        survives so a hot tuple re-inserts on its next sighting."""
        had = self._agg_resident
        self._agg_slots.clear()
        self._agg_epochs.clear()
        self._agg_free.clear()
        self._agg_next = 0
        self._agg_resident = 0
        self._agg_resets += 1
        self._agg_gen += 1
        _AGG_EVENTS.with_labels("reset").inc()
        _ENTRIES.with_labels("aggregates").set(0)
        if journal:
            flight_recorder.record(
                "key_table_reset", region="aggregates", mode="wholesale",
                dropped=had,
            )

    # -- accounting -----------------------------------------------------------

    def count_shipped(self, n_indexed: int, n_collapsed: int) -> None:
        """Commit a dispatched batch's shipping path, once the batch is
        definitely taking the indexed path."""
        with self._lock:
            self._sets["indexed"] += int(n_indexed)
            self._sets["collapsed"] += int(n_collapsed)
        if n_indexed:
            _SETS.with_labels("indexed").inc(int(n_indexed))
        if n_collapsed:
            _SETS.with_labels("collapsed").inc(int(n_collapsed))

    def count_raw(self, n_sets: int) -> None:
        """A batch fell back to the raw plane for a reason resolve_sets
        did not see (bare-point sets, which never gather)."""
        with self._lock:
            self._sets["raw"] += int(n_sets)
        _SETS.with_labels("raw").inc(int(n_sets))

    def device_arrays(self, shard: Optional[int] = None):
        """(validator tensor, aggregate tensor) snapshot of one replica:
        indices at or above the validator tensor's length address the
        aggregate region. ``shard=None`` resolves the calling thread's
        dispatch shard (falling back to the lowest replica); ``(None,
        None)`` before the first sync or when ``shard`` has no replica."""
        with self._lock:
            if not self._dev:
                return None, None
            if shard is None:
                s = self._resolve_shard_locked()
                if s is None:
                    s = min(self._dev)
            else:
                s = int(shard)
                if s not in self._dev:
                    return None, None
            return self._dev[s], self._agg_dev.get(s)

    def __len__(self) -> int:
        return self._n

    def status(self) -> dict:
        """One document describing the table."""
        with self._lock:
            sets = dict(self._sets)
            shipped = sets["indexed"] + sets["collapsed"]
            total = shipped + sets["raw"]
            rows = sum(int(t.shape[0]) for t in (*self._dev.values(),
                                                 *self._agg_dev.values()))
            return {
                "device": str(self.device),
                "replicas": sorted(self._dev),
                "validators_resident": self._n,
                "host_cache_len": len(self.cache.pubkeys),
                "validator_capacity": self._cap_v,
                "aggregates_resident": self._agg_resident,
                "aggregate_capacity": self.max_aggregates,
                "aggregate_resets": self._agg_resets,
                "aggregate_hits": self._agg_hits,
                "aggregate_inserts": self._agg_inserts,
                "aggregate_precomputed": self._agg_precomputed,
                "aggregate_evictions": self._agg_evictions,
                "aggregate_free_slots": len(self._agg_free),
                "aggregate_epochs": sorted(set(self._agg_epochs.values())),
                "aggregate_sum_seconds": self._agg_sum_s,
                "device_bytes": rows * G1_ROW_BYTES,
                "upload_bytes": dict(self._uploads),
                "sets": sets,
                "hit_ratio": round(shipped / total, 4) if total else None,
                "identity_pinned": self._n <= len(self.cache.pubkeys),
                "resyncs": dict(self._resyncs),
                "resync_failures": self._resync_failures,
                "resync_pending": self._resync_timer is not None,
            }


# ---------------------------------------------------------------------------
# Process-global table (the seam CudaBackend reaches without a handle)
# ---------------------------------------------------------------------------

_table_lock = threading.Lock()
_table: Optional[DeviceKeyTable] = None


def set_table(table: Optional[DeviceKeyTable]) -> None:
    global _table
    with _table_lock:
        _table = table


def clear_table(table: Optional[DeviceKeyTable] = None) -> None:
    """Detach the global table (only if it still IS ``table`` when one is
    given: a racing rebuild must not lose its fresh table)."""
    global _table
    with _table_lock:
        if table is None or _table is table:
            _table = None


def get_table() -> Optional[DeviceKeyTable]:
    return _table


def get_active_table() -> Optional[DeviceKeyTable]:
    """The attached table, when it has resident rows to gather from."""
    t = _table
    if t is not None and len(t):
        return t
    return None
