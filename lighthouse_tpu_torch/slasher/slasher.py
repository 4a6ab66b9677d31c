"""Min-max-span slashing detection (reference: ``slasher/src/array.rs``
— the published min-max surround-detection scheme over a 2D
(validator x epoch) distance array; ``slasher/src/lib.rs:33-48`` status
enum; queues in ``attestation_queue.rs``).

Data layout is the vectorized (numpy) analogue of the reference's
chunked LMDB arrays: per validator,

* ``min_span[e]`` = min over recorded attestations with ``source > e`` of
  ``target - e`` — a new attestation (s, t) **surrounds** an existing one
  iff ``min_span[s] < t - s`` (some vote sits strictly inside it);
* ``max_span[e]`` = max over recorded attestations with ``source < e`` of
  ``target - e`` — a new attestation is **surrounded by** an existing one
  iff ``max_span[s] > t - s``.

Span updates touch a contiguous epoch range and are applied with numpy
slice min/max — one vector op per attestation instead of a Python loop
over epochs.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Optional

import numpy as np

from ..ssz import hash_tree_root

_NO_SPAN = np.iinfo(np.int64).max


from ..utils import metrics

_BATCH_TIME = metrics.histogram(
    "slasher_batch_seconds", "queued-attestation batch processing latency"
)
_SLASHINGS = metrics.counter(
    "slasher_slashings_found_total", "attester/proposer slashings detected"
)


def _b64(v: int) -> bytes:
    return int(v).to_bytes(8, "big")


def _u64(b: bytes) -> int:
    return int.from_bytes(b, "big")


class AttesterSlashingStatus(enum.Enum):
    NOT_SLASHABLE = "not_slashable"
    DOUBLE_VOTE = "double_vote"
    SURROUNDS_EXISTING = "surrounds_existing"
    SURROUNDED_BY_EXISTING = "surrounded_by_existing"


class Slasher:
    """``on_slashing`` receives (status, indexed_attestation_new,
    indexed_attestation_old) — e.g. the op pool's insert_attester_slashing
    wrapped by the service."""

    def __init__(
        self,
        types,
        history_length: int = 4096,
        on_slashing: Optional[Callable] = None,
        slots_per_epoch: int = 32,
        store=None,
    ):
        """``store``: optional :class:`KeyValueStore`; when given, span
        arrays + evidence persist under ``Column.SLASHER`` and reload on
        construction (reference: the LMDB database behind
        ``slasher/src/database/lmdb_impl.rs:1-203``). Writes are batched
        per ``process_queued``/``check_block_header`` call."""
        self.t = types
        self.history = history_length
        self.slots_per_epoch = slots_per_epoch
        self.on_slashing = on_slashing
        self._store = store
        self._dirty_spans: set[int] = set()
        self._dirty_targets: set[tuple[int, int]] = set()
        self._dirty_blocks: set[tuple[int, int]] = set()
        self._lock = threading.Lock()
        # spans index epochs relative to this sliding base; advancing the
        # base shifts every validator's arrays (reference: the chunked
        # arrays slide with the finalized epoch)
        self._base = 0
        # per-validator span arrays [history] int64
        self._min_span: dict[int, np.ndarray] = {}
        self._max_span: dict[int, np.ndarray] = {}
        # (validator, target_epoch) -> [(data_root, indexed_attestation)]
        # (all distinct votes kept: span flags must always have evidence)
        self._by_target: dict[tuple[int, int], list[tuple[bytes, object]]] = {}
        # (validator, source_epoch) -> targets recorded (for evidence lookup)
        self._by_source: dict[tuple[int, int], list[int]] = {}
        # blocks: (proposer, slot) -> (root, signed_header)
        self._blocks: dict[tuple[int, int], tuple[bytes, object]] = {}
        self._queue: list = []
        self.found_attester_slashings: list = []
        self.found_proposer_slashings: list = []
        if store is not None:
            try:
                self._load()
            except Exception:
                # corrupt/mismatched persisted state must not brick
                # startup (same degrade-to-fresh contract as the client's
                # fork-choice and op-pool restores)
                self._base = 0
                self._min_span.clear()
                self._max_span.clear()
                self._by_target.clear()
                self._by_source.clear()
                self._blocks.clear()

    # -- ingestion (queued, like the reference's batching queues) --------

    def accept_attestation(self, indexed_attestation) -> None:
        with self._lock:
            self._queue.append(indexed_attestation)

    def process_queued(self) -> int:
        with _BATCH_TIME.time():
            return self._process_queued()

    def _process_queued(self) -> int:
        """Periodic batch processing (reference
        ``slasher/service/src/service.rs``). Returns #slashings found."""
        with self._lock:
            batch, self._queue = self._queue, []
        found = 0
        for att in batch:
            found += len(self.check_attestation(att))
        self.flush()
        return found

    # -- attestations ----------------------------------------------------

    def _spans(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        mn = self._min_span.get(v)
        if mn is None:
            mn = self._min_span[v] = np.full(self.history, _NO_SPAN, np.int64)
            self._max_span[v] = np.full(self.history, -1, np.int64)
        return mn, self._max_span[v]

    def check_attestation(self, indexed) -> list:
        """Record + detect; returns [(status, evidence AttesterSlashing)].

        Evidence ordering follows spec ``is_slashable_attestation_data``:
        the SURROUNDING attestation must be ``attestation_1``."""
        data = indexed.data
        s, t = data.source.epoch, data.target.epoch
        root = hash_tree_root(data)
        out = []
        with self._lock:
            for v in (int(i) for i in indexed.attesting_indices):
                status, old = self._check_one(v, s, t, root)
                if status != AttesterSlashingStatus.NOT_SLASHABLE:
                    if status == AttesterSlashingStatus.SURROUNDS_EXISTING:
                        first, second = indexed, old  # new surrounds old
                    else:
                        first, second = old, indexed
                    slashing = self.t.AttesterSlashing(
                        attestation_1=first, attestation_2=second
                    )
                    self.found_attester_slashings.append(slashing)
                    _SLASHINGS.inc()
                    out.append((status, slashing))
                    if self.on_slashing:
                        self.on_slashing(status, indexed, old)
                self._record(v, s, t, root, indexed)
        return out

    def _check_one(self, v: int, s: int, t: int, root: bytes):
        # double vote: same target, ANY data difference
        for prev_root, prev_att in self._by_target.get((v, t), ()):
            if prev_root != root:
                return AttesterSlashingStatus.DOUBLE_VOTE, prev_att
        self._maybe_rebase(t)
        mn, mx = self._spans(v)
        si = s - self._base
        if 0 <= si < self.history:
            dist = t - s
            # min_span[s] = min(t' - s) over existing with s' > s; a value
            # below dist means some existing (s', t') sits strictly INSIDE
            # the new (s, t): the NEW SURROUNDS an existing vote.
            if mn[si] != _NO_SPAN and mn[si] < dist:
                old = self._find_inside(v, s, t)
                if old is not None:
                    return AttesterSlashingStatus.SURROUNDS_EXISTING, old
            # max_span[s] = max(t' - s) over existing with s' < s; above
            # dist means some existing encloses the new vote.
            if mx[si] > dist:
                old = self._find_enclosing(v, s, t)
                if old is not None:
                    return (
                        AttesterSlashingStatus.SURROUNDED_BY_EXISTING,
                        old,
                    )
        return AttesterSlashingStatus.NOT_SLASHABLE, None

    def _find_inside(self, v: int, s: int, t: int):
        """Existing attestation strictly inside (s, t)."""
        for (vv, tt), entries in self._by_target.items():
            if vv != v or not tt < t:
                continue
            for _, att in entries:
                if att.data.source.epoch > s:
                    return att
        return None

    def _find_enclosing(self, v: int, s: int, t: int):
        """Existing attestation strictly enclosing (s, t)."""
        for (vv, tt), entries in self._by_target.items():
            if vv != v or not tt > t:
                continue
            for _, att in entries:
                if att.data.source.epoch < s:
                    return att
        return None

    def _record(self, v: int, s: int, t: int, root: bytes, indexed) -> None:
        entries = self._by_target.setdefault((v, t), [])
        if all(r != root for r, _ in entries):
            entries.append((root, indexed))
            self._dirty_targets.add((v, t))
        self._by_source.setdefault((v, s), []).append(t)
        self._dirty_spans.add(v)
        self._maybe_rebase(t)
        mn, mx = self._spans(v)
        base = self._base
        # attestations with source > e: window epochs e in [base, s);
        # distance t - e. Vectorized slice update over indices.
        lo_i, hi_i = 0, min(max(s - base, 0), self.history)
        if hi_i > lo_i:
            e = np.arange(lo_i, hi_i) + base
            np.minimum(mn[lo_i:hi_i], t - e, out=mn[lo_i:hi_i])
        # attestations with source < e: epochs e in (s, t]
        lo_i = min(max(s + 1 - base, 0), self.history)
        hi_i = min(max(t + 1 - base, 0), self.history)
        if hi_i > lo_i:
            e = np.arange(lo_i, hi_i) + base
            np.maximum(mx[lo_i:hi_i], t - e, out=mx[lo_i:hi_i])

    def _maybe_rebase(self, epoch: int) -> None:
        """Slide the span window so ``epoch`` is addressable; history that
        falls off the left edge is forgotten (it is older than the
        weak-subjectivity horizon anyway)."""
        if epoch - self._base < self.history:
            return
        new_base = epoch - self.history // 2
        shift = new_base - self._base
        for v in self._min_span:
            mn, mx = self._min_span[v], self._max_span[v]
            mn[:-shift] = mn[shift:] if shift < self.history else _NO_SPAN
            mn[-shift:] = _NO_SPAN
            mx[:-shift] = mx[shift:] if shift < self.history else -1
            mx[-shift:] = -1
        self._base = new_base
        self._dirty_spans.update(self._min_span)  # the shift touched all

    # -- blocks ----------------------------------------------------------

    def check_block_header(self, signed_header) -> Optional[object]:
        """Double-proposal detection -> ProposerSlashing evidence."""
        msg = signed_header.message
        key = (msg.proposer_index, msg.slot)
        root = hash_tree_root(msg)
        slashing = None
        with self._lock:
            prev = self._blocks.get(key)
            if prev is None:
                self._blocks[key] = (root, signed_header)
                self._dirty_blocks.add(key)
            elif prev[0] != root:
                slashing = self.t.ProposerSlashing(
                    signed_header_1=prev[1], signed_header_2=signed_header
                )
                self.found_proposer_slashings.append(slashing)
                _SLASHINGS.inc()
        if slashing is not None and self.on_slashing:
            self.on_slashing("double_proposal", signed_header, prev[1])
        self.flush()
        return slashing

    # -- maintenance -----------------------------------------------------

    def prune(self, finalized_epoch: int) -> None:
        with self._lock:
            self._by_target = {
                k: v for k, v in self._by_target.items() if k[1] >= finalized_epoch
            }
            self._by_source = {
                k: v for k, v in self._by_source.items() if k[1] >= finalized_epoch
            }
            self._blocks = {
                k: v
                for k, v in self._blocks.items()
                if k[1] >= finalized_epoch * self.slots_per_epoch
            }
            # dirty entries for pruned keys must not resurrect store rows
            self._dirty_targets = {
                k for k in self._dirty_targets if k in self._by_target
            }
            self._dirty_blocks = {k for k in self._dirty_blocks if k in self._blocks}
            if self._store is not None:
                from ..store.kv import Column

                drop = []
                for key in list(self._store.keys(Column.SLASHER)):
                    if key[:1] == b"a" and _u64(key[9:17]) < finalized_epoch:
                        drop.append(key)
                    elif key[:1] == b"b" and (
                        _u64(key[9:17]) < finalized_epoch * self.slots_per_epoch
                    ):
                        drop.append(key)
                for key in drop:
                    self._store.delete(Column.SLASHER, key)

    # -- persistence (reference: slasher/src/database/lmdb_impl.rs) ------

    def flush(self) -> None:
        """Write dirty spans/evidence/blocks to the store in one batch."""
        if self._store is None:
            return
        import json

        from ..store.kv import Column

        with self._lock:
            if not (self._dirty_spans or self._dirty_targets or self._dirty_blocks):
                return
            items = [
                (
                    Column.SLASHER,
                    b"meta",
                    json.dumps(
                        {
                            "version": 1,
                            "base": self._base,
                            "history": self.history,
                            "slots_per_epoch": self.slots_per_epoch,
                        }
                    ).encode(),
                )
            ]
            for v in self._dirty_spans:
                mn, mx = self._spans(v)
                items.append(
                    (Column.SLASHER, b"s" + _b64(v), mn.tobytes() + mx.tobytes())
                )
            for v, t in self._dirty_targets:
                entries = self._by_target.get((v, t), [])
                items.append(
                    (
                        Column.SLASHER,
                        b"a" + _b64(v) + _b64(t),
                        json.dumps(
                            [
                                [
                                    r.hex(),
                                    self.t.IndexedAttestation.encode(att).hex(),
                                ]
                                for r, att in entries
                            ]
                        ).encode(),
                    )
                )
            for p, slot in self._dirty_blocks:
                entry = self._blocks.get((p, slot))
                if entry is None:  # pruned between marking and flush
                    continue
                root, header = entry
                items.append(
                    (
                        Column.SLASHER,
                        b"b" + _b64(p) + _b64(slot),
                        json.dumps(
                            [root.hex(), self.t.SignedBeaconBlockHeader.encode(header).hex()]
                        ).encode(),
                    )
                )
            self._store.put_batch(items)
            self._dirty_spans.clear()
            self._dirty_targets.clear()
            self._dirty_blocks.clear()

    def _load(self) -> None:
        """Restore spans + evidence from the store (init-time; lock not
        yet shared). ``_by_source`` is derived from the evidence."""
        import json

        from ..store.kv import Column

        meta = self._store.get(Column.SLASHER, b"meta")
        if meta is None:
            return
        doc = json.loads(meta.decode())
        if doc.get("history") != self.history:
            raise ValueError(
                f"slasher history mismatch: store {doc.get('history')}, "
                f"configured {self.history}"
            )
        self._base = int(doc["base"])
        for key, value in self._store.iter_column(Column.SLASHER):
            tag = key[:1]
            if tag == b"s":
                v = _u64(key[1:9])
                arr = np.frombuffer(value, np.int64).copy()
                self._min_span[v] = arr[: self.history]
                self._max_span[v] = arr[self.history :]
            elif tag == b"a":
                v, t = _u64(key[1:9]), _u64(key[9:17])
                entries = [
                    (
                        bytes.fromhex(r),
                        self.t.IndexedAttestation.decode(bytes.fromhex(att)),
                    )
                    for r, att in json.loads(value.decode())
                ]
                self._by_target[(v, t)] = entries
                for _, att in entries:
                    self._by_source.setdefault(
                        (v, int(att.data.source.epoch)), []
                    ).append(t)
            elif tag == b"b":
                p, slot = _u64(key[1:9]), _u64(key[9:17])
                r, header = json.loads(value.decode())
                self._blocks[(p, slot)] = (
                    bytes.fromhex(r),
                    self.t.SignedBeaconBlockHeader.decode(bytes.fromhex(header)),
                )
