"""Data-movement ledger: host-to-device byte attribution for the staged
BLS verifier. The port's own copy of the JAX package's
``utils/transfer_ledger.py``: the same API, families, labels, env knobs
and summary; the device-memory probe reads the CUDA caching allocator.

Three surfaces, one module:

* **Per-verify cost attribution.** The raw and the indexed packer
  (``crypto/device/bls.pack_signature_sets_raw`` / ``_indexed``) time
  their phases (``decode`` byte parsing and randomness, ``limb_split``
  int-to-limb conversion, ``pad`` allocation and padding-lane fill,
  ``hash`` hash_to_field, ``device_put`` host-to-device copy) and report
  per-operand byte splits here: ``bls_device_pack_seconds{phase}``,
  ``bls_device_h2d_bytes_total{operand,kind}`` (operands ``pubkeys`` /
  ``signatures`` / ``messages`` / ``aux`` count LIVE bytes; ``padding``
  counts every byte shipped for lanes no caller asked for: the labels
  sum to the exact ``ndarray.nbytes`` the copy moved),
  ``bls_device_d2h_bytes_total`` (verdict reads). Each staged verify
  journals ONE ``transfer_ledger`` flight-recorder event carrying the
  whole row.
* **Repeat-pubkey evidence.** :class:`ReuploadTracker`, a bounded
  sliding-window sketch keyed by pubkey digest: what fraction of the G1
  bytes uploaded within the last N verifies were re-uploads of
  already-seen keys (``bls_device_pubkey_reupload_ratio{kind}``): the
  H2D bandwidth a device-side gather reclaims.
* **Device-memory telemetry.** ``device_memory_bytes{kind}`` from the
  CUDA caching allocator (:func:`update_device_memory`), probed on a
  throttle from the summary, never from the verify hot path.

Attribution context (caller kind + resolution path) is THREAD-LOCAL: the
scheduler (``verification_service/batcher.py``) wraps each backend call
in :func:`context`, so a planned sub-batch attributes its bytes to its
own kind and a split-and-retry re-pack is labelled ``path=bisection``:
the retry's bytes are real (the host did re-ship them) but they are never
mistaken for the original flush's (exactly-once per pack). CPU
resolutions (the compile service's fallback) record zero-device-byte
rows via :func:`record_cpu`. A thread the scheduler starts for a
dispatch (a mesh shard's flush worker, the watchdog's thread) enters the
caller's context itself.

No torch import at module load; the device-memory probe reads
``torch.cuda`` only when the process already imported torch and
initialized CUDA. With the ledger disabled
(``LIGHTHOUSE_TPU_TRANSFER_LEDGER=0``) every recording entry point
returns after one global check.

Byte model: :func:`operand_bytes_model` is the ONE analytic formula for
what a padded (B, K, M) raw pack ships per operand, shared with the
flush planner's plan accounting; it equals the packer's actual
``ndarray.nbytes``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import flight_recorder, metrics, slot_ledger

# ---------------------------------------------------------------------------
# Byte model (int32 limb layout, crypto/device/fp.py: NL=32 12-bit limbs)
# ---------------------------------------------------------------------------

NL = 32                         # limbs per field element (== fp.NL)
_FP_BYTES = NL * 4              # one Fp element, int32 limbs
G1_POINT_BYTES = 2 * _FP_BYTES  # affine (x, y): one packed pubkey row
_FP2_BYTES = 2 * _FP_BYTES

PACK_PHASES = ("decode", "limb_split", "pad", "hash", "device_put")
OPERANDS = ("pubkeys", "signatures", "messages", "aux", "padding")


# one pubkey slot on the wire: raw = a limb-packed G1 affine row + its
# mask bool; indexed = an int32 table index + its mask bool (the device
# key table, crypto/device/key_table.py)
INDEXED_SLOT_BYTES = 4 + 1


def operand_bytes_model(
    b: int, k: int, m: int, indexed: bool = False
) -> Dict[str, int]:
    """Exact bytes a padded (B, K, M) raw pack ships host-to-device, per
    operand family (the ``ndarray.nbytes`` of the copied arguments):

    * ``pubkeys``: ``pk_xy`` int32[B,K,2,NL] + ``pk_mask`` bool[B,K],
      or, with ``indexed=True`` (``pack_signature_sets_indexed``),
      ``pk_idx`` int32[B,K] + ``pk_mask`` bool[B,K]
    * ``signatures``: ``sig_x`` int32[B,2,NL] + ``sig_larger`` bool[B]
    * ``messages``: ``msg_u`` int32[M,2,2,NL] + ``msg_idx`` int32[B]
    * ``aux``: ``rand`` int32[B,2] + ``set_mask`` bool[B]
    """
    slot = INDEXED_SLOT_BYTES if indexed else G1_POINT_BYTES + 1
    out = {
        "pubkeys": b * k * slot,
        "signatures": b * (_FP2_BYTES + 1),
        "messages": m * 2 * _FP2_BYTES + b * 4,
        "aux": b * (2 * 4 + 1),
    }
    out["total"] = sum(out.values())
    return out


def live_operand_bytes(
    n_sets: int, pk_slots: int, m_req: int, indexed: bool = False
) -> Dict[str, int]:
    """The share of :func:`operand_bytes_model` the callers actually
    asked for: ``pk_slots`` real pubkey slots, ``n_sets`` live lanes,
    ``m_req`` distinct messages. ``padded - live`` is the padding
    share."""
    slot = INDEXED_SLOT_BYTES if indexed else G1_POINT_BYTES + 1
    out = {
        "pubkeys": pk_slots * slot,
        "signatures": n_sets * (_FP2_BYTES + 1),
        "messages": m_req * 2 * _FP2_BYTES + n_sets * 4,
        "aux": n_sets * (2 * 4 + 1),
    }
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# Metric families
# ---------------------------------------------------------------------------

_H2D_BYTES = metrics.counter_vec(
    "bls_device_h2d_bytes_total",
    "host-to-device bytes shipped by the staged packers, by operand "
    "(pubkeys/signatures/messages/aux count LIVE bytes; padding counts "
    "every byte shipped for lanes no caller asked for: the labels sum "
    "to the exact ndarray.nbytes copied) and caller kind (the "
    "scheduler's attribution context; `direct` outside a scheduler)",
    ("operand", "kind"),
)
_D2H_BYTES = metrics.counter(
    "bls_device_d2h_bytes_total",
    "device-to-host bytes read back per staged verify (the verdict "
    "scalar: intermediates stay on the device by design)",
)
_PACK_SECONDS = metrics.histogram_vec(
    "bls_device_pack_seconds",
    "host-side pack wall time by phase: decode (signature byte parsing "
    "+ randomness), limb_split (int-to-limb conversion + array fill), "
    "pad (allocation + padding-lane fill), hash (message hash_to_field), "
    "device_put (host-to-device copy, measured to the caller's stream "
    "sync when the ledger is enabled; with it disabled the copy's "
    "enqueue only), total (the whole pack; the phases sum to about the "
    "total)",
    ("phase",),
)
# public handle: the hashed packer observes phase="total" directly
# (crypto/device/bls.py)
PACK_SECONDS = _PACK_SECONDS
_REUPLOAD_RATIO = metrics.gauge_vec(
    "bls_device_pubkey_reupload_ratio",
    "fraction of G1 pubkey bytes uploaded within the sliding window "
    "(last N staged verifies) that were re-uploads of already-seen "
    "keys, per caller kind: ratio x pubkey bytes/s is the H2D bandwidth "
    "a device-resident key table reclaims",
    ("kind",),
)
_DEVICE_MEMORY = metrics.gauge_vec(
    "device_memory_bytes",
    "device memory telemetry from the CUDA caching allocator of device "
    "0: bytes_in_use (allocated bytes now), peak_bytes_in_use (allocated "
    "bytes at peak) and bytes_limit (the card's total memory); kinds "
    "absent where nothing reports (null-safe), and a kind the latest "
    "probe no longer reports decays to 0 rather than serving its last "
    "value as current",
    ("kind",),
)
_LEDGER_VERIFIES = metrics.counter_vec(
    "bls_device_ledger_rows_total",
    "transfer-ledger rows committed, by resolution path (device = a "
    "staged verify with measured bytes; cpu paths record zero device "
    "bytes)",
    ("path",),
)


# ---------------------------------------------------------------------------
# Enable / configure
# ---------------------------------------------------------------------------


# one env-parsing convention across the observability knobs
_env_int = flight_recorder._env_int
_env_float = flight_recorder._env_float

_enabled = os.environ.get("LIGHTHOUSE_TPU_TRANSFER_LEDGER", "1") not in ("", "0")
_mem_interval_s = _env_float("LIGHTHOUSE_TPU_LEDGER_MEM_INTERVAL_S", 5.0)
_window = _env_int("LIGHTHOUSE_TPU_LEDGER_WINDOW", 1024)


def enabled() -> bool:
    return _enabled


def configure(
    enabled: Optional[bool] = None,
    window: Optional[int] = None,
    mem_interval_s: Optional[float] = None,
) -> dict:
    """Override knobs at runtime; returns the PREVIOUS values so tests
    can restore them (flight_recorder.configure's contract)."""
    global _enabled, _window, _mem_interval_s, _tracker
    prev = {
        "enabled": _enabled,
        "window": _window,
        "mem_interval_s": _mem_interval_s,
    }
    if enabled is not None:
        _enabled = bool(enabled)
    if window is not None and int(window) != _window:
        _window = max(1, int(window))
        _tracker = ReuploadTracker(_window)
    if mem_interval_s is not None:
        _mem_interval_s = float(mem_interval_s)
    return prev


# ---------------------------------------------------------------------------
# Attribution context (thread-local kind + resolution path)
# ---------------------------------------------------------------------------

_tls = threading.local()

_DEFAULT_CONTEXT = ("direct", "direct")


class _Ctx:
    """Context manager scoping one (kind, path) attribution frame."""

    __slots__ = ("kind", "path", "_prev")

    def __init__(self, kind: str, path: str):
        self.kind = kind
        self.path = path

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = (self.kind, self.path)
        return self

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def context(kind: str, path: str) -> _Ctx:
    """Attribute every pack/commit on THIS thread inside the ``with`` to
    ``(kind, path)``: the scheduler wraps each backend call so bytes
    land on the caller kind, and bisection retries are labelled
    ``path=bisection`` instead of inflating the original flush."""
    return _Ctx(str(kind), str(path))


def current_context() -> Tuple[str, str]:
    ctx = getattr(_tls, "ctx", None)
    return ctx if ctx is not None else _DEFAULT_CONTEXT


# ---------------------------------------------------------------------------
# Repeat-pubkey sliding-window sketch
# ---------------------------------------------------------------------------


def pubkey_digest(blob: bytes) -> bytes:
    """16-byte blake2b digest of one packed pubkey row (the canonical
    int32 limb encoding): the window key."""
    return hashlib.blake2b(blob, digest_size=16).digest()


class ReuploadTracker:
    """Bounded sliding window over the last ``window`` observations
    (one observation = one staged verify's pubkey uploads): per kind,
    what fraction of uploaded G1 bytes were re-uploads of a digest
    already present in the window. Thread-safe; eviction is exact for
    totals (a record leaving the window removes its bytes) and
    first-upload-sticky for membership (an entry marked re-upload at
    insert time stays one for its lifetime: the sketch answers "how
    much of the recent upload stream was redundant", not "which copy
    was first").
    """

    def __init__(self, window: int = 1024):
        self.window = max(1, int(window))
        self._ring: deque = deque()
        self._counts: Dict[bytes, int] = {}
        self._uploaded: Dict[str, int] = {}
        self._reuploaded: Dict[str, int] = {}
        self._lock = threading.Lock()

    def observe(
        self, kind: str, entries: Iterable[Tuple[bytes, int]]
    ) -> Tuple[int, int]:
        """Record one verify's pubkey uploads: ``entries`` are
        ``(digest, nbytes)`` pairs. Returns ``(reuploaded_bytes,
        uploaded_bytes)`` for THIS observation."""
        kind = str(kind)
        with self._lock:
            rec: List[Tuple[bytes, int, bool]] = []
            up = re = 0
            for digest, nb in entries:
                nb = int(nb)
                seen = self._counts.get(digest, 0) > 0
                self._counts[digest] = self._counts.get(digest, 0) + 1
                rec.append((digest, nb, seen))
                up += nb
                if seen:
                    re += nb
            self._ring.append((kind, rec))
            self._uploaded[kind] = self._uploaded.get(kind, 0) + up
            self._reuploaded[kind] = self._reuploaded.get(kind, 0) + re
            while len(self._ring) > self.window:
                old_kind, old_rec = self._ring.popleft()
                o_up = o_re = 0
                for digest, nb, was_re in old_rec:
                    c = self._counts.get(digest, 0) - 1
                    if c <= 0:
                        self._counts.pop(digest, None)
                    else:
                        self._counts[digest] = c
                    o_up += nb
                    if was_re:
                        o_re += nb
                # .get defaults: a zero-upload record can outlive its
                # kind's popped totals (the kind re-appears at 0 and is
                # re-popped below); eviction must never raise
                self._uploaded[old_kind] = (
                    self._uploaded.get(old_kind, 0) - o_up
                )
                self._reuploaded[old_kind] = (
                    self._reuploaded.get(old_kind, 0) - o_re
                )
                if self._uploaded[old_kind] <= 0:
                    self._uploaded.pop(old_kind, None)
                    self._reuploaded.pop(old_kind, None)
            return re, up

    def ratio(self, kind: Optional[str] = None) -> float:
        """Re-upload fraction of the current window, per kind or (with
        ``kind=None``) over every kind together. 0.0 when nothing was
        uploaded."""
        with self._lock:
            if kind is None:
                up = sum(self._uploaded.values())
                re = sum(self._reuploaded.values())
            else:
                up = self._uploaded.get(kind, 0)
                re = self._reuploaded.get(kind, 0)
        return re / up if up else 0.0

    def summary(self) -> dict:
        with self._lock:
            kinds = {}
            for k in sorted(self._uploaded):
                k_up = self._uploaded.get(k, 0)
                k_re = self._reuploaded.get(k, 0)
                kinds[k] = {
                    "uploaded_bytes": k_up,
                    "reuploaded_bytes": k_re,
                    "ratio": round(k_re / k_up, 4) if k_up else 0.0,
                }
            up = sum(self._uploaded.values())
            re = sum(self._reuploaded.values())
            return {
                "window": self.window,
                "records": len(self._ring),
                "distinct_keys": len(self._counts),
                "uploaded_bytes": up,
                "reuploaded_bytes": re,
                "ratio": round(re / up, 4) if up else 0.0,
                "kinds": kinds,
            }


_tracker = ReuploadTracker(_window)


def tracker() -> ReuploadTracker:
    """The process-global sketch (the gauges' backing store)."""
    return _tracker


# ---------------------------------------------------------------------------
# Recording entry points (the hot path; one global check when disabled)
# ---------------------------------------------------------------------------


def observe_pack_phases(phases: Dict[str, float], total_s: float) -> None:
    """Land pack-phase seconds in ``bls_device_pack_seconds{phase}``.
    NOT gated by the ledger knob: metric families stay always-on, and
    ``LIGHTHOUSE_TPU_TRANSFER_LEDGER=0`` turns off byte accounting, the
    sketch and the journal rows, never pack-time telemetry."""
    for phase, s in phases.items():
        _PACK_SECONDS.with_labels(phase).observe(s)
    _PACK_SECONDS.with_labels("total").observe(total_s)


def note_pack(
    n_sets: int,
    b: int,
    k: int,
    m: int,
    pk_slots: int,
    m_req: int,
    phases: Dict[str, float],
    total_s: float,
    operand_nbytes: Dict[str, int],
    pubkey_blobs: Sequence[bytes],
    indexed: bool = False,
) -> None:
    """One pack completed: attribute operand bytes to the current
    (kind, path) context, feed the repeat-pubkey sketch, and stage the
    row for :func:`commit_verify` (same thread). The packer calls this
    unconditionally; disabled = immediate return (phase telemetry goes
    through :func:`observe_pack_phases`, which is not gated).

    ``operand_nbytes`` are the ACTUAL per-operand array nbytes (ground
    truth, not the model); ``pubkey_blobs`` the packed per-pubkey limb
    rows as bytes. ``indexed=True`` marks the indexed packer (device
    key-table gather): the pubkey operand is the index plane, and no G1
    blobs feed the re-upload sketch (nothing G1-shaped crossed)."""
    if not _enabled:
        return
    kind, path = current_context()
    live = live_operand_bytes(n_sets, pk_slots, m_req, indexed=indexed)
    total_bytes = 0
    by_operand = {}
    for op in ("pubkeys", "signatures", "messages", "aux"):
        nb = int(operand_nbytes.get(op, 0))
        total_bytes += nb
        by_operand[op] = min(live[op], nb)
    padding = total_bytes - sum(by_operand.values())
    by_operand["padding"] = padding
    for op, nb in by_operand.items():
        if nb:
            _H2D_BYTES.with_labels(op, kind).inc(nb)
    if total_bytes:
        # chain-time attribution: the slot's report card carries the
        # byte total (the operand split stays in the counter family)
        slot_ledger.note_h2d_bytes(total_bytes)

    entries = [
        (pubkey_digest(blob), len(blob)) for blob in pubkey_blobs
    ]
    re_b, up_b = _tracker.observe(kind, entries)
    # refresh EVERY exported kind, not just the one that packed: a kind
    # whose window entries evicted must decay to 0.0 on the scrape
    # (gauge children cannot be unregistered)
    _REUPLOAD_RATIO.with_labels(kind).set(_tracker.ratio(kind))
    for (k_label,), child in _REUPLOAD_RATIO.children().items():
        if k_label != kind:
            child.set(_tracker.ratio(k_label))

    _tls.pending = {
        "kind": kind,
        "path": path,
        "indexed": bool(indexed),
        "n_sets": int(n_sets),
        "b": int(b), "k": int(k), "m": int(m),
        "pk_slots": int(pk_slots), "m_req": int(m_req),
        "phases": {p: round(s, 6) for p, s in phases.items()},
        "pack_s": round(total_s, 6),
        "h2d_bytes": by_operand,
        "h2d_bytes_total": total_bytes,
        "pubkeys_uploaded_bytes": up_b,
        "pubkeys_reuploaded_bytes": re_b,
    }


def pending_pack() -> Optional[dict]:
    """Peek at this thread's staged (not yet committed) pack row."""
    return getattr(_tls, "pending", None)


def commit_verify(verdict: Optional[bool], d2h_bytes: int = 1) -> None:
    """One staged verify completed on THIS thread: pop the staged pack
    row, count the verdict read-back, and journal the full ledger row
    as ONE ``transfer_ledger`` flight-recorder event. No staged row
    (ledger was off at pack time) = no event: the journal never carries
    fabricated bytes. The pop happens even when disabled: a row staged
    before a disable/enable cycle must never be journaled against a
    later, unrelated verify."""
    row = getattr(_tls, "pending", None)
    _tls.pending = None
    if not _enabled or row is None:
        return
    _D2H_BYTES.inc(int(d2h_bytes))
    _LEDGER_VERIFIES.with_labels("device").inc()
    ops = row["h2d_bytes"]
    phase_fields = {
        f"{p}_s": s for p, s in row["phases"].items()
    }
    flight_recorder.record(
        "transfer_ledger",
        kind=row["kind"], path=row["path"],
        indexed=row.get("indexed", False),
        n_sets=row["n_sets"],
        b=row["b"], k=row["k"], m=row["m"],
        pack_s=row["pack_s"],
        **phase_fields,
        h2d_bytes_total=row["h2d_bytes_total"],
        pubkeys_bytes=ops.get("pubkeys", 0),
        signatures_bytes=ops.get("signatures", 0),
        messages_bytes=ops.get("messages", 0),
        aux_bytes=ops.get("aux", 0),
        padding_bytes=ops.get("padding", 0),
        pubkeys_uploaded_bytes=row["pubkeys_uploaded_bytes"],
        pubkeys_reuploaded_bytes=row["pubkeys_reuploaded_bytes"],
        d2h_bytes=int(d2h_bytes),
        # None = the verify raised before producing a verdict (the row
        # still lands: the pack's bytes were real)
        verdict=None if verdict is None else bool(verdict),
    )


def note_op_bytes(operand_nbytes: Dict[str, int], kind: Optional[str] = None) -> None:
    """Standalone device-op H2D attribution for dispatches that are NOT
    a signature-set pack: the MSM host helpers (``device_msm_g1`` ships
    G1 points + scalars, ``device_sum_g2`` ships G2 points). Ticks the
    same ``bls_device_h2d_bytes_total{operand,kind}`` family against the
    current attribution context (or an explicit ``kind``) and lands the
    byte total in the slot ledger. No journal row and no re-upload
    sketch: those are per-verify surfaces, and an MSM is not a verify."""
    if not _enabled:
        return
    k = kind if kind is not None else current_context()[0]
    total = 0
    for op, nb in operand_nbytes.items():
        nb = int(nb)
        if nb:
            _H2D_BYTES.with_labels(op, k).inc(nb)
            total += nb
    if total:
        slot_ledger.note_h2d_bytes(total)


def record_cpu(n_sets: int, kind: Optional[str] = None,
               path: Optional[str] = None) -> None:
    """A CPU-resolved verification (the compile service's fallback):
    journal a zero-device-byte ledger row so data-movement accounting
    stays exactly-once across resolution paths: the device shipped
    nothing for these sets, and the row says so."""
    if not _enabled:
        return
    ckind, cpath = current_context()
    _LEDGER_VERIFIES.with_labels("cpu").inc()
    flight_recorder.record(
        "transfer_ledger",
        kind=kind if kind is not None else ckind,
        path=path if path is not None else cpath,
        n_sets=int(n_sets),
        b=0, k=0, m=0,
        pack_s=0.0,
        h2d_bytes_total=0,
        pubkeys_bytes=0, signatures_bytes=0, messages_bytes=0,
        aux_bytes=0, padding_bytes=0,
        pubkeys_uploaded_bytes=0, pubkeys_reuploaded_bytes=0,
        d2h_bytes=0,
        verdict=None,
    )


# ---------------------------------------------------------------------------
# Device-memory telemetry (reads torch.cuda only once CUDA is up)
# ---------------------------------------------------------------------------

_mem_lock = threading.Lock()
_last_mem_update = 0.0
# kind -> the CUDA caching allocator's memory_stats() key
_MEM_STAT_KEYS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
)


def update_device_memory(force: bool = False) -> Optional[dict]:
    """Refresh ``device_memory_bytes{kind}`` from the CUDA caching
    allocator of device 0 (the node's first card, as the JAX probe reads
    its first device). Throttled to one probe per ``mem_interval_s``
    unless ``force``; returns the gauge values, or None when torch is
    not imported or CUDA is not initialized in this process.

    Kinds: ``bytes_in_use`` (``allocated_bytes.all.current``: memory the
    port's tensors hold now), ``peak_bytes_in_use``
    (``allocated_bytes.all.peak``) and ``bytes_limit`` (the card's total
    memory, ``torch.cuda.mem_get_info``). The allocator's reserved
    segments (CUDA-graph pools among them) are not a kind here, as XLA's
    allocator stats have none; ``torch.cuda.memory_reserved()`` reads
    them. The JAX kind ``live_buffers`` (the sum of live arrays' bytes)
    is left out: torch keeps no registry of live tensors, and
    ``bytes_in_use`` is its nearest measure.

    Never initializes CUDA: a telemetry or HTTP thread must not bring a
    backend up as a side effect (the JAX module's rule; on a lost card
    that is a hang)."""
    global _last_mem_update
    if not _enabled and not force:
        return None
    now = time.monotonic()
    with _mem_lock:
        if not force and now - _last_mem_update < _mem_interval_s:
            return None
        _last_mem_update = now
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return None
    out = {}
    try:
        if not torch.cuda.is_initialized():
            return None
        dev = torch.device("cuda", 0)
        stats = torch.cuda.memory_stats(dev)
        for kind, key in _MEM_STAT_KEYS:
            if key in stats:
                out[kind] = int(stats[key])
        out["bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
    except Exception:
        return out or None
    # refresh EVERY exported kind: one the current probe no longer
    # reports decays to 0 (children cannot be unregistered)
    stale = {
        labels[0] for labels in _DEVICE_MEMORY.children()
    } - set(out)
    for kind, v in out.items():
        _DEVICE_MEMORY.with_labels(kind).set(v)
    for kind in stale:
        _DEVICE_MEMORY.with_labels(kind).set(0)
    return out or None


# ---------------------------------------------------------------------------
# Summary (the `data_movement` document)
# ---------------------------------------------------------------------------


def summary() -> dict:
    """One document: cumulative per-operand/per-kind H2D bytes,
    pack-phase seconds, pack share of the device verify wall, effective
    H2D bandwidth over the device_put phase, the repeat-pubkey window,
    and device memory."""
    by_operand: Dict[str, float] = {}
    by_kind: Dict[str, float] = {}
    for (operand, kind), child in _H2D_BYTES.children().items():
        by_operand[operand] = by_operand.get(operand, 0) + child.value
        by_kind[kind] = by_kind.get(kind, 0) + child.value
    h2d_total = sum(by_operand.values())

    phases = {}
    for (phase,), child in _PACK_SECONDS.children().items():
        total, sum_, _ = child.snapshot()
        if total:
            phases[phase] = {"count": total, "sum_s": round(sum_, 6)}
    pack_sum = phases.get("total", {}).get("sum_s", 0.0)
    dput_sum = phases.get("device_put", {}).get("sum_s", 0.0)

    # pack share of the end-to-end verify wall (the histogram family
    # registered by crypto/device/bls.py; absent until it is imported)
    verify_wall = 0.0
    fam = metrics.get("bls_device_verify_seconds")
    if fam is not None and hasattr(fam, "children"):
        for _labels, child in fam.children().items():
            _t, s, _c = child.snapshot()
            verify_wall += s

    # throttle-respecting probe; between probes the gauges' last values
    # serve (the same data at probe-interval freshness)
    mem = update_device_memory()
    if mem is None:
        mem = {
            labels[0]: child.value
            for labels, child in _DEVICE_MEMORY.children().items()
        } or None

    return {
        "enabled": _enabled,
        "h2d_bytes_total": int(h2d_total),
        "h2d_bytes_by_operand": {
            op: int(v) for op, v in sorted(by_operand.items())
        },
        "h2d_bytes_by_kind": {
            k: int(v) for k, v in sorted(by_kind.items())
        },
        "d2h_bytes_total": int(_D2H_BYTES.value),
        "pack_seconds": phases,
        "pack_share_of_verify_wall": (
            round(pack_sum / verify_wall, 4) if verify_wall else None
        ),
        # needs BOTH: the phase histogram is always-on, so with the
        # ledger disabled dput_sum > 0 while bytes stay 0: that is
        # "unmeasured", never a confident 0.0 B/s
        "h2d_bandwidth_bytes_per_s": (
            round(h2d_total / dput_sum, 1)
            if dput_sum and h2d_total else None
        ),
        "pubkey_reupload": _tracker.summary(),
        "device_memory": mem,
    }
