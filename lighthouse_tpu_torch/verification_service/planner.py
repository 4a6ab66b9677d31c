"""Shape-aware flush planner: bin-packed, kind-homogeneous sub-batches.
The port's copy of the JAX package's ``verification_service/planner.py``,
plain Python with no device import.

At flush time the scheduler (``batcher.py``) hands the fused submission
list to :meth:`FlushPlanner.plan`, which partitions it into one or more
sub-batches:

* **sub-bucket by kind**: attestation and sync-committee sets have
  near-fixed (K, M) geometry per caller kind, so kind-homogeneous
  sub-batches stop padding the K/M axes up to the mix's max;
* **split static from dynamic**: with a device key table attached
  (``crypto/device/key_table.py``), submissions whose every pubkey is
  table-resident are packed apart from the others, since the backend's
  gathered packer is all-or-nothing per batch;
* **bin-pack the B axis**: a kind group's submissions are first-fit-
  decreasing packed across ladder rungs, minimizing padded lanes B*K*M;
* **prefer warm rungs**: with a compile-service registry attached, a
  sub-batch lands on the cheapest warm rung covering it; a split that
  would go cold while the single rung is warm falls back to the single
  rung (a plan never trades a warm dispatch for a shed);
* **fall back when it can't win**: a split is used only when its padded
  lanes, plus a charge per extra dispatch, beat the single-rung plan;
* **shard the dp axis**: given several healthy mesh shards, each kind
  group is balance-partitioned across them (whole submissions, never
  fewer than ``dp_min_sets`` per shard) and scored by the busiest
  shard. The port has no mesh yet; the axis is pure logic over shard id
  lists;
* **class-aware packing**: ``plan(..., qos="bulk")`` packs a bulk-class
  drain for throughput: a cold big rung re-bins onto the largest
  covering warm rung instead of shedding, and the dp floor rises to
  :data:`BULK_DP_MIN_SETS`. The deadline class never does this.

Submissions are ATOMIC: a submission is the verdict-isolation unit
(bisection, ``batcher.py``) and is never split across sub-batches or
shards.

This module also owns the bucket ladder every packer and the compile
service pad to (:data:`BUCKET_LADDER`, :func:`round_up_bucket`), the one
lane/padding-waste formula (:func:`padded_lanes`, :func:`live_lanes`,
:func:`padding_waste_ratio`) and the sub-batches' ``est_h2d_bytes``, priced by the transfer
ledger's analytic byte model of a padded rung
(``utils/transfer_ledger.operand_bytes_model`` and
``live_operand_bytes``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..utils import transfer_ledger

Rung = Tuple[int, int, int]  # (B, K, M) padded bucket shape

# 48/96/192 are the intermediate rungs the flush planner bin-packs onto
# (observed traffic shapes a power-of-two ladder padded up).
BUCKET_LADDER = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256, 512, 1024)


def round_up_bucket(n: int, ladder: Sequence[int] = BUCKET_LADDER) -> int:
    """Padded size for ``n`` sets (or pubkeys, or messages): the smallest
    ladder rung holding ``n``, then multiples of the top rung."""
    for c in ladder:
        if n <= c:
            return c
    top = ladder[-1]
    return ((n + top - 1) // top) * top


# Scoring charge for every sub-batch beyond the first, in padded-lane
# units: a dispatch pays fixed overhead (host pack, dispatch, device
# sync) that the cost model prices at roughly this many B*K*M cells, so
# the planner never shreds trickle traffic into tiny batches just to
# shave a lane or two — the fusing win of the scheduler stays intact.
DEFAULT_SUBBATCH_OVERHEAD_LANES = 16
# Minimum sets a dp shard is worth waking up for: below this the
# per-dispatch fixed overhead dominates whatever parallelism buys, so a
# kind group smaller than 2x this stays on one shard (trickle keeps
# fusing; the shard axis is for the big warm rungs).
DEFAULT_DP_MIN_SETS = 8
# Bulk-class dp floor: a bulk flush exists to fill the big
# rungs, so a shard is only worth waking for a big-rung-worth of sets —
# below this the deadline-class floor would shred a 512-set drain into
# dispatch-overhead-dominated slivers across chips.
BULK_DP_MIN_SETS = 64
_ENV_OVERHEAD = "LIGHTHOUSE_TPU_SCHED_PLAN_OVERHEAD_LANES"
_ENV_PLANNER = "LIGHTHOUSE_TPU_SCHED_PLANNER"
_ENV_DP_MIN = "LIGHTHOUSE_TPU_SCHED_DP_MIN_SETS"


# ---------------------------------------------------------------------------
# THE lane / padding-waste formula (one definition, two metric families)
# ---------------------------------------------------------------------------


def padded_lanes(b: int, k: int, m: int) -> int:
    """Device lanes a padded (B, K, M) batch pays for: the full B*K*M
    volume — B set lanes x K pubkey slots x M message-plane slices."""
    return int(b) * int(k) * int(m)


def live_lanes(pk_slots: int, m_req: int) -> int:
    """Lanes the callers actually asked for: the real pubkey slots
    (sum of len(pks) over live sets) replicated across the m_req live
    message-plane slices. Padding on ANY axis (B, K or M) shows up as
    the gap to :func:`padded_lanes`."""
    return int(pk_slots) * max(1, int(m_req))


def padding_waste_ratio(live: int, padded: int) -> float:
    """1 - live/padded: the fraction of paid-for device lanes no caller
    asked for. 0.0 for an empty/degenerate batch (nothing was paid)."""
    if padded <= 0:
        return 0.0
    return max(0.0, 1.0 - live / float(padded))


# ---------------------------------------------------------------------------
# Geometry extraction (shared with compile_service._geometry)
# ---------------------------------------------------------------------------


def set_geometry(item) -> Tuple[int, Optional[bytes]]:
    """(pubkey count, hashable message key) of ONE signature set —
    a ``SignatureSet`` object or a ``(sig, pks, msg)`` triple. Anything
    else conservatively counts as a 1-pubkey set with an un-keyable
    message (over-reserving only risks extra padding)."""
    keys = getattr(item, "signing_keys", None)
    msg = getattr(item, "message", None)
    if keys is None and isinstance(item, (tuple, list)) and len(item) == 3:
        keys, msg = item[1], item[2]
    k = len(keys) if keys is not None else 1
    if msg is None:
        return k, None
    try:
        return k, bytes(msg)
    except (TypeError, ValueError):
        return k, None


def flush_geometry(sets) -> Tuple[int, int, int]:
    """(n_sets, max pubkeys/set, unique messages) of a flush — the three
    dims the packers pad. Un-keyable messages each count distinct."""
    n = 0
    k = 1
    msgs: Set[bytes] = set()
    distinct = 0
    for item in sets:
        n += 1
        ki, key = set_geometry(item)
        k = max(k, ki or 1)
        if key is None:
            distinct += 1
        else:
            msgs.add(key)
    return n, k, max(1, len(msgs) + distinct)


# ---------------------------------------------------------------------------
# Plan data model
# ---------------------------------------------------------------------------


class PlannedSubBatch:
    """One dispatch of the plan: whole submissions, their live geometry,
    and the padded rung the backend will land on. ``static`` marks a
    sub-batch whose every pubkey resolves to the device key table
   : the backend ships a ``(B, K)`` index plane for it, so
    its byte estimate uses the indexed operand model."""

    __slots__ = (
        "subs", "sets", "kinds", "n_sets", "k_req", "m_req",
        "pk_slots", "rung", "cold", "static", "shard", "live", "padded",
        "est_h2d_bytes", "est_live_h2d_bytes",
    )

    def __init__(self, subs: List, rung: Rung, cold: bool,
                 n_sets: int, k_req: int, m_req: int, pk_slots: int,
                 static: bool = False, shard: Optional[int] = None):
        self.subs = subs
        self.sets = [st for s in subs for st in s.sets]
        self.kinds = "+".join(sorted({s.kind for s in subs}))
        self.n_sets = n_sets
        self.k_req = k_req
        self.m_req = m_req
        self.pk_slots = pk_slots
        self.rung = rung
        self.cold = cold
        self.static = static
        # the dp shard this sub-batch dispatches on; None =
        # unsharded (primary device) — the pre-mesh behavior
        self.shard = shard
        self.live = live_lanes(pk_slots, m_req)
        self.padded = padded_lanes(*rung)
        # byte accounting: what the packer will ship
        # host→device for this element's padded rung, and the live share
        # the callers asked for — the shared analytic model pinned
        # against the packer's actual ndarray.nbytes by test. A static
        # sub-batch prices the index plane.
        self.est_h2d_bytes = transfer_ledger.operand_bytes_model(
            *rung, indexed=static
        )["total"]
        self.est_live_h2d_bytes = transfer_ledger.live_operand_bytes(
            n_sets, pk_slots, m_req, indexed=static
        )["total"]

    def waste(self) -> float:
        return padding_waste_ratio(self.live, self.padded)


class FlushPlan:
    """The planner's answer: ``mode`` is ``"planned"`` (multi- or
    better-shaped sub-batches) or ``"single"`` (today's one-rung flush,
    the fallback). Lane totals use the shared formula above."""

    __slots__ = (
        "mode", "sub_batches", "live", "padded",
        "legacy_rung", "legacy_padded", "legacy_cold",
        "est_h2d_bytes", "est_live_h2d_bytes",
    )

    def __init__(self, mode: str, sub_batches: List[PlannedSubBatch],
                 legacy_rung: Rung, legacy_cold: bool = False):
        self.mode = mode
        self.sub_batches = sub_batches
        self.live = sum(sb.live for sb in sub_batches)
        self.padded = sum(sb.padded for sb in sub_batches)
        self.legacy_rung = legacy_rung
        self.legacy_padded = padded_lanes(*legacy_rung)
        self.legacy_cold = legacy_cold
        self.est_h2d_bytes = sum(sb.est_h2d_bytes for sb in sub_batches)
        self.est_live_h2d_bytes = sum(
            sb.est_live_h2d_bytes for sb in sub_batches
        )

    def waste(self) -> float:
        return padding_waste_ratio(self.live, self.padded)

    def rungs_label(self) -> str:
        return "+".join(
            f"{b}x{k}x{m}" for (b, k, m) in (sb.rung for sb in self.sub_batches)
        )

    def shards_used(self) -> List[int]:
        """Distinct dp shards this plan dispatches on (empty when the
        plan is unsharded — the single-device behavior)."""
        return sorted({
            sb.shard for sb in self.sub_batches if sb.shard is not None
        })


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


def best_covering_rung(
    warm: Iterable[Rung], n: int, k: int, m: int
) -> Optional[Rung]:
    """Cheapest rung in ``warm`` covering (n, k, m), minimizing padded
    lanes. THE covering policy: ``WarmShapeRegistry.best_covering``
    (compile_service/service.py) delegates here, so the rung the
    planner scores a sub-batch at is the rung routing actually lands
    it on."""
    cands = [r for r in warm if r[0] >= n and r[1] >= k and r[2] >= m]
    if not cands:
        return None
    return min(cands, key=lambda r: (padded_lanes(*r), r[0], r[1], r[2]))


def _largest_rung_at_most(n: int) -> int:
    best = BUCKET_LADDER[0]
    for c in BUCKET_LADDER:
        if c <= n:
            best = c
    return best


def _active_key_table():
    """The process-global device key table, reached lazily so this
    module imports no torch: the planner only calls the table's host-side
    ``covers_sets``."""
    try:
        from ..crypto.device import key_table as _kt

        return _kt.get_active_table()
    except Exception:
        return None


class FlushPlanner:
    """Stateless-per-flush planner (see module docstring). ``overhead_
    lanes`` is the scoring charge per sub-batch beyond the first;
    ``enabled=False`` always returns the single-rung plan (the
    pre-planner behavior, byte-identical)."""

    def __init__(
        self,
        overhead_lanes: Optional[int] = None,
        enabled: Optional[bool] = None,
        dp_min_sets: Optional[int] = None,
    ):
        if overhead_lanes is None:
            try:
                overhead_lanes = int(os.environ.get(_ENV_OVERHEAD, ""))
            except ValueError:
                overhead_lanes = DEFAULT_SUBBATCH_OVERHEAD_LANES
        self.overhead_lanes = max(0, int(overhead_lanes))
        if dp_min_sets is None:
            try:
                dp_min_sets = int(os.environ.get(_ENV_DP_MIN, ""))
            except ValueError:
                dp_min_sets = DEFAULT_DP_MIN_SETS
        self.dp_min_sets = max(1, int(dp_min_sets))
        if enabled is None:
            enabled = os.environ.get(_ENV_PLANNER, "1") not in ("", "0")
        self.enabled = bool(enabled)

    # -- public entry -----------------------------------------------------

    def plan(
        self,
        subs: Sequence,
        warm_rungs=None,
        shards: Optional[Sequence[int]] = None,
        qos: str = "deadline",
    ) -> FlushPlan:
        """Partition ``subs`` (objects with ``.kind`` and ``.sets``) into
        sub-batches. ``warm_rungs`` is the compile-service registry's
        warm (B, K, M) set for the active engine — a flat iterable, or
        (mesh-aware) a ``{shard: [rungs]}`` dict so a COLD
        shard sheds to fallback instead of stalling a flush; None means
        no service attached (every exact rung dispatches; the packers
        pad to it). ``shards`` is the mesh's healthy shard-id list —
        more than one enables the dp packing axis; None/1 is the
        single-device behavior, byte-identical to before. ``qos`` is
        the flush's service class (module docstring): bulk
        plans fill the largest warm rungs and re-bin cold big rungs
        onto warm coverage; the deadline class is unchanged."""
        bulk = qos == "bulk"
        shard_ids = [int(s) for s in shards] if shards else []
        dp = len(shard_ids) > 1
        warm = warm_rungs
        if warm is not None and not isinstance(warm, dict):
            warm = list(warm)
        legacy_warm = self._warm_for(warm, shard_ids[0] if shard_ids else None)
        table = _active_key_table()
        subs = list(subs)
        # classify each submission ONCE; the legacy whole-flush flag and
        # the bin-packer's group keys both derive from this pass (no
        # re-walk of the identity map per bin)
        flags = [
            bool(table is not None and self._is_static([s], table))
            for s in subs
        ]
        legacy = self._make_sub_batch(
            subs, legacy_warm, table, static=bool(subs) and all(flags),
            shard=shard_ids[0] if shard_ids else None,
        )
        if not self.enabled or len(subs) == 0:
            return FlushPlan("single", [legacy], legacy.rung, legacy.cold)
        # shards are passed through even at width 1: a one-chip mesh
        # still tags every sub-batch with its shard so per-chip
        # accounting and failover behave uniformly (dp scoring below
        # only engages at width > 1)
        planned = self._kind_binpacked(
            subs, flags, warm, table, shard_ids or None, bulk=bulk
        )
        if len(planned) <= 1:
            # one bin == the legacy plan re-derived; report it as single
            # (same rung by construction: one group, one bin, whole flush)
            return FlushPlan("single", [legacy], legacy.rung, legacy.cold)
        # warm preference dominates the lane score in BOTH directions: a
        # shed pays CPU wall time, not device lanes, so comparing a cold
        # plan's padded lanes against a warm one's is apples-to-oranges.
        # A plan that sends ANY sub-batch to the CPU fallback while the
        # single warm rung could serve the whole flush on device is a
        # de-optimization; conversely an all-warm split must beat a COLD
        # single rung whatever the lane count says.
        if warm is not None:
            planned_cold = any(sb.cold for sb in planned)
            if planned_cold and not legacy.cold:
                return FlushPlan("single", [legacy], legacy.rung, legacy.cold)
            if legacy.cold and not planned_cold:
                return FlushPlan("planned", planned, legacy.rung, legacy.cold)
            if bulk and legacy.cold and any(not sb.cold for sb in planned):
                # bulk partial-warm salvage: when the single
                # rung is cold, a split that gets ANY share onto warm
                # device rungs beats shedding the whole drain to the CPU
                # fallback — the lane score below cannot see the
                # device/CPU cliff (a shed pays CPU wall, not lanes).
                # Deadline-class flushes never take this: a partial shed
                # still stalls the latency class on its slowest member.
                return FlushPlan("planned", planned, legacy.rung, legacy.cold)
        # static/dynamic separation dominates the lane score:
        # when the split isolates key-table-resident sub-batches from
        # raw ones and the single-rung flush would be MIXED (one raw set
        # degrades every static set back to the G1 limb plane), the
        # split is the point — the static share drops ~98% of its pubkey
        # bytes, worth far more than the overhead-lane charge. An
        # all-static or all-raw flush keeps the pure lane comparison.
        static_split = (
            table is not None
            and len({sb.static for sb in planned}) > 1
            and not legacy.static
        )
        if dp and len({sb.shard for sb in planned}) > 1:
            # shards run CONCURRENTLY: the wall-clock cost of a dp plan
            # is the busiest shard's padded lanes (plus its extra
            # dispatches), not the sum over shards — comparing the sum
            # against one device's single rung would charge parallelism
            # as if it were serial and the axis would never win
            per_shard_padded: Dict[Optional[int], int] = {}
            per_shard_count: Dict[Optional[int], int] = {}
            for sb in planned:
                per_shard_padded[sb.shard] = (
                    per_shard_padded.get(sb.shard, 0) + sb.padded
                )
                per_shard_count[sb.shard] = (
                    per_shard_count.get(sb.shard, 0) + 1
                )
            score = max(per_shard_padded.values()) + self.overhead_lanes * (
                max(per_shard_count.values()) - 1
            )
        else:
            score = sum(sb.padded for sb in planned) + self.overhead_lanes * (
                len(planned) - 1
            )
        if score >= legacy.padded and not static_split:
            return FlushPlan("single", [legacy], legacy.rung, legacy.cold)
        return FlushPlan("planned", planned, legacy.rung, legacy.cold)

    # -- internals --------------------------------------------------------

    def _geometry_of(self, subs: List) -> Tuple[int, int, int, int]:
        """(n_sets, k_req, m_req, live pk slots) over whole submissions."""
        n = 0
        k_req = 1
        pk_slots = 0
        msgs: Set[bytes] = set()
        distinct = 0
        for s in subs:
            for item in s.sets:
                n += 1
                ki, key = set_geometry(item)
                k_req = max(k_req, ki or 1)
                pk_slots += ki
                if key is None:
                    distinct += 1
                else:
                    msgs.add(key)
        m_req = max(1, len(msgs) + distinct)
        return n, k_req, m_req, pk_slots

    @staticmethod
    def _warm_for(warm, shard: Optional[int]):
        """The warm-rung set a sub-batch on ``shard`` routes against:
        a per-shard dict (mesh-aware registry) keys by shard — an
        unknown shard reads as COLD, never as another chip's warmth; a
        flat list applies to every shard; None means no service."""
        if isinstance(warm, dict):
            if shard is None:
                if not warm:
                    return None
                shard = sorted(warm)[0]
            return list(warm.get(shard, ()))
        return warm

    def _make_sub_batch(
        self, subs: List, warm: Optional[List[Rung]], table=None,
        static: Optional[bool] = None, shard: Optional[int] = None,
    ) -> PlannedSubBatch:
        """``static=None`` classifies here (the legacy whole-flush
        sub-batch); the bin-packer passes its group's already-known
        flag so a flush is classified once per submission, not re-walked
        per bin. ``warm`` is already shard-resolved by the caller."""
        n, k_req, m_req, pk_slots = self._geometry_of(subs)
        exact: Rung = (
            round_up_bucket(max(1, n)),
            round_up_bucket(k_req),
            round_up_bucket(m_req),
        )
        cold = False
        rung = exact
        if warm is not None:
            covering = best_covering_rung(warm, n, k_req, m_req)
            if covering is not None:
                rung = covering
            else:
                cold = True
        if static is None:
            static = bool(table is not None and self._is_static(subs, table))
        return PlannedSubBatch(
            subs, rung, cold, n, k_req, m_req, pk_slots, static=static,
            shard=shard,
        )

    @staticmethod
    def _is_static(subs: List, table) -> bool:
        """Every set of every submission resolves to the device key
        table (a host predicate; the backend re-verifies identity at
        pack time, so a misprediction costs padding, never
        correctness)."""
        try:
            return all(table.covers_sets(s.sets) for s in subs)
        except Exception:
            return False

    def _kind_binpacked(
        self, subs: List, flags: List[bool], warm,
        table=None, shards: Optional[List[int]] = None,
        bulk: bool = False,
    ) -> List[PlannedSubBatch]:
        """Sub-bucket by kind — and, with a device key table attached,
        by static/dynamic eligibility (``flags``, one per submission,
        classified once by ``plan``), so one out-of-table submission
        cannot degrade a whole flush back to the raw limb plane — then,
        with a dp mesh (``shards``), balance-partition each
        group across shards (whole submissions only; a shard never gets
        fewer than ``dp_min_sets`` sets), then first-fit-decreasing
        bin-pack each (group × shard)'s submissions over the B axis
        with bin capacity = the largest ladder rung <= that partition's
        set count (an oversized submission opens its own bin —
        submissions never split)."""
        groups: Dict[Tuple[str, bool], List] = {}
        for s, static in zip(subs, flags):
            groups.setdefault((s.kind, static), []).append(s)
        planned: List[PlannedSubBatch] = []
        # cross-group shard load so small groups spread over the mesh
        # instead of all landing on the first shard
        shard_load: Dict[int, int] = {s: 0 for s in (shards or ())}
        for kind, _static in sorted(groups):
            members = groups[(kind, _static)]
            n_group = sum(len(s.sets) for s in members)
            if shards:
                parts = self._dp_partition(
                    members, n_group, shards, shard_load,
                    # bulk never shreds below a big-rung-worth per
                    # shard: parallelism is for the big
                    # warm rungs, not for slivers
                    dp_min=(
                        max(self.dp_min_sets, BULK_DP_MIN_SETS)
                        if bulk else self.dp_min_sets
                    ),
                )
            else:
                parts = [(None, members)]
            for shard, part in parts:
                n_part = sum(len(s.sets) for s in part)
                cap = _largest_rung_at_most(max(1, n_part))
                shard_warm = self._warm_for(warm, shard)
                # stable FFD: big submissions first, arrival-order
                # tie-break
                order = sorted(
                    range(len(part)),
                    key=lambda i: (-len(part[i].sets), i),
                )
                bins: List[List] = []  # [submissions, set count]
                for i in order:
                    sub = part[i]
                    size = len(sub.sets)
                    placed = False
                    for b in bins:
                        if b[1] + size <= cap:
                            b[0].append(sub)
                            b[1] += size
                            placed = True
                            break
                    if not placed:
                        # a submission larger than cap still gets its
                        # own bin
                        bins.append([[sub], size])
                for members_bin, _count in bins:
                    sb = self._make_sub_batch(
                        members_bin, shard_warm, table,
                        static=_static, shard=shard,
                    )
                    if bulk and sb.cold and shard_warm:
                        # bulk fills warm rungs: a cold big
                        # rung re-bins onto warm coverage instead of
                        # shedding the drain to the CPU fallback
                        planned.extend(self._bulk_warm_rebin(
                            sb, shard_warm, table, _static, shard,
                        ))
                    else:
                        planned.append(sb)
        return planned

    def _bulk_warm_rebin(
        self, sb: PlannedSubBatch, warm: List[Rung], table,
        static: bool, shard: Optional[int],
    ) -> List[PlannedSubBatch]:
        """Bulk-class cold-rung salvage: ``sb``'s exact big
        rung has no compiled program, but smaller warm rungs may cover
        its (K, M) — re-bin the submissions into chunks of the LARGEST
        covering warm B, so a 512-set backfill drain fills two warm
        256-rungs on device instead of shedding the lot to the CPU
        fallback. The deadline class never does this: splitting a
        latency-class flush multiplies dispatches on the critical path,
        while bulk pays wall-clock it is contractually indifferent to.
        Submissions stay atomic — one larger than every covering warm
        rung keeps its own (cold) bin, and decide_flush sheds exactly
        that remainder, not the whole drain.

        Coverage is judged per CHUNK, not against the whole batch's
        m_req: each set carries one message (``_geometry_of``), so a
        chunk's unique-message count is bounded by its set count — a
        warm (256,1,256) rung serves 256-set chunks of a 512-set
        per-set-distinct-message drain (m_req=512) that could never
        cover the batch whole. A cap below :data:`BULK_DP_MIN_SETS`
        is not worth re-binning for (a big drain would shred into
        dispatch-overhead-dominated slivers): keep the cold bin."""
        cap = 0
        for r in warm:
            if r[1] < sb.k_req:
                continue
            # the rung serves chunks up to its B outright when its M
            # plane covers min(B, batch m_req); else chunks up to its
            # M (a chunk of c sets has at most c unique messages)
            cap = max(cap, (
                r[0] if r[2] >= min(sb.m_req, r[0]) else min(r[0], r[2])
            ))
        if cap < BULK_DP_MIN_SETS:
            return [sb]
        if cap >= sb.n_sets:
            # a covering rung existed after all — sb would not be cold;
            # defensive: keep the original bin
            return [sb]
        bins: List[List] = []
        order = sorted(
            range(len(sb.subs)), key=lambda i: (-len(sb.subs[i].sets), i)
        )
        for i in order:
            sub = sb.subs[i]
            size = len(sub.sets)
            placed = False
            for b in bins:
                if b[1] + size <= cap:
                    b[0].append(sub)
                    b[1] += size
                    placed = True
                    break
            if not placed:
                bins.append([[sub], size])
        if len(bins) <= 1:
            return [sb]
        return [
            self._make_sub_batch(
                members, warm, table, static=static, shard=shard
            )
            for members, _count in bins
        ]

    def _dp_partition(
        self, members: List, n_group: int, shards: List[int],
        shard_load: Dict[int, int], dp_min: Optional[int] = None,
    ) -> List[Tuple[int, List]]:
        """Partition one kind group's submissions across dp shards:
        at most ``n_group // dp_min`` shards participate (a shard
        must be worth its dispatch overhead; ``dp_min`` defaults to
        the deadline class's ``dp_min_sets`` — bulk raises it to
        :data:`BULK_DP_MIN_SETS`), chosen least-loaded
        first; big submissions greedily land on the least-loaded chosen
        shard. Deterministic (sorted, index tie-breaks) — the lockstep
        replay's byte-identical-across-processes gate covers dp plans
        too. Submissions NEVER split across shards."""
        if dp_min is None:
            dp_min = self.dp_min_sets
        k = min(len(shards), max(1, n_group // dp_min))
        if k <= 1:
            s = min(shards, key=lambda i: (shard_load[i], i))
            shard_load[s] += n_group
            return [(s, members)]
        chosen = sorted(shards, key=lambda i: (shard_load[i], i))[:k]
        buckets: Dict[int, List] = {s: [] for s in chosen}
        local: Dict[int, int] = {s: 0 for s in chosen}
        order = sorted(
            range(len(members)), key=lambda i: (-len(members[i].sets), i)
        )
        for i in order:
            sub = members[i]
            s = min(chosen, key=lambda j: (local[j], j))
            buckets[s].append(sub)
            local[s] += len(sub.sets)
        # enforce the floor AFTER the greedy pass: skewed atomic
        # submissions (one 16-set + one 2-set) can leave a shard below
        # dp_min_sets — merge it into the least-loaded other shard so
        # no dispatch is ever worth less than the floor the knob
        # documents. Terminates: every merge removes a bucket.
        while len(buckets) > 1:
            under = [s for s in buckets if local[s] < dp_min]
            if not under:
                break
            s = min(under, key=lambda j: (local[j], j))
            tgt = min(
                (t for t in buckets if t != s),
                key=lambda j: (local[j], j),
            )
            buckets[tgt].extend(buckets.pop(s))
            local[tgt] += local.pop(s)
        for s, n in local.items():
            shard_load[s] += n
        return [(s, buckets[s]) for s in sorted(buckets) if buckets[s]]
