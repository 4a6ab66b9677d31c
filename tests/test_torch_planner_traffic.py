"""The port's flush planner, traffic model and SLO tracker against the JAX
package's, with exact equality.

* ``FlushPlanner.plan`` over seeded submission geometries, with and
  without warm rungs and shard lists, deadline and bulk classes: mode,
  rungs, membership, live and padded lanes, byte estimates, shards.
* Every generator of ``GENERATORS`` at seeds 0-2: the event lists.
* ``write_trace``/``read_trace`` across the two packages.
* ``lockstep_replay``: its JSON output, byte for byte.
* ``SloTracker`` fed the same observations at explicit times: summaries,
  burn documents, latched kinds and the ``slo_burn`` journal.
"""

from __future__ import annotations

import json
import random

import pytest

from lighthouse_tpu.utils import flight_recorder as jfr
from lighthouse_tpu.verification_service import planner as jplanner
from lighthouse_tpu.verification_service import slo as jslo
from lighthouse_tpu.verification_service import traffic as jtraffic
from lighthouse_tpu_torch.utils import flight_recorder as tfr
from lighthouse_tpu_torch.verification_service import planner as tplanner
from lighthouse_tpu_torch.verification_service import slo as tslo
from lighthouse_tpu_torch.verification_service import traffic as ttraffic

KINDS = ("unaggregated", "aggregate", "sync_message", "backfill")
WARM = [(2, 1, 2), (8, 1, 8), (16, 16, 8), (32, 1, 8), (64, 16, 8), (256, 1, 256)]


class Sub:
    __slots__ = ("kind", "sets")

    def __init__(self, kind, sets):
        self.kind = kind
        self.sets = sets


def _subs(seed: int, n: int):
    """Seeded submissions: kind, set count and pubkeys per set; messages
    drawn from a small pool so the M axis dedups."""
    r = random.Random(seed)
    out = []
    for _ in range(n):
        kind = r.choice(KINDS)
        k = {"aggregate": r.choice((8, 16)), "backfill": 1}.get(kind, 1)
        sets = [(None, [None] * k, b"%s-%d" % (kind.encode(), r.randrange(6)))
                for _ in range(r.choice((1, 1, 2, 3, 5, 9, 40)))]
        out.append(Sub(kind, sets))
    return out


def _plan_doc(plan, subs):
    index = {id(s): i for i, s in enumerate(subs)}
    return {
        "mode": plan.mode,
        "rungs": plan.rungs_label(),
        "live": plan.live,
        "padded": plan.padded,
        "legacy": [list(plan.legacy_rung), plan.legacy_padded, plan.legacy_cold],
        "bytes": [plan.est_h2d_bytes, plan.est_live_h2d_bytes],
        "waste": plan.waste(),
        "shards": plan.shards_used(),
        "sub_batches": [
            [sorted(index[id(s)] for s in sb.subs), sb.kinds, list(sb.rung), sb.cold,
             sb.n_sets, sb.k_req, sb.m_req, sb.pk_slots, sb.live, sb.padded,
             sb.shard, sb.est_h2d_bytes, sb.est_live_h2d_bytes]
            for sb in plan.sub_batches
        ],
    }


@pytest.mark.parametrize("warm,shards", [
    (None, None), ("flat", None), (None, [0]), ("flat", [0, 1, 2]),
    ("by_shard", [0]), ("by_shard", [0, 1, 2]),
])
@pytest.mark.parametrize("qos", ["deadline", "bulk"])
def test_flush_plans_match_jax(warm, shards, qos):
    warm_rungs = {"flat": WARM, None: None}.get(warm)
    if warm == "by_shard":
        warm_rungs = {s: WARM[: 2 + 2 * i] for i, s in enumerate(shards)}
    modes = set()
    for seed in range(12):
        subs = _subs(seed, 1 + seed % 7 * 3)
        docs = [_plan_doc(mod.FlushPlanner(overhead_lanes=16, enabled=True, dp_min_sets=8)
                          .plan(subs, warm_rungs=warm_rungs, shards=shards, qos=qos), subs)
                for mod in (jplanner, tplanner)]
        assert docs[1] == docs[0], seed
        modes.add(docs[1]["mode"])
    assert modes == {"single", "planned"}


def test_lane_and_geometry_helpers_match_jax():
    for b, k, m in ((1, 1, 1), (48, 16, 8), (256, 1, 256)):
        assert tplanner.padded_lanes(b, k, m) == jplanner.padded_lanes(b, k, m)
    for live, padded in ((0, 0), (3, 8), (8, 8), (9, 8)):
        assert (tplanner.padding_waste_ratio(live, padded)
                == jplanner.padding_waste_ratio(live, padded))
    sets = [s for sub in _subs(3, 8) for s in sub.sets]
    assert tplanner.flush_geometry(sets) == jplanner.flush_geometry(sets)
    assert (tplanner.best_covering_rung(WARM, 5, 8, 3)
            == jplanner.best_covering_rung(WARM, 5, 8, 3) == (16, 16, 8))
    assert tplanner.BUCKET_LADDER == jplanner.BUCKET_LADDER


def test_planner_disabled_is_the_single_rung():
    subs = _subs(5, 10)
    for mod in (jplanner, tplanner):
        assert mod.FlushPlanner(enabled=False).plan(subs).mode == "single"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generators_match_jax(seed):
    assert sorted(ttraffic.GENERATORS) == sorted(jtraffic.GENERATORS)
    for name, gen in ttraffic.GENERATORS.items():
        kw = {"duration_s": 6.0, "seed": seed}
        assert gen(**kw) == jtraffic.GENERATORS[name](**kw), name


def test_trace_round_trips_across_packages(tmp_path):
    events = ttraffic.epoch_boundary_flood(duration_s=6.0, seed=4)
    assert ttraffic.TRACE_SCHEMA == jtraffic.TRACE_SCHEMA
    for writer, reader, name in ((ttraffic, jtraffic, "t2j"), (jtraffic, ttraffic, "j2t")):
        path = tmp_path / f"{name}.jsonl"
        head = writer.write_trace(str(path), events, name="flood", seed=4,
                                  generator="epoch_boundary_flood", params={"d": 6.0})
        got_head, got = reader.read_trace(str(path))
        own_head, own = writer.read_trace(str(path))
        assert got_head == own_head == head and got == own
        assert [{k: e[k] for k in ev} for e, ev in zip(got, events)] == events
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"schema": "other/1"}) + "\n")
    for mod in (ttraffic, jtraffic):
        with pytest.raises(ValueError, match="unsupported trace schema"):
            mod.read_trace(str(bad))


@pytest.mark.parametrize("case", ["plain", "warm_sharded", "bulk_lookahead"])
def test_lockstep_replay_json_matches_jax(case):
    if case == "plain":
        events = jtraffic.gossip_steady(duration_s=4.0, seed=1)
        kw = {}
    elif case == "warm_sharded":
        events = jtraffic.epoch_boundary_flood(duration_s=4.0, seed=2)
        kw = {"warm_rungs": WARM, "shards": [0, 1], "max_batch_sets": 64}
    else:
        events = jtraffic.bulk_backfill_under_gossip(duration_s=3.0, seed=0)
        events += jtraffic.epoch_boundary_flood(duration_s=3.0, seed=5)
        kw = {"lookahead": True, "bulk_flush_sets": 256, "warm_rungs": WARM}
    want = json.dumps(jtraffic.lockstep_replay(events, **kw), sort_keys=True)
    got = json.dumps(ttraffic.lockstep_replay(events, **kw), sort_keys=True)
    assert got == want


def test_slo_tracker_matches_jax():
    """The same observations at explicit times: a quiet stretch, a miss
    storm that latches the burn alert, bulk samples, and the windows
    after the storm ages out."""
    jfr.clear()
    tfr.clear()
    r = random.Random(9)
    obs = []
    t = 1000.0
    for i in range(400):
        t += r.uniform(0.01, 0.4)
        kind = r.choice(("unaggregated", "aggregate", "backfill"))
        qos = "bulk" if kind == "backfill" else "deadline"
        lat = r.uniform(0.001, 0.2)
        storm = 120 <= i < 200
        missed = qos == "deadline" and (lat > 0.15 or (storm and r.random() < 0.6))
        obs.append((kind, r.choice(("fused", "sub_batch", "bisection")), lat, missed, t, qos))
    docs = []
    for mod in (jslo, tslo):
        tr = mod.SloTracker(window=64, budget_miss_ratio=0.05, fast_window_s=5.0,
                            slow_window_s=20.0, burn_alert=1.0)
        reads = []
        for i, (kind, path, lat, missed, now, qos) in enumerate(obs):
            tr.observe(kind, path, lat, missed, now=now, qos=qos)
            if i % 50 == 49:
                reads.append([tr.summary(deadline_ms=25.0, now=now), tr.burn(now=now),
                              tr.latched_kinds(now=now), tr.misses_total()])
        docs.append(reads)
    assert docs[1] == docs[0]
    assert any(r[2] for r in docs[1]), "the storm must latch a burn alert"
    burns = [[e["fields"] for e in fr.events(["slo_burn"])] for fr in (jfr, tfr)]
    assert burns[1] == burns[0] and burns[1]
    assert tslo.quantile_ms([0.001 * i for i in range(1, 101)], 0.99) == 99.0
