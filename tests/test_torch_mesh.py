"""The port's device mesh, its sharded scheduling, failover, watchdog and
recovery, the compile service's mesh ladder, the key table's replicas and
the fault-injection layer, against the JAX package's.

Scheduling-layer cases run each package in turn on a placeholder mesh
(``DeviceMesh(devices=[None, None])``) with one shared stub verifier, and
compare with exact equality: dp plans and shard assignments, verdicts and
exceptions, the ``shard_lost`` / ``shard_probation`` / ``shard_recovered``
/ ``watchdog_reaped`` event sequences (fields that carry wall time or
random jitter dropped), failover outcomes and ``mesh.status()`` less the
device strings, the time-dependent fields and ``bubble_ratio``. Flushes
are triggered by hand under a deadline of minutes. Events of concurrent
shard workers are compared per shard. Both packages' flight recorders,
fault points and meshes are process-global; each case clears them.

The key table replicates on a ``[cpu, cpu]`` mesh in the port and on a
placeholder mesh in the JAX package. One end-to-end case runs
``CudaBackend(device="cpu")`` behind the port's scheduler on a
``[cpu, cpu]`` mesh, kills shard 1 at the real staged-dispatch seam
mid-run, and holds the verdicts against ``cpu-native``.
"""

from __future__ import annotations

import random
import threading
import time
import types

import numpy as np
import pytest
import torch

from lighthouse_tpu import compile_service as jcs
from lighthouse_tpu.crypto.device import mesh as jmesh
from lighthouse_tpu.utils import fault_injection as jfi
from lighthouse_tpu.utils import flight_recorder as jfr
from lighthouse_tpu.utils import metrics as jmetrics
from lighthouse_tpu.verification_service import VerificationScheduler as JaxScheduler
from lighthouse_tpu.verification_service import traffic as jtraffic
from lighthouse_tpu.verification_service.batcher import WatchdogTimeout as JaxWatchdog
from lighthouse_tpu.verification_service.planner import FlushPlanner as JaxPlanner
from lighthouse_tpu_torch.compile_service import lowering as tlowering
from lighthouse_tpu_torch.compile_service import service as tcs
from lighthouse_tpu_torch.crypto.device import bls as tdbls
from lighthouse_tpu_torch.crypto.device import mesh as tmesh
from lighthouse_tpu_torch.utils import fault_injection as tfi
from lighthouse_tpu_torch.utils import flight_recorder as tfr
from lighthouse_tpu_torch.utils import metrics as tmetrics
from lighthouse_tpu_torch.utils import pipeline_profiler as tpp
from lighthouse_tpu_torch.verification_service import VerificationScheduler as TorchScheduler
from lighthouse_tpu_torch.verification_service import traffic as ttraffic
from lighthouse_tpu_torch.verification_service.batcher import WatchdogTimeout as TorchWatchdog
from lighthouse_tpu_torch.verification_service.planner import FlushPlanner as TorchPlanner

LONG_MS = 600_000.0  # no deadline trigger fires while a case runs
STAGES = ("stage1", "stage2", "stage3")
MESH_KINDS = ("shard_lost", "shard_probation", "shard_recovered", "watchdog_reaped")
# fields carrying wall time or the backoff's random jitter
VOLATILE = {"seconds", "next_probe_s", "down_s"}

PKGS = {
    "jax": types.SimpleNamespace(
        mesh=jmesh, fi=jfi, fr=jfr, Scheduler=JaxScheduler, Planner=JaxPlanner,
        Watchdog=JaxWatchdog, cs=jcs.service, svc_kw={}),
    "torch": types.SimpleNamespace(
        mesh=tmesh, fi=tfi, fr=tfr, Scheduler=TorchScheduler, Planner=TorchPlanner,
        Watchdog=TorchWatchdog, cs=tcs, svc_kw={"device": "cpu"}),
}


def _reset_globals():
    for p in PKGS.values():
        p.fr.clear()
        p.fi.clear()
        p.mesh.clear_mesh()


@pytest.fixture(autouse=True)
def _clean():
    _reset_globals()
    yield
    _reset_globals()


def both(scenario, **kw):
    """Run ``scenario(P, **kw)`` for each package in turn (globals reset
    and the jitter's RNG seeded the same before each) and return the two
    results."""
    out = {}
    for name, P in PKGS.items():
        _reset_globals()
        random.seed(1234)
        out[name] = scenario(P, **kw)
    return out["jax"], out["torch"]


def _mk_sets(kind, n, pubkeys=1, messages=2):
    return [(None, [None] * pubkeys, kind.encode() + (i % messages).to_bytes(4, "big"))
            for i in range(n)]


def _flush(sched, subs, timeout=60):
    """Submit ``subs`` ((kind, sets) pairs) in order, flush by hand, and
    return each verdict or exception as a comparable value."""
    futs = [sched.submit(sets, kind) for kind, sets in subs]
    sched.flush()
    out = []
    for f in futs:
        exc = f.exception(timeout=timeout)
        out.append(f.result() if exc is None else f"{type(exc).__name__}: {exc}")
    return out


def _events(P, kinds=MESH_KINDS):
    return [(e["kind"], {k: v for k, v in e["fields"].items() if k not in VOLATILE})
            for e in P.fr.events(list(kinds))]


def _dispatches(P):
    """The ``shard_dispatch`` journal, sorted (shard workers run
    concurrently)."""
    return sorted((e["fields"]["shard"], e["fields"]["kinds"], e["fields"]["n_sets"],
                   e["fields"]["rung"], e["fields"]["route"], e["fields"]["ok"])
                  for e in P.fr.events(["shard_dispatch"]))


def _mesh_status(mesh):
    """``status()`` less device strings, the time-dependent fields and
    ``bubble_ratio``."""
    st = mesh.status()
    st["chips"] = [{k: v for k, v in c.items()
                    if k not in ("device", "platform", "bubble_ratio", "next_probe_in_s")}
                   for c in st["chips"]]
    return st


def _idle(svc, timeout=10.0):
    """The compile service's worker has nothing queued, in flight or
    waiting to retry (the JAX service has no ``wait_idle``)."""
    _wait(lambda: not svc._queue and svc._in_flight is None and not svc._retry_at,
          timeout, "an idle compile service")
    return True


def _wait(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


class _Sub:
    __slots__ = ("kind", "sets")

    def __init__(self, kind, sets):
        self.kind = kind
        self.sets = sets


# ---------------------------------------------------------------------------
# Planner: the dp shard axis
# ---------------------------------------------------------------------------


def _plan_doc(plan, subs):
    index = {id(s): i for i, s in enumerate(subs)}
    return [plan.mode, plan.shards_used(),
            [(sb.shard, sb.kinds, list(sb.rung), sb.cold, sorted(index[id(s)] for s in sb.subs))
             for sb in plan.sub_batches]]


@pytest.mark.parametrize("dp_min", [4, 8])
def test_dp_plans_and_shard_assignments_match_jax(dp_min):
    """Seeded random traffic on random shard sets, with and without
    per-shard warm views: the same sub-batches on the same shards, every
    submission exactly once, and the dp_min_sets floor on every shard of
    a split."""
    rng = random.Random(0xD0 + dp_min)
    kinds = ("unaggregated", "aggregate", "sync_message")
    for _round in range(30):
        subs = [_Sub(rng.choice(kinds), _mk_sets("k", rng.randint(1, 9), rng.randint(1, 4)))
                for _ in range(rng.randint(1, 24))]
        shards = sorted(rng.sample(range(6), rng.randint(1, 4)))
        warm = None
        if rng.random() < 0.5:
            warm = {s: rng.sample([(8, 1, 2), (16, 1, 2), (16, 4, 2), (32, 4, 2)],
                                  rng.randint(0, 4)) for s in shards}
        docs = [_plan_doc(P.Planner(dp_min_sets=dp_min).plan(subs, warm_rungs=warm,
                                                             shards=shards), subs)
                for P in PKGS.values()]
        assert docs[0] == docs[1]
        _mode, used, sbs = docs[1]
        members = sorted(i for sb in sbs for i in sb[4])
        assert members == list(range(len(subs)))  # each submission once
        per_kind = {}  # kind -> shard -> sets: the floor holds per kind group
        for shard, kind, _rung, _cold, idx in sbs:
            assert shard is None or shard in shards
            at = per_kind.setdefault(kind, {})
            at[shard] = at.get(shard, 0) + sum(len(subs[i].sets) for i in idx)
        if len(used) > 1 and warm is None:
            for at in per_kind.values():
                if len(at) > 1:
                    assert all(n >= dp_min for n in at.values()), per_kind


def test_headline_mix_splits_across_shards_as_in_jax():
    subs = [_Sub("unaggregated", _mk_sets("u", 1, 1)) for _ in range(32)]
    subs += [_Sub("aggregate", _mk_sets("a", 1, 8)) for _ in range(16)]
    docs = [_plan_doc(P.Planner(dp_min_sets=8).plan(subs, shards=[0, 1]), subs)
            for P in PKGS.values()]
    assert docs[0] == docs[1]
    mode, used, sbs = docs[1]
    assert mode == "planned" and used == [0, 1]
    per_shard = {}
    for shard, _kinds, _rung, _cold, members in sbs:
        per_shard[shard] = per_shard.get(shard, 0) + len(members)
    assert per_shard == {0: 24, 1: 24}


def test_lockstep_replay_dp_plans_match_jax():
    events = jtraffic.gossip_steady(duration_s=6.0, seed=11)
    a = jtraffic.lockstep_replay(events, shards=[0, 1])
    b = ttraffic.lockstep_replay(ttraffic.gossip_steady(duration_s=6.0, seed=11),
                                 shards=[0, 1])
    assert a["digest"] == b["digest"]
    assert any(fl["dp_shards"] == [0, 1] for fl in b["flushes"])


# ---------------------------------------------------------------------------
# Mesh: health, accounting, scope, metric families
# ---------------------------------------------------------------------------


def _health_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)
    out = [m.healthy_shards(), m.primary_shard(), m.failover_shard(0), len(m)]
    m.note_dispatch(1, 8, 0.01)
    out.append(_mesh_status(m))
    err = RuntimeError("chip gone")
    out += [m.note_failure(1, err, lost=True), m.note_failure(1, err, lost=True),
            m.healthy_shards(), m.failover_shard(1), m.is_probing(1), m.probing_shards()]
    out.append(m.note_failure(0, err, lost=False))
    out.append(_mesh_status(m))
    m.restore_shard(1)
    out += [m.healthy_shards(), m.is_probing(1), P.mesh.healthy_shard_count(),
            _mesh_status(m), _events(P)]
    m._t0 -= 120.0  # two windows old: the rate divides by the window
    m.note_dispatch(0, 30, 0.01)
    out.append(m.status()["chips"][0]["sets_per_sec"])
    P.mesh.clear_mesh(m)
    out.append(P.mesh.healthy_shard_count())
    return out


def test_mesh_health_status_and_events_match_jax():
    j, t = both(_health_scenario)
    assert j == t
    assert t[-2] == pytest.approx(30 / 60.0, rel=0.1)
    lost = [f for k, f in t[-3] if k == "shard_lost"]
    assert len(lost) == 1 and lost[0]["shard"] == 1


def test_dispatch_scope_sets_the_thread_local_shard():
    for P in PKGS.values():
        m = P.mesh.DeviceMesh(devices=[None, None])
        P.mesh.set_mesh(m)
        assert P.mesh.current_shard() is None
        with P.mesh.dispatch_to(1):
            assert P.mesh.current_shard() == 1
            with P.mesh.dispatch_to(0):
                assert P.mesh.current_shard() == 0
            assert P.mesh.current_shard() == 1
            seen = []
            th = threading.Thread(target=lambda: seen.append(P.mesh.current_shard()))
            th.start()
            th.join()
            assert seen == [None]  # the scope is per thread
        assert P.mesh.current_shard() is None


def test_port_mesh_devices_and_scope_on_explicit_devices():
    """Explicit devices: names and ``torch.device`` objects, CPU included;
    a CPU or placeholder shard sets only the thread-local, and a device
    scope that fails to enter leaves it untouched."""
    m = tmesh.DeviceMesh(devices=["cpu", torch.device("cpu"), None])
    assert m.devices == [torch.device("cpu"), torch.device("cpu"), None]
    assert m.device_for(0) == torch.device("cpu") and m.device_for(5) is None
    assert m.memory_by_shard() == {0: None, 1: None, 2: None}
    assert m._default_canary(0) and m._default_canary(2)
    tpp.reset()  # no dispatch recorded yet: every shard's ratio is None
    st = m.status()
    assert [c["platform"] for c in st["chips"]] == ["cpu", "cpu", None]
    assert all(c["bubble_ratio"] is None for c in st["chips"])
    tmesh.set_mesh(m)
    with tmesh.dispatch_to(1):
        assert tmesh.current_shard() == 1
    tmesh.set_mesh(tmesh.DeviceMesh(devices=["cuda:0"]))
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            with tmesh.dispatch_to(0):
                pass
        assert tmesh.current_shard() is None
        with pytest.raises(RuntimeError, match="no CUDA devices"):
            tmesh.DeviceMesh()


def test_mesh_metric_families_match_jax():
    jnames = {n for n in jmetrics.registry_snapshot()
              if n.startswith(("bls_device_shard_", "fault_"))}
    tnames = {n for n in tmetrics.registry_snapshot()
              if n.startswith(("bls_device_shard_", "fault_"))}
    # the busy-seconds family is the pipeline profiler's, in both packages
    assert len(tnames) == 11 and tnames == jnames
    for name in tnames:
        assert type(tmetrics.get(name)).__name__ == type(jmetrics.get(name)).__name__


# ---------------------------------------------------------------------------
# Scheduler: sharded dispatch, failover, verify_now
# ---------------------------------------------------------------------------


def _sharded_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)
    calls, lock = [], threading.Lock()

    def verify(sets):
        with lock:
            calls.append((P.mesh.current_shard(), threading.current_thread().name, len(sets)))
        return True

    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS,
                        flush_planner=P.Planner(dp_min_sets=8)).start()
    try:
        verdicts = _flush(sched, [("unaggregated", s) for s in
                                  [_mk_sets("u", 1, 1) for _ in range(32)]])
    finally:
        sched.stop()
    st = sched.status()
    return {
        "verdicts": verdicts,
        "calls": sorted(calls),
        "last_plan": st["planner"]["last_plan"],
        "dp_shards": st["dp_shards"],
        "dispatches": _dispatches(P),
        "mesh": _mesh_status(m),
    }


def test_sharded_flush_dispatches_on_both_shards_as_in_jax():
    j, t = both(_sharded_scenario)
    assert j == t
    assert t["verdicts"] == [True] * 32 and t["dp_shards"] == 2
    assert t["last_plan"]["dp_shards"] == [0, 1]
    # each shard's sub-batch ran on its own worker thread
    assert {(s, name) for s, name, _n in t["calls"]} == {(0, "flush-shard-0"),
                                                        (1, "flush-shard-1")}
    assert [c["sets_total"] for c in t["mesh"]["chips"]] == [16, 16]


def _loss_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)
    poison = _mk_sets("p", 1, 1)
    kill = {"on": False}
    calls, lock = [], threading.Lock()

    def verify(sets):
        shard = P.mesh.current_shard()
        with lock:
            calls.append((shard, len(sets)))
        if kill["on"] and shard == 1:
            raise RuntimeError("injected chip loss")
        return not any(s is poison[0] for s in sets)

    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS,
                        flush_planner=P.Planner(dp_min_sets=8)).start()
    out = {}
    try:
        out["r1"] = _flush(sched, [("unaggregated", _mk_sets("u", 1, 1)) for _ in range(32)])
        kill["on"] = True
        subs = [("unaggregated", _mk_sets("u", 1, 1)) for _ in range(31)]
        out["r2"] = _flush(sched, subs + [("unaggregated", poison)])
        out["healthy"] = m.healthy_shards()
        out["events"] = _events(P)
        out["r3"] = _flush(sched, [("unaggregated", _mk_sets("u", 1, 1)) for _ in range(32)])
        st = sched.status()
        out["last_plan"] = st["planner"]["last_plan"]
        out["dp_shards"] = st["dp_shards"]
        out["bisections"] = st["bisections_total"]
    finally:
        sched.stop()
    out["calls"] = sorted(calls, key=str)
    out["mesh"] = _mesh_status(m)
    return out


def test_shard_loss_fails_over_with_verdicts_as_in_jax():
    """Shard 1 dies mid-run: its sub-batch re-verifies on shard 0, the
    poisoned submission is still the only False, ``shard_lost`` and the
    probation entry are journaled, and the next flush plans on shard 0
    alone."""
    j, t = both(_loss_scenario)
    assert j == t
    assert t["r1"] == [True] * 32 and t["r3"] == [True] * 32
    assert t["r2"] == [True] * 31 + [False]
    assert t["healthy"] == [0] and t["dp_shards"] == 1
    assert t["last_plan"]["dp_shards"] in ([], [0])
    assert [k for k, _f in t["events"]] == ["shard_lost", "shard_probation"]
    assert t["events"][1][1]["attempt"] == 0


def _work_failure_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)

    def verify(sets):
        raise ValueError("deterministic backend bug")

    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS,
                        flush_planner=P.Planner(dp_min_sets=4)).start()
    try:
        verdicts = _flush(sched, [("unaggregated", _mk_sets("u", 1, 1)) for _ in range(16)])
    finally:
        sched.stop()
    return {"verdicts": verdicts, "healthy": m.healthy_shards(),
            "events": _events(P), "mesh": _mesh_status(m)}


def test_work_failure_propagates_and_keeps_the_shard_as_in_jax():
    j, t = both(_work_failure_scenario)
    assert j == t
    assert t["verdicts"] == ["ValueError: deterministic backend bug"] * 16
    assert t["healthy"] == [0, 1] and t["events"] == []


def _verify_now_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)
    seen = []
    bad = {"shard": None}

    def verify(sets):
        s = P.mesh.current_shard()
        seen.append(s)
        if s == bad["shard"]:
            raise RuntimeError(f"chip {s} gone")
        return True

    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS).start()
    out = []
    try:
        out.append(sched.verify_now(_mk_sets("b", 2, 1), "block"))
        bad["shard"] = 0
        out.append(sched.verify_now(_mk_sets("b", 2, 1), "block"))  # fails over once
        out += [m.healthy_shards(), m.is_probing(0)]
        out.append(sched.verify_now(_mk_sets("b", 2, 1), "block"))  # straight to 1
        bad["shard"] = 1
        # no failover shard left: the retry runs unscoped, on the
        # caller's own device, and shard 1 is lost too
        out.append(sched.verify_now(_mk_sets("b", 2, 1), "block"))
        out.append(m.healthy_shards())
    finally:
        sched.stop()
    out += [seen, _events(P), _mesh_status(m)]
    return out


def test_verify_now_fails_over_once_and_drops_the_chip_as_in_jax():
    j, t = both(_verify_now_scenario)
    assert j == t
    assert t[:7] == [True, True, [1], True, True, True, []]
    assert t[7] == [0, 0, 1, 1, 1, None]


def _verify_now_work_failure(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)

    def verify(sets):
        raise ValueError("work bug")

    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS).start()
    try:
        with pytest.raises(ValueError):
            sched.verify_now(_mk_sets("b", 2, 1), "block")
    finally:
        sched.stop()
    return m.healthy_shards(), _mesh_status(m)


def test_verify_now_work_failure_keeps_the_shards_as_in_jax():
    j, t = both(_verify_now_work_failure)
    assert j == t and t[0] == [0, 1]


def _verify_now_warm_check(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)
    dispatched, fallback_calls = [], []

    def verify(sets):
        dispatched.append(P.mesh.current_shard())
        return True

    def fallback(sets):
        fallback_calls.append(len(sets))
        return True

    svc = P.cs.CompileService(rungs=((1, 1, 1),), compile_rung_fn=lambda b, k, m: {},
                              fallback_verify_fn=fallback, **P.svc_kw).start()
    P.cs.set_service(svc)
    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS, compile_service=svc).start()
    try:
        _idle(svc)
        impl = svc._impl()
        sets = _mk_sets("b", 2, 1, messages=1)
        m.note_failure(0, RuntimeError("chip gone"), lost=True)
        svc.registry.mark_ready((2, 1, 1), impl, device=0)  # warm on the dead shard only
        out = [sched.verify_now(sets, "block"), list(fallback_calls), list(dispatched)]
        svc.registry.mark_ready((2, 1, 1), impl, device=1)
        out += [sched.verify_now(sets, "block"), list(fallback_calls), list(dispatched)]
        _idle(svc)
        out.append(svc.warm_rungs_by_shard([0, 1]))
    finally:
        sched.stop()
        svc.stop()
        P.cs.clear_service(svc)
    return out


def test_verify_now_routes_against_the_dispatching_shard_as_in_jax():
    j, t = both(_verify_now_warm_check)
    assert j == t
    assert t[:6] == [True, [2], [], True, [2], [1]]


# ---------------------------------------------------------------------------
# Recovery: probation, backoff, re-admission
# ---------------------------------------------------------------------------


def _recovery_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None], probe_base_s=0.02, probe_max_s=0.05)
    P.mesh.set_mesh(m)
    probes = []

    def probe(shard):
        probes.append((shard, P.mesh.current_shard()))
        return len(probes) >= 3  # two failed probes, then a passing one

    m.start_recovery(probe_fn=probe)
    try:
        assert m.note_failure(1, RuntimeError("chip gone"), lost=True)
        _wait(lambda: m.healthy_shards() == [0, 1], msg="re-admission")
    finally:
        m.stop_recovery()
    return {"probes": probes, "events": _events(P), "mesh": _mesh_status(m)}


def test_probation_backoff_and_recovery_match_jax():
    j, t = both(_recovery_scenario)
    assert j == t
    assert t["probes"] == [(1, 1)] * 3  # each probe in the shard's scope
    assert [(k, f.get("attempt", f.get("probes"))) for k, f in t["events"]] == [
        ("shard_lost", None), ("shard_probation", 0), ("shard_probation", 1),
        ("shard_probation", 2), ("shard_recovered", 3)]
    assert t["mesh"]["recoveries_total"] == 1 and t["mesh"]["probation_shards"] == []


def _replan_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None], probe_base_s=0.02, probe_max_s=0.05)
    P.mesh.set_mesh(m)
    broken = {"on": True}

    def verify(sets):
        if broken["on"] and P.mesh.current_shard() == 1:
            raise RuntimeError("injected chip loss")
        return True

    m.start_recovery(probe_fn=lambda shard: not broken["on"])
    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS,
                        flush_planner=P.Planner(dp_min_sets=4)).start()
    out = {}
    try:
        out["r1"] = _flush(sched, [("unaggregated", _mk_sets("u", 1)) for _ in range(16)])
        out["after_loss"] = m.healthy_shards()
        broken["on"] = False
        _wait(lambda: m.healthy_shards() == [0, 1], msg="recovery")
        out["r2"] = _flush(sched, [("unaggregated", _mk_sets("u", 1)) for _ in range(16)])
        out["last_plan"] = sched.status()["planner"]["last_plan"]["dp_shards"]
    finally:
        sched.stop()
        m.stop_recovery()
    out["recoveries"] = m.status()["recoveries_total"]
    return out


def test_scheduler_replans_onto_the_recovered_shard_as_in_jax():
    j, t = both(_replan_scenario)
    assert j == t
    assert t == {"r1": [True] * 16, "after_loss": [0], "r2": [True] * 16,
                 "last_plan": [0, 1], "recoveries": 1}


def test_operator_restore_and_bounded_stop_as_in_jax():
    def scenario(P):
        m = P.mesh.DeviceMesh(devices=[None, None], probe_base_s=0.01, probe_max_s=0.02)
        P.mesh.set_mesh(m)
        probing = threading.Event()

        def slow_probe(shard):
            probing.set()
            time.sleep(0.6)
            return False

        m.start_recovery(probe_fn=slow_probe)
        m.note_failure(1, RuntimeError("gone"), lost=True)
        assert probing.wait(5.0)
        t0 = time.perf_counter()
        m.stop_recovery(timeout=0.1)
        stop_s = time.perf_counter() - t0
        out = [stop_s < 0.5, m.recovery_running(), m.healthy_shards()]
        m.restore_shard(1)  # operator restore wins
        out += [m.is_probing(1), m.healthy_shards()]
        time.sleep(0.7)  # the abandoned probe resolves against cleared state
        out.append(m.status()["recoveries_total"])
        return out

    j, t = both(scenario)
    assert j == t == [True, False, [0], False, [0, 1], 0]


# ---------------------------------------------------------------------------
# Dispatch watchdog
# ---------------------------------------------------------------------------


def _watchdog_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)

    def verify(sets):
        if P.mesh.current_shard() == 1:
            time.sleep(2.0)  # the hang
        return True

    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS, watchdog_s=0.15,
                        flush_planner=P.Planner(dp_min_sets=4)).start()
    try:
        t0 = time.perf_counter()
        verdicts = _flush(sched, [("unaggregated", _mk_sets("u", 1)) for _ in range(16)])
        wall = time.perf_counter() - t0
        st = sched.status()
    finally:
        sched.stop()
    return {"verdicts": verdicts, "bounded": wall < 1.5, "healthy": m.healthy_shards(),
            "probing": m.is_probing(1), "reaped": st["watchdog_reaped_total"],
            "knobs": [st["watchdog_s"], st["watchdog_bypass_s"]], "events": _events(P)}


def test_watchdog_reaps_a_hang_into_failover_as_in_jax():
    j, t = both(_watchdog_scenario)
    assert j == t
    assert t["verdicts"] == [True] * 16 and t["bounded"] and t["healthy"] == [0]
    assert t["reaped"] == 1 and t["knobs"] == [0.15, 0.0]
    assert [k for k, _f in t["events"]] == ["watchdog_reaped", "shard_lost", "shard_probation"]
    assert t["events"][0][1] == {"shard": 1, "deadline_s": 0.15, "n_sets": 8}


def _work_hang_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)

    def verify(sets):
        time.sleep(0.4)  # hangs on every shard
        return True

    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS, watchdog_s=0.1,
                        flush_planner=P.Planner(dp_min_sets=2)).start()
    try:
        verdicts = _flush(sched, [("unaggregated", _mk_sets("u", 1)) for _ in range(4)])
        st = sched.status()
    finally:
        sched.stop()
    reaps = sorted((f["shard"], f["n_sets"]) for k, f in _events(P) if k == "watchdog_reaped")
    return {"verdicts": verdicts, "healthy": m.healthy_shards(),
            "reaped": st["watchdog_reaped_total"], "reaps": reaps}


def test_watchdog_work_hang_propagates_and_keeps_the_shards_as_in_jax():
    j, t = both(_work_hang_scenario)
    assert j["verdicts"] == [v.replace("JaxWatchdog", "WatchdogTimeout") for v in t["verdicts"]]
    assert j == t
    assert all(v.startswith("WatchdogTimeout: sharded dispatch on shard")
               for v in t["verdicts"])
    assert t["healthy"] == [0, 1] and t["reaped"] == 8


def _watchdog_relay_scenario(P):
    m = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(m)
    seen = []

    def verify(sets):
        seen.append((P.mesh.current_shard(), threading.current_thread().name))
        raise ValueError("deterministic backend bug")

    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS, watchdog_s=5.0,
                        flush_planner=P.Planner(dp_min_sets=1)).start()
    try:
        verdicts = _flush(sched, [("unaggregated", _mk_sets("u", 2))])
    finally:
        sched.stop()
    return verdicts, sorted(seen), m.healthy_shards()


def test_watchdog_relays_the_original_exception_in_the_shard_scope_as_in_jax():
    j, t = both(_watchdog_relay_scenario)
    assert j == t
    assert t[0] == ["ValueError: deterministic backend bug"]
    assert t[1] == [(0, "dispatch-wd-0"), (1, "dispatch-wd-1")] and t[2] == [0, 1]


# ---------------------------------------------------------------------------
# Chaos: sticky fault, probation, recovery with the mesh ladder warm; hang
# ---------------------------------------------------------------------------

N_SUBS = 16
CHAOS_RUNGS = ((8, 1, 1), (16, 1, 1))


def _chaos_scenario(P):
    compile_calls = []

    def compile_rung(b, k, m):
        compile_calls.append((b, k, m))
        return {s: {"seconds": 0.001, "fresh": True} for s in STAGES}

    poison = [(None, [None], b"shared-message")]

    def verify(sets):
        if P.mesh.current_shard() == 1:
            P.fi.fire("staged_dispatch")  # every shard-1 dispatch, probes included
        return not any(s is poison[0] for s in sets)

    def subs():
        return [("unaggregated", [(None, [None], b"shared-message")]) for _ in range(N_SUBS)]

    mesh = P.mesh.DeviceMesh(devices=[None, None], probe_base_s=0.05, probe_max_s=0.2)
    P.mesh.set_mesh(mesh)
    mesh.start_recovery(probe_fn=lambda shard: bool(verify(_mk_sets("canary", 1))))
    svc = P.cs.CompileService(rungs=CHAOS_RUNGS, compile_rung_fn=compile_rung,
                              **P.svc_kw).start()
    P.cs.set_service(svc)
    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS, compile_service=svc,
                        flush_planner=P.Planner(dp_min_sets=4)).start()
    out = {}
    try:
        _wait(lambda: all(len(svc.warm_rungs_active(device=d)) == len(CHAOS_RUNGS)
                          for d in (0, 1)), msg="mesh ladder warm")
        out["ladder"] = list(compile_calls)
        out["by_shard"] = svc.warm_rungs_by_shard([0, 1])
        out["p1"] = _flush(sched, subs())
        out["p1_plan"] = sched.status()["planner"]["last_plan"]["dp_shards"]
        P.fi.arm("staged_dispatch", nth=1, sticky=True)
        out["p2"] = _flush(sched, subs()[: N_SUBS - 1] + [("unaggregated", poison)])
        out["p2_healthy"] = mesh.healthy_shards()
        _wait(lambda: mesh.status()["chips"][1]["probe_attempts"] >= 2, msg="backoff probes")
        out["p3"] = _flush(sched, subs())
        out["p3_dp"] = sched.status()["dp_shards"]
        P.fi.clear()
        _wait(lambda: mesh.healthy_shards() == [0, 1], msg="re-admission")
        for _ in range(2):
            out.setdefault("p4", []).append(_flush(sched, subs()))
        out["p4_plan"] = sched.status()["planner"]["last_plan"]["dp_shards"]
        out["compiles_after"] = len(compile_calls) - len(out["ladder"])
    finally:
        P.fi.clear()
        sched.stop()
        svc.stop()
        P.cs.clear_service(svc)
        mesh.stop_recovery()
    evs = _events(P)
    attempts = [f["attempt"] for k, f in evs if k == "shard_probation"]
    out["attempts_prefix"] = attempts[:3]
    out["recovered"] = [(f["shard"], f["warm_rungs"]) for k, f in evs if k == "shard_recovered"]
    out["lost"] = [f["shard"] for k, f in evs if k == "shard_lost"]
    out["injected"] = sorted({(e["fields"]["point"], e["fields"]["action"])
                              for e in P.fr.events(["fault_injected"])})
    out["recoveries"] = mesh.status()["recoveries_total"]
    return out


def test_chaos_loss_probation_recovery_with_zero_new_warmups_as_in_jax():
    j, t = both(_chaos_scenario)
    assert j == t
    assert sorted(t["ladder"]) == sorted(CHAOS_RUNGS * 2)
    assert t["p1"] == [True] * N_SUBS and t["p1_plan"] == [0, 1]
    assert t["p2"] == [True] * (N_SUBS - 1) + [False] and t["p2_healthy"] == [0]
    assert t["attempts_prefix"] == [0, 1, 2] and t["p3_dp"] == 1
    assert t["p4"] == [[True] * N_SUBS] * 2 and t["p4_plan"] == [0, 1]
    assert t["compiles_after"] == 0 and t["recoveries"] == 1
    assert t["recovered"] == [(1, len(CHAOS_RUNGS))] and t["lost"] == [1]
    assert t["injected"] == [("staged_dispatch", "raise")]


def _hang_scenario(P):
    def verify(sets):
        if P.mesh.current_shard() == 1:
            P.fi.fire("staged_dispatch")  # one-shot hang on shard 1's first dispatch
        return True

    mesh = P.mesh.DeviceMesh(devices=[None, None])
    P.mesh.set_mesh(mesh)
    sched = P.Scheduler(verify_fn=verify, deadline_ms=LONG_MS, watchdog_s=0.2,
                        flush_planner=P.Planner(dp_min_sets=4)).start()
    try:
        P.fi.arm("staged_dispatch", nth=1, hang_s=2.0)
        t0 = time.perf_counter()
        verdicts = _flush(sched, [("unaggregated", _mk_sets("u", 1)) for _ in range(N_SUBS)])
        wall = time.perf_counter() - t0
        st = sched.status()
    finally:
        P.fi.clear()
        sched.stop()
    hangs = [e["fields"] for e in P.fr.events(["fault_injected"])]
    return {"verdicts": verdicts, "bounded": wall < 1.5, "healthy": mesh.healthy_shards(),
            "reaped": st["watchdog_reaped_total"], "events": _events(P), "hangs": hangs}


def test_chaos_injected_hang_is_reaped_within_the_deadline_as_in_jax():
    j, t = both(_hang_scenario)
    assert j == t
    assert t["verdicts"] == [True] * N_SUBS and t["bounded"] and t["healthy"] == [0]
    assert t["reaped"] == 1
    assert t["hangs"] == [{"point": "staged_dispatch", "call": 1, "action": "hang",
                           "hang_s": 2.0}]


# ---------------------------------------------------------------------------
# Compile service: the mesh ladder
# ---------------------------------------------------------------------------


def _ladder_scenario(P):
    mesh = P.mesh.DeviceMesh(devices=[None, None, None])
    P.mesh.set_mesh(mesh)
    order = []
    gate = threading.Event()

    def compile_rung(b, k, m):
        gate.wait(10)
        order.append((b, k, m))
        return {s: {"seconds": 0.0, "fresh": True} for s in STAGES}

    svc = P.cs.CompileService(rungs=((8, 1, 1), (16, 1, 1)), compile_rung_fn=compile_rung,
                              **P.svc_kw).start()
    try:
        _wait(lambda: svc.status()["in_flight"] is not None, msg="first warm-up")
        st = svc.status()
        queued = {"queue": st["queue"], "in_flight": st["in_flight"],
                  "mesh_devices": st["mesh_devices"]}
        gate.set()
        assert _idle(svc)
        warm = sorted(r[:3] + r[4:] for r in svc.status()["warm_rungs_by_device"])
        # shard 2 lost with recovery off (no probation): its rungs are
        # skipped; a probing shard's rungs are live work
        mesh.note_failure(2, RuntimeError("gone"), lost=True)
        mesh._shards[2].probation = False
        svc.request(32, 1, 1, device=2)
        assert _idle(svc)
        skipped = svc.warm_rungs_by_shard([2])
        mesh._shards[2].probation = True
        svc.request(32, 1, 1, device=2)
        assert _idle(svc)
        probing = svc.warm_rungs_by_shard([0, 2])
    finally:
        svc.stop()
    return {"queued": queued, "order": order, "warm": warm, "skipped": skipped,
            "probing": probing}


def test_compile_service_walks_the_mesh_ladder_as_in_jax():
    j, t = both(_ladder_scenario)
    assert j == t
    assert t["queued"] == {"queue": [[8, 1, 1, 1], [8, 1, 1, 2], [16, 1, 1, 0],
                                     [16, 1, 1, 1], [16, 1, 1, 2]],
                           "in_flight": [8, 1, 1, 0], "mesh_devices": [0, 1, 2]}
    assert t["order"] == [(8, 1, 1)] * 3 + [(16, 1, 1)] * 3 + [(32, 1, 1)]
    assert t["skipped"] == {2: [(8, 1, 1), (16, 1, 1)]}
    assert t["probing"] == {0: [(8, 1, 1), (16, 1, 1)],
                            2: [(8, 1, 1), (16, 1, 1), (32, 1, 1)]}


def test_compile_fault_point_drives_the_retry_as_in_jax():
    def scenario(P):
        calls = []
        svc = P.cs.CompileService(rungs=((4, 1, 1),), compile_rung_fn=lambda b, k, m: (
            calls.append((b, k, m)), {s: {"seconds": 0.0, "fresh": True} for s in STAGES})[1],
            **P.svc_kw)
        svc.retry_base_s = svc.retry_max_s = 0.01
        P.fi.arm("compile", nth=1)
        svc.start()
        try:
            assert _idle(svc)
            st = svc.status()
        finally:
            svc.stop()
        return calls, st["failed_total"], st["retry"]["retries_total"], [
            (e["fields"]["point"], e["fields"]["call"]) for e in P.fr.events(["fault_injected"])]

    j, t = both(scenario)
    assert j == t == ([(4, 1, 1)], 1, 1, [("compile", 1)])


def test_warm_gather_runs_on_the_shards_replica():
    """``lowering.warm_gather(..., shard=1)`` gathers from shard 1's
    replica in shard 1's scope; ``_shard_scope`` is a no-op without a
    mesh."""
    from lighthouse_tpu_torch.crypto import bls as tbls
    from lighthouse_tpu_torch.crypto.device import key_table as tkt

    assert tmesh.current_shard() is None
    with tlowering._shard_scope(1):
        assert tmesh.current_shard() is None
    assert tmesh.device_of(1, "cpu") == "cpu"
    mesh = tmesh.DeviceMesh(devices=["cpu", "cpu"])
    tmesh.set_mesh(mesh)
    cache = types.SimpleNamespace(
        pubkeys=[tbls.SecretKey(41_000 + i).public_key() for i in range(2)])
    table = tkt.DeviceKeyTable(cache, max_aggregates=2, device="cpu")
    table.sync(reason="startup")
    seen = []
    real = tdbls._run_stage

    def spy(stage, fn, *args):
        seen.append((stage, tmesh.current_shard(), args[0] is table.device_arrays(1)[0]))
        return real(stage, fn, *args)

    tdbls._run_stage = spy
    try:
        rec = tlowering.warm_gather(4, 2, table, shard=1)
    finally:
        tdbls._run_stage = real
    assert seen == [("gather", 1, True)] and rec["fresh"]
    assert tmesh.device_of(1, "cuda") == torch.device("cpu")


# ---------------------------------------------------------------------------
# The staged seam and the backend in a shard scope
# ---------------------------------------------------------------------------


def test_run_stage_keys_freshness_per_shard_and_fires_the_fault_seam():
    mesh = tmesh.DeviceMesh(devices=["cpu", "cpu"])
    tmesh.set_mesh(mesh)
    tdbls.reset_recompile_tracking()
    x = torch.zeros(3, dtype=torch.int32)
    fresh = []
    for shard in (0, 0, 1, 1):
        with tmesh.dispatch_to(shard):
            fresh.append(tdbls._run_stage("mesh-test", torch.neg, x)[2])
    assert fresh == [True, False, True, False]
    tfi.arm("staged_dispatch", nth=2)
    with tmesh.dispatch_to(0):
        tdbls._run_stage("mesh-test", torch.neg, x)
    with tmesh.dispatch_to(1), pytest.raises(tfi.InjectedFault):
        tdbls._run_stage("mesh-test", torch.neg, x)
    with tmesh.dispatch_to(1):
        tdbls._run_stage("mesh-test", torch.neg, x)  # one-shot: the next call runs
    st = tfi.status()["points"]["staged_dispatch"]
    assert (st["calls"], st["injected"]) == (3, 1)


def test_backend_packs_and_routes_on_the_scoped_shard(monkeypatch):
    """``CudaBackend`` in a shard scope packs on that shard's device and
    asks the compile service for that shard's rung; outside any scope it
    uses its own device and shard 0."""
    from lighthouse_tpu_torch.crypto import bls as tbls

    mesh = tmesh.DeviceMesh(devices=["cpu", "meta"])
    tmesh.set_mesh(mesh)
    svc = tcs.CompileService(rungs=((1, 1, 1),), compile_rung_fn=lambda b, k, m: {},
                             device="cpu").start()
    tcs.set_service(svc)
    seen = []

    class Stop(Exception):
        pass

    def pads_for(n, k, m, device=0):
        seen.append(("pads_for", device))
        return None

    def pack(sets, **kw):
        seen.append(("pack", str(kw["device"])))
        raise Stop

    monkeypatch.setattr(svc, "pads_for", pads_for)
    monkeypatch.setattr(tdbls, "pack_signature_sets_raw", pack)
    sk = tbls.SecretKey(7)
    sets = [(sk.sign(b"\x01" * 32), [sk.public_key().point], b"\x01" * 32)]
    backend = tdbls.CudaBackend(device="cpu")
    try:
        for scope in (None, 1, 0):
            with tmesh.dispatch_to(scope), pytest.raises(Stop):
                backend.verify_signature_sets(sets)
    finally:
        svc.stop()
        tcs.clear_service(svc)
    assert seen == [("pads_for", 0), ("pack", "cpu"), ("pads_for", 1), ("pack", "meta"),
                    ("pads_for", 0), ("pack", "cpu")]


def test_no_mesh_no_shard_axis():
    """Without a mesh the scheduler plans no shard axis, journals no
    ``shard_dispatch`` and reports 0 dp shards."""
    calls = []
    sched = TorchScheduler(verify_fn=lambda sets: calls.append(tmesh.current_shard()) or True,
                           deadline_ms=LONG_MS, flush_planner=TorchPlanner(dp_min_sets=1)).start()
    try:
        assert _flush(sched, [("unaggregated", _mk_sets("u", 1)) for _ in range(8)]) == [True] * 8
        st = sched.status()
    finally:
        sched.stop()
    assert st["dp_shards"] == 0 and st["planner"]["last_plan"]["dp_shards"] == []
    assert set(calls) == {None} and tfr.events(["shard_dispatch"]) == []


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    dict(p=0.3, seed=7), dict(p=0.05, seed=123456), dict(every=3, after=2),
    dict(nth=4, sticky=True), dict(p=0.5, seed=9, count=3), dict(every=2, count=2, sticky=True),
])
def test_fault_schedule_matches_jax(spec):
    assert tfi.schedule(200, **spec) == jfi.schedule(200, **spec)


def test_fault_spec_status_and_journal_match_jax():
    spec = "staged_dispatch:nth=2,mode=sticky;compile:p=0.5,seed=3;key_table_sync:hang=0.01"
    assert tfi.parse_spec(spec) == jfi.parse_spec(spec)
    for bad in ("nope:nth=1", "compile:bogus=1", "compile:mode=often", "compile",
                "staged_dispatch:nth=1,shard=1"):
        for fi in (jfi, tfi):
            with pytest.raises(ValueError):
                fi.parse_spec(bad)
    docs = []
    for P in PKGS.values():
        P.fr.clear()
        P.fi.configure(spec)
        outcomes = []
        for point in ("staged_dispatch",) * 4 + ("compile",) * 6 + ("key_table_sync",):
            try:
                P.fi.fire(point)
                outcomes.append("ok")
            except P.fi.InjectedFault as e:
                outcomes.append(str(e))
        st = P.fi.status()
        evs = [e["fields"] for e in P.fr.events(["fault_injected"])]
        docs.append((outcomes, st, evs, P.fi.armed()))
        P.fi.clear()
        assert not P.fi.armed()
    assert docs[0] == docs[1]
    with pytest.raises(ValueError):
        tfi.arm("duty_lookahead", nth=1)  # no such seam in the port


MESH_ENV = ("LIGHTHOUSE_TPU_DP_MESH", "LIGHTHOUSE_TPU_DP_DEVICES", "LIGHTHOUSE_TPU_MESH_RECOVERY",
            "LIGHTHOUSE_TPU_MESH_PROBE_BASE_S", "LIGHTHOUSE_TPU_MESH_PROBE_MAX_S")


@pytest.mark.parametrize("env", [
    {}, {"LIGHTHOUSE_TPU_DP_MESH": "0"}, {"LIGHTHOUSE_TPU_DP_MESH": ""},
    {"LIGHTHOUSE_TPU_MESH_RECOVERY": "0"}, {"LIGHTHOUSE_TPU_DP_DEVICES": "4"},
    {"LIGHTHOUSE_TPU_DP_DEVICES": " All "}, {"LIGHTHOUSE_TPU_DP_DEVICES": "auto"},
    {"LIGHTHOUSE_TPU_DP_DEVICES": "0"}, {"LIGHTHOUSE_TPU_DP_DEVICES": "two"},
    {"LIGHTHOUSE_TPU_MESH_PROBE_BASE_S": "0.25", "LIGHTHOUSE_TPU_MESH_PROBE_MAX_S": "2"},
    {"LIGHTHOUSE_TPU_MESH_PROBE_BASE_S": "soon"},
])
def test_mesh_env_knobs_read_as_jax(monkeypatch, env):
    """The mesh's env knobs keep the JAX package's names and parse the
    same: the dp switch, the dp width, the recovery kill switch and the
    probe backoff a placeholder mesh picks up."""
    for name in MESH_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for fn in ("env_enabled", "recovery_env_enabled", "env_devices"):
        assert getattr(tmesh, fn)() == getattr(jmesh, fn)(), fn
    backoff = [{k: m.status()[k] for k in ("probe_base_s", "probe_max_s")}
               for m in (tmesh.DeviceMesh(devices=[None]), jmesh.DeviceMesh(devices=[None]))]
    assert backoff[0] == backoff[1]


# ---------------------------------------------------------------------------
# Key table: one replica per shard
# ---------------------------------------------------------------------------


def _jax_table(n):
    from lighthouse_tpu.crypto import bls as jbls
    from lighthouse_tpu.crypto.device import key_table as jkt

    cache = types.SimpleNamespace(pubkeys=[
        types.SimpleNamespace(point=jbls.SecretKey(31_000 + i).public_key().point)
        for i in range(n)])
    return jkt, cache, jkt.DeviceKeyTable(cache, max_aggregates=4)


def _torch_table(n):
    from lighthouse_tpu_torch.crypto import bls as tbls
    from lighthouse_tpu_torch.crypto.device import key_table as tkt

    cache = types.SimpleNamespace(pubkeys=[
        types.SimpleNamespace(point=tbls.SecretKey(31_000 + i).public_key().point)
        for i in range(n)])
    return tkt, cache, tkt.DeviceKeyTable(cache, max_aggregates=4, device="cpu")


def test_key_table_replicates_per_shard_all_or_nothing_as_in_jax():
    """A two-shard mesh: startup and delta syncs commit on both replicas
    or neither (also under an armed ``key_table_sync`` fault), upload
    bytes count per replica, the resolve path serves the dispatch shard's
    replica, aggregate inserts write every replica, and the replicas equal
    each other and the JAX table's on the same registry."""
    out = {}
    for name, P, make, devices in (("jax", PKGS["jax"], _jax_table, [None, None]),
                                   ("torch", PKGS["torch"], _torch_table, ["cpu", "cpu"])):
        mesh = P.mesh.DeviceMesh(devices=devices)
        P.mesh.set_mesh(mesh)
        kt, cache, table = make(3)
        doc = {"added": table.sync(reason="startup")}
        st = table.status()
        doc["replicas"], doc["startup_bytes"] = st["replicas"], st["upload_bytes"]["startup"]
        (d0, a0), (d1, a1) = table.device_arrays(0), table.device_arrays(1)
        doc["distinct"] = d0 is not d1 and a0 is not a1
        doc["rows"] = [np.asarray(d0[:3]).tolist(), np.asarray(d1[:3]).tolist()]
        pts = [pk.point for pk in cache.pubkeys]
        with P.mesh.dispatch_to(1):
            res = table.resolve_sets([(None, [pts[0], pts[1]], b"m" * 32)])
        doc["resolved_replica_1"] = res is not None and res[1] is table.device_arrays(1)[0]
        new = make(4)[1].pubkeys[3]
        cache.pubkeys.append(new)
        P.fi.arm("key_table_sync", nth=1)
        with pytest.raises(P.fi.InjectedFault):
            table.sync(reason="delta")
        P.fi.clear()
        doc["after_fault"] = [len(table), table.status()["upload_bytes"]]
        doc["delta"] = table.sync(reason="delta")
        d0, d1 = (np.asarray(table.device_arrays(s)[0][:4]) for s in (0, 1))
        doc["delta_equal"] = (d0 == d1).all() and not (d0[3] == 0).all()
        doc["rows4"] = d0.tolist()
        committee = [(None, [pts[0], pts[1]], b"c" * 32)]
        assert table.resolve_sets(committee) is not None
        assert table.resolve_sets(committee) is not None
        st = table.status()
        doc["agg"] = [st["aggregate_inserts"], st["upload_bytes"]["aggregate"]]
        aggs = [np.asarray(table.device_arrays(s)[1]) for s in (0, 1)]
        doc["agg_rows_equal"] = (aggs[0] == aggs[1]).all()
        doc["agg_rows"] = aggs[0].tolist()
        out[name] = doc
        P.mesh.clear_mesh(mesh)
    assert out["jax"] == out["torch"]
    t = out["torch"]
    assert t["replicas"] == [0, 1] and t["distinct"] and t["resolved_replica_1"]
    from lighthouse_tpu_torch.crypto.device import key_table as tkt

    assert t["startup_bytes"] == 3 * tkt.G1_ROW_BYTES * 2
    assert t["after_fault"][0] == 3 and t["delta"] == 1 and t["delta_equal"]
    assert t["agg"] == [1, tkt.G1_ROW_BYTES * 2] and t["agg_rows_equal"]


def test_key_table_without_a_mesh_keeps_one_replica():
    _kt, cache, table = _torch_table(2)
    table.sync(reason="startup")
    st = table.status()
    assert st["replicas"] == [0] and st["upload_bytes"]["startup"] == 2 * _kt.G1_ROW_BYTES
    assert table.device_arrays(1) == (None, None)
    with tmesh.dispatch_to(1):  # no mesh: the lowest replica still serves
        assert table.device_arrays()[0] is table.device_arrays(0)[0]


# ---------------------------------------------------------------------------
# End to end: the CPU backend behind the scheduler on a [cpu, cpu] mesh
# ---------------------------------------------------------------------------


def test_cpu_backend_on_a_two_shard_mesh_loses_shard_1_with_cpu_natives_verdicts():
    """Round 1 splits two valid submissions across shards 0 and 1. Then
    shard 1 is killed the way ``tests/test_zgate9_chaos.py`` keys its
    fault: the verifier raises :class:`InjectedFault` in shard 1's dispatch
    scope while the fault is on, then runs the backend. Round 2's
    sub-batch on shard 1 fails over to shard 0, shard 1 is lost, and every
    verdict (one submission signed over the wrong message) equals
    ``cpu-native``'s."""
    from lighthouse_tpu.crypto import backend as jbackend
    from lighthouse_tpu.crypto import bls as jbls
    from lighthouse_tpu_torch.crypto import bls as tbls
    from lighthouse_tpu_torch.crypto import native

    raw = []
    for sk, msg, signed in ((11, b"\x31" * 32, b"\x31" * 32), (12, b"\x32" * 32, b"\x32" * 32),
                            (13, b"\x33" * 32, b"\x33" * 32), (14, b"\x34" * 32, b"\x35" * 32)):
        raw.append((tbls.SecretKey(sk).public_key().serialize(),
                    native.native_sign(sk, signed), msg))

    def sets_of(bls_mod):
        return [[bls_mod.SignatureSet(bls_mod.Signature.deserialize(sig),
                                      [bls_mod.PublicKey.deserialize(pk)], msg)]
                for pk, sig, msg in raw]

    prev = jbackend.active().name
    jbackend.set_backend("cpu-native")
    try:
        want = [jbls.verify_signature_sets(s) for s in sets_of(jbls)]
    finally:
        jbackend.set_backend(prev)
    assert want == [True, True, True, False]

    subs = sets_of(tbls)
    mesh = tmesh.DeviceMesh(devices=["cpu", "cpu"])
    tmesh.set_mesh(mesh)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    lost = threading.Event()

    def verify(sets):
        if lost.is_set() and tmesh.current_shard() == 1:
            raise tfi.InjectedFault("staged_dispatch: shard 1 lost")
        return tbls.verify_signature_sets(sets, device="cpu")

    sched = TorchScheduler(verify_fn=verify, deadline_ms=LONG_MS,
                           flush_planner=TorchPlanner(dp_min_sets=1)).start()
    try:
        got = _flush(sched, [("unaggregated", s) for s in subs[:2]], timeout=300)
        round1 = _dispatches(PKGS["torch"])
        lost.set()
        got += _flush(sched, [("unaggregated", s) for s in subs[2:]], timeout=300)
    finally:
        sched.stop()
        torch.set_num_threads(threads)
    assert got == want
    assert [d[0] for d in round1] == [0, 1]
    assert mesh.healthy_shards() == [0]
    events = _events(PKGS["torch"])
    assert [k for k, _f in events] == ["shard_lost", "shard_probation"]
    assert "shard 1 lost" in events[0][1]["error"]
