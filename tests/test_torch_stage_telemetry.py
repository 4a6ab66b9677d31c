"""The telemetry hooks wired into the port's device path, on the CPU.

One raw and one gathered (collapsed) verify on ``CudaBackend(device="cpu")``
and one verify whose stage 2 raises: the stage histogram counts the
stages dispatched, the transfer ledger's H2D bytes per verify equal
``last_batch["h2d_bytes"]``, each verify journals exactly one
``bls_stage_verify`` event and one ``transfer_ledger`` row (a raise: the
row alone, with no verdict), and no telemetry call runs inside a
``CapturedProgram`` body (each records while a captured body runs; on
the CPU the body runs eagerly, so a hook inside it would show).

Then two short scheduler passes. The verifier there is a stub that
dispatches one stage through ``bls._run_stage`` per call (the CPU
backend's verify costs seconds, and these checks are about the
scheduler's hooks): on a ``[cpu, cpu]`` mesh with the watchdog armed
and a poisoned set (bisection), then through a compile service whose
rungs are all cold (every flush shed to its fallback). Each flush
journals exactly one ``pipeline_flush``; each shard's bubble causes sum
to its idle time; the ledger context and the flush scope reach the
shard workers and the watchdog's thread; the mesh reports a bubble
ratio per shard; and the admission valve reads a headroom once the
capacity estimator has sampled.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

from lighthouse_tpu_torch.compile_service import service as tcs
from lighthouse_tpu_torch.crypto.device import bls as dbls
from lighthouse_tpu_torch.crypto.device import graphs
from lighthouse_tpu_torch.crypto.device import key_table as kt
from lighthouse_tpu_torch.crypto.device import mesh as tmesh
from lighthouse_tpu_torch.utils import fault_injection as tfi
from lighthouse_tpu_torch.utils import flight_recorder as tfr
from lighthouse_tpu_torch.utils import metrics as tmetrics
from lighthouse_tpu_torch.utils import pipeline_profiler as tpp
from lighthouse_tpu_torch.utils import slot_ledger as tsl
from lighthouse_tpu_torch.utils import timeseries as tts
from lighthouse_tpu_torch.utils import tracing as ttracing
from lighthouse_tpu_torch.utils import transfer_ledger as ttl
from lighthouse_tpu_torch.verification_service import VerificationScheduler
from lighthouse_tpu_torch.verification_service import admission
from lighthouse_tpu_torch.verification_service.planner import FlushPlanner

from test_torch_bls import seeded_words
from test_torch_key_table import _caches, _signed_sets, _table

LONG_MS = 600_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stage_counts() -> dict:
    return {stage: child.snapshot()[0]
            for (stage, _impl), child in dbls._STAGE_SECONDS.children().items()}


def _h2d_total() -> float:
    return sum(c.value for c in ttl._H2D_BYTES.children().values())


def _hook_spy(mp):
    """Count telemetry calls made inside and outside a captured body."""
    inside = threading.local()
    calls = {"inside": [], "outside": 0}
    orig_call = graphs.CapturedProgram.__call__

    def call(self, *args, **kw):
        inside.on = True
        try:
            return orig_call(self, *args, **kw)
        finally:
            inside.on = False

    mp.setattr(graphs.CapturedProgram, "__call__", call)

    def spy(owner, name):
        orig = getattr(owner, name)

        def wrapped(*args, **kw):
            if getattr(inside, "on", False):
                calls["inside"].append(name)
            else:
                calls["outside"] += 1
            return orig(*args, **kw)

        mp.setattr(owner, name, wrapped)

    for name in ("note_stage_wall", "note_pack_wall", "note_compile_wall",
                 "note_fallback_wall", "note_plan_wall"):
        spy(tpp, name)
    for name in ("note_pack", "commit_verify", "note_op_bytes", "observe_pack_phases",
                 "record_cpu"):
        spy(ttl, name)
    for name in ("note_resolution", "note_h2d_bytes", "note_bubble", "note_fresh_compile",
                 "note_committee_sighting"):
        spy(tsl, name)
    spy(tfr, "record")
    spy(ttracing, "span")
    for cls, name in ((tmetrics.Histogram, "observe"), (tmetrics.Counter, "inc"),
                      (tmetrics.Gauge, "set")):
        spy(cls, name)
    return calls


@pytest.fixture(scope="module")
def verified():
    """The three verifies, each with the telemetry read around it."""
    prev = tfr.configure(enabled=True, capacity=4096)
    prev_tl = ttl.configure(enabled=True)
    tfr.clear()
    tfi.clear()
    sks, jcache, pcache = _caches(2, seed=300)
    _jsets, psets = _signed_sets(sks, jcache, pcache)
    backend = dbls.CudaBackend(device="cpu", rand_words=seeded_words(5))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        calls = _hook_spy(mp)
        for name in ("raw", "gathered", "raises"):
            table = _table(pcache, agg_min_repeats=1) if name == "gathered" else None
            if table is not None:
                kt.set_table(table)
            if name == "raises":
                tfi.arm("staged_dispatch", nth=2)  # stage 2 of the next verify
            stages0, h2d0 = _stage_counts(), _h2d_total()
            seq0 = tfr.status()["recorded_total"]
            try:
                verdict = backend.verify_signature_sets(psets)
            except tfi.InjectedFault:
                verdict = "raised"
            finally:
                kt.clear_table(table)
                tfi.clear()
            events = [e for e in tfr.events() if e["seq"] >= seq0]
            stages1 = _stage_counts()
            out[name] = {
                "verdict": verdict,
                "last_batch": dict(backend.last_batch),
                "stages": {s: stages1[s] - stages0.get(s, 0) for s in stages1
                           if stages1[s] != stages0.get(s, 0)},
                "h2d": _h2d_total() - h2d0,
                "stage_verify": [e["fields"] for e in events
                                 if e["kind"] == "bls_stage_verify"],
                "ledger": [e["fields"] for e in events if e["kind"] == "transfer_ledger"],
            }
        out["calls"] = {"inside": list(calls["inside"]), "outside": calls["outside"]}
    ttl.configure(**prev_tl)
    tfr.configure(**prev)
    return out


def test_stage_histogram_counts_the_stages_dispatched(verified):
    assert verified["raw"]["stages"] == {"stage1": 1, "stage2": 1, "stage3": 1}
    assert verified["gathered"]["stages"] == {"gather": 1, "stage1": 1, "stage2": 1,
                                              "stage3": 1}
    # the raise: stage 1 dispatched, stage 2 raised before its dispatch
    assert verified["raises"]["stages"] == {"stage1": 1}


def test_ledger_bytes_equal_last_batch_and_one_row_each(verified):
    for name, path in (("raw", "raw_staged"), ("gathered", "raw_gather")):
        v = verified[name]
        lb = v["last_batch"]
        assert v["verdict"] is True and lb["path"] == path
        assert v["h2d"] == lb["h2d_bytes"] > 0
        assert len(v["stage_verify"]) == 1 and len(v["ledger"]) == 1
        row, ev = v["ledger"][0], v["stage_verify"][0]
        assert row["h2d_bytes_total"] == lb["h2d_bytes"]
        assert row["pubkeys_bytes"] + row["padding_bytes"] + row["signatures_bytes"] \
            + row["messages_bytes"] + row["aux_bytes"] == lb["h2d_bytes"]
        assert row["verdict"] is True and row["indexed"] == (name == "gathered")
        assert row["kind"] == row["path"] == "direct" and row["d2h_bytes"] == 1
        assert (ev["b"], ev["k"], ev["m"]) == tuple(lb["rung"]) and ev["verdict"] is True
        assert ev.get("gathered", False) == (name == "gathered")
    assert verified["gathered"]["last_batch"]["collapsed"] == 1
    # the pubkey plane: 5 bytes a gathered slot, 257 a raw one
    assert verified["raw"]["ledger"][0]["pubkeys_bytes"] == 3 * (2 * 32 * 4 + 1)
    raises = verified["raises"]
    assert raises["verdict"] == "raised" and not raises["stage_verify"]
    assert len(raises["ledger"]) == 1 and raises["ledger"][0]["verdict"] is None
    assert raises["ledger"][0]["d2h_bytes"] == 0 and raises["h2d"] > 0


def test_no_telemetry_call_inside_a_captured_body(verified):
    assert verified["calls"]["inside"] == []
    assert verified["calls"]["outside"] > 50


# ---------------------------------------------------------------------------
# The scheduler's hooks
# ---------------------------------------------------------------------------


def _sets(tag: bytes, n: int):
    return [(None, [None], tag + i.to_bytes(4, "big")) for i in range(n)]


def _stub(seen):
    """A verifier that dispatches one stage on the calling shard (as a
    device verify would) and fails any set tagged ``poison``."""
    lock = threading.Lock()

    def verify(sets):
        with lock:
            seen.append((threading.current_thread().name, ttl.current_context(),
                         tpp.current_flush() is not None))
        dbls._run_stage("stub", lambda x: x + 1, torch.zeros(1))
        return not any(msg.startswith(b"poison") for _sig, _pks, msg in sets)

    return verify


def _pass(sched, subs):
    futs = [sched.submit(sets, kind) for kind, sets in subs]
    sched.flush()
    return [f.result(timeout=60) for f in futs]


@pytest.fixture(scope="module")
def served():
    prev = tfr.configure(enabled=True, capacity=4096)
    tfr.clear()
    tpp.reset()
    tts.reset()
    mesh = tmesh.DeviceMesh(devices=["cpu", "cpu"])
    tmesh.set_mesh(mesh)
    seen = []
    out = {}
    try:
        sched = VerificationScheduler(
            verify_fn=_stub(seen), deadline_ms=LONG_MS, watchdog_s=30.0,
            flush_planner=FlushPlanner(dp_min_sets=2)).start()
        try:
            out["mesh_verdicts"] = []
            for _ in range(3):
                out["mesh_verdicts"] += _pass(sched, [
                    ("unaggregated", _sets(b"u", 4)), ("aggregate", _sets(b"a", 4)),
                    ("unaggregated", _sets(b"poison", 1)), ("unaggregated", _sets(b"v", 3))])
                time.sleep(0.01)  # an empty-queue wait between flushes
        finally:
            sched.stop()
        out["mesh_status"] = mesh.status()
        out["exact"] = {i: (sum(st.causes.values()), st.idle_s)
                        for i, st in tpp._shards.items()}
        out["pp"] = tpp.summary()
    finally:
        tmesh.clear_mesh(mesh)
    out["seen"] = list(seen)
    # the estimator's first pass: the arrival counters' baseline
    t_sample = time.time()
    tts.sample(now=t_sample)

    def fallback(sets):  # the CPU verifier: no device dispatch
        return not any(msg.startswith(b"poison") for _sig, _pks, msg in sets)

    svc = tcs.CompileService(rungs=[(1, 1, 1)], compile_rung_fn=lambda b, k, m: {},
                             device="cpu", fallback_verify_fn=fallback)
    svc.start()
    svc.wait_idle(timeout=30)
    try:
        sched = VerificationScheduler(verify_fn=_stub(seen), deadline_ms=LONG_MS,
                                      compile_service=svc).start()
        try:
            out["shed_verdicts"] = _pass(sched, [("aggregate", _sets(b"s", 6)),
                                                 ("aggregate", _sets(b"poison", 1))])
        finally:
            sched.stop()
    finally:
        svc.stop()
    out["shed_status"] = svc.status()
    out["flushes"] = tfr.events(["scheduler_flush"])
    out["pipeline"] = [e["fields"] for e in tfr.events(["pipeline_flush"])]
    out["ledger_cpu"] = [e["fields"] for e in tfr.events(["transfer_ledger"])]
    out["bisections"] = tfr.events(["scheduler_bisection"])
    out["estimate"] = tts.sample(now=t_sample + 10.0)
    out["headroom"] = admission._live_headroom()
    tfr.configure(**prev)
    return out


def test_one_pipeline_flush_per_flush(served):
    assert served["mesh_verdicts"] == [True, True, False, True] * 3
    assert served["shed_verdicts"] == [True, False]
    assert served["bisections"], "the poisoned set bisects"
    assert served["shed_status"]["fallback"]["calls"] >= 2
    assert len(served["pipeline"]) == len(served["flushes"]) == 4
    mesh_rows, shed_rows = served["pipeline"][:3], served["pipeline"][3:]
    for row in mesh_rows:
        # the device phase came from the shard workers' watchdog threads
        assert row["device_s"] > 0 and row["plan_s"] > 0 and row["verdict"] is False
        assert row["dp_shards"] == "[0, 1]"  # the journal keeps lists as text
    assert shed_rows[0]["fallback_s"] > 0 and shed_rows[0]["device_s"] == 0
    # the shed flush's CPU resolutions each left a zero-byte ledger row
    cpu_rows = [r for r in served["ledger_cpu"] if r["h2d_bytes_total"] == 0]
    assert len(cpu_rows) == served["shed_status"]["fallback"]["calls"]
    assert {r["kind"] for r in cpu_rows} == {"aggregate"}
    assert {r["path"] for r in cpu_rows} == {"fallback", "bisection"}


def test_scopes_reach_shard_workers_and_the_watchdog_thread(served):
    mesh_calls = [s for s in served["seen"] if s[0].startswith("dispatch-wd-")]
    assert len(mesh_calls) >= 6
    for _thread, (kind, path), in_flush in mesh_calls:
        assert kind in ("unaggregated", "aggregate") and kind != "direct"
        assert path in ("sub_batch", "bisection", "fused") and in_flush


def test_bubbles_sum_to_idle_and_the_mesh_reads_its_ratio(served):
    assert set(served["exact"]) == {0, 1}
    for causes, idle in served["exact"].values():
        assert idle > 0 and causes == pytest.approx(idle, rel=1e-12, abs=1e-12)
    shards = served["pp"]["shards"]
    assert "queue_empty" in {c for s in shards.values() for c in s["causes"]}
    chips = served["mesh_status"]["chips"]
    assert [c["bubble_ratio"] for c in chips] == [shards["0"]["bubble_ratio"],
                                                 shards["1"]["bubble_ratio"]]
    assert all(0 < c["bubble_ratio"] < 1 for c in chips)


def test_admission_reads_the_estimators_headroom(served):
    est = served["estimate"]
    assert est["cost_source"] is not None and est["arrival_sets_per_sec"] > 0
    assert served["headroom"] is not None
    assert served["headroom"] == est["headroom_ratio"]


def test_a_gap_beside_a_warm_up_attributes_to_compile():
    """A compile-service warm-up (``bls.warming()``, as ``lowering`` runs
    every rung's) is ``compile`` activity from its start: a traffic gap
    that closes while it still runs attributes to ``compile``, and its
    own dispatches add no busy time."""
    tpp.reset()
    started, release = threading.Event(), threading.Event()

    def worker():
        with dbls.warming():
            dbls._run_stage("stub", lambda x: x + 1, torch.zeros(2))
            started.set()
            release.wait(10)

    dbls._run_stage("stub", lambda x: x + 1, torch.zeros(1))
    t = threading.Thread(target=worker)
    t.start()
    started.wait(10)
    time.sleep(0.02)
    dbls._run_stage("stub", lambda x: x + 1, torch.zeros(1))  # the gap closes mid-capture
    release.set()
    t.join()
    shard = tpp.summary()["shards"]["0"]
    assert shard["dispatches"] == 2 and shard["gaps"] == 1
    assert shard["dominant_cause"] == "compile"
    assert shard["causes"]["compile"] >= 0.02
