"""The port's verification scheduler against the JAX package's.

Both schedulers get the same submissions and one shared stub verifier (a
set is bad when its message carries ``BAD``; ``BOOM`` raises in a fused
batch of more than one set, ``RAISE`` raises always). Every flush is
triggered by hand (``flush()``) under a deadline of minutes, so no case
waits on a timer. Compared with exact equality: each future's verdict or
exception, the batch sizes the stub saw, the bisection count,
``last_plan``, the path counts of ``status()`` and the SLO window's
per-path counts. One end-to-end case runs the port's scheduler on
``CudaBackend(device="cpu")`` against the JAX scheduler on ``cpu-native``.

The two packages' metrics registries and flight recorders are
process-global; each case clears both recorders first.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import pytest
import torch

from lighthouse_tpu.utils import flight_recorder as jfr
from lighthouse_tpu.utils import metrics as jmetrics
from lighthouse_tpu.verification_service import (
    BulkAdmissionController as JaxAdmission,
    VerificationScheduler as JaxScheduler,
)
from lighthouse_tpu.verification_service import planner as jplanner
from lighthouse_tpu_torch.utils import flight_recorder as tfr
from lighthouse_tpu_torch.utils import metrics as tmetrics
from lighthouse_tpu_torch.verification_service import (
    BulkAdmissionController as TorchAdmission,
    VerificationScheduler as TorchScheduler,
)
from lighthouse_tpu_torch.verification_service import planner as tplanner

PACKAGES = {
    "jax": (JaxScheduler, JaxAdmission, jplanner),
    "torch": (TorchScheduler, TorchAdmission, tplanner),
}
LONG_MS = 600_000.0  # no deadline trigger fires while a case runs


@pytest.fixture(autouse=True)
def _clean_recorders():
    jfr.clear()
    tfr.clear()
    yield
    jfr.clear()
    tfr.clear()


def _set(msg: bytes, k: int = 1):
    """A geometry-only ``(sig, pks, msg)`` triple: what the planner and
    the stub read."""
    return (None, [None] * k, msg)


class Stub:
    """The shared verifier: records each call's set count; an empty call
    is False, as ``verify_signature_sets([])`` is."""

    def __init__(self):
        self.calls = []

    def __call__(self, sets):
        sets = list(sets)
        self.calls.append(len(sets))
        msgs = [s[2] for s in sets]
        if any(b"RAISE" in m for m in msgs):
            raise RuntimeError("verifier raised")
        if len(sets) > 1 and any(b"BOOM" in m for m in msgs):
            raise RuntimeError("only the fused shape fails")
        return bool(sets) and not any(b"BAD" in m for m in msgs)


def _outcome(fut):
    exc = fut.exception(timeout=30)
    return fut.result() if exc is None else f"{type(exc).__name__}: {exc}"


def _summary(sched, stub, futs, extra=None):
    st = sched.status()
    slo = sched.slo_summary()
    return {
        "verdicts": [_outcome(f) for f in futs],
        "calls": stub.calls,
        "bisections": st["bisections_total"],
        "last_plan": st["planner"]["last_plan"],
        "counts": {k: st[k] for k in ("fused_batches_total", "shed_total",
                                      "buckets_seen", "queue_sets")},
        "plans": {k: st["planner"][k] for k in ("plans_planned_total",
                                                "plans_single_total")},
        "bulk": {k: st["bulk"][k] for k in ("queue_sets", "flushes_total",
                                            "sets_flushed_total", "shed_total")},
        "slo_paths": {kind: {p: v["count"] for p, v in doc["paths"].items()}
                      for kind, doc in slo["kinds"].items()},
        **(extra or {}),
    }


def _run(pkg: str, scenario, **kw):
    sched_cls, adm_cls, _planner = PACKAGES[pkg]
    stub = Stub()
    kw.setdefault("deadline_ms", LONG_MS)
    kw.setdefault("max_batch_sets", 256)
    kw.setdefault("max_queue_sets", 1024)
    if "admission" in kw:
        kw["bulk_admission"] = adm_cls(**kw.pop("admission"))
    sched = sched_cls(verify_fn=stub, **kw).start()
    try:
        futs, extra = scenario(sched)
        for f in futs:
            f.exception(timeout=30)
    finally:
        sched.stop()
    return _summary(sched, stub, futs, extra)


def _parity(scenario, **kw):
    got = {pkg: _run(pkg, scenario, **dict(kw)) for pkg in PACKAGES}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_fused_flush_and_bisection_match_jax():
    def scenario(s):
        futs = [s.submit([_set(b"att%d" % (i % 3))], "unaggregated") for i in range(5)]
        futs.append(s.submit([_set(b"BAD agg", 8)], "aggregate"))
        futs += [s.submit([_set(b"sync", 1), _set(b"sync", 1)], "sync_message")
                 for _ in range(2)]
        futs.append(s.submit([_set(b"agg%d" % i, 8) for i in range(3)], "aggregate"))
        s.flush()
        return futs, None

    got = _parity(scenario)
    assert got["verdicts"] == [True] * 5 + [False, True, True, True]
    assert got["bisections"] >= 1


def test_empty_submission_and_verify_now_match_jax():
    def scenario(s):
        futs = [s.submit([], "unaggregated")]
        extra = {"now": [s.verify_now([_set(b"blk", 2), _set(b"rnd")], "block"),
                         s.verify_now([_set(b"blk"), _set(b"BAD blk")], "block"),
                         s.verify_now([], "block")]}
        return futs, extra

    got = _parity(scenario)
    assert got["verdicts"] == [False] and got["now"] == [True, False, False]
    assert got["slo_paths"]["block"] == {"bypass": 3}


def test_backpressure_shed_matches_jax():
    def scenario(s):
        first = s.submit([_set(b"a"), _set(b"b")], "unaggregated")  # queued
        shed = s.submit([_set(b"c")], "sync_message")   # 2 + 1 > 2: shed now
        shed_bad = s.submit([_set(b"BAD")], "aggregate")
        done_before_flush = [shed.done(), shed_bad.done(), first.done()]
        s.flush()
        return [first, shed, shed_bad], {"done_before_flush": done_before_flush}

    got = _parity(scenario, max_queue_sets=2)
    assert got["done_before_flush"] == [True, True, False]
    assert got["verdicts"] == [True, True, False]
    assert got["counts"]["shed_total"] == 2 and got["calls"][:2] == [1, 1]


def test_raise_inside_a_fused_batch_matches_jax():
    def scenario(s):
        futs = [s.submit([_set(b"ok1")], "unaggregated"),
                s.submit([_set(b"BOOM")], "unaggregated"),
                s.submit([_set(b"RAISE")], "unaggregated"),
                s.submit([_set(b"ok2"), _set(b"ok3")], "sync_message")]
        s.flush()
        return futs, None

    got = _parity(scenario)
    assert got["verdicts"] == [True, True, "RuntimeError: verifier raised", True]
    # the unaggregated bin [ok1, BOOM] raised fused and was bisected; the
    # RAISE leaf's exception reached its own future only
    assert got["bisections"] == 1 and got["slo_paths"]["unaggregated"]["bisection"] == 2


def test_bulk_paused_and_resumed_by_the_headroom_feed_match_jax():
    def make(feed):
        def scenario(s):
            bulk = s.submit([_set(b"bf1"), _set(b"bf2")], "backfill", qos="bulk")
            gossip = s.submit([_set(b"g")], "unaggregated")
            s.flush()
            gossip.result(timeout=30)
            paused = {"bulk_done": bulk.done(), **{k: s.status()["bulk"]["admission"][k]
                                                   for k in ("throttled", "reason")}}
            feed["h"] = 0.5
            s.flush()  # wakes the loop: admission re-read, then the bulk chunk
            bulk.result(timeout=30)
            adm = s.status()["bulk"]["admission"]
            return [gossip, bulk], {"paused": paused, "resumed": {
                k: adm[k] for k in ("throttled", "excursions_total", "last_headroom")}}
        return scenario

    got = {}
    for pkg in PACKAGES:
        feed = {"h": 0.05}
        got[pkg] = _run(pkg, make(feed), bulk_flush_sets=2, bulk_linger_ms=LONG_MS,
                        admission=dict(headroom_fn=lambda f=feed: f["h"],
                                       min_interval_s=0.0))
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["paused"] == {"bulk_done": False, "throttled": True, "reason": "headroom"}
    assert t["resumed"] == {"throttled": False, "excursions_total": 1, "last_headroom": 0.5}
    assert t["calls"] == [1, 2] and t["bulk"]["flushes_total"] == 1
    assert t["slo_paths"]["backfill"] == {"bulk": 1}


class StubService:
    """A compile service that answers by geometry: K >= 8 sheds, B >= 4
    pads to (8, 1, 8), anything else is warm. The fallback is the stub."""

    def __init__(self, stub):
        self.stub = stub
        self.decisions = []
        self.fallback_calls = []

    def active(self):
        return True

    def warm_rungs_active(self, device=0):
        return [(2, 1, 2), (8, 1, 8)]

    def decide_flush(self, sets, caller="flush", geometry=None, device_index=0):
        n, k, m = geometry if geometry is not None else tplanner.flush_geometry(sets)
        exact = (tplanner.round_up_bucket(n), tplanner.round_up_bucket(k),
                 tplanner.round_up_bucket(m))
        if k >= 8:
            action, rung = "shed", None
        elif n >= 4:
            action, rung = "padded", (8, 1, 8)
        else:
            action, rung = "warm", exact
        self.decisions.append([re.sub(r":.*", "", caller), [n, k, m], action])
        return {"action": action, "rung": rung, "exact": exact, "fp_impl": "stub",
                "device": device_index}

    def fallback_verify(self, sets):
        self.fallback_calls.append(len(sets))
        return self.stub(sets)


def test_routing_against_a_stub_compile_service_matches_jax():
    got = {}
    for pkg in PACKAGES:
        sched_cls = PACKAGES[pkg][0]
        stub = Stub()
        svc = StubService(stub)
        sched = sched_cls(verify_fn=stub, deadline_ms=LONG_MS, max_batch_sets=256,
                          max_queue_sets=1024, compile_service=svc).start()
        try:
            futs = [sched.submit([_set(b"u%d" % i)], "unaggregated") for i in range(5)]
            futs.append(sched.submit([_set(b"agg", 8)], "aggregate"))
            futs.append(sched.submit([_set(b"BAD agg", 8)], "aggregate"))
            futs.append(sched.submit([_set(b"s")], "sync_message"))
            sched.flush()
            for f in futs:
                f.exception(timeout=30)
            now = [sched.verify_now([_set(b"blk", 8)], "block"),
                   sched.verify_now([_set(b"blk"), _set(b"rnd")], "block")]
        finally:
            sched.stop()
        got[pkg] = _summary(sched, stub, futs, {
            "now": now, "decisions": svc.decisions, "fallback": svc.fallback_calls})
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["verdicts"] == [True] * 6 + [False, True] and t["now"] == [True, True]
    assert {a for _c, _g, a in t["decisions"]} == {"warm", "padded", "shed"}
    assert t["fallback"] and t["slo_paths"]["block"] == {"bypass": 1, "fallback": 1}


def _registered_families(pkg_root: Path) -> set:
    names = set()
    for mod in ("verification_service/batcher.py", "verification_service/slo.py",
                "verification_service/admission.py", "utils/pipeline_profiler.py"):
        names |= set(re.findall(r'metrics\.\w+\(\s*"(verification_scheduler_\w+)"',
                                (pkg_root / mod).read_text()))
    return names


def test_metric_families_match_jax():
    import lighthouse_tpu
    import lighthouse_tpu_torch
    import lighthouse_tpu_torch.compile_service  # noqa: F401  (the fallback's family)

    jax_names = _registered_families(Path(lighthouse_tpu.__file__).parent)
    torch_names = {n for n in tmetrics.registry_snapshot()
                   if n.startswith("verification_scheduler_")}
    assert len(jax_names) >= 25 and torch_names == jax_names
    assert {"verification_scheduler_dp_shards",
            "verification_scheduler_watchdog_reaped_total"} <= torch_names
    assert {n for n in jmetrics.registry_snapshot()} >= jax_names
    assert "compile_service_fallback_verify_seconds" in tmetrics.registry_snapshot()
    for name in jax_names:
        assert type(tmetrics.get(name)).__name__ == type(jmetrics.get(name)).__name__
    assert _registered_families(Path(lighthouse_tpu_torch.__file__).parent) == jax_names


def test_end_to_end_verdicts_on_the_cpu_backend_match_cpu_native():
    """Two submissions, one signed over the wrong message: the port's
    scheduler on ``CudaBackend(device="cpu")`` (the fused batch, then its
    two bisected halves) gives the JAX scheduler's verdicts on
    ``cpu-native``."""
    from lighthouse_tpu.crypto import backend as jbackend
    from lighthouse_tpu.crypto import bls as jbls
    from lighthouse_tpu_torch.crypto import bls as tbls
    from lighthouse_tpu_torch.crypto import native

    raw = []
    for sk, msg, signed in ((5, b"\x21" * 32, b"\x21" * 32),
                            (6, b"\x22" * 32, b"\x23" * 32)):
        pk = tbls.SecretKey(sk).public_key()
        raw.append((pk.serialize(), native.native_sign(sk, signed), msg))

    def sets_of(bls_mod):
        return [[bls_mod.SignatureSet(bls_mod.Signature.deserialize(sig),
                                      [bls_mod.PublicKey.deserialize(pk)], msg)]
                for pk, sig, msg in raw]

    def run(sched):
        sched.start()
        try:
            futs = [sched.submit(s, "unaggregated") for s in subs]
            sched.flush()
            return [f.result(timeout=300) for f in futs], sched.status()["bisections_total"]
        finally:
            sched.stop()

    prev = jbackend.active().name
    jbackend.set_backend("cpu-native")
    try:
        subs = sets_of(jbls)
        want = run(JaxScheduler(deadline_ms=LONG_MS))
    finally:
        jbackend.set_backend(prev)
    subs = sets_of(tbls)
    # one intra-op thread: a CPU verify's tensors are small, so more
    # threads take the same wall and several times the CPU time spinning,
    # which slows every other test process on the box
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = run(TorchScheduler(
            verify_fn=functools.partial(tbls.verify_signature_sets, device="cpu"),
            deadline_ms=LONG_MS))
    finally:
        torch.set_num_threads(threads)
    assert got == want == ([True, False], 1)
