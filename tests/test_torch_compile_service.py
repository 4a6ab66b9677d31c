"""The port's compile service and bucket helpers against the JAX package's.

* Registry and routing: the port's ``WarmShapeRegistry``/``CompileService``
  and ``lighthouse_tpu.compile_service.service``'s (jax-free at import; its
  engine name is set to the port's) go through the same seeded sequence of
  ``mark_ready``, ``invalidate``, ``route``, ``pads_for`` and
  ``decide_flush`` calls and must give identical decisions.
* Geometry: ``flush_geometry``, ``round_up_bucket`` and
  ``best_covering_rung`` equal the JAX package's on triples and on
  ``SignatureSet`` objects.
* The worker, with an injected ``compile_rung_fn`` (nothing is captured):
  it walks the plan in priority order, ``request`` jumps the queue, a
  failing rung is retried with backoff without killing the worker, and
  ``invalidate`` re-queues the rung in flight. These mirror
  ``tests/test_compile_service.py``.
"""

import random
import threading
import time

import pytest

from lighthouse_tpu.compile_service import service as jsvc
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.verification_service import planner as jplanner
from lighthouse_tpu.verification_service import round_up_bucket as jround_up
from lighthouse_tpu_torch.compile_service import service as psvc
from lighthouse_tpu_torch.crypto import bls as pbls
from lighthouse_tpu_torch.crypto.device import bls as dbls
from lighthouse_tpu_torch.verification_service import planner as pplanner

IMPL = psvc.CompileService._impl()  # the port's active fp.mul engine
STAGES = ("stage1", "stage2", "stage3")


class _JaxService(jsvc.CompileService):
    """The JAX service with the port's engine name (its own reads the JAX
    package's active engine, whose default differs from the port's)."""

    @staticmethod
    def _impl():
        return IMPL


def _stages():
    return {s: {"seconds": 0.01, "fresh": True} for s in STAGES}


def _wait(predicate, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    pytest.fail(f"timed out waiting for {msg}")


def _blocked():
    """A compile runner that blocks until its gate opens, so that a started
    service stays cold (its registry changes only through the test)."""
    gate = threading.Event()

    def run(b, k, m):
        assert gate.wait(timeout=30)
        return _stages()

    return run, gate


# ---------------------------------------------------------------------------
# Registry and routing parity
# ---------------------------------------------------------------------------

LADDER_RUNGS = [(b, k, m) for b in (1, 4, 8, 48, 64, 192) for k in (1, 2, 16)
                for m in (1, 8, 192)]


def _ops(seed: int, n: int = 400):
    rng = random.Random(seed)
    for _ in range(n):
        op = rng.choices(["mark", "mark_stale", "invalidate", "route", "pads",
                          "decide"], weights=[6, 1, 1, 6, 4, 4])[0]
        if op in ("mark", "mark_stale"):
            yield op, rng.choice(LADDER_RUNGS)
        elif op == "invalidate":
            yield op, None
        elif rng.random() < 0.3:  # a rung's own shape: warm when marked
            yield op, rng.choice(LADDER_RUNGS)
        else:
            yield op, (rng.randint(1, 256), rng.randint(1, 24), rng.randint(1, 200))


@pytest.mark.parametrize("registered", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_registry_and_routing_match_jax(seed, registered):
    """Identical decisions over one seeded sequence; with the services
    registered as their packages' globals, ``padded`` flushes stay padded,
    otherwise both downgrade them to ``shed``."""
    prun, pgate = _blocked()
    jrun, jgate = _blocked()
    port = psvc.CompileService(rungs=((1, 1, 1),), compile_rung_fn=prun, device="cpu")
    jax_ = _JaxService(rungs=((1, 1, 1),), compile_rung_fn=jrun)
    port.start()
    jax_.start()
    if registered:
        psvc.set_service(port)
        jsvc.set_service(jax_)
    actions = set()
    try:
        for op, arg in _ops(seed):
            if op == "mark":
                got = [s.registry.mark_ready(arg, IMPL, epoch=s.registry.epoch)
                       for s in (port, jax_)]
            elif op == "mark_stale":
                got = [s.registry.mark_ready(arg, IMPL, epoch=s.registry.epoch - 1)
                       for s in (port, jax_)]
            elif op == "invalidate":
                for s in (port, jax_):
                    s.registry.invalidate()
                got = [s.registry.epoch for s in (port, jax_)]
            elif op == "route":
                got = [s.route(*arg) for s in (port, jax_)]
                actions.add(got[0]["action"])
            elif op == "pads":
                got = [s.pads_for(*arg) for s in (port, jax_)]
            else:
                got = [s.decide_flush(None, geometry=arg) for s in (port, jax_)]
            assert got[0] == got[1], (op, arg, got)
            assert port.registry.warm_rungs() == jax_.registry.warm_rungs()
        assert port.status()["cold_routes"] == jax_.status()["cold_routes"]
        assert actions == {"warm", "padded", "shed"}
    finally:
        psvc.clear_service(port)
        jsvc.clear_service(jax_)
        pgate.set()
        jgate.set()
        port.stop()
        jax_.stop()


def test_decide_flush_queues_the_exact_rung_like_jax():
    """A cold flush queues its exact rung at the front, in both."""
    prun, pgate = _blocked()
    jrun, jgate = _blocked()
    plan = ((1, 1, 1), (2, 1, 1), (4, 1, 1))
    port = psvc.CompileService(rungs=plan, compile_rung_fn=prun, device="cpu").start()
    jax_ = _JaxService(rungs=plan, compile_rung_fn=jrun).start()
    try:
        for s in (port, jax_):
            _wait(lambda s=s: s.status()["in_flight"] == [1, 1, 1], msg="in flight")
        sets = [("sig", ["pk"] * 3, b"m1"), ("sig", ["pk"], b"m2")] * 3
        dp, dj = port.decide_flush(sets), jax_.decide_flush(sets)
        assert dp == dj and dp["action"] == "shed" and dp["exact"] == (8, 4, 2)
        assert port.status()["queue"] == jax_.status()["queue"] == [
            [8, 4, 2], [2, 1, 1], [4, 1, 1]]
    finally:
        pgate.set()
        jgate.set()
        port.stop()
        jax_.stop()


# ---------------------------------------------------------------------------
# Geometry parity
# ---------------------------------------------------------------------------

def test_round_up_and_covering_rung_match_jax():
    for n in list(range(0, 300)) + [511, 512, 513, 1023, 1024, 1025, 5000]:
        assert pplanner.round_up_bucket(n) == jround_up(n), n
    assert pplanner.BUCKET_LADDER == jplanner.BUCKET_LADDER
    rng = random.Random(3)
    for _ in range(300):
        warm = rng.sample(LADDER_RUNGS, rng.randint(0, 12))
        req = (rng.randint(1, 200), rng.randint(1, 20), rng.randint(1, 200))
        assert pplanner.best_covering_rung(warm, *req) == \
            jplanner.best_covering_rung(warm, *req)
    assert psvc.DEFAULT_RUNGS == jsvc.DEFAULT_RUNGS
    assert psvc.MSM_RUNGS == jsvc.MSM_RUNGS


def test_flush_geometry_matches_jax_on_triples_and_signature_sets():
    jsk = jbls.SecretKey(7)
    jpk = jbls.PublicKey.deserialize(jsk.public_key().serialize())
    m1, m2 = b"\x01" * 32, b"\x02" * 32
    jsig = jbls.Signature.deserialize(jsk.sign(m1).serialize())
    psk = pbls.SecretKey(7)
    ppk = pbls.PublicKey.deserialize(psk.public_key().serialize())
    psig = pbls.Signature.deserialize(psk.sign(m1).serialize())

    def sets(b, sig, pk):
        return [
            b.SignatureSet.single_pubkey(sig, pk, m1),
            b.SignatureSet.multiple_pubkeys(sig, [pk, pk, pk], m2),
            b.SignatureSet.single_pubkey(sig, pk, m1),
        ]

    want = jplanner.flush_geometry(sets(jbls, jsig, jpk))
    assert pplanner.flush_geometry(sets(pbls, psig, ppk)) == want == (3, 3, 2)
    triples = [(psig, [ppk, ppk], m1), (psig, [ppk], m2), ("x", [ppk], bytearray(m1))]
    assert pplanner.flush_geometry(triples) == jplanner.flush_geometry(triples)
    odd = [object(), ("sig", None, None), ("sig", [1, 2], 7)]
    assert pplanner.flush_geometry(odd) == jplanner.flush_geometry(odd)
    for item in (*triples, *odd):
        assert pplanner.set_geometry(item) == jplanner.set_geometry(item)


def test_packers_pad_with_the_shared_ladder():
    """The packers' default padding is the ladder's: one copy."""
    assert not hasattr(dbls, "_round_up")
    assert dbls.round_up_bucket is pplanner.round_up_bucket


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def test_worker_walks_plan_in_priority_order():
    calls = []

    def run(b, k, m):
        calls.append((b, k, m))
        return _stages()

    plan = ((8, 2, 2), (4, 1, 1), (2, 1, 1))
    svc = psvc.CompileService(rungs=plan, compile_rung_fn=run, device="cpu").start()
    try:
        assert svc.wait_idle(timeout=10)
        assert tuple(calls) == plan
        st = svc.status()
        assert st["running"] and st["compiled_total"] == 3
        assert st["queue"] == [] and st["in_flight"] is None
        assert sorted(st["warm_rungs"]) == sorted([*r, IMPL] for r in plan)
        assert st["stages"]["8x2x2"] == _stages()
    finally:
        svc.stop()
    assert not svc.active()


def test_request_jumps_the_queue_and_a_failure_does_not_kill_the_worker():
    gate = threading.Event()
    order = []

    def run(b, k, m):
        if not order:
            assert gate.wait(timeout=10)
        order.append((b, k, m))
        if (b, k, m) == (4, 1, 1):
            raise RuntimeError("induced capture failure")
        return _stages()

    plan = ((2, 1, 1), (4, 1, 1), (64, 1, 1), (8, 1, 1))
    svc = psvc.CompileService(rungs=plan, compile_rung_fn=run, device="cpu")
    svc.retry_max_attempts = 1  # no retry: the failure stays counted
    svc.start()
    try:
        _wait(lambda: svc.status()["in_flight"] == [2, 1, 1], msg="first rung in flight")
        svc.request(16, 1, 1)
        svc.request(8, 1, 1)  # already queued last: promoted to the front
        assert svc.status()["queue"] == [[8, 1, 1], [16, 1, 1], [4, 1, 1], [64, 1, 1]]
        gate.set()
        assert svc.wait_idle(timeout=10)
        assert order == [(2, 1, 1), (8, 1, 1), (16, 1, 1), (4, 1, 1), (64, 1, 1)]
        st = svc.status()
        assert st["failed_total"] == 1 and st["compiled_total"] == 4
        assert "induced capture failure" in st["last_error"]
        assert [4, 1, 1, IMPL] not in st["warm_rungs"]
        assert [64, 1, 1, IMPL] in st["warm_rungs"] and svc.active()
    finally:
        svc.stop()


def test_failing_rung_is_retried_with_backoff():
    attempts = []

    def run(b, k, m):
        attempts.append((time.monotonic(), (b, k, m)))
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return _stages()

    svc = psvc.CompileService(rungs=((4, 1, 1),), compile_rung_fn=run, device="cpu")
    svc.retry_base_s = 0.05
    svc.retry_max_attempts = 5
    svc.start()
    try:
        assert svc.wait_idle(timeout=10)
        assert [r for _, r in attempts] == [(4, 1, 1)] * 3
        gaps = [b - a for (a, _), (b, _) in zip(attempts, attempts[1:])]
        # jittered exponential backoff: base * 2^(n-1) * [0.5, 1]
        assert gaps[0] >= 0.025 and gaps[1] >= 0.05
        st = svc.status()
        assert st["retry"]["retries_total"] == 2 and st["failed_total"] == 2
        assert svc.registry.is_warm((4, 1, 1), IMPL) and svc.active()
    finally:
        svc.stop()


def test_retry_budget_spent_leaves_the_rung_cold():
    calls = []

    def run(b, k, m):
        calls.append((b, k, m))
        raise RuntimeError("deterministic")

    svc = psvc.CompileService(rungs=((4, 1, 1), (2, 1, 1)), compile_rung_fn=run,
                              device="cpu")
    svc.retry_base_s = 0.01
    svc.retry_max_attempts = 2
    svc.start()
    try:
        assert svc.wait_idle(timeout=10)
        assert calls.count((4, 1, 1)) == 2 and calls.count((2, 1, 1)) == 2
        assert svc.registry.warm_rungs() == [] and svc.active()
    finally:
        svc.stop()


def test_invalidate_requeues_the_in_flight_rung():
    gate = threading.Event()
    calls = []

    def run(b, k, m):
        calls.append((b, k, m))
        if len(calls) == 1:
            assert gate.wait(timeout=10)
        return _stages()

    svc = psvc.CompileService(rungs=((2, 1, 1), (4, 1, 1)), compile_rung_fn=run,
                              device="cpu").start()
    try:
        _wait(lambda: svc.status()["in_flight"] == [2, 1, 1], msg="in flight")
        epoch = svc.registry.epoch
        svc.invalidate()
        assert svc.registry.epoch == epoch + 1
        gate.set()
        assert svc.wait_idle(timeout=10)
        # the in-flight mark was stale; the re-queued rung warmed again
        assert calls[0] == (2, 1, 1) and calls.count((2, 1, 1)) == 2
        assert svc.registry.is_warm((2, 1, 1), IMPL)
        assert svc.registry.is_warm((4, 1, 1), IMPL)
    finally:
        svc.stop()


def test_note_rung_verified_marks_warm_and_feeds_costs():
    svc = psvc.CompileService(rungs=((2, 1, 1),), compile_rung_fn=lambda *r: _stages(),
                              device="cpu")
    stale = svc.registry.epoch
    svc.registry.invalidate()
    svc.note_rung_verified(8, 1, 1, epoch=stale, seconds=1.0, n_sets=4)
    assert not svc.registry.is_warm((8, 1, 1), IMPL)  # stale epoch
    svc.note_rung_verified(8, 1, 1, epoch=svc.registry.epoch, seconds=2.0, n_sets=4)
    assert svc.route(5)["action"] == "warm"
    assert svc.route(3) == {"action": "padded", "rung": (8, 1, 1), "exact": (4, 1, 1),
                            "fp_impl": IMPL, "device": 0}
    costs = svc.measured_rung_costs()
    # the first dispatch (the captures' wall) is kept out of the aggregate
    assert costs["rungs"]["8x1x1@dev0"]["dispatches"] == 2
    assert costs["s_per_set"] == 0.5 and costs["sum_sets"] == 4


def test_env_rungs_and_msm_ladder_rides_the_first_rungs(monkeypatch):
    from lighthouse_tpu_torch.compile_service import lowering

    monkeypatch.setenv("LIGHTHOUSE_TPU_COMPILE_RUNGS", "4:2:2, 8:1:1")
    assert psvc.CompileService(device="cpu").plan == ((4, 2, 2), (8, 1, 1))
    monkeypatch.setenv("LIGHTHOUSE_TPU_COMPILE_RUNGS", "4:2")
    assert psvc.CompileService(device="cpu").plan == psvc.DEFAULT_RUNGS
    monkeypatch.delenv("LIGHTHOUSE_TPU_COMPILE_RUNGS")
    calls = []
    monkeypatch.setattr(lowering, "warm_staged",
                        lambda b, k, m, device, shard=None: _stages())
    monkeypatch.setattr(lowering, "warm_msm",
                        lambda n, device, shard=None: (calls.append(n), {"seconds": 0.0})[1])
    plan = ((2, 1, 1), (4, 1, 1), (8, 1, 1), (16, 1, 1), (32, 1, 1))
    svc = psvc.CompileService(rungs=plan, device="cpu")
    svc._stopped = False
    psvc.set_msm_warm_enabled(True)
    try:
        for rung in plan:
            svc._compile_rung(rung)
        assert calls == sorted(psvc.MSM_RUNGS)  # one per staged rung, smallest first
        assert svc.status()["msm_warm"] == sorted(psvc.MSM_RUNGS)
    finally:
        psvc.set_msm_warm_enabled(False)
