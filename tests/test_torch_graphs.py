"""The port's staged dispatch on the CPU: ``_run_stage``, the captured
programs' CPU path, the kernel counters a graph replay credits, and one
batch end to end through a compile service.

No graph exists on the CPU: a captured program runs its function eagerly
there, so these tests hold the dispatch logic (freshness, routing and
padding to a warm rung, verdicts). The stage programs are also run under
a dispatch mode that fails on any op that would make a CUDA capture
sync with the host (an ``.item()``, a ``nonzero``, a boolean index, a
tensor made from host data): what the card would refuse inside a graph.
The captures themselves are held against eager runs on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Verdicts are held against the JAX package's ``cpu-native`` backend (the C
verifier) on a valid and a poisoned batch: 2 verifies of about 8 s each
(the valid one about twice that under the dispatch mode), after the
rung's warm-up (one run of the three stages).
"""

import contextlib
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto.native import NativeBackend
from lighthouse_tpu_torch.compile_service import lowering
from lighthouse_tpu_torch.compile_service import service as psvc
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.cpu.curve import G1Point
from lighthouse_tpu_torch.crypto.cpu.fields import Fq
from lighthouse_tpu_torch.crypto.device import bls as dbls
from lighthouse_tpu_torch.crypto.device import graphs, kernels

RUNG = (4, 2, 2)
M1, M2 = b"\x41" * 32, b"\x42" * 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs
    several worker processes side by side."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_run_stage_freshness_and_seconds():
    label = "test_graphs_stage"
    inc = lambda a: a + 1  # noqa: E731
    out, sec, fresh = dbls._run_stage(label, inc, torch.zeros(3))
    assert fresh and torch.equal(out, torch.ones(3)) and sec >= 0
    assert dbls._run_stage(label, inc, torch.ones(3))[2] is False
    assert dbls._run_stage(label, inc, torch.zeros(4))[2] is True
    assert dbls._run_stage(label, inc, torch.zeros(4, dtype=torch.int32))[2] is True
    assert dbls._run_stage(label, inc, torch.zeros(4, dtype=torch.int32))[2] is False
    child = dbls._STAGE_SECONDS.with_labels(label, dbls.fp.get_impl())
    assert child.snapshot()[0] == 5 and child.snapshot()[1] >= 0


def test_captured_program_on_cpu_returns_what_fn_returns():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b, a * b

    prog = graphs.CapturedProgram(fn, "test_cpu_program")
    x, y = torch.arange(4), torch.arange(4) * 3
    got, want = prog(x, y), fn(x, y)
    assert len(got) == 2 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(calls) == 2
    single = graphs.CapturedProgram(lambda a: a * 2, "test_cpu_single")
    assert torch.equal(single(x), x * 2)
    # the CPU runs the function: no graph, nothing in the status
    assert prog.graph_for(x, y) is None
    assert "test_cpu_program" not in graphs.status()["programs"]
    with pytest.raises(TypeError):
        prog(x, 3)
    with pytest.raises(ValueError):
        prog(x, torch.zeros(4, device="meta"))


def test_kernel_counters_credit_a_replay():
    """A capture's counts go to its own sink, not the global counters, and
    are credited once per replay."""
    kernels.reset_launches()
    kernels._count("fp2_sq", 96)
    snap = kernels.snapshot()
    with kernels.counting_into() as delta:
        kernels._count("fp2_sq", 5)
        kernels._count("fp2_sq", 5)
        kernels._count("fp_mul_cols", 7)
    assert delta["fp2_sq"][:2] == (2, 10) and delta["fp2_mul"][:2] == (0, 0)
    assert kernels.launches == {"fp_mul_cols": 0, "fp2_mul": 0, "fp2_sq": 1}
    assert kernels.snapshot() == snap
    for _ in range(3):
        kernels.credit(delta)
    assert kernels.launches == {"fp_mul_cols": 3, "fp2_mul": 0, "fp2_sq": 7}
    assert kernels.lanes["fp2_sq"] == 96 + 30 and kernels.lanes["fp_mul_cols"] == 21
    assert dict(kernels.lane_hist["fp2_sq"]) == {96: 1, 5: 6}
    kernels.reset_launches()


def test_capture_sink_is_isolated_from_other_threads():
    """Two threads: one counts inside a capture sink while the other
    credits replays and counts its own launches. The sink holds only its
    own thread's launches and the globals only the other thread's, exact
    to the launch (the counters take a lock)."""
    import sys
    import threading

    kernels.reset_launches()
    credit = {"fp_mul_cols": (2, 384, Counter({192: 2})),
              "fp2_mul": (1, 96, Counter({96: 1})), "fp2_sq": (0, 0, Counter())}
    start = threading.Barrier(2)
    sinks = []

    def capturing():
        start.wait(timeout=30)
        with kernels.counting_into() as sink:
            for i in range(3000):
                kernels._count("fp2_sq", 1 + i % 3)
        sinks.append(sink)

    def traffic():
        start.wait(timeout=30)
        for _ in range(3000):
            kernels.credit(credit)
            kernels._count("fp_mul_cols", 7)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=f) for f in (capturing, traffic)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    (sink,) = sinks
    assert sink["fp2_sq"] == (3000, 6000, {1: 1000, 2: 1000, 3: 1000})
    assert sink["fp_mul_cols"][0] == 0 and sink["fp2_mul"][0] == 0
    assert kernels.launches == {"fp_mul_cols": 9000, "fp2_mul": 3000, "fp2_sq": 0}
    assert kernels.lanes == {"fp_mul_cols": 3000 * (384 + 7), "fp2_mul": 3000 * 96,
                             "fp2_sq": 0}
    assert dict(kernels.lane_hist["fp_mul_cols"]) == {192: 6000, 7: 3000}
    kernels.reset_launches()


def test_engine_triple_keys_the_graphs_and_the_seen_shapes():
    """A graph's key and ``_run_stage``'s seen-shape key name the active
    (fp, fp2, line) engines: a switched engine is a fresh key."""
    from lighthouse_tpu_torch.crypto.device import fp, fp2, pairing

    x = torch.zeros((2, 32), dtype=torch.int32)
    default = graphs.CapturedProgram.key((x,))
    assert default[1] == graphs.engines() == (fp.get_impl(), fp2.get_impl(),
                                              pairing.get_line_impl())
    assert graphs.engines() == ("pallas_int8", "fused_pallas", "fused")
    label, inc = "test_engine_key_stage", (lambda a: a + 1)
    assert dbls._run_stage(label, inc, x)[2] is True
    assert dbls._run_stage(label, inc, x)[2] is False
    for ctx, triple in ((fp.impl("toeplitz_int32"), ("toeplitz_int32", "fused_pallas", "fused")),
                        (fp2.impl("composed"), ("pallas_int8", "composed", "fused")),
                        (pairing.line_impl("composed"), ("pallas_int8", "fused_pallas",
                                                         "composed"))):
        with ctx:
            key = graphs.CapturedProgram.key((x,))
            assert key[1] == triple and key[0] == default[0] and key[2] == default[2]
            assert dbls._run_stage(label, inc, x)[2] is True
            assert dbls._run_stage(label, inc, x)[2] is False
    assert graphs.CapturedProgram.key((x,)) == default
    assert dbls._run_stage(label, inc, x)[2] is False


def test_reset_compiled_state_drops_graphs_seen_shapes_and_registry():
    from lighthouse_tpu_torch.crypto.device import reset_compiled_state

    prog = graphs.CapturedProgram(lambda a: a, "test_reset_program")
    x = torch.zeros(3)
    prog._graphs[prog.key((x,))] = graphs._Graph()  # as a capture leaves it
    label = "test_reset_stage"
    assert dbls._run_stage(label, lambda a: a, x)[2] is True
    assert dbls._run_stage(label, lambda a: a, x)[2] is False
    svc = psvc.CompileService(rungs=((4, 1, 1),), compile_rung_fn=lambda b, k, m: {},
                              device="cpu")
    impl = svc._impl()
    svc.registry.mark_ready((4, 1, 1), impl)
    epoch = svc.registry.epoch
    psvc.set_service(svc)
    try:
        reset_compiled_state()
    finally:
        psvc.clear_service(svc)
    assert prog._graphs == {}
    assert dbls._run_stage(label, lambda a: a, x)[2] is True
    assert not svc.registry.is_warm((4, 1, 1), impl) and svc.registry.epoch == epoch + 1


def test_service_engine_follows_fp_set_impl():
    """The registry's engine slot is the active fp.mul engine, as the JAX
    service's: a rung warm under one engine does not route warm under
    another."""
    from lighthouse_tpu_torch.crypto.device import fp

    svc = psvc.CompileService(rungs=((4, 1, 1),), compile_rung_fn=lambda b, k, m: {},
                              device="cpu")
    assert svc._impl() == fp.get_impl() == "pallas_int8"
    svc.registry.mark_ready((4, 1, 1), svc._impl())
    assert svc.route(3, 1, 1)["action"] == "warm"
    for name in ("toeplitz_int32", "matmul_int8"):
        with fp.impl(name):
            assert svc._impl() == name
            r = svc.route(3, 1, 1)
            assert r["action"] == "shed" and r["fp_impl"] == name
    assert svc.route(3, 1, 1) == {"action": "warm", "rung": (4, 1, 1),
                                  "exact": (4, 1, 1), "fp_impl": "pallas_int8",
                                  "device": 0}


def test_constant_cache_fills_once_under_threads():
    """Warm-ups fill the device caches from more than one thread: every
    thread must get the one tensor a key was filled with (a second fill
    would leave a graph reading a tensor the cache no longer holds)."""
    import sys
    import threading

    from lighthouse_tpu_torch.crypto.device import fp

    lin = fp.LinMap([[1, -2], [3, 0]])
    key = ("test_threads", 1)
    got, lins = [], []
    barrier = threading.Barrier(16)

    def work():
        barrier.wait(timeout=30)
        got.append(fp.on_device(key, "cpu", lambda: np.arange(4, dtype=np.int32)))
        lin(torch.zeros((1, 2, fp.NL), dtype=torch.int32))
        lins.append(lin._dev[torch.device("cpu")])

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 16 and all(t is got[0] for t in got)
    assert len(lins) == 16 and all(t is lins[0] for t in lins)


def test_staged_dummy_args_are_the_stage_signatures():
    """The warm-up's arguments have the shapes the raw packer gives a
    batch at the rung, so the warm rung is not fresh for traffic."""
    args = lowering.staged_dummy_args(*RUNG, device="cpu")
    sk = jbls.SecretKey(5)
    raw = sk.sign(M1).serialize()
    pk = sk.public_key().point
    sets = [(bls.Signature.deserialize(raw), [G1Point(Fq(pk.x.n), Fq(pk.y.n))], M1)]
    packed = dbls.pack_signature_sets_raw(sets, *RUNG, device="cpu")
    pk_xy, pk_mask, sig_x, sig_larger, msg_u, _idx, rand, set_mask = packed
    sig = lambda ts: [(tuple(t.shape), t.dtype) for t in ts]  # noqa: E731
    assert sig(args["stage1"]) == sig((sig_x, sig_larger, msg_u))
    assert sig(args["stage2"])[:2] == sig((pk_xy, pk_mask))
    assert sig(args["stage2"])[3:] == sig((rand, set_mask))
    assert set(lowering.staged_captured()) == set(lowering.STAGES)


# ---------------------------------------------------------------------------
# One batch end to end through a compile service
# ---------------------------------------------------------------------------

# aten ops a CUDA capture refuses, or that read a device value on the host
_SYNCING = {"_local_scalar_dense", "item", "is_nonzero", "equal", "allclose",
            "nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
            "unique_consecutive", "repeat_interleave", "lift_fresh",
            "lift_fresh_copy"}


class _NoHostSync(TorchDispatchMode):
    """Fails on an op that would sync with the host or copy host data
    inside a CUDA graph capture; records the ops it saw."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bad = name in _SYNCING
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            bad = any(t is not None and t.dtype == torch.bool for t in args[1])
        if bad:
            raise AssertionError(f"{func} would sync with the host under capture")
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _no_host_data(*_a, **_k):
    raise AssertionError("a tensor made from host data inside a stage program")


@contextlib.contextmanager
def _capture_safe(monkeypatch):
    """Run every stage program's function under :class:`_NoHostSync`, with
    ``torch.from_numpy`` refused (the constant caches were filled by the
    warm-up). Yields the list of modes, one per stage call."""
    modes = []
    for prog in lowering.staged_captured().values():
        def wrapped(*args, _fn=prog.fn):
            mode = _NoHostSync()
            modes.append(mode)
            with mode, mock.patch.object(torch, "from_numpy", _no_host_data):
                return _fn(*args)
        monkeypatch.setattr(prog, "fn", wrapped)
    yield modes


@pytest.fixture(scope="module")
def service():
    """A compile service whose plan is the one rung, warmed on the CPU by
    the default path (``lowering.warm_staged``), attached to the seam."""
    svc = psvc.CompileService(rungs=(RUNG,), device="cpu")
    psvc.set_service(svc)
    svc.start()
    try:
        assert svc.wait_idle(timeout=300)
        yield svc
    finally:
        svc.stop()
        psvc.clear_service(svc)


def _sets(poison: bool):
    """(JAX sets, port sets): three single-signer sets over two messages
    (exact rung (4, 1, 2)); poisoned, set 1 is signed by the wrong key."""
    sks = [jbls.SecretKey(31 + i) for i in range(2)]
    pks = [sk.public_key().point for sk in sks]
    signers = [(0, M1), (0 if poison else 1, M1), (1, M2)]
    owners = [0, 1, 1]
    raws = [sks[s].sign(m).serialize() for s, m in signers]
    jsets = [(jbls.Signature.deserialize(r), [pks[o]], m)
             for r, o, (_s, m) in zip(raws, owners, signers)]
    ppks = [G1Point(Fq(p.x.n), Fq(p.y.n)) for p in pks]
    psets = [(bls.Signature.deserialize(r), [ppks[o]], m)
             for r, o, (_s, m) in zip(raws, owners, signers)]
    return jsets, psets


def test_warm_staged_marks_the_rung_warm_on_cpu(service):
    impl = psvc.CompileService._impl()
    st = service.status()
    assert st["warm_rungs"] == [[*RUNG, impl]]
    assert st["failed_total"] == 0 and st["compiled_total"] == 1
    assert set(st["stages"]["4x2x2"]) == set(lowering.STAGES)
    assert service.route(3, 1, 2) == {"action": "padded", "rung": RUNG,
                                      "exact": (4, 1, 2), "fp_impl": impl,
                                      "device": 0}


@pytest.mark.parametrize("poison", [False, True])
def test_batch_pads_to_the_warm_rung_and_matches_cpu_native(service, poison, monkeypatch):
    jsets, psets = _sets(poison)
    want = NativeBackend().verify_signature_sets(jsets)
    assert want is (not poison)
    backend = dbls.CudaBackend(device="cpu")
    if poison:
        assert backend.verify_signature_sets(psets) is want
    else:  # the capture-safety check once: the poisoned batch runs the same ops
        with _capture_safe(monkeypatch) as modes:
            assert backend.verify_signature_sets(psets) is want
        assert len(modes) == 3 and all(m.ops > 1000 for m in modes)
    lb = backend.last_batch
    assert lb["path"] == "raw_staged" and lb["rung"] == RUNG
    assert (lb["b"], lb["k"], lb["m"]) == RUNG and lb["n_sets"] == 3
    assert lb["warm"] is True and set(lb["stages"]) == set(lowering.STAGES)
    costs = service.measured_rung_costs()["rungs"]["4x2x2@dev0"]
    assert costs["dispatches"] >= 1 and costs["sum_sets"] >= 3
    assert service.status()["warm_rungs"] == [[*RUNG, psvc.CompileService._impl()]]
