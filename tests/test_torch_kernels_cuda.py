"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a card: the
kernels are CUDA C++ with no CPU mode. This file imports neither JAX nor
the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 raw columns and reduced limbs equal to the plain versions
(exact integers, same reduction plan); K2/K3 canonical-equal with limbs
in [0, 8191]; the composed engines canonical-equal to K1-K3, limbs in
[0, 8191]; verdicts as expected; a warm verify beside another thread's
capture under 1.0 s. Lane counts 1 to 3474 cover one lane,
ragged blocks and the largest K2 launch of the verify path; K3 is also
held limb for limb at every lane count the verify path launches it with.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.device import fp, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA with no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# 1 lane, ragged blocks of K1's four lanes, and the block batch's
# largest K2 launch
LANES = (1, 3, 5, 1170, 3474)
# K3's lane counts on the verify path: gossip 96 and 195, block 960 and 579
K3_PATH_LANES = (96, 195, 579, 960)


def _limbs(rng, *shape):
    """Random relaxed limbs with the all-8191 worst case and zeros."""
    a = rng.integers(0, fp.LIMB_MAX + 1, size=(*shape, fp.NL), dtype=np.int32)
    a[0] = fp.LIMB_MAX
    a[1:2] = 0
    return a


def _canonical_equal(got, want):
    assert int(got.min()) >= 0 and int(got.max()) <= fp.LIMB_MAX
    assert torch.equal(fp.canonical(got), fp.canonical(want))


@pytest.mark.parametrize("lanes", LANES)
def test_k1_matches_plain(dev, lanes):
    rng = np.random.default_rng(11 + lanes)
    x, y = (torch.from_numpy(_limbs(rng, lanes)).to(dev) for _ in range(2))
    assert torch.equal(kernels.fp_mul_cols(x, y), kernels.fp_mul_cols_plain(x, y))
    got = kernels.fp_mul(x, y)
    assert torch.equal(got, kernels.fp_mul_plain(x, y))
    assert int(got.min()) >= 0 and int(got.max()) <= fp.LIMB_MAX
    # broadcasting and an empty batch
    assert torch.equal(kernels.fp_mul(x, y[:1]), kernels.fp_mul_plain(x, y[:1]))
    assert torch.equal(kernels.fp_mul_cols(x[:1], y), kernels.fp_mul_cols_plain(x[:1], y))
    assert kernels.fp_mul(x[:0], y[:0]).shape == (0, fp.NL)


@pytest.mark.parametrize("lanes", LANES)
def test_k2_k3_match_plain(dev, lanes):
    rng = np.random.default_rng(12 + lanes)
    a, b = (torch.from_numpy(_limbs(rng, lanes, 2)).to(dev) for _ in range(2))
    _canonical_equal(kernels.fp2_mul(a, b), kernels.fp2_mul_plain(a, b))
    _canonical_equal(kernels.fp2_sq(a), kernels.fp2_sq_plain(a))
    # broadcasting and empty batches
    _canonical_equal(kernels.fp2_mul(a, b[:1]), kernels.fp2_mul_plain(a, b[:1]))
    assert kernels.fp2_mul(a[:0], b[:0]).shape == (0, 2, fp.NL)
    assert kernels.fp2_sq(a[:0]).shape == (0, 2, fp.NL)


@pytest.mark.parametrize("lanes", K3_PATH_LANES)
def test_k3_matches_plain_at_path_lanes(dev, lanes):
    rng = np.random.default_rng(13 + lanes)
    a = torch.from_numpy(_limbs(rng, lanes, 2)).to(dev)
    assert torch.equal(kernels.fp2_sq(a), kernels.fp2_sq_plain(a))


def test_kernels_reject_bad_operands(dev):
    x = torch.zeros((4, fp.NL), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        kernels.fp_mul(x, x)
    with pytest.raises(ValueError):
        kernels.fp2_sq(torch.zeros((4, 3, fp.NL), dtype=torch.int32, device=dev))


def test_verify_on_card_counts_launches(dev):
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.device.bls import CudaBackend

    sks = [bls.SecretKey(77 + i) for i in range(2)]
    pks = [sk.public_key().point for sk in sks]
    m1, m2 = b"\x31" * 32, b"\x32" * 32
    agg = bls.SecretKey(77 + 78).sign(m2)
    sets = [(sks[0].sign(m1), [pks[0]], m1), (agg, pks, m2)]
    sets = [(bls.Signature.deserialize(s.serialize()), k, m) for s, k, m in sets]
    backend = CudaBackend(device=dev)
    kernels.reset_launches()
    assert backend.verify_signature_sets(sets) is True
    assert all(n > 0 for n in kernels.launches.values()), kernels.launches
    for name, n in kernels.launches.items():
        hist = kernels.lane_hist[name]
        assert sum(hist.values()) == n
        assert sum(k * v for k, v in hist.items()) == kernels.lanes[name] >= n
    bad = [sets[0], (sets[1][0], sets[1][1], m1)]
    assert backend.verify_signature_sets(bad) is False


def test_key_table_grown_on_card_gathers_as_on_cpu(dev):
    """A table synced on the card and grown across one capacity rung (1024
    -> 4096 rows, copied on the device) gathers the same rows, aggregate
    region included, as the same table on the CPU: torch.equal."""
    import types

    from lighthouse_tpu_torch.crypto.cpu.curve import g1_generator
    from lighthouse_tpu_torch.crypto.device.bls import _gather_fn
    from lighthouse_tpu_torch.crypto.device.key_table import DeviceKeyTable

    g = g1_generator()
    pts, p = [], g
    for _ in range(1100):
        pts.append(types.SimpleNamespace(point=p))
        p = p + g
    caches = [types.SimpleNamespace(pubkeys=pts[:1000]) for _ in range(2)]
    tables = [DeviceKeyTable(c, agg_min_repeats=1, upload_chunk_rows=300, device=d)
              for c, d in zip(caches, (dev, "cpu"))]
    committee = (None, [pts[i].point for i in (3, 4, 5)], b"\x00" * 32)
    for t, c in zip(tables, caches):
        t.sync(reason="startup")
        assert t.resolve_sets([committee])[3] == 1
        c.pubkeys.extend(pts[1000:])
        assert t.sync() == 100
        assert t.status()["validator_capacity"] == 4096
    (gdev, gagg), (cdev, cagg) = (t.device_arrays() for t in tables)
    assert gdev.device.type == "cuda" and gagg.device.type == "cuda"
    idx = torch.tensor([[0, 999, 1000, 1099], [4096, 4097, 5, 9999]], dtype=torch.int32)
    got = _gather_fn(gdev, gagg, idx.to(dev))
    assert torch.equal(got.cpu(), _gather_fn(cdev, cagg, idx))
    assert torch.equal(gdev.cpu(), cdev)


# ---------------------------------------------------------------------------
# CUDA graphs (``graphs.CapturedProgram``): captures against eager runs
# ---------------------------------------------------------------------------

def test_captured_k1_replays_equal_to_eager(dev):
    """One K1 launch from the ctypes library, captured into a graph on the
    torch stream, replays equal to an eager launch on new inputs."""
    from lighthouse_tpu_torch.crypto.device import graphs

    rng = np.random.default_rng(21)
    x, y, x2, y2 = (torch.from_numpy(_limbs(rng, 192)).to(dev) for _ in range(4))
    prog = graphs.CapturedProgram(kernels.fp_mul, "test_k1")
    assert torch.equal(prog(x, y), kernels.fp_mul_plain(x, y))  # the capture
    g = prog.graph_for(x, y)
    assert g is not None and g.nodes >= 1 and g.replays == 0
    kernels.reset_launches()
    got = prog(x2, y2)
    assert kernels.launches["fp_mul_cols"] == 1  # credited by the replay
    assert torch.equal(got, kernels.fp_mul(x2, y2)) and g.replays == 1
    assert kernels.lane_hist["fp_mul_cols"] == {192: 2}


def _stage_batch(dev, signer=77, seed=5):
    """The raw planes of a 2-set batch (one single-signer set, one
    aggregate of two) with seeded random words."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.device.bls import pack_signature_sets_raw

    sks = [bls.SecretKey(signer + i) for i in range(2)]
    pks = [sk.public_key().point for sk in sks]
    m1, m2 = bytes([seed]) * 32, bytes([seed + 1]) * 32
    sets = [(sks[0].sign(m1), [pks[0]], m1),
            (bls.SecretKey(2 * signer + 1).sign(m2), pks, m2)]
    sets = [(bls.Signature.deserialize(s.serialize()), k, m) for s, k, m in sets]
    rng = np.random.default_rng(seed)

    def words():
        r = int(rng.integers(1, 2 ** 63, dtype=np.int64))
        return (r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF

    return pack_signature_sets_raw(sets, rand_words=words, device=dev)


def test_captured_stages_equal_eager_and_credit_eager_counts(dev):
    """Each stage's capture and its replay equal the eager stage function
    on the same planes (``torch.equal``), and a replay credits exactly the
    launches, lanes and lane counts of the eager run."""
    from lighthouse_tpu_torch.crypto.device import bls as dbls

    pk_xy, pk_mask, sig_x, sig_larger, msg_u, msg_idx, rand, set_mask = _stage_batch(dev)
    s1 = (sig_x, sig_larger, msg_u)

    def stage_args(out1, out2):
        sig_xy, mx, my, minf, _ok = out1
        pk_x, pk_y, pk_inf, acc_x, acc_y, acc_inf, _f = out2
        return {
            "stage1": s1,
            "stage2": (pk_xy, pk_mask, sig_xy, rand, set_mask),
            "stage3": (pk_x, pk_y, pk_inf, *dbls._take_messages(mx, my, minf, msg_idx),
                       acc_x, acc_y, acc_inf),
        }

    out1 = dbls._stage1_fn(*s1)
    out2 = dbls._stage2_fn(pk_xy, pk_mask, out1[0], rand, set_mask)
    args = stage_args(out1, out2)
    for name, fn, prog in (("stage1", dbls._stage1_fn, dbls._stage1),
                           ("stage2", dbls._stage2_fn, dbls._stage2),
                           ("stage3", dbls._stage3_fn, dbls._stage3)):
        kernels.reset_launches()
        want = fn(*args[name])
        eager = kernels.snapshot()
        want = want if isinstance(want, tuple) else (want,)
        prog(*args[name])  # captures, unless an earlier test did
        kernels.reset_launches()
        got = prog(*args[name])  # a replay
        assert kernels.snapshot() == eager, name
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (name, i)
    assert bool(want[0]) is True  # the batch verifies


def test_replay_uses_new_inputs(dev):
    """A replay copies each argument into its static input: the stage-2
    graph's static ``rand_bits`` holds the latest batch's plane, and a
    batch signed by other keys gives its own verdict through the same
    graphs."""
    from lighthouse_tpu_torch.crypto.device import bls as dbls

    a = _stage_batch(dev, signer=91, seed=7)
    b = _stage_batch(dev, signer=93, seed=9)
    assert not torch.equal(a[6], b[6])
    for planes in (a, b):
        assert bool(dbls._staged_verify(*planes)) is True
        out1 = dbls._stage1(*planes[2:5])
        args2 = (planes[0], planes[1], out1[0], planes[6], planes[7])
        dbls._stage2(*args2)
        g = dbls._stage2.graph_for(*args2)
        assert g is not None and torch.equal(g.inputs[3], planes[6])
    bad = list(b)
    bad[4] = a[4]  # b's signatures over a's messages
    assert bool(dbls._staged_verify(*bad)) is False
    assert bool(dbls._staged_verify(*a)) is True


def test_backend_counts_equal_between_capture_and_replay(dev):
    """The first verify at a rung runs the eager warm-ups (counted); later
    verifies replay the graphs (credited): the same counts, and
    ``last_batch`` says which it was."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.device import graphs
    from lighthouse_tpu_torch.crypto.device.bls import CudaBackend

    sks = [bls.SecretKey(301 + i) for i in range(3)]
    m = b"\x55" * 32
    sets = [(bls.Signature.deserialize(sk.sign(m).serialize()),
             [sk.public_key().point], m) for sk in sks]  # B=4 K=1 M=1
    backend = CudaBackend(device=dev)
    counts = []
    for _ in range(3):
        kernels.reset_launches()
        assert backend.verify_signature_sets(sets) is True
        counts.append((kernels.snapshot(), backend.last_batch["warm"]))
    assert counts[0][0] == counts[1][0] == counts[2][0]
    assert [w for _, w in counts][1:] == [True, True]
    st = graphs.status()
    assert st["graphs"] >= 3 and st["nodes"] > 0 and st["pool_bytes"] > 0


def test_hashed_and_aggregate_verify_programs_capture_and_replay(dev):
    """The hashed program (bare points) and the aggregate-verify program,
    each captured at its first call and replayed after: right verdicts on
    valid and wrong inputs through the same graphs."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.device.bls import CudaBackend

    sks = [bls.SecretKey(401 + i) for i in range(2)]
    pks = [sk.public_key() for sk in sks]
    ms = [b"\x61" * 32, b"\x62" * 32]
    sigs = [sk.sign(m) for sk, m in zip(sks, ms)]
    backend = CudaBackend(device=dev)
    sets = [(s.point_or_infinity(), [pk.point], m) for s, pk, m in zip(sigs, pks, ms)]
    for want in (True, True):  # the capture, then a replay
        assert backend.verify_signature_sets(sets) is want
    assert backend.last_batch["path"] == "hashed" and backend.last_batch["warm"]
    assert backend.verify_signature_sets([sets[0], (sets[1][0], sets[1][1], ms[0])]) is False
    agg = bls.AggregateSignature.infinity()
    for s in sigs:
        agg.add_assign(s)
    for _ in range(2):
        assert agg.aggregate_verify(ms, pks, device=str(dev)) is True
    assert agg.aggregate_verify(ms[::-1], pks, device=str(dev)) is False


# ---------------------------------------------------------------------------
# A capture on another thread never stalls a warm replay
# ---------------------------------------------------------------------------

def _gossip_like(first: int, poison: bool):
    """Four single-signer sets over two messages (rung (4, 1, 2)); poisoned,
    the last set is signed by the wrong key."""
    from lighthouse_tpu_torch.crypto import bls

    sks = [bls.SecretKey(first + i) for i in range(4)]
    msgs = [b"\x71" * 32, b"\x71" * 32, b"\x72" * 32, b"\x72" * 32]
    signers = [0, 1, 2, 2 if poison else 3]
    return [(bls.Signature.deserialize(sks[s].sign(m).serialize()),
             [sks[i].public_key().point], m)
            for i, (s, m) in enumerate(zip(signers, msgs))]


def test_cold_rung_capture_never_stalls_a_warm_verify(dev):
    """The compile service's worker captures a cold rung while another
    thread verifies on a warm rung: every warm verify's wall stays under
    1.0 s (a stage-3 capture alone takes 2.4 s or more on an H100), its
    verdict is right, and the global counters end at exactly the warm
    verifies' credits plus the worker's eager warm-ups."""
    import time

    from lighthouse_tpu_torch.compile_service import lowering
    from lighthouse_tpu_torch.compile_service.service import CompileService
    from lighthouse_tpu_torch.crypto.device import graphs
    from lighthouse_tpu_torch.crypto.device.bls import CudaBackend

    valid, poisoned = _gossip_like(501, False), _gossip_like(501, True)
    backend = CudaBackend(device=dev)
    assert backend.verify_signature_sets(valid) is True  # captures the rung
    kernels.reset_launches()
    assert backend.verify_signature_sets(valid) is True
    assert backend.last_batch["warm"] and backend.last_batch["rung"] == (4, 1, 2)
    eager = kernels.snapshot()
    cold = (24, 2, 4)
    cold_args = lowering.staged_dummy_args(*cold, device=dev)
    progs = lowering.staged_captured()
    assert all(progs[s].graph_for(*cold_args[s]) is None for s in lowering.STAGES)

    svc = CompileService(rungs=(cold,), device=dev)  # not attached: no re-routing
    kernels.reset_launches()
    walls, wrong = [], []
    t0 = time.perf_counter()
    svc.start()
    try:
        while True:
            st = svc.status()
            if st["in_flight"] is None and not st["queue"]:
                break
            for sets, want in ((valid, True), (poisoned, False)):
                t = time.perf_counter()
                got = backend.verify_signature_sets(sets)
                walls.append(time.perf_counter() - t)
                if got is not want or not backend.last_batch["warm"]:
                    wrong.append((want, got, backend.last_batch))
        assert svc.wait_idle(timeout=300)
    finally:
        svc.stop()
    span = time.perf_counter() - t0
    st = svc.status()
    assert st["compiled_total"] == 1 and st["failed_total"] == 0, st["last_error"]
    cold_graphs = [progs[s].graph_for(*cold_args[s]) for s in lowering.STAGES]
    assert all(g is not None for g in cold_graphs)
    capture_s = sum(g.capture_s + g.warmup_s for g in cold_graphs)
    assert not wrong, wrong
    assert len(walls) >= 4, (walls, capture_s, span)
    assert max(walls) < 1.0, (walls, capture_s)
    # exact counts: each warm verify credits the eager counts, the worker's
    # warm-ups add their real launches (equal to each graph's credit)
    want = {k: (0, 0, Counter()) for k in kernels.launches}
    for delta in [eager] * len(walls) + [g.credit for g in cold_graphs]:
        want = {k: (want[k][0] + n, want[k][1] + l, want[k][2] + h)
                for k, (n, l, h) in delta.items()}
    assert kernels.snapshot() == want
    waits = graphs.status()["lock_wait_s"]
    print(f"warm walls {[round(w, 4) for w in walls]} during {capture_s:.2f} s of "
          f"cold-rung warm-up and capture; lock waits {waits}")


def test_scheduler_serves_on_card_with_one_poisoned(dev):
    """The verification scheduler on the card, its compile service warm at
    (4, 1, 2): four single-signer submissions, one signed by the wrong key,
    flushed by hand. The fused flush fails, bisection isolates the bad
    submission on the same warm rung, and each verdict is its own."""
    from lighthouse_tpu_torch.compile_service import service as csvc
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.verification_service import VerificationScheduler

    good, bad = _gossip_like(701, False), _gossip_like(701, True)
    subs = [bls.SignatureSet(sig, [bls.PublicKey(p) for p in pks], m)
            for sig, pks, m in good[:3] + bad[3:]]
    svc = csvc.CompileService(rungs=[(4, 1, 2)], device=dev)
    csvc.set_service(svc)
    svc.start()
    try:
        assert svc.wait_idle(timeout=600)
        kernels.reset_launches()
        sched = VerificationScheduler(compile_service=svc, deadline_ms=600_000).start()
        try:
            futs = [sched.submit([s], "unaggregated") for s in subs]
            sched.flush()
            verdicts = [f.result(timeout=600) for f in futs]
        finally:
            sched.stop()
        st, routes = sched.status(), svc.status()["cold_routes"]
    finally:
        svc.stop()
        csvc.clear_service(svc)
    assert verdicts == [True, True, True, False]
    assert st["bisections_total"] >= 1 and routes["shed"] == 0
    assert all(kernels.launches[k] > 0 for k in kernels.launches)
    print(f"scheduler on the card: routes {routes}, bisections "
          f"{st['bisections_total']}, plan {st['planner']['last_plan']}, launches "
          f"{dict(kernels.launches)}, slo {sched.slo_summary()['kinds']['unaggregated']}")


# ---------------------------------------------------------------------------
# The composed engines against the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fp2_engine", ["composed", "fused_pallas"])
@pytest.mark.parametrize("fp_engine", ["toeplitz_int32", "matmul_int8", "pallas_int8"])
def test_engines_equal_the_kernels_at_path_lanes(dev, fp_engine, fp2_engine):
    """``fp.mul``, ``fp2.mul`` and ``fp2.sq`` under each engine pair are
    canonical-equal to K1, K2 and K3 at the path's lane counts (K1 up to
    the raw block verify's 147,456 lanes; K2 up to 3,474; K3 up to 960),
    limbs in [0, 8191]."""
    from lighthouse_tpu_torch.crypto.device import fp2

    rng = np.random.default_rng(31)
    with fp.impl(fp_engine), fp2.impl(fp2_engine):
        for lanes in (1, 192, 147456):
            x, y = (torch.from_numpy(_limbs(rng, lanes)).to(dev) for _ in range(2))
            _canonical_equal(fp.mul(x, y), kernels.fp_mul(x, y))
        for lanes in (1, 960, 3474):
            a, b = (torch.from_numpy(_limbs(rng, lanes, 2)).to(dev) for _ in range(2))
            _canonical_equal(fp2.mul(a, b), kernels.fp2_mul(a, b))
        for lanes in (1, 96, 960):
            a = torch.from_numpy(_limbs(rng, lanes, 2)).to(dev)
            _canonical_equal(fp2.sq(a), kernels.fp2_sq(a))


# ---------------------------------------------------------------------------
# The device mesh on the card
# ---------------------------------------------------------------------------

def test_two_shard_mesh_on_one_card_loses_recovers_and_resplits(dev):
    """A two-shard mesh whose shards both name the card, behind the
    scheduler with a compile service whose ladder walked both shards
    (rungs (2, 1, 1) and (4, 1, 1), four signers over one message). Shard
    1 is lost mid-run the way the JAX package's chaos tests key a fault:
    the verifier raises ``InjectedFault`` in shard 1's dispatch scope
    while the fault is on, else runs the backend on the card. Its
    sub-batch fails over to shard 0 and the poisoned submission alone is
    False. Cleared, the recovery worker's probe (the canary on the card,
    then a one-set verify through the same verifier) re-admits shard 1
    with no new graph captured, and the next flush splits across both
    shards again."""
    import threading
    import time

    from lighthouse_tpu_torch.compile_service import service as csvc
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.device import graphs, mesh
    from lighthouse_tpu_torch.utils import fault_injection as fi
    from lighthouse_tpu_torch.verification_service import VerificationScheduler
    from lighthouse_tpu_torch.verification_service.planner import FlushPlanner

    msg = b"\x73" * 32
    sks = [bls.SecretKey(811 + i) for i in range(4)]
    sig = [bls.Signature.deserialize(sk.sign(msg).serialize()) for sk in sks]
    good = [bls.SignatureSet(s, [sk.public_key()], msg) for s, sk in zip(sig, sks)]
    bad = bls.SignatureSet(sig[0], [sks[3].public_key()], msg)
    lost = threading.Event()

    def verify(sets):
        if lost.is_set() and mesh.current_shard() == 1:
            raise fi.InjectedFault("staged_dispatch: card lost on shard 1")
        return bls.verify_signature_sets(sets)

    m2 = mesh.DeviceMesh(devices=[dev, dev], probe_base_s=0.2, probe_max_s=0.5)
    mesh.set_mesh(m2)
    svc = csvc.CompileService(rungs=[(2, 1, 1), (4, 1, 1)], device=dev)
    csvc.set_service(svc)
    svc.start()
    sched = None
    try:
        assert svc.wait_idle(timeout=600)
        assert svc.warm_rungs_by_shard([0, 1]) == {0: [(2, 1, 1), (4, 1, 1)],
                                                   1: [(2, 1, 1), (4, 1, 1)]}
        m2.start_recovery(probe_fn=lambda s: m2._default_canary(s)
                          and verify([good[0]]) is True)
        sched = VerificationScheduler(verify_fn=verify, compile_service=svc,
                                      deadline_ms=600_000,
                                      flush_planner=FlushPlanner(dp_min_sets=1)).start()

        def flush(sets):
            futs = [sched.submit([s], "unaggregated") for s in sets]
            sched.flush()
            return ([f.result(timeout=600) for f in futs],
                    sched.status()["planner"]["last_plan"]["dp_shards"])

        assert flush(good) == ([True] * 4, [0, 1])
        lost.set()
        assert flush(good[:3] + [bad])[0] == [True, True, True, False]
        assert m2.healthy_shards() == [0] and m2.is_probing(1)
        # the bisection's warm-ups, requested by the flush, capture first
        assert svc.wait_idle(timeout=600)
        n_graphs = graphs.status()["graphs"]
        lost.clear()
        t0 = time.monotonic()
        while m2.healthy_shards() != [0, 1]:
            assert time.monotonic() - t0 < 60, m2.status()
            time.sleep(0.05)
        assert svc.wait_idle(timeout=600)
        assert graphs.status()["graphs"] == n_graphs
        assert flush(good) == ([True] * 4, [0, 1])
        st = m2.status()
        assert st["recoveries_total"] == 1 and st["chips"][1]["device_memory_bytes"]
    finally:
        if sched is not None:
            sched.stop()
        m2.stop_recovery()
        mesh.clear_mesh(m2)
        svc.stop()
        csvc.clear_service(svc)
