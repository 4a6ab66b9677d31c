"""The port's operation pool and duty lookahead against the JAX package's.

Both pools are fed the same bytes: the JAX harness's attestations (the
minimal preset, 16 validators, phase0) with their signatures replaced by
real ones from the C signer, so that every merge folds real G2 points,
and a sync committee's messages over one root. Exact equality
throughout (the outputs are SSZ bytes):

* attestations for a block, sync contributions, the block's sync
  aggregate (from messages, and with a stored contribution) and the
  persistence blob with its round trip;
* with a ``DeviceAggregator(device="cpu")`` attached, every sum runs the
  device G2 sum at the smallest MSM rung (64 points) and the outputs are
  byte-equal to the host fold's, with every sum counted ``ok``;
* the lookahead's device row (the device MSM with all-one scalars on the
  CPU) equals the host fold and is pre-inserted into a key table; its
  worker's trigger, counts and journal match the JAX worker's on one
  clock schedule.
"""

from __future__ import annotations

import copy

import pytest
import torch

from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.duty_lookahead import DutyLookahead as JLookahead
from lighthouse_tpu.operation_pool import OperationPool as JPool
from lighthouse_tpu.operation_pool.persistence import (
    pool_from_bytes as jpool_from_bytes, pool_to_bytes as jpool_to_bytes)
from lighthouse_tpu.state_transition import partial_state_advance as jadvance
from lighthouse_tpu.testing.harness import StateHarness as JHarness
from lighthouse_tpu.types import types_for as jtypes_for
from lighthouse_tpu.types.chain_spec import minimal_spec as jminimal_spec
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu.utils import (
    flight_recorder as jfr, slot_clock as jclock, slot_ledger as jledger)
from lighthouse_tpu_torch.crypto import backend as tbackend
from lighthouse_tpu_torch.crypto.cpu.curve import g1_generator
from lighthouse_tpu_torch.crypto.device import key_table
from lighthouse_tpu_torch.crypto.native import native_sign
from lighthouse_tpu_torch.duty_lookahead import DutyLookahead as TLookahead
from lighthouse_tpu_torch.operation_pool import DeviceAggregator, OperationPool as TPool
from lighthouse_tpu_torch.operation_pool.persistence import (
    pool_from_bytes as tpool_from_bytes, pool_to_bytes as tpool_to_bytes)
from lighthouse_tpu_torch.types import types_for as ttypes_for
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as tminimal_spec
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL
from lighthouse_tpu_torch.utils import (
    flight_recorder as tfr, metrics as tmetrics, slot_clock as tclock, slot_ledger as tledger)

SLOT, ROOT = 5, bytes(range(32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fake_backends():
    saved = [(m, m._active, m._active_name) for m in (jbackend, tbackend)]
    jbackend.set_backend("fake")
    tbackend.set_backend("fake")
    yield
    for m, active, name in saved:
        m._active, m._active_name = active, name


@pytest.fixture(scope="module")
def inputs():
    """Bytes both pools take: the head state one slot ahead, every
    committee member's single-bit attestation of the last two slots
    (really signed), a full sync committee's messages over ``ROOT`` and
    one stored contribution."""
    saved = (jbackend._active, jbackend._active_name)
    jbackend.set_backend("fake")
    try:
        h = JHarness(JMINIMAL, jminimal_spec(), 16, fork_name="phase0", fake_sign=True)
        h.extend_chain(3, strategy="none", attest=False)
        singles = []
        for slot in (h.state.slot - 2, h.state.slot - 1):
            for full in h.attestations_for_slot(h.state, slot):
                n = len(full.aggregation_bits)
                for i in range(n):
                    att = copy.deepcopy(full)
                    att.aggregation_bits = [j == i for j in range(n)]
                    att.signature = native_sign(1000 + 31 * slot + i, bytes([slot, i]) * 16)
                    singles.append(type(att).encode(att))
        advanced = jadvance(h.preset, h.spec, copy.deepcopy(h.state), h.state.slot + 1)
        state = type(advanced).encode(advanced)
    finally:
        jbackend._active, jbackend._active_name = saved
    sync = [(pos, native_sign(2000 + pos, ROOT)) for pos in range(JMINIMAL.SYNC_COMMITTEE_SIZE)]
    sub = JMINIMAL.sync_subcommittee_size
    stored = ([pos < sub - 1 for pos in range(sub)], native_sign(3000, ROOT))
    return {"singles": singles, "state": state, "sync": sync, "stored": stored}


def _drive(pool, t, inputs) -> dict:
    """Every output of ``pool`` fed ``inputs``, as bytes."""
    for raw in inputs["singles"]:
        pool.insert_attestation(t.Attestation.decode(raw))
    state = t.state["phase0"].decode(inputs["state"])
    out = {"n_attestations": pool.n_attestations(),
           "for_block": [t.Attestation.encode(a) for a in pool.attestations_for_block(state)]}
    for pos, sig in inputs["sync"]:
        pool.insert_sync_committee_message(SLOT, ROOT, pos, sig)
    out["contributions"] = [
        t.SyncCommitteeContribution.encode(pool.sync_contribution_for(SLOT, ROOT, i))
        for i in range(t.preset.SYNC_COMMITTEE_SUBNET_COUNT)]
    out["aggregate"] = t.SyncAggregate.encode(pool.sync_aggregate_for_block(SLOT, ROOT))
    bits, sig = inputs["stored"]
    pool.insert_sync_contribution(t.SyncCommitteeContribution(
        slot=SLOT, beacon_block_root=ROOT, subcommittee_index=2, aggregation_bits=bits,
        signature=sig))
    out["with_stored"] = t.SyncAggregate.encode(pool.sync_aggregate_for_block(SLOT, ROOT))
    return out


def _agg_counts() -> dict:
    fam = tmetrics.get("op_pool_device_agg_total")
    return {k: (fam.children().get((k,)).value if fam.children().get((k,)) else 0)
            for k in ("ok", "fallback", "small")}


def test_pool_outputs_and_persistence_match_jax(inputs):
    jt, tt = jtypes_for(JMINIMAL), ttypes_for(TMINIMAL)
    jpool = JPool(JMINIMAL, jminimal_spec(), jt)
    tpool = TPool(TMINIMAL, tminimal_spec(), tt)
    got, want = _drive(tpool, tt, inputs), _drive(jpool, jt, inputs)
    assert got == want
    assert got["n_attestations"] > 0 and got["for_block"]
    blob = tpool_to_bytes(tpool)
    assert blob == jpool_to_bytes(jpool)
    back = tpool_from_bytes(TMINIMAL, tminimal_spec(), tt, blob)
    assert tpool_to_bytes(back) == blob
    assert jpool_to_bytes(jpool_from_bytes(JMINIMAL, jminimal_spec(), jt, blob)) == blob


def test_device_aggregator_on_the_cpu_is_byte_equal_to_the_host_fold(inputs):
    """Every sum of the pool with an aggregator attached runs the device
    G2 sum at the MSM ladder's smallest rung (64) on the CPU and gives the
    host fold's bytes; none falls back."""
    tt = ttypes_for(TMINIMAL)
    host = _drive(TPool(TMINIMAL, tminimal_spec(), tt), tt, inputs)
    agg = DeviceAggregator(device="cpu")
    assert agg._pad_n(2) == agg._pad_n(TMINIMAL.SYNC_COMMITTEE_SIZE) == 64
    before = _agg_counts()
    seq0 = tfr.status()["recorded_total"]
    dev = _drive(TPool(TMINIMAL, tminimal_spec(), tt, device_agg=agg), tt, inputs)
    after = _agg_counts()
    assert dev == host
    ok = after["ok"] - before["ok"]
    assert ok >= 6 and after["fallback"] == before["fallback"]
    events = [e for e in tfr.events(["op_pool_device_agg"]) if e["seq"] >= seq0]
    assert len(events) == ok
    assert {e["fields"]["pad_n"] for e in events} == {64}
    assert all(e["fields"]["outcome"] == "ok" for e in events)


def _lookahead_journal(fr, seq0):
    keep = ("epoch", "committees", "warmed", "device_sums", "host_sums", "virtual", "failed")
    return [{k: e["fields"].get(k) for k in keep} for e in fr.events(["lookahead_epoch_warmed"])
            if e["seq"] >= seq0]


def test_lookahead_worker_matches_jax_on_one_clock_schedule():
    """Model mode (no key table), as the replay drives it: the trigger,
    the per-epoch counts, the journal and the ``on_warmed`` calls of both
    workers, ticked by hand over the same manual clock, each prewarming
    its package's ``CommitteeSightingModel``; the warmed committees'
    sightings are then hits and an unwarmed one a first sighting."""
    committees = {e: [tuple(range(8 * e + i, 8 * e + i + 3)) for i in range(4)]
                  for e in range(4)}
    got = {}
    for name, cls, clock_mod, fr, ledger in (("jax", JLookahead, jclock, jfr, jledger),
                                             ("torch", TLookahead, tclock, tfr, tledger)):
        clock = clock_mod.ManualSlotClock(0, 6, 8)
        prev = clock_mod.set_clock(clock)
        seq0 = fr.status()["recorded_total"]
        warmed = []
        sightings = ledger.CommitteeSightingModel()

        def on_warmed(e, c, warmed=warmed, sightings=sightings):
            warmed.append((e, len(c)))
            sightings.prewarm(c)

        try:
            la = cls(lambda e: committees[e], trigger_frac=0.5, on_warmed=on_warmed)
            ticks = []
            for slot in (0, 2, 3, 4, 5, 9, 12, 13, 20):
                clock.set_slot(slot)
                r = la.tick()
                ticks.append(None if r is None else (r["epoch"], r["counts"]))
            st = la.status()
        finally:
            clock_mod.set_clock(prev)
        st.pop("last_warm_s")
        for c in (*committees[1], *committees[2], (99, 100)):
            sightings.observe(c)
        got[name] = (ticks, st, warmed, _lookahead_journal(fr, seq0),
                     (sightings.first, sightings.hits, sightings.hit_ratio()))
    assert got["torch"] == got["jax"]
    assert got["torch"][0][3] == (1, {"device": 0, "host": 0, "virtual": 4, "failed": 0})
    assert got["torch"][4][:2] == (1, 8)


def test_lookahead_device_row_on_the_cpu_equals_the_host_fold():
    """The lookahead's committee sum on the CPU (``device_msm_g1`` with
    all-one scalars at the smallest rung) equals the host fold, and the
    warm pre-inserts it into the key table as the committee's row."""
    pts = [g1_generator().mul(7 + 3 * i) for i in range(5)]
    cache = type("Cache", (), {"pubkeys": [type("Pk", (), {"point": p})() for p in pts],
                               "get": lambda self, i: self.pubkeys[i]})()
    table = key_table.DeviceKeyTable(cache, device="cpu")
    table.sync(reason="startup")
    clock = tclock.ManualSlotClock(0, 6, 8)
    prev = tclock.set_clock(clock)
    try:
        la = TLookahead(lambda e: [(0, 1, 2, 3, 4)], key_table=table, pubkey_cache=cache,
                        device="cpu")
        sums = []
        device_sum = la._sum_points
        la._sum_points = lambda points: sums.append(device_sum(points)) or sums[-1]
        r = la.warm_epoch(1)
        host = pts[0]
        for p in pts[1:]:
            host = host + p
        assert sums == [(host, "device")]
    finally:
        tclock.set_clock(prev)
    assert r["counts"] == {"device": 1, "host": 0, "virtual": 0, "failed": 0}
    assert r["inserts"] == {"inserted": 1}
    assert table.status()["aggregate_precomputed"] == 1
    assert la.status()["committees"]["device"] == 1


def _failing(monkeypatch, name):
    """Make the device function ``name`` of the port's ``crypto/device/bls.py``
    raise, as a kernel that fails to build or launch would."""
    from lighthouse_tpu_torch.crypto.device import bls as dbls

    def boom(*a, **k):
        raise RuntimeError("injected device failure")
    monkeypatch.setattr(dbls, name, boom)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_failed_device_sum_falls_back_only_for_a_cpu_caller(inputs, monkeypatch, device):
    """A failed G2 sum is journaled with its error either way. A caller
    that asked for the CPU gets JAX's counted fallback (the host fold's
    bytes); on the card the pool's sum raises and nothing is counted as a
    fallback, so the host never serves the card's work."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.operation_pool.device_agg import DeviceAggregationError

    _failing(monkeypatch, "device_sum_g2")
    tt = ttypes_for(TMINIMAL)
    sigs = [bls.Signature.deserialize(sig) for _, sig in inputs["sync"][:3]]
    host = TPool(TMINIMAL, tminimal_spec(), tt)._aggregate(sigs).serialize()
    pool = TPool(TMINIMAL, tminimal_spec(), tt, device_agg=DeviceAggregator(device=device))
    before = _agg_counts()
    seq0 = tfr.status()["recorded_total"]
    if device == "cpu":
        assert pool._aggregate(sigs).serialize() == host
    else:
        with pytest.raises(DeviceAggregationError, match="injected device failure"):
            pool._aggregate(sigs)
    after = _agg_counts()
    assert after["fallback"] - before["fallback"] == (device == "cpu")
    assert after["ok"] == before["ok"]
    events = [e["fields"] for e in tfr.events(["op_pool_device_agg"]) if e["seq"] >= seq0]
    assert [e["outcome"] for e in events] == ["fallback" if device == "cpu" else "error"]
    assert "injected device failure" in events[0]["error"]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_failed_lookahead_sum_falls_back_only_for_a_cpu_caller(monkeypatch, device):
    """A failed committee MSM: a caller that asked for the CPU keeps the
    error in ``last_error`` and the host fold serves the row (counted
    ``host``); on the card the epoch's warm fails, journaled with the
    error and retried after a backoff, and no row is inserted."""
    _failing(monkeypatch, "device_msm_g1")
    pts = [g1_generator().mul(7 + 3 * i) for i in range(5)]
    cache = type("Cache", (), {"pubkeys": [type("Pk", (), {"point": p})() for p in pts],
                               "get": lambda self, i: self.pubkeys[i]})()
    table = key_table.DeviceKeyTable(cache, device="cpu")
    table.sync(reason="startup")
    seq0 = tfr.status()["recorded_total"]
    la = TLookahead(lambda e: [(0, 1, 2, 3, 4)], key_table=table, pubkey_cache=cache,
                    device=device, device_sum=True)
    r = la.warm_epoch(1)
    st = la.status()
    assert "injected device failure" in st["last_error"]
    if device == "cpu":
        assert r["counts"] == {"device": 0, "host": 1, "virtual": 0, "failed": 0}
        assert table.status()["aggregate_precomputed"] == 1
    else:
        assert r is None and st["epochs"]["error"] == 1
        assert st["committees"] == {"device": 0, "host": 0, "virtual": 0, "failed": 0}
        assert table.status()["aggregate_precomputed"] == 0
        failed = [e["fields"] for e in tfr.events(["lookahead_insert_failed"])
                  if e["seq"] >= seq0]
        assert [f["reason"] for f in failed] == ["warm_error"]
        assert "injected device failure" in failed[0]["error"]


def test_signature_decompression_through_the_c_library_equals_the_oracle():
    """The pool decompresses every signature it sums: through the C library
    (the oracle's checks, 0.6 ms against 7 ms), the oracle's point; an x
    off the curve is refused there and raises the oracle's error."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.cpu.curve import G2Point

    sigs = [native_sign(7 + i, bytes([i]) * 32) for i in range(16)]
    for raw in sigs:
        assert bls._native_signature_point(raw) == G2Point.decompress(raw)
        assert bls.Signature.deserialize(raw).point == G2Point.decompress(raw)
    bad = next(raw[:95] + bytes([b]) for raw in sigs for b in range(256)
               if not _on_curve(raw[:95] + bytes([b])))
    assert bls._native_signature_point(bad) is None
    with pytest.raises(bls.BlsError, match="not on curve"):
        bls.Signature.deserialize(bad).point


def _on_curve(raw: bytes) -> bool:
    from lighthouse_tpu_torch.crypto.cpu.curve import G2Point

    try:
        G2Point.decompress(raw)
    except ValueError:
        return False
    return True
