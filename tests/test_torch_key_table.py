"""The port's device key table, its gather and the indexed (gathered)
verify path, against the JAX package on the same seeded keys.

* The table's own contract, the cases of ``tests/test_key_table.py`` and
  of the epoch-retention cases of ``tests/test_duty_lookahead.py``:
  identity pinning, the capacity ladder, delta admission and atomic sync,
  the aggregate collapse and the region reset, held slots when the region
  fills mid-batch, the never-cached infinity aggregate, ``covers_sets``,
  concurrent resolve, capacity growth, retention and ``insert_precomputed``.
* Against the JAX package: the table's rows, ``_gather_fn`` and the
  indexed packer's planes are byte-equal to the JAX twins'.
* The gathered planes equal the raw planes on live slots, and the
  gathered verdicts of ``CudaBackend(device="cpu")`` equal ``cpu-native``'s
  (the C verifier) at B = 2, K = 2.

Every tolerance is exact: byte-equal rows and planes, equal verdicts.
"""

import threading
import types

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto.device import bls as jdbls
from lighthouse_tpu.crypto.device import key_table as jkt
from lighthouse_tpu.crypto.native import NativeBackend
from lighthouse_tpu.crypto.params import R
from lighthouse_tpu.utils import slot_clock as jslot_clock
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.cpu.curve import G1Point, G2Point, g2_generator
from lighthouse_tpu_torch.crypto.cpu.fields import Fq, Fq2
from lighthouse_tpu_torch.crypto.device import bls as dbls
from lighthouse_tpu_torch.crypto.device import curve, fp
from lighthouse_tpu_torch.crypto.device import key_table as kt
from lighthouse_tpu_torch.crypto.params import B2
from lighthouse_tpu_torch.utils import slot_clock

from test_torch_bls import seeded_words

SEED = 11
MSG = b"\x21" * 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def manual_clock():
    clock = slot_clock.ManualSlotClock(genesis_time=0, seconds_per_slot=12)
    prev = slot_clock.set_clock(clock)
    yield clock
    slot_clock.set_clock(prev)


def _port_point(jpoint) -> G1Point:
    return G1Point(Fq(jpoint.x.n), Fq(jpoint.y.n))


def _caches(n, seed=1000):
    """n keys (the C library's fast keygen) as a JAX cache and a port cache
    over the same points: append-only ``pubkeys`` lists of PublicKeys."""
    sks = [jbls.SecretKey(seed + i) for i in range(n)]
    jpks = [sk.public_key() for sk in sks]
    jcache = types.SimpleNamespace(pubkeys=jpks)
    pcache = types.SimpleNamespace(
        pubkeys=[bls.PublicKey(_port_point(pk.point)) for pk in jpks])
    return sks, jcache, pcache


def _table(cache, **kw):
    t = kt.DeviceKeyTable(cache, device="cpu", **kw)
    t.sync(reason="startup")
    return t


def _committee(cache, members, sig=None, msg=MSG):
    """One ``(sig, [points], msg)`` triple over cache rows ``members``."""
    sig = sig if sig is not None else bls.Signature.infinity()
    return (sig, [cache.pubkeys[i].point for i in members], msg)


def _host_sum(cache, members):
    s = cache.pubkeys[members[0]].point
    for i in members[1:]:
        s = s + cache.pubkeys[i].point
    return s


def _row(point) -> np.ndarray:
    return curve.pack_g1([point])[0][0]


def _extend(cache, n):
    """Append n more keys by repeated addition (distinct points)."""
    p = cache.pubkeys[-1].point
    step = cache.pubkeys[0].point
    for _ in range(n):
        p = p + step
        cache.pubkeys.append(types.SimpleNamespace(point=p))


# ---------------------------------------------------------------------------
# Sync, identity, capacity
# ---------------------------------------------------------------------------


def test_startup_sync_rows_equal_jax_table():
    _sks, jcache, pcache = _caches(5)
    t = kt.DeviceKeyTable(pcache, device="cpu")
    assert t.sync(reason="startup") == 5
    jt = jkt.DeviceKeyTable(jcache)
    jt.sync(reason="startup")
    dev, agg = t.device_arrays()
    jdev, jagg = jt.device_arrays()
    assert dev.dtype == torch.int32 and tuple(dev.shape) == (1024, 2, fp.NL)
    assert dev.numpy().tobytes() == np.asarray(jdev).tobytes()
    assert agg.numpy().tobytes() == np.asarray(jagg).tobytes()
    for i, pk in enumerate(pcache.pubkeys):
        assert t.index_of_point(pk.point) == i
    st = t.status()
    assert st["validators_resident"] == 5 and st["identity_pinned"] is True
    assert st["upload_bytes"]["startup"] == 5 * kt.G1_ROW_BYTES
    assert st["device_bytes"] == (1024 + kt.DEFAULT_MAX_AGGREGATES) * kt.G1_ROW_BYTES
    assert t.sync() == 0
    assert kt.NL == fp.NL == jkt.NL and kt.CAPACITY_LADDER == jkt.CAPACITY_LADDER


@pytest.mark.parametrize("n", [1, 1024, 1025, 65537, 1_000_000, 1_100_000])
def test_capacity_ladder_matches_jax(n):
    assert kt.table_capacity(n) == jkt.table_capacity(n)
    assert kt.table_capacity(1025) == 4096


def test_delta_admission_chunked_and_atomic():
    _sks, _jcache, cache = _caches(3)
    t = _table(cache, upload_chunk_rows=2)
    _extend(cache, 4)
    assert t.sync(reason="delta") == 4
    dev = t.device_arrays()[0]
    for i in range(7):
        assert np.array_equal(dev[i].numpy(), _row(cache.pubkeys[i].point))
        assert t.index_of_point(cache.pubkeys[i].point) == i
    assert t.status()["upload_bytes"]["delta"] == 4 * kt.G1_ROW_BYTES
    before = dev.clone()

    # an invalid row mid-delta commits NOTHING, not even the valid rows
    # packed before it; a shrunken cache raises too
    good = bls.PublicKey(_extend_point(cache))
    cache.pubkeys.extend([good, types.SimpleNamespace(point=None)])
    with pytest.raises(kt.KeyTableError):
        t.sync()
    assert len(t) == 7 and t.index_of_point(good.point) is None
    assert torch.equal(t.device_arrays()[0], before)
    del cache.pubkeys[1:]
    with pytest.raises(kt.KeyTableError):
        t.sync()
    assert len(t) == 7


def _extend_point(cache):
    return cache.pubkeys[-1].point + cache.pubkeys[0].point


def test_sync_or_schedule_retries_then_catches_up(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_KEY_TABLE_RESYNC_BASE_S", "0.01")
    _sks, _jcache, cache = _caches(2)
    t = _table(cache)
    good = types.SimpleNamespace(point=_extend_point(cache))
    cache.pubkeys.append(types.SimpleNamespace(point=None))
    try:
        assert t.sync_or_schedule() is None
        assert t.status()["resyncs"]["scheduled"] >= 1
        cache.pubkeys[-1] = good
        for _ in range(200):
            if len(t) == 3:
                break
            threading.Event().wait(0.01)
        assert len(t) == 3 and t.status()["resyncs"]["ok"] >= 1
    finally:
        t.close()
    monkeypatch.delenv("LIGHTHOUSE_TPU_KEY_TABLE", raising=False)
    assert kt.env_enabled() is True
    monkeypatch.setenv("LIGHTHOUSE_TPU_KEY_TABLE", "0")
    assert kt.env_enabled() is False


def test_env_knobs_size_the_table(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_KEY_TABLE_MAX_AGG", "3")
    monkeypatch.setenv("LIGHTHOUSE_TPU_KEY_TABLE_CHUNK", "not a number")
    _sks, _jcache, cache = _caches(1)
    t = _table(cache)
    assert t.max_aggregates == 3
    assert t.upload_chunk_rows == kt.DEFAULT_UPLOAD_CHUNK_ROWS
    assert tuple(t.device_arrays()[1].shape) == (3, 2, fp.NL)


# ---------------------------------------------------------------------------
# Resolution: identity pinning, aggregate collapse, reset, held slots
# ---------------------------------------------------------------------------


def test_resolution_is_identity_pinned_not_equality():
    _sks, _jcache, cache = _caches(3)
    t = _table(cache)
    sets = [_committee(cache, [i]) for i in range(3)]
    resolved, _dev, _agg, collapsed = t.resolve_sets(sets)
    assert resolved == [[0], [1], [2]] and collapsed == 0
    # a byte-equal FOREIGN point misses: the whole batch falls back raw
    foreign = bls.PublicKey.deserialize(cache.pubkeys[0].serialize())
    assert foreign.point is not cache.pubkeys[0].point
    bad = [(sets[0][0], [foreign.point], MSG)] + sets[1:]
    assert t.resolve_sets(bad) is None
    assert t.status()["sets"]["raw"] == 3


def test_aggregate_collapse_on_repeat_and_region_reset():
    _sks, _jcache, cache = _caches(6)
    t = _table(cache, max_aggregates=1)
    a = [_committee(cache, [0, 1, 2])]
    b = [_committee(cache, [3, 4, 5])]
    r1, _, _, c1 = t.resolve_sets(a)
    assert c1 == 0 and len(r1[0]) == 3       # first sighting ships K
    r2, dev, agg, c2 = t.resolve_sets(a)
    assert c2 == 1 and r2[0] == [1024]       # second collapses to one slot
    assert np.array_equal(agg[0].numpy(), _row(_host_sum(cache, [0, 1, 2])))
    assert t.status()["aggregate_sum_seconds"] > 0
    # a second committee first marks the full region for a deferred
    # recycle, then collapses once the recycle applied
    for _ in range(4):
        r4, _, _, c4 = t.resolve_sets(b)
        if c4:
            break
    assert c4 == 1 and len(r4[0]) == 1
    assert t.status()["aggregate_resets"] >= 1
    r5, _, _, _ = t.resolve_sets(a)
    assert len(r5[0]) in (1, 3)


def test_mid_batch_region_full_never_recycles_held_slots():
    _sks, _jcache, cache = _caches(6)
    t = _table(cache, max_aggregates=1, agg_min_repeats=1)
    a = _committee(cache, [0, 1, 2])
    b = _committee(cache, [3, 4, 5])
    ra, _, _, ca = t.resolve_sets([a])
    assert ca == 1
    slot_a = ra[0][0]
    rr, _dev, agg, _cc = t.resolve_sets([a, b])
    assert rr[0] == [slot_a], "A must keep its cached slot"
    assert len(rr[1]) == 3, "B must ship K indices, not a recycled slot"
    want_a = _row(_host_sum(cache, [0, 1, 2]))
    assert np.array_equal(agg[slot_a - 1024].numpy(), want_a)
    # the recycle lands in a LATER batch; the earlier snapshot is a tensor
    # the insert never wrote, so it still serves A's sum
    rb, _, agg2, cb = t.resolve_sets([b])
    assert cb == 1 and agg2 is not agg
    assert np.array_equal(agg[slot_a - 1024].numpy(), want_a)
    assert np.array_equal(agg2[rb[0][0] - 1024].numpy(),
                          _row(_host_sum(cache, [3, 4, 5])))


def test_infinity_aggregate_is_never_cached():
    _sks, _jcache, cache = _caches(2)
    p = cache.pubkeys[0].point
    cache.pubkeys[1] = types.SimpleNamespace(point=G1Point(p.x, -p.y))
    t = _table(cache, agg_min_repeats=1)
    for _ in range(3):
        resolved, _, _, collapsed = t.resolve_sets([_committee(cache, [0, 1])])
        assert collapsed == 0 and len(resolved[0]) == 2
    assert t.status()["aggregates_resident"] == 0


def test_signature_set_indices_and_covers_sets():
    sks, _jcache, cache = _caches(2)
    t = _table(cache)
    sig = bls.Signature.infinity()
    ok = bls.SignatureSet.single_pubkey(sig, cache.pubkeys[0], MSG, signing_index=0)
    assert ok.signing_indices == [0]
    assert bls.SignatureSet.multiple_pubkeys(
        sig, cache.pubkeys, MSG, signing_indices=[0, 1]).signing_indices == [0, 1]
    with pytest.raises(bls.BlsError):
        bls.SignatureSet.multiple_pubkeys(sig, cache.pubkeys, MSG, signing_indices=[0])
    assert bls.SignatureSet.single_pubkey(sig, cache.pubkeys[0], MSG).signing_indices is None
    assert t.covers_sets([ok]) and t.covers_sets([_committee(cache, [0, 1])])
    stale = bls.SignatureSet.single_pubkey(sig, cache.pubkeys[0], MSG, signing_index=99)
    assert not t.covers_sets([stale])
    foreign = bls.PublicKey.deserialize(cache.pubkeys[1].serialize())
    assert not t.covers_sets([bls.SignatureSet.single_pubkey(sig, foreign, MSG, 1)])
    assert not kt.DeviceKeyTable(cache, device="cpu").covers_sets([ok])


def test_concurrent_resolve_always_gathers_the_right_sum():
    """8 threads x overlapping committees x a 2-slot region in churn:
    whatever each resolve returns, gathering its rows from ITS OWN
    snapshot reproduces exactly its committee's points or sum."""
    _sks, _jcache, cache = _caches(8)
    t = _table(cache, max_aggregates=2, agg_min_repeats=1)
    committees = [[0, 1, 2], [3, 4, 5], [2, 3, 6], [1, 5, 7]]
    expected = {ci: _row(_host_sum(cache, m)) for ci, m in enumerate(committees)}
    errors = []

    def worker(tid):
        try:
            for rep in range(25):
                ci = (tid + rep) % len(committees)
                resolved, dev, agg, _c = t.resolve_sets([_committee(cache, committees[ci])])
                idx = torch.tensor([resolved[0]], dtype=torch.int32)
                rows = dbls._gather_fn(dev, agg, idx)[0].numpy()
                if len(resolved[0]) == 1:
                    assert np.array_equal(rows[0], expected[ci]), f"committee {ci}"
                else:
                    for r, i in zip(rows, committees[ci]):
                        assert np.array_equal(r, _row(cache.pubkeys[i].point))
        except Exception as e:  # noqa: BLE001 (surfaced below)
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors


def test_capacity_growth_rebases_cached_aggregate_indices():
    _sks, _jcache, cache = _caches(3)
    t = _table(cache, agg_min_repeats=1)
    committee = [_committee(cache, [0, 1, 2])]
    r1, dev1, _, c1 = t.resolve_sets(committee)
    assert c1 == 1 and r1[0][0] == 1024
    _extend(cache, 1022)
    assert t.sync(reason="delta") == 1022
    st = t.status()
    assert st["validator_capacity"] == 4096
    assert st["upload_bytes"]["delta"] == 1022 * kt.G1_ROW_BYTES  # growth uploads nothing
    r2, dev, agg, c2 = t.resolve_sets(committee)
    assert c2 == 1 and r2[0][0] == 4096  # rebased, same slot 0
    assert dev is not dev1 and torch.equal(dev[:3], dev1[:3])
    assert tuple(dev1.shape) == (1024, 2, fp.NL)  # the old snapshot is intact
    assert np.array_equal(agg[0].numpy(), _row(_host_sum(cache, [0, 1, 2])))
    assert np.array_equal(dev[1024].numpy(), _row(cache.pubkeys[1024].point))


# ---------------------------------------------------------------------------
# Epoch-tagged retention and insert_precomputed (port's slot clock)
# ---------------------------------------------------------------------------


def test_insert_precomputed_outcomes_and_first_sighting_k1(manual_clock):
    _sks, _jcache, cache = _caches(8)
    t = _table(cache, agg_min_repeats=2)
    committee = [0, 1, 2, 3]
    assert t.insert_precomputed(committee, _host_sum(cache, committee)) == "inserted"
    st = t.status()
    assert st["aggregates_resident"] == 1 and st["aggregate_precomputed"] == 1
    assert st["aggregate_inserts"] == 0 and st["aggregate_epochs"] == [1]
    resolved, _dev, _agg, collapsed = t.resolve_sets([_committee(cache, committee)])
    assert collapsed == 1 and len(resolved[0]) == 1, "first sighting ships K=1"
    assert t.status()["aggregate_hits"] == 1
    assert t.insert_precomputed(committee, _host_sum(cache, committee), epoch=5) == "exists"
    assert t.status()["aggregate_epochs"] == [5]
    assert t.insert_precomputed([3], _host_sum(cache, [0, 1])) == "disabled"
    assert kt.DeviceKeyTable(cache, max_aggregates=0, device="cpu").insert_precomputed(
        [0, 1], None) == "disabled"
    assert t.insert_precomputed([4, 5], None) == "infinity"
    assert t.insert_precomputed([4, 5], _host_sum(cache, [4, 5])) == "never_cache"
    assert kt.DeviceKeyTable(cache, device="cpu").insert_precomputed(
        committee, _host_sum(cache, committee)) == "unsynced"


def test_two_epoch_retention_evicts_instead_of_wholesale_reset(manual_clock):
    _sks, _jcache, cache = _caches(8)
    t = _table(cache, agg_min_repeats=1)
    a, b, c = [0, 1], [2, 3], [4, 5]
    assert t.insert_precomputed(a, _host_sum(cache, a), epoch=0) == "inserted"
    assert t.insert_precomputed(b, _host_sum(cache, b), epoch=1) == "inserted"
    manual_clock.set_slot(32)   # epoch 1: nothing evicts
    t.resolve_sets([_committee(cache, a)])
    assert t.status()["aggregate_evictions"] == 0
    manual_clock.set_slot(64)   # epoch 2: A (tag 0) evicts, B stays
    _r, _, _, collapsed = t.resolve_sets([_committee(cache, b)])
    assert collapsed == 1
    st = t.status()
    assert st["aggregates_resident"] == 1 and st["aggregate_evictions"] == 1
    assert st["aggregate_free_slots"] == 1 and st["aggregate_epochs"] == [1]
    assert st["aggregate_resets"] == 0
    assert t.insert_precomputed(c, _host_sum(cache, c), epoch=3) == "inserted"
    assert t.status()["aggregate_free_slots"] == 0
    _r1, _, _, c1 = t.resolve_sets([_committee(cache, a)])
    assert c1 == 1 and t.status()["aggregate_resets"] == 0


def test_full_region_declines_precompute_without_reset(manual_clock):
    _sks, _jcache, cache = _caches(4)
    t = _table(cache, max_aggregates=1, agg_min_repeats=1)
    assert t.insert_precomputed([0, 1], _host_sum(cache, [0, 1]), epoch=0) == "inserted"
    assert t.insert_precomputed([2, 3], _host_sum(cache, [2, 3]), epoch=0) == "full"
    assert t.status()["aggregate_resets"] == 0
    manual_clock.set_slot(64)
    assert t.insert_precomputed([2, 3], _host_sum(cache, [2, 3]), epoch=2) == "inserted"


@pytest.mark.parametrize("t_unix", [0.0, 11.9, 12.0, 383.0, 384.5, 1e9 + 0.25])
def test_slot_clock_copy_matches_jax(t_unix):
    ours = slot_clock.SlotClock(genesis_time=5, seconds_per_slot=12)
    ref = jslot_clock.SlotClock(genesis_time=5, seconds_per_slot=12)
    assert ours.slot_at(t_unix) == ref.slot_at(t_unix)
    assert ours.epoch_at(t_unix) == ref.epoch_at(t_unix)
    frac = slot_clock.SlotClock(0, 0.5, slots_per_epoch=4)
    assert frac.slot_at(t_unix) == jslot_clock.SlotClock(0, 0.5, 4).slot_at(t_unix)
    m = slot_clock.ManualSlotClock()
    m.set_slot(70)
    assert (m.now(), m.current_epoch(), m.first_slot_of_epoch(2)) == (70, 2, 64)
    prev = slot_clock.set_clock(m)
    assert slot_clock.get_clock() is m
    assert slot_clock.set_clock(prev) is m


def test_process_global_table_seam():
    _sks, _jcache, cache = _caches(1)
    t = kt.DeviceKeyTable(cache, device="cpu")
    kt.set_table(t)
    try:
        assert kt.get_table() is t and kt.get_active_table() is None  # empty
        t.sync(reason="startup")
        assert kt.get_active_table() is t
        kt.clear_table(kt.DeviceKeyTable(cache, device="cpu"))  # not ours
        assert kt.get_table() is t
        kt.clear_table(t)
        assert kt.get_table() is None
    finally:
        kt.clear_table()


# ---------------------------------------------------------------------------
# Gather and the indexed packer against the JAX package
# ---------------------------------------------------------------------------


def test_gather_matches_jax_gather():
    _sks, _jcache, cache = _caches(6)
    t = _table(cache, max_aggregates=4, agg_min_repeats=1)
    t.resolve_sets([_committee(cache, [0, 1]), _committee(cache, [2, 3, 4])])
    dev, agg = t.device_arrays()
    # validator rows, both aggregate slots, an empty slot, and indices past
    # either region (clipped)
    idx = np.array([[0, 5, 1024, 1025], [1026, 1023, 9999, 3]], np.int32)
    got = dbls._gather_fn(dev, agg, torch.from_numpy(idx))
    want = np.array(jdbls._gather_fn(dev.numpy(), agg.numpy(), idx))
    assert torch.equal(got, torch.from_numpy(want))
    assert np.array_equal(got[0, 2].numpy(), _row(_host_sum(cache, [0, 1])))


def _signed_sets(sks, jcache, pcache, wrong_signer=False, foreign=False, sig1=None):
    """(JAX sets, port sets), B = 2, K <= 2: set 0 signed by key 0 on M1,
    set 1 by keys 0 and 1 (the aggregate secret) on M2."""
    m1, m2 = b"\x31" * 32, b"\x32" * 32
    raw0 = sks[1 if wrong_signer else 0].sign(m1).serialize()
    raw1 = sig1 or jbls.SecretKey((sks[0].k + sks[1].k) % R).sign(m2).serialize()
    jsets = [
        (jbls.Signature.deserialize(raw0), [jcache.pubkeys[0].point], m1),
        (jbls.Signature.deserialize(raw1), [p.point for p in jcache.pubkeys[:2]], m2),
    ]
    p0 = pcache.pubkeys[0].point
    if foreign:
        p0 = G1Point(Fq(p0.x.n), Fq(p0.y.n))  # equal value, another object
    psets = [
        (bls.Signature.deserialize(raw0), [p0], m1),
        (bls.Signature.deserialize(raw1), [p.point for p in pcache.pubkeys[:2]], m2),
    ]
    return jsets, psets


def test_indexed_planes_match_jax_and_gather_matches_raw(monkeypatch):
    sks, jcache, pcache = _caches(5)
    t = _table(pcache, agg_min_repeats=1)
    jsets, psets = _signed_sets(sks, jcache, pcache)
    resolved, dev, agg, collapsed = t.resolve_sets(psets)
    assert collapsed == 1 and resolved == [[0], [1024]]
    monkeypatch.setattr(jdbls, "_rand_scalar_words", seeded_words(SEED))
    want = jdbls.pack_signature_sets_indexed(jsets, resolved, pad_b=4, pad_k=2, pad_m=2)
    got = dbls.pack_signature_sets_indexed(
        psets, resolved, pad_b=4, pad_k=2, pad_m=2,
        rand_words=seeded_words(SEED), device="cpu")
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.numpy().tobytes() == w.tobytes()
    with pytest.raises(ValueError):
        dbls.pack_signature_sets_indexed(psets, resolved[:1], device="cpu")

    # the uncollapsed resolve: gathered planes equal the raw pack's on live
    # slots, and every other plane is byte-identical
    rows = [[0], [0, 1]]
    idx_args = dbls.pack_signature_sets_indexed(
        psets, rows, pad_b=4, pad_k=2, rand_words=seeded_words(1), device="cpu")
    raw_args = dbls.pack_signature_sets_raw(
        psets, pad_b=4, pad_k=2, rand_words=seeded_words(1), device="cpu")
    gathered = dbls._gather_fn(dev, agg, idx_args[0])
    mask = idx_args[1]
    assert torch.equal(mask, raw_args[1])
    assert torch.equal(gathered[mask], raw_args[0][mask])
    for a, b in zip(idx_args[2:], raw_args[2:]):
        assert torch.equal(a, b)
    # the pubkey plane is 5 bytes a slot instead of 257
    assert dbls._nbytes(idx_args[:2]) * 50 < dbls._nbytes(raw_args[:2])


def test_table_on_another_device_raises_never_gathers():
    _sks, _jcache, cache = _caches(2)
    t = kt.DeviceKeyTable(cache, device="meta")
    t.sync(reason="startup")
    dev, agg = t.device_arrays()
    assert dev.device.type == "meta"
    pk_idx = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(kt.KeyTableError):
        dbls.verify_batch_raw_staged_gather(dev, agg, pk_idx, *([None] * 7))


def test_backend_refuses_a_table_on_another_device_before_resolving():
    """A table on another device than the backend's raises before the
    batch is resolved: no aggregate is inserted and no set is counted."""
    _sks, _jcache, cache = _caches(3)
    t = kt.DeviceKeyTable(cache, device="meta", agg_min_repeats=1)
    t.sync(reason="startup")
    sig = bls.Signature.deserialize(g2_generator().compress())
    sets = [(sig, [pk.point for pk in cache.pubkeys], MSG)]
    before = t.status()
    kt.set_table(t)
    try:
        with pytest.raises(kt.KeyTableError):
            dbls.CudaBackend(device="cpu").verify_signature_sets(sets)
    finally:
        kt.clear_table(t)
    after = t.status()
    assert after["sets"] == before["sets"]
    assert after["aggregate_inserts"] == before["aggregate_inserts"] == 0
    assert after["aggregates_resident"] == 0


# ---------------------------------------------------------------------------
# Gathered verdicts against cpu-native (the C verifier)
# ---------------------------------------------------------------------------


def _non_subgroup_sig() -> bytes:
    x0 = 5
    while True:
        x = Fq2.from_ints(x0, 1)
        y = (x.square() * x + Fq2.from_ints(*B2)).sqrt()
        if y is not None:
            pt = G2Point(x, y)
            assert not pt.in_subgroup()
            return pt.compress()
        x0 += 1


@pytest.fixture(scope="module")
def keyset():
    return _caches(2, seed=300)


@pytest.mark.parametrize("case", ["valid", "wrong_signer", "collapsed", "poisoned_collapsed",
                                  "foreign_key_raw"])
def test_gathered_verdicts_match_cpu_native(keyset, case):
    sks, jcache, pcache = keyset
    t = _table(pcache, agg_min_repeats=1 if "collapsed" in case else 2)
    sig1 = _non_subgroup_sig() if case == "poisoned_collapsed" else None
    jsets, psets = _signed_sets(sks, jcache, pcache, wrong_signer=case == "wrong_signer",
                                foreign=case == "foreign_key_raw", sig1=sig1)
    backend = dbls.CudaBackend(device="cpu", rand_words=seeded_words(SEED))
    kt.set_table(t)
    try:
        port = backend.verify_signature_sets(psets)
    finally:
        kt.clear_table(t)
    native = NativeBackend().verify_signature_sets(jsets)
    assert port is native is (case in ("valid", "collapsed", "foreign_key_raw"))
    lb, sets = backend.last_batch, t.status()["sets"]
    if case == "foreign_key_raw":
        assert lb["path"] == "raw_staged" and sets["raw"] == 2
        assert lb["pubkey_bytes"] == 2 * 2 * (2 * fp.NL * 4 + 1)
    else:
        assert lb["path"] == "raw_gather" and sets["raw"] == 0
        assert lb["pubkey_bytes"] == 2 * lb["k"] * 5
    if "collapsed" in case:
        assert lb["collapsed"] == 1 and lb["k"] == 1
        assert sets == {"indexed": 1, "collapsed": 1, "raw": 0}
    elif case != "foreign_key_raw":
        assert lb["collapsed"] == 0 and lb["k"] == 2
