"""The port's beacon chain against the JAX package's on ``fake`` (the
reference's fake-crypto seam: the pipeline is under test, the signature
math is covered by the gossip and crypto files).

Only bytes cross between the packages: the JAX harness's genesis and
fake-signed blocks are decoded in the port. Exact equality throughout:

* blocks imported one by one through ``process_block`` give equal head
  roots and head-state roots after every block; a fresh chain imports the
  same blocks through ``process_chain_segment`` to the same head;
* ``HotColdDB`` loads every imported state, by snapshot or by replaying
  blocks onto one, to the JAX store's state roots;
* a device key table over the chain's real ``ValidatorPubkeyCache`` (on
  the CPU) syncs at startup and takes new validators admitted through
  ``import_new_pubkeys`` as a delta, through the cache's ``subscribe``
  listener, keyed by the cache's own point objects.
"""

from __future__ import annotations

import copy

import pytest
import torch

from lighthouse_tpu import ssz as jssz
from lighthouse_tpu.beacon_chain import BeaconChain as JChain
from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.state_transition import store_replayer as jreplayer
from lighthouse_tpu.store import HotColdDB as JDB, MemoryStore as JMem
from lighthouse_tpu.testing.harness import StateHarness as JHarness
from lighthouse_tpu.types import types_for as jtypes_for
from lighthouse_tpu.types.chain_spec import minimal_spec as jminimal_spec
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as JClock
from lighthouse_tpu_torch import ssz as tssz
from lighthouse_tpu_torch.beacon_chain import BeaconChain as TChain
from lighthouse_tpu_torch.crypto import backend as tbackend
from lighthouse_tpu_torch.crypto.device import key_table
from lighthouse_tpu_torch.state_transition import store_replayer as treplayer
from lighthouse_tpu_torch.state_transition.genesis import interop_secret_key
from lighthouse_tpu_torch.store import HotColdDB as TDB, MemoryStore as TMem
from lighthouse_tpu_torch.testing.harness import native_pubkey
from lighthouse_tpu_torch.types import types_for as ttypes_for
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as tminimal_spec
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as TClock

BLOCKS = 12
SNAPSHOT = 8  # slots per hot snapshot: states between snapshots replay


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
def jax_blocks():
    """The JAX harness's genesis and BLOCKS fake-signed blocks (8
    validators, phase0), as bytes."""
    saved = (jbackend._active, jbackend._active_name)
    jbackend.set_backend("fake")
    try:
        h = JHarness(JMINIMAL, jminimal_spec(), 8, fake_sign=True)
        genesis = type(h.state).encode(h.state)
        blocks = [type(b).encode(b) for b in h.extend_chain(BLOCKS, strategy="none")]
    finally:
        jbackend._active, jbackend._active_name = saved
    return genesis, blocks


def _jax_chain(genesis: bytes):
    t = jtypes_for(JMINIMAL)
    spec = jminimal_spec()
    state = t.state["phase0"].decode(genesis)
    db = JDB(JMem(), t, spec, jreplayer(JMINIMAL, spec), slots_per_snapshot=SNAPSHOT)
    clock = JClock(state.genesis_time, spec.seconds_per_slot)
    return JChain(JMINIMAL, spec, t, db, state, slot_clock=clock), clock, t


def _port_chain(genesis: bytes):
    t = ttypes_for(TMINIMAL)
    spec = tminimal_spec()
    state = t.state["phase0"].decode(genesis)
    db = TDB(TMem(), t, spec, treplayer(TMINIMAL, spec), slots_per_snapshot=SNAPSHOT)
    clock = TClock(state.genesis_time, spec.seconds_per_slot)
    return TChain(TMINIMAL, spec, t, db, state, slot_clock=clock), clock, t


@pytest.fixture(scope="module")
def imported(jax_blocks):
    """Both chains after importing every block one by one: the chains and
    the (head root, head-state root) pairs after each block."""
    saved = [(m, m._active, m._active_name) for m in (jbackend, tbackend)]
    jbackend.set_backend("fake")
    tbackend.set_backend("fake")
    try:
        genesis, blocks = jax_blocks
        (jc, jclock, jt), (tc, tclock, tt) = _jax_chain(genesis), _port_chain(genesis)
        heads = []
        for data in blocks:
            jb = jt.signed_block["phase0"].decode(data)
            tb = tt.signed_block["phase0"].decode(data)
            jclock.set_slot(jb.message.slot)
            tclock.set_slot(tb.message.slot)
            jroot = jc.process_block(jc.verify_block_for_gossip(jb))
            troot = tc.process_block(tc.verify_block_for_gossip(tb))
            heads.append(((jroot, jc.head_block_root, jssz.hash_tree_root(jc.head_state)),
                          (troot, tc.head_block_root, tssz.hash_tree_root(tc.head_state))))
    finally:
        for m, active, name in saved:
            m._active, m._active_name = active, name
    return jc, tc, heads


def test_block_import_gives_equal_heads_and_state_roots(imported):
    jc, tc, heads = imported
    assert len(heads) == BLOCKS
    for slot, (j, t) in enumerate(heads, start=1):
        assert j == t, f"slot {slot}"
        assert t[0] == t[1]  # each block became the head
    assert tc.head_state.slot == BLOCKS
    assert type(tc.head_state).encode(tc.head_state) == type(jc.head_state).encode(jc.head_state)


def test_chain_segment_import_reaches_the_same_head(jax_blocks, imported):
    genesis, blocks = jax_blocks
    _jc, _tc, heads = imported
    (jc, jclock, jt), (tc, tclock, tt) = _jax_chain(genesis), _port_chain(genesis)
    jclock.set_slot(BLOCKS)
    tclock.set_slot(BLOCKS)
    jroots = jc.process_chain_segment([jt.signed_block["phase0"].decode(b) for b in blocks])
    troots = tc.process_chain_segment([tt.signed_block["phase0"].decode(b) for b in blocks])
    assert troots == jroots == [t[0] for _j, t in heads]
    assert tc.head_block_root == jc.head_block_root == heads[-1][1][1]
    assert tssz.hash_tree_root(tc.head_state) == heads[-1][1][2]


def test_hot_cold_db_replay_gives_the_jax_stores_states(imported):
    jc, tc, _heads = imported
    # every block's post-state, walking back from the head: stored as a
    # snapshot or as a summary the store replays blocks onto a snapshot for
    replayed = 0
    root = tc.head_block_root
    while True:
        tb, jb = tc.store.get_block(root), jc.store.get_block(root)
        if tb is None:
            break
        assert type(tb).encode(tb) == type(jb).encode(jb)
        state_root = bytes(tb.message.state_root)
        ts, js = tc.store.get_state(state_root), jc.store.get_state(state_root)
        assert tssz.hash_tree_root(ts) == jssz.hash_tree_root(js) == state_root
        replayed += ts.slot % SNAPSHOT != 0
        root = bytes(tb.message.parent_root)
    assert replayed >= BLOCKS - BLOCKS // SNAPSHOT - 1


def test_key_table_over_the_pubkey_cache_syncs_admissions_as_deltas(jax_blocks):
    genesis, _blocks = jax_blocks
    tc, _clock, _t = _port_chain(genesis)
    cache = tc.pubkey_cache
    table = key_table.DeviceKeyTable(cache, device="cpu")
    try:
        assert table.sync(reason="startup") == 8
        calls = []

        def listener(_cache, _t=table):
            calls.append(_t.sync_or_schedule(reason="delta"))

        cache.subscribe(listener)
        grown = copy.deepcopy(tc.head_state)
        for i in (8, 9, 10):  # deposits' validators, as a block's import admits them
            v = copy.deepcopy(grown.validators[0])
            v.pubkey = native_pubkey(interop_secret_key(i))
            grown.validators.append(v)
        cache.import_new_pubkeys(grown)
        st = table.status()
        assert calls == [3] and len(cache) == 11
        assert st["validators_resident"] == 11 and st["identity_pinned"]
        assert st["upload_bytes"].get("delta", 0) > 0
        # the table resolves the cache's own point objects, old and new
        for i in range(11):
            assert table.index_of_point(cache.get(i).point) == i
        cache.unsubscribe(listener)
        grown.validators.append(copy.deepcopy(grown.validators[1]))
        grown.validators[-1].pubkey = native_pubkey(interop_secret_key(11))
        cache.import_new_pubkeys(grown)
        assert calls == [3] and table.status()["validators_resident"] == 11
    finally:
        table.close()
