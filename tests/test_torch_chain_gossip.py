"""The port's gossip verifiers against the JAX package's, with real
signatures on ``cpu-native`` in both packages.

Two chains (one per package) on one altair genesis of 16 validators
(minimal preset) import the same two real-signed blocks; then the same
gossip, built and signed in the JAX types and carried to the port as
bytes, goes through both chains' batch verifiers. Exact equality of every
verdict and error kind:

* unaggregated attestations: valid, signed by another validator's key,
  a duplicate in the batch, a second batch repeating a valid one, one
  from a future slot, one voting for an unknown head block;
* sync committee messages: valid, wrongly signed, a duplicate, an
  unknown validator, a slot outside the window.

Then one gossip batch goes through the port's ``VerificationScheduler``
on ``CudaBackend(device="cpu")`` (one verify, about 7 s), and a port chain with no
backend chosen uses the registry's default, ``cuda``: on this CPU-only
box its first block import raises instead of verifying on the host.
"""

from __future__ import annotations

import functools

import pytest
import torch

from lighthouse_tpu.beacon_chain import BeaconChain as JChain
from lighthouse_tpu.beacon_chain import (
    batch_verify_sync_committee_messages as jbatch_sync,
)
from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.state_transition import store_replayer as jreplayer
from lighthouse_tpu.state_transition.helpers import CommitteeCache
from lighthouse_tpu.store import HotColdDB as JDB, MemoryStore as JMem
from lighthouse_tpu.testing.harness import StateHarness as JHarness
from lighthouse_tpu.types import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_SYNC_COMMITTEE,
    compute_signing_root,
    get_domain,
    types_for as jtypes_for,
)
from lighthouse_tpu.types.chain_spec import minimal_spec as jminimal_spec
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as JClock
from lighthouse_tpu_torch.beacon_chain import BeaconChain as TChain
from lighthouse_tpu_torch.beacon_chain import (
    batch_verify_sync_committee_messages as tbatch_sync,
)
from lighthouse_tpu_torch.crypto import backend as tbackend
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch.state_transition import store_replayer as treplayer
from lighthouse_tpu_torch.store import HotColdDB as TDB, MemoryStore as TMem
from lighthouse_tpu_torch.types import types_for as ttypes_for
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as tminimal_spec
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as TClock
from lighthouse_tpu_torch.verification_service import VerificationScheduler

N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _native_backends():
    saved = [(m, m._active, m._active_name) for m in (jbackend, tbackend)]
    jbackend.set_backend("cpu-native")
    tbackend.set_backend("cpu-native")
    yield
    for m, active, name in saved:
        m._active, m._active_name = active, name


@pytest.fixture(scope="module")
def signed():
    """The JAX harness (its genesis costs about 13 s: the sync committee's
    keys are decompressed in pure Python) and two real-signed blocks, as
    bytes."""
    saved = (jbackend._active, jbackend._active_name)
    jbackend.set_backend("cpu-native")
    try:
        h = JHarness(JMINIMAL, jminimal_spec(altair_fork_epoch=0), N, fork_name="altair")
        genesis = type(h.state).encode(h.state)
        blocks = [type(b).encode(b) for b in h.extend_chain(2, strategy="none")]
    finally:
        jbackend._active, jbackend._active_name = saved
    return h, genesis, blocks


def _chains(genesis: bytes, blocks, port_only: bool = False):
    """(JAX chain, port chain) on ``genesis`` with ``blocks`` imported,
    both clocks at the last block's slot."""
    out = []
    for pkg in ("torch",) if port_only else ("jax", "torch"):
        types_for, spec, preset, DB, Mem, replayer, Clock, Chain = (
            (jtypes_for, jminimal_spec, JMINIMAL, JDB, JMem, jreplayer, JClock, JChain)
            if pkg == "jax" else
            (ttypes_for, tminimal_spec, TMINIMAL, TDB, TMem, treplayer, TClock, TChain))
        t, sp = types_for(preset), spec(altair_fork_epoch=0)
        state = t.state["altair"].decode(genesis)
        clock = Clock(state.genesis_time, sp.seconds_per_slot, preset.SLOTS_PER_EPOCH)
        chain = Chain(preset, sp, t, DB(Mem(), t, sp, replayer(preset, sp)), state,
                      slot_clock=clock)
        for data in blocks:
            sb = t.signed_block["altair"].decode(data)
            clock.set_slot(sb.message.slot)
            chain.process_block(sb)
        out.append((chain, t))
    return out


def _attestations(h, state):
    """Unaggregated attestations (JAX types, bytes) of slots 1 and 2, each
    committee member's own, then the bad ones. Returns (name, bytes)."""
    t = h.t
    cache = CommitteeCache(JMINIMAL, state, 0)
    domain = get_domain(h.spec, state, DOMAIN_BEACON_ATTESTER, 0)
    out = []
    for slot in (1, 2):
        for agg in h.attestations_for_slot(state, slot):
            size = len(agg.aggregation_bits)
            root = compute_signing_root(t.AttestationData, agg.data, domain)
            for pos, v in enumerate(cache.committee(slot, agg.data.index)):
                att = t.Attestation(aggregation_bits=[i == pos for i in range(size)],
                                    data=agg.data, signature=h.keys[int(v)].sign(root).serialize())
                out.append((f"valid {slot}/{pos}", att))
    first = out[0][1]
    tampered = t.Attestation.decode(t.Attestation.encode(out[-1][1]))
    tampered.signature = h.keys[(N - 1)].sign(b"\x11" * 32).serialize()
    future = t.Attestation.decode(t.Attestation.encode(first))
    future.data.slot = 5
    unknown = t.Attestation.decode(t.Attestation.encode(first))
    unknown.data.beacon_block_root = b"\xaa" * 32
    out = out[:-1] + [("tampered", tampered), ("duplicate", first), ("future", future),
                      ("unknown head", unknown)]
    return [(name, t.Attestation.encode(a)) for name, a in out]


def _kinds(results):
    return ["ok" if not isinstance(r, Exception) else r.kind for r in results]


def test_attestation_verdicts_and_error_kinds_equal_jax(signed):
    h, genesis, blocks = signed
    (jc, jt), (tc, tt) = _chains(genesis, blocks)
    atts = _attestations(h, jc.head_state)
    got = {}
    for chain, t in ((jc, jt), (tc, tt)):
        batch = [t.Attestation.decode(b) for _n, b in atts]
        first = chain.batch_verify_unaggregated_attestations_for_gossip(batch)
        again = chain.batch_verify_unaggregated_attestations_for_gossip(batch[:1])
        got[chain is tc] = (_kinds(first), _kinds(again))
    assert got[True] == got[False]
    kinds, again = got[True]
    names = [n for n, _b in atts]
    assert dict(zip(names, kinds)) == {
        **{n: "ok" for n in names if n.startswith("valid")},
        "tampered": "InvalidSignature", "duplicate": "PriorAttestationKnown",
        "future": "OutsideSlotRange", "unknown head": "UnknownHeadBlock"}
    assert again == ["PriorAttestationKnown"]


def _sync_messages(h, chain):
    t, state = h.t, chain.head_state
    root = chain.head_block_root
    signing_root = compute_signing_root(
        None, root, get_domain(h.spec, state, DOMAIN_SYNC_COMMITTEE, 0))
    index_of = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    members = list(dict.fromkeys(index_of[bytes(pk)]
                                 for pk in state.current_sync_committee.pubkeys))

    def msg(vi, slot=2, key=None, sig_root=signing_root):
        return t.SyncCommitteeMessage(
            slot=slot, beacon_block_root=root, validator_index=vi,
            signature=h.keys[key if key is not None else vi].sign(sig_root).serialize())

    out = [(f"valid {v}", msg(v)) for v in members[:4]]
    out += [("tampered", msg(members[4], key=members[5])), ("duplicate", msg(members[0])),
            ("unknown validator", msg(members[6])), ("outside window", msg(members[7], slot=7))]
    out[-2][1].validator_index = 99
    return [(n, t.SyncCommitteeMessage.encode(m)) for n, m in out]


def test_sync_message_verdicts_and_error_kinds_equal_jax(signed):
    h, genesis, blocks = signed
    (jc, jt), (tc, tt) = _chains(genesis, blocks)
    msgs = _sync_messages(h, jc)
    jk = _kinds(jbatch_sync(jc, [jt.SyncCommitteeMessage.decode(b) for _n, b in msgs]))
    tk = _kinds(tbatch_sync(tc, [tt.SyncCommitteeMessage.decode(b) for _n, b in msgs]))
    assert tk == jk
    assert dict(zip([n for n, _b in msgs], tk)) == {
        **{n: "ok" for n, _b in msgs if n.startswith("valid")},
        "tampered": "InvalidSignature", "duplicate": "PriorMessageKnown",
        "unknown validator": "UnknownValidator", "outside window": "OutsideSlotWindow"}


def test_a_gossip_batch_through_the_scheduler_on_the_cpu_backend(signed):
    """Two valid attestations (two messages) through the port's scheduler
    on ``CudaBackend(device="cpu")``: one fused verify (a rejection would
    cost a bisection, about 30 s here; the cpu-native cases above pin the
    rejections), the verdicts of the JAX chain on ``cpu-native``."""
    h, genesis, blocks = signed
    (jc, jt), (tc, tt) = _chains(genesis, blocks)
    atts = _attestations(h, jc.head_state)
    pick = [b for n, b in atts if n in ("valid 1/0", "valid 2/0")]
    want = _kinds(jc.batch_verify_unaggregated_attestations_for_gossip(
        [jt.Attestation.decode(b) for b in pick]))
    sched = VerificationScheduler(
        verify_fn=functools.partial(tbls.verify_signature_sets, device="cpu"),
        deadline_ms=5.0).start()
    tc.verification_scheduler = sched
    try:
        got = _kinds(tc.batch_verify_unaggregated_attestations_for_gossip(
            [tt.Attestation.decode(b) for b in pick]))
        st = sched.status()
    finally:
        sched.stop()
    assert got == want == ["ok", "ok"]
    assert st["fused_batches_total"] == 1 and st["bisections_total"] == 0


def test_a_chain_with_no_backend_chosen_uses_cuda_and_raises_here(signed, monkeypatch):
    _h, genesis, blocks = signed
    monkeypatch.delenv(tbackend.ENV, raising=False)
    tbackend._active = tbackend._active_name = None
    ((tc, tt),) = _chains(genesis, [], port_only=True)
    sb = tt.signed_block["altair"].decode(blocks[0])
    tc.slot_clock.set_slot(sb.message.slot)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tc.process_block(sb)
    assert tbackend.active_name() == "cuda"
    assert tc.head_state.slot == 0  # nothing was imported
