"""The port's state transition against the JAX package's, through the two
packages' ``StateHarness``.

Exact equality throughout, and only bytes cross between the packages:

* on ``fake`` (fake-signed blocks), both harnesses build the same chain
  over two epochs of the minimal preset: equal state roots after every
  slot, equal blocks, in ``phase0`` and ``altair``;
* the shuffle and the committees of every epoch of that chain are equal;
* three blocks with real signatures (the port's harness signs with its
  default, the pure-Python oracle; the JAX package's with its own) are
  byte-equal, import on ``cpu-native`` in both packages, and each block's
  signature sets are equal: messages, pubkey bytes, signature bytes.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from lighthouse_tpu import ssz as jssz
from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.state_transition import helpers as jhelpers
from lighthouse_tpu.state_transition import shuffle as jshuffle
from lighthouse_tpu.state_transition.block import state_pubkey_resolver as jresolver
from lighthouse_tpu.state_transition.signature_sets import (
    BlockSignatureAccumulator as JAccumulator,
)
from lighthouse_tpu.state_transition.slot import partial_state_advance as jadvance
from lighthouse_tpu.testing.harness import StateHarness as JHarness
from lighthouse_tpu.types.chain_spec import minimal_spec as jminimal_spec
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu_torch import ssz as tssz
from lighthouse_tpu_torch.crypto import backend as tbackend
from lighthouse_tpu_torch.state_transition import helpers as thelpers
from lighthouse_tpu_torch.state_transition import shuffle as tshuffle
from lighthouse_tpu_torch.state_transition.block import state_pubkey_resolver as tresolver
from lighthouse_tpu_torch.state_transition.signature_sets import (
    BlockSignatureAccumulator as TAccumulator,
)
from lighthouse_tpu_torch.state_transition.slot import partial_state_advance as tadvance
from lighthouse_tpu_torch.testing.harness import StateHarness as THarness, native_pubkey
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as tminimal_spec
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL

SLOTS = 17  # two epoch boundaries of the minimal preset


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _restore_backends():
    """Both registries are process-global: each case sets its own and
    leaves them as it found them."""
    saved = [(m, m._active, m._active_name) for m in (jbackend, tbackend)]
    yield
    for m, active, name in saved:
        m._active, m._active_name = active, name


def _harnesses(fork: str, n: int, **port_kw):
    kw = dict(altair_fork_epoch=0 if fork == "altair" else None)
    j = JHarness(JMINIMAL, jminimal_spec(**kw), n, fork_name=fork, **port_kw.pop("jax", {}))
    t = THarness(TMINIMAL, tminimal_spec(**kw), n, fork_name=fork, **port_kw)
    return j, t


def _bytes(x) -> bytes:
    return type(x).encode(x)


@pytest.fixture(scope="module")
def fake_chains():
    """Both harnesses over SLOTS fake-signed slots of 16 validators, the
    port's with its default (pure-Python) key derivation: per fork, the
    (JAX, port) state roots and states after every slot and the blocks'
    bytes."""
    out = {}
    saved = [(m, m._active, m._active_name) for m in (jbackend, tbackend)]
    jbackend.set_backend("fake")
    tbackend.set_backend("fake")
    try:
        for fork in ("phase0", "altair"):
            j, t = _harnesses(fork, 16, fake_sign=True, jax={"fake_sign": True})
            roots = [(jssz.hash_tree_root(j.state), tssz.hash_tree_root(t.state))]
            states = [(copy.deepcopy(j.state), copy.deepcopy(t.state))]
            blocks = []
            for _ in range(SLOTS):
                jb = j.extend_chain(1, strategy="none")[0]
                tb = t.extend_chain(1, strategy="none")[0]
                blocks.append((_bytes(jb), _bytes(tb)))
                roots.append((jssz.hash_tree_root(j.state), tssz.hash_tree_root(t.state)))
                states.append((copy.deepcopy(j.state), copy.deepcopy(t.state)))
            out[fork] = (roots, blocks, states)
    finally:
        for m, active, name in saved:
            m._active, m._active_name = active, name
    return out


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_harnesses_build_the_same_chain_on_fake(fake_chains, fork):
    roots, blocks, states = fake_chains[fork]
    for slot, (jr, tr) in enumerate(roots):
        assert jr == tr, f"state root differs after slot {slot}"
    for slot, (jb, tb) in enumerate(blocks, start=1):
        assert jb == tb, f"block of slot {slot} differs"
    assert states[-1][1].slot == SLOTS
    assert _bytes(states[-1][0]) == _bytes(states[-1][1])


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_committees_and_shufflings_are_equal(fake_chains, fork):
    _, _, states = fake_chains[fork]
    for epoch in range(3):
        js, ts = states[epoch * TMINIMAL.SLOTS_PER_EPOCH]
        jc = jhelpers.CommitteeCache(JMINIMAL, js, epoch)
        tc = thelpers.CommitteeCache(TMINIMAL, ts, epoch)
        assert jc.committees_per_slot == tc.committees_per_slot
        for slot in range(epoch * 8, epoch * 8 + 8):
            for i in range(tc.committees_per_slot):
                assert [int(v) for v in jc.committee(slot, i)] == [
                    int(v) for v in tc.committee(slot, i)]
        assert (jhelpers.get_beacon_proposer_index(JMINIMAL, js)
                == thelpers.get_beacon_proposer_index(TMINIMAL, ts))
    rng = np.random.default_rng(7)
    for n in (1, 5, 64, 333):
        seed = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
        assert jshuffle.shuffle_list(n, seed, 10).tolist() == \
            tshuffle.shuffle_list(n, seed, 10).tolist()
        assert jshuffle.unshuffle_list(n, seed, 10).tolist() == \
            tshuffle.unshuffle_list(n, seed, 10).tolist()
        for i in (0, n // 2, n - 1):
            assert jshuffle.compute_shuffled_index(i, n, seed, 10) == \
                tshuffle.compute_shuffled_index(i, n, seed, 10)


def _set_bytes(sets):
    return [(s.message, [pk.serialize() for pk in s.signing_keys], s.signature.serialize())
            for s in sets]


def test_three_signed_blocks_import_on_cpu_native_with_equal_signature_sets():
    jbackend.set_backend("cpu-native")
    tbackend.set_backend("cpu-native")
    j, t = _harnesses("phase0", 32, pubkey_fn=native_pubkey)
    assert _bytes(j.state) == _bytes(t.state)
    for _ in range(3):
        slot = j.state.slot + 1
        jatts = j.attestations_for_slot(j.state, slot - 1)[: JMINIMAL.MAX_ATTESTATIONS] \
            if slot >= 2 else []
        tatts = t.attestations_for_slot(t.state, slot - 1)[: TMINIMAL.MAX_ATTESTATIONS] \
            if slot >= 2 else []
        jb, tb = j.produce_block(slot, attestations=jatts), t.produce_block(slot, attestations=tatts)
        assert _bytes(jb) == _bytes(tb)
        # each block's sets on its pre-state, in both packages
        jpre = jadvance(JMINIMAL, j.spec, copy.deepcopy(j.state), slot)
        tpre = tadvance(TMINIMAL, t.spec, copy.deepcopy(t.state), slot)
        jacc = JAccumulator(JMINIMAL, j.spec, jpre, jresolver(jpre))
        tacc = TAccumulator(TMINIMAL, t.spec, tpre, tresolver(tpre))
        jacc.include_all(jb)
        tacc.include_all(tb)
        assert len(tacc.sets) == 2 + len(tatts)
        assert _set_bytes(jacc.sets) == _set_bytes(tacc.sets)
        # the whole import verifies every set (one batch) on cpu-native
        j.process_block(jb, strategy="bulk")
        t.process_block(tb, strategy="bulk")
        assert jssz.hash_tree_root(j.state) == tssz.hash_tree_root(t.state)
    assert t.state.slot == 3
