"""The port's slasher against the JAX package's.

The same inputs go through both: JAX containers are built, encoded, and
decoded by the port's types. Exact equality throughout:

* every scenario of ``tests/test_slasher.py``: each status and the SSZ
  bytes of each piece of evidence;
* a seeded numpy sequence of attestations and block headers over a
  ``history_length=64`` window (its epochs climb, so the window rebases):
  the statuses, the evidence, the span arrays and the window's base;
* the store rows under ``Column.SLASHER`` after a flush, and after a
  prune; a port slasher reloaded from the JAX slasher's rows (and the
  JAX slasher from the port's) finds the same third conflicting vote.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lighthouse_tpu.slasher import Slasher as JSlasher
from lighthouse_tpu.store.kv import Column as JColumn, MemoryStore as JMemoryStore
from lighthouse_tpu.types.containers import types_for as jtypes_for
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu_torch.slasher import AttesterSlashingStatus, Slasher as TSlasher
from lighthouse_tpu_torch.store.kv import Column as TColumn, MemoryStore as TMemoryStore
from lighthouse_tpu_torch.types.containers import types_for as ttypes_for
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL

JT, TT = jtypes_for(JMINIMAL), ttypes_for(TMINIMAL)
SEQ_STEPS = 300
HISTORY = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _att(validators, source, target, root=1) -> bytes:
    """tests/test_slasher.py's ``_att``, as the bytes of a JAX container."""
    root = bytes([root]) * 32
    a = JT.IndexedAttestation(
        attesting_indices=list(validators),
        data=JT.AttestationData(
            slot=target * JMINIMAL.SLOTS_PER_EPOCH, index=0, beacon_block_root=root,
            source=JT.Checkpoint(epoch=source, root=b"\x0a" * 32),
            target=JT.Checkpoint(epoch=target, root=root)),
        signature=b"\x00" * 96)
    return JT.IndexedAttestation.encode(a)


def _header(slot, proposer, body) -> bytes:
    h = JT.SignedBeaconBlockHeader(
        message=JT.BeaconBlockHeader(slot=slot, proposer_index=proposer,
                                     body_root=bytes([body]) * 32),
        signature=b"\x00" * 96)
    return JT.SignedBeaconBlockHeader.encode(h)


def _run(t, slasher, ops) -> list:
    """Apply ``ops`` to ``slasher`` (decoding with the package's types
    ``t``); one record per op: statuses and evidence bytes."""
    out = []
    for op, raw in ops:
        if op == "att":
            got = slasher.check_attestation(t.IndexedAttestation.decode(raw))
            out.append([(s.value, t.AttesterSlashing.encode(e).hex()) for s, e in got])
        elif op == "hdr":
            got = slasher.check_block_header(t.SignedBeaconBlockHeader.decode(raw))
            out.append(None if got is None else t.ProposerSlashing.encode(got).hex())
        elif op == "queue":
            slasher.accept_attestation(t.IndexedAttestation.decode(raw))
        else:  # process the queue
            out.append(slasher.process_queued())
    return out


# the scenarios of tests/test_slasher.py: (history, ops, statuses the ops give)
SCENARIOS = {
    "not_slashable": (4096, [("att", _att([1], 0, 1)), ("att", _att([1], 1, 2)),
                             ("att", _att([1], 0, 1))], [[], [], []]),
    "double_vote": (4096, [("att", _att([1], 0, 3, 1)), ("att", _att([1], 2, 3, 2))],
                    [[], ["double_vote"]]),
    "surrounds": (4096, [("att", _att([7], 3, 4)), ("att", _att([7], 2, 6))],
                  [[], ["surrounds_existing"]]),
    "surrounded_by": (4096, [("att", _att([7], 2, 6)), ("att", _att([7], 3, 4))],
                      [[], ["surrounded_by_existing"]]),
    "only_common_validators": (4096, [("att", _att([1, 2], 3, 4)), ("att", _att([3], 2, 6))],
                               [[], []]),
    "block_double_proposal": (4096, [("hdr", _header(9, 4, 1)), ("hdr", _header(9, 4, 1)),
                                     ("hdr", _header(9, 4, 2))], [None, None, "found"]),
    "queue_and_callback": (4096, [("queue", _att([5], 3, 4)), ("queue", _att([5], 2, 6)),
                                  ("process", None)], [1]),
    "sliding_window": (64, [("att", _att([3], 5000, 5001)), ("att", _att([3], 4999, 5002)),
                            ("att", _att([3], 5000, 5001, 5))],
                       [[], ["surrounds_existing"], ["double_vote"]]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenarios_give_jax_statuses_and_evidence(name):
    history, ops, want = SCENARIOS[name]
    found = {}
    recs = {}
    for label, t, cls in (("jax", JT, JSlasher), ("torch", TT, TSlasher)):
        calls = found[label] = []
        s = cls(t, history_length=history, on_slashing=lambda *a, c=calls: c.append(a[0]))
        recs[label] = _run(t, s, ops)
    assert recs["torch"] == recs["jax"]
    shape = [r if isinstance(r, int) else
             ("found" if isinstance(r, str) else r) if not isinstance(r, list)
             else [st for st, _e in r] for r in recs["torch"]]
    assert shape == want
    assert [getattr(s, "value", s) for s in found["torch"]] == [
        getattr(s, "value", s) for s in found["jax"]]
    assert AttesterSlashingStatus.DOUBLE_VOTE.value == "double_vote"


def _sequence(seed: int = 7) -> list:
    """A seeded sequence of attestations by up to three of six validators
    (epochs climbing past the window, so it rebases) and, every 25th step,
    a block header (every other one a second proposal)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(SEQ_STEPS):
        src = i // 2 + int(rng.integers(0, 12))
        tgt = src + int(rng.integers(1, 10))
        vs = sorted({int(v) for v in rng.integers(0, 6, size=int(rng.integers(1, 4)))})
        ops.append(("att", _att(vs, src, tgt, int(rng.integers(1, 3)))))
        if i % 25 == 0:
            ops.append(("hdr", _header(i, int(rng.integers(0, 6)), 1 + (i // 25) % 2)))
            ops.append(("hdr", _header(i, int(rng.integers(0, 6)), 2)))
    return ops


@pytest.fixture(scope="module")
def seq_runs():
    """The sequence through both slashers, each on its package's store."""
    ops = _sequence()
    out = {}
    for label, t, cls, store in (("jax", JT, JSlasher, JMemoryStore()),
                                 ("torch", TT, TSlasher, TMemoryStore())):
        s = cls(t, history_length=HISTORY, store=store)
        out[label] = (s, store, _run(t, s, ops))
    return out


def _rows(store, column) -> list:
    return list(store.iter_column(column))


def test_seeded_sequence_gives_jax_statuses_evidence_and_spans(seq_runs):
    (js, _, jrec), (ts, _, trec) = seq_runs["jax"], seq_runs["torch"]
    assert trec == jrec
    flagged = [r for r in trec if isinstance(r, list) and r]
    assert len(flagged) > 20  # the sequence does reach every kind of offence
    kinds = {st for r in flagged for st, _e in r}
    assert kinds == {"double_vote", "surrounds_existing", "surrounded_by_existing"}
    assert any(isinstance(r, str) for r in trec)
    assert ts._base == js._base > 0
    assert sorted(ts._min_span) == sorted(js._min_span)
    for v in js._min_span:
        assert np.array_equal(ts._min_span[v], js._min_span[v])
        assert np.array_equal(ts._max_span[v], js._max_span[v])


def test_flushed_rows_equal_and_reload_across_packages(seq_runs):
    (js, jstore, _), (ts, tstore, _) = seq_runs["jax"], seq_runs["torch"]
    js.flush()
    ts.flush()
    rows = _rows(tstore, TColumn.SLASHER)
    assert rows == _rows(jstore, JColumn.SLASHER)
    assert {k[:1] for k, _v in rows} == {b"m", b"s", b"a", b"b"}
    # each package reloads the other's rows and finds the same third vote
    conflict = _att([2], 140, 151, 9)
    third = {}
    for label, t, cls, store_cls, column, src in (
            ("torch", TT, TSlasher, TMemoryStore, TColumn.SLASHER, jstore),
            ("jax", JT, JSlasher, JMemoryStore, JColumn.SLASHER, tstore)):
        store = store_cls()
        store.put_batch([(column, k, v) for k, v in _rows(src, column)])
        s = cls(t, history_length=HISTORY, store=store)
        assert s._base == js._base
        third[label] = _run(t, s, [("att", conflict)])
    assert third["torch"] == third["jax"]
    assert third["torch"][0], "the reloaded slasher missed the conflicting vote"


def test_prune_leaves_equal_rows(seq_runs):
    (js, jstore, _), (ts, tstore, _) = seq_runs["jax"], seq_runs["torch"]
    before = len(_rows(tstore, TColumn.SLASHER))
    js.prune(100)
    ts.prune(100)
    rows = _rows(tstore, TColumn.SLASHER)
    assert rows == _rows(jstore, JColumn.SLASHER)
    assert len(rows) < before
    assert sorted(ts._by_target) == sorted(js._by_target)
    assert sorted(ts._blocks) == sorted(js._blocks)
