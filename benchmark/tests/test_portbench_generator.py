"""The traffic generator: the same seed gives the same units byte for
byte, and the units hold the counts and the sharing of messages that the
sync mix states."""

import json
from collections import Counter
from pathlib import Path

import pytest

from benchmark import generator

BENCH = Path(__file__).resolve().parent.parent
SEED = 2**31 + 4099


def load():
    cfg = json.loads((BENCH / "configs" / "gnosis_2p17.json").read_text())
    tr = json.loads((BENCH / "traffic" / "sync.json").read_text())
    return cfg, tr


def test_same_seed_same_bytes():
    cfg, tr = load()
    a = generator.trace_lines(generator.generate(cfg, tr, SEED, 4), "sync", SEED)
    b = generator.trace_lines(generator.generate(cfg, tr, SEED, 4), "sync", SEED)
    c = generator.trace_lines(generator.generate(cfg, tr, SEED + 1, 4), "sync", SEED + 1)
    assert a == b
    assert a[1:] != c[1:]
    head = json.loads(a[0])
    assert head["schema"] == "lighthouse_tpu.traffic_trace/1"
    assert head["n_events"] == len(a) - 1


def _block_checks(sets, committee, sync_size):
    assert len(sets) == 131
    atts, (proposal, randao, sync) = sets[:128], sets[128:]
    assert all(0.9 * committee - 1 <= len(s.members) <= committee for s in atts)
    assert len(proposal.members) == len(randao.members) == 1
    assert proposal.members == randao.members
    assert 0.9 * sync_size - 1 <= len(sync.members) <= sync_size
    # the sync aggregate signs under its own domain, never the proposal's root
    assert sync.msg not in {proposal.msg, randao.msg} | {s.msg for s in atts}


def test_sync_cell_units():
    cfg, tr = load()
    units = generator.generate(cfg, tr, SEED, 4)
    for u in units:
        assert u.entry == "bulk" and u.kind == "chain_segment"
        assert len(u.sets) == 16 * 131
        for b in range(16):
            _block_checks(u.sets[131 * b:131 * (b + 1)], 128, 512)
    # an attestation's AttestationData root is shared by the two blocks
    # that carry its slot's committees, and by nothing else
    msgs = Counter(s.msg for u in units for b in range(16) for s in u.sets[131 * b:131 * b + 128])
    assert max(msgs.values()) == 2
    # the proposal of block s and the sync aggregate of block s + 1 differ
    syncs = {s.msg for u in units for s in u.sets[130::131]}
    proposals = {s.msg for u in units for s in u.sets[128::131]}
    assert not syncs & proposals


@pytest.mark.parametrize("seconds", [1, 4, 24, 51])
def test_units_follow_the_window(seconds):
    """The window holds as many epochs as the mix's ceiling fills."""
    cfg, tr = load()
    units = generator.generate(cfg, tr, SEED, seconds)
    window = [u for u in units if u.slot >= 0]
    assert sum(u.slot < 0 for u in units) == tr["preroll_units"]
    assert [u.slot for u in units] == list(range(-tr["preroll_units"], len(window)))
    sets = sum(len(u.sets) for u in window)
    assert sets >= tr["ceiling_sets_per_s"] * seconds > sets - len(window[-1].sets)


def test_wrongly_signed_sets_alternate():
    """One wrongly signed set in every other window unit from the first,
    none in the warm-up: every run compares units that fail and units
    that verify."""
    cfg, tr = load()
    units = generator.generate(cfg, tr, SEED, 12)
    assert tr["bad_every"] == 2
    assert not any(s.bad for u in units if u.slot < 0 for s in u.sets)
    assert [sum(s.bad for s in u.sets) for u in units if u.slot >= 0] == \
        [int(u.slot % 2 == 0) for u in units if u.slot >= 0]
    places = {next(j for j, s in enumerate(u.sets) if s.bad) for u in units[tr["preroll_units"]::2]}
    assert len(places) > 1
