"""The benchmark's one traffic generator.

A traffic mix is a data file, ``benchmark/traffic/<name>.json``; a
configuration is ``benchmark/configs/<name>.json``. This module turns the
pair, a seed and the window's seconds into the work of one run: a list of
:class:`Unit`, each one caller's call (a chain segment) with its signature
sets described by :class:`SetSpec` (message, signers, whether it is
signed wrongly). It draws everything from ``numpy``'s PCG64 under the
seed, never from the clock, so one seed gives the same units byte for byte
(:func:`trace_lines` writes them in the repository's JSONL trace format,
``lighthouse_tpu.traffic_trace/1``, with each set's message and signers).

The beacon world is the consensus specs' (phase0 and altair):

* each epoch's committees are a seeded permutation of the registry cut
  into ``slots_per_epoch * committees_per_slot`` committees;
* an attestation signs its committee's AttestationData root, shared by
  every aggregate of that (slot, committee);
* a block carries ``max_attestations`` aggregates, from the committees of
  the slots named by ``attestation_slots`` (1 = the slot before), the
  proposal, RANDAO and the sync aggregate, which signs the parent root
  under the sync committee's domain: a root of its own.

A mix is a closed loop: units of ``blocks_per_unit`` consecutive blocks
(``"epoch"`` = one epoch), handed over one after another. The window gets
as many units as ``ceiling_sets_per_s`` sets a second fill for the run's
seconds, after ``preroll_units`` warm-up units (negative slots). One set
is signed wrongly, at a seeded place, in every ``bad_every``-th unit of
the window from its first, so that every run, however short, has units
that fail and units that verify.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the order of G1 and G2
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
TRACE_SCHEMA = "lighthouse_tpu.traffic_trace/1"


@dataclass
class SetSpec:
    """One signature set: signed by ``members`` (validator indices; the
    secret of validator i is i + 1) over ``msg``; a ``bad`` set is signed
    with the aggregate secret plus one."""

    msg: bytes
    members: Tuple[int, ...]
    bad: bool = False

    def scalar(self) -> int:
        return (sum(self.members) + len(self.members) + int(self.bad)) % R


@dataclass
class Unit:
    """One call: ``entry`` is ``bulk`` (``backend_verify_bulk``) or
    ``verify_now``; ``slot`` is its place in the run (negative =
    warm-up)."""

    kind: str
    entry: str
    sets: List[SetSpec]
    slot: int = 0


class World:
    """The seeded beacon world of one configuration."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.n = int(cfg["validators"])
        self.spe = int(cfg["slots_per_epoch"])
        self.cps = max(1, min(int(cfg["max_committees_per_slot"]),
                              self.n // self.spe // int(cfg["target_committee_size"])))
        self.committee_size = self.n // (self.spe * self.cps)
        self.sync_committee = self.rng.permutation(self.n)[: int(cfg["sync_committee_size"])]
        self._perms: Dict[int, np.ndarray] = {}

    def root(self, *parts) -> bytes:
        """A 32-byte signing root named by ``parts``, unique per seed."""
        h = hashlib.sha256(self.seed.to_bytes(16, "big", signed=True))
        h.update(repr(parts).encode())
        return h.digest()

    def committee(self, slot: int, index: int) -> np.ndarray:
        epoch = slot // self.spe
        perm = self._perms.get(epoch)
        if perm is None:
            perm = self._perms[epoch] = np.random.default_rng(
                [self.seed & (2**63 - 1), epoch + 2**20]).permutation(self.n)
        c = (slot % self.spe) * self.cps + index
        return perm[c * self.committee_size:(c + 1) * self.committee_size]

    def share(self, pool: np.ndarray, lo_hi: Sequence[float]) -> Tuple[int, ...]:
        """A uniform share in [lo, hi] of ``pool``, as sorted indices."""
        lo, hi = lo_hi
        k = max(1, int(round(len(pool) * self.rng.uniform(lo, hi))))
        return tuple(int(v) for v in np.sort(self.rng.permutation(pool)[:k]))

    def attestation(self, slot: int, index: int, part) -> SetSpec:
        return SetSpec(self.root("attestation_data", slot, index),
                       self.share(self.committee(slot, index), part))

    def block(self, slot: int, traffic: dict) -> List[SetSpec]:
        """A block's sets: its aggregates, the proposal, RANDAO and the
        sync aggregate over the parent root."""
        part = traffic["participation"]
        proposer = (int(self.rng.integers(self.n)),)
        return self.block_attestations(slot, traffic) + [
            SetSpec(self.root("block", slot), proposer),
            SetSpec(self.root("randao", slot // self.spe), proposer),
            SetSpec(self.root("sync", slot - 1), self.share(self.sync_committee, part)),
        ]

    def block_attestations(self, slot: int, traffic: dict) -> List[SetSpec]:
        """``max_attestations`` aggregates over the committees of the slots
        ``attestation_slots`` before ``slot``, one committee after another."""
        want = int(self.cfg["max_attestations"])
        out = []
        while len(out) < want:
            for b in traffic["attestation_slots"]:
                for index in range(self.cps):
                    if len(out) < want:
                        out.append(self.attestation(slot - b, index, traffic["participation"]))
        return out


def generate(cfg: dict, traffic: dict, seed: int, seconds: float) -> List[Unit]:
    """The units of one run of the cell (configuration ``cfg``, mix
    ``traffic``) under ``seed`` for a window of ``seconds``."""
    world = World(cfg, seed)
    per = traffic["blocks_per_unit"]
    per = world.spe if per == "epoch" else int(per)
    pre = int(traffic["preroll_units"])
    want = float(traffic["ceiling_sets_per_s"]) * float(seconds)
    units: List[Unit] = []
    slot = world.spe  # start past genesis: every attestation slot exists
    in_window = 0
    while len(units) < pre or in_window < want:
        sets: List[SetSpec] = []
        for _b in range(per):
            sets += world.block(slot, traffic)
            slot += 1
        units.append(Unit(traffic["kind"], traffic["entry"], sets, len(units) - pre))
        if len(units) > pre:
            in_window += len(sets)
    every = int(traffic["bad_every"])
    for u in units[pre::every]:
        u.sets[int(world.rng.integers(len(u.sets)))].bad = True
    return units


def trace_lines(units: List[Unit], name: str, seed: int) -> List[str]:
    """The units as a JSONL trace: a header line, then one event per unit
    (the repository's event fields, plus each set's message, signers and
    whether it is signed wrongly). A closed loop hands each unit over when
    the last returns, so every event is due at 0."""
    head = {"schema": TRACE_SCHEMA, "name": name, "seed": int(seed),
            "n_events": len(units), "duration_s": 0.0,
            "generator": "benchmark/generator.py", "params": {}}
    lines = [json.dumps(head, sort_keys=True)]
    for u in units:
        lines.append(json.dumps({
            "t": 0.0, "kind": u.kind, "n_sets": len(u.sets),
            "pubkeys": max(len(s.members) for s in u.sets),
            "messages": len({s.msg for s in u.sets}),
            "path": "verify_now" if u.entry == "verify_now" else "submit",
            "qos": "bulk" if u.entry == "bulk" else "deadline",
            "slot": u.slot,
            "sets": [[s.msg.hex(), list(s.members), s.bad] for s in u.sets],
        }, sort_keys=True))
    return lines
