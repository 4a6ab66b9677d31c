"""Fork-choice persistence: the full ForkChoice (store checkpoints +
queued attestations + proto-array nodes + vote trackers) round-trips
through one opaque blob in the hot DB's FORK_CHOICE column.

Reference: the beacon chain persists fork choice on shutdown and at
finalization and resumes from it (``beacon_chain.rs:400-440``,
``proto_array/src/proto_array_fork_choice.rs`` ``as_bytes/from_bytes``
SSZ containers). The blob here is versioned JSON with hex-encoded roots —
same durability contract, introspectable in a debugger.
"""

from __future__ import annotations

import json

from ..types.chain_spec import ChainSpec
from ..types.preset import Preset
from .fork_choice import ForkChoice, QueuedAttestation
from .proto_array import ExecutionStatus, ProtoNode, VoteTracker

_VERSION = 1


def _hx(b: bytes) -> str:
    return bytes(b).hex()


def _un(s: str) -> bytes:
    return bytes.fromhex(s)


def _cp(cp: tuple[int, bytes]) -> list:
    return [int(cp[0]), _hx(cp[1])]


def _uncp(v) -> tuple[int, bytes]:
    return (int(v[0]), _un(v[1]))


def fork_choice_to_bytes(fc: ForkChoice) -> bytes:
    """Caller must own ``fc`` exclusively (the chain serializes via
    ``BeaconChain.fork_choice_bytes`` under the chain lock) — concurrent
    mutation tears the nodes/votes iteration."""
    st = fc.store
    doc = {
        "version": _VERSION,
        "store": {
            "current_slot": st.current_slot,
            "justified": _cp(st.justified_checkpoint),
            "finalized": _cp(st.finalized_checkpoint),
            "best_justified": _cp(st.best_justified_checkpoint),
            "justified_balances": list(map(int, st.justified_balances)),
            "proposer_boost_root": _hx(st.proposer_boost_root),
            "equivocating_indices": sorted(st.equivocating_indices),
        },
        "queued_attestations": [
            [qa.slot, list(qa.validator_indices), _hx(qa.block_root), qa.target_epoch]
            for qa in fc.queued_attestations
        ],
        "proto": {
            "nodes": [
                [
                    n.slot,
                    _hx(n.root),
                    n.parent,
                    _cp(n.justified_checkpoint),
                    _cp(n.finalized_checkpoint),
                    n.execution_status.value,
                    int(n.weight),
                    n.best_child,
                    n.best_descendant,
                ]
                for n in fc.proto.nodes
            ],
            "votes": {
                str(v): [_hx(t.current_root), _hx(t.next_root), t.next_epoch]
                for v, t in fc.proto.votes.items()
            },
            "balances": list(map(int, fc.proto.balances)),
            "justified": _cp(fc.proto.justified_checkpoint),
            "finalized": _cp(fc.proto.finalized_checkpoint),
            "proposer_boost_root": _hx(fc.proto.proposer_boost_root),
            "equivocating_indices": sorted(fc.proto.equivocating_indices),
        },
    }
    return json.dumps(doc, separators=(",", ":")).encode()


def fork_choice_from_bytes(
    preset: Preset, spec: ChainSpec, data: bytes
) -> ForkChoice:
    doc = json.loads(data.decode())
    if doc.get("version") != _VERSION:
        raise ValueError(f"unknown fork-choice blob version {doc.get('version')}")
    st = doc["store"]
    proto = doc["proto"]
    nodes = proto["nodes"]
    if not nodes:
        raise ValueError("fork-choice blob has no nodes")

    anchor = nodes[0]
    fc = ForkChoice(
        preset,
        spec,
        anchor[0],
        _un(anchor[1]),
        _uncp(proto["justified"]),
        _uncp(proto["finalized"]),
        st["justified_balances"],
    )
    # replace the single-anchor proto contents with the persisted DAG
    fc.proto.nodes = [
        ProtoNode(
            slot=n[0],
            root=_un(n[1]),
            parent=n[2],
            justified_checkpoint=_uncp(n[3]),
            finalized_checkpoint=_uncp(n[4]),
            execution_status=ExecutionStatus(n[5]),
            weight=n[6],
            best_child=n[7],
            best_descendant=n[8],
        )
        for n in nodes
    ]
    fc.proto.index = {n.root: i for i, n in enumerate(fc.proto.nodes)}
    fc.proto.votes = {
        int(v): VoteTracker(
            current_root=_un(t[0]), next_root=_un(t[1]), next_epoch=t[2]
        )
        for v, t in proto["votes"].items()
    }
    fc.proto.balances = proto["balances"]
    fc.proto.proposer_boost_root = _un(proto["proposer_boost_root"])
    fc.proto.equivocating_indices = set(proto["equivocating_indices"])

    s = fc.store
    s.current_slot = st["current_slot"]
    s.justified_checkpoint = _uncp(st["justified"])
    s.finalized_checkpoint = _uncp(st["finalized"])
    s.best_justified_checkpoint = _uncp(st["best_justified"])
    s.justified_balances = st["justified_balances"]
    s.proposer_boost_root = _un(st["proposer_boost_root"])
    s.equivocating_indices = set(st["equivocating_indices"])
    fc.queued_attestations = [
        QueuedAttestation(
            slot=q[0], validator_indices=q[1], block_root=_un(q[2]), target_epoch=q[3]
        )
        for q in doc["queued_attestations"]
    ]
    return fc
