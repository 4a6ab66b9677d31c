"""Operation-pool persistence (reference:
``beacon_node/operation_pool/src/persistence.rs`` — the pool is
SSZ-persisted on shutdown and restored by the client builder).

One versioned blob in the OP_POOL column: attestation data + compact
aggregation entries, slashings, exits, and the sync-committee pools.
Containers are SSZ-encoded (same wire types as gossip); the envelope is
JSON with hex payloads for debuggability.
"""

from __future__ import annotations

import json

from .pool import OperationPool, _CompactAttestation

_VERSION = 1


def _hx(b: bytes) -> str:
    return bytes(b).hex()


def _un(s: str) -> bytes:
    return bytes.fromhex(s)


def pool_to_bytes(pool: OperationPool) -> bytes:
    t = pool.types
    with pool._lock:
        doc = {
            "version": _VERSION,
            "attestations": [
                {
                    "data": _hx(t.AttestationData.encode(data)),
                    "entries": [
                        {"bits": [int(b) for b in c.aggregation_bits],
                         "sig": _hx(c.signature)}
                        for c in compacts
                    ],
                }
                for data, compacts in pool._attestations.values()
            ],
            "proposer_slashings": [
                _hx(t.ProposerSlashing.encode(s))
                for s in pool._proposer_slashings.values()
            ],
            "attester_slashings": [
                _hx(t.AttesterSlashing.encode(s)) for s in pool._attester_slashings
            ],
            "voluntary_exits": [
                _hx(t.SignedVoluntaryExit.encode(e))
                for e in pool._voluntary_exits.values()
            ],
            "sync_messages": [
                [slot, _hx(root), {str(p): _hx(sig) for p, sig in sigs.items()}]
                for (slot, root), sigs in pool._sync_messages.items()
            ],
            "sync_contributions": [
                [list(k[:1]) + [_hx(k[1])] + list(k[2:]),
                 [[int(b) for b in bits], _hx(sig)]]
                for k, (bits, sig) in pool._sync_contributions.items()
            ],
        }
    return json.dumps(doc, separators=(",", ":")).encode()


def pool_from_bytes(preset, spec, types, data: bytes) -> OperationPool:
    doc = json.loads(data.decode())
    if doc.get("version") != _VERSION:
        raise ValueError(f"unknown op-pool blob version {doc.get('version')}")
    t = types
    pool = OperationPool(preset, spec, types)
    from ..ssz import hash_tree_root

    for a in doc["attestations"]:
        att_data = t.AttestationData.decode(_un(a["data"]))
        root = hash_tree_root(t.AttestationData, att_data)
        pool._attestations[root] = (
            att_data,
            [
                _CompactAttestation(
                    aggregation_bits=[bool(b) for b in e["bits"]],
                    signature=_un(e["sig"]),
                )
                for e in a["entries"]
            ],
        )
    for s in doc["proposer_slashings"]:
        sl = t.ProposerSlashing.decode(_un(s))
        pool._proposer_slashings[int(sl.signed_header_1.message.proposer_index)] = sl
    pool._attester_slashings = [
        t.AttesterSlashing.decode(_un(s)) for s in doc["attester_slashings"]
    ]
    for e in doc["voluntary_exits"]:
        ex = t.SignedVoluntaryExit.decode(_un(e))
        pool._voluntary_exits[int(ex.message.validator_index)] = ex
    for slot, root, sigs in doc["sync_messages"]:
        pool._sync_messages[(int(slot), _un(root))] = {
            int(p): _un(sig) for p, sig in sigs.items()
        }
    for key, (bits, sig) in doc["sync_contributions"]:
        k = (int(key[0]), _un(key[1]), *[int(x) for x in key[2:]])
        pool._sync_contributions[k] = ([bool(b) for b in bits], _un(sig))
    return pool
