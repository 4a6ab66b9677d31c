"""Slashing protection database, EIP-3076 (reference:
``validator_client/slashing_protection/src/slashing_database.rs:35-608``
+ ``interchange.rs``).

SQLite-backed record of every signed block/attestation per validator;
``check_and_insert_*`` enforces, atomically:

* blocks — no double proposal at a slot (same signing root is an
  idempotent re-sign), no proposal at or below the low watermark;
* attestations — source <= target, no double vote for a target epoch, no
  surrounding or surrounded vote (min-max conditions), monotone source.

Interchange (EIP-3076 v5) import/export for migrating between clients.
"""

from __future__ import annotations

import json
import sqlite3
import threading


class SlashingProtectionError(ValueError):
    """Refusing to sign: doing so would be slashable (or unsafe)."""


class SlashingDatabase:
    def __init__(self, path: str = ":memory:", genesis_validators_root: bytes = bytes(32)):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self.genesis_validators_root = genesis_validators_root
        with self._conn:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS validators ("
                " id INTEGER PRIMARY KEY, pubkey BLOB UNIQUE NOT NULL)"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS signed_blocks ("
                " validator_id INTEGER NOT NULL, slot INTEGER NOT NULL,"
                " signing_root BLOB,"
                " UNIQUE (validator_id, slot))"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS signed_attestations ("
                " validator_id INTEGER NOT NULL,"
                " source_epoch INTEGER NOT NULL, target_epoch INTEGER NOT NULL,"
                " signing_root BLOB,"
                " UNIQUE (validator_id, target_epoch))"
            )

    # -- registration ----------------------------------------------------

    def register_validator(self, pubkey: bytes) -> int:
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT id FROM validators WHERE pubkey=?", (pubkey,)
            ).fetchone()
            if row:
                return row[0]
            cur = self._conn.execute(
                "INSERT INTO validators (pubkey) VALUES (?)", (pubkey,)
            )
            return cur.lastrowid

    def _vid(self, pubkey: bytes) -> int:
        row = self._conn.execute(
            "SELECT id FROM validators WHERE pubkey=?", (pubkey,)
        ).fetchone()
        if not row:
            raise SlashingProtectionError(
                f"unregistered validator {pubkey.hex()[:12]}"
            )
        return row[0]

    # -- blocks ----------------------------------------------------------

    def check_and_insert_block_proposal(
        self, pubkey: bytes, slot: int, signing_root: bytes
    ) -> None:
        with self._lock, self._conn:
            vid = self._vid(pubkey)
            row = self._conn.execute(
                "SELECT signing_root FROM signed_blocks"
                " WHERE validator_id=? AND slot=?",
                (vid, slot),
            ).fetchone()
            if row is not None:
                if row[0] == signing_root:
                    return  # idempotent re-sign of the same block
                raise SlashingProtectionError(
                    f"double block proposal at slot {slot}"
                )
            low = self._conn.execute(
                "SELECT MAX(slot) FROM signed_blocks WHERE validator_id=?",
                (vid,),
            ).fetchone()[0]
            if low is not None and slot < low:
                raise SlashingProtectionError(
                    f"block slot {slot} below low watermark {low}"
                )
            self._conn.execute(
                "INSERT INTO signed_blocks (validator_id, slot, signing_root)"
                " VALUES (?,?,?)",
                (vid, slot, signing_root),
            )

    # -- attestations ----------------------------------------------------

    def check_and_insert_attestation(
        self, pubkey: bytes, source_epoch: int, target_epoch: int,
        signing_root: bytes,
    ) -> None:
        if source_epoch > target_epoch:
            raise SlashingProtectionError("attestation source > target")
        with self._lock, self._conn:
            vid = self._vid(pubkey)
            row = self._conn.execute(
                "SELECT signing_root FROM signed_attestations"
                " WHERE validator_id=? AND target_epoch=?",
                (vid, target_epoch),
            ).fetchone()
            if row is not None:
                if row[0] == signing_root:
                    return
                raise SlashingProtectionError(
                    f"double vote for target epoch {target_epoch}"
                )
            # surround checks (min-max): new surrounds old / old surrounds new
            surrounds = self._conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id=?"
                " AND source_epoch > ? AND target_epoch < ?",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if surrounds:
                raise SlashingProtectionError(
                    "attestation would surround an existing vote"
                )
            surrounded = self._conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id=?"
                " AND source_epoch < ? AND target_epoch > ?",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if surrounded:
                raise SlashingProtectionError(
                    "attestation would be surrounded by an existing vote"
                )
            # monotone watermarks (EIP-3076 minimal conditions)
            max_source = self._conn.execute(
                "SELECT MAX(source_epoch) FROM signed_attestations"
                " WHERE validator_id=?",
                (vid,),
            ).fetchone()[0]
            if max_source is not None and source_epoch < max_source:
                # allowed by the letter of slashing rules, but EIP-3076
                # importers use max-source as the low watermark; refuse to
                # regress (matches the reference's behaviour)
                raise SlashingProtectionError(
                    f"attestation source {source_epoch} below watermark {max_source}"
                )
            max_target = self._conn.execute(
                "SELECT MAX(target_epoch) FROM signed_attestations"
                " WHERE validator_id=?",
                (vid,),
            ).fetchone()[0]
            if max_target is not None and target_epoch <= max_target:
                raise SlashingProtectionError(
                    f"attestation target {target_epoch} at/below watermark {max_target}"
                )
            self._conn.execute(
                "INSERT INTO signed_attestations"
                " (validator_id, source_epoch, target_epoch, signing_root)"
                " VALUES (?,?,?,?)",
                (vid, source_epoch, target_epoch, signing_root),
            )

    # -- interchange (EIP-3076 v5) ---------------------------------------

    def export_interchange(self) -> dict:
        with self._lock:
            data = []
            for vid, pubkey in self._conn.execute(
                "SELECT id, pubkey FROM validators ORDER BY id"
            ).fetchall():
                blocks = [
                    {
                        "slot": str(slot),
                        **(
                            {"signing_root": "0x" + root.hex()}
                            if root
                            else {}
                        ),
                    }
                    for slot, root in self._conn.execute(
                        "SELECT slot, signing_root FROM signed_blocks"
                        " WHERE validator_id=? ORDER BY slot",
                        (vid,),
                    ).fetchall()
                ]
                atts = [
                    {
                        "source_epoch": str(s),
                        "target_epoch": str(t),
                        **(
                            {"signing_root": "0x" + root.hex()}
                            if root
                            else {}
                        ),
                    }
                    for s, t, root in self._conn.execute(
                        "SELECT source_epoch, target_epoch, signing_root"
                        " FROM signed_attestations WHERE validator_id=?"
                        " ORDER BY target_epoch",
                        (vid,),
                    ).fetchall()
                ]
                data.append(
                    {
                        "pubkey": "0x" + pubkey.hex(),
                        "signed_blocks": blocks,
                        "signed_attestations": atts,
                    }
                )
        return {
            "metadata": {
                "interchange_format_version": "5",
                "genesis_validators_root": "0x"
                + self.genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(self, obj: dict) -> None:
        meta = obj["metadata"]
        if meta["interchange_format_version"] != "5":
            raise SlashingProtectionError("unsupported interchange version")
        gvr = bytes.fromhex(meta["genesis_validators_root"][2:])
        if (
            self.genesis_validators_root != bytes(32)
            and gvr != self.genesis_validators_root
        ):
            raise SlashingProtectionError("genesis_validators_root mismatch")
        with self._lock, self._conn:
            for rec in obj["data"]:
                pubkey = bytes.fromhex(rec["pubkey"][2:])
                row = self._conn.execute(
                    "SELECT id FROM validators WHERE pubkey=?", (pubkey,)
                ).fetchone()
                vid = (
                    row[0]
                    if row
                    else self._conn.execute(
                        "INSERT INTO validators (pubkey) VALUES (?)", (pubkey,)
                    ).lastrowid
                )
                for b in rec.get("signed_blocks", []):
                    root = (
                        bytes.fromhex(b["signing_root"][2:])
                        if "signing_root" in b
                        else None
                    )
                    self._conn.execute(
                        "INSERT OR REPLACE INTO signed_blocks"
                        " (validator_id, slot, signing_root) VALUES (?,?,?)",
                        (vid, int(b["slot"]), root),
                    )
                for a in rec.get("signed_attestations", []):
                    root = (
                        bytes.fromhex(a["signing_root"][2:])
                        if "signing_root" in a
                        else None
                    )
                    self._conn.execute(
                        "INSERT OR REPLACE INTO signed_attestations"
                        " (validator_id, source_epoch, target_epoch,"
                        " signing_root) VALUES (?,?,?,?)",
                        (
                            vid,
                            int(a["source_epoch"]),
                            int(a["target_epoch"]),
                            root,
                        ),
                    )

    def export_json(self) -> str:
        return json.dumps(self.export_interchange(), indent=2)

    def import_json(self, s: str) -> None:
        self.import_interchange(json.loads(s))
