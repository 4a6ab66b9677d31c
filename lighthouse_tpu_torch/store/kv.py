"""Key-value store abstraction (reference: ``beacon_node/store``'s
``KeyValueStore`` trait + ``MemoryStore`` (``memory_store.rs:1-126``) +
``leveldb_store.rs``).

Keys are (column, key-bytes); columns mirror the reference's ``DBColumn``
prefixes. The disk backend is sqlite3 (the stdlib binding to the native C
library — filling leveldb's niche here: ordered iteration, batch atomic
writes, single-file persistence).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator, Optional


class Column:
    """DBColumn analogue (reference ``store/src/lib.rs`` DBColumn)."""

    BLOCK = "blk"
    STATE = "ste"
    STATE_SUMMARY = "ssm"
    COLD_STATE = "cst"
    COLD_BLOCK_ROOTS = "cbr"
    COLD_STATE_ROOTS = "csr"
    COLD_STATE_SLOTS = "csl"  # state root -> slot (freezer reverse index)
    COLD_PARTIAL = "cpt"      # chunked restore points (freezer.py)
    COLD_VREC = "cvr"         # interned validator records (id -> SSZ)
    COLD_VREC_INDEX = "cvi"   # validator record hash -> id
    COLD_RANDAO = "crn"       # epoch -> final randao mix
    PUBKEY_CACHE = "pkc"
    METADATA = "meta"
    FORK_CHOICE = "frk"
    OP_POOL = "opo"
    SLASHER = "sls"


class KeyValueStore:
    """Interface: get/put/delete/iteration + atomic batches."""

    def get(self, column: str, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, column: str, key: bytes, value: bytes) -> None:
        self.put_batch([(column, key, value)])

    def put_batch(self, items) -> None:
        raise NotImplementedError

    def delete(self, column: str, key: bytes) -> None:
        raise NotImplementedError

    def keys(self, column: str) -> Iterator[bytes]:
        raise NotImplementedError

    def iter_column(self, column: str) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def approx_size(self) -> int:
        """Approximate on-disk bytes (0 when unknown) — feeds the
        store_db_size_bytes gauge (reference exposes LevelDB sizes)."""
        return 0

    def close(self) -> None:
        pass


class MemoryStore(KeyValueStore):
    """Ephemeral store for tests/harnesses (reference memory_store.rs)."""

    def __init__(self):
        self._data: dict[str, dict[bytes, bytes]] = {}
        self._lock = threading.Lock()

    def get(self, column: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(column, {}).get(key)

    def put_batch(self, items) -> None:
        with self._lock:
            for column, key, value in items:
                self._data.setdefault(column, {})[key] = value

    def delete(self, column: str, key: bytes) -> None:
        with self._lock:
            self._data.get(column, {}).pop(key, None)

    def keys(self, column: str) -> Iterator[bytes]:
        with self._lock:
            return iter(sorted(self._data.get(column, {}).keys()))

    def iter_column(self, column: str) -> Iterator[tuple[bytes, bytes]]:
        with self._lock:
            return iter(sorted(self._data.get(column, {}).items()))

    def approx_size(self) -> int:
        with self._lock:
            return sum(
                len(k) + len(v)
                for col in self._data.values()
                for k, v in col.items()
            )


class SqliteStore(KeyValueStore):
    """Disk store over sqlite3 (native C). One table, (col, key) PK, WAL
    mode for concurrent readers. Atomic put_batch via a transaction."""

    def __init__(self, path: str):
        self._path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._conn:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                " col TEXT NOT NULL, key BLOB NOT NULL, value BLOB NOT NULL,"
                " PRIMARY KEY (col, key))"
            )

    def get(self, column: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE col=? AND key=?", (column, key)
            ).fetchone()
        return row[0] if row else None

    def put_batch(self, items) -> None:
        with self._lock, self._conn:
            self._conn.executemany(
                "INSERT OR REPLACE INTO kv (col, key, value) VALUES (?,?,?)",
                [(c, k, v) for c, k, v in items],
            )

    def delete(self, column: str, key: bytes) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM kv WHERE col=? AND key=?", (column, key)
            )

    def keys(self, column: str) -> Iterator[bytes]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key FROM kv WHERE col=? ORDER BY key", (column,)
            ).fetchall()
        return iter(r[0] for r in rows)

    def iter_column(self, column: str) -> Iterator[tuple[bytes, bytes]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE col=? ORDER BY key", (column,)
            ).fetchall()
        return iter((r[0], r[1]) for r in rows)

    def approx_size(self) -> int:
        import os

        try:
            return os.path.getsize(self._path)
        except OSError:
            return 0

    def close(self) -> None:
        self._conn.close()
