"""L3 persistence: key-value stores, the hot/cold split DB, iterators.

Reference: ``beacon_node/store`` (``hot_cold_store.rs``,
``memory_store.rs``, ``iter.rs``, ``leveldb_store.rs``).
"""

from .hot_cold import HotColdDB, StateSummary, StoreError
from .iter import block_roots_iter, state_roots_iter
from .kv import Column, KeyValueStore, MemoryStore, SqliteStore

__all__ = [
    "Column",
    "HotColdDB",
    "KeyValueStore",
    "MemoryStore",
    "SqliteStore",
    "StateSummary",
    "StoreError",
    "block_roots_iter",
    "state_roots_iter",
]
