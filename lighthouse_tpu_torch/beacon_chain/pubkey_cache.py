"""Validator pubkey cache (reference:
``beacon_node/beacon_chain/src/validator_pubkey_cache.rs:20-136``).

Decompression + subgroup checks happen ONCE, at validator-registry
admission; every subsequent signature build is an O(1) index lookup of the
already-validated point. This is the structural prerequisite for the TPU
batch path: sets are packed from decompressed points without touching the
per-block deserialization cost the round-1 code paid.

Persisted to the store (compressed bytes keyed by index) and reloaded at
startup, like the reference (``validator_pubkey_cache.rs:49,79``).
"""

from __future__ import annotations

import struct
from typing import Optional

from ..crypto import bls
from ..store.kv import Column


class PubkeyCacheError(ValueError):
    pass


class ValidatorPubkeyCache:
    def __init__(self, store=None):
        self.pubkeys: list[bls.PublicKey] = []
        self.indices: dict[bytes, int] = {}  # compressed bytes -> index
        self.store = store
        # admission listeners: the device-resident pubkey
        # table subscribes so deposits delta-sync host→device without
        # the cache importing the device stack
        self._listeners: list = []
        if store is not None:
            self._load()

    def subscribe(self, fn) -> None:
        """Call ``fn(cache)`` after every successful admission batch.
        Listener failures are contained (logged, never raised): a device
        mirror that cannot sync degrades that mirror — new indices fall
        back to the raw pack path — and must not fail block import."""
        self._listeners.append(fn)

    def unsubscribe(self, fn) -> None:
        """Remove a listener (no-op when absent): a stopped client must
        detach its device mirror or admissions would keep syncing — and
        keeping alive — a table nothing routes to anymore."""
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _load(self) -> None:
        rows = sorted(
            self.store.kv.iter_column(Column.PUBKEY_CACHE),
            key=lambda kv: struct.unpack("<Q", kv[0])[0],
        )
        for key, raw in rows:
            (idx,) = struct.unpack("<Q", key)
            if idx != len(self.pubkeys):
                raise PubkeyCacheError(f"pubkey cache gap at index {idx}")
            pk = bls.PublicKey.deserialize(raw)  # re-validated on load
            self.indices[raw] = idx
            self.pubkeys.append(pk)

    def import_new_pubkeys(self, state) -> None:
        """Admit validators beyond the current length. Raises on an invalid
        (non-subgroup / infinity) pubkey — such a validator cannot exist in
        a valid state (deposits are checked on the way in)."""
        n = len(self.pubkeys)
        if len(state.validators) <= n:
            return
        batch = []
        for idx in range(n, len(state.validators)):
            raw = bytes(state.validators[idx].pubkey)
            pk = bls.PublicKey.deserialize(raw)
            self.indices[raw] = idx
            self.pubkeys.append(pk)
            batch.append((Column.PUBKEY_CACHE, struct.pack("<Q", idx), raw))
        if self.store is not None and batch:
            self.store.kv.put_batch(batch)
        if batch:
            for fn in list(self._listeners):
                try:
                    fn(self)
                except Exception as e:
                    from ..utils import logging as tlog

                    tlog.log(
                        "warn", "pubkey-cache admission listener failed",
                        error=repr(e)[:120],
                    )

    def get(self, validator_index: int) -> bls.PublicKey:
        try:
            return self.pubkeys[validator_index]
        except IndexError:
            raise PubkeyCacheError(
                f"validator index {validator_index} beyond pubkey cache "
                f"({len(self.pubkeys)})"
            ) from None

    def get_index(self, pubkey_bytes: bytes) -> Optional[int]:
        return self.indices.get(bytes(pubkey_bytes))

    def resolver(self):
        """PubkeyResolver for the signature-set constructors."""
        return self.get

    def __len__(self) -> int:
        return len(self.pubkeys)
