"""Incremental hash-tree-root caching (reference: ``consensus/cached_tree_hash``).

The reference caches the internal Merkle layers of the big ``BeaconState``
fields and re-hashes only the paths touched since the last root. Same idea
here, arranged around the batched hashing seam:

* :class:`MerkleTreeCache` — stores every layer of one field's tree as a
  contiguous ``uint8[width, 32]`` matrix. ``update(leaves)`` vectorially
  diffs the new leaf matrix against the cached one and re-hashes only the
  changed pair-paths (one batched ``hash_pairs`` call per level). The diff
  doubles as the correctness guarantee: a cache fed a *different* state's
  leaves just does more work, never returns a wrong root.
* per-element root memo — container roots (validators) keyed by their
  field-value tuple (flat types) or SSZ encoding, with generational
  eviction, so unchanged elements skip merkleization between slots.
* :class:`CachedRootComputer` — drives both for a ``BeaconState``-shaped
  container: heavy list/vector fields go through tree caches, everything
  else recomputes via the plain path.
"""

from __future__ import annotations

import threading

import numpy as np

from .core import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Union,
    Vector,
    _Boolean,
    _ContainerMeta,
    _Uint,
)
from .hash import _chunk_count, _is_basic, hash_tree_root, merkleize, mix_in_length
from .sha256 import ZERO_HASHES, hash_pairs

_ZERO_ROWS = [np.frombuffer(z, np.uint8) for z in ZERO_HASHES]


def _depth_for_limit(limit: int) -> int:
    if limit <= 1:
        return 0
    return (limit - 1).bit_length()


class MerkleTreeCache:
    """Layered Merkle tree over up to ``2**depth`` virtual leaves with
    incremental (diff-based) updates."""

    def __init__(self, depth: int):
        self.depth = depth
        self._leaves: np.ndarray | None = None
        self._layers: list[np.ndarray] = []
        self._root: bytes = ZERO_HASHES[depth]

    # -- full rebuild ----------------------------------------------------

    def _rebuild(self, leaves: np.ndarray) -> bytes:
        self._leaves = leaves.copy()
        self._layers = []
        layer = self._leaves
        d = 0
        while layer.shape[0] > 1:
            n = layer.shape[0]
            if n % 2:
                layer = np.concatenate([layer, _ZERO_ROWS[d][None]], axis=0)
                n += 1
            nxt = hash_pairs(layer.reshape(n // 2, 64))
            self._layers.append(nxt)
            layer = nxt
            d += 1
        self._root = self._fold_zero(layer, d)
        return self._root

    def _fold_zero(self, top: np.ndarray, d: int) -> bytes:
        """Fold the single real node up through the remaining virtual
        all-zero right subtrees."""
        if self._leaves is None or self._leaves.shape[0] == 0:
            return ZERO_HASHES[self.depth]
        node = top[0].tobytes()
        pair = np.empty((1, 64), np.uint8)
        for lvl in range(d, self.depth):
            pair[0, :32] = np.frombuffer(node, np.uint8)
            pair[0, 32:] = _ZERO_ROWS[lvl]
            node = hash_pairs(pair)[0].tobytes()
        return node

    # -- incremental update ----------------------------------------------

    def update(self, leaves: np.ndarray) -> bytes:
        """``leaves`` is uint8[n, 32]; returns the depth-``self.depth``
        virtual-zero-padded root."""
        if leaves.shape[0] == 0:
            self._leaves = leaves.copy()
            self._layers = []
            self._root = ZERO_HASHES[self.depth]
            return self._root
        if (
            self._leaves is None
            or self._leaves.shape[0] != leaves.shape[0]
            # >1/4 changed: a full batched rebuild is cheaper than the
            # per-level gather/scatter bookkeeping
        ):
            return self._rebuild(leaves)
        changed = np.nonzero(np.any(self._leaves != leaves, axis=1))[0]
        if changed.size == 0:
            return self._root
        if changed.size > leaves.shape[0] // 4:
            return self._rebuild(leaves)

        np.copyto(self._leaves, leaves)
        layer = self._leaves
        idx = np.unique(changed >> 1)
        for d, nxt in enumerate(self._layers):
            n = layer.shape[0]
            pairs = np.empty((idx.size, 64), np.uint8)
            pairs[:, :32] = layer[2 * idx]
            right = 2 * idx + 1
            in_range = right < n
            pairs[in_range, 32:] = layer[right[in_range]]
            pairs[~in_range, 32:] = _ZERO_ROWS[d]
            nxt[idx] = hash_pairs(pairs)
            layer = nxt
            idx = np.unique(idx >> 1)
        self._root = self._fold_zero(layer, len(self._layers))
        return self._root


def _flat_fields(tpe) -> bool:
    """True when every field is a basic/bytes value — then the field
    tuple is an immutable, cheap memo key. Types with nested containers
    or lists fall back to the encoding key (a nested mutable object in a
    dict key could be mutated after insertion and poison the table)."""
    return all(
        isinstance(t, (_Uint, _Boolean, ByteVector)) for _, t in tpe.fields
    )


class _ElemRootMemo:
    """Container-root memo with generational eviction.

    Key = the tuple of field VALUES for flat (all-basic-field) types —
    one attribute read per field, ~20x cheaper than SSZ-encoding the
    element just to look it up (the encode cost dominated the incremental
    state root at mainnet registry sizes); other types key by encoding."""

    def __init__(self, cap: int = 1 << 21):
        self.cap = cap
        self._new: dict = {}
        self._old: dict = {}
        self._flat: dict = {}

    def get(self, tpe, value) -> bytes:
        flat = self._flat.get(tpe)
        if flat is None:
            flat = self._flat[tpe] = _flat_fields(tpe)
        if flat:
            key = (tpe, *(getattr(value, n) for n, _ in tpe.fields))
        else:
            key = tpe.encode(value)
        try:
            root = self._new.get(key)
        except TypeError:  # a flat field held an unhashable value
            key = tpe.encode(value)
            root = self._new.get(key)
        if root is None:
            root = self._old.get(key)
            if root is None:
                root = hash_tree_root(tpe, value)
            self._new[key] = root
            if len(self._new) > self.cap:
                self._old = self._new
                self._new = {}
        return root


class CachedRootComputer:
    """hash_tree_root for a container with incremental caching of its
    list/vector fields. One computer per chain (or one global default) —
    feeding it unrelated states is safe, only slower."""

    def __init__(self):
        self._trees: dict[str, MerkleTreeCache] = {}
        self._memo = _ElemRootMemo()
        # The BeaconProcessor runs >1 worker thread; a computer shared
        # across threads (e.g. a per-chain instance reached from HTTP and
        # worker threads) must serialize — the diff-then-rehash in
        # MerkleTreeCache.update is not atomic, so interleaved updates
        # would permanently corrupt cached layers.
        self._lock = threading.Lock()

    def _tree(self, key: str, depth: int) -> MerkleTreeCache:
        t = self._trees.get(key)
        if t is None or t.depth != depth:
            t = self._trees[key] = MerkleTreeCache(depth)
        return t

    # -- leaf-matrix builders -------------------------------------------

    def _container_list_leaves(self, tpe, values) -> np.ndarray:
        out = np.empty((len(values), 32), np.uint8)
        memo = self._memo
        elem = tpe.elem
        for i, v in enumerate(values):
            out[i] = np.frombuffer(memo.get(elem, v), np.uint8)
        return out

    @staticmethod
    def _packed_basic_leaves(elem, values) -> np.ndarray:
        size = elem.fixed_size()
        per_chunk = 32 // size
        n_chunks = (len(values) + per_chunk - 1) // per_chunk
        if isinstance(elem, _Uint) and elem.bits in (8, 16, 32, 64):
            arr = np.asarray(values, dtype=f"<u{size}")
        elif isinstance(elem, _Boolean):
            arr = np.asarray(values, dtype=np.uint8)
        else:
            data = b"".join(elem.encode(v) for v in values)
            arr = np.frombuffer(data, np.uint8)
        raw = arr.view(np.uint8).reshape(-1)
        out = np.zeros((n_chunks, 32), np.uint8)
        out.reshape(-1)[: raw.size] = raw
        return out

    @staticmethod
    def _bytes32_vector_leaves(values) -> np.ndarray:
        return np.frombuffer(b"".join(values), np.uint8).reshape(-1, 32)

    # -- the public entry ------------------------------------------------

    def hash_tree_root(self, value: Container) -> bytes:
        with self._lock:
            tpe = type(value)
            leaves = []
            for name, t in tpe.fields:
                v = getattr(value, name)
                leaves.append(self._field_root(name, t, v))
            return merkleize(leaves, len(leaves))

    def _field_root(self, name: str, t, v) -> bytes:
        if isinstance(t, List):
            depth = _depth_for_limit(_chunk_count(t))
            if isinstance(t.elem, _ContainerMeta):
                lv = self._container_list_leaves(t, v)
            elif _is_basic(t.elem):
                lv = self._packed_basic_leaves(t.elem, v)
            elif isinstance(t.elem, ByteVector) and t.elem.length == 32:
                lv = (
                    self._bytes32_vector_leaves(v)
                    if v
                    else np.empty((0, 32), np.uint8)
                )
            else:
                return hash_tree_root(t, v)
            root = self._tree(name, depth).update(lv)
            return mix_in_length(root, len(v))
        if isinstance(t, Vector):
            depth = _depth_for_limit(_chunk_count(t))
            if _is_basic(t.elem):
                lv = self._packed_basic_leaves(t.elem, v)
            elif isinstance(t.elem, ByteVector) and t.elem.length == 32:
                lv = self._bytes32_vector_leaves(v)
            else:
                return hash_tree_root(t, v)
            return self._tree(name, depth).update(lv)
        return hash_tree_root(t, v)


# Default computers for the state transition's per-slot root refresh — a
# small LIFO POOL, not thread-local: per-thread computers would start cold
# on every ThreadingHTTPServer request thread (a full re-merkleization per
# request), while a single shared computer would serialize concurrent
# state transitions AND thrash its diff trees between unrelated state
# lineages (trees are keyed by field name). LIFO checkout keeps the
# warmest computer with the active lineage; concurrent transitions get
# their own.
_POOL: list[CachedRootComputer] = []
_POOL_CAP = 4
_POOL_LOCK = threading.Lock()


def cached_state_root(state) -> bytes:
    with _POOL_LOCK:
        computer = _POOL.pop() if _POOL else CachedRootComputer()
    try:
        return computer.hash_tree_root(state)
    finally:
        with _POOL_LOCK:
            if len(_POOL) < _POOL_CAP:
                _POOL.append(computer)
