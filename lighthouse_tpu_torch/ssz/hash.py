"""hash-tree-root (Merkleization) over the SSZ descriptors.

Spec rules as in the reference's ``consensus/tree_hash``: basic values are
packed into 32-byte chunks; collections merkleize to their *limit* depth
using virtual zero subtrees (so a ``List[Validator, 2**40]`` does not
materialize 2^40 chunks); lists/bitlists mix in their length; unions mix
in their selector.
"""

from __future__ import annotations

import numpy as np

from .core import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    SSZError,
    Union,
    Vector,
    _Boolean,
    _ContainerMeta,
    _Uint,
    _pack_bits,
)
from .sha256 import ZERO_HASHES, hash32_concat, hash_pairs

BYTES_PER_CHUNK = 32


def _next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _pad_chunks(data: bytes) -> list[bytes]:
    if not data:
        return []
    if len(data) % BYTES_PER_CHUNK:
        data = data + bytes(BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK)
    return [data[i:i + BYTES_PER_CHUNK] for i in range(0, len(data), BYTES_PER_CHUNK)]


def merkleize(chunks: list[bytes], limit: int | None = None) -> bytes:
    """Merkle root of chunks padded (virtually) to ``limit`` leaves."""
    count = len(chunks)
    if limit is None:
        limit = count
    if count > limit:
        raise SSZError(f"merkleize: {count} chunks exceed limit {limit}")
    width = _next_pow2(limit)
    depth = (width - 1).bit_length()
    if count == 0:
        return ZERO_HASHES[depth]
    layer = chunks
    for d in range(depth):
        if len(layer) % 2:
            layer = layer + [ZERO_HASHES[d]]
        if len(layer) == 0:
            break
        arr = np.frombuffer(b"".join(layer), np.uint8).reshape(-1, 64)
        hashed = hash_pairs(arr)
        layer = [hashed[i].tobytes() for i in range(hashed.shape[0])]
    root = layer[0]
    return root


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash32_concat(root, length.to_bytes(32, "little"))


def _chunk_count(tpe) -> int:
    """Leaf-limit of a collection type (spec chunk_count)."""
    if isinstance(tpe, (_Uint, _Boolean)):
        return 1
    if isinstance(tpe, ByteVector):
        return (tpe.length + 31) // 32
    if isinstance(tpe, ByteList):
        return (tpe.limit + 31) // 32
    if isinstance(tpe, Bitvector):
        return (tpe.length + 255) // 256
    if isinstance(tpe, Bitlist):
        return (tpe.limit + 255) // 256
    if isinstance(tpe, Vector):
        if _is_basic(tpe.elem):
            return (tpe.length * tpe.elem.fixed_size() + 31) // 32
        return tpe.length
    if isinstance(tpe, List):
        if _is_basic(tpe.elem):
            return (tpe.limit * tpe.elem.fixed_size() + 31) // 32
        return tpe.limit
    raise SSZError(f"chunk_count: unsupported type {tpe!r}")


def _is_basic(tpe) -> bool:
    return isinstance(tpe, (_Uint, _Boolean))


def hash_tree_root(tpe, value=None) -> bytes:
    """Root of ``value`` under descriptor ``tpe``. For containers the value
    may be omitted (``hash_tree_root(instance)``)."""
    if value is None and isinstance(tpe, Container):
        value = tpe
        tpe = type(tpe)

    if _is_basic(tpe):
        return tpe.encode(value).ljust(32, b"\x00")
    if isinstance(tpe, ByteVector):
        return merkleize(_pad_chunks(tpe.encode(value)), _chunk_count(tpe))
    if isinstance(tpe, ByteList):
        data = tpe.encode(value)
        return mix_in_length(
            merkleize(_pad_chunks(data), _chunk_count(tpe)), len(data)
        )
    if isinstance(tpe, Bitvector):
        return merkleize(_pad_chunks(_pack_bits(value)), _chunk_count(tpe))
    if isinstance(tpe, Bitlist):
        if len(value) > tpe.limit:
            raise SSZError("Bitlist over limit")
        return mix_in_length(
            merkleize(_pad_chunks(_pack_bits(value)), _chunk_count(tpe)), len(value)
        )
    if isinstance(tpe, Vector):
        if _is_basic(tpe.elem):
            if len(value) != tpe.length:
                raise SSZError("Vector length mismatch")
            packed = b"".join(tpe.elem.encode(v) for v in value)
            return merkleize(_pad_chunks(packed), _chunk_count(tpe))
        return merkleize([hash_tree_root(tpe.elem, v) for v in value], tpe.length)
    if isinstance(tpe, List):
        if len(value) > tpe.limit:
            raise SSZError("List over limit")
        if _is_basic(tpe.elem):
            packed = b"".join(tpe.elem.encode(v) for v in value)
            root = merkleize(_pad_chunks(packed), _chunk_count(tpe))
        else:
            root = merkleize(
                [hash_tree_root(tpe.elem, v) for v in value], tpe.limit
            )
        return mix_in_length(root, len(value))
    if isinstance(tpe, Union):
        sel, val = value
        opt = tpe.options[sel]
        root = bytes(32) if opt is None else hash_tree_root(opt, val)
        return hash32_concat(root, sel.to_bytes(32, "little"))
    if isinstance(tpe, _ContainerMeta):
        leaves = [hash_tree_root(t, getattr(value, n)) for n, t in tpe.fields]
        return merkleize(leaves, len(leaves))
    raise SSZError(f"hash_tree_root: unsupported type {tpe!r}")
