"""Merkle branch verification (reference: ``consensus/merkle_proof``)."""

from __future__ import annotations

from ..ssz.sha256 import hash32_concat


def is_valid_merkle_branch(
    leaf: bytes, branch, depth: int, index: int, root: bytes
) -> bool:
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = hash32_concat(branch[i], value)
        else:
            value = hash32_concat(value, branch[i])
    return value == root


def compute_merkle_root(leaves, depth: int) -> bytes:
    """Root of a depth-``depth`` tree over ``leaves`` (zero-padded)."""
    from ..ssz.sha256 import ZERO_HASHES

    layer = list(leaves)
    for d in range(depth):
        if len(layer) % 2:
            layer.append(ZERO_HASHES[d])
        layer = [
            hash32_concat(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)
        ] or [ZERO_HASHES[d + 1]]
    return layer[0] if layer else ZERO_HASHES[depth]
