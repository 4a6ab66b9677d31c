"""Merkle proof GENERATION over SSZ container trees (reference:
``consensus/merkle_proof`` + ``BeaconState::compute_merkle_proof`` in
``consensus/types/src/beacon_state.rs`` — the light-client seam).

A container's hash-tree-root is the Merkle root of its field roots padded
to the next power of two; a field's generalized index is
``next_pow2(n_fields) + field_index``; nested paths multiply:
``gi(parent_path) * next_pow2(n_child) + child_index``.
"""

from __future__ import annotations

from .core import Container, _ContainerMeta
from .hash import _next_pow2, hash_tree_root
from .sha256 import ZERO_HASHES, hash_pairs

import numpy as np


def _field_roots(tpe, value) -> list[bytes]:
    return [hash_tree_root(t, getattr(value, n)) for n, t in tpe.fields]


def _tree_levels(leaves: list[bytes], width: int) -> list[list[bytes]]:
    """All levels bottom-up over ``width`` (pow2) leaves, zero-padded."""
    level = list(leaves) + [ZERO_HASHES[0]] * (width - len(leaves))
    # leaves of a container are real roots; padding uses zero chunks
    level = [bytes(x) for x in level]
    levels = [level]
    d = 0
    while len(level) > 1:
        pairs = np.frombuffer(b"".join(level), np.uint8).reshape(-1, 64)
        hashed = hash_pairs(pairs)
        level = [hashed[i].tobytes() for i in range(hashed.shape[0])]
        levels.append(level)
        d += 1
    return levels


def compute_merkle_proof(value: Container, path: list[str]) -> tuple[bytes, list[bytes], int]:
    """Branch for the field at ``path`` (e.g. ``["finalized_checkpoint",
    "root"]``) against ``hash_tree_root(value)``.

    -> (leaf_root, branch bottom-up, generalized_index). Only all-fixed
    container hops are supported (the light-client paths are)."""
    tpe = type(value)
    if not isinstance(tpe, _ContainerMeta):
        raise TypeError("proofs start at a container")
    name = path[0]
    fields = tpe.fields
    names = [n for n, _ in fields]
    idx = names.index(name)
    sub_tpe = dict(fields)[name]
    sub_val = getattr(value, name)

    width = _next_pow2(len(fields))
    depth = (width - 1).bit_length()
    leaves = _field_roots(tpe, value)
    levels = _tree_levels(leaves, width)

    branch = []
    i = idx
    for d in range(depth):
        branch.append(levels[d][i ^ 1])
        i //= 2

    gi = width + idx
    if len(path) == 1:
        return leaves[idx], branch, gi

    # recurse into the sub-container; its branch sits BELOW ours
    sub_leaf, sub_branch, sub_gi = compute_merkle_proof(sub_val, path[1:])
    sub_width = 1 << (sub_gi.bit_length() - 1)
    return sub_leaf, sub_branch + branch, gi * sub_width + (sub_gi - sub_width)


def verify_merkle_proof(
    leaf: bytes, branch: list[bytes], generalized_index: int, root: bytes
) -> bool:
    """Spec ``is_valid_merkle_branch`` driven by a generalized index."""
    from ..state_transition.merkle import is_valid_merkle_branch

    depth = generalized_index.bit_length() - 1
    index = generalized_index - (1 << depth)
    return is_valid_merkle_branch(leaf, branch, depth, index, root)
