"""Swap-or-not committee shuffling (spec ``compute_shuffled_index``;
reference: ``consensus/swap_or_not_shuffle``).

Two entry points:

* :func:`compute_shuffled_index` — single-index, the literal spec loop.
* :func:`shuffle_list` — whole-permutation, numpy-vectorized per round
  (one hash per 256-index block per round, then lane-parallel bit tests).
  The reference gets the same asymptotics with its ``shuffle_list``; this
  formulation keeps the whole permutation as flat arrays — the layout the
  TPU batch planner and committee caches consume directly.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def compute_shuffled_index(
    index: int, index_count: int, seed: bytes, rounds: int
) -> int:
    """Spec-exact single-index swap-or-not (forward direction)."""
    assert 0 <= index < index_count
    for r in range(rounds):
        pivot = int.from_bytes(_h(seed + bytes([r]))[:8], "little") % index_count
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = _h(seed + bytes([r]) + (position // 256).to_bytes(4, "little"))
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def _shuffle_rounds(n: int, seed: bytes, rounds) -> np.ndarray:
    """Apply swap-or-not rounds (an iterable of round numbers) to the full
    index vector at once."""
    idx = np.arange(n, dtype=np.int64)
    n_blocks = (n + 255) // 256
    for r in rounds:
        rb = bytes([r])
        pivot = int.from_bytes(_h(seed + rb)[:8], "little") % n
        flip = (pivot + n - idx) % n
        position = np.maximum(idx, flip)
        # one hash per 256-position block covering every `position` value
        blocks = np.frombuffer(
            b"".join(
                _h(seed + rb + blk.to_bytes(4, "little")) for blk in range(n_blocks)
            ),
            np.uint8,
        ).reshape(n_blocks, 32)
        byte = blocks[position // 256, (position % 256) // 8]
        bit = (byte >> (position % 8).astype(np.uint8)) & 1
        idx = np.where(bit.astype(bool), flip, idx)
    return idx


def shuffle_list(n: int, seed: bytes, rounds: int) -> np.ndarray:
    """``out[i] = compute_shuffled_index(i, n, seed)`` for all i at once."""
    if n == 0:
        return np.zeros(0, np.int64)
    return _shuffle_rounds(n, seed, range(rounds))


def unshuffle_list(n: int, seed: bytes, rounds: int) -> np.ndarray:
    """Inverse permutation (rounds applied in reverse order). Satisfies
    ``unshuffle[shuffle[i]] == i`` — what committee assignment actually
    needs: committee k is ``unshuffle_list(...)[k*size:(k+1)*size]``...
    i.e. the *positions whose shuffled index* lands in that slice."""
    if n == 0:
        return np.zeros(0, np.int64)
    return _shuffle_rounds(n, seed, range(rounds - 1, -1, -1))
