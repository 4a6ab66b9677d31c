"""Greedy weighted maximum-coverage selection (reference:
``beacon_node/operation_pool/src/max_cover.rs:1-226``).

Each candidate exposes a cover set (dict key -> weight). The greedy
algorithm repeatedly takes the candidate with the largest *uncovered*
weight and removes its coverage from the rest — the classic (1 - 1/e)
approximation the reference uses for attestation packing.
"""

from __future__ import annotations

from typing import Callable, Iterable, TypeVar

T = TypeVar("T")


class MaxCoverItem:
    """Wraps a candidate with its current (shrinking) cover set."""

    __slots__ = ("item", "covering")

    def __init__(self, item, covering: dict):
        self.item = item
        self.covering = dict(covering)

    def score(self) -> int:
        return sum(self.covering.values())


def maximum_cover(
    items: Iterable[tuple[T, dict]], limit: int
) -> list[tuple[T, dict]]:
    """items: (candidate, {key: weight}). Returns up to ``limit``
    (candidate, covered-at-selection) pairs, highest-value first."""
    pool = [MaxCoverItem(i, c) for i, c in items if c]
    out = []
    for _ in range(limit):
        if not pool:
            break
        best = max(pool, key=MaxCoverItem.score)
        if best.score() == 0:
            break
        covered = dict(best.covering)
        pool.remove(best)
        for other in pool:
            for k in covered:
                other.covering.pop(k, None)
        out.append((best.item, covered))
    return out
