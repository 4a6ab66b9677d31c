"""Bucket ladder, flush geometry and the covering-rung policy: the port's
own copies of the JAX package's ``verification_service`` helpers
(``batcher.py::round_up_bucket``, ``planner.py::flush_geometry`` and
``best_covering_rung``), plain Python with no device import.

ONE ladder: the device packers (``crypto/device/bls.py``) pad B, K and M
with :func:`round_up_bucket`, and the compile service routes and warms
the same rungs, so a flush of any size lands on a bounded set of captured
shapes.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Set, Tuple

Rung = Tuple[int, int, int]  # (B, K, M) padded bucket shape

# 48/96/192 are the intermediate rungs the JAX package's flush planner
# bin-packs onto (observed traffic shapes a power-of-two ladder padded up).
BUCKET_LADDER = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256, 512, 1024)


def round_up_bucket(n: int, ladder: Sequence[int] = BUCKET_LADDER) -> int:
    """Padded size for ``n`` sets (or pubkeys, or messages): the smallest
    ladder rung holding ``n``, then multiples of the top rung."""
    for c in ladder:
        if n <= c:
            return c
    top = ladder[-1]
    return ((n + top - 1) // top) * top


def padded_lanes(b: int, k: int, m: int) -> int:
    """Device lanes a padded (B, K, M) batch pays for: B * K * M."""
    return int(b) * int(k) * int(m)


def set_geometry(item) -> Tuple[int, Optional[bytes]]:
    """(pubkey count, hashable message key) of one signature set: an
    object with ``signing_keys`` and ``message`` or a ``(sig, pks, msg)``
    triple. Anything else counts as a 1-pubkey set with an un-keyable
    message (over-reserving only risks extra padding)."""
    keys = getattr(item, "signing_keys", None)
    msg = getattr(item, "message", None)
    if keys is None and isinstance(item, (tuple, list)) and len(item) == 3:
        keys, msg = item[1], item[2]
    k = len(keys) if keys is not None else 1
    if msg is None:
        return k, None
    try:
        return k, bytes(msg)
    except (TypeError, ValueError):
        return k, None


def flush_geometry(sets) -> Tuple[int, int, int]:
    """(n_sets, max pubkeys per set, unique messages) of a flush: the
    three dims the packers pad. Un-keyable messages each count distinct."""
    n = 0
    k = 1
    msgs: Set[bytes] = set()
    distinct = 0
    for item in sets:
        n += 1
        ki, key = set_geometry(item)
        k = max(k, ki or 1)
        if key is None:
            distinct += 1
        else:
            msgs.add(key)
    return n, k, max(1, len(msgs) + distinct)


def best_covering_rung(
    warm: Iterable[Rung], n: int, k: int, m: int
) -> Optional[Rung]:
    """Cheapest rung in ``warm`` covering (n, k, m): fewest padded lanes,
    then the smaller B, K, M. None when no rung covers it."""
    cands = [r for r in warm if r[0] >= n and r[1] >= k and r[2] >= m]
    if not cands:
        return None
    return min(cands, key=lambda r: (padded_lanes(*r), r[0], r[1], r[2]))
