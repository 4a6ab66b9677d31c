"""Columnar (structure-of-arrays) state views for batched epoch
processing — the numpy tier of the per-epoch pipeline promised in
``state_transition/epoch.py``.

The reference's per-epoch processing is compiled Rust over struct-of-
validator arrays (``consensus/state_processing/src/per_epoch_processing/``);
a TPU-native framework holds the per-validator columns as flat arrays so
every pass is a handful of vector ops over the full validator set instead
of a million-iteration interpreter loop. These views are also the layout
a future device (jnp) tier consumes unchanged.
"""

from .columns import Columns, Fallback
from .epoch import process_epoch_columnar

__all__ = ["Columns", "Fallback", "process_epoch_columnar"]
