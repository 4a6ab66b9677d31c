"""Slasher, the port of the JAX package's ``slasher/``: double-vote +
min-max surround detection.

Reference: ``slasher/`` (``src/lib.rs:20-48`` AttesterSlashingStatus,
``src/array.rs`` chunked min/max span arrays over (validator, epoch),
``attestation_queue.rs``/``block_queue.rs`` batching, feeding found
slashings into the op pool via ``slasher/service``). Host code: the
evidence it finds reaches the card as the signature sets of the block
that carries it.
"""

from .slasher import AttesterSlashingStatus, Slasher

__all__ = ["AttesterSlashingStatus", "Slasher"]
