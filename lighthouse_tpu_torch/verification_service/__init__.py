"""The verification service's shape helpers: the bucket ladder every
packer and the compile service pad to, a flush's geometry and the
covering-rung policy (``planner.py``). The scheduler that fuses
submissions is not ported yet."""

from .planner import (
    BUCKET_LADDER,
    best_covering_rung,
    flush_geometry,
    padded_lanes,
    round_up_bucket,
    set_geometry,
)

__all__ = [
    "BUCKET_LADDER",
    "best_covering_rung",
    "flush_geometry",
    "padded_lanes",
    "round_up_bucket",
    "set_geometry",
]
