"""Verification service: the continuous-batching layer between the
node's signature verifiers and the BLS backend (``batcher.py``), the
port's copy of the JAX package's. Callers submit signature sets; the
scheduler fuses submissions from many producers into shared device
batches under a latency deadline, with split-and-retry isolation so
per-submission verdicts stay identical to direct per-caller calls. At
flush time the shape-aware planner (``planner.py``) partitions the fused
submissions into kind-homogeneous, bin-packed sub-batches when that
reduces padded device lanes, and keeps the single-rung flush when it
cannot win. ``slo.py`` keeps the verdict-latency window, ``admission.py``
the bulk class's valve and ``traffic.py`` the arrival traces."""

from .admission import BulkAdmissionController
from .batcher import (
    BUCKET_LADDER,
    VerificationScheduler,
    backend_verify,
    backend_verify_bulk,
    backend_verify_each,
    backend_verify_now,
    round_up_bucket,
    scheduler_of,
)
from .planner import (
    FlushPlan,
    FlushPlanner,
    PlannedSubBatch,
    best_covering_rung,
    flush_geometry,
    live_lanes,
    padded_lanes,
    padding_waste_ratio,
    set_geometry,
)
from .slo import SloTracker

__all__ = [
    "BUCKET_LADDER",
    "BulkAdmissionController",
    "FlushPlan",
    "FlushPlanner",
    "PlannedSubBatch",
    "SloTracker",
    "VerificationScheduler",
    "backend_verify",
    "backend_verify_bulk",
    "backend_verify_each",
    "backend_verify_now",
    "best_covering_rung",
    "flush_geometry",
    "live_lanes",
    "padded_lanes",
    "padding_waste_ratio",
    "round_up_bucket",
    "scheduler_of",
    "set_geometry",
]
