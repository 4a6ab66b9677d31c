"""BeaconProcessor: bounded work queues + worker pool + batch coalescing.

Reference: ``beacon_node/network/src/beacon_processor/mod.rs`` — a manager
task feeding <= CPU-count blocking workers from bounded per-kind queues;
when a worker frees up, up to MAX_GOSSIP_ATTESTATION_BATCH_SIZE=64 pending
gossip attestations (or aggregates) are popped and executed as ONE batch
(``mod.rs:176-177,1008-1099``), with queue-overflow shedding and a
re-processing queue for too-early/unknown-parent work
(``work_reprocessing_queue.rs``).

Device-first deltas from the reference's design:

* the coalesced batch is the DEVICE batch: default ceilings match the
  device bucket sizes (256 unaggregated / 64 aggregates vs the
  reference's 64/64) — the whole point of the device backend is that the
  batch ceiling rises without per-item latency cost;
* batch assembly is paced by worker availability exactly like the
  reference: an idle pool drains items one-by-one (lowest latency), a
  busy pool accumulates device-sized batches (highest throughput).
"""

from .processor import BeaconProcessor, Work, WorkKind

__all__ = ["BeaconProcessor", "Work", "WorkKind"]
