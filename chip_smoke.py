"""Chip smoke check of lighthouse_tpu_torch on one NVIDIA GPU (H100).

Drives the port's main path, BLS batch verification of signature sets,
through the entry point a node calls (``CudaBackend.verify_signature_sets``)
on its raw, gathered (device key table) and collapsed paths, at mainnet
shapes, and holds each of its three CUDA kernels against its
plain torch version on the card. Phases, in order; any failure raises:

1. device: require CUDA, print the card's name and power limit, build the
   kernels from ``lighthouse_tpu_torch/csrc`` and print the build time and
   what ptxas reports (registers, spills);
2. kernels: K1 ``fp_mul_cols`` (raw columns and reduced limbs equal),
   K2 ``fp2_mul`` and K3 ``fp2_sq`` (canonical-equal, limbs in [0, 8191])
   against their plain versions at 1, 3, 5, 1170 and 3474 lanes, with the
   all-8191 and all-zero worst cases, a broadcast operand and an empty
   batch;
3. gossip batch: 64 single-signer attestations from 8 committees of one
   slot (K = 1, M = 8): valid -> True, one message tampered -> False; the
   decompressed signatures and the device hash-to-G2 of this batch are
   also held against the host oracle;
4. block batch: 128 aggregate attestations with 180..229 signers each plus
   the proposal and RANDAO sets (B = 130 on the 192 rung, K <= 256,
   M = 130): valid -> True, one non-subgroup signature -> False;
5. key table: a registry of 2^19 validators (secrets 1..N, built in
   Jacobian coordinates with one batch inversion), the first half synced
   at startup, the rest delta-admitted, which grows the table to the
   next rung by a device copy; each sync's seconds, upload bytes and
   status;
6. gathered verifies: gossip and block batches redrawn from the
   registry's own points, verified on the gathered path (collapse held
   off): valid -> True, non-subgroup -> False; a block batch with one
   foreign key falls back to the raw path and still verifies; the
   gathered pubkey planes equal the raw planes on live slots;
7. collapse: a fresh block batch seen three times with the table's
   default ``agg_min_repeats`` (2): the second sighting pays the host
   sums (seconds printed) and ships K = 1, the third hits; a poisoned
   signature over the collapsed rows -> False;
8. msm: ``device_msm_g1`` at N = 512 with random u64 scalars equal to
   the host reference (registry row i is [i + 1]G, so the MSM is the C
   library's [sum s_i (i + 1)]G) and ``device_sum_g2`` at N = 128 equal
   to the host fold; one committee's
   all-ones MSM equal to the table's host sum; a committee inserted with
   ``insert_precomputed`` ships K = 1 at its first sighting -> True;
9. warm dispatch: the graphs captured on first use in phases 3-8 are
   dropped; a ``CompileService`` over the rungs those batches landed on,
   then the first ``WARM_DEFAULT_RUNGS`` of ``DEFAULT_RUNGS``, with the MSM
   ladder on, captures every stage graph ahead of traffic (per rung and
   stage: capture and eager warm-up seconds, node count, pool bytes); with
   the service attached the gossip, raw block, gathered block and
   collapsed block batches are verified again, every stage replaying its
   graph, their credited launches and lanes equal to the eager run's; a
   stale-input sequence (valid, poisoned, valid, other signers valid and
   poisoned) on one rung; the MSM and G2 sum through their graphs equal to
   the host fold. Each served batch's transfer-ledger H2D bytes per verify
   must equal ``last_batch["h2d_bytes"]`` (pubkey-plane bytes beside
   them), each verify journaling one ``bls_stage_verify`` event and one
   ``transfer_ledger`` row; then ``stage_latency_summary()``'s rows, and
   the warm gossip, block and gathered block verifies with every
   telemetry knob on, off, and on but the transfer ledger's
   (``OVERHEAD_ROUNDS`` squared each, medians side by side; on against
   off held to max(5%, 5 ms));
10. concurrent warm: the phase-9 service's worker is asked for the cold
   rungs ``CONCURRENT_COLD`` of ``DEFAULT_RUNGS`` and captures them while
   this thread serves
   the warm gossip and gathered block batches in turns: each wall (under
   ``WARM_WALL_LIMIT_S``), the lock waits, each capture's span and how far
   the verifies overlapped the captures; the counters must end at the
   verifies' eager counts plus the worker's warm-ups; the pipeline
   profiler's bubbles of the warm traffic, by cause, must sum to its idle
   time with ``compile`` the cause beside the captures;
11. engines: the gossip batch verified under each of ``ENGINE_TRIPLES``
   (the composed Fp2 and line steps over each ``fp.mul`` engine): valid
   (a capture, then a replay) and poisoned, each triple's capture
   seconds, nodes and walls; then the default triple's graphs replay
   with no new capture;
12. serve: the port's ``VerificationScheduler`` with the phase-9 compile
   service attached and its default verifier (the card), replaying
   ``traffic.gossip_steady`` (``SERVE_DURATION_S`` seconds at the
   generator's mainnet-shaped rates) three times, each event submitted at
   its time as a real signed set of its kind: a cold pass (flushes route
   warm, or padded onto a warm rung while the worker warms their exact
   rungs), ``wait_idle``, a warm pass with one attestation signed over the
   wrong message and the phase-4 and phase-6 block batches through
   ``verify_now`` (with ``--planner-off`` run again with the flush planner
   off, every flush one rung, to compare), and a shed pass through a
   second compile service that holds only ``SERVE_SHED_RUNG``: the first
   flush of each geometry sheds to the C fallback while that service's
   worker warms its rung. Per pass: submissions, flushes, sub-batches,
   routes and fallback calls, each kind's p50/p99 submit-to-verdict
   latency and miss ratio by path, bisections, the K1-K3 launches
   credited, the graphs captured and the ``verify_now`` walls; each
   pass's lane counts join phase 13's. Every verdict must be right (the
   poisoned one alone False), the warm pass must shed nothing and launch
   K1-K3, the shed pass must serve a shed flush on the fallback, and the
   fallback is ``cpu-native``. Each pass (here and in 12b) also prints the
   pipeline profiler's bubbles per shard by cause, which must sum to the
   idle time, its flush phases and overlap potential, and must journal
   one ``pipeline_flush`` event per flush. The phase ends when the service
   is idle;
12b. mesh (``crypto/device/mesh.py``), with the phase-9 service, phase 5's
   key table and phase 12's pools, each step a ``MESH_DURATION_S`` pass of
   ``traffic.gossip_steady`` (seed 1) through the scheduler, ended when
   the compile service is idle: the mesh this
   machine discovers (one shard on ``cuda:0``, every sub-batch tagged
   shard 0, K1-K3 launched, its status and latencies beside phase 12's
   warm pass); then ``DeviceMesh(devices=[cuda:0, cuda:0])``: a key table
   over the registry syncs two equal replicas (twice the upload), the
   service walks its ladder for shard 1 capturing no graph, a gathered
   block verifies from each replica, and flushes split across shards 0
   and 1 on two threads, each shard with its bubble ratio; a verifier
   that raises ``InjectedFault`` in
   shard 1's scope loses it (the poisoned set the only False, failed probes
   journaled with growing attempts); cleared, shard 1 is re-admitted with
   no graph captured and flushes split again (a gathered block batch
   through ``verify_now``); a ``MESH_HANG_S`` hang on shard 1 under a
   ``MESH_WATCHDOG_S`` watchdog is reaped within the deadline plus 0.5 s
   with right verdicts; then a hang inside a graph replay on shard 1, with
   the graph's lock held (``CapturedProgram._outputs`` wrapped here), is
   reaped and the sets fail over to shard 0, which replays the same graph:
   run with the failover's ``graphs.no_graph_wait`` off (the port before
   it) and on, at ``REPLAY_HANG_S``, each with its reap and failover
   walls; with it on, the failover must give the
   right verdict within the deadline. The phase ends with no mesh
   attached;
12c. telemetry, with the phase-9 service and phase 12's pools: one more
   ``TELEMETRY_DURATION_S`` pass of ``traffic.gossip_steady`` (seed 2) with
   the slot ledger and the capacity estimator reset and its sampler
   ticking every ``TELEMETRY_SAMPLE_S``: the capacity estimate with its
   cost source (the bulk valve's headroom must be the estimate's), the
   transfer ledger's data movement, the slot ledger's chain time,
   ``stage_latency_summary()`` and ``device_memory_bytes{kind}`` beside
   ``torch.cuda.memory_reserved()``;
12d. chain (``lighthouse_tpu_torch/beacon_chain``, built by the port's
   ``client.ClientBuilder``): an interop chain of ``CHAIN_VALIDATORS``
   validators at the mainnet preset with altair from genesis, made by the
   port's ``StateHarness`` (signed by the C library) in a producer
   process and carried as SSZ bytes. The block chain's node here has the
   ``cuda`` backend with the JAX builder's wiring in its order: the
   operation pool's ``DeviceAggregator`` (``device_msm``), a mesh, a key
   table over its pubkey cache (startup sync, the delta listener), the
   duty lookahead, its own compile service warming ``CHAIN_RUNGS`` and
   the MSM ladder, a ``VerificationScheduler``, the beacon processor and
   HTTP on a free port; its ``ManualSlotClock`` is the process clock.
   Each of ``CHAIN_SLOTS`` slots imports its block through
   ``process_block`` (``verify_now``), verifies the slot's unaggregated
   attestations in batches of ``CHAIN_GOSSIP_BATCH`` (one signed by the
   wrong key, which must be the only rejection, ``InvalidSignature``)
   and its four aggregates, and hands its sync messages to the beacon
   processor, which verifies them and fills the operation pool. The
   lookahead must warm all 128 committees of ``CHAIN_LOOKAHEAD_EPOCH``
   through the card before its first slot, whose four aggregates must
   then collapse on their first sighting. At ``CHAIN_CONTRIB_SLOTS`` each
   subcommittee's sync contribution is asked for over HTTP (a 128-point
   G2 sum on the card), at ``CHAIN_PRODUCE_SLOTS`` a block is produced
   over HTTP (a 512-point sync aggregate; not imported), and every pool
   sum must take the device path. A second node, built the same way in
   its own process (the key table seam is one a process) with its own
   compile service warming ``CHAIN_SEGMENT_RUNGS``, gets the same blocks
   over the port's network: it dials the oracle below and range-syncs
   from it (``RangeSync`` pulling ``blocks_by_range`` over the Noise +
   snappy transport, each batch ``CHAIN_SEGMENT`` work for the beacon
   processor: ``process_chain_segment``, the bulk class), re-statusing
   the oracle each time its head reaches a mark (``sync_marks``: every
   ``CHAIN_SEGMENT_BLOCKS`` slots and the last), so the sync overlaps the
   chain; no flush may shed to the host. A late joiner, built the same
   way in a process of its own with a compile service warming
   ``CATCH_UP_RUNGS``, dials the oracle only once its head has reached
   ``RangeSync.BATCH`` and syncs from genesis, so its first batch is a
   whole ``RangeSync.BATCH`` (32) blocks in one ``process_chain_segment``
   call; it runs on after the phase's other checks and is read after it
   (``catch_up_result``: every root equal to the oracle's, no flush shed,
   K1-K3 launched, its segment walls, its lane counts for phase 13). A
   third node in its own
   process, on ``cpu-native`` (its pool has no aggregator: every sum is
   the host fold) and listening on the network, is the oracle: every
   head root, post-state root,
   verdict, contribution and produced block of both must equal its own,
   each produced sync aggregate must verify there, and K1-K3 must launch
   in both card nodes. Printed: the block-import wall (median, p90) and
   the verify's share of it, gossip submit-to-verdict p50/p99 per kind,
   sets per flush, the segment walls, the key table's paths, the
   lookahead's epoch wall, the pool's sums, a delta sync of one more
   validator admitted through the pubkey cache (the harness makes no
   deposits), and the node's two device callers (the lookahead's MSM at
   N=128, the pool's G2 sums at 128 and 512 points) called once more
   alone against the host fold with their launches; the segment node's
   sync: blocks and batches (``sync_range_*``), the bytes it read from the
   wire, the sync wall and each segment's; the phase's lane counts join
   phase 13's. The slasher: the block chain's node and the oracle are built
   with ``slasher=True`` (persisting under ``Column.SLASHER`` in their
   stores) and one beacon-processor worker, and the slot's aggregates go
   to the beacon processor (verified on the card, applied to fork choice,
   put in the pool, handed to the slasher). At ``EQUIVOCATION_SLOT`` the
   producer adds a conflicting aggregate (a second aggregator, the votes of
   ``EQUIVOCATORS`` members for the parent block) and a second block from
   the slot's proposer, handed to the beacon processor after the slot's
   block, which also comes by gossip there: gossip must reject it on both
   nodes (``RepeatProposal``) after the slasher saw its header. Before the
   block produced at slot 33, each node's slot timer must have drained one
   attester slashing per double voter and the proposer slashing into its
   pool (read over HTTP, byte-equal on both); the produced block must carry
   one of each. Signed here with its proposer's interop key (the C
   signer), it is imported on both nodes as a sibling of the harness's
   block 33: a copy whose attester slashing carries a re-signed
   attestation must be rejected (``InvalidSignature``), then the block must
   import on the card on the warm rung (192, 512, 192), K1-K3 launched,
   post-state root equal to the oracle's, the double voters and the
   proposer slashed. Printed: the slasher's ``slasher_batch_seconds``
   (count, sum), slashings found, validators tracked and span bytes, rows
   and bytes held and flushed under ``Column.SLASHER``, each node process's
   resident memory, the sibling import's wall and verify share; its lane
   counts join phase 13's. ``eth1/`` and ``execution_layer/`` have no phase:
   no node builds them and they reach no device (their CPU tests hold them
   to the JAX package's);
12e. the devnet (``devnet_phase``): ``python -m lighthouse_tpu_torch bn
   --bls-backend cuda --listen-port P`` at the minimal preset (64 interop
   validators, its compile service holding ``DEVNET_RUNGS``), a second
   ``bn --bls-backend cpu-native --boot-nodes 127.0.0.1:P`` and ``vc
   --interop-keys 0:64`` on the card bn, genesis ``DEVNET_GENESIS_S`` after
   the launch, for ``DEVNET_SLOTS`` slots of the system clock: the card bn
   answers health, ``/lighthouse/health`` and ``/metrics`` (Prometheus
   text) with its rung warm before genesis; the vc proposes and attests
   through its HTTP API; both heads end equal and 3 or more slots past
   genesis; the card bn's ``/metrics`` show its verifies on the card, K1-K3
   launched and no flush shed; the vc's slashing-protection database holds
   every canonical block; each process exits 0 within ``BN_EXIT_S`` of
   SIGTERM with no lock file, all within ``DEVNET_BUDGET_S``. The card
   bn's own launches by lane count from the vc's start to its stop (its
   ``/lighthouse/health`` ``kernels`` block) join phase 13's. It runs
   beside phase 11 (on a thread of this script, its own processes; phase
   11 checks verdicts and replays, no wall) and is read when phase 12d
   ends;
13. kernel timings where the path runs them: each kernel checked again and
   timed (device ms per launch, launches queued back to back behind a
   device sleep, CUDA events) with its plain version and its bound at 1
   lane, at the most frequent and at the largest lane count of the block
   batch's valid verify (K3 at every lane count either batch launched),
   and at the shapes earlier versions timed; beside them the launch
   floor, the device time per launch of a one-element in-place add
   queued the same way;
14. two more valid verifies, graph replays, of each raw batch, of the
   gathered block batch and of the collapsed block batch: one timed by
   CUDA events around the replays, one under torch.profiler (which sees
   the kernels inside the graphs): the device busy share, and for the raw
   batches each kernel's device ms per verify beside its lanes per verify
   and the bound summed over them.

Each stage is one CUDA graph per rung (``graphs.CapturedProgram``): a
rung's first verify runs the eager warm-ups and captures, later ones
replay, and the counts of the two must be equal. Each batch is verified
three times (median wall printed); every verify prints its path, padded
rung, whether it replayed, its per-stage walls, host resolve and pack
seconds and the bytes it copied to the card.

The counts of kernel launches (and the lanes they carry) are set to 0
just before each verify and read just after it. The kernels line reports
the launches of the valid block-batch verify. Keys and messages are made
from ``--seed``; the host signers (pure Python for single signers, the C
library for committees) are independent of the device hash-to-curve.

    python3 chip_smoke.py            # the full check (one card)
    python3 chip_smoke.py --quick    # build, kernel checks and timings, graphs, tiny verifies,
                                     # a concurrent warm-up, the engine triples, MSM
    python3 chip_smoke.py --time-only DIR   # time the kernels of the checkout at DIR
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MEM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
INT32_MAC_RATE = 16.75e12  # int32 multiply-adds/s: 64 INT32 lanes/SM x 132 SMs x 1.98 GHz
SLEEP_HZ = 2.0e9           # cycles per second for torch.cuda._sleep (above the SM clock)

KERNELS = ("fp_mul_cols", "fp2_mul", "fp2_sq")
REPLACES = {
    "fp_mul_cols": "lighthouse_tpu/crypto/device/pallas_fp.py:60",
    "fp2_mul": "lighthouse_tpu/crypto/device/pallas_fp2.py:145",
    "fp2_sq": "lighthouse_tpu/crypto/device/pallas_fp2.py:159",
}
# the kernel's name in the profiler's rows
PROFILE_NAME = {"fp_mul_cols": "::fp_mul_kernel", "fp2_mul": "::fp2_mul_kernel",
                "fp2_sq": "::fp2_sq_kernel"}
# bytes one lane reads and writes: two (one) operands and the result
LANE_BYTES = {"fp_mul_cols": 3 * 32 * 4, "fp2_mul": 3 * 64 * 4, "fp2_sq": 2 * 64 * 4}
# The key table's registry: 2^19 validators, the order of mainnet's
# registry when the reference's v3.3.0 shipped.
REGISTRY_SIZE = 1 << 19
# The warm phase's compile service walks the batches' rungs, then this many
# of the default rungs (a rung's three captures take about 10 s on an H100,
# so the whole ladder would take minutes; one keeps the script inside its
# time limit); and waits this long for them.
WARM_DEFAULT_RUNGS = 1
WARM_TIMEOUT_S = 600
# The concurrent-warm phase queues these rungs of DEFAULT_RUNGS (by index;
# cold after phase 9) on the compile service's worker while this thread
# serves warm batches, whose walls must stay under WARM_WALL_LIMIT_S (a
# stage-3 capture alone takes 2.4 s or more on an H100; one rung's three
# captures keep the script inside its time limit).
CONCURRENT_COLD = (3,)
WARM_WALL_LIMIT_S = 1.0
# The engine phase's (fp, fp2, line) engine triples, each verified on the
# gossip batch (its first verify captures the rung under that triple, about
# 40 s under a composed fp engine).
ENGINE_TRIPLES = (("toeplitz_int32", "composed", "composed"),
                  ("matmul_int8", "composed", "composed"),
                  ("pallas_int8", "composed", "composed"))
# The serve phase's trace: traffic.gossip_steady at its own mainnet-shaped
# rates (40 unaggregated, 12 aggregates, 6 sync messages per second) for
# this many seconds; its pools: committees of 8 signers (one attestation
# message each) and sync-committee signers over one block root.
SERVE_DURATION_S = 2.0
SERVE_COMMITTEES = 7
SERVE_SYNC = 16
# the shed pass's second compile service warms only this rung: the
# precomputed committee's (phase 8), which phase 9 captures
SERVE_SHED_RUNG = (1, 1, 1)
# The mesh phase: each pass replays this much of traffic.gossip_steady
# (seed 1) through the scheduler; the split passes' planner puts a kind
# group on two shards from 2 x MESH_DP_MIN_SETS sets; the probe backoff of
# the two-shard mesh; the watchdog's deadline and the injected hang
MESH_DURATION_S = 1.5
MESH_DP_MIN_SETS = 2
MESH_PROBE_BASE_S = 0.5
MESH_PROBE_MAX_S = 2.0
MESH_WATCHDOG_S = 2.0
MESH_HANG_S = 4.0
# mesh step 6: the hang inside a replay, longer than the watchdog's
# deadline by more than the deadline again (so a failover that waits on the
# lock is reaped too)
REPLAY_HANG_S = 5.0
# phase 9's telemetry overhead: rounds of verifies per mode and batch (the
# same count of verifies in each round)
OVERHEAD_ROUNDS = 2
# The telemetry phase: one more pass of traffic.gossip_steady (seed 2) this
# long, with the capacity sampler ticking at this interval (the node's
# default is 10 s, longer than the pass)
TELEMETRY_DURATION_S = 3.0
TELEMETRY_SAMPLE_S = 0.5
# The chain phase: the port's beacon chain at the mainnet preset with
# altair from genesis and this many validators (four full 128-wide
# committees a slot, a 512-member sync committee), over this many slots
# (the fewest that cross an epoch boundary: at 40 the phase took 349 s on
# an H100, about 7.5 s a slot of the block chain's host work and gossip
# verdicts); unaggregated attestations go to the chain's
# batch verifier this many at a time, and the segment chain imports the
# blocks this many a process_chain_segment call (one bulk batch each). The
# compile service warms these rungs first: gossip batches and their
# bisection halves, the aggregates, a slot's sync messages, a block (raw
# and with committees collapsed by the key table), and the sibling block
# that carries the slasher's evidence (128 attestations, the proposal,
# RANDAO and sync aggregate sets, two header sets and two indexed
# attestation sets: 135 sets with up to 512 keys, 134 messages); the
# segment chain's own service warms a segment's (its sync committee raw,
# then collapsed).
CHAIN_VALIDATORS = 16384
CHAIN_SLOTS = 33
CHAIN_GOSSIP_BATCH = 64
CHAIN_SEGMENT_BLOCKS = 8
# the segment node's status polls of the oracle: within the status quota of
# the port's peer manager (a burst of 8, then one a second)
STATUS_POLL_S = 2.0
CHAIN_RUNGS = ((64, 1, 8), (16, 128, 16), (512, 1, 1), (8, 512, 8), (8, 1, 8),
               (192, 512, 192))
# an 8-block segment is 7 sets a block (56, the 64 rung); the 128 rung
# holds a range-sync batch of up to 18 blocks, should the oracle's head run
# past a mark before the node asks
CHAIN_SEGMENT_RUNGS = ((64, 512, 64), (64, 128, 64), (128, 512, 128))
# the late joiner's rung: its first range-sync batch is RangeSync.BATCH
# (32) blocks, about 7 sets a block (224, the 256 rung; up to 512 keys
# in the sync aggregate's set, a message a set at most); the last block
# pads onto it
CATCH_UP_RUNGS = ((256, 512, 256),)
# RangeSync waits this long for a batch's import before its thread gives
# up until the next status (network/service.py)
RANGE_SYNC_WAIT_S = 60.0
CHAIN_TIMEOUT_S = 600
# The node around the chain: the committees a slot at CHAIN_VALIDATORS
# (each 128 wide), the epoch whose committees the duty lookahead must warm
# on the card (past the halfway trigger of the epoch before) so that its
# first slot's aggregates collapse on their first sighting, the slots
# whose four sync contributions are asked for over HTTP (128-point G2
# sums in the pool) and the slots a block is produced for over HTTP (a
# 512-point sync aggregate).
CHAIN_COMMITTEES_A_SLOT = 4
CHAIN_LOOKAHEAD_EPOCH = 1
CHAIN_CONTRIB_SLOTS = (8, 16, 24, 32)
CHAIN_PRODUCE_SLOTS = (17, 33)
# The slasher (both nodes are built with ClientConfig(slasher=True), their
# beacon processors with one worker, so that each node's pool and slasher
# see the aggregates in their order of arrival). At EQUIVOCATION_SLOT, in
# epoch 0 after the block produced at slot 17 and not among the epoch's
# first two slots (the conflicting vote's block, the parent, descends from
# the target), a second aggregator of the slot's first committee
# aggregates the votes of its first EQUIVOCATORS members for the parent
# block with the slot's source and target (a double vote each), and the
# slot's proposer signs a second block with EQUIVOCATION_GRAFFITI (a
# double proposal). The block produced at the next of CHAIN_PRODUCE_SLOTS
# must carry the evidence the slot timer drained into the pool; signed,
# it is imported as a sibling of the harness's block of that slot.
EQUIVOCATION_SLOT = 28
EQUIVOCATORS = 4
EQUIVOCATION_GRAFFITI = b"equivocation".ljust(32, b"\0")
# Phase 12e, the devnet: 64 interop validators at the minimal preset
# (phase0: two committees of four a slot). The card bn's compile rung holds
# every flush the validator client's submissions and the blocks make (an
# aggregate's three sets; a block's proposal, RANDAO and the pool's
# attestations, more than 16 sets at times; K <= 4). The rest of
# DEVNET_RUNGS are the smaller geometries the devnet's flushes land on,
# warmed after it (before genesis, most times), so the bn has no capture
# left to finish when it stops. Genesis comes DEVNET_GENESIS_S after the
# launch, so both bns are up and the first rung is warm before the first
# slot (beside phase 11, which runs meanwhile); the
# devnet runs DEVNET_SLOTS slots of the system clock, and each process has
# BN_EXIT_S to exit after SIGTERM.
DEVNET_VALIDATORS = 64
DEVNET_RUNGS = ((64, 4, 64), (16, 4, 16), (8, 4, 8), (4, 4, 4), (1, 1, 1))
DEVNET_RUNG = DEVNET_RUNGS[0]
DEVNET_GENESIS_S = 35.0
DEVNET_VC_LEAD_S = 5.0   # the vc starts at least this long before genesis
DEVNET_EXIT_ROOM_S = 4.0  # of the budget, left for the two bns' exits (both at once)
DEVNET_SLOTS = 4
DEVNET_BUDGET_S = 90.0
BN_EXIT_S = 10.0
# The MSM phase's point counts: the top MSM rung (a mainnet committee) for
# G1 with random u64 scalars, and 128 points for the G2 sum.
MSM_N = 512
G2_N = 128
# Lane counts every kernel is checked at: 1, ragged blocks, and the
# largest K2 launch of the block batch.
CHECK_LANES = (1, 3, 5, 1170, 3474)
# Timing shapes of --quick, which runs no batch: 1 lane, the most frequent
# and the largest lane count of the block batch (seed 0), and for K3 every
# count the gossip and block verifies launch. The full run times at the
# counts its own verifies launched.
QUICK_LANES = {"fp_mul_cols": (1, 192, 147456), "fp2_mul": (1, 18, 960, 3474),
               "fp2_sq": (1, 96, 195, 579, 960)}
# The shapes earlier versions of this script timed (an Fp12 product's 81
# Fp lanes at 65 Miller lanes; 27 Fp2 lanes at 193): the path does not
# launch these counts; they are timed to compare with those times.
EARLIER_LANES = {"fp_mul_cols": 81 * 65, "fp2_mul": 27 * 193, "fp2_sq": 27 * 193}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls queued behind a
    device-side sleep, so that the card runs them back to back whatever the
    host's speed, timed by CUDA events; the median of ``rounds``. A round
    counts only if the host finished queueing before the sleep ended: one
    that did not is run again behind a sleep twice as long (the garbage
    collector is held off while a round queues), and the third such round
    in a row raises."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = 3 * reps * (time.perf_counter() - t0) + 1e-3
    times, late = [], 0
    while len(times) < rounds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
        gc.disable()
        try:
            t0 = time.perf_counter()
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            queued_s = time.perf_counter() - t0
        finally:
            gc.enable()
        b.synchronize()
        if queued_s > sleep_s:
            late += 1
            if late == 3:
                raise RuntimeError(f"timing: queueing took {queued_s:.4f} s, longer "
                                   f"than the {sleep_s:.4f} s device sleep, 3 rounds in a row")
            sleep_s *= 2
            continue
        late = 0
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def launch_floor(dev, card: str) -> float:
    """Print and return the device ms per launch of the smallest torch
    kernel, a one-element in-place add, queued back to back as the kernels
    are timed: the card's own cost of a launch, against which a kernel's
    1-lane time reads."""
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = device_ms(lambda: x.add_(1))
    log(f"launch floor: {ms:.4f} ms per launch (one-element in-place add, "
        f"queued back to back) on {card}")
    return ms


def bound(name: str, lanes: int):
    """(ms, "bytes" or "operations"): the least time the card could take for
    ``lanes`` lanes of kernel ``name``."""
    from lighthouse_tpu_torch.crypto.device import kernels

    byte_s = lanes * LANE_BYTES[name] / MEM_RATE
    op_s = lanes * kernels.macs_per_lane(name) / INT32_MAC_RATE
    return max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations"


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def operands(rng, name: str, lanes: int, dev):
    """Random relaxed limbs for ``lanes`` lanes of kernel ``name``, with the
    all-8191 worst case in lane 0 and zeros in lane 1."""
    from lighthouse_tpu_torch.crypto.device import fp

    shape = (lanes, fp.NL) if name == "fp_mul_cols" else (lanes, 2, fp.NL)
    out = []
    for _ in range(1 if name == "fp2_sq" else 2):
        a = rng.integers(0, fp.LIMB_MAX + 1, size=shape, dtype=np.int32)
        a[0] = fp.LIMB_MAX
        a[1:2] = 0
        out.append(torch.from_numpy(a).to(dev))
    return out


def calls(name: str):
    """(kernel wrapper, plain version) of the main path's mode of ``name``."""
    from lighthouse_tpu_torch.crypto.device import kernels

    return {
        "fp_mul_cols": (kernels.fp_mul, kernels.fp_mul_plain),
        "fp2_mul": (kernels.fp2_mul, kernels.fp2_mul_plain),
        "fp2_sq": (kernels.fp2_sq, kernels.fp2_sq_plain),
    }[name]


def check_kernel(name: str, args) -> tuple[int, bool]:
    """Hold one launch against the plain version: K1's raw columns and
    reduced limbs must be equal; K2 and K3 canonical-equal with limbs in
    [0, 8191]. Returns (max abs canonical error, limbs equal)."""
    from lighthouse_tpu_torch.crypto.device import fp, kernels

    fn, plain = calls(name)
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    if name == "fp_mul_cols":
        if not torch.equal(kernels.fp_mul_cols(*args), kernels.fp_mul_cols_plain(*args)):
            raise AssertionError("fp_mul_cols: raw columns differ from the plain version")
        if not torch.equal(got, want):
            raise AssertionError("fp_mul_cols: reduced limbs differ from the plain version")
        return 0, True
    if got.numel() and (int(got.min()) < 0 or int(got.max()) > fp.LIMB_MAX):
        raise AssertionError(f"{name}: limbs outside [0, {fp.LIMB_MAX}]")
    err = int((fp.canonical(got) - fp.canonical(want)).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: canonical values differ (max {err})")
    return err, bool(torch.equal(got, want))


def check_kernels(rng, dev) -> dict:
    """Every kernel at CHECK_LANES, with broadcast operands and an empty
    batch. Returns {name: max abs error}."""
    from lighthouse_tpu_torch.crypto.device import kernels

    errs = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        exact = []
        for lanes in CHECK_LANES:
            args = operands(rng, name, lanes, dev)
            err, eq = check_kernel(name, args)
            errs[name] = max(errs[name], err)
            exact.append(eq)
            if len(args) == 2:  # one operand broadcast over the lanes
                check_kernel(name, (args[0], args[1][:1]))
        fn, _ = calls(name)
        empty = operands(rng, name, 2, dev)
        if fn(*(a[:0] for a in empty)).shape[0] != 0:
            raise AssertionError(f"{name}: an empty batch gave a non-empty result")
        log(f"kernel {name}: equal to its plain version at {CHECK_LANES} lanes, "
            f"broadcast and empty (limbs equal: {all(exact)})")
    kernels.reset_launches()
    return errs


def time_kernels(rng, dev, shapes: dict, errs: dict) -> dict:
    """Check and time each kernel and its plain version at the given lane
    counts. Returns {name: [timing dict, ...]}."""
    out = {}
    for name in KERNELS:
        fn, plain = calls(name)
        rows = []
        for lanes in shapes[name]:
            args = operands(rng, name, lanes, dev)
            err, _ = check_kernel(name, args)
            errs[name] = max(errs[name], err)
            ms = device_ms(lambda: fn(*args))
            plain_ms = device_ms(lambda: plain(*args), reps=5, rounds=3)
            b_ms, b_by = bound(name, lanes)
            rows.append(dict(lanes=lanes, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by))
            log(f"  {name} at {lanes} lanes: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
                f"bound {b_ms:.3g} ms ({b_by}), at {b_ms / ms:.2%} of the bound")
            del args
        out[name] = rows
    return out


def lane_summary(label: str, hist: dict) -> None:
    for name in KERNELS:
        h = hist[name]
        n, lanes = sum(h.values()), sum(k * v for k, v in h.items())
        top = ", ".join(f"{k}: {v}" for k, v in sorted(h.items(), key=lambda kv: -kv[1])[:6])
        log(f"lanes {label} {name}: {lanes} lanes in {n} launches (mean "
            f"{lanes / max(n, 1):.1f}, max {max(h, default=0)}); most frequent "
            f"(lanes: launches) {top}")


# A path that launches a kernel at no more than this many distinct lane
# counts has each of them checked and timed (K3 in the verifies, K2 in the
# G2 sum); otherwise its most frequent count and its largest.
FEW_COUNTS = 8


def path_shapes(hists: dict) -> dict:
    """The lane counts each kernel is checked and timed at: 1 lane, the
    earlier versions' shape, and for every path of this run that launched
    the kernel (``hists``: {path: {kernel: {lanes: launches}}}) its most
    frequent lane count and its largest, or all of its counts when there
    are few."""
    out = {}
    for name in KERNELS:
        shapes = {1, EARLIER_LANES[name]}
        for hist in hists.values():
            h = hist.get(name)
            if not h:
                continue
            shapes |= set(h) if len(h) <= FEW_COUNTS else {mode_of(hist, name), max(h)}
        out[name] = sorted(shapes)
    return out


def mode_of(hist: dict, name: str) -> int:
    """The most frequent lane count of ``name`` (the larger one on a tie)."""
    return max(hist[name].items(), key=lambda kv: (kv[1], kv[0]))[0]


def print_shapes(shapes: dict, hists: dict) -> None:
    """Which paths launched each checked lane count."""
    for name in KERNELS:
        by = {n: [p for p, h in hists.items() if n in h.get(name, {})] for n in shapes[name]}
        log(f"  {name} lane counts: " + "; ".join(
            f"{n} ({', '.join(ps) or ('checked always' if n == 1 else 'earlier shape')})"
            for n, ps in by.items()))


# ---------------------------------------------------------------------------
# Batches (host signer)
# ---------------------------------------------------------------------------

def registry_points(n: int, s0: int = 1):
    """[s0]G, ..., [s0+n-1]G (the keys of secrets s0..s0+n-1) as cpu
    G1Points, built in Jacobian coordinates, P_{i+1} = P_i + G, with one
    Montgomery batch inversion for the affine conversion: an affine
    addition per key would pay one field inversion each."""
    from lighthouse_tpu_torch.crypto.cpu.curve import G1Point
    from lighthouse_tpu_torch.crypto.cpu.fields import Fq
    from lighthouse_tpu_torch.crypto.native import native_sk_to_pk_xy
    from lighthouse_tpu_torch.crypto.params import G1_X, G1_Y, P

    gx, gy = G1_X, G1_Y
    # the first two keys from the C library, then mixed additions of G
    # (P_i != +-G for i >= 2, so the addition never meets a doubling)
    x0, y0 = native_sk_to_pk_xy(s0)
    xs, ys, zs = [x0], [y0], [1]
    (X, Y), Z = native_sk_to_pk_xy(s0 + 1), 1
    for _ in range(n - 1):
        xs.append(X)
        ys.append(Y)
        zs.append(Z)
        zz = Z * Z % P
        h = (gx * zz - X) % P
        r = (gy * zz * Z - Y) % P
        hh = h * h % P
        hhh = h * hh % P
        v = X * hh % P
        X = (r * r - hhh - 2 * v) % P
        Y = (r * (v - X) - Y * hhh) % P
        Z = Z * h % P
    prefix, acc = [], 1
    for z in zs:
        prefix.append(acc)
        acc = acc * z % P
    inv = pow(acc, P - 2, P)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        zi = inv * prefix[i] % P
        inv = inv * zs[i] % P
        zi2 = zi * zi % P
        out[i] = G1Point(Fq(xs[i] * zi2), Fq(ys[i] * zi2 * zi))
    return out


def keys_for(s0: int, n: int, registry=None):
    """The pubkeys of secrets s0 .. s0+n-1: the registry's own point
    objects (secret i is registry row i-1) when one is given."""
    if registry is None:
        return registry_points(n, s0)
    return registry[s0 - 1: s0 - 1 + n]


def gossip_sets(rng, s0: int, registry=None):
    """64 unaggregated attestations, 8 committees of 8 in one slot."""
    from lighthouse_tpu_torch.crypto.bls import Signature
    from lighthouse_tpu_torch.crypto.cpu.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.params import DST, R

    pks = keys_for(s0, 64, registry)
    msgs = [rng.bytes(32) for _ in range(8)]
    hs = [hash_to_g2(m, DST) for m in msgs]
    sets = []
    for c in range(8):
        sig = hs[c].mul((s0 + 8 * c) % R)
        for j in range(8):
            i = 8 * c + j
            sets.append((Signature.deserialize(sig.compress()), [pks[i]], msgs[c]))
            sig = sig + hs[c]
    return sets, msgs, hs


def committee_set(rng, s0: int, pks):
    """One set signed by the secrets s0 .. s0+k-1 of ``pks`` over a random
    message: the signature of their aggregate secret, by the C library's
    signer (the pure-Python signer's bytes, 30 times faster)."""
    from lighthouse_tpu_torch.crypto.bls import Signature
    from lighthouse_tpu_torch.crypto.native import native_sign
    from lighthouse_tpu_torch.crypto.params import R

    k = len(pks)
    m = rng.bytes(32)
    return Signature.deserialize(native_sign((k * s0 + k * (k - 1) // 2) % R, m)), list(pks), m


def block_sets(rng, s0: int, registry=None):
    """128 aggregates (K in [180, 229]) + proposal + RANDAO (K = 1)."""
    ks = [int(k) for k in rng.integers(180, 230, size=128)] + [1, 1]
    pks = keys_for(s0, sum(ks), registry)
    sets, start = [], 0
    for k in ks:
        sets.append(committee_set(rng, s0 + start, pks[start:start + k]))
        start += k
    return sets


def non_subgroup_signature(rng):
    """A point on E2 outside G2, compressed."""
    from lighthouse_tpu_torch.crypto.bls import Signature
    from lighthouse_tpu_torch.crypto.cpu.curve import G2Point
    from lighthouse_tpu_torch.crypto.cpu.fields import Fq2
    from lighthouse_tpu_torch.crypto.params import B2, P

    while True:
        x = Fq2.from_ints(int.from_bytes(rng.bytes(48), "big") % P,
                          int.from_bytes(rng.bytes(48), "big") % P)
        y = (x.square() * x + Fq2.from_ints(*B2)).sqrt()
        if y is not None:
            pt = G2Point(x, y)
            assert not pt.in_subgroup()
            return Signature.deserialize(pt.compress())


def batch_line(backend) -> str:
    """The backend's description of its latest batch, for the log."""
    lb = backend.last_batch
    stages = ", ".join(f"{k} {v:.4f}" for k, v in lb["stages"].items())
    return (f"path {lb['path']}, B={lb['b']} K={lb['k']} M={lb['m']}, "
            f"{'graphs replayed' if lb['warm'] else 'a stage captured'} (stage s: "
            f"{stages}), {lb['collapsed']} of {lb['n_sets']} sets collapsed, host "
            f"resolve {lb['resolve_s']:.4f} s, host pack {lb['pack_s']:.4f} s, H2D "
            f"{lb['h2d_bytes']} B of which pubkey planes {lb['pubkey_bytes']} B")


def timed_verify(backend, sets, label, expect, reps: int = 3, path=None,
                 warm=None, record=None):
    """``reps`` verifies of one batch, each with the launch counts set to 0
    just before it and read just after it; prints every wall time and the
    median, the batch's path, rung and per-stage walls, and its host and
    copy costs. A rung's first verify runs each stage's eager warm-up and
    captures its graph; later ones replay it: their counts must be equal.
    ``path``, when given, is the path every verify must take; ``warm``,
    when True, requires every verify to replay graphs only. ``record``,
    when given, receives the per-stage seconds of each verify. Returns
    (median wall, launch counts and lane histograms {kernel: {lanes:
    launches}} of the last run)."""
    from lighthouse_tpu_torch.crypto.device import kernels

    walls, counts, hist, kinds, stage_s = [], None, None, [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        verdict = backend.verify_signature_sets(sets)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        lb = backend.last_batch
        if verdict is not expect:
            raise AssertionError(f"{label}: verdict {verdict}, expected {expect}")
        if path is not None and lb["path"] != path:
            raise AssertionError(f"{label}: path {lb['path']}, expected {path}")
        if warm and not lb["warm"]:
            raise AssertionError(f"{label}: a stage was captured, not replayed")
        if counts is not None and counts != kernels.launches:
            raise AssertionError(f"{label}: launch counts differ between runs "
                                 f"({counts} then {kernels.launches})")
        counts = dict(kernels.launches)
        hist = {k: dict(h) for k, h in kernels.lane_hist.items()}
        kinds.append("replay" if lb["warm"] else "capture")
        stage_s.append(lb["stages"])
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    wall = statistics.median(walls)
    med = {k: statistics.median(s[k] for s in stage_s) for k in stage_s[-1]}
    if record is not None:
        record.update(walls=walls, stages=med, kinds=kinds)
    log(f"{label}: verdict {expect} x{reps} ({', '.join(kinds)}); {wall:.3f} s per "
        f"verify (median of {', '.join(f'{w:.3f}' for w in walls)}); per-stage median "
        f"s {json.dumps({k: round(v, 4) for k, v in med.items()})}; launches "
        f"{json.dumps(counts)}; lanes {json.dumps(dict(kernels.lanes))}")
    log(f"  {label}: {batch_line(backend)}")
    return wall, counts, hist


def check_stage1_against_host(sets, msgs, hs, dev):
    """Decompressed signatures and device hash-to-G2 vs the host oracle."""
    from lighthouse_tpu_torch.crypto.device import bls as dbls, fp

    args = dbls.pack_signature_sets_raw(sets, device=dev)
    sig_xy, mx, my, minf, sig_ok = dbls._stage1(args[2], args[3], args[4])
    if not bool(sig_ok[: len(sets)].all()):
        raise AssertionError("stage 1: a valid signature failed decompression")
    sig_c = fp.canonical(sig_xy).cpu().numpy()
    for i in range(4):
        pt = sets[i][0].point
        want = [pt.x.c0.n, pt.x.c1.n, pt.y.c0.n, pt.y.c1.n]
        got = [fp.limbs_to_int(sig_c[i, a, b]) for a in range(2) for b in range(2)]
        if got != want:
            raise AssertionError(f"stage 1: signature {i} decompressed wrong")
    mxc, myc = mx.cpu().numpy(), my.cpu().numpy()
    for j, h in enumerate(hs):
        got = [fp.limbs_to_int(mxc[j, 0]), fp.limbs_to_int(mxc[j, 1]),
               fp.limbs_to_int(myc[j, 0]), fp.limbs_to_int(myc[j, 1])]
        if got != [h.x.c0.n, h.x.c1.n, h.y.c0.n, h.y.c1.n] or bool(minf[j]):
            raise AssertionError(f"stage 1: hash_to_g2 of message {j} differs from the host")
    log(f"stage 1 vs host oracle: 4 decompressed signatures and {len(hs)} "
        "message points equal")


def profile_verify(backend, sets, label, wall):
    """Two more verifies, their stages replaying their graphs: one with
    CUDA events around each replay (the graphs' device time, gaps between
    their nodes included), then one under torch.profiler (the device time
    by kernel name, which the profiler reads inside the graphs). Prints
    the device's busy share of ``wall`` (the unprofiled median). Returns
    {kernel: device ms} for the port's kernels (None where the profiler
    saw none)."""
    from torch.profiler import ProfilerActivity, profile

    from lighthouse_tpu_torch.crypto.device import graphs

    torch.cuda.synchronize()
    graphs.set_event_timing(True)
    backend.verify_signature_sets(sets)
    replay_s = graphs.replay_device_ms() / 1e3
    graphs.set_event_timing(False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        backend.verify_signature_sets(sets)
        torch.cuda.synchronize()
    if not backend.last_batch["warm"]:
        raise AssertionError(f"profile {label}: a stage was captured, not replayed")
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host-side op rows repeat their kernels' device time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"profile {label}: device busy {busy_s:.4f} s in {sum(r[1] for r in rows)} "
        f"device ops (profiler); graph replays {replay_s:.4f} s of device time (CUDA "
        f"events, gaps inside the graphs included); idle share "
        f"{1 - busy_s / wall:.3f} (profiler) / {1 - replay_s / wall:.3f} (events) of "
        f"the {wall:.4f} s median wall")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3:9.3f} ms {count:7d}x  {key[:80]}")
    per = {name: sum(r[0] for r in rows if PROFILE_NAME[name] in r[2]) / 1e3
           for name in KERNELS}
    return {name: ms or None for name, ms in per.items()}


# ---------------------------------------------------------------------------
# The key table, the gathered and collapsed paths, the MSM
# ---------------------------------------------------------------------------

class held_collapse:
    """Raise the table's ``agg_min_repeats`` above any sighting count for a
    block of verifies, so every set ships its K indices (the gathered path
    without the aggregate collapse)."""

    def __init__(self, table):
        self.table = table

    def __enter__(self):
        self.prev = self.table.agg_min_repeats
        self.table.agg_min_repeats = 1 << 30

    def __exit__(self, *exc):
        self.table.agg_min_repeats = self.prev


def key_table_phase(registry, dev):
    """Sync the first half of the registry at startup, then delta-admit the
    rest, which grows the table to the next rung by a device copy. Prints
    each sync's seconds, upload bytes and status; holds rows at both ends
    of each half against the host pack. Returns the table."""
    from types import SimpleNamespace

    from lighthouse_tpu_torch.crypto.bls import PublicKey
    from lighthouse_tpu_torch.crypto.device import curve, key_table

    n, half = len(registry), len(registry) // 2
    cache = SimpleNamespace(pubkeys=[PublicKey(p) for p in registry[:half]])
    table = key_table.DeviceKeyTable(cache, device=dev)
    for reason in ("startup", "delta"):
        if reason == "delta":
            cache.pubkeys.extend(PublicKey(p) for p in registry[half:])
        t0 = time.perf_counter()
        added = table.sync(reason=reason)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = table.status()
        log(f"key table {reason} sync: {added} rows in {dt:.3f} s, upload "
            f"{st['upload_bytes'][reason]} B, capacity {st['validator_capacity']} rows "
            f"({st['validator_capacity'] * key_table.G1_ROW_BYTES} B of validator rows "
            f"on the card, {st['device_bytes']} B with the aggregate region)")
        log(f"  status {json.dumps(st)}")
    if table.status()["validator_capacity"] != key_table.table_capacity(n):
        raise AssertionError("key table: capacity is not the registry's rung")
    rows = [0, half - 1, half, n - 1]
    tdev, _ = table.device_arrays()
    want = curve.pack_g1([registry[i] for i in rows])[0]
    if tdev.device != dev or not np.array_equal(tdev[rows].cpu().numpy(), want):
        raise AssertionError("key table: device rows differ from the host pack")
    log(f"key table rows {rows} equal to the host pack, on {tdev.device}")
    return table


def gathered_phase(rng, registry, table, backend, dev):
    """Gossip and block batches drawn from the registry's own points on the
    gathered path (collapse held off), a poisoned one, one with a foreign
    key (raw fallback), and the gathered planes against the raw planes on
    the card. Returns (block sets, median wall of the block verify, lane
    histograms of the valid verifies by path)."""
    from lighthouse_tpu_torch.crypto.cpu.curve import G1Point
    from lighthouse_tpu_torch.crypto.cpu.fields import Fq
    from lighthouse_tpu_torch.crypto.device import bls as dbls

    t0 = time.perf_counter()
    gsets, _msgs, _hs = gossip_sets(rng, 1000, registry)
    bsets = block_sets(rng, 100_000, registry)
    log(f"host signing from the registry: {time.perf_counter() - t0:.2f} s")
    walls, hists = {}, {}
    with held_collapse(table):
        for label, sets in (("gossip", gsets), ("block", bsets)):
            wall, _counts, hist = timed_verify(
                backend, sets, f"gathered {label} valid", True, path="raw_gather")
            walls[label] = wall
            hists[f"gathered {label}"] = hist
            resolved, tdev, tagg, _ = table.resolve_sets(sets)
            idx = dbls.pack_signature_sets_indexed(sets, resolved, device=dev)[0]
            gather_ms = device_ms(lambda: dbls._gather_fn(tdev, tagg, idx))
            log(f"  gathered {label}: gather {gather_ms:.4f} device ms at "
                f"{tuple(idx.shape)} indices")
            lane_summary(f"gathered {label} valid", hist)
        poisoned = list(bsets)
        poisoned[5] = (non_subgroup_signature(rng), bsets[5][1], bsets[5][2])
        timed_verify(backend, poisoned, "gathered block non-subgroup signature", False,
                     path="raw_gather")
        foreign = list(bsets)
        sig, pks, m = foreign[1]
        p = pks[0]
        foreign[1] = (sig, [G1Point(Fq(p.x.n), Fq(p.y.n))] + pks[1:], m)
        raw0 = table.status()["sets"]["raw"]
        timed_verify(backend, foreign, "block with one foreign key", True,
                     path="raw_staged")
        raw = table.status()["sets"]["raw"] - raw0
        if raw <= 0:
            raise AssertionError("foreign key: the raw fallback was not counted")
        log(f"  foreign key: count_raw +{raw} sets (table sets {table.status()['sets']})")

        # the gathered pubkey planes against the raw planes, on the card
        resolved, tdev, tagg, _ = table.resolve_sets(bsets)
        words = seeded_words(7)
        idx_args = dbls.pack_signature_sets_indexed(bsets, resolved, rand_words=words(),
                                                    device=dev)
        raw_args = dbls.pack_signature_sets_raw(bsets, rand_words=words(), device=dev)
        gathered = dbls._gather_fn(tdev, tagg, idx_args[0])
        mask = idx_args[1]
        if not (torch.equal(mask, raw_args[1])
                and torch.equal(gathered[mask], raw_args[0][mask])
                and all(torch.equal(a, b) for a, b in zip(idx_args[2:], raw_args[2:]))):
            raise AssertionError("gathered planes differ from the raw planes")
        log(f"gathered pubkey planes equal to the raw planes on {int(mask.sum())} live "
            f"slots, on {gathered.device}; the other six planes equal")
    return bsets, walls["block"], hists


def seeded_words(seed: int):
    """A factory of seeded stand-ins for the packers' random words: each
    call gives a fresh generator from the same seed."""
    def make():
        rng = np.random.default_rng(seed)

        def words():
            r = int(rng.integers(1, 2 ** 63, dtype=np.int64))
            return (r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF
        return words
    return make


def collapse_phase(rng, registry, table, backend):
    """A fresh block batch verified three times with the default
    ``agg_min_repeats`` (2): the second sighting pays the host sums and
    ships K = 1, the third hits the cached rows. Then a poisoned signature
    over the collapsed rows. Returns (sets, median wall of three verifies
    after the third sighting, their lane histograms)."""
    from lighthouse_tpu_torch.crypto.device import kernels

    t0 = time.perf_counter()
    csets = block_sets(rng, 200_000, registry)
    log(f"host signing: {time.perf_counter() - t0:.2f} s; {len(csets)} sets from "
        f"registry rows 199,999 on")
    n_comm = sum(1 for _, pks, _ in csets if len(pks) > 1)
    n_adds = sum(len(pks) - 1 for _, pks, _ in csets if len(pks) > 1)
    for sighting in (1, 2, 3):
        sum0 = table.status()["aggregate_sum_seconds"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        verdict = backend.verify_signature_sets(csets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lb = backend.last_batch
        k1_max = max(kernels.lane_hist["fp_mul_cols"])
        log(f"collapse sighting {sighting}: verdict {verdict}; K rung {lb['k']}; "
            f"{lb['collapsed']} of {lb['n_sets']} sets collapsed; K1 lane maximum "
            f"{k1_max}; {wall:.3f} s; launches {json.dumps(dict(kernels.launches))}")
        log(f"  collapse sighting {sighting}: {batch_line(backend)}")
        if verdict is not True or lb["path"] != "raw_gather":
            raise AssertionError(f"collapse sighting {sighting}: {verdict} on {lb['path']}")
        if sighting > 1:
            if lb["k"] != 1 or lb["collapsed"] != n_comm:
                raise AssertionError(f"collapse sighting {sighting}: not collapsed")
        if sighting == 2:
            log(f"collapse host sums (second sighting): "
                f"{table.status()['aggregate_sum_seconds'] - sum0:.3f} s for {n_adds} "
                f"affine additions over {n_comm} committees")
    # the steady state: every committee hits its cached row
    wall, _counts, hist = timed_verify(backend, csets, "collapsed block valid", True,
                                       path="raw_gather")
    lane_summary("collapsed block valid", hist)
    poisoned = list(csets)
    poisoned[5] = (non_subgroup_signature(rng), csets[5][1], csets[5][2])
    timed_verify(backend, poisoned, "collapsed block non-subgroup signature", False,
                 path="raw_gather", reps=1)
    if backend.last_batch["collapsed"] != n_comm:
        raise AssertionError("poisoned collapsed batch: rows were not collapsed")
    st = table.status()
    log(f"  table after collapse: {st['aggregates_resident']} aggregate rows, "
        f"{st['aggregate_inserts']} inserts, {st['aggregate_hits']} hits, "
        f"upload {st['upload_bytes']['aggregate']} B")
    return csets, wall, hist


def msm_phase(rng, registry, table, backend, dev, csets):
    """The G1 MSM at N = 512 against the host reference (the C library's
    [sum s_i k_i]G) and the G2 sum at N = 128 against the host fold; one
    committee's all-ones MSM against the table's host sum; and a
    committee inserted ahead of time whose first sighting ships K = 1.
    Returns the lane histograms of the three device sums by path, and the
    inputs and host references of the G1 MSM and the G2 sum."""
    from lighthouse_tpu_torch.crypto.cpu.curve import G1Point, G2Point, g2_generator
    from lighthouse_tpu_torch.crypto.cpu.fields import Fq
    from lighthouse_tpu_torch.crypto.device import bls as dbls, curve, kernels, msm
    from lighthouse_tpu_torch.crypto.native import native_sk_to_pk_xy
    from lighthouse_tpu_torch.crypto.params import R as R_ORDER

    hists = {}

    def counted(label, fn, path_kernels):
        """Run one device sum with the counts set to 0 just before it and
        read just after; every kernel of ``path_kernels`` must launch."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"{label}: {dt:.3f} s on the card; launches {json.dumps(dict(kernels.launches))}")
        missing = [k for k in path_kernels if kernels.launches[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        hists[label] = {k: dict(h) for k, h in kernels.lane_hist.items()}
        lane_summary(label, hists[label])
        return out

    pts = registry[:MSM_N]
    sc = [int(s) for s in rng.integers(0, 2 ** 64, size=MSM_N, dtype=np.uint64)]
    sc[0] = (1 << 64) - 1
    got = counted(f"msm g1 N={MSM_N}",
                  lambda: dbls.device_msm_g1(pts, sc, pad_n=MSM_N, device=dev),
                  ["fp_mul_cols"])
    # the host reference: registry row i is [i + 1]G, so the MSM is
    # [sum_i s_i (i + 1) mod r]G, one scalar multiplication of G by the C
    # library (a pure-Python fold of 512 u64 products took 20 s)
    t0 = time.perf_counter()
    if any((p.x, p.y) != tuple(Fq(c) for c in native_sk_to_pk_xy(i + 1))
           for i, p in enumerate(pts)):
        raise AssertionError("msm g1: the registry rows are not [i + 1]G")
    k = sum(s * (i + 1) for i, s in enumerate(sc)) % R_ORDER
    want = G1Point.infinity() if k == 0 else G1Point(*(Fq(c) for c in native_sk_to_pk_xy(k)))
    log(f"msm g1 host reference: {time.perf_counter() - t0:.3f} s")
    if got.compress() != want.compress():
        raise AssertionError("msm g1: differs from the host reference")
    refs = {"g1": (pts, sc, want), "g2": (None, None, None)}
    log(f"msm g1 N={MSM_N} (random u64 scalars, one all-ones): equal to the host reference")

    g2 = g2_generator()
    q = g2.mul(int(rng.integers(1, 2 ** 62)))
    pts2 = []
    for _ in range(G2_N):
        pts2.append(q)
        q = q + g2
    got2 = counted(f"sum g2 N={G2_N}",
                   lambda: dbls.device_sum_g2(pts2, pad_n=G2_N, device=dev),
                   ["fp_mul_cols", "fp2_mul"])
    want2 = G2Point.infinity()
    for p in pts2:
        want2 = want2 + p
    if got2.compress() != want2.compress():
        raise AssertionError("sum g2: differs from the host fold")
    refs["g2"] = (pts2, None, want2)
    log(f"sum g2 N={G2_N}: equal to the host fold")

    # one committee of the collapsed batch: the duty lookahead's all-ones MSM
    # against the row the table summed on the host
    _sig, pks, _m = csets[0]
    rung = msm.msm_rung(len(pks))
    dsum = counted(f"msm g1 committee K={len(pks)} at rung {rung}",
                   lambda: dbls.device_msm_g1(pks, [1] * len(pks), pad_n=rung, device=dev),
                   ["fp_mul_cols"])
    resolved, tdev, tagg, collapsed = table.resolve_sets([csets[0]])
    if collapsed != 1:
        raise AssertionError("committee: not cached in the table")
    row = tagg[resolved[0][0] - tdev.shape[0]].cpu().numpy()
    if not np.array_equal(row, curve.pack_g1([dsum])[0][0]):
        raise AssertionError("committee: device MSM differs from the table's host sum")
    log(f"msm g1 committee K={len(pks)}: equal to the table's host-summed row")

    # a committee never seen: inserted ahead of time, first sighting K = 1
    s0 = len(registry) - 250
    fset = committee_set(rng, s0, registry[s0 - 1: s0 + 199])
    point = dbls.device_msm_g1(fset[1], [1] * 200, pad_n=msm.msm_rung(200), device=dev)
    log(f"precomputed committee: K=200 summed by the device MSM at rung {msm.msm_rung(200)}")
    outcome = table.insert_precomputed([table.index_of_point(p) for p in fset[1]], point)
    if outcome != "inserted":
        raise AssertionError(f"insert_precomputed: {outcome}")
    timed_verify(backend, [fset], "precomputed committee, first sighting", True,
                 path="raw_gather", reps=1)
    if backend.last_batch["k"] != 1 or backend.last_batch["collapsed"] != 1:
        raise AssertionError("precomputed committee: first sighting did not ship K=1")
    return hists, refs


# ---------------------------------------------------------------------------
# The warm staged dispatch: each stage a CUDA graph per rung, captured by the
# compile service ahead of traffic
# ---------------------------------------------------------------------------

def check_captured_k1(rng, dev) -> None:
    """One K1 launch from the ctypes library captured into a graph on the
    torch stream: the capture's own replay equals the eager warm-up (the
    wrapper checks), and a replay on new inputs equals an eager launch."""
    from lighthouse_tpu_torch.crypto.device import graphs, kernels

    x, y, x2, y2 = (operands(rng, "fp_mul_cols", 192, dev)[0] for _ in range(4))
    prog = graphs.CapturedProgram(kernels.fp_mul, "check_k1")
    if not torch.equal(prog(x, y), kernels.fp_mul_plain(x, y)):
        raise AssertionError("captured K1: the capture differs from the plain version")
    if not torch.equal(prog(x2, y2), kernels.fp_mul(x2, y2)):
        raise AssertionError("captured K1: a replay differs from an eager launch")
    g = prog.graph_for(x, y)
    log(f"captured K1 at 192 lanes: capture and replay equal to eager; {g.nodes} "
        f"graph nodes, capture {g.capture_s:.4f} s, pool {g.pool_bytes} B")
    prog.reset()
    kernels.reset_launches()


def start_service(plan, dev):
    """Start a compile service over ``plan`` with the MSM ladder on, attach
    it, and wait until it has warmed every rung. Returns (service, wall)."""
    from lighthouse_tpu_torch.compile_service import service as csvc

    svc = csvc.CompileService(rungs=plan, device=dev)
    csvc.set_msm_warm_enabled(True)
    csvc.set_service(svc)
    t0 = time.perf_counter()
    svc.start()
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"compile service not idle after {WARM_TIMEOUT_S} s: "
                             f"{json.dumps(svc.status(), default=str)[:2000]}")
    wall = time.perf_counter() - t0
    st = svc.status()
    cold = [r for r in plan if [*r, svc._impl()] not in st["warm_rungs"]]
    if st["failed_total"] or cold:
        raise AssertionError(f"compile service: rungs {cold} cold, "
                             f"{st['failed_total']} failures: {st['last_error']}")
    return svc, wall


def capture_table(plan, msm_rungs, dev) -> dict:
    """Print each rung's stage graphs (and the MSM ladder's): capture
    seconds, eager warm-up seconds, node count, pool bytes; a graph two
    rungs share is printed once. Returns the rows by 'BxKxM stage'."""
    from lighthouse_tpu_torch.compile_service import lowering
    from lighthouse_tpu_torch.crypto.device import bls as dbls, fp

    progs = lowering.staged_captured()
    out, seen = {}, {}

    def row(label, g):
        if g is None:
            raise AssertionError(f"{label}: no graph captured")
        if id(g) in seen:  # stage 1 keys on (B, M), stage 2 on (B, K), stage 3 on B
            out[label] = {"same_as": seen[id(g)]}
            log(f"  {label}: the graph of {seen[id(g)]}")
            return
        seen[id(g)] = label
        out[label] = dict(capture_s=g.capture_s, instantiate_s=g.instantiate_s,
                          instantiate_max_s=g.instantiate_max_s, segments=len(g.segments),
                          warmup_s=g.warmup_s, nodes=g.nodes,
                          pool_bytes=g.pool_bytes, launches=g.record()["launches"])
        log(f"  {label}: capture {g.capture_s:.3f} s (instantiate {g.instantiate_s:.3f}, "
            f"{len(g.segments)} segments, longest {g.instantiate_max_s:.3f}), "
            f"eager warm-up {g.warmup_s:.3f} s, "
            f"{g.nodes} nodes, pool {g.pool_bytes} B, launches {json.dumps(out[label]['launches'])}")

    for rung in plan:
        args = lowering.staged_dummy_args(*rung, device=dev)
        for stage in lowering.STAGES:
            row(f"{'x'.join(map(str, rung))} {stage}", progs[stage].graph_for(*args[stage]))
    for n in msm_rungs:
        z = lambda *shape, dt=torch.int32: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        row(f"msm N={n}", dbls._msm.graph_for(z(n, 2, fp.NL), z(n, dt=torch.bool), z(n, 2)))
        row(f"g2sum N={n}", dbls._g2sum.graph_for(z(n, 2, 2, fp.NL), z(n, dt=torch.bool)))
    return out


def graph_summary(label: str) -> dict:
    """Print and return the totals of every captured graph."""
    from lighthouse_tpu_torch.crypto.device import graphs

    st = graphs.status()
    log(f"{label}: {st['graphs']} graphs, {st['nodes']} nodes, {st['pool_bytes']} B of "
        f"graph pools on the card (reserved {torch.cuda.memory_reserved()} B in all); "
        f"lock waits {json.dumps(st['lock_wait_s'])}")
    return {k: st[k] for k in ("graphs", "nodes", "pool_bytes", "lock_wait_s")}


def stale_input_check(rng, backend, sets) -> None:
    """On one rung (``sets``: a gossip batch, its first two sets of one
    committee): valid, poisoned (the first two signatures swapped: same
    message, wrong signers), valid, a second valid batch with other
    signers, then that batch with a non-subgroup signature. Each verdict
    must be right and each verify must replay the rung's graphs (stale
    inputs would repeat a verdict)."""
    swapped = list(sets)
    swapped[0] = (sets[1][0], sets[0][1], sets[0][2])
    swapped[1] = (sets[0][0], sets[1][1], sets[1][2])
    other, _m, _h = gossip_sets(rng, 5000)
    other = other[: len(sets)]
    other_bad = list(other)
    other_bad[-1] = (non_subgroup_signature(rng), other[-1][1], other[-1][2])
    rung = None
    seq = (("valid", sets, True), ("poisoned", swapped, False), ("valid", sets, True),
           ("other signers valid", other, True),
           ("other signers poisoned", other_bad, False))
    for label, batch, want in seq:
        got = backend.verify_signature_sets(batch)
        lb = backend.last_batch
        rung = rung or lb["rung"]
        if got is not want or not lb["warm"] or lb["rung"] != rung:
            raise AssertionError(f"stale-input check, {label}: verdict {got} (want {want}), "
                                 f"warm {lb['warm']}, rung {lb['rung']} (want {rung})")
    log(f"stale-input check on rung {rung}: " + ", ".join(
        f"{label} {want}" for label, _b, want in seq) + " (all replays)")


def served_verify(backend, sets, label, expect, path, eager_hist) -> dict:
    """Three verifies with the service attached, all replays; their
    credited launches and lanes must equal the eager run's."""
    rec = {}
    wall, counts, hist = timed_verify(backend, sets, label, expect, path=path,
                                      warm=True, record=rec)
    if hist != eager_hist:
        raise AssertionError(f"{label}: credited lane counts differ from the eager run")
    log(f"  {label}: credited launches and lanes equal the eager run's")
    return dict(wall=wall, walls=rec["walls"], stages=rec["stages"], launches=counts,
                rung=backend.last_batch["rung"])


def served_sum(label, fn, want, eager_hist) -> None:
    """One device sum with the service attached: equal to the host fold,
    its credited counts equal the eager run's."""
    from lighthouse_tpu_torch.crypto.device import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = fn()
    dt = time.perf_counter() - t0
    hist = {k: dict(h) for k, h in kernels.lane_hist.items()}
    if got.compress() != want.compress():
        raise AssertionError(f"{label}: differs from the host fold")
    if hist != eager_hist:
        raise AssertionError(f"{label}: credited lane counts differ from the eager run")
    log(f"{label} through its graph: equal to the host fold, {dt:.4f} s; credited "
        f"launches {json.dumps(dict(kernels.launches))} equal the eager run's")


def _add_hist(into: dict, hist: dict) -> None:
    """Add a lane histogram {kernel: {lanes: launches}} into ``into``."""
    for k, h in hist.items():
        for n, c in h.items():
            into.setdefault(k, {})
            into[k][n] = into[k].get(n, 0) + c


def concurrent_warm_phase(svc, backend, cold_rungs, traffic, dev) -> dict:
    """Queue ``cold_rungs`` on the attached service's worker and, while it
    warms and captures them, verify the warm ``traffic`` batches from this
    thread in turns, ``(label, sets, want, path, eager lane histogram)``
    each. Prints every wall, the lock waits and how far the verifies
    overlapped the captures. Fails on a wrong verdict, a verify that
    captured or took another path, a wall of WARM_WALL_LIMIT_S or more, no
    verify overlapping a capture, or counters other than the verifies'
    eager counts plus the worker's warm-ups (each equal to its graph's
    credit)."""
    from lighthouse_tpu_torch.compile_service import lowering
    from lighthouse_tpu_torch.crypto.device import graphs, kernels

    progs = lowering.staged_captured()

    def stage_graphs():
        return [progs[st].graph_for(*lowering.staged_dummy_args(*r, device=dev)[st])
                for r in cold_rungs for st in lowering.STAGES]

    if any(g is not None for g in stage_graphs()):
        raise AssertionError(f"concurrent warm: a stage of {cold_rungs} is captured already")
    from lighthouse_tpu_torch.utils import pipeline_profiler

    before = {id(g) for p in list(graphs._PROGRAMS) for g in p._graphs.values()}
    waits0 = graphs.status()["lock_wait_s"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    pipeline_profiler.reset()  # the warm traffic's gaps beside the captures
    t_start = time.perf_counter()
    for r in cold_rungs:
        svc.request(*r)
    verifies, want_hist = [], {}
    while True:
        st = svc.status()
        if st["in_flight"] is None and not st["queue"]:
            break
        for label, sets, want, path, hist in traffic:
            t0 = time.perf_counter()
            got = backend.verify_signature_sets(sets)
            t1 = time.perf_counter()
            lb = backend.last_batch
            if got is not want or not lb["warm"] or lb["path"] != path:
                raise AssertionError(f"concurrent warm, {label}: verdict {got} (want {want}), "
                                     f"warm {lb['warm']}, path {lb['path']}")
            stages = {"resolve": lb["resolve_s"], "pack": lb["pack_s"], **lb["stages"]}
            stages["rest"] = t1 - t0 - sum(stages.values())
            verifies.append((label, t0, t1, stages))
            _add_hist(want_hist, hist)
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("concurrent warm: the service did not finish its rungs")
    span = time.perf_counter() - t_start
    st = svc.status()
    if st["failed_total"] or any([*r, svc._impl()] not in st["warm_rungs"] for r in cold_rungs):
        raise AssertionError(f"concurrent warm: rungs not warmed: {st['last_error']}")
    # every graph the worker captured in this phase: the rungs' stages and
    # the extras it warms with them (an MSM rung not yet warm)
    cold = [g for p in list(graphs._PROGRAMS) for g in p._graphs.values()
            if id(g) not in before]
    if any(g not in cold for g in stage_graphs()):
        raise AssertionError("concurrent warm: a stage graph of the cold rungs is missing")
    for g in cold:
        _add_hist(want_hist, {k: dict(h) for k, (_n, _l, h) in g.credit.items()})
    got_hist = {k: dict(h) for k, h in kernels.lane_hist.items() if h}
    if got_hist != {k: h for k, h in want_hist.items() if h}:
        raise AssertionError("concurrent warm: the counters differ from the verifies' eager "
                             "counts plus the worker's warm-ups")
    spans = sorted((g.steps["warmup"][0], g.steps["check"][1]) for g in cold)
    overlap = [sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in spans)
               for _l, t0, t1, _s in verifies]
    walls = [t1 - t0 for _l, t0, t1, _s in verifies]
    busy = sum(b - a for a, b in spans)

    def beside(t0, t1):
        """The capture steps (and seconds) a verify ran beside."""
        out = {}
        for g in cold:
            for step, (a, b) in g.steps.items():
                ov = min(t1, b) - max(t0, a)
                if ov > 0:
                    out[step] = round(out.get(step, 0.0) + ov, 4)
        return out

    waits = graphs.status()["lock_wait_s"]
    dwaits = {kind: {d: v - waits0.get(kind, {}).get(d, 0.0) for d, v in per.items()}
              for kind, per in waits.items()}
    for (label, t0, t1, stages), ov in zip(verifies, overlap):
        log(f"  concurrent {label}: {t1 - t0:.4f} s at +{t0 - t_start:.2f} s "
            f"({ov:.4f} s beside a capture: {json.dumps(beside(t0, t1))}); host and stage s "
            f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    for p in sorted(graphs._PROGRAMS, key=lambda p: p.name):
        for key, g in list(p._graphs.items()):
            if g in cold:
                shapes = " ".join("x".join(map(str, shape)) for shape, _dt in key[2])
                steps = ", ".join(f"{k} +{a - t_start:.2f}..+{b - t_start:.2f}"
                                  for k, (a, b) in g.steps.items())
                log(f"  worker captured {p.name} [{shapes}]: warm-up {g.warmup_s:.3f} s, "
                    f"capture {g.capture_s:.3f} s (instantiate {g.instantiate_s:.3f}, "
                    f"{len(g.segments)} segments, longest {g.instantiate_max_s:.3f}), "
                    f"{g.nodes} nodes; steps (s) {steps}")
    n_over = sum(1 for ov in overlap if ov > 0)
    by_label = {}
    for (label, *_r), w in zip(verifies, walls):
        by_label.setdefault(label, []).append(w)
    log(f"concurrent warm: {len(verifies)} warm verifies in {span:.2f} s while the worker "
        f"warmed {cold_rungs} ({busy:.2f} s of warm-ups and captures); {n_over} verifies "
        f"overlapped a capture for {sum(overlap):.2f} s; walls max {max(walls):.4f} s, "
        f"median by batch {json.dumps({k: round(statistics.median(v), 4) for k, v in by_label.items()})}; "
        f"lock waits in this phase {json.dumps(dwaits)}; verdicts right, counters equal "
        f"the eager counts plus the warm-ups")
    if n_over == 0:
        raise AssertionError("concurrent warm: no verify overlapped a capture")
    if max(walls) >= WARM_WALL_LIMIT_S:
        raise AssertionError(f"concurrent warm: a warm verify took {max(walls):.3f} s "
                             f"(limit {WARM_WALL_LIMIT_S} s)")
    # the pipeline profiler: the worker's captures are compile activity,
    # so the warm traffic's gaps beside them attribute to `compile`
    shards = bubble_reading("concurrent warm")
    causes = shards.get("0", {}).get("causes", {})
    beside = {c: v for c, v in causes.items() if c != "pack"}
    if not beside or max(beside, key=beside.get) != "compile":
        raise AssertionError(f"concurrent warm: gaps beside the captures by cause {causes}: "
                             "compile is not the cause")
    log(f"concurrent warm: the warm traffic's gaps beside the captures: compile "
        f"{causes['compile']} s of {shards['0']['idle_s']} s idle (pack {causes.get('pack')} "
        f"s); busy {shards['0']['busy_s']} s counts the traffic only")
    return {"cold_rungs": [list(r) for r in cold_rungs], "span_s": span,
            "capture_busy_s": busy, "verifies": len(verifies), "overlapping": n_over,
            "overlap_s": sum(overlap), "wall_max_s": max(walls),
            "walls": {k: v for k, v in by_label.items()}, "lock_waits_s": dwaits,
            "bubbles": shards}


def engine_phase(backend, sets, dev) -> dict:
    """The gossip batch verified under each of ENGINE_TRIPLES: a first
    valid verify (which captures the rung's stage graphs under the
    triple), a replayed valid verify and a replayed poisoned one (the
    first two signatures swapped: one committee, so the same messages and
    rung, wrong signers); prints the captures' seconds and nodes and each
    wall. Then the default triple's graphs must still replay, with no new
    capture."""
    from lighthouse_tpu_torch.compile_service import lowering
    from lighthouse_tpu_torch.crypto.device import fp, fp2, graphs, kernels, pairing

    bad = list(sets)
    bad[0] = (sets[1][0], sets[0][1], sets[0][2])
    bad[1] = (sets[0][0], sets[1][1], sets[1][2])
    progs = lowering.staged_captured()
    out = {}
    n0 = graphs.status()["graphs"]
    for triple in ENGINE_TRIPLES:
        walls = []
        with fp.impl(triple[0]), fp2.impl(triple[1]), pairing.line_impl(triple[2]):
            for label, batch, want in (("first", sets, True), ("valid", sets, True),
                                       ("poisoned", bad, False)):
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                got = backend.verify_signature_sets(batch)
                walls.append(time.perf_counter() - t0)
                lb = backend.last_batch
                if got is not want or lb["warm"] is not (label != "first"):
                    raise AssertionError(f"engines {triple}, {label}: verdict {got} (want "
                                         f"{want}), warm {lb['warm']}")
            launches = dict(kernels.launches)
            args = lowering.staged_dummy_args(*lb["rung"], device=dev)
            gs = [progs[stg].graph_for(*args[stg]) for stg in lowering.STAGES]
        rec = {"rung": list(lb["rung"]),
               "capture_s": sum(g.capture_s for g in gs),
               "warmup_s": sum(g.warmup_s for g in gs),
               "nodes": sum(g.nodes for g in gs),
               "stage_nodes": [g.nodes for g in gs],
               "first_wall_s": walls[0], "wall_s": walls[1], "poisoned_wall_s": walls[2],
               "launches": launches}
        out["/".join(triple)] = rec
        log(f"  engines {'/'.join(triple)} at rung {lb['rung']}: captures "
            f"{rec['capture_s']:.3f} s (eager warm-ups {rec['warmup_s']:.3f} s), "
            f"{rec['nodes']} nodes {rec['stage_nodes']}; walls: first {walls[0]:.3f} s, "
            f"replay {walls[1]:.4f} s, poisoned {walls[2]:.4f} s (False); launches per "
            f"replay {json.dumps(launches)}")
    n1 = graphs.status()["graphs"]
    got = backend.verify_signature_sets(sets)
    if got is not True or not backend.last_batch["warm"] or graphs.status()["graphs"] != n1:
        raise AssertionError("engines: the default triple's graphs did not replay as before")
    log(f"engines: {len(ENGINE_TRIPLES)} triples right, valid and poisoned; "
        f"{n1 - n0} new graphs; the default triple "
        f"{'/'.join(graphs.engines())} still replays with no new capture")
    return out


# ---------------------------------------------------------------------------
# The verification scheduler serving gossip traffic on the card
# ---------------------------------------------------------------------------

def serve_pools(rng, s0: int):
    """Signed sets for the serve phase, as the scheduler's callers hand
    them over (``bls.SignatureSet``), one pool per caller kind of
    ``traffic.gossip_steady``: 56 unaggregated attestations of 7
    committees of 8 (K = 1), each committee's aggregate of its 8 (K = 8),
    and 16 sync-committee messages over one block root (K = 1). The 7
    attestation messages and the block root keep a flush's distinct
    messages within 8, the M of the warm gossip rungs. Also returns one
    attestation signed over the wrong message (another committee's)."""
    from lighthouse_tpu_torch.crypto.bls import PublicKey, Signature, SignatureSet
    from lighthouse_tpu_torch.crypto.cpu.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.params import DST, R

    keys = [PublicKey(p) for p in registry_points(SERVE_COMMITTEES * 8 + SERVE_SYNC, s0)]
    msgs = [rng.bytes(32) for _ in range(SERVE_COMMITTEES + 1)]
    hs = [hash_to_g2(m, DST) for m in msgs]
    pools = {"unaggregated": [], "aggregate": [], "sync_message": []}
    for c in range(SERVE_COMMITTEES):
        sig = hs[c].mul((s0 + 8 * c) % R)
        total = None
        for j in range(8):
            i = 8 * c + j
            pools["unaggregated"].append(SignatureSet(
                Signature.deserialize(sig.compress()), [keys[i]], msgs[c]))
            total = sig if total is None else total + sig
            sig = sig + hs[c]
        pools["aggregate"].append(SignatureSet(
            Signature.deserialize(total.compress()), keys[8 * c: 8 * c + 8], msgs[c]))
    s_sync = s0 + 8 * SERVE_COMMITTEES
    sig = hs[-1].mul(s_sync % R)
    for j in range(SERVE_SYNC):
        pools["sync_message"].append(SignatureSet(
            Signature.deserialize(sig.compress()), [keys[8 * SERVE_COMMITTEES + j]],
            msgs[-1]))
        sig = sig + hs[-1]
    good = pools["unaggregated"][0]
    poisoned = SignatureSet(good.signature, good.signing_keys, msgs[1])
    return pools, poisoned


def _route_counts(svc) -> dict:
    st = svc.status()
    return {**st["cold_routes"], "fallback_calls": st["fallback"]["calls"]}


def serve_pass(label, svc, events, pools, extra=(), bypass=(), scheduler_cls=None,
               **sched_kw):
    """Replay ``events`` (a ``traffic`` trace) through a fresh
    ``VerificationScheduler`` (or ``scheduler_cls``) with ``svc`` attached, its default
    ``verify_fn`` (the port's ``bls.verify_signature_sets``, on the card)
    and ``sched_kw``:
    this thread submits each event at its time ``t``, a set drawn in turn
    from its kind's pool; ``extra`` holds (t, kind, set, verdict) to
    submit as well; a second thread calls ``verify_now`` with each
    (t, sets) of ``bypass``. Every verdict must be right. Prints and
    returns the pass's counts, routes (``warm`` is every routed dispatch,
    sub-batches and ``verify_now`` calls, less the padded and shed ones),
    latencies, captures and the kernels' lane histogram (``lane_hist``)."""
    import threading

    from lighthouse_tpu_torch.crypto.device import graphs, kernels
    from lighthouse_tpu_torch.utils import pipeline_profiler
    from lighthouse_tpu_torch.verification_service import VerificationScheduler

    drawn = dict.fromkeys(pools, 0)
    items = []
    for ev in events:
        pool = pools[ev["kind"]]
        items.append((ev["t"], ev["kind"], pool[drawn[ev["kind"]] % len(pool)], True))
        drawn[ev["kind"]] += 1
    items = sorted([*items, *extra], key=lambda it: it[0])
    routes0, stages0 = _route_counts(svc), dict(svc.status()["stages"])
    graphs0 = graphs.status()["programs"]
    sched = (scheduler_cls or VerificationScheduler)(compile_service=svc, **sched_kw).start()
    walls_now, errors = [], []

    def blocks():
        for t, sets in bypass:
            time.sleep(max(0.0, t0 + t - time.perf_counter()))
            w0 = time.perf_counter()
            try:
                if sched.verify_now(sets, "block") is not True:
                    errors.append(f"verify_now at t={t}: False for a valid block batch")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"verify_now at t={t}: {e!r}")
            walls_now.append(time.perf_counter() - w0)

    # this stream only: a device-wide sync is refused while the compile
    # service's worker captures, and invalidates that capture
    torch.cuda.current_stream().synchronize()
    kernels.reset_launches()
    pipeline_profiler.reset()  # the bubbles and flush phases of this pass
    pipeline0 = _journal_count("pipeline_flush")
    t0 = time.perf_counter()
    blocker = threading.Thread(target=blocks, name="serve-blocks")
    blocker.start()
    futs = []
    for t, kind, s, want in items:
        time.sleep(max(0.0, t0 + t - time.perf_counter()))
        futs.append((t, kind, want, sched.submit([s], kind)))
    submitted_s = time.perf_counter() - t0
    for t, kind, want, f in futs:
        got = f.result(timeout=WARM_TIMEOUT_S)
        if got is not want:
            errors.append(f"{kind} submitted at t={t}: verdict {got}, expected {want}")
    blocker.join()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    hist = {k: dict(h) for k, h in kernels.lane_hist.items()}
    sched.stop()
    if errors:
        raise AssertionError(f"serve {label}: " + "; ".join(errors[:10]))
    st, slo = sched.status(), sched.slo_summary()
    routes1 = _route_counts(svc)
    routes = {k: routes1[k] - routes0[k] for k in routes1}
    routes = {"warm": st["fused_batches_total"] + len(bypass) - routes["padded"]
              - routes["shed"], **routes}
    stages1 = svc.status()["stages"]
    warmed = {r: round(sum(v["seconds"] for v in recs.values()), 3)
              for r, recs in stages1.items() if r not in stages0}
    new_graphs = {}
    for prog, recs in graphs.status()["programs"].items():
        for key, rec in recs.items():
            if key not in graphs0.get(prog, {}):
                new_graphs[f"{prog} {key.split(' ', 2)[-1]}"] = round(rec["capture_s"], 3)
    out = {
        "submissions": len(futs) + len(bypass),
        "flushes": st["planner"]["plans_planned_total"] + st["planner"]["plans_single_total"],
        "sub_batches": st["fused_batches_total"],
        "planned_flushes": st["planner"]["plans_planned_total"],
        "buckets_seen": st["buckets_seen"],
        "routes": routes,
        "bisections": st["bisections_total"],
        "watchdog_reaped": st["watchdog_reaped_total"],
        "launches": launches,
        "wall_s": wall,
        "submit_s": submitted_s,
        "verify_now_walls_s": walls_now,
        "rungs_warmed": warmed,
        "graphs_captured": new_graphs,
        "slo": {k: {f: v[f] for f in ("count_total", "p50_ms", "p99_ms", "max_ms",
                                      "window_miss_ratio")} | {
                    "paths": {p: [d["count"], d["p50_ms"], d["p99_ms"]]
                              for p, d in v["paths"].items()}}
                for k, v in slo["kinds"].items()},
        "budget_ms": slo["budget_ms"],
        "lane_hist": hist,
    }
    log(f"serve {label}: {out['submissions']} submissions ({len(futs)} submitted over "
        f"{submitted_s:.2f} s, {len(bypass)} verify_now), {out['flushes']} flushes "
        f"({out['planned_flushes']} planned), {out['sub_batches']} sub-batches, buckets "
        f"{out['buckets_seen']}; wall {wall:.2f} s; every verdict right")
    log(f"  routes {json.dumps(routes)}; bisections {out['bisections']}; K1-K3 launches "
        f"credited {json.dumps(launches)}")
    for kind, v in out["slo"].items():
        log(f"  {kind}: {v['count_total']} verdicts, p50 {v['p50_ms']} ms, p99 "
            f"{v['p99_ms']} ms, max {v['max_ms']} ms, miss ratio {v['window_miss_ratio']} "
            f"(budget {out['budget_ms']} ms); by path [count, p50, p99] "
            f"{json.dumps(v['paths'])}")
    log(f"  verify_now walls {[round(w, 4) for w in walls_now]} s")
    log(f"  rungs the worker warmed during the pass (stage seconds): {json.dumps(warmed)}")
    log(f"  graphs captured during the pass: {len(new_graphs)}, capture s "
        f"{json.dumps(new_graphs)}")
    out["telemetry"] = pass_telemetry(f"serve {label}", out["flushes"], pipeline0)
    log(f"  {card_line()}")
    return out


def shed_pass(events, pools, rung, dev) -> dict:
    """The trace again, through a second compile service whose ladder is
    only ``rung`` (a rung phase 9 captured, so it is warm at once). It is
    not the attached service, so ``decide_flush`` downgrades ``padded`` to
    ``shed``: the first flush of every other geometry is served by
    ``fallback_verify`` on the C verifier while this service's worker
    warms the flush's exact rung (graphs the earlier passes captured, so
    each warm-up is a replay); later flushes of that geometry run on the
    card. Holds every verdict, at least one shed flush served by the
    fallback, and the fallback backend ``cpu-native``."""
    from lighthouse_tpu_torch.compile_service import service as csvc

    csvc.set_msm_warm_enabled(False)  # the MSM ladder is the attached service's
    shed_svc = csvc.CompileService(rungs=[rung], device=dev).start()
    if not shed_svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"serve shed pass: the second service did not warm {rung}")
    out = serve_pass(f"shed pass (a second service, ladder [{rung}])", shed_svc, events,
                     pools)
    if not shed_svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("serve shed pass: the second service is not idle")
    shed_svc.stop()
    csvc.set_msm_warm_enabled(True)
    fb = shed_svc.status()["fallback"]
    if fb["backend"] != "cpu-native":
        raise AssertionError(f"serve shed pass: the fallback backend is {fb['backend']}")
    if not out["routes"]["shed"] or not out["routes"]["fallback_calls"]:
        raise AssertionError(f"serve shed pass: routes {out['routes']}: no shed served")
    out["fallback"] = fb
    paths = {k: v["paths"]["fallback"] for k, v in out["slo"].items()
             if "fallback" in v["paths"]}
    log(f"  fallback {fb['backend']}: {fb['calls']} calls, {fb['sets']} sets, "
        f"{fb['seconds']:.4f} s in all; fallback path by kind [count, p50 ms, p99 ms] "
        f"{json.dumps(paths)}")
    return out


def serve_phase(rng, svc, block_batches, dev, planner_off=False) -> dict:
    """The port's ``VerificationScheduler`` on the card, with the phase-9
    compile service attached and the default ``verify_fn``: a replay of
    ``traffic.gossip_steady(duration_s=SERVE_DURATION_S, seed=0)`` in
    three passes. The cold pass meets whatever rungs its flushes ask for
    (warm, or padded onto a larger warm rung while the worker warms the
    exact one); after ``svc.wait_idle()`` the warm pass adds one poisoned
    attestation and two block batches through ``verify_now`` (with
    ``planner_off`` it runs again with the flush planner off, every flush
    one rung, to compare); the shed pass (:func:`shed_pass`) routes flushes
    to the C fallback. Ends when the service is idle. Holds every verdict,
    no shed in the warm pass, K1-K3 launched in the warm pass, and the
    fallback backend ``cpu-native``."""
    from lighthouse_tpu_torch.crypto.bls import PublicKey, SignatureSet
    from lighthouse_tpu_torch.verification_service import traffic

    events = traffic.gossip_steady(duration_s=SERVE_DURATION_S, seed=0, rate_scale=1.0)
    counts = {k: sum(1 for e in events if e["kind"] == k)
              for k in ("unaggregated", "aggregate", "sync_message")}
    t0 = time.perf_counter()
    pools, poisoned = serve_pools(rng, 300_000)
    log(f"serve trace: gossip_steady({SERVE_DURATION_S} s, seed 0): {len(events)} "
        f"submissions {json.dumps(counts)}; pools signed on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    st = svc.status()["fallback"]
    if st["backend"] != "cpu-native":
        raise AssertionError(f"serve: the fallback backend is {st['backend']}")
    t0 = time.perf_counter()
    ok = svc.fallback_verify(pools["aggregate"][:2])
    bad = svc.fallback_verify([pools["unaggregated"][1], poisoned])
    if ok is not True or bad is not False:
        raise AssertionError(f"serve: fallback_verify gave {ok}, {bad} (want True, False)")
    log(f"fallback {st['backend']} (C build and two batches) {time.perf_counter() - t0:.3f} s: "
        "valid True, poisoned False")
    out = {"trace": {"events": len(events), **counts}}
    out["cold"] = serve_pass("cold pass", svc, events, pools)
    t0 = time.perf_counter()
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"serve: the compile service is not idle after {WARM_TIMEOUT_S} s")
    out["wait_idle_s"] = time.perf_counter() - t0
    log(f"serve: the worker finished the rungs the cold pass asked for in "
        f"{out['wait_idle_s']:.2f} s more; warm rungs {svc.status()['warm_rungs']}")
    to_sets = [[SignatureSet(sig, [PublicKey(p) for p in pks], m) for sig, pks, m in batch]
               for batch in block_batches]
    half = SERVE_DURATION_S / 2
    warm_kw = dict(extra=[(half, "unaggregated", poisoned, False)],
                   bypass=[(half / 2, to_sets[0]), (half * 1.5, to_sets[1])])
    out["warm"] = serve_pass("warm pass", svc, events, pools, **warm_kw)
    w = out["warm"]
    if w["routes"]["shed"] or w["routes"]["fallback_calls"]:
        raise AssertionError(f"serve warm pass: routes {w['routes']}: a shed")
    missing = [k for k in KERNELS if not w["launches"].get(k)]
    if missing:
        raise AssertionError(f"serve warm pass: kernels never launched: {missing}")
    if planner_off:
        out["warm_single"] = serve_pass(
            "warm pass, single-rung plans (plan_flushes=False)", svc, events, pools,
            plan_flushes=False, **warm_kw)
    out["shed"] = shed_pass(events, pools, SERVE_SHED_RUNG, dev)
    # no capture of a rung the passes queued may overlap the timed phases
    t0 = time.perf_counter()
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"serve: the compile service is not idle after {WARM_TIMEOUT_S} s")
    out["end_wait_idle_s"] = time.perf_counter() - t0
    log(f"serve: the attached service was idle {out['end_wait_idle_s']:.2f} s after "
        "the last pass")
    out["fallback"] = svc.status()["fallback"]
    out["pools"] = (pools, poisoned)
    return out


# ---------------------------------------------------------------------------
# The device mesh on the card: one discovered shard, then two shards on the
# one card through loss, recovery and a watchdog reap
# ---------------------------------------------------------------------------

def _events_since(seq0: int, kinds) -> list:
    from lighthouse_tpu_torch.utils import flight_recorder

    return [e for e in flight_recorder.events(list(kinds)) if e["seq"] >= seq0]


def _journal_seq() -> int:
    from lighthouse_tpu_torch.utils import flight_recorder

    return flight_recorder.status()["recorded_total"]


def _graph_count() -> int:
    from lighthouse_tpu_torch.crypto.device import graphs

    return graphs.status()["graphs"]


def _graph_keys() -> set:
    from lighthouse_tpu_torch.crypto.device import graphs

    return {f"{prog} {key}" for prog, recs in graphs.status()["programs"].items()
            for key in recs}


def _wait_for(cond, timeout: float, what: str, label: str = "mesh") -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{label}: timed out after {timeout} s waiting for {what}")
        time.sleep(0.02)
    return time.perf_counter() - t0


def mesh_pass(label, svc, events, pools, **kw) -> dict:
    """One serve pass (:func:`serve_pass`) on the attached mesh, with the
    shard-tagged journal of its sub-batches: the shards they dispatched
    on, their routes, the threads that ran them, and the flushes whose
    plan split across shards. The pass ends when the service is idle: a
    rung its flushes asked for may still be capturing when the last
    verdict lands, and a later step's capture count must not see it."""
    seq0 = _journal_seq()
    out = serve_pass(label, svc, events, pools, **kw)
    keys0 = _graph_keys()
    t0 = time.perf_counter()
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"{label}: the service is not idle after the pass")
    late = sorted(_graph_keys() - keys0)
    out["idle_wait_s"], out["graphs_after_pass"] = time.perf_counter() - t0, late
    log(f"  {label}: service idle {out['idle_wait_s']:.3f} s after the last verdict; "
        f"graphs the pass's warm-ups captured after it: {len(late)} {late}")
    tags = _events_since(seq0, ["shard_dispatch"])
    plans = _events_since(seq0, ["scheduler_plan"])
    out["shards"] = {}
    for e in tags:
        f = e["fields"]
        rec = out["shards"].setdefault(f["shard"], {"sub_batches": 0, "sets": 0,
                                                    "routes": {}, "threads": []})
        rec["sub_batches"] += 1
        rec["sets"] += f["n_sets"]
        rec["routes"][f["route"]] = rec["routes"].get(f["route"], 0) + 1
        if e["thread"] not in rec["threads"]:
            rec["threads"].append(e["thread"])
    # the journal keeps a list field as its text
    out["split_flushes"] = sum(1 for e in plans
                               if len(json.loads(str(e["fields"]["dp_shards"]))) > 1)
    out["flush_plans"] = len(plans)
    if len(tags) != out["sub_batches"]:
        raise AssertionError(f"{label}: {len(tags)} shard-tagged sub-batches of "
                             f"{out['sub_batches']}")
    log(f"  {label}: per shard {json.dumps(out['shards'])}; {out['split_flushes']} of "
        f"{out['flush_plans']} flushes split across shards")
    return out


def mesh_phase(svc, table, pools, poisoned, serve_warm, backend, gbsets, dev) -> dict:
    """The device mesh on the card (``crypto/device/mesh.py``), with the
    phase-9 compile service, phase 5's key table and phase 12's pools.

    1. The mesh this machine discovers (``DeviceMesh()``): one shard on
       ``cuda:0``; the key table re-synced (one replica) and a short
       ``gossip_steady`` trace served, every sub-batch tagged shard 0.
    2. Two shards on the one card: a new key table over phase 5's registry
       syncs two replicas (twice the upload, the replicas equal); the
       service walks its ladder again, now for shard 1 (no graph may be
       captured: shard 0's graphs are on the same device); a gathered
       block batch verifies from each shard's replica; a trace is served
       with a planner that splits flushes across both shards.
    3. Card loss, keyed as the JAX package's chaos tests key it: the
       scheduler's verifier (and the recovery probe, which runs the same
       verifier after the canary) raises ``InjectedFault`` in shard 1's
       dispatch scope while the fault is on, else runs the backend on the
       card. Shard 1 is lost, a poisoned set in the degraded flushes is
       the only False, and the probes fail with growing attempts.
    4. Recovery: the fault cleared, a probe passes, the re-warm captures
       nothing, the key table re-syncs, shard 1 is re-admitted and flushes
       split again (with a ``verify_now`` block batch on the primary).
    5. Watchdog: the same verifier hangs ``MESH_HANG_S`` on shard 1's next
       dispatch under a ``MESH_WATCHDOG_S`` deadline. Timed from a stamp
       the flush thread takes before it starts the watched dispatch, the
       reap comes no earlier than the deadline and within the deadline
       plus 0.5 s, and the sets fail over with right verdicts.

    Every verdict must be right; the phase ends with no mesh attached and
    the service's ladder back on one shard."""
    import threading

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import PublicKey, SignatureSet
    from lighthouse_tpu_torch.crypto.device import key_table
    from lighthouse_tpu_torch.crypto.device import mesh as mesh_mod
    from lighthouse_tpu_torch.utils import fault_injection as fi
    from lighthouse_tpu_torch.verification_service import VerificationScheduler, traffic
    from lighthouse_tpu_torch.verification_service.planner import FlushPlanner

    events = traffic.gossip_steady(duration_s=MESH_DURATION_S, seed=1, rate_scale=1.0)
    out = {"trace_events": len(events)}
    t_phase = time.perf_counter()

    # 1. the discovered mesh: one shard on this machine's one card
    mesh1 = mesh_mod.DeviceMesh() if dev.type == "cuda" else mesh_mod.DeviceMesh(devices=[dev])
    if len(mesh1) != 1 or mesh1.device_for(0) != dev:
        raise AssertionError(f"mesh: discovered {mesh1.devices}, expected [{dev}]")
    mesh_mod.set_mesh(mesh1)
    key_table.set_table(table)
    added = table.sync(reason="recovery")
    if table.status()["replicas"] != [0] or added:
        raise AssertionError(f"mesh: the key table re-sync added {added} rows, replicas "
                             f"{table.status()['replicas']}")
    log(f"mesh 1: discovered {len(mesh1)} shard on {mesh1.devices}; key table re-synced "
        f"({added} rows, replicas [0])")
    one = mesh_pass("mesh 1 (one discovered shard)", svc, events, pools)
    if set(one["shards"]) != {0}:
        raise AssertionError(f"mesh 1: sub-batches on shards {sorted(one['shards'])}")
    missing = [k for k in KERNELS if not one["launches"].get(k)]
    if missing:
        raise AssertionError(f"mesh 1: kernels never launched: {missing}")
    chip = mesh1.status()["chips"][0]
    if chip["failures"] or (dev.type == "cuda" and not chip["device_memory_bytes"]):
        raise AssertionError(f"mesh 1: status {chip}")
    log(f"mesh 1 status: {chip['sets_per_sec']} sets/s over the window, "
        f"{chip['sets_total']} sets in {chip['dispatches']} dispatches, "
        f"device_memory_bytes {chip['device_memory_bytes']}, failures {chip['failures']}")
    for kind, v in one["slo"].items():
        w = serve_warm["slo"].get(kind, {})
        log(f"  {kind}: p50 {v['p50_ms']} / p99 {v['p99_ms']} ms on the mesh; phase 12 "
            f"warm pass p50 {w.get('p50_ms')} / p99 {w.get('p99_ms')} ms")
    out["one_shard"] = {"pass": one, "status": mesh1.status()}
    mesh_mod.clear_mesh(mesh1)

    # 2. two shards on the one card
    mesh2 = mesh_mod.DeviceMesh(devices=[dev, dev], probe_base_s=MESH_PROBE_BASE_S,
                                probe_max_s=MESH_PROBE_MAX_S)
    mesh_mod.set_mesh(mesh2)
    table2 = key_table.DeviceKeyTable(table.cache, device=dev)
    t0 = time.perf_counter()
    n = table2.sync(reason="startup")
    sync_s = time.perf_counter() - t0
    st1, st2 = table.status(), table2.status()
    one_bytes = st1["upload_bytes"]["startup"] + st1["upload_bytes"]["delta"]
    (d0, a0), (d1, a1) = table2.device_arrays(0), table2.device_arrays(1)
    if (st2["replicas"] != [0, 1] or st2["upload_bytes"]["startup"] != 2 * one_bytes
            or d0 is d1 or not torch.equal(d0, d1) or not torch.equal(a0, a1)
            or not torch.equal(d0[:n], table.device_arrays(0)[0][:n])):
        raise AssertionError(f"mesh 2: key table replicas {st2['replicas']}, upload "
                             f"{st2['upload_bytes']} (one replica {one_bytes} B)")
    log(f"mesh 2: key table synced {n} rows onto replicas {st2['replicas']} in "
        f"{sync_s:.3f} s: upload {st2['upload_bytes']['startup']} B (one replica "
        f"{one_bytes} B), replicas torch.equal; device bytes {st2['device_bytes']} "
        f"(phase 5's one replica {st1['device_bytes']}); allocated on the card "
        f"{torch.cuda.memory_allocated(dev) if dev.type == 'cuda' else None} B")
    key_table.set_table(table2)
    g0 = _graph_count()
    t0 = time.perf_counter()
    svc.stop()
    svc.start()  # the ladder over (rung, shard) for both shards
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("mesh 2: the ladder walk did not finish")
    plan_warm = [r for r in svc.plan if r in svc.warm_rungs_active(device=1)]
    # the rungs traffic warmed on shard 0, asked for on shard 1 as a flush's
    # routing would
    extra = [r for r in svc.warm_rungs_active(device=0)
             if r not in svc.warm_rungs_active(device=1)]
    for r in extra:
        svc.request(*r, device=1)
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("mesh 2: the shard-1 warm-ups did not finish")
    walk_s = time.perf_counter() - t0
    walk_graphs = _graph_count() - g0
    by_shard = svc.warm_rungs_by_shard([0, 1])
    log(f"mesh 2: the service walked its ladder for shard 1 ({len(plan_warm)} of "
        f"{len(svc.plan)} plan rungs warm) and {len(extra)} rungs traffic warmed on "
        f"shard 0, in {walk_s:.2f} s; graphs captured: {walk_graphs} (shard 0's are "
        f"on the same device); warm rungs per shard "
        f"{ {k: len(v) for k, v in by_shard.items()} }")
    if walk_graphs or len(plan_warm) != len(svc.plan):
        raise AssertionError(f"mesh 2: the walk captured {walk_graphs} graphs, warmed "
                             f"{plan_warm}")
    gathered = {}
    with held_collapse(table2):
        for shard in (0, 1):
            with mesh_mod.dispatch_to(shard):
                t0 = time.perf_counter()
                ok = backend.verify_signature_sets(gbsets)
                gathered[shard] = time.perf_counter() - t0
            lb = backend.last_batch
            if ok is not True or lb["path"] != "raw_gather" or not lb["warm"]:
                raise AssertionError(f"mesh 2: gathered block on shard {shard}: {ok}, "
                                     f"{batch_line(backend)}")
    log(f"mesh 2: the gathered block batch from each shard's replica: True, walls "
        f"{ {k: round(v, 4) for k, v in gathered.items()} } s")
    planner = FlushPlanner(dp_min_sets=MESH_DP_MIN_SETS)
    split = mesh_pass("mesh 2 (two shards, split flushes)", svc, events, pools,
                      flush_planner=planner)
    if not split["split_flushes"] or sorted(split["shards"]) != [0, 1]:
        raise AssertionError(f"mesh 2: no flush split across shards [0, 1]")
    threads = {t for rec in split["shards"].values() for t in rec["threads"]}
    if not {"flush-shard-0", "flush-shard-1"} <= threads:
        raise AssertionError(f"mesh 2: sub-batches ran on threads {sorted(threads)}")
    ratios = [c["bubble_ratio"] for c in mesh2.status()["chips"]]
    if any(r is None for r in ratios):
        raise AssertionError(f"mesh 2: bubble ratios {ratios}")
    log(f"mesh 2: bubble ratio per shard {ratios} (the pipeline profiler's, on the host "
        f"clock: both shards' busy intervals lie on the one card)")
    split["bubble_ratios"] = ratios
    out["two_shards"] = {"key_table_sync_s": sync_s, "upload_bytes": st2["upload_bytes"],
                         "device_bytes": st2["device_bytes"], "walk_s": walk_s,
                         "walk_graphs": walk_graphs, "gathered_walls": gathered,
                         "pass": split}

    # 3. card loss
    canary = [pools["unaggregated"][0]]
    chaos = {"lost": False, "hang_s": 0.0, "hung_at": None}
    chaos_lock = threading.Lock()

    def chaos_verify(sets):
        # shard 1's dispatches fail while the fault is on, or hang once
        if mesh_mod.current_shard() == 1:
            if chaos["lost"]:
                raise fi.InjectedFault("staged_dispatch: card lost on shard 1")
            with chaos_lock:
                hang_s, chaos["hang_s"] = chaos["hang_s"], 0.0
                if hang_s:
                    chaos["hung_at"] = time.time()
            if hang_s:
                time.sleep(hang_s)
        return bls.verify_signature_sets(sets)

    def probe(shard):
        # the canary on the card, then one set through the same verifier
        return mesh2._default_canary(shard) and chaos_verify(canary) is True

    mesh2.start_recovery(probe_fn=probe)
    seq_loss = _journal_seq()
    chaos["lost"] = True
    half = MESH_DURATION_S / 2
    lost = mesh_pass("mesh 3 (shard 1 lost)", svc, events, pools, flush_planner=planner,
                     extra=[(half, "unaggregated", poisoned, False)], verify_fn=chaos_verify)
    lost_ev = _events_since(seq_loss, ["shard_lost"])
    if [e["fields"]["shard"] for e in lost_ev] != [1] or mesh2.healthy_shards() != [0]:
        raise AssertionError(f"mesh 3: shard_lost {lost_ev}, healthy "
                             f"{mesh2.healthy_shards()}")
    _wait_for(lambda: mesh2.status()["chips"][1]["probe_attempts"] >= 1, 30,
              "a failed probe")
    attempts = [e["fields"]["attempt"] for e in _events_since(seq_loss, ["shard_probation"])]
    if attempts[:2] != [0, 1] or attempts != sorted(attempts):
        raise AssertionError(f"mesh 3: probation attempts {attempts}")
    log(f"mesh 3: shard 1 lost ({lost_ev[0]['fields']['error']}); the poisoned set the "
        f"only False; probation attempts {attempts}, each failed probe journaled")
    out["loss"] = {"pass": lost, "probation_attempts": attempts,
                   "status": mesh2.status()}

    # 4. recovery
    keys0, seq_rec = _graph_keys(), _journal_seq()
    chaos["lost"] = False
    down_s = _wait_for(lambda: mesh2.healthy_shards() == [0, 1],
                       MESH_PROBE_MAX_S * 2 + 30, "re-admission")
    # the recovery worker re-admits the shard, then journals it
    _wait_for(lambda: _events_since(seq_rec, ["shard_recovered"]), 5,
              "the shard_recovered event")
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("mesh 4: the re-warm did not finish")
    rec = _events_since(seq_rec, ["shard_recovered"])
    rec_new = sorted(_graph_keys() - keys0)
    rec_graphs = len(rec_new)
    if [e["fields"]["shard"] for e in rec] != [1] or rec_graphs:
        raise AssertionError(f"mesh 4: shard_recovered {rec}, graphs captured {rec_new}")
    log(f"mesh 4: shard 1 re-admitted {down_s:.2f} s after the fault cleared "
        f"({json.dumps(rec[0]['fields'])}); graphs captured by the re-warm: {rec_graphs}; "
        f"key table re-synced (upload {table2.status()['upload_bytes']})")
    blocks = [SignatureSet(sig, [PublicKey(p) for p in pks], m) for sig, pks, m in gbsets]
    with held_collapse(table2):
        resplit = mesh_pass("mesh 4 (shard 1 re-admitted)", svc, events, pools,
                            flush_planner=planner, bypass=[(half, blocks)])
    if not resplit["split_flushes"] or sorted(resplit["shards"]) != [0, 1]:
        raise AssertionError("mesh 4: flushes did not split across shards [0, 1] again")
    out["recovery"] = {"pass": resplit, "readmitted_after_s": down_s,
                       "recovered": rec[0]["fields"], "graphs_captured": rec_graphs}

    # 5. the watchdog reaps a hang on shard 1
    starts = []

    class StampedScheduler(VerificationScheduler):
        # stamps each watched dispatch on the flush thread, before the
        # watchdog starts its worker and its deadline
        def _dispatch_on(self, verify, sets, shard, deadline_s, **kw):
            starts.append((time.time(), shard))
            return super()._dispatch_on(verify, sets, shard, deadline_s, **kw)

    seq_wd = _journal_seq()
    chaos["hang_s"] = MESH_HANG_S
    try:
        wd = mesh_pass("mesh 5 (watchdog)", svc, events, pools, flush_planner=planner,
                       watchdog_s=MESH_WATCHDOG_S, verify_fn=chaos_verify,
                       scheduler_cls=StampedScheduler)
    finally:
        chaos["hang_s"] = 0.0
    reaps = _events_since(seq_wd, ["watchdog_reaped"])
    hung_at = chaos["hung_at"]
    if not reaps or hung_at is None or reaps[0]["fields"]["shard"] != 1:
        raise AssertionError(f"mesh 5: reaps {reaps}, hang began at {hung_at}")
    began = [t for t, shard in starts if shard == 1 and t <= hung_at][-1]
    reap_s = reaps[0]["t"] - began
    if not MESH_WATCHDOG_S - 0.02 <= reap_s <= MESH_WATCHDOG_S + 0.5:
        raise AssertionError(f"mesh 5: reaped {reap_s:.3f} s after the dispatch began "
                             f"(deadline {MESH_WATCHDOG_S} s)")
    reaped_total = wd["watchdog_reaped"]
    if reaped_total < 1:
        raise AssertionError("mesh 5: the scheduler counted no reap")
    log(f"mesh 5: the hang on shard 1 reaped {reap_s:.3f} s after its dispatch began "
        f"(deadline {MESH_WATCHDOG_S} s, hang {MESH_HANG_S} s); {len(reaps)} reaped; "
        f"every verdict right")
    # the reaped dispatch runs on after its hang: wait for it and for the
    # recovery of shard 1 before the timed phases
    for th in threading.enumerate():
        if th.name.startswith("dispatch-wd-"):
            th.join(timeout=MESH_HANG_S + 60)
    _wait_for(lambda: mesh2.healthy_shards() == [0, 1], MESH_PROBE_MAX_S * 2 + 30,
              "shard 1 back after the reap")
    out["watchdog"] = {"pass": wd, "reap_s": reap_s, "reaps": len(reaps),
                       "reaped_total": reaped_total}

    # 6. a hang inside a replay, with the graph's lock held
    with held_collapse(table2):
        out["replay_hang"] = replay_hang_step(mesh2, backend, gbsets)
    out["final_status"] = mesh2.status()
    mesh2.stop_recovery()
    mesh_mod.clear_mesh(mesh2)
    key_table.clear_table(table2)
    del table2, d0, d1, a0, a1
    svc.stop()
    svc.start()  # the ladder back on one shard, as with no mesh
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("mesh: the service is not idle after the phase")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['wall_s']:.1f} s; {card_line()}")
    return out


def replay_hang_step(mesh2, backend, sets) -> dict:
    """Mesh step 6: a dispatch on shard 1 hangs inside a graph replay,
    after the graph's lock is taken (``CapturedProgram._outputs``, called
    under the lock, is wrapped here to sleep), the watchdog reaps it after
    ``MESH_WATCHDOG_S``, and the scheduler fails the sets over to shard 0,
    whose replay is of the same graph: both shards are on the one card.
    Run twice at ``REPLAY_HANG_S``: with the failover's
    ``graphs.no_graph_wait`` turned off (the port before the fix), then
    on. Per run: the reap's wall, the failover's wall
    and verdict (or the error that replaced it), its graph-lock wait and
    the eager runs beside the busy graph. With the fix on the failover
    must give the right verdict within the watchdog's deadline."""
    import contextlib
    import threading

    from lighthouse_tpu_torch.crypto.device import graphs
    from lighthouse_tpu_torch.crypto.device import mesh as mesh_mod
    from lighthouse_tpu_torch.verification_service import VerificationScheduler
    from lighthouse_tpu_torch.verification_service.batcher import WatchdogTimeout

    sched = VerificationScheduler(verify_fn=backend.verify_signature_sets,
                                  watchdog_s=MESH_WATCHDOG_S)
    outputs = graphs.CapturedProgram.__dict__["_outputs"]
    arm = {"hang_s": 0.0}
    arm_lock = threading.Lock()

    def hung_outputs(g, dev):
        if mesh_mod.current_shard() == 1:
            with arm_lock:
                hang_s, arm["hang_s"] = arm["hang_s"], 0.0
            if hang_s:
                time.sleep(hang_s)
        return outputs.__func__(g, dev)

    no_wait = graphs.no_graph_wait
    runs = {}
    graphs.CapturedProgram._outputs = staticmethod(hung_outputs)
    try:
        for label, hang_s, fixed in (("before the fix", REPLAY_HANG_S, False),
                                     ("the fix", REPLAY_HANG_S, True)):
            graphs.no_graph_wait = no_wait if fixed else contextlib.nullcontext
            waits0 = graphs.status()["lock_wait_s"]["graph"]
            eager0 = graphs.status()["failover_eager"]
            arm["hang_s"] = hang_s
            t0 = time.perf_counter()
            try:
                sched._dispatch_on(sched._verify, sets, 1, MESH_WATCHDOG_S)
                raise AssertionError("mesh 6: the hung replay was not reaped")
            except WatchdogTimeout as e:
                reap_s = time.perf_counter() - t0
                t1 = time.perf_counter()
                try:
                    verdict = sched._failover_retry(sched._verify, sets, 1, e, mesh2)
                except WatchdogTimeout as e2:
                    verdict = f"reaped again: {e2}"
                failover_s = time.perf_counter() - t1
            for th in threading.enumerate():  # the reaped dispatches run on
                if th.name.startswith("dispatch-wd-"):
                    th.join(timeout=hang_s + 60)
            st = graphs.status()
            wait = sum(st["lock_wait_s"]["graph"].values()) - sum(waits0.values())
            eager = sum(st["failover_eager"].values()) - sum(eager0.values())
            runs[f"{label}, hang {hang_s:g} s"] = rec = {
                "hang_s": hang_s, "fixed": fixed, "reap_s": reap_s, "failover_s": failover_s,
                "verdict": verdict, "graph_lock_wait_s": wait, "failover_eager": eager}
            log(f"mesh 6 ({label}): a {hang_s:g} s hang inside shard 1's replay, lock held: "
                f"reaped after {reap_s:.3f} s; the failover to shard 0 (the same graph) "
                f"took {failover_s:.3f} s, verdict {verdict}, graph-lock wait {wait:.3f} s, "
                f"eager runs beside the busy graph {eager}")
            _wait_for(lambda: mesh2.healthy_shards() == [0, 1], MESH_PROBE_MAX_S * 2 + 30,
                      "shard 1 back after the replay hang")
    finally:
        graphs.CapturedProgram._outputs = outputs
        graphs.no_graph_wait = no_wait
    fixed = [r for r in runs.values() if r["fixed"]]
    if any(r["verdict"] is not True or r["failover_s"] > MESH_WATCHDOG_S
           or r["failover_eager"] < 1 for r in fixed):
        raise AssertionError(f"mesh 6: with no_graph_wait the failover {fixed}")
    return runs


# ---------------------------------------------------------------------------
# Telemetry: the port's ledgers, profiler and estimator read on the card
# ---------------------------------------------------------------------------

def _journal_count(kind: str) -> float:
    """Journal events of ``kind`` recorded so far (the recorder's counter:
    exact whatever the ring dropped)."""
    from lighthouse_tpu_torch.utils import metrics

    return metrics.get("flight_recorder_events_total").with_labels(kind).value


def _ledger_h2d() -> float:
    from lighthouse_tpu_torch.utils import transfer_ledger

    return sum(c.value for c in transfer_ledger._H2D_BYTES.children().values())


def _verifies() -> float:
    """``CudaBackend`` verifies so far, whatever their verdict."""
    from lighthouse_tpu_torch.crypto.device import bls as dbls

    return sum(c.value for c in dbls._OUTCOMES.children().values())


def ledger_checked(label, backend, fn):
    """Run ``fn`` (verifies of one batch) and hold the telemetry they left
    against the backend's own account: the transfer ledger's H2D bytes
    per verify equal ``last_batch["h2d_bytes"]``, and each verify
    journaled one ``bls_stage_verify`` event and one ``transfer_ledger``
    row. Returns (``fn``'s result, the reading)."""
    h0, n0 = _ledger_h2d(), _verifies()
    sv0, tl0 = _journal_count("bls_stage_verify"), _journal_count("transfer_ledger")
    got = fn()
    n = _verifies() - n0
    lb = backend.last_batch
    per = (_ledger_h2d() - h0) / n if n else None
    rows = (_journal_count("bls_stage_verify") - sv0, _journal_count("transfer_ledger") - tl0)
    if not n or per != lb["h2d_bytes"] or rows != (n, n):
        raise AssertionError(f"{label}: ledger H2D per verify {per} B against last_batch "
                             f"{lb['h2d_bytes']} B; {rows} bls_stage_verify / "
                             f"transfer_ledger rows for {n} verifies")
    log(f"  {label}: ledger H2D {int(per)} B per verify = last_batch h2d_bytes (pubkey "
        f"planes {lb['pubkey_bytes']} B); one bls_stage_verify and one transfer_ledger "
        f"row each of {int(n)} verifies")
    return got, {"verifies": n, "h2d_bytes": per, "pubkey_bytes": lb["pubkey_bytes"]}


def bubble_reading(label: str) -> dict:
    """The pipeline profiler's shards since its last reset: busy, idle and
    the bubbles by cause, which must sum to the idle time (to the
    summary's rounding)."""
    from lighthouse_tpu_torch.utils import pipeline_profiler

    shards = pipeline_profiler.summary()["shards"]
    for i, sh in shards.items():
        if abs(sum(sh["causes"].values()) - sh["idle_s"]) > 1e-5 * (1 + len(sh["causes"])):
            raise AssertionError(f"{label}: shard {i} bubbles {sh['causes']} do not sum "
                                 f"to its idle {sh['idle_s']} s")
        log(f"  {label}: shard {i} busy {sh['busy_s']} s, idle {sh['idle_s']} s "
            f"(bubble ratio {sh['bubble_ratio']}) in {sh['gaps']} gaps; by cause "
            f"{json.dumps(sh['causes'])} (sum = idle)")
    return shards


def pass_telemetry(label: str, flushes: int, pipeline0: float) -> dict:
    """One serve pass as the pipeline profiler saw it (reset at its
    start): each shard's bubbles by cause, the ``pipeline_flush`` events
    (one per flush), the flush phases and the overlap-potential ratio."""
    from lighthouse_tpu_torch.utils import pipeline_profiler

    shards = bubble_reading(label)
    events = _journal_count("pipeline_flush") - pipeline0
    if events != flushes:
        raise AssertionError(f"{label}: {events} pipeline_flush events for {flushes} flushes")
    summ = pipeline_profiler.summary()
    ov = summ["overlap_potential"]
    log(f"  {label}: {int(events)} pipeline_flush events = {flushes} flushes; flush phases "
        f"s {json.dumps({k: v for k, v in summ['flushes'].items() if k.endswith('_s')})}; "
        f"saturation {summ['flush_thread_saturation']}; overlap potential "
        f"{ov['projected_speedup']} (measured {ov['measured_sets_per_sec']} sets/s, "
        f"projected {ov['projected_sets_per_sec']})")
    return {"shards": shards, "pipeline_flush_events": events, "flushes": summ["flushes"],
            "saturation": summ["flush_thread_saturation"],
            "overlap_speedup": ov["projected_speedup"]}


def set_telemetry(mode: str) -> None:
    """Every telemetry knob ``on`` (tracing included) or ``off``: the
    transfer ledger, pipeline profiler, slot ledger, capacity sampler,
    flight recorder and span tracing; ``ledger off``: every knob on but
    the transfer ledger's. Metric families have no knob."""
    from lighthouse_tpu_torch.utils import (
        flight_recorder, pipeline_profiler, slot_ledger, timeseries, tracing,
        transfer_ledger)

    on = mode != "off"
    for mod in (pipeline_profiler, slot_ledger, timeseries):
        mod.configure(enabled=on)
    transfer_ledger.configure(enabled=mode == "on")
    flight_recorder.configure(enabled=on)
    (tracing.enable if on else tracing.disable)()


def telemetry_overhead(backend, batches) -> dict:
    """Each warm batch verified with every telemetry knob on, off, and on
    but the transfer ledger's, in ``OVERHEAD_ROUNDS`` rounds of
    ``OVERHEAD_ROUNDS`` each: the medians side by side, and the on
    median's excess over off against max(5%, 5 ms). The knobs end at their
    defaults (tracing off)."""
    from lighthouse_tpu_torch.utils import tracing

    modes = ("on", "off", "ledger off")
    walls = {label: {m: [] for m in modes} for label in batches}
    try:
        for _round in range(OVERHEAD_ROUNDS):
            for mode in modes:
                set_telemetry(mode)
                for label, (sets, want) in batches.items():
                    for _ in range(OVERHEAD_ROUNDS):
                        torch.cuda.current_stream().synchronize()
                        t0 = time.perf_counter()
                        if backend.verify_signature_sets(sets) is not want:
                            raise AssertionError(f"overhead {label} ({mode}): wrong verdict")
                        torch.cuda.current_stream().synchronize()
                        walls[label][mode].append(time.perf_counter() - t0)
    finally:
        set_telemetry("on")
        tracing.disable()
        tracing.clear()
    out = {}
    for label, w in walls.items():
        on, off, nol = (statistics.median(w[m]) for m in modes)
        limit = max(0.05 * off, 0.005)
        out[label] = {"on_s": on, "off_s": off, "ledger_off_s": nol,
                      "excess_s": on - off, "within": on - off <= limit}
        log(f"  telemetry overhead, {label}: median {on:.4f} s with every knob on, "
            f"{off:.4f} s with every knob off, {nol:.4f} s with every knob on but the "
            f"transfer ledger's ({OVERHEAD_ROUNDS ** 2} verifies each): on {on - off:+.4f} s "
            f"({(on - off) / off:+.2%}) over off, "
            f"{'within' if on - off <= limit else 'OVER'} max(5%, 5 ms)")
    return out


def print_stage_summary(label: str) -> dict:
    """``bls.stage_latency_summary()``: the stage, verify, pack-phase and
    bubble rows."""
    from lighthouse_tpu_torch.crypto.device import bls as dbls

    rows = dbls.stage_latency_summary()
    log(f"{label}: stage_latency_summary() rows")
    for key, row in rows.items():
        log(f"  {key}: {json.dumps(row)}")
    return rows


def telemetry_phase(svc, pools, dev) -> dict:
    """The telemetry readings of one serve pass, with the phase-9 compile
    service and phase 12's pools: ``traffic.gossip_steady`` (seed 2,
    ``TELEMETRY_DURATION_S``) with every ledger reset first and the
    capacity sampler ticking every ``TELEMETRY_SAMPLE_S``. Prints the
    stage summary, the transfer ledger's data movement, the slot
    ledger's chain time, the capacity estimate with its cost source (and
    the bulk valve's headroom, which must be that estimate's), and
    ``device_memory_bytes{kind}`` beside the allocator's reserved bytes."""
    from lighthouse_tpu_torch.utils import (
        pipeline_profiler, slot_ledger, timeseries, transfer_ledger)
    from lighthouse_tpu_torch.verification_service import admission, traffic

    events = traffic.gossip_steady(duration_s=TELEMETRY_DURATION_S, seed=2, rate_scale=1.0)
    slot_ledger.reset()
    timeseries.reset()
    timeseries.start_sampler(interval_s=TELEMETRY_SAMPLE_S)
    try:
        out = {"pass": serve_pass("telemetry pass", svc, events, pools)}
    finally:
        timeseries.stop_sampler()
    est = timeseries.last_estimate()
    headroom = admission._live_headroom()
    cap = timeseries.capacity_summary()
    if est is None or est["cost_source"] is None or est["headroom_ratio"] is None \
            or headroom != est["headroom_ratio"]:
        raise AssertionError(f"telemetry: estimate {est}, bulk valve headroom {headroom}")
    store = timeseries.get_store()
    series = {fam: [round(v, 4) for _t, v in store.points(fam)]
              for fam in ("capacity_utilization", "capacity_headroom_ratio",
                          "capacity_estimated_sets_per_sec")}
    log(f"  capacity, the sampler's last tick: {est['estimated_sets_per_sec']} sets/s from "
        f"cost {est['cost_s_per_set']} s a set ({est['cost_source']}) on {est['shards']} "
        f"shard(s); arrival {est['arrival_sets_per_sec']} sets/s; utilization "
        f"{est['utilization']}; headroom {est['headroom_ratio']} (the bulk valve reads "
        f"{headroom}); every tick of the pass {json.dumps(series)}; "
        f"{cap['sampler']['samples_total']} samples, store {json.dumps(cap['store'])}")
    dm = transfer_ledger.summary()
    log(f"  data movement: H2D {dm['h2d_bytes_total']} B by operand "
        f"{json.dumps(dm['h2d_bytes_by_operand'])} by kind "
        f"{json.dumps(dm['h2d_bytes_by_kind'])}; D2H {dm['d2h_bytes_total']} B; pack share "
        f"of the verify wall {dm['pack_share_of_verify_wall']}; H2D bandwidth over "
        f"device_put {dm['h2d_bandwidth_bytes_per_s']} B/s; pubkey re-upload "
        f"{json.dumps(dm['pubkey_reupload'])}")
    mem = transfer_ledger.update_device_memory(force=True)
    reserved = torch.cuda.memory_reserved(dev) if dev.type == "cuda" else None
    log(f"  device_memory_bytes {json.dumps(mem)}; the allocator reserves {reserved} B "
        f"(graph pools and cached segments, which bytes_in_use does not count)")
    if dev.type == "cuda" and not (mem and mem.get("bytes_in_use") and mem.get("bytes_limit")):
        raise AssertionError(f"telemetry: device_memory_bytes {mem}")
    chain = slot_ledger.summary()
    cards = slot_ledger.slot_cards(last=2)
    log(f"  slot ledger: {json.dumps(chain)}; newest cards {json.dumps(cards)[:1500]}")
    out.update(stage_summary=print_stage_summary("telemetry pass"), estimate=est,
               capacity_series=series, headroom=headroom, data_movement=dm,
               device_memory=mem,
               reserved_bytes=reserved, chain_time=chain,
               pipeline=pipeline_profiler.summary())
    return out


# ---------------------------------------------------------------------------
# The chain phase: the port's beacon chain on the card
# ---------------------------------------------------------------------------
#
# Five processes, each a stage of one pipeline (the host work of a chain at
# 16,384 validators is pure Python, so each stage needs its own core): the
# producer (the harness: blocks and the gossip's plan), the signer (the
# gossip's signatures, by the C library on eight threads), this process
# (the block chain on the card), the segment chain (on the card, in its
# own process) and the oracle (on cpu-native). Only SSZ bytes and plain
# values cross between them.


def chain_spec_and_types():
    from dataclasses import replace

    from lighthouse_tpu_torch.types import types_for
    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.types.preset import MAINNET

    return MAINNET, replace(mainnet_spec(), altair_fork_epoch=0), types_for(MAINNET)


def chain_harness(n: int):
    """The phase's interop chain: mainnet preset, altair from genesis, ``n``
    validators, signed and keyed by the C library (the oracle's bytes)."""
    from lighthouse_tpu_torch.testing.harness import (
        StateHarness, native_pubkey, native_signer)

    preset, spec, _t = chain_spec_and_types()
    return StateHarness(preset, spec, n, fork_name="altair", signer=native_signer,
                        pubkey_fn=native_pubkey)


def chain_node(genesis_bytes: bytes, n_expected: int, **cfg):
    """A beacon node built by the port's ``ClientBuilder`` on the genesis
    state carried across as SSZ bytes: the mainnet preset (altair from
    genesis), an in-memory store, HTTP on a free port unless ``cfg`` turns
    it off, and a ``ManualSlotClock`` installed as the process clock (the
    duty lookahead and the key table read it). ``cfg`` holds the other
    ``ClientConfig`` fields. Returns (client, clock, types); the client is
    started."""
    from lighthouse_tpu_torch.client import ClientBuilder, ClientConfig
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock, set_clock

    preset, spec, t = chain_spec_and_types()
    genesis = t.state["altair"].decode(genesis_bytes)
    if len(genesis.validators) != n_expected:
        raise AssertionError("chain: the genesis state lost validators on the way")
    clock = ManualSlotClock(genesis.genesis_time, spec.seconds_per_slot,
                            preset.SLOTS_PER_EPOCH)
    set_clock(clock)
    client = (ClientBuilder(ClientConfig(**{"preset_base": "mainnet", "http_port": 0, **cfg}),
                            spec)
              .with_genesis_state(genesis).with_slot_clock(clock).build().start())
    return client, clock, t


def slot_attestations(h, slot: int, cache):
    """``h.attestations_for_slot(h.state, slot)`` (the state at ``slot``)
    over the epoch's committees computed once: each committee's fully
    participating attestation, signed by ``h.sign_root``."""
    from lighthouse_tpu_torch.state_transition.helpers import latest_block_header_root
    from lighthouse_tpu_torch.types import (
        DOMAIN_BEACON_ATTESTER, compute_signing_root, get_domain)

    state, t, preset = h.state, h.t, h.preset
    epoch = slot // preset.SLOTS_PER_EPOCH
    head = latest_block_header_root(state)
    start = epoch * preset.SLOTS_PER_EPOCH
    target = (bytes(state.block_roots[start % preset.SLOTS_PER_HISTORICAL_ROOT])
              if start < state.slot else head)
    domain = get_domain(h.spec, state, DOMAIN_BEACON_ATTESTER, epoch)
    out = []
    for index in range(cache.committees_per_slot):
        committee = [int(v) for v in cache.committee(slot, index)]
        data = t.AttestationData(
            slot=slot, index=index, beacon_block_root=head,
            source=state.current_justified_checkpoint,
            target=t.Checkpoint(epoch=epoch, root=target))
        root = compute_signing_root(t.AttestationData, data, domain)
        out.append((committee, root, t.Attestation(
            aggregation_bits=[True] * len(committee), data=data,
            signature=h.sign_root([h.keys[v] for v in committee], root))))
    return out


def slot_plan(h, slot: int, block_root: bytes, cache, index_of: dict):
    """The gossip of ``slot`` on the harness's head state (the slot's block
    imported), all but its members' signatures: each committee member's
    unaggregated attestation (one, at a position drawn from the slot, to be
    signed by another validator's key), each committee's aggregate with its
    aggregator's proof, every sync committee member's message over the
    block root. Returns the plan and the full aggregates the next block
    carries."""
    from lighthouse_tpu_torch import ssz
    from lighthouse_tpu_torch.beacon_chain.attestation_verification import _is_aggregator
    from lighthouse_tpu_torch.crypto.native import native_sign
    from lighthouse_tpu_torch.types import (
        DOMAIN_AGGREGATE_AND_PROOF, DOMAIN_SELECTION_PROOF, DOMAIN_SYNC_COMMITTEE,
        compute_signing_root, get_domain)

    state, t, spec = h.state, h.t, h.spec
    epoch = slot // h.preset.SLOTS_PER_EPOCH
    atts = slot_attestations(h, slot, cache)
    unagg = []  # (attestation data bytes, position, size, secret, root)
    for committee, root, agg in atts:
        data = t.AttestationData.encode(agg.data)
        unagg += [(data, pos, len(committee), h.keys[v].k, root)
                  for pos, v in enumerate(committee)]
    bad = (slot * 7919) % len(unagg)
    unagg[bad] = (*unagg[bad][:3], unagg[bad][3] + 1, unagg[bad][4])  # another key
    sync_root = compute_signing_root(
        None, block_root, get_domain(spec, state, DOMAIN_SYNC_COMMITTEE, epoch))
    members = list(dict.fromkeys(index_of[bytes(pk)]
                                 for pk in state.current_sync_committee.pubkeys))
    sel_root = compute_signing_root(
        ssz.Uint64, slot, get_domain(spec, state, DOMAIN_SELECTION_PROOF, epoch))
    ap_domain = get_domain(spec, state, DOMAIN_AGGREGATE_AND_PROOF, epoch)
    signed_aggs = []
    for committee, _root, agg in atts:
        for v in committee:
            proof = native_sign(h.keys[v].k, sel_root)
            if _is_aggregator(len(committee), proof):
                break
        else:
            raise AssertionError(f"chain: a committee of slot {slot} has no aggregator")
        msg = t.AggregateAndProof(aggregator_index=v, aggregate=agg, selection_proof=proof)
        sig = native_sign(h.keys[v].k, compute_signing_root(t.AggregateAndProof, msg,
                                                            ap_domain))
        signed_aggs.append(t.SignedAggregateAndProof.encode(
            t.SignedAggregateAndProof(message=msg, signature=sig)))
    return {"unaggregated": unagg, "tampered": bad, "aggregates": signed_aggs,
            "sync": [(v, h.keys[v].k) for v in members], "sync_root": sync_root,
            "block_root": block_root}, [agg for _c, _r, agg in atts]


def equivocation(h, sb, committee, data, first: int) -> dict:
    """The two offences of ``EQUIVOCATION_SLOT`` on the harness's head
    state (its block ``sb`` imported), signed by the C library: a second
    aggregator of the slot's first committee (``committee``, whose
    aggregate has ``data`` and the aggregator ``first``) aggregates the
    votes of its first ``EQUIVOCATORS`` members for the parent block with
    the same source and target (a double vote each), and the slot's
    proposer signs a copy of ``sb`` with ``EQUIVOCATION_GRAFFITI`` (a double
    proposal; gossip rejects it, so its state root stays the real
    block's)."""
    from lighthouse_tpu_torch import ssz
    from lighthouse_tpu_torch.beacon_chain.attestation_verification import _is_aggregator
    from lighthouse_tpu_torch.crypto.native import native_sign
    from lighthouse_tpu_torch.types import (
        DOMAIN_AGGREGATE_AND_PROOF, DOMAIN_BEACON_ATTESTER, DOMAIN_SELECTION_PROOF,
        compute_signing_root, get_domain)

    t, spec, state = h.t, h.spec, h.state
    slot = int(sb.message.slot)
    epoch = slot // h.preset.SLOTS_PER_EPOCH
    conflict = t.AttestationData(slot=slot, index=data.index,
                                 beacon_block_root=bytes(sb.message.parent_root),
                                 source=data.source, target=data.target)
    voters = committee[:EQUIVOCATORS]
    root = compute_signing_root(t.AttestationData, conflict,
                                get_domain(spec, state, DOMAIN_BEACON_ATTESTER, epoch))
    att = t.Attestation(aggregation_bits=[i < EQUIVOCATORS for i in range(len(committee))],
                        data=conflict, signature=h.sign_root([h.keys[v] for v in voters], root))
    sel_root = compute_signing_root(
        ssz.Uint64, slot, get_domain(spec, state, DOMAIN_SELECTION_PROOF, epoch))
    for v in committee[committee.index(first) + 1:]:
        proof = native_sign(h.keys[v].k, sel_root)
        if _is_aggregator(len(committee), proof):
            break
    else:
        raise AssertionError(f"chain: slot {slot}'s first committee has one aggregator only")
    msg = t.AggregateAndProof(aggregator_index=v, aggregate=att, selection_proof=proof)
    sig = native_sign(h.keys[v].k, compute_signing_root(
        t.AggregateAndProof, msg, get_domain(spec, state, DOMAIN_AGGREGATE_AND_PROOF, epoch)))
    block = copy.deepcopy(sb.message)
    block.body.graffiti = EQUIVOCATION_GRAFFITI
    second = h.sign_block(block, int(block.proposer_index))
    return {"aggregate": t.SignedAggregateAndProof.encode(
                t.SignedAggregateAndProof(message=msg, signature=sig)),
            "block": type(second).encode(second), "double_voters": sorted(voters),
            "proposer": int(block.proposer_index)}


def chain_producer(outq, n: int, slots: int) -> None:
    """The producer process: the harness's genesis, then each slot's block
    (the previous slot's aggregates, a full sync aggregate) and the plan of
    its gossip, on ``outq``; None at the end. The plan of
    ``EQUIVOCATION_SLOT`` carries its offences (:func:`equivocation`), the
    plan of the next of ``CHAIN_PRODUCE_SLOTS`` the evidence then due in the
    pools."""
    from lighthouse_tpu_torch.ssz import hash_tree_root
    from lighthouse_tpu_torch.state_transition.helpers import CommitteeCache

    t0 = time.perf_counter()
    h = chain_harness(n)
    outq.put(("genesis", type(h.state).encode(h.state), time.perf_counter() - t0))
    index_of = {bytes(v.pubkey): i for i, v in enumerate(h.state.validators)}
    committees, prev, due = {}, [], None
    for slot in range(1, slots + 1):
        t0 = time.perf_counter()
        sb = h.produce_block(slot, attestations=prev, full_sync=True)
        h.process_block(sb, strategy="none")
        epoch = slot // h.preset.SLOTS_PER_EPOCH
        if epoch not in committees:
            committees[epoch] = CommitteeCache(h.preset, h.state, epoch)
        plan, prev = slot_plan(h, slot, hash_tree_root(sb.message), committees[epoch],
                               index_of)
        if slot == EQUIVOCATION_SLOT:
            first = h.t.SignedAggregateAndProof.decode(plan["aggregates"][0])
            plan["equivocation"] = due = equivocation(
                h, sb, [int(v) for v in committees[epoch].committee(slot, 0)], prev[0].data,
                int(first.message.aggregator_index))
        elif due is not None and slot in CHAIN_PRODUCE_SLOTS:
            plan["slashings_due"] = {k: due[k] for k in ("double_voters", "proposer")}
            due = None
        outq.put(("slot", slot, type(sb).encode(sb), plan, time.perf_counter() - t0))
    outq.put(None)


def chain_signer(inq, outqs, genesis_qs) -> None:
    """The signer process: signs each slot's planned gossip with the C
    library on eight threads (it releases the GIL) and sends every slot's
    block and gossip, as SSZ bytes, to each of ``outqs``; the genesis alone
    goes to ``genesis_qs`` too (the segment node, which gets its blocks by
    range sync)."""
    from concurrent.futures import ThreadPoolExecutor

    from lighthouse_tpu_torch.crypto.native import native_sign

    _preset, _spec, t = chain_spec_and_types()
    genesis = inq.get()
    for q in [*outqs, *genesis_qs]:
        q.put(genesis)
    with ThreadPoolExecutor(8) as pool:
        while (msg := inq.get()) is not None:
            _, slot, block, plan, produce_s = msg
            t0 = time.perf_counter()
            jobs = [(sk, root) for _d, _p, _n, sk, root in plan["unaggregated"]]
            jobs += [(sk, plan["sync_root"]) for _v, sk in plan["sync"]]
            sigs = list(pool.map(lambda j: native_sign(*j), jobs))
            unagg = [t.Attestation.encode(t.Attestation(
                aggregation_bits=[i == pos for i in range(size)],
                data=t.AttestationData.decode(data), signature=sig))
                for (data, pos, size, _sk, _r), sig in zip(plan["unaggregated"], sigs)]
            sync = [t.SyncCommitteeMessage.encode(t.SyncCommitteeMessage(
                slot=slot, beacon_block_root=plan["block_root"], validator_index=v,
                signature=sig)) for (v, _sk), sig in zip(plan["sync"], sigs[len(unagg):])]
            gossip = {"unaggregated": unagg, "aggregates": plan["aggregates"],
                      "sync": sync, "tampered": plan["tampered"],
                      "equivocation": plan.get("equivocation"),
                      "slashings_due": plan.get("slashings_due")}
            out = ("slot", slot, block, gossip, (produce_s, time.perf_counter() - t0))
            for q in outqs:
                q.put(out)
    for q in outqs:
        q.put(None)


def _kinds(results) -> list:
    return [getattr(r, "kind", "ok") if isinstance(r, Exception) else "ok"
            for r in results]


def api_get(client, path: str):
    """GET ``path`` from the node's HTTP API; the decoded JSON body."""
    import urllib.request

    url = f"http://127.0.0.1:{client.api.port}{path}"
    with urllib.request.urlopen(url, timeout=CHAIN_TIMEOUT_S) as r:
        return json.loads(r.read())


def process_work(client, kind, items) -> list:
    """Submit ``items`` to the node's beacon processor as work of ``kind``
    (a ``WorkKind`` name) and wait for them: gossip sync messages (verified
    in batches, each verified one put in the operation pool), aggregates
    (verified in batches, applied to fork choice, put in the pool and
    handed to the slasher) or blocks (the slasher sees the header, then
    gossip verification and the import). The results, in order: a value,
    or the handler's exception."""
    import threading

    from lighthouse_tpu_torch.beacon_processor import Work, WorkKind

    out = [None] * len(items)
    left = [len(items)]
    lock, done = threading.Lock(), threading.Event()

    def finish(i):
        def cb(result):
            out[i] = result
            with lock:
                left[0] -= 1
                if not left[0]:
                    done.set()
        return cb

    for i, m in enumerate(items):
        if not client.processor.submit(Work(WorkKind[kind], m, done=finish(i))):
            raise AssertionError(f"chain: the beacon processor shed a {kind} item")
    if items and not done.wait(CHAIN_TIMEOUT_S):
        raise AssertionError(f"chain: the beacon processor did not finish a slot's {kind} "
                             "work")
    return out


def _popcount(hex_bits: str) -> int:
    return sum(bin(b).count("1") for b in bytes.fromhex(hex_bits[2:]))


def chain_slot(client, clock, t, msg, walls=None) -> dict:
    """One slot on a node built by ``chain_node``. For a slot of
    ``CHAIN_PRODUCE_SLOTS`` a block is first produced over HTTP on the
    previous slot's head, with the RANDAO reveal of the producer's block
    (the C signer's); where the slasher's evidence is due, only once the
    slot timer has drained it into the pool. Then the slot's block is
    imported through ``process_block`` (at ``EQUIVOCATION_SLOT`` handed to
    the beacon processor as a gossip block, then the proposer's second
    block, which gossip must reject), its unaggregated attestations
    verified in batches of ``CHAIN_GOSSIP_BATCH``, and its aggregates (then
    the conflicting one) and sync messages submitted to the node's beacon
    processor, which puts them in the operation pool (and the aggregates
    in fork choice and the slasher). For a slot of ``CHAIN_CONTRIB_SLOTS``
    each subcommittee's sync contribution is then asked for over HTTP; where
    evidence was due, the produced block is imported as a sibling
    (:func:`sibling_import`). Returns the roots, every verdict (``ok`` or the
    error kind), the produced block, the contributions and the slasher's
    evidence and sibling."""
    from lighthouse_tpu_torch.ssz import hash_tree_root

    chain = client.chain
    _, slot, block, gossip, _ = msg
    clock.set_slot(slot)
    sb = t.signed_block["altair"].decode(block)
    eq, due = gossip.get("equivocation"), gossip.get("slashings_due")
    w = {}
    produced = evidence = sibling = None
    if due is not None:
        p0 = time.perf_counter()
        evidence = drained_evidence(client, due)
        w["drain_wait"] = time.perf_counter() - p0
    if slot in CHAIN_PRODUCE_SLOTS:
        p0 = time.perf_counter()
        randao = bytes(sb.message.body.randao_reveal).hex()
        produced = api_get(client, f"/eth/v2/validator/blocks/{slot}?randao_reveal=0x{randao}")
        w["produce"] = time.perf_counter() - p0
    w0 = time.perf_counter()
    if eq is None:
        root = chain.process_block(sb)
        equivocation = None
    else:  # the real block, then the second one, through gossip
        (root,) = process_work(client, "GOSSIP_BLOCK", [sb])
        if not isinstance(root, bytes):
            raise AssertionError(f"chain: slot {slot}'s block was not imported from gossip: "
                                 f"{root!r}")
        (second,) = _kinds(process_work(client, "GOSSIP_BLOCK", [
            t.signed_block["altair"].decode(eq["block"])]))
        equivocation = {"block": second}
    w1 = time.perf_counter()
    atts = [t.Attestation.decode(b) for b in gossip["unaggregated"]]
    unagg = []
    for i in range(0, len(atts), CHAIN_GOSSIP_BATCH):
        unagg += _kinds(chain.batch_verify_unaggregated_attestations_for_gossip(
            atts[i:i + CHAIN_GOSSIP_BATCH]))
    w2 = time.perf_counter()
    table = chain.device_key_table
    hits0 = table.status()["aggregate_hits"] if table is not None else 0
    miss0 = _metric("bls_device_key_table_agg_events_total", "miss")
    aggs = _kinds(process_work(client, "GOSSIP_AGGREGATE", [
        t.SignedAggregateAndProof.decode(b) for b in gossip["aggregates"]]))
    if table is not None:
        w["agg_hits"] = table.status()["aggregate_hits"] - hits0
        w["agg_misses"] = _metric("bls_device_key_table_agg_events_total", "miss") - miss0
    if eq is not None:
        (equivocation["aggregate"],) = _kinds(process_work(client, "GOSSIP_AGGREGATE", [
            t.SignedAggregateAndProof.decode(eq["aggregate"])]))
    w3 = time.perf_counter()
    sync = _kinds(process_work(client, "GOSSIP_SYNC_MESSAGE",
                               [t.SyncCommitteeMessage.decode(b) for b in gossip["sync"]]))
    w4 = time.perf_counter()
    contributions = None
    if slot in CHAIN_CONTRIB_SLOTS:
        contributions = []
        for i in range(chain.preset.SYNC_COMMITTEE_SUBNET_COUNT):
            body = api_get(client, f"/eth/v1/validator/sync_committee_contribution?slot={slot}"
                                   f"&subcommittee_index={i}&beacon_block_root=0x{root.hex()}")
            contributions.append(body["data"])
        w["contributions"] = time.perf_counter() - w4
    head, state_root = chain.head_block_root.hex(), hash_tree_root(chain.head_state).hex()
    if due is not None and produced is not None:
        sibling = sibling_import(client, clock, t, produced, w)
    if walls is not None:
        walls.append({"import": w1 - w0, "unaggregated": w2 - w1, "aggregate": w3 - w2,
                      "sync": w4 - w3, **w})
    return {"slot": slot, "root": root.hex(), "head": head, "state_root": state_root,
            "unaggregated": unagg, "aggregate": aggs, "sync": sync,
            "tampered": gossip["tampered"], "produced": produced,
            "contributions": contributions, "equivocation": equivocation,
            "evidence": evidence, "sibling": sibling}


def drained_evidence(client, due) -> dict:
    """Waits until the node's slot timer has drained its slasher's
    evidence of ``due`` into the operation pool (one attester slashing for
    each double voter, one proposer slashing), then reads the pool over
    HTTP: each slashing as SSZ hex and the indices it slashes."""
    from lighthouse_tpu_torch.ssz.json import from_json

    chain, t = client.chain, client.chain.types
    want = (len(due["double_voters"]), 1)

    def drained():
        c = chain.op_pool.contents()
        return (len(c["attester_slashings"]), len(c["proposer_slashings"])) == want

    _wait_for(drained, CHAIN_TIMEOUT_S, "the slot timer's drain of the slasher's evidence",
              label="chain")
    out = {}
    for kind, tpe in (("attester_slashings", t.AttesterSlashing),
                      ("proposer_slashings", t.ProposerSlashing)):
        got = [from_json(tpe, j) for j in api_get(client, f"/eth/v1/beacon/pool/{kind}")["data"]]
        out[kind] = [tpe.encode(s).hex() for s in got]
        out[f"{kind}_indices"] = [
            sorted(set(map(int, s.attestation_1.attesting_indices))
                   & set(map(int, s.attestation_2.attesting_indices)))
            if kind == "attester_slashings" else [int(s.signed_header_1.message.proposer_index)]
            for s in got]
    return out


class timed_verify_now:
    """Inside the block, every ``verify_now`` of ``chain``'s scheduler (the
    block path's) appends its wall to ``self.walls``."""

    def __init__(self, chain):
        self.sched, self.walls = chain.verification_scheduler, []

    def __enter__(self):
        if self.sched is not None:
            inner = self.inner = self.sched.verify_now

            def timed(sets, kind="block"):
                v0 = time.perf_counter()
                try:
                    return inner(sets, kind)
                finally:
                    self.walls.append(time.perf_counter() - v0)

            self.sched.verify_now = timed
        return self

    def __exit__(self, *exc):
        if self.sched is not None:
            self.sched.verify_now = self.inner


def sibling_import(client, clock, t, produced, walls) -> dict:
    """The block produced over HTTP at this slot, which carries the
    slasher's evidence, signed here with its proposer's interop key by the
    C library (as the harness signs) and imported through
    ``process_block`` as a sibling of the harness's block of the slot, on
    the next slot's clock after fork choice's tick (a late block: no
    proposer boost, and the slot's aggregates' votes keep the harness's
    block the head). First a copy whose attester slashing's second
    attestation is re-signed by a validator outside it (the block signed
    again) must be rejected, then the block must import. Returns its root,
    its post-state root, the validators it slashed and the copy's error
    kind; its wall, the verify's share, the batch's rung and K1-K3 launches
    and lanes go into ``walls["sibling"]``."""
    from lighthouse_tpu_torch.crypto import backend
    from lighthouse_tpu_torch.crypto.device import kernels
    from lighthouse_tpu_torch.crypto.native import native_sign
    from lighthouse_tpu_torch.ssz import hash_tree_root
    from lighthouse_tpu_torch.ssz.json import from_json
    from lighthouse_tpu_torch.state_transition.genesis import interop_secret_key
    from lighthouse_tpu_torch.types import (
        DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, compute_signing_root, get_domain)

    chain = client.chain
    spe = chain.preset.SLOTS_PER_EPOCH
    block = from_json(t.block["altair"], produced["data"])
    slot = int(block.slot)
    clock.set_slot(slot + 1)
    chain.on_tick(slot + 1)
    state = chain.head_state

    def signed(b):
        root = compute_signing_root(type(b), b, get_domain(
            chain.spec, state, DOMAIN_BEACON_PROPOSER, slot // spe))
        return t.signed_block["altair"](message=b, signature=native_sign(
            interop_secret_key(int(b.proposer_index)).k, root))

    bad = copy.deepcopy(block)
    a2 = bad.body.attester_slashings[0].attestation_2
    inside = set(map(int, a2.attesting_indices))
    other = next(i for i in range(len(state.validators)) if i not in inside)
    a2.signature = native_sign(interop_secret_key(other).k, compute_signing_root(
        t.AttestationData, a2.data,
        get_domain(chain.spec, state, DOMAIN_BEACON_ATTESTER, int(a2.data.target.epoch))))
    with timed_verify_now(chain) as tv_bad:
        try:
            chain.process_block(signed(bad))
            rejected = "imported"
        except Exception as e:
            rejected = getattr(e, "kind", type(e).__name__)
    pre = {i for i, v in enumerate(state.validators) if v.slashed}
    before = kernels.snapshot()
    with timed_verify_now(chain) as tv:
        w0 = time.perf_counter()
        root = chain.process_block(signed(block))
        wall = time.perf_counter() - w0
    after = kernels.snapshot()
    post = chain.state_at_block_root(root)
    last = getattr(backend.active(), "last_batch", None) or {}
    walls["sibling"] = {
        "wall_s": wall, "verify_s": sum(tv.walls), "verifies": len(tv.walls),
        "rejected_verify_s": sum(tv_bad.walls),
        "rung": list(last["rung"]) if "rung" in last else None, "warm": last.get("warm"),
        "path": last.get("path"),
        "launches": {k: after[k][0] - before[k][0] for k in after},
        "lane_hist": {k: dict(after[k][2] - before[k][2]) for k in after}}
    return {"root": root.hex(), "state_root": hash_tree_root(post).hex(),
            "slashed": sorted({i for i, v in enumerate(post.validators) if v.slashed} - pre),
            "head": chain.head_block_root.hex(), "rejected": rejected}


def count_slasher_flushes(chain) -> dict:
    """Counts what ``chain``'s slasher writes to its store under
    ``Column.SLASHER`` (its ``put_batch`` calls, rows and bytes), from now
    on, into the returned dict."""
    from lighthouse_tpu_torch.store.kv import Column

    kv = chain.slasher._store
    put_batch, out = kv.put_batch, {"flushes": 0, "rows_flushed": 0, "bytes_flushed": 0}

    def counted(items):
        items = list(items)
        mine = [len(v) for c, _k, v in items if c == Column.SLASHER]
        if mine:
            out["flushes"] += 1
            out["rows_flushed"] += len(mine)
            out["bytes_flushed"] += sum(mine)
        return put_batch(items)

    kv.put_batch = counted
    return out


def rss() -> dict:
    """This process's resident memory (``VmRSS`` of ``/proc/self/status``),
    in KiB."""
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key == "VmRSS":
                return {"rss_kib": int(value.split()[0])}
    return {"rss_kib": None}


def slasher_reading(chain, flushed) -> dict:
    """The node's slasher after the chain: its batches
    (``slasher_batch_seconds`` count and sum), the slashings it found, the
    validators it tracks and their span bytes, the rows and bytes it holds
    and has flushed under ``Column.SLASHER``, and this process's resident
    memory."""
    from lighthouse_tpu_torch.store.kv import Column
    from lighthouse_tpu_torch.utils import metrics

    sl = chain.slasher
    sl.process_queued()  # the last slot's queue, should the timer not have ticked since
    batches = metrics.get("slasher_batch_seconds")
    held = [len(v) for _k, v in sl._store.iter_column(Column.SLASHER)]
    spans = [*sl._min_span.values(), *sl._max_span.values()]
    return {"batches": batches.total, "batch_s": batches.sum,
            "found": _counter("slasher_slashings_found_total"),
            "validators": len(sl._min_span), "span_bytes": sum(a.nbytes for a in spans),
            "rows_held": len(held), "bytes_held": sum(held), **flushed, **rss()}


def slasher_checks(chain, mine, walls, flushed, oracle_reading) -> dict:
    """Phase 12d's slasher, read after the chain (``mine`` already equals
    the oracle's records): the equivocating block rejected by gossip as a
    repeat proposal and the conflicting aggregate accepted; the pool's
    evidence, drained by the slot timer, one attester slashing for each
    double voter and one proposer slashing; the block produced at the next
    of ``CHAIN_PRODUCE_SLOTS`` carrying one of each, byte-equal to the
    pool's; its sibling import on the card (K1-K3 launched, the offenders
    slashed, not the head) after a copy with a re-signed attestation was
    rejected; both slashers' readings. Returns the phase's slasher record
    and the sibling import's launches by lane count."""
    from lighthouse_tpu_torch.ssz.json import from_json

    t = chain.types
    eq = [r for r in mine if r["equivocation"] is not None]
    due = [r for r in mine if r["evidence"] is not None]
    if len(eq) != 1 or len(due) != 1:
        raise AssertionError(f"chain: {len(eq)} slots with the offences, {len(due)} with "
                             "the evidence due (want one each)")
    eq, r = eq[0], due[0]
    if eq["equivocation"] != {"block": "RepeatProposal", "aggregate": "ok"}:
        raise AssertionError(f"chain: slot {eq['slot']}'s offences: {eq['equivocation']} "
                             "(want the second block rejected as RepeatProposal, the "
                             "conflicting aggregate accepted)")
    ev = r["evidence"]
    voters = ev["attester_slashings_indices"][0]
    if (len(voters) != EQUIVOCATORS or ev["attester_slashings_indices"] != [voters] * len(voters)
            or len(ev["proposer_slashings"]) != 1):
        raise AssertionError(f"chain: the pool's evidence at slot {r['slot']}: {ev}")
    proposer = ev["proposer_slashings_indices"][0][0]
    body = from_json(t.block["altair"], r["produced"]["data"]).body
    carried = {"attester": [t.AttesterSlashing.encode(x).hex() for x in body.attester_slashings],
               "proposer": [t.ProposerSlashing.encode(x).hex() for x in body.proposer_slashings]}
    if (len(carried["attester"]) != 1 or carried["attester"][0] not in ev["attester_slashings"]
            or carried["proposer"] != ev["proposer_slashings"]):
        raise AssertionError(f"chain: the block produced at slot {r['slot']} carries "
                             f"{len(carried['attester'])} attester and "
                             f"{len(carried['proposer'])} proposer slashings, not the pool's")
    sib, w = r["sibling"], walls[mine.index(r)]["sibling"]
    if (sib["rejected"] != "InvalidSignature" or sib["slashed"] != sorted([*voters, proposer])
            or sib["head"] != r["root"]):
        raise AssertionError(f"chain: the sibling import at slot {r['slot']}: copy "
                             f"{sib['rejected']}, slashed {sib['slashed']}, head {sib['head']}")
    missing = [k for k in KERNELS if not w["launches"].get(k)]
    if missing:
        raise AssertionError(f"chain: the sibling import launched none of {missing}")
    mine_reading = slasher_reading(chain, flushed)
    for label, got in (("card node", mine_reading), ("oracle", oracle_reading)):
        if got["found"] != EQUIVOCATORS + 1:
            raise AssertionError(f"chain: the {label}'s slasher found {got['found']} slashings "
                                 f"(want {EQUIVOCATORS + 1})")
    log(f"chain slasher: slot {eq['slot']}'s second block rejected by gossip on both nodes "
        f"({eq['equivocation']['block']}); its conflicting aggregate accepted; at slot "
        f"{r['slot']} the pool holds {len(ev['attester_slashings'])} attester slashings "
        f"(double voters {voters}) and the proposer slashing of validator {proposer}, "
        f"byte-equal on both nodes, drained by the slot timer (the produce waited "
        f"{walls[mine.index(r)]['drain_wait']:.2f} s for it)")
    log(f"chain slasher: the block produced at slot {r['slot']} carries one attester and one "
        f"proposer slashing (the pool's bytes); its sibling import on the card: "
        f"{w['wall_s']:.3f} s, verify {w['verify_s']:.3f} s in {w['verifies']} verify_now "
        f"(share {w['verify_s'] / w['wall_s']:.3f}), rung {w['rung']} warm {w['warm']} path "
        f"{w['path']}, K1-K3 launches {json.dumps(w['launches'])}; post-state "
        f"{sib['state_root'][:12]} equal to cpu-native's; slashed {sib['slashed']}; the "
        f"copy with a re-signed attestation rejected on both nodes ({sib['rejected']})")
    for label, got in (("card node", mine_reading), ("oracle", oracle_reading)):
        log(f"chain slasher ({label}): slasher_batch_seconds count {got['batches']} sum "
            f"{got['batch_s']:.3f} s; {got['found']:.0f} slashings found; "
            f"{got['validators']} validators tracked, {got['span_bytes']} span bytes; "
            f"Column.SLASHER {got['rows_held']} rows, {got['bytes_held']} bytes held, "
            f"{got['bytes_flushed']} bytes in {got['rows_flushed']} rows flushed over "
            f"{got['flushes']} batches; process resident {got['rss_kib']} KiB")
    return {"equivocation_slot": eq["slot"], "evidence_slot": r["slot"], "double_voters": voters,
            "proposer": proposer, "sibling": {k: v for k, v in w.items() if k != "lane_hist"},
            "slashed": sib["slashed"], "drain_wait_s": walls[mine.index(r)]["drain_wait"],
            "card_node": mine_reading, "oracle": oracle_reading}, w["lane_hist"]


def _metric(name: str, *labels) -> float:
    """The value of family ``name``'s child at ``labels`` (0 when absent)."""
    from lighthouse_tpu_torch.utils import metrics

    fam = metrics.get(name)
    child = None if fam is None else fam.children().get(tuple(labels))
    return 0.0 if child is None else child.value


def check_sync_aggregate(client, produced) -> None:
    """The produced block's sync aggregate verifies on this process's
    backend (the oracle's ``cpu-native``): the participants' keys of the
    current sync committee over the parent root, signed at its slot."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.types import (DOMAIN_SYNC_COMMITTEE, compute_signing_root,
                                            get_domain)

    chain = client.chain
    state, blk = chain.head_state, produced["data"]
    agg = blk["body"]["sync_aggregate"]
    bits = bytes.fromhex(agg["sync_committee_bits"][2:])
    pks = [bls.PublicKey.deserialize(bytes(pk))
           for i, pk in enumerate(state.current_sync_committee.pubkeys)
           if bits[i // 8] >> (i % 8) & 1]
    prev = int(blk["slot"]) - 1
    root = compute_signing_root(None, bytes.fromhex(blk["parent_root"][2:]),
                                get_domain(chain.spec, state, DOMAIN_SYNC_COMMITTEE,
                                           prev // chain.preset.SLOTS_PER_EPOCH))
    sig = bls.AggregateSignature.deserialize(bytes.fromhex(agg["sync_committee_signature"][2:]))
    if not sig.fast_aggregate_verify(root, pks):
        raise AssertionError(f"chain oracle: the sync aggregate produced at slot {blk['slot']} "
                             "does not verify")


def chain_oracle(inq, outq, n: int, port_q, late_port_q, done_q) -> None:
    """The oracle process: the same node on ``cpu-native`` (so its
    operation pool has no device aggregator: every aggregate is the host
    fold) with the backend called directly, no scheduler, fed the
    producer's bytes; one result per slot on ``outq``, then None. Every
    block it produces must carry a sync aggregate that verifies here. It
    listens on the port's network (``listen_port=0``) and puts its port on
    ``port_q`` (for the segment node) and, once its head reaches
    ``RangeSync.BATCH``, on ``late_port_q`` (for the late joiner): both
    range-sync from it, and the oracle serves until both say on ``done_q``
    that they are done, after its results, its network view, its slasher's
    reading and None have gone to ``outq``. Its slasher and beacon
    processor are the card node's (``slasher=True``, one worker)."""
    import queue

    from lighthouse_tpu_torch.network.service import RangeSync

    client, clock, t = chain_node(inq.get()[1], n, bls_backend="cpu-native",
                                  verification_scheduler=False, listen_port=0,
                                  slasher=True, n_workers=1)
    flushed = count_slasher_flushes(client.chain)
    port_q.put(client.network.port)
    if client.chain.op_pool._device_agg is not None:
        raise AssertionError("chain oracle: the pool has a device aggregator")
    late = None
    while (msg := inq.get()) is not None:
        r = chain_slot(client, clock, t, msg)
        if r["produced"] is not None:
            check_sync_aggregate(client, r["produced"])
        outq.put(r)
        if late is None and r["slot"] >= RangeSync.BATCH:
            late_port_q.put(late := client.network.port)
    if late is None:  # a chain shorter than one batch
        late_port_q.put(client.network.port)
    outq.put(("network", _net_view(client.network)))
    outq.put(("slasher", slasher_reading(client.chain, flushed)))
    outq.put(None)
    try:  # serve both syncing nodes until they are done
        for _ in range(2):
            done_q.get(timeout=2 * CHAIN_TIMEOUT_S)
    except queue.Empty:
        pass
    client.stop()


def chain_segment(inq, outq, n: int, slots: int, device_index: int, port_q,
                  done_q, late: bool = False) -> None:
    """The segment chain's process, on the card: a node with its own
    compile service (warming ``CHAIN_SEGMENT_RUNGS``), key table,
    scheduler and network (``listen_port=0``), no HTTP and no lookahead.
    It dials the oracle (its port from ``port_q``) and gets the blocks by
    range sync over the port's Noise + snappy transport: each time the
    oracle's status shows its head at the next of ``sync_marks``, the
    status goes to the node's ``RangeSync``, which pulls
    ``blocks_by_range`` (``RangeSync.BATCH`` at most) and hands them to the
    beacon processor as ``CHAIN_SEGMENT`` work: ``process_chain_segment``
    through the scheduler's bulk class and the card. Puts one result on
    ``outq``: the roots, the segment and sync walls, the bytes it read from
    the wire, the sync counters, K1-K3 launches and lanes.

    With ``late`` it is the late joiner: warming ``CATCH_UP_RUNGS``, it
    gets the oracle's port only once the oracle's head has reached
    ``RangeSync.BATCH`` and then syncs from genesis, so its first batch
    is a whole ``RangeSync.BATCH`` of blocks, as a node that joins a
    running network pulls; then the rest up to ``slots``."""
    import threading

    from lighthouse_tpu_torch.crypto.device import kernels
    from lighthouse_tpu_torch.network.service import PROTO_STATUS, RangeSync
    from lighthouse_tpu_torch.ssz import hash_tree_root

    if device_index >= 0:
        dev = torch.device("cuda", device_index)
        torch.cuda.set_device(dev)
        kernels.build()
        node = {"bls_backend": "cuda", "device": str(dev)}
    else:  # a CPU rehearsal: the C verifier, no device wiring
        node = {"bls_backend": "cpu-native"}
    label = "chain catch-up" if late else "chain segment"
    client, clock, t = chain_node(inq.get()[1], n, http_enabled=False, duty_lookahead=False,
                                  compile_rungs=CATCH_UP_RUNGS if late else CHAIN_SEGMENT_RUNGS,
                                  listen_port=0, **node)
    chain, net = client.chain, client.network
    svc, table = chain.compile_service, chain.device_key_table
    if svc is not None and not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError(f"{label}: the compile service did not warm its rungs")
    roots, walls, lock = [], [], threading.Lock()
    segment = chain.process_chain_segment

    def timed_segment(blocks):  # the beacon processor's CHAIN_SEGMENT handler calls this
        s0 = time.perf_counter()
        got = segment(blocks)
        with lock:
            walls.append((len(blocks), time.perf_counter() - s0))
            roots.extend(r.hex() for r in got)
        return got

    chain.process_chain_segment = timed_segment
    clock.set_slot(slots)  # a syncing node: the whole range lies in its past
    try:
        port = port_q.get(timeout=2 * CHAIN_TIMEOUT_S if late else CHAIN_TIMEOUT_S)
        kernels.reset_launches()
        b0, n0 = _counter("sync_range_batches_total"), _counter("sync_range_blocks_total")
        peer = net.connect("127.0.0.1", port)
        if peer is None:
            raise AssertionError(f"{label}: could not dial the oracle on port {port}")
        wire = [0]
        read_exact = peer._read_exact

        def counted(k):  # every byte the node reads from the oracle
            got = read_exact(k)
            wire[0] += len(got or b"")
            return got

        peer._read_exact = counted
        marks = (sorted({min(RangeSync.BATCH, slots), slots}) if late
                 else sync_marks(slots))
        t_sync = waited = None
        for mark in marks:
            w0 = time.perf_counter()
            while True:  # the oracle's status, polled until its head reaches the mark
                raw = peer.request(PROTO_STATUS.encode(), json.dumps(net.local_status()).encode(),
                                   timeout=CHAIN_TIMEOUT_S)
                if not raw:
                    raise AssertionError(f"{label}: the oracle did not answer a status "
                                         f"request ({peer.closed and 'closed' or 'refused'}): "
                                         f"{json.dumps(_net_view(net), default=str)}")
                status = json.loads(raw)
                if int(status["head_slot"]) >= mark:
                    break
                if time.perf_counter() - w0 > CHAIN_TIMEOUT_S:
                    raise AssertionError(f"{label}: the oracle's head never reached {mark}")
                time.sleep(STATUS_POLL_S)
            if t_sync is None:
                t_sync, waited = time.perf_counter(), 0.0
            else:
                waited += time.perf_counter() - w0
            net.sync.on_status(peer, status)
            _wait_for(lambda: chain.head_state.slot >= mark, CHAIN_TIMEOUT_S,
                      f"the range sync to slot {mark}", label=label)
        sync_s = time.perf_counter() - t_sync
    finally:
        done_q.put(True)  # the oracle may stop serving now
    routes = svc.status()["cold_routes"] if svc is not None else {}
    sets = table.status()["sets"] if table is not None else {}
    view = _net_view(net)
    client.stop()
    outq.put({"roots": roots, "head": chain.head_block_root.hex(),
              "state_root": hash_tree_root(chain.head_state).hex(),
              "walls": [w for _n, w in walls], "blocks_per_segment": [k for k, _w in walls],
              "sync_s": sync_s, "waited_s": waited, "wire_bytes": wire[0],
              "sync_batches": _counter("sync_range_batches_total") - b0,
              "sync_blocks": _counter("sync_range_blocks_total") - n0,
              "range_batch": RangeSync.BATCH, "marks": marks, "network": view,
              "launches": dict(kernels.launches),
              "lane_hist": {k: dict(h) for k, h in kernels.lane_hist.items()},
              "key_table": sets, "routes": routes})


def _net_view(net) -> dict:
    """A node's view of its network: its peers (closed or not), the
    requests its rate limiter refused and the penalties and bans it
    journaled."""
    from lighthouse_tpu_torch.utils import flight_recorder

    return {"peers": [[p.node_id[:12], p.closed, p.remote_listen_port]
                      for p in net.transport.peers_snapshot()],
            "rate_limited": _counter("network_rate_limited_total"),
            "penalties": [e["fields"] for e in
                          flight_recorder.events(["peer_penalty", "peer_ban"])][-8:]}


def sync_marks(slots: int) -> list:
    """The oracle heads at which the segment node re-statuses it: every
    ``CHAIN_SEGMENT_BLOCKS`` slots and the last slot."""
    return sorted({*range(CHAIN_SEGMENT_BLOCKS, slots + 1, CHAIN_SEGMENT_BLOCKS), slots})


def _counter(name: str) -> float:
    """An unlabeled family's value (0 when absent)."""
    from lighthouse_tpu_torch.utils import metrics

    fam = metrics.get(name)
    return 0.0 if fam is None else fam.value


def extra_validator(state) -> int:
    """Append one validator with the next interop key to ``state`` (a copy
    of the head state) and return its index."""
    from lighthouse_tpu_torch.state_transition.genesis import interop_secret_key
    from lighthouse_tpu_torch.testing.harness import native_pubkey

    i = len(state.validators)
    v = copy.deepcopy(state.validators[0])
    v.pubkey = native_pubkey(interop_secret_key(i))
    state.validators.append(v)
    state.balances.append(state.balances[0])
    return i


def run_helper(fn, *args) -> None:
    """A helper process's body: ``fn(*args)``, then its queues flushed and
    the process left with ``os._exit(0)``, without the interpreter's
    teardown (a node's daemon threads may still be inside torch when its
    static destructors run, which once aborted a helper after it had
    sent its results). An exception in ``fn`` still exits non-zero."""
    import os

    fn(*args)
    for a in args:
        for q in a if isinstance(a, list) else [a]:
            if hasattr(q, "join_thread"):
                q.close()
                q.join_thread()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def chain_phase(dev, slots: int = None, n: int = None, prewarm=None) -> dict:
    """The port's beacon node on the card (see the module docstring):
    starts the producer, signer, segment, late joiner and oracle
    processes, runs the block chain's node here, and stops the producer,
    signer and segment processes. The late joiner and the oracle serving
    it run on: ``out["catch_up"]`` is the handle that :func:`catch_up_result`
    reads and stops them with (a failure here stops them too).
    ``prewarm``, a started compile service, captures ``CHAIN_RUNGS`` while
    the producer builds the genesis state, so the node's own service then
    finds their graphs."""
    import multiprocessing as mp

    from lighthouse_tpu_torch.utils import slot_clock

    slots = slots or CHAIN_SLOTS
    n = n or CHAIN_VALIDATORS
    t_phase = time.perf_counter()
    ctx = mp.get_context("spawn")
    (planq, to_main, to_oracle, to_segment, to_late, from_oracle, from_segment, from_late,
     port_q, late_port_q, done_q) = (ctx.Queue() for _ in range(11))
    seg_dev = dev.index if dev.type == "cuda" else -1
    procs = [ctx.Process(target=run_helper, name=name, args=(fn, *args), daemon=True)
             for name, fn, args in (
                 ("chain_producer", chain_producer, (planq, n, slots)),
                 ("chain_signer", chain_signer, (planq, [to_main, to_oracle],
                                                 [to_segment, to_late])),
                 ("chain_segment", chain_segment, (to_segment, from_segment, n, slots,
                                                   seg_dev, port_q, done_q)),
                 ("chain_oracle", chain_oracle, (to_oracle, from_oracle, n, port_q,
                                                 late_port_q, done_q)),
                 ("chain_catch_up", chain_segment, (to_late, from_late, n, slots, seg_dev,
                                                    late_port_q, done_q, True)))]
    for p in procs:
        p.start()
    prev_clock = slot_clock.get_clock()
    ok = False
    try:
        out = _chain_phase(dev, slots, n, to_main, from_oracle, from_segment, prewarm)
        ok = True
    finally:
        slot_clock.set_clock(prev_clock)
        for p in procs[:3] if ok else procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    bad = {p.name: p.exitcode for p in procs[:3] if p.exitcode}
    if bad:
        raise AssertionError(f"chain: a helper process failed (exit codes {bad})")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"chain phase wall {out['wall_s']:.1f} s; {card_line()}")
    out["catch_up"] = {"procs": procs[3:], "queue": from_late, "slots": slots,
                       "oracle": out.pop("oracle_chain")}
    return out


def stop_catch_up(handle) -> None:
    """Stop the late joiner and the oracle of ``handle``, wherever they
    are."""
    for p in handle["procs"]:
        if p.is_alive():
            p.kill()
        p.join()


def catch_up_result(handle) -> dict:
    """The late joiner's result (phase 12d's catch-up, which runs on
    while phase 12e does): waits for it, stops the late joiner and the
    oracle, and holds it to the oracle's chain. Its first range-sync batch
    must be ``RangeSync.BATCH`` blocks (one ``process_chain_segment`` call),
    every root equal to the oracle's, no flush shed to the host and K1-K3
    launched."""
    import queue

    from lighthouse_tpu_torch.network.service import RangeSync

    t0 = time.perf_counter()
    try:
        late = handle["queue"].get(timeout=2 * CHAIN_TIMEOUT_S)
    except queue.Empty:
        stop_catch_up(handle)
        raise AssertionError("chain catch-up: the late joiner sent no result")
    waited = time.perf_counter() - t0
    for p in handle["procs"]:
        p.join(timeout=30)
    stop_catch_up(handle)
    bad = {p.name: p.exitcode for p in handle["procs"] if p.exitcode}
    if bad:
        raise AssertionError(f"chain catch-up: a helper process failed (exit codes {bad})")
    slots, oracle = handle["slots"], handle["oracle"]
    first = min(RangeSync.BATCH, slots)
    if (late["roots"] != oracle["roots"] or late["head"] != oracle["head"]
            or late["state_root"] != oracle["state_root"]):
        raise AssertionError("chain catch-up: the late joiner's roots differ from cpu-native's")
    if (late["sync_blocks"] != slots or late["blocks_per_segment"][:1] != [first]
            or late["routes"].get("shed")):
        raise AssertionError(f"chain catch-up: range sync counted {late['sync_blocks']} blocks "
                             f"in segments of {late['blocks_per_segment']} (want {slots}, the "
                             f"first {first}); routes {late['routes']} (a shed flush ran on the "
                             "host)")
    missing = [k for k in KERNELS if not late["launches"].get(k)]
    if missing:
        raise AssertionError(f"chain catch-up: {missing} never launched by the late joiner")
    over = sum(w > RANGE_SYNC_WAIT_S for w in late["walls"])
    log(f"chain catch-up: a late joiner dialed the cpu-native node at its head "
        f"{late['marks'][0]} and range-synced {len(late['roots'])} blocks from genesis: "
        f"process_chain_segment calls of {late['blocks_per_segment']} blocks in "
        f"{[round(w, 2) for w in late['walls']]} s ({over} of them longer than RangeSync's "
        f"{RANGE_SYNC_WAIT_S:g} s wait for a batch's import), "
        f"sync_range_batches_total +{late['sync_batches']:.0f}, {late['wire_bytes']} bytes "
        f"read from the wire, sync wall {late['sync_s']:.1f} s; roots equal to cpu-native's; "
        f"key table paths {json.dumps(late['key_table'])}; routes {json.dumps(late['routes'])}; "
        f"K1-K3 launches {json.dumps(late['launches'])}; {waited:.1f} s waited for it here")
    out = {k: late[k] for k in ("walls", "blocks_per_segment", "launches", "key_table",
                                "routes", "sync_s", "wire_bytes", "sync_batches",
                                "sync_blocks", "marks", "network")}
    out["waited_s"] = waited
    out["lane_hist"] = late["lane_hist"]
    return out


def lookahead_check(chain) -> dict:
    """Called before the first slot of ``CHAIN_LOOKAHEAD_EPOCH``: the duty
    lookahead warmed that epoch past its halfway trigger in the epoch
    before (waiting for its worker if it is still summing), with every
    committee through the card and none on the host or failed."""
    la = chain.duty_lookahead
    epoch = CHAIN_LOOKAHEAD_EPOCH
    _wait_for(lambda: (la.status()["warmed_epoch"] or 0) >= epoch, CHAIN_TIMEOUT_S,
              f"the duty lookahead's warm of epoch {epoch}", label="chain")
    st = la.status()
    want = chain.preset.SLOTS_PER_EPOCH * CHAIN_COMMITTEES_A_SLOT
    got = {p: _metric("duty_lookahead_committees_total", p) for p in ("device", "host",
                                                                      "failed")}
    if (st["committees"]["device"], st["committees"]["host"], st["committees"]["failed"]) != (
            want, 0, 0) or got != {"device": want, "host": 0, "failed": 0}:
        raise AssertionError(f"chain: the lookahead's committees {st['committees']} (metric "
                             f"{got}): want {want} through the card, none on the host, none "
                             "failed")
    log(f"chain: the duty lookahead warmed epoch {epoch} before its first slot: {want} "
        f"committees through the card (device MSM at N=128), wall {st['last_warm_s']:.3f} s, "
        f"inserts {json.dumps(st['inserts'])}")
    return {"epoch": epoch, "committees": st["committees"], "inserts": st["inserts"],
            "wall_s": st["last_warm_s"]}


def node_sums(chain, dev) -> dict:
    """The node's two device callers, each called once more here, alone,
    at the rungs its path ran (the lookahead at N=128 on a committee's
    keys, the pool's G2 sums at 128 and 512 points): each result against
    the host fold, its wall, and its K1-K3 launches and lane counts (the
    launches of one call; the node's own calls ran beside the chain's
    verifies, where the counts cannot be told apart)."""
    from lighthouse_tpu_torch.compile_service.service import MSM_RUNGS
    from lighthouse_tpu_torch.crypto.cpu.curve import g2_generator
    from lighthouse_tpu_torch.crypto.device import bls as dbls, kernels
    from lighthouse_tpu_torch.state_transition.helpers import CommitteeCache

    cache = CommitteeCache(chain.preset, chain.head_state, CHAIN_LOOKAHEAD_EPOCH)
    first = chain.preset.SLOTS_PER_EPOCH * CHAIN_LOOKAHEAD_EPOCH
    pks = [chain.pubkey_cache.get(int(i)).point for i in cache.committee(first, 0)]
    g2 = [g2_generator().mul(i + 1) for i in range(max(MSM_RUNGS))]
    calls = {"lookahead msm g1 N=128": (lambda: dbls.device_msm_g1(
                 pks, [1] * len(pks), pad_n=128, device=dev), _host_sum(pks)),
             "pool sum g2 N=128": (lambda: dbls.device_sum_g2(g2[:128], pad_n=128, device=dev),
                                   g2_generator().mul(128 * 129 // 2)),
             "pool sum g2 N=512": (lambda: dbls.device_sum_g2(g2, pad_n=512, device=dev),
                                   g2_generator().mul(512 * 513 // 2))}
    out = {}
    for label, (fn, want) in calls.items():
        fn()  # replays from here on
        torch.cuda.current_stream().synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = fn()
        wall = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"{label}: differs from the host fold")
        if KERNELS and not any(kernels.launches.values()):
            raise AssertionError(f"{label}: launched none of K1-K3")
        out[label] = {"wall_s": wall, "launches": dict(kernels.launches),
                      "lane_hist": {k: dict(h) for k, h in kernels.lane_hist.items()}}
        log(f"  {label}: equal to the host fold, {1e3 * wall:.2f} ms a call (a replay), "
            f"K1-K3 launches {json.dumps(out[label]['launches'])}")
    return out


def _host_sum(points):
    agg = points[0]
    for p in points[1:]:
        agg = agg + p
    return agg


def _chain_phase(dev, slots, n, to_main, from_oracle, from_segment, prewarm) -> dict:
    from lighthouse_tpu_torch.crypto.device import kernels
    from lighthouse_tpu_torch.utils import slot_ledger

    log(f"chain: {card_line()}")
    for rung in CHAIN_RUNGS if prewarm is not None else ():
        prewarm.request(*rung)
    _, genesis, genesis_s = to_main.get(timeout=CHAIN_TIMEOUT_S)
    if prewarm is not None and not prewarm.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("chain: the phase-9 service did not capture the phase's rungs")
    log(f"chain: genesis of {n} validators built by the producer in {genesis_s:.1f} s "
        f"({len(genesis)} SSZ bytes)")
    t0 = time.perf_counter()
    client, clock, t = chain_node(genesis, n, bls_backend="cuda", device=str(dev),
                                  device_msm=True, duty_lookahead=True,
                                  compile_rungs=CHAIN_RUNGS, slasher=True, n_workers=1)
    chain = client.chain
    flushed = count_slasher_flushes(chain)
    svc, table = chain.compile_service, chain.device_key_table
    log(f"chain: the node built by ClientBuilder in {time.perf_counter() - t0:.1f} s "
        f"(pubkey cache of {len(chain.pubkey_cache)} keys; "
        f"{table.status()['validators_resident']} keys resident in the key table; "
        f"aggregator, mesh of {len(chain.device_mesh)}, lookahead, compile service, "
        f"scheduler, beacon processor, slasher, HTTP on port {client.api.port}); "
        f"resident {rss()}")
    t0 = time.perf_counter()
    if not svc.wait_idle(timeout=WARM_TIMEOUT_S):
        raise AssertionError("chain: the compile service did not warm the phase's rungs")
    log(f"chain: rungs {list(CHAIN_RUNGS)} and MSM ladder {svc.status()['msm_warm']} warm "
        f"({time.perf_counter() - t0:.1f} s waited)")
    routes0, graphs0 = _route_counts(svc), _graph_count()
    agg0 = {k: _metric("op_pool_device_agg_total", k) for k in ("ok", "fallback", "small")}
    mine, walls, stage_s = [], [], []
    sched = chain.verification_scheduler
    torch.cuda.current_stream().synchronize()
    kernels.reset_launches()
    lookahead = None
    t_loop = time.perf_counter()
    with timed_verify_now(chain) as tv:
        while (msg := to_main.get(timeout=CHAIN_TIMEOUT_S)) is not None:
            if msg[1] == chain.preset.SLOTS_PER_EPOCH * CHAIN_LOOKAHEAD_EPOCH:
                lookahead = lookahead_check(chain)
            stage_s.append(msg[4])
            mine.append(chain_slot(client, clock, t, msg, walls))
            r, w = mine[-1], walls[-1]
            if r["slot"] % 8 == 0 or r["slot"] == slots or "produce" in w:
                log(f"  slot {r['slot']}: head {r['head'][:12]} state {r['state_root'][:12]}; "
                    f"import {w['import']:.2f} s, gossip {w['unaggregated']:.2f} / "
                    f"{w['aggregate']:.2f} / {w['sync']:.2f} s"
                    + (f", block produced in {w['produce']:.2f} s" if "produce" in w else "")
                    + (f", 4 contributions in {w['contributions']:.2f} s"
                       if "contributions" in w else ""))
            if lookahead is not None and "collapse" not in lookahead:
                if (w["agg_hits"], w["agg_misses"]) != (len(r["aggregate"]), 0):
                    raise AssertionError(f"chain: slot {r['slot']}'s aggregates: {w['agg_hits']} "
                                         f"collapsed, {w['agg_misses']} first sightings missed")
                ratio = _metric("key_table_first_sighting_hit_ratio", str(CHAIN_LOOKAHEAD_EPOCH))
                lookahead["collapse"] = {"slot": r["slot"], "aggregates": w["agg_hits"],
                                         "first_sighting_hit_ratio": ratio}
                log(f"chain: slot {r['slot']}'s {w['agg_hits']} aggregates took the collapsed "
                    f"path on their first sighting; key_table_first_sighting_hit_ratio"
                    f"{{epoch=\"{CHAIN_LOOKAHEAD_EPOCH}\"}} {ratio}")
    now_walls = tv.walls
    loop_s = time.perf_counter() - t_loop
    launches = dict(kernels.launches)
    hist = {k: dict(h) for k, h in kernels.lane_hist.items()}
    st, slo = sched.status(), sched.slo_summary()
    oracle, oracle_extra = [], {}
    while (r := from_oracle.get(timeout=CHAIN_TIMEOUT_S)) is not None:
        if isinstance(r, tuple):
            oracle_extra[r[0]] = r[1]
        else:
            oracle.append(r)
    oracle_net = oracle_extra["network"]
    log(f"chain: the oracle's view of its network: {json.dumps(oracle_net, default=str)}")
    seg = from_segment.get(timeout=CHAIN_TIMEOUT_S)
    if mine != oracle:
        diff = [(a["slot"], k) for a, b in zip(mine, oracle) for k in a if a[k] != b[k]]
        raise AssertionError(f"chain: the card's chain differs from cpu-native's: "
                             f"{diff[:10]} ({len(mine)} against {len(oracle)} slots)")
    for r in mine:
        want = ["ok"] * len(r["unaggregated"])
        want[r["tampered"]] = "InvalidSignature"
        if (r["unaggregated"] != want or set(r["aggregate"]) != {"ok"}
                or set(r["sync"]) != {"ok"} or r["head"] != r["root"]):
            raise AssertionError(f"chain: slot {r['slot']}: wrong verdicts or head")
    if len(mine) != slots:
        raise AssertionError(f"chain: {len(mine)} of {slots} slots ran")
    slashing, sibling_hist = slasher_checks(chain, mine, walls, flushed,
                                            oracle_extra["slasher"])
    oracle_chain = {"roots": [r["root"] for r in oracle], "head": oracle[-1]["head"],
                    "state_root": oracle[-1]["state_root"]}
    if (seg["roots"] != oracle_chain["roots"] or seg["head"] != oracle_chain["head"]
            or seg["state_root"] != oracle_chain["state_root"]):
        raise AssertionError("chain: the segment chain's roots differ from cpu-native's")
    if seg["sync_blocks"] != slots or not seg["sync_batches"] or seg["routes"].get("shed"):
        raise AssertionError(f"chain segment: range sync counted {seg['sync_blocks']} blocks in "
                             f"{seg['sync_batches']} batches (want {slots}); routes "
                             f"{seg['routes']} (a shed flush ran on the host)")
    for label, got in (("block chain", launches), ("segment chain", seg["launches"])):
        missing = [k for k in KERNELS if not got.get(k)]
        if missing:
            raise AssertionError(f"chain: {missing} never launched by the {label}")
    tst = table.status()
    if KERNELS and tst["sets"]["indexed"] + tst["sets"]["collapsed"] == 0:
        raise AssertionError("chain: no set resolved on the key table's gathered path")
    # the node's pool: every contribution and produced sync aggregate went
    # through the card and equals the oracle's host fold (mine == oracle)
    contribs = [c for r in mine for c in r["contributions"] or ()]
    produced = [r["produced"]["data"] for r in mine if r["produced"] is not None]
    sums = {k: _metric("op_pool_device_agg_total", k) - agg0[k] for k in agg0}
    want_sums = len(contribs) + len(produced)
    n_sub = chain.preset.SYNC_COMMITTEE_SUBNET_COUNT
    if (len(contribs) != n_sub * len([s for s in CHAIN_CONTRIB_SLOTS if s <= slots])
            or len(produced) != len([s for s in CHAIN_PRODUCE_SLOTS if s <= slots])
            or sums["fallback"] or sums["ok"] != want_sums):
        raise AssertionError(f"chain: the pool's device sums {sums}: want {want_sums} ok and "
                             f"no fallback ({len(contribs)} contributions, {len(produced)} "
                             "blocks produced)")
    for c in contribs:
        if _popcount(c["aggregation_bits"]) != chain.preset.sync_subcommittee_size:
            raise AssertionError(f"chain: a contribution of slot {c['slot']} is not full")
    for b in produced:
        bits = _popcount(b["body"]["sync_aggregate"]["sync_committee_bits"])
        if bits != chain.preset.SYNC_COMMITTEE_SIZE:
            raise AssertionError(f"chain: the block produced at slot {b['slot']} aggregates "
                                 f"{bits} sync signatures")
    if slots >= CHAIN_SLOTS and (lookahead is None or "collapse" not in lookahead):
        raise AssertionError("chain: the lookahead's epoch was not checked")
    produce = [p for p, _s in stage_s]
    sign = [s for _p, s in stage_s]
    log(f"chain: {len(mine)} slots in {loop_s:.1f} s; every head, state root and verdict "
        f"equal to the cpu-native chain's (one tampered attestation a slot, the only "
        f"rejection: InvalidSignature); K1-K3 launches {json.dumps(launches)}")
    log(f"chain: the operation pool: {len(contribs)} sync contributions (128 points each) "
        f"over HTTP and {len(produced)} blocks produced over HTTP (512-point sync aggregates), "
        f"every signature byte-equal to the oracle pool's host fold (the oracle verified each "
        f"aggregate on cpu-native); op_pool_device_agg_total {json.dumps(sums)}")
    log(f"  key table paths (sets): {json.dumps(tst['sets'])}, hit ratio {tst['hit_ratio']}, "
        f"aggregate inserts {tst['aggregate_inserts']}, precomputed "
        f"{tst['aggregate_precomputed']}, hits {tst['aggregate_hits']}")
    log(f"  producer s a slot: median {statistics.median(produce):.2f}; signer "
        f"{statistics.median(sign):.2f}")
    out = {"slots": len(mine), "validators": n, "loop_s": loop_s, "launches": launches,
           "oracle_chain": oracle_chain,
           "lane_hist": hist, "key_table": {k: tst[k] for k in ("sets", "hit_ratio",
                                                                "aggregate_inserts",
                                                                "aggregate_precomputed",
                                                                "aggregate_hits")},
           "lookahead": lookahead, "pool_sums": sums,
           "produce_s": [w["produce"] for w in walls if "produce" in w],
           "contributions_s": [w["contributions"] for w in walls if "contributions" in w],
           "chain_time": slot_ledger.summary(), "slasher": slashing,
           "sibling_lane_hist": sibling_hist}
    imp = sorted(w["import"] for w in walls)
    sibling_verify = sum(w["sibling"]["verify_s"] + w["sibling"]["rejected_verify_s"]
                         for w in walls if "sibling" in w)
    out["block_import"] = {"median_s": statistics.median(imp),
                           "p90_s": imp[int(0.9 * (len(imp) - 1))],
                           "verify_share": (sum(now_walls) - sibling_verify) / sum(imp),
                           "verify_now_median_s": statistics.median(now_walls)}
    b = out["block_import"]
    log(f"  block import wall median {b['median_s']:.3f} s, p90 {b['p90_s']:.3f} s; the "
        f"verify's share {b['verify_share']:.3f} (verify_now median "
        f"{b['verify_now_median_s']:.3f} s)")
    flushes = st["planner"]["plans_planned_total"] + st["planner"]["plans_single_total"]
    n_sets = sum(len(r["unaggregated"]) + 3 * len(r["aggregate"]) + len(r["sync"])
                 for r in mine)
    out["gossip"] = {k: {f: v[f] for f in ("count_total", "p50_ms", "p99_ms")}
                     for k, v in slo["kinds"].items()}
    out.update(flushes=flushes, sets_per_flush=n_sets / max(1, flushes),
               bisections=st["bisections_total"],
               gossip_walls_s={k: statistics.median(w[k] for w in walls)
                               for k in ("unaggregated", "aggregate", "sync")})
    for k, v in out["gossip"].items():
        log(f"  {k}: {v['count_total']} verdicts, submit-to-verdict p50 {v['p50_ms']} ms, "
            f"p99 {v['p99_ms']} ms")
    log(f"  {n_sets} gossip sets (and {len(mine)} blocks through verify_now) in "
        f"{flushes} flushes, {out['sets_per_flush']:.1f} gossip sets a flush; "
        f"{st['bisections_total']} bisections")
    out["segment"] = {k: seg[k] for k in ("walls", "blocks_per_segment", "launches",
                                          "key_table", "routes", "sync_s", "waited_s",
                                          "wire_bytes", "sync_batches", "sync_blocks",
                                          "marks", "range_batch", "network")}
    out["segment"]["oracle_network"] = oracle_net
    out["segment"]["wall_s"] = sum(seg["walls"])
    out["segment_lane_hist"] = seg["lane_hist"]
    log(f"chain segment: {len(seg['roots'])} blocks range-synced from the cpu-native node over "
        f"the port's Noise + snappy transport: re-status at the oracle's heads {seg['marks']}, "
        f"sync_range_batches_total +{seg['sync_batches']:.0f}, sync_range_blocks_total "
        f"+{seg['sync_blocks']:.0f} (RangeSync.BATCH {seg['range_batch']}), "
        f"{seg['wire_bytes']} bytes read from the wire; sync wall {seg['sync_s']:.1f} s from "
        f"the first mark ({seg['waited_s']:.1f} s of it waiting for the oracle's next mark)")
    log(f"chain segment: its view of the network {json.dumps(seg['network'], default=str)}")
    log(f"chain segment: process_chain_segment calls of {seg['blocks_per_segment']} blocks in "
        f"{[round(w, 2) for w in seg['walls']]} s ({sum(seg['walls']):.1f} s); roots equal "
        f"to cpu-native's; key table paths {json.dumps(seg['key_table'])}; routes "
        f"{json.dumps(seg['routes'])}; K1-K3 launches {json.dumps(seg['launches'])}")
    # a deposit: the harness makes none (its blocks carry no deposits, and
    # one needs a proof against an eth1 deposit root), so one more
    # validator is admitted through the cache, as a deposit's import is
    grown = copy.deepcopy(chain.head_state)
    extra = extra_validator(grown)
    e0 = tst["validators_resident"]
    chain.pubkey_cache.import_new_pubkeys(grown)
    after = table.status()["validators_resident"]
    if after != e0 + 1 or len(chain.pubkey_cache) != e0 + 1:
        raise AssertionError(f"chain: the delta sync did not admit the new key "
                             f"({e0} -> {after})")
    log(f"chain: one more validator ({extra}) admitted through the pubkey cache: the "
        f"listener delta-synced the key table ({e0} -> {after} keys)")
    log("chain: the node's device callers alone, once each (after the loop)")
    out["node_sums"] = sums_alone = node_sums(chain, dev)
    per_caller = {
        "lookahead epoch": {k: v * (lookahead or {}).get("committees", {}).get("device", 0)
                            for k, v in sums_alone["lookahead msm g1 N=128"]["launches"].items()},
        "pool sums": {k: sums_alone["pool sum g2 N=128"]["launches"][k] * len(contribs)
                      + sums_alone["pool sum g2 N=512"]["launches"][k] * len(produced)
                      for k in sums_alone["pool sum g2 N=128"]["launches"]}}
    out["launches_per_caller_derived"] = per_caller
    log(f"chain: K1-K3 launches per caller, DERIVED, not counted on the node's path (one "
        f"isolated call's launches times the calls the node made): {json.dumps(per_caller)}")
    routes1 = _route_counts(svc)
    out["routes"] = {k: routes1[k] - routes0[k] for k in routes1}
    out["graphs_captured"] = _graph_count() - graphs0
    log(f"chain: routes {json.dumps(out['routes'])}; graphs captured during the phase "
        f"{out['graphs_captured']}")
    client.stop()
    return out


class Beside:
    """``fn()`` on a thread of its own from :meth:`start` on;
    :meth:`result` waits for it and returns its value or raises its
    exception."""

    def __init__(self, fn):
        import threading

        self.fn, self.out = fn, {}
        self.thread = threading.Thread(target=self._run, name=fn.__name__, daemon=True)

    def _run(self):
        try:
            self.out["value"] = self.fn()
        except BaseException as e:
            self.out["error"] = e

    def start(self) -> None:
        self.thread.start()

    def join(self) -> None:
        """Wait for ``fn`` if it was started (it stops what it started)."""
        if self.thread.ident is not None:
            self.thread.join()

    def result(self):
        if self.thread.ident is None:
            raise AssertionError(f"{self.fn.__name__} was never started")
        self.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out["value"]


class _Proc:
    """A subprocess of the devnet: its output lines collected by a reader
    thread."""

    def __init__(self, name: str, argv: list, env: dict, cwd: Path):
        import threading

        self.name, self.lines = name, []
        self.proc = subprocess.Popen(argv, cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())

    def wait_line(self, prefix: str, deadline: float) -> str:
        while True:
            got = [ln for ln in self.lines if ln.startswith(prefix)]
            if got:
                return got[0]
            if self.proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"devnet: no '{prefix}' line from the {self.name} "
                                     f"(exit {self.proc.poll()}): {self.lines[-20:]}")
            time.sleep(0.1)

    def stop(self) -> tuple:
        """SIGTERM; (exit code, seconds to exit)."""
        return _stop_all([self])[0]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(timeout=5)


def _stop_all(procs) -> list:
    """SIGTERM to every one of ``procs`` at once; per process (exit code or
    None, seconds from the signal to its exit)."""
    import signal

    t0 = time.perf_counter()
    for p in procs:
        p.proc.send_signal(signal.SIGTERM)
    out = []
    for p in procs:
        try:
            p.proc.wait(timeout=max(0.0, t0 + BN_EXIT_S - time.perf_counter()))
        except subprocess.TimeoutExpired:
            out.append((None, time.perf_counter() - t0))
            continue
        out.append((p.proc.returncode, time.perf_counter() - t0))
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _http(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


def _prom(text: str, name: str) -> dict:
    """The samples of family ``name`` in Prometheus text: {label text: value}."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith(name + "{") or ln.startswith(name + " "):
            key, _, value = ln.rpartition(" ")
            out[key[len(name):]] = float(value)
    return out


def devnet_phase(backend: str = "cuda") -> dict:
    """Phase 12e: the README's devnet through the port's entry points, in
    three subprocesses (``DEVNET_VALIDATORS`` interop validators at the
    minimal preset, a shared genesis ``DEVNET_GENESIS_S`` after the
    launch):

    * ``python -m lighthouse_tpu_torch bn --bls-backend cuda
      --listen-port P`` (the card bn; its compile service holds
      ``DEVNET_RUNGS``, through its env knob, ``DEVNET_RUNG`` first);
    * a second ``bn --bls-backend cpu-native --boot-nodes 127.0.0.1:P``,
      which follows over gossip;
    * ``vc --interop-keys 0:64 --beacon-node <the card bn>`` with a data
      directory (its slashing-protection database).

    The card bn must be up, answer ``/eth/v1/node/health``,
    ``/lighthouse/health`` and ``/metrics`` (Prometheus text) and hold the
    rung warm before genesis. The devnet then runs ``DEVNET_SLOTS`` slots
    of the system clock: the vc proposes and attests through the card bn's
    HTTP API, the card bn verifies them on the card and gossips them. Then
    the vc stops, both heads must be equal and at least 3 slots past
    genesis, the card bn's ``/metrics`` must show its verifies on the
    device backend with K1-K3 launched (``bls_device_kernel_launches_total``)
    and no flush shed to the host, the vc's database must hold a signed
    block at every slot of the canonical chain, and each process must exit
    0 within ``BN_EXIT_S`` of SIGTERM, leaving no lock file; all within
    ``DEVNET_BUDGET_S``. ``backend`` other than ``cuda`` is a CPU
    rehearsal (the card checks are skipped)."""
    import os
    import sqlite3
    import tempfile

    t0 = time.perf_counter()
    deadline = t0 + DEVNET_BUDGET_S
    root = Path(__file__).resolve().parent
    genesis = int(time.time() + DEVNET_GENESIS_S)
    p2p = _free_port()
    env = dict(os.environ, PYTHONPATH=str(root),
               LIGHTHOUSE_TPU_COMPILE_RUNGS=",".join(":".join(map(str, r))
                                                     for r in DEVNET_RUNGS))
    bn = [sys.executable, "-m", "lighthouse_tpu_torch", "bn", "--preset", "minimal",
          "--interop-validators", str(DEVNET_VALIDATORS), "--http-port", "0",
          "--genesis-time", str(genesis)]
    procs, out = [], {}
    on_card = backend == "cuda"
    with tempfile.TemporaryDirectory(prefix="devnet-") as tmp:
        dirs = {k: Path(tmp, k) for k in ("card", "peer", "vc")}
        for d in dirs.values():
            d.mkdir()
        try:
            card = _Proc("card bn", [*bn, "--bls-backend", backend, "--listen-port", str(p2p),
                                     "--datadir", str(dirs["card"])], env, root)
            procs.append(card)
            ports = {}
            line = card.wait_line("beacon node up", deadline)  # listening: dial it
            ports["card"] = int(re.search(r":(\d+) ", line).group(1))
            peer = _Proc("cpu-native bn", [*bn, "--bls-backend", "cpu-native", "--listen-port",
                                           "0", "--boot-nodes", f"127.0.0.1:{p2p}",
                                           "--datadir", str(dirs["peer"])], env, root)
            procs.append(peer)
            line = peer.wait_line("beacon node up", deadline)
            ports["peer"] = int(re.search(r":(\d+) ", line).group(1))
            out["up_s"] = time.perf_counter() - t0
            status, _ = _http(ports["card"], "/eth/v1/node/health")
            health = json.loads(_http(ports["card"], "/lighthouse/health")[1])["data"]
            text = _http(ports["card"], "/metrics")[1].decode()
            bad = [ln for ln in text.splitlines() if ln and not _PROM_LINE.match(ln)]
            if status != 200 or bad:
                raise AssertionError(f"devnet: card bn health {status}; /metrics lines that "
                                     f"are not Prometheus text: {bad[:3]}")
            # the rung warm before the vc starts: its first duties (slot 0's,
            # before genesis) are verified on the card too
            while on_card and not _bn_warm(health["compile_service"]):
                if time.time() > genesis - DEVNET_VC_LEAD_S:
                    raise AssertionError(f"devnet: the card bn's rung {DEVNET_RUNG} is not "
                                         f"warm {DEVNET_VC_LEAD_S} s before genesis: "
                                         f"{health['compile_service']}")
                time.sleep(0.25)
                health = json.loads(_http(ports["card"], "/lighthouse/health")[1])["data"]
            out["warm_s"] = time.perf_counter() - t0
            kernels0 = health["kernels"]  # the card bn's K1-K3 counts before the vc
            vc = _Proc("vc", [sys.executable, "-m", "lighthouse_tpu_torch", "vc", "--preset",
                              "minimal", "--interop-keys", f"0:{DEVNET_VALIDATORS}",
                              "--beacon-node", f"http://127.0.0.1:{ports['card']}",
                              "--datadir", str(dirs["vc"])], env, root)
            procs.append(vc)
            vc.wait_line("validator client up", deadline)
            out["vc_up_s"] = time.perf_counter() - t0
            log(f"devnet: bns up at {out['up_s']:.1f} s, the card's rung warm at "
                f"{out['warm_s']:.1f} s, the vc up at {out['vc_up_s']:.1f} s; genesis at "
                f"{DEVNET_GENESIS_S:.0f} s")
            peers = json.loads(_http(ports["card"], "/eth/v1/node/peers")[1])["data"]
            if not peers:
                raise AssertionError("devnet: the cpu-native bn is not the card bn's peer")
            # the last slot's block proposed and imported
            time.sleep(max(0.0, genesis + DEVNET_SLOTS * 6 + 1 - time.time()))
            out["vc_exit"] = vc.stop()
            heads = {}
            for _ in range(50):  # the last block's gossip reaches the peer
                heads = {k: json.loads(_http(p, "/eth/v1/beacon/headers/head")[1])["data"]
                         for k, p in ports.items()}
                if heads["card"]["root"] == heads["peer"]["root"]:
                    break
                time.sleep(0.2)
            head_slot = int(heads["card"]["header"]["message"]["slot"])
            if heads["card"]["root"] != heads["peer"]["root"] or head_slot < 3:
                raise AssertionError(f"devnet: heads {heads}: want equal, 3 or more slots past "
                                     "genesis")
            slots, root_hex = [], heads["card"]["root"]
            while True:  # the canonical chain's block slots, from the head down
                hdr = json.loads(_http(ports["card"], f"/eth/v1/beacon/headers/{root_hex}")[1])
                msg = hdr["data"]["header"]["message"]
                if int(msg["slot"]) == 0:
                    break
                slots.append(int(msg["slot"]))
                root_hex = msg["parent_root"]
            text = _http(ports["card"], "/metrics")[1].decode()
            launches = {k.split('"')[1]: v for k, v in
                        _prom(text, "bls_device_kernel_launches_total").items()}
            verifies = sum(_prom(text, "bls_device_verify_outcomes_total").values())
            routes = {k.split('"')[1]: v for k, v in
                      _prom(text, "compile_service_cold_routes_total").items()}
            health = json.loads(_http(ports["card"], "/lighthouse/health")[1])["data"]
            if on_card and (not verifies or routes.get("shed") or
                            any(not launches.get(k) for k in KERNELS)):
                raise AssertionError(f"devnet: the card bn's verifies {verifies}, routes "
                                     f"{routes}, K1-K3 launches {launches}: want every "
                                     "verify on the card, none shed; its compile service "
                                     f"{json.dumps(health['compile_service'], default=str)}")
            csvc = health["compile_service"]
            w0 = time.perf_counter()
            # no capture in flight when the node stops: the warm-ups the
            # devnet's cold geometries asked for finish first
            while csvc and (csvc["queue"] or csvc["in_flight"]):
                if time.perf_counter() > deadline - DEVNET_EXIT_ROOM_S:
                    raise AssertionError(f"devnet: the card bn's compile service still busy: "
                                         f"{json.dumps(csvc, default=str)[:600]}")
                time.sleep(0.25)
                csvc = json.loads(_http(ports["card"], "/lighthouse/health")[1])["data"][
                    "compile_service"]
            out["idle_wait_s"] = time.perf_counter() - w0
            kernels1 = json.loads(_http(ports["card"], "/lighthouse/health")[1])["data"][
                "kernels"]
            out["card_exit"], out["peer_exit"] = _stop_all([card, peer])
        finally:
            for proc in procs:
                proc.kill()
        for label, (rc, secs) in (("vc", out["vc_exit"]), ("card bn", out["card_exit"]),
                                  ("cpu-native bn", out["peer_exit"])):
            if rc != 0 or secs > BN_EXIT_S:
                raise AssertionError(f"devnet: the {label} exited {rc} in {secs:.2f} s after "
                                     f"SIGTERM: {[p.lines[-20:] for p in procs]}")
        locks = [d for d in (dirs["card"], dirs["peer"]) if Path(d, "beacon.lock").exists()]
        db = sqlite3.connect(str(dirs["vc"] / "slashing_protection.sqlite"))
        signed = {r[0] for r in db.execute("SELECT slot FROM signed_blocks")}
        db.close()
    if locks or not set(slots) <= signed:
        raise AssertionError(f"devnet: lock files left {locks}; blocks {sorted(slots)}, signed "
                             f"in the vc's database {sorted(signed)}")
    wall = time.perf_counter() - t0
    if wall > DEVNET_BUDGET_S:
        raise AssertionError(f"devnet: the phase took {wall:.1f} s of its {DEVNET_BUDGET_S} s")
    out.update(wall_s=wall, head_slot=head_slot, head=heads["card"]["root"],
               blocks=sorted(slots), signed_blocks=sorted(signed), verifies=verifies,
               launches=launches, routes=routes, peers=len(peers),
               warm_rungs=(csvc or {}).get("warm_rungs"))
    out["lane_hist"] = hist = {}
    if kernels0 is not None and kernels1 is not None:
        for k in KERNELS:
            h0, h1 = kernels0["lane_hist"][k], kernels1["lane_hist"][k]
            hist[k] = {int(n): c - h0.get(n, 0) for n, c in h1.items() if c > h0.get(n, 0)}
        out["launches_counted"] = {k: kernels1["launches"][k] - kernels0["launches"][k]
                                   for k in KERNELS}
    if on_card and any(not hist.get(k) for k in KERNELS):
        raise AssertionError(f"devnet: the card bn's /lighthouse/health counted no launch "
                             f"by lane count from the vc's start on: {hist}")
    log(f"devnet: {DEVNET_SLOTS} slots of the system clock; the card bn's compile service "
        f"warmed {out['warm_rungs']} (of {list(DEVNET_RUNGS)}, and any cold geometry the "
        f"devnet met), "
        f"idle {out['idle_wait_s']:.1f} s after the vc stopped")
    log(f"devnet: both heads {out['head'][:14]} at slot {head_slot}; canonical blocks at "
        f"{out['blocks']}, every one signed in the vc's slashing-protection database "
        f"({len(signed)} signed); the card bn: {verifies:.0f} device verifies, routes "
        f"{json.dumps(routes)}, K1-K3 launches {json.dumps(launches)} (its /metrics)")
    log(f"devnet: the card bn's own K1-K3 launches from the vc's start to its stop "
        f"(its /lighthouse/health; the warm-ups of the rungs after the first included): "
        f"{json.dumps(out.get('launches_counted'))} at "
        f"{ {k: len(h) for k, h in hist.items()} } lane counts")
    log(f"devnet: SIGTERM exits (code, s): vc {out['vc_exit']}, card bn {out['card_exit']}, "
        f"cpu-native bn {out['peer_exit']}; no lock file; phase {wall:.1f} s")
    return out


def _bn_warm(csvc) -> bool:
    """The bn process's compile service (its ``/lighthouse/health`` block)
    reports ``DEVNET_RUNG`` warm."""
    return bool(csvc) and any(tuple(r[:3]) == DEVNET_RUNG for r in csvc["warm_rungs"])


_PROM_LINE = re.compile(
    r'^(# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*'
    r'|# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram|summary|untyped)'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*")*\})? '
    r'(-?[0-9.e+-]+|[+-]Inf|NaN)( -?[0-9]+)?)$')


def warm_phase(rng, dev, backend, table, batches, path_rungs, eager, refs) -> dict:
    """Drop the graphs the earlier phases captured on first use, start a
    compile service over the batches' rungs then ``DEFAULT_RUNGS`` (the
    first ``WARM_DEFAULT_RUNGS`` of them), print the capture table, then
    verify every path with the service attached, run the stale-input
    check and the MSM and G2 sum through their graphs."""
    from lighthouse_tpu_torch.compile_service.service import DEFAULT_RUNGS
    from lighthouse_tpu_torch.crypto.device import bls as dbls, graphs, key_table

    from lighthouse_tpu_torch.utils import pipeline_profiler

    graphs.reset()
    dbls.reset_recompile_tracking()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pipeline_profiler.reset()  # the bubble rows of this phase
    plan = list(dict.fromkeys([*path_rungs, *DEFAULT_RUNGS[:WARM_DEFAULT_RUNGS]]))
    log(f"compile service plan: the batches' rungs {path_rungs}, then "
        f"{WARM_DEFAULT_RUNGS} of the {len(DEFAULT_RUNGS)} default rungs "
        f"({len(plan)} rungs); MSM ladder on")
    svc, wall = start_service(plan, dev)
    log(f"compile service warmed {len(plan)} rungs and the MSM ladder in {wall:.2f} s")
    table_rows = capture_table(plan, svc.status()["msm_warm"], dev)
    summary = graph_summary("captured graphs after the warm-up")
    out = {"warm_s": wall, "plan": plan, "captures": table_rows, "graphs": summary,
           "paths": {}}

    key_table.clear_table(table)  # the raw batches' keys are not the registry's
    ledger = {}

    def served(label):
        sets, path = batches[label]
        out["paths"][label], ledger[label] = ledger_checked(
            f"served {label}", backend,
            lambda: served_verify(backend, sets, f"served {label} valid", True, path,
                                  eager[label]))

    for label in ("gossip", "block"):
        served(label)
    stale_input_check(rng, backend, batches["gossip"][0])
    key_table.set_table(table)
    with held_collapse(table):
        served("gathered block")
    served("collapsed block")
    out["ledger"] = ledger
    pts, sc, want = refs["g1"]
    served_sum(f"msm g1 N={MSM_N}",
               lambda: dbls.device_msm_g1(pts, sc, pad_n=MSM_N, device=dev), want,
               eager[f"msm g1 N={MSM_N}"])
    pts2, _sc, want2 = refs["g2"]
    served_sum(f"sum g2 N={G2_N}",
               lambda: dbls.device_sum_g2(pts2, pad_n=G2_N, device=dev), want2,
               eager[f"sum g2 N={G2_N}"])
    out["graphs_after"] = graph_summary("captured graphs after the served verifies")
    out["stage_summary"] = print_stage_summary("phase 9")
    key_table.clear_table(table)
    out["overhead"] = telemetry_overhead(
        backend, {"gossip": (batches["gossip"][0], True),
                  "block": (batches["block"][0], True)})
    key_table.set_table(table)
    with held_collapse(table):  # the node's default path, for comparison
        out["overhead"].update(telemetry_overhead(
            backend, {"gathered block": (batches["gathered block"][0], True)}))
    out["service"] = svc
    return out



_PHASE_T: list = []


def _phase_mark(name: str) -> None:
    """The start of phase ``name`` (and the end of the one before, whose
    wall is logged, so a run cut short still shows where its time went)."""
    now = time.perf_counter()
    if _PHASE_T:
        prev, t0 = _PHASE_T[-1]
        log(f"phase {prev} took {now - t0:.1f} s (script at {now - _PHASE_T[0][1]:.1f} s)")
    _PHASE_T.append((name, now))


def _phase_walls() -> dict:
    """Each marked phase's wall, in seconds."""
    return {a: round(t1 - t0, 1) for (a, t0), (_b, t1) in zip(_PHASE_T, _PHASE_T[1:])}

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="build, kernel checks and timings, one tiny verify")
    ap.add_argument("--planner-off", action="store_true",
                    help="serve phase: also replay the warm pass with the flush "
                         "planner off (every flush one rung), to compare")
    ap.add_argument("--time-only", metavar="ROOT",
                    help="only check and time the kernels of the checkout at ROOT "
                         "(--quick's lane counts and the earlier shapes) and print "
                         "them as one JSON line: to compare two trees in one run")
    args = ap.parse_args()
    t_script = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.time_only:
        sys.path.insert(0, str(Path(args.time_only).resolve()))
    from lighthouse_tpu_torch.crypto.device import bls as dbls, kernels, key_table
    from lighthouse_tpu_torch.utils import slot_clock

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    _phase_mark("1")
    log(f"phase 1 device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    import importlib.util

    log(f"cryptography importable here: {importlib.util.find_spec('cryptography') is not None}"
        " (for information: the port carries its own X25519, ChaCha20-Poly1305 and AES-CTR)")
    kernels.build()
    info = kernels.build_info
    log(f"kernel build: {info['seconds']:.2f} s ({info['library']})")
    for line in info.get("log", "").splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    rng = np.random.default_rng(args.seed)
    if args.time_only:
        shapes = {k: sorted({*QUICK_LANES[k], EARLIER_LANES[k]}) for k in KERNELS}
        timings = time_kernels(rng, dev, shapes, dict.fromkeys(KERNELS, 0))
        floor_ms = launch_floor(dev, card)
        log(card)
        print(json.dumps({"root": args.time_only, "source": str(kernels.SOURCE),
                          "launch_floor_ms": floor_ms, "timings": timings}), flush=True)
        return 0
    _phase_mark("2")
    log("phase 2 kernels vs plain versions")
    errs = check_kernels(rng, dev)

    backend = dbls.CudaBackend(device=dev)
    if args.quick:
        from lighthouse_tpu_torch.compile_service import service as csvc
        from lighthouse_tpu_torch.crypto.device import graphs

        log("kernel timings (device ms per launch, launches queued back to back)")
        time_kernels(rng, dev, QUICK_LANES, errs)
        launch_floor(dev, card)
        check_captured_k1(rng, dev)
        gsets, msgs, hs = gossip_sets(rng, 1000)
        sets = gsets[:2]
        timed_verify(backend, sets, "quick verify (B=2)", True)
        bad = [sets[0], (sets[0][0], sets[1][1], sets[1][2])]  # wrong signer
        timed_verify(backend, bad, "quick verify wrong signer", False, reps=1, warm=True)
        graphs.reset()
        dbls.reset_recompile_tracking()
        plan = [(2, 1, 1), (64, 1, 8), (192, 256, 192)]
        svc, wall = start_service(plan, dev)
        log(f"compile service warmed {plan} and {svc.status()['msm_warm']} of the MSM "
            f"ladder in {wall:.2f} s")
        capture_table(plan, svc.status()["msm_warm"], dev)
        graph_summary("captured graphs")
        stale_input_check(rng, backend, sets)
        gwall, _c, ghist = timed_verify(backend, gsets, "quick gossip (B=64) served", True,
                                        warm=True)
        concurrent_warm_phase(svc, backend, [(32, 1, 8)],
                              [("gossip", gsets, True, "raw_staged", ghist)], dev)
        engine_phase(backend, gsets, dev)
        profile_verify(backend, gsets, "quick gossip served", gwall)
        registry = registry_points(64)
        table = key_table_phase(registry, dev)
        key_table.set_table(table)
        timed_verify(backend, gossip_sets(rng, 1, registry)[0][:2],
                     "quick gathered verify (B=2)", True, path="raw_gather", warm=True)
        key_table.clear_table(table)
        sc = [int(s) for s in rng.integers(0, 2 ** 64, size=8, dtype=np.uint64)]
        want = registry[0].mul(sc[0])
        for p, s in zip(registry[1:8], sc[1:]):
            want = want + p.mul(s)
        for rep in ("capture", "replay"):
            if dbls.device_msm_g1(registry[:8], sc, device=dev) != want:
                raise AssertionError(f"quick msm ({rep}): differs from the host fold")
        log("quick msm g1 N=8: capture and replay equal to the host fold")
        svc.stop()
        csvc.clear_service(svc)
        log(card)
        log("quick run complete")
        return 0

    _phase_mark("3")
    log("phase 3 gossip batch: 64 attestations, 8 committees (K=1, M=8)")
    t0 = time.perf_counter()
    sets, msgs, hs = gossip_sets(rng, 1000)
    log(f"host signing: {time.perf_counter() - t0:.2f} s")
    check_stage1_against_host(sets, msgs, hs, dev)
    t0 = time.perf_counter()
    dbls.pack_signature_sets_raw(sets, device=dev)
    torch.cuda.synchronize()
    log(f"gossip host pack (parse, limbs, hash_to_field, copy): {time.perf_counter() - t0:.3f} s")
    gwall, gcounts, ghist = timed_verify(backend, sets, "gossip valid", True)
    path_rungs = [backend.last_batch["rung"]]
    tampered = list(sets)
    sig, pks, m = tampered[17]
    tampered[17] = (sig, pks, bytes([m[0] ^ 1]) + m[1:])
    timed_verify(backend, tampered, "gossip tampered message", False)
    log(card)

    _phase_mark("4")
    log("phase 4 block batch: 128 aggregates (K 180..229) + proposal + RANDAO")
    t0 = time.perf_counter()
    bsets = block_sets(rng, 100_000)
    log(f"host signing: {time.perf_counter() - t0:.2f} s; B={len(bsets)} "
        f"K<={max(len(s[1]) for s in bsets)} M={len({s[2] for s in bsets})}")
    t0 = time.perf_counter()
    dbls.pack_signature_sets_raw(bsets, device=dev)
    torch.cuda.synchronize()
    log(f"block host pack (parse, limbs, hash_to_field, copy): {time.perf_counter() - t0:.3f} s")
    bwall, counts, bhist = timed_verify(backend, bsets, "block valid", True)
    path_rungs.append(backend.last_batch["rung"])
    poisoned = list(bsets)
    poisoned[5] = (non_subgroup_signature(rng), bsets[5][1], bsets[5][2])
    timed_verify(backend, poisoned, "block non-subgroup signature", False)
    lane_summary("gossip valid", ghist)
    lane_summary("block valid", bhist)
    log(card)

    n_reg = REGISTRY_SIZE
    _phase_mark("5")
    log(f"phase 5 key table: a registry of {n_reg} validators (secrets 1..{n_reg})")
    t0 = time.perf_counter()
    registry = registry_points(n_reg)
    log(f"registry host build (Jacobian additions, one batch inversion): "
        f"{time.perf_counter() - t0:.2f} s")
    # chain time is the test's own: no epoch rolls over while it runs
    slot_clock.set_clock(slot_clock.ManualSlotClock())
    table = key_table_phase(registry, dev)
    key_table.set_table(table)
    log(card)

    _phase_mark("6")
    log("phase 6 gathered verifies (registry keys, collapse held off)")
    gbsets, gbwall, hists = gathered_phase(rng, registry, table, backend, dev)
    log(card)

    _phase_mark("7")
    log("phase 7 collapse: a fresh block batch seen three times (agg_min_repeats 2)")
    csets, cwall, hists["collapsed block"] = collapse_phase(rng, registry, table, backend)
    path_rungs.append(backend.last_batch["rung"])
    log(card)

    _phase_mark("8")
    log("phase 8 msm: G1 MSM and G2 sum against host references; precomputed committee")
    msm_hists, refs = msm_phase(rng, registry, table, backend, dev, csets)
    hists.update(msm_hists)
    path_rungs.append(backend.last_batch["rung"])
    log(card)

    _phase_mark("9")
    log("phase 9 warm dispatch: the compile service captures each rung's stage graphs; "
        "every path verified through the graphs, with the service attached")
    hists = {"gossip": ghist, "block": bhist, **hists}
    batches = {"gossip": (sets, "raw_staged"), "block": (bsets, "raw_staged"),
               "gathered block": (gbsets, "raw_gather"),
               "collapsed block": (csets, "raw_gather")}
    warm = warm_phase(rng, dev, backend, table, batches,
                      list(dict.fromkeys(path_rungs)), hists, refs)
    log(card)

    from lighthouse_tpu_torch.compile_service.service import DEFAULT_RUNGS

    cold = [DEFAULT_RUNGS[i] for i in CONCURRENT_COLD]
    _phase_mark("10")
    log(f"phase 10 concurrent warm: the service's worker captures the cold rungs {cold} "
        "while this thread serves warm gossip and gathered block batches")
    key_table.set_table(table)
    with held_collapse(table):
        warm["concurrent"] = concurrent_warm_phase(
            warm["service"], backend, cold,
            [("gossip", sets, True, "raw_staged", ghist),
             ("gathered block", gbsets, True, "raw_gather", hists["gathered block"])], dev)
    key_table.clear_table(table)
    log(card)

    # phase 12e's devnet (its own processes, no check on a wall of this
    # process) runs beside phase 11 and is read after phase 12d; should the
    # script fail before, the thread is joined at exit (it stops its
    # processes)
    import atexit

    devnet_run = Beside(devnet_phase)
    devnet_run.start()
    atexit.register(devnet_run.join)
    _phase_mark("11")
    log("phase 11 engines: the gossip batch under the composed engine triples (phase 12e's "
        "devnet starts beside it)")
    warm["engines"] = engine_phase(backend, sets, dev)
    log(card)

    _phase_mark("12")
    log("phase 12 serve: the verification scheduler on the card, the phase-9 compile "
        "service attached, replaying gossip_steady cold, warm, then shed to the C fallback")
    warm["serve"] = serve_phase(rng, warm["service"], [bsets, gbsets], dev,
                                args.planner_off)
    for p in ("cold", "warm", "warm_single", "shed"):
        if p in warm["serve"]:
            hists[f"serve {p}"] = warm["serve"][p].pop("lane_hist")
    log(card)

    _phase_mark("12b")
    log("phase 12b mesh: one discovered shard, then two shards on the one card through "
        "a split, a loss, a recovery and a watchdog reap")
    pools, serve_poisoned = warm["serve"].pop("pools")
    mesh = mesh_phase(warm["service"], table, pools, serve_poisoned, warm["serve"]["warm"],
                      backend, gbsets, dev)
    for label, part in (("one_shard", "mesh one shard"), ("two_shards", "mesh two shards")):
        hists[part] = mesh[label]["pass"].pop("lane_hist")
    for label in ("loss", "recovery", "watchdog"):
        mesh[label]["pass"].pop("lane_hist")
    print(json.dumps({"mesh": mesh}, default=str), flush=True)
    log(card)

    _phase_mark("12c")
    log("phase 12c telemetry: one more pass with the ledgers reset and the capacity "
        "sampler ticking; the stage summary, data movement, chain time, capacity and "
        "device memory")
    tel = telemetry_phase(warm["service"], pools, dev)
    tel["pass"].pop("lane_hist")
    print(json.dumps({"telemetry": tel}, default=str), flush=True)
    log(card)

    _phase_mark("12d")
    log(f"phase 12d chain: the port's beacon node, built by its ClientBuilder "
        f"({CHAIN_VALIDATORS} validators, mainnet preset, altair), imports {CHAIN_SLOTS} "
        "slots of blocks and verifies their gossip through its scheduler, compile service "
        "and key table on the card; its duty lookahead warms the next epoch and its "
        "operation pool sums sync signatures on the card; a segment node imports the same "
        "blocks; a cpu-native node is the oracle")
    from lighthouse_tpu_torch.compile_service import service as csvc

    prev_table = key_table.get_table()
    csvc.clear_service(warm["service"])  # the node attaches its own
    chain = chain_phase(dev, prewarm=warm["service"])
    catch_up = chain.pop("catch_up")  # the late joiner runs on through phase 12e
    csvc.set_service(warm["service"])
    key_table.set_table(prev_table)
    hists["chain"] = chain.pop("lane_hist")
    hists["chain segment"] = chain.pop("segment_lane_hist")
    hists["chain sibling import"] = chain.pop("sibling_lane_hist")
    for label, rec in chain["node_sums"].items():
        hists[label] = rec.pop("lane_hist")
    print(json.dumps({"chain": chain}, default=str), flush=True)
    log(card)

    _phase_mark("12e")
    log("phase 12e devnet: python -m lighthouse_tpu_torch bn --bls-backend cuda --listen-port, "
        "a cpu-native bn dialing it, and a vc of 64 interop keys on the card bn, for "
        f"{DEVNET_SLOTS} slots of the system clock, started beside phase 11 (its lines "
        "among phase 11's)")
    try:
        devnet = devnet_run.result()
    except BaseException:
        stop_catch_up(catch_up)
        raise
    hists["devnet"] = devnet.pop("lane_hist")
    print(json.dumps({"devnet": devnet}), flush=True)
    log(card)

    _phase_mark("12d catch-up")
    log("phase 12d catch-up: the late joiner's range sync from genesis, which ran on after "
        "phase 12d's checks")
    late = catch_up_result(catch_up)
    hists["chain catch-up"] = late.pop("lane_hist")
    print(json.dumps({"chain_catch_up": late}, default=str), flush=True)
    log(card)

    _phase_mark("13")
    log("phase 13 every kernel checked against its plain version and timed at "
        "each path's lane counts (device ms per launch, launches queued back to back)")
    gc.collect()  # the engine phase's garbage, before the timed queueing
    shapes = path_shapes(hists)
    print_shapes(shapes, hists)
    timings = time_kernels(rng, dev, shapes, errs)
    launch_floor(dev, card)
    # profiled after every timed run: a torch.profiler session slows the
    # launches that follow it (35-45% on an H100)
    _phase_mark("14")
    log("phase 14 profiles (graph replays)")
    key_table.clear_table(table)  # the raw batches' keys are not the registry's
    served = {k: v["wall"] for k, v in warm["paths"].items()}
    gdev = profile_verify(backend, sets, "gossip valid", served["gossip"])
    bdev = profile_verify(backend, bsets, "block valid", served["block"])
    key_table.set_table(table)
    with held_collapse(table):
        profile_verify(backend, gbsets, "gathered block valid", served["gathered block"])
    profile_verify(backend, csets, "collapsed block valid", served["collapsed block"])
    key_table.clear_table(table)
    per_verify = {}
    for label, dev_ms, cnt, hist in (("gossip", gdev, gcounts, ghist),
                                     ("block", bdev, counts, bhist)):
        for k in KERNELS:
            lanes = sum(n * c for n, c in hist[k].items())
            b_ms = sum(bound(k, n)[0] * c for n, c in hist[k].items())
            ms = dev_ms[k]
            seen = (f"{ms:.3f} device ms in {cnt[k]} launches ({1e3 * ms / cnt[k]:.2f} us "
                    f"each)" if ms else f"not seen by the profiler ({cnt[k]} launches)")
            log(f"per {label} verify {k}: {seen}, {lanes} lanes, bound over those "
                f"lanes {b_ms:.4f} ms" + (f" ({b_ms / ms:.2%})" if ms else ""))
            if label == "block":
                per_verify[k] = dict(lanes=lanes, device_ms=ms, bound_ms=b_ms)
    svc = warm.pop("service")
    svc.stop()
    csvc.clear_service(svc)
    warm["paths"] = {k: {**v, "rung": list(v["rung"])} for k, v in warm["paths"].items()}
    print(json.dumps({"warm_dispatch": warm}, default=str), flush=True)
    log(card)

    rows = []
    for k in KERNELS:
        at = {r["lanes"]: r for r in timings[k]}[mode_of(bhist, k)]
        rows.append({
            "name": k, "route": "cuda",
            "source": "lighthouse_tpu_torch/csrc/fp_kernels.cu",
            "replaces": REPLACES[k], "launches": counts[k],
            "max_abs_err": errs[k], "lanes": at["lanes"], "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": None,
            "lanes_per_verify": per_verify[k]["lanes"],
            "device_ms_per_verify": per_verify[k]["device_ms"],
            "bound_ms_per_verify": per_verify[k]["bound_ms"],
            "timings": timings[k],
        })
    _phase_mark("end")
    log(f"phase walls (s): {json.dumps(_phase_walls())}")
    log(f"script wall {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
