"""Multi-node simulator: N full beacon nodes in ONE process, connected
over real localhost TCP networking (reference: ``testing/simulator`` —
``src/main.rs:1-15``, ``local_network.rs``, invariant ``checks.rs`` —
and ``testing/node_test_rig``).

Each node: its own store, BeaconChain, BeaconProcessor, NetworkService.
Validators are partitioned across nodes; block proposals and
attestations are produced by the owning node and propagate over gossip.
A shared ManualSlotClock keeps the run deterministic.
"""

from __future__ import annotations

import copy
import time

from ..beacon_chain import BeaconChain, VerifiedUnaggregatedAttestation
from ..client import _build_processor
from ..network import NetworkService
from ..operation_pool import OperationPool
from ..ssz import hash_tree_root
from ..state_transition import store_replayer
from ..store import HotColdDB, MemoryStore
from ..testing.harness import StateHarness
from ..types.chain_spec import minimal_spec
from ..types.preset import MINIMAL
from ..utils.slot_clock import ManualSlotClock


class LocalNode:
    def __init__(self, harness_template, genesis, clock):
        h = harness_template
        db = HotColdDB(
            MemoryStore(), h.t, h.spec, store_replayer(h.preset, h.spec),
            slots_per_snapshot=8,
        )
        self.chain = BeaconChain(
            h.preset, h.spec, h.t, db, copy.deepcopy(genesis), slot_clock=clock
        )
        self.chain.op_pool = OperationPool(h.preset, h.spec, h.t)
        self.processor = _build_processor(self.chain, n_workers=1)
        self.net = NetworkService(self.chain, self.processor)

    def close(self):
        self.net.close()
        self.processor.shutdown()


class LocalNetwork:
    """``validator_split``: list of validator-index sets, one per node."""

    def __init__(self, n_nodes: int, validator_count: int = 8, fork: str = "phase0"):
        self.h = StateHarness(
            MINIMAL, minimal_spec(), validator_count=validator_count,
            fork_name=fork, fake_sign=True,
        )
        self.genesis = copy.deepcopy(self.h.state)
        self.clock = ManualSlotClock(
            self.genesis.genesis_time, self.h.spec.seconds_per_slot
        )
        self.nodes = [
            LocalNode(self.h, self.genesis, self.clock) for _ in range(n_nodes)
        ]
        # everyone dials the bootnode; peer exchange fills the mesh
        boot = self.nodes[0]
        for node in self.nodes[1:]:
            node.net.connect("127.0.0.1", boot.net.port)
        # dial() registers the peer on the DIALING side synchronously, but
        # the bootnode's accept-loop thread registers inbound peers after
        # its half of the handshake — callers touching
        # ``nodes[0].net.transport.peers`` right after construction raced
        # that thread (the one red test in the default gate). Block until
        # every inbound peer is registered.
        self._wait_inbound(boot, n_nodes - 1)
        self.validator_owner = {
            v: v % n_nodes for v in range(validator_count)
        }

    @staticmethod
    def _wait_inbound(node: LocalNode, n: int, timeout: float = 5.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if node.net.transport.peer_count() >= n:
                return
            time.sleep(0.01)
        raise AssertionError(
            f"bootnode registered {node.net.transport.peer_count()} of "
            f"{n} inbound peers within {timeout}s"
        )

    def add_node(self) -> LocalNode:
        node = LocalNode(self.h, self.genesis, self.clock)
        have = self.nodes[0].net.transport.peer_count()
        node.net.connect("127.0.0.1", self.nodes[0].net.port)
        self._wait_inbound(self.nodes[0], have + 1)
        self.nodes.append(node)
        return node

    # -- driving ---------------------------------------------------------

    def tick_slot(self, attest: bool = True) -> None:
        """Advance one slot: proposer's node builds + publishes the block;
        every validator's node attests to it over gossip."""
        h = self.h
        slot = self.h.state.slot + 1
        self.clock.set_slot(slot)
        for node in self.nodes:
            node.chain.on_tick(slot)

        # canonical copy of the chain lives in the harness (proposer keys)
        atts = []
        if attest and slot >= 2:
            atts = h.attestations_for_slot(h.state, slot - 1)[
                : h.preset.MAX_ATTESTATIONS
            ]
        sb = h.produce_block(slot, attestations=atts)
        h.process_block(sb, strategy="none")
        proposer_node = self.nodes[sb.message.proposer_index % len(self.nodes)]
        proposer_node.chain.process_block(
            proposer_node.chain.verify_block_for_gossip(sb)
        )
        proposer_node.net.publish_block(sb)
        self._settle()

        if attest:
            # single-bit gossip attestations from each owner node
            for att in h.attestations_for_slot(h.state, slot):
                bits = list(att.aggregation_bits)
                from ..state_transition import get_beacon_committee

                committee = get_beacon_committee(
                    h.preset, h.state, att.data.slot, att.data.index
                )
                for pos, v in enumerate(committee):
                    single = copy.deepcopy(att)
                    single.aggregation_bits = [
                        i == pos for i in range(len(bits))
                    ]
                    node = self.nodes[int(v) % len(self.nodes)]
                    res = node.chain.batch_verify_unaggregated_attestations_for_gossip(
                        [single]
                    )
                    if isinstance(res[0], VerifiedUnaggregatedAttestation):
                        node.chain.apply_attestation_to_fork_choice(res[0])
                        node.chain.op_pool.insert_attestation(single)
                        node.net.publish_attestation(single, att.data.index)
            self._settle()

    def _settle(self, timeout: float = 5.0) -> None:
        """Wait until every node's queues drain."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all(
                sum(n.processor.queue_lengths().values()) == 0
                for n in self.nodes
            ):
                time.sleep(0.05)
                if all(
                    sum(n.processor.queue_lengths().values()) == 0
                    for n in self.nodes
                ):
                    return
            time.sleep(0.01)

    def recompute_heads(self) -> None:
        for n in self.nodes:
            n.chain.recompute_head()

    # -- invariant checks (reference checks.rs) --------------------------

    def check_all_heads_equal(self) -> bytes:
        self.recompute_heads()
        heads = {n.chain.head_block_root for n in self.nodes}
        assert len(heads) == 1, f"forked heads: {[h.hex()[:8] for h in heads]}"
        return heads.pop()

    def check_finalization(self, min_epoch: int) -> None:
        for i, n in enumerate(self.nodes):
            fin = n.chain.fork_choice.store.finalized_checkpoint[0]
            assert fin >= min_epoch, f"node {i} finalized {fin} < {min_epoch}"

    def close(self) -> None:
        for n in self.nodes:
            n.close()
