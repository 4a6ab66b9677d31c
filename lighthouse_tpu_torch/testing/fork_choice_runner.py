"""Step-driven fork-choice harness: the consumer of the ef
``fork_choice`` vector format (anchor + tick/block/attestation/
attester_slashing/checks steps).

This is the analogue of the reference's ef fork_choice case runner
(``testing/ef_tests/src/cases/fork_choice.rs:1-688``), which drives a
full ``BeaconChainHarness``; here the runner owns a :class:`ForkChoice`
plus a root→state map maintained by replaying blocks through the real
state transition. The port's copy of the JAX package's runner.
"""

from __future__ import annotations

import copy

from ..fork_choice import ForkChoice
from ..ssz import hash_tree_root
from ..state_transition import partial_state_advance
from ..state_transition.block import process_block
from ..state_transition.helpers import get_indexed_attestation
from ..types.chain_spec import ChainSpec
from ..types.preset import Preset


class ForkChoiceRunner:
    def __init__(
        self, preset: Preset, spec: ChainSpec, fork_name: str,
        anchor_state, anchor_block,
    ):
        self.preset = preset
        self.spec = spec
        self.fork_name = fork_name
        anchor_root = hash_tree_root(type(anchor_block), anchor_block)
        self.anchor_root = anchor_root
        self.genesis_time = anchor_state.genesis_time
        # anchor checkpoints root to the anchor block itself (chain.py:146)
        self.fc = ForkChoice(
            preset,
            spec,
            anchor_state.slot,
            anchor_root,
            (anchor_state.current_justified_checkpoint.epoch, anchor_root),
            (anchor_state.finalized_checkpoint.epoch, anchor_root),
            [v.effective_balance for v in anchor_state.validators],
        )
        self.states = {anchor_root: copy.deepcopy(anchor_state)}

    # -- steps -----------------------------------------------------------

    def on_tick(self, time: int) -> None:
        slot = (time - self.genesis_time) // self.spec.seconds_per_slot
        self.fc.on_tick(slot)

    def on_block(self, signed_block) -> bytes:
        """Replay through the state transition, then register with fork
        choice. Raises on any invalid block (unknown parent, bad
        transition, fork-choice rejection)."""
        block = signed_block.message
        parent = self.states.get(bytes(block.parent_root))
        if parent is None:
            raise KeyError("unknown parent block")
        state = copy.deepcopy(parent)
        state = partial_state_advance(self.preset, self.spec, state, block.slot)
        process_block(
            self.preset, self.spec, state, signed_block, self.fork_name,
            signature_strategy="none",
        )
        root = hash_tree_root(type(block), block)
        self.fc.on_block(self.fc.store.current_slot, block, root, state)
        self.states[root] = state
        return root

    def on_attestation(self, attestation) -> None:
        target_state = self.states.get(bytes(attestation.data.target.root))
        if target_state is None:
            raise KeyError("unknown attestation target")
        indexed = get_indexed_attestation(self.preset, target_state, attestation)
        self.fc.on_attestation(self.fc.store.current_slot, indexed)

    def on_attester_slashing(self, slashing) -> None:
        self.fc.on_attester_slashing(
            slashing.attestation_1, slashing.attestation_2
        )

    # -- observables -----------------------------------------------------

    def checks(self) -> dict:
        head = self.fc.get_head()
        jc = self.fc.store.justified_checkpoint
        fin = self.fc.store.finalized_checkpoint
        return {
            "head": {
                "slot": int(self.fc.proto.get_block_slot(head)),
                "root": "0x" + head.hex(),
            },
            "justified_checkpoint": {"epoch": int(jc[0]), "root": "0x" + jc[1].hex()},
            "finalized_checkpoint": {"epoch": int(fin[0]), "root": "0x" + fin[1].hex()},
            "proposer_boost_root": "0x" + self.fc.store.proposer_boost_root.hex(),
        }
