"""Test rigs (reference: ``beacon_node/beacon_chain/src/test_utils.rs``
``BeaconChainHarness``): deterministic interop validators driving real
state transitions with real BLS signatures: the port's copies of the JAX
package's ``StateHarness``, fork-choice runner and network simulator
(``simulator.LocalNetwork``, imported from its module: it pulls in the
client and the network)."""

from .fork_choice_runner import ForkChoiceRunner
from .harness import StateHarness


def spec_for_fork(fork: str):
    """Minimal-preset ChainSpec with fork-activation epochs set for
    ``fork``."""
    from ..types.chain_spec import minimal_spec

    return minimal_spec(
        altair_fork_epoch=0 if fork != "phase0" else None,
        bellatrix_fork_epoch=0 if fork == "bellatrix" else None,
    )


__all__ = ["ForkChoiceRunner", "StateHarness", "spec_for_fork"]
