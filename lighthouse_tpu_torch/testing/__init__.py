"""Test rigs (reference: ``beacon_node/beacon_chain/src/test_utils.rs``
``BeaconChainHarness``): deterministic interop validators driving real
state transitions with real BLS signatures. The port's copy of the JAX
package's ``StateHarness``; its fork-choice runner and simulator are not
ported."""

from .harness import StateHarness


def spec_for_fork(fork: str):
    """Minimal-preset ChainSpec with fork-activation epochs set for
    ``fork``."""
    from ..types.chain_spec import minimal_spec

    return minimal_spec(
        altair_fork_epoch=0 if fork != "phase0" else None,
        bellatrix_fork_epoch=0 if fork == "bellatrix" else None,
    )


__all__ = ["StateHarness", "spec_for_fork"]
