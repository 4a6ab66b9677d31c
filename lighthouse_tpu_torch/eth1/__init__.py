"""Eth1 deposit tracking, the port of the JAX package's ``eth1/``:
deposit log + block caches feeding block production's eth1-data votes
and deposit inclusion.

Reference: ``beacon_node/eth1`` (``src/service.rs:393`` caching service)
+ ``beacon_node/genesis`` (genesis from deposit logs). Host code with no
device caller.
"""

from .service import DepositLog, Eth1Block, Eth1Service, MockEth1Endpoint

__all__ = ["DepositLog", "Eth1Block", "Eth1Service", "MockEth1Endpoint"]
