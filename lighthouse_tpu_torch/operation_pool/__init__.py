"""Operation pool: gossip-learned operations -> optimal block packings.

Reference: ``beacon_node/operation_pool`` (max-cover selection, on-insert
aggregation, reward-weighted packing).
"""

from .device_agg import DeviceAggregator
from .max_cover import MaxCoverItem, maximum_cover
from .pool import OperationPool

__all__ = [
    "DeviceAggregator",
    "MaxCoverItem",
    "OperationPool",
    "maximum_cover",
]
