"""Execution-layer bridge, the port of the JAX package's
``execution_layer/``: engine API client, state machine, payload cache,
and the mock EL used by tests.

Reference: ``beacon_node/execution_layer`` (``src/engine_api/http.rs:31-41``
new_payload/forkchoice_updated/get_payload, ``src/engines.rs`` upcheck
state machine, ``src/test_utils`` MockExecutionLayer). Host code with no
device caller.
"""

from .engine_api import EngineApiClient, EngineApiError, PayloadStatus
from .execution_layer import ExecutionLayer
from .mock import MockExecutionLayer

__all__ = [
    "EngineApiClient",
    "EngineApiError",
    "ExecutionLayer",
    "MockExecutionLayer",
    "PayloadStatus",
]
