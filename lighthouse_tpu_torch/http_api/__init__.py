"""L6: the standard Beacon API HTTP server + metrics endpoint.

Reference: ``beacon_node/http_api`` (warp router, ``src/lib.rs:483+``)
and ``beacon_node/http_metrics``.
"""

from .server import BeaconApiServer

__all__ = ["BeaconApiServer"]
