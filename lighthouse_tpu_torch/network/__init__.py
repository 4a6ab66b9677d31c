"""L5 networking: gossip pub/sub, req/resp RPC, peer exchange, range
sync over TCP with SSZ-snappy payloads.

Reference: ``beacon_node/lighthouse_network`` (libp2p behaviour) +
``beacon_node/network`` (router, sync). The port's copy of the JAX
package's ``network/``: the Noise session gets X25519 and
ChaCha20-Poly1305 from ``utils/crypto.py``, not ``cryptography``.
"""

from .service import (
    ATTESTATION_SUBNET_COUNT,
    NetworkService,
    RangeSync,
    Topics,
)
from .transport import Peer, Transport

__all__ = [
    "ATTESTATION_SUBNET_COUNT",
    "NetworkService",
    "Peer",
    "RangeSync",
    "Topics",
    "Transport",
]
