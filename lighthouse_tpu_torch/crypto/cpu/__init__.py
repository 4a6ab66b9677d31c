"""Pure-Python host oracle for BLS12-381: fields, curves, hash-to-G2, the
pairing and the signature scheme.

The port's own copy of the JAX package's host oracle. It is the ``cpu``
entry of the backend registry (``crypto/backend.py``), signs for the host
side of tests and of ``chip_smoke.py`` and supplies the constants the
device stack embeds. Not constant-time: the node only verifies public
data on this path.
"""

from .fields import Fq, Fq2, Fq6, Fq12  # noqa: F401
from .curve import G1Point, G2Point, g1_generator, g2_generator  # noqa: F401
