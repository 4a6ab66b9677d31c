"""Pure-Python host oracle for BLS12-381: fields, curves, hash-to-G2.

The port's own trimmed copy of the JAX package's host oracle. It signs
for the host side of tests and of ``chip_smoke.py`` and supplies the
constants the device stack embeds.
"""

from .fields import Fq, Fq2  # noqa: F401
from .curve import G1Point, G2Point, g1_generator, g2_generator  # noqa: F401
