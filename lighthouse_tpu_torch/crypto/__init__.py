"""BLS12-381 for the port: host constants and oracle (``params``,
``iso3_g2``, ``cpu``), the public API (``bls``) and the device stack
(``device``)."""
