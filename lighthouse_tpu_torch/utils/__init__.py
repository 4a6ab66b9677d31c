"""Host utilities the port's device modules read (jax-free copies)."""
