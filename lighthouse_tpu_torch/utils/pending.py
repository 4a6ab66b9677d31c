"""The JAX package's host modules the port does not carry yet: the
network, the eth2 HTTP client, keys, the validator client and the
slasher (ROADMAP item 15c). A node option or a command that needs one
raises :class:`NotPortedError`, an ``ImportError`` that names the item;
the defaults never reach them."""

from __future__ import annotations

from contextlib import contextmanager

ITEM = "ROADMAP item 15c"


class NotPortedError(ImportError):
    pass


@contextmanager
def pending(module: str):
    """Turn the ``ModuleNotFoundError`` of an import of
    ``lighthouse_tpu_torch.<module>`` inside the block into a
    :class:`NotPortedError`; any other import error passes through."""
    try:
        yield
    except ModuleNotFoundError as e:
        if not (e.name or "").startswith(f"lighthouse_tpu_torch.{module}"):
            raise
        raise NotPortedError(
            f"lighthouse_tpu_torch.{module} is not ported yet ({ITEM})",
            name=e.name,
        ) from e
