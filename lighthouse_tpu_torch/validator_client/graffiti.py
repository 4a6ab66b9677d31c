"""Graffiti file support (reference ``common/graffiti_file``): a
per-validator graffiti mapping reread at every proposal so operators can
edit it without restarting the VC.

Format (one entry per line)::

    default: lighthouse_tpu
    0x<pubkey-hex>: my validator 7

Values are encoded UTF-8, truncated/zero-padded to 32 bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def _to_bytes32(text: str) -> bytes:
    raw = text.strip().encode()[:32]
    return raw.ljust(32, b"\x00")


class GraffitiFile:
    def __init__(self, path):
        self.path = Path(path)

    def graffiti_for(self, pubkey: bytes) -> Optional[bytes]:
        """Mapping lookup for ``pubkey`` (falls back to ``default``);
        None when the file is missing/unreadable or has no match —
        callers then use their own default. Reread per call by design."""
        try:
            text = self.path.read_text()
        except OSError:
            return None
        default = None
        want = "0x" + bytes(pubkey).hex()
        for line in text.splitlines():
            if ":" not in line or line.lstrip().startswith("#"):
                continue
            key, _, value = line.partition(":")
            key = key.strip().lower()
            if key == "default":
                default = _to_bytes32(value)
            elif key == want:
                return _to_bytes32(value)
        return default
