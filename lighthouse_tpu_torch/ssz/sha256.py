"""Hashing layer: batched SHA-256 over 64-byte blocks.

The analogue of the reference's ``crypto/eth2_hashing`` (runtime dispatch
between ring and SHA-NI — ``src/lib.rs:87-177``): one seam,
``hash_pairs``, through which ALL merkleization flows. Backends:

* native C (``_native/sha256.c``, the JAX package's source): SHA-NI when
  the CPU has it, portable scalar otherwise; batch-first export so Python
  pays one FFI transition per merkle tree level instead of one
  interpreter round-trip per node. Built at the first hash, never at
  import (``_native.build_and_load``);
* hashlib (OpenSSL) when the C build fails — slower per row purely from
  per-call interpreter overhead, same results.
"""

from __future__ import annotations

import ctypes as _ct
import hashlib
import threading

import numpy as np

_lib = None
_loaded = False
_load_lock = threading.Lock()


def _native():
    """The C library, or None when it cannot be built (decided once)."""
    global _lib, _loaded
    if not _loaded:
        with _load_lock:
            if not _loaded:
                from .. import _native as native_build

                try:
                    lib = native_build.build_and_load("sha256")
                    lib.sha256_hash_pairs.argtypes = [
                        _ct.c_char_p, _ct.c_char_p, _ct.c_size_t
                    ]
                    lib.sha256_oneshot.argtypes = [
                        _ct.c_char_p, _ct.c_size_t, _ct.c_char_p
                    ]
                    _lib = lib
                except (native_build.NativeBuildError, OSError, AttributeError):
                    _lib = None  # no toolchain or symbols missing: hashlib
                _loaded = True
    return _lib


def hash_bytes(data: bytes) -> bytes:
    lib = _native()
    if lib is not None:
        out = _ct.create_string_buffer(32)
        lib.sha256_oneshot(data, len(data), out)
        return out.raw
    return hashlib.sha256(data).digest()


def hash32_concat(a: bytes, b: bytes) -> bytes:
    return hash_bytes(a + b)


def _hash_pairs_hashlib(pairs: np.ndarray) -> np.ndarray:
    out = np.empty((pairs.shape[0], 32), np.uint8)
    mv = memoryview(np.ascontiguousarray(pairs)).cast("B")
    for i in range(pairs.shape[0]):
        out[i] = np.frombuffer(
            hashlib.sha256(mv[i * 64:(i + 1) * 64]).digest(), np.uint8
        )
    return out


def hash_pairs(pairs: np.ndarray) -> np.ndarray:
    """uint8[n, 64] -> uint8[n, 32]: SHA-256 of each 64-byte row.

    The merkleization hot loop: one native batch call when available.
    """
    lib = _native()
    if lib is not None:
        n = pairs.shape[0]
        pairs = np.ascontiguousarray(pairs)
        out = np.empty((n, 32), np.uint8)
        lib.sha256_hash_pairs(
            pairs.ctypes.data_as(_ct.c_char_p),
            out.ctypes.data_as(_ct.c_char_p),
            n,
        )
        return out
    return _hash_pairs_hashlib(pairs)


# Zero-subtree hashes: ZERO_HASHES[d] = root of an all-zero depth-d tree
# (hashlib at import: nothing is built then; the bytes are the same).
ZERO_HASHES = [bytes(32)]
for _ in range(64):
    ZERO_HASHES.append(hashlib.sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]).digest())
