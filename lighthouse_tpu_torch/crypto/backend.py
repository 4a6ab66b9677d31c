"""Runtime-selectable BLS execution backends: the port's copy of the JAX
package's registry.

The backend is a runtime choice, ``set_backend(name)`` or the
``LIGHTHOUSE_TPU_BLS_BACKEND`` environment variable. Four names:

* ``cuda`` (the default): :class:`~.device.bls.CudaBackend` on ``cuda``,
  the port's device path. On a machine without a card its first verify
  raises; it never verifies on the host in its place;
* ``cpu``: :class:`CpuBackend`, the pure-Python oracle (``cpu/bls.py``);
* ``cpu-native``: the C verifier (``crypto/native.py``);
* ``fake``: :class:`FakeBackend`, always valid but for the reference's
  edge semantics.

Backend protocol (all points are the host oracle's affine points; the
device backend converts to device tensors internally):

    verify(pk_point, message, sig_point) -> bool
    fast_aggregate_verify(pk_points, message, sig_point) -> bool
    aggregate_verify(pk_points, messages, sig_point) -> bool
    verify_signature_sets([(sig, [pk_points], message32)]) -> bool
        where ``sig`` is a bls.Signature OBJECT (possibly lazy/compressed
        — the device backend ships its raw bytes to the card) or a bare
        G2 point; an off-curve lazy signature must yield False, never an
        exception (catch bls.BlsError)
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict

from .cpu import bls as _cpu

ENV = "LIGHTHOUSE_TPU_BLS_BACKEND"
DEFAULT = "cuda"


class CpuBackend:
    """Pure-Python backend (analogue of the reference's milagro backend)."""

    name = "cpu"

    verify = staticmethod(_cpu.verify)
    fast_aggregate_verify = staticmethod(_cpu.fast_aggregate_verify)
    aggregate_verify = staticmethod(_cpu.aggregate_verify)

    @staticmethod
    def verify_signature_sets(sets) -> bool:
        # materialize lazy signatures; a non-curve x is simply invalid
        from . import bls as _bls

        raw = []
        try:
            for sig, pks, msg in sets:
                point = sig.point if isinstance(sig, _bls.Signature) else sig
                if point is None:
                    return False
                raw.append((point, pks, msg))
        except _bls.BlsError:
            return False
        return _cpu.verify_signature_sets(raw)


class FakeBackend:
    """Always-valid backend for tests that ignore crypto (reference:
    crypto/bls/src/impls/fake_crypto.rs). Keeps the reference's edge
    semantics: an empty batch / empty signing keys still fail."""

    name = "fake"

    @staticmethod
    def verify(pk, message, sig) -> bool:
        return True

    @staticmethod
    def fast_aggregate_verify(pks, message, sig) -> bool:
        return bool(pks)

    @staticmethod
    def aggregate_verify(pks, messages, sig) -> bool:
        return bool(pks) and len(pks) == len(messages)

    @staticmethod
    def verify_signature_sets(sets) -> bool:
        sets = list(sets)
        return bool(sets) and all(pks for _, pks, _ in sets)


def _cuda_backend(device=None):
    from .device.bls import CudaBackend

    return CudaBackend(device=device or "cuda")


def _native_backend(device=None):
    from .native import NativeBackend

    return NativeBackend()


# Each factory takes an optional ``device``; the host backends ignore it.
_REGISTRY: Dict[str, Callable[..., object]] = {
    "cuda": _cuda_backend,
    "cpu": lambda device=None: CpuBackend(),
    "cpu-native": _native_backend,
    "fake": lambda device=None: FakeBackend(),
}

_lock = threading.Lock()
_active = None
_active_name = None


def register(name: str, factory: Callable[..., object]) -> None:
    """Add backend ``name``; ``factory(device=None)`` builds it."""
    _REGISTRY[name] = factory


def set_backend(name: str, device=None) -> None:
    """Activate backend ``name``. ``device`` places a device backend
    (a caller asking for the CPU passes ``"cpu"``); the host backends
    ignore it."""
    global _active, _active_name
    with _lock:
        if name not in _REGISTRY:
            raise KeyError(f"unknown BLS backend {name!r}; have {sorted(_REGISTRY)}")
        _active = _REGISTRY[name](device)
        _active_name = name


def active():
    global _active, _active_name
    if _active is None:
        with _lock:
            if _active is None:
                name = os.environ.get(ENV, DEFAULT)
                _active = _REGISTRY[name]()
                _active_name = name
    return _active


def active_name() -> str:
    active()
    return _active_name
