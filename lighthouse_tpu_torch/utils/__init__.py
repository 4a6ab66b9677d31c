"""Host utilities (jax-free copies of the JAX package's ``utils/``): the
slot clock, metrics, the lockfile and the telemetry the device modules
read."""

from .lockfile import Lockfile, LockfileError
from .slot_clock import ManualSlotClock, SlotClock, SystemTimeSlotClock
from . import metrics

__all__ = [
    "Lockfile",
    "LockfileError",
    "ManualSlotClock",
    "SlotClock",
    "SystemTimeSlotClock",
    "metrics",
]
