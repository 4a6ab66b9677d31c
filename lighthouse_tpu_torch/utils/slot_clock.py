"""Slot clocks: genesis-anchored slot and epoch math, and a settable
process-global clock.

The port's own copy of the JAX package's slot clock seam (reference:
``common/slot_clock`` - ``SystemTimeSlotClock``, and ``ManualSlotClock``
for tests). The device key table reads the current epoch from
:func:`get_clock` to tag and evict its cached aggregate-pubkey rows;
replays and tests install their own clock with :func:`set_clock`.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# Mainnet constants — the defaults a clock gets when the caller does
# not say otherwise. Replays install clocks scaled to their traces.
DEFAULT_SECONDS_PER_SLOT = 12
DEFAULT_SLOTS_PER_EPOCH = 32


class SlotClock:
    def __init__(
        self,
        genesis_time: float,
        seconds_per_slot: float,
        slots_per_epoch: int = DEFAULT_SLOTS_PER_EPOCH,
    ):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self.slots_per_epoch = max(1, int(slots_per_epoch))

    def now(self) -> int:
        """Current slot (0 before genesis)."""
        return self.slot_at(self._unix_time())

    def slot_at(self, t: float) -> int:
        """Slot containing unix time ``t`` (0 before genesis) — the
        genesis-anchored resolution replays use to map a trace
        timestamp onto chain time."""
        if t < self.genesis_time:
            return 0
        return int(t - self.genesis_time) // int(self.seconds_per_slot) \
            if float(self.seconds_per_slot).is_integer() \
            else int((t - self.genesis_time) / self.seconds_per_slot)

    def epoch_of(self, slot: int) -> int:
        """Epoch containing ``slot``."""
        return int(slot) // self.slots_per_epoch

    def epoch_at(self, t: float) -> int:
        return self.epoch_of(self.slot_at(t))

    def current_epoch(self) -> int:
        return self.epoch_of(self.now())

    def first_slot_of_epoch(self, epoch: int) -> int:
        return int(epoch) * self.slots_per_epoch

    def seconds_into_slot(self) -> float:
        t = self._unix_time()
        if t < self.genesis_time:
            return 0.0
        return (t - self.genesis_time) % self.seconds_per_slot

    def start_of(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def duration_to_next_slot(self) -> float:
        return self.start_of(self.now() + 1) - self._unix_time()

    def _unix_time(self) -> float:
        return time.time()


class SystemTimeSlotClock(SlotClock):
    pass


class ManualSlotClock(SlotClock):
    """Test clock: advanced explicitly (reference ManualSlotClock)."""

    def __init__(
        self,
        genesis_time: float = 0,
        seconds_per_slot: float = 12,
        slots_per_epoch: int = DEFAULT_SLOTS_PER_EPOCH,
    ):
        super().__init__(genesis_time, seconds_per_slot, slots_per_epoch)
        self._now = float(genesis_time)

    def set_slot(self, slot: int) -> None:
        self._now = self.start_of(slot)

    def advance_slots(self, n: int = 1) -> None:
        self._now += n * self.seconds_per_slot

    def advance_seconds(self, s: float) -> None:
        self._now += s

    def _unix_time(self) -> float:
        return self._now


# ---------------------------------------------------------------------------
# Process-global clock seam
# ---------------------------------------------------------------------------
#
# The key table attributes its cached rows to "the current epoch": ONE
# clock per process, replaceable for replays and tests. The default is a
# mainnet-parameter system clock anchored at unix epoch 0, so slots are
# globally meaningful absolute numbers until something more specific is
# installed.

_clock_lock = threading.Lock()
_global_clock: Optional[SlotClock] = None


def get_clock() -> SlotClock:
    """The process-global slot clock (created lazily with mainnet
    parameters when nothing was installed)."""
    global _global_clock
    with _clock_lock:
        if _global_clock is None:
            _global_clock = SystemTimeSlotClock(
                genesis_time=0,
                seconds_per_slot=DEFAULT_SECONDS_PER_SLOT,
                slots_per_epoch=DEFAULT_SLOTS_PER_EPOCH,
            )
        return _global_clock


def set_clock(clock: Optional[SlotClock]) -> Optional[SlotClock]:
    """Install ``clock`` as the process-global slot clock (None resets
    to the lazy default); returns the previous clock so callers can
    restore it (a replay installs its clock and restores the previous one)."""
    global _global_clock
    with _clock_lock:
        prev = _global_clock
        _global_clock = clock
        return prev
