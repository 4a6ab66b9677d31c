"""Structure-of-arrays view of the validator registry + balances.

One extraction pass over ``state.validators`` yields int64/uint64/bool
columns; every epoch-processing pass then runs as numpy vector ops. All
arithmetic here is exact integer math: the extraction asserts value
bounds under which every downstream product provably fits int64, and
raises :class:`Fallback` otherwise so the caller can take the scalar
(python big-int) path instead. Mirrors the layout of the reference's
``BeaconState`` validator vectors (``consensus/types/src/beacon_state.rs``)
rather than its per-validator struct iteration.
"""

from __future__ import annotations

import numpy as np

from ...types.chain_spec import FAR_FUTURE_EPOCH

FF_U64 = np.uint64(FAR_FUTURE_EPOCH)

# Bounds under which every product computed by the columnar passes fits
# int64 (see the per-pass derivations in epoch.py). Real networks sit
# orders of magnitude below all of them.
EFF_BALANCE_LIMIT = 1 << 36      # max effective balance (gwei); mainnet max 32e9 < 2^35
BALANCE_LIMIT = 1 << 62          # max balance (gwei)
SCORE_LIMIT = 1 << 25            # max inactivity score (eff * score < 2^61)
TOTAL_BALANCE_LIMIT = 1 << 58    # max total active balance (adjusted * (eff//inc) < 2^63)
FINALITY_DELAY_LIMIT = 1 << 24   # max finality delay (eff * delay < 2^60)


class Fallback(Exception):
    """Columnar preconditions not met — caller must use the scalar path.

    Raised only from pure (non-mutating) precondition checks, so the
    state is guaranteed untouched when it propagates.
    """


class Columns:
    """Columnar registry view. Mutating passes keep the arrays and the
    underlying validator objects in sync (arrays are authoritative
    mid-epoch; objects are written through immediately for the sparse
    fields and wholesale for balances at the end)."""

    __slots__ = (
        "n", "vals", "eff", "slashed", "act_elig", "act", "exit", "wd", "balances",
    )

    @classmethod
    def from_state(cls, state) -> "Columns":
        vals = state.validators
        n = len(vals)
        c = cls()
        c.n = n
        c.vals = vals
        try:
            c.eff = np.fromiter(
                (v.effective_balance for v in vals), np.int64, count=n
            )
            c.balances = np.fromiter(state.balances, np.int64, count=n)
        except OverflowError as e:  # value >= 2^63: scalar big-int territory
            raise Fallback(str(e)) from e
        c.slashed = np.fromiter((bool(v.slashed) for v in vals), bool, count=n)
        c.act_elig = np.fromiter(
            (v.activation_eligibility_epoch for v in vals), np.uint64, count=n
        )
        c.act = np.fromiter((v.activation_epoch for v in vals), np.uint64, count=n)
        c.exit = np.fromiter((v.exit_epoch for v in vals), np.uint64, count=n)
        c.wd = np.fromiter(
            (v.withdrawable_epoch for v in vals), np.uint64, count=n
        )
        if n and (
            int(c.eff.max()) >= EFF_BALANCE_LIMIT
            or int(c.balances.max()) >= BALANCE_LIMIT
        ):
            raise Fallback("balance columns exceed exact-int64 bounds")
        return c

    def active_mask(self, epoch: int) -> np.ndarray:
        e = np.uint64(epoch)
        return (self.act <= e) & (e < self.exit)

    def total_active_balance(self, preset, epoch: int) -> int:
        """Spec get_total_active_balance (floored at one increment)."""
        total = int(self.eff[self.active_mask(epoch)].sum())
        total = max(preset.EFFECTIVE_BALANCE_INCREMENT, total)
        if total >= TOTAL_BALANCE_LIMIT:
            raise Fallback("total active balance exceeds exact-int64 bounds")
        return total

    def sum_effective(self, preset, mask: np.ndarray) -> int:
        """Spec get_total_balance over a mask (floored at one increment)."""
        return max(
            preset.EFFECTIVE_BALANCE_INCREMENT, int(self.eff[mask].sum())
        )

    def write_balances(self, state) -> None:
        state.balances = self.balances.tolist()
