"""Columnar per-epoch processing: numpy vector passes over
:class:`~.columns.Columns`, exactly mirroring the scalar spec functions
in ``state_transition/epoch.py`` (which remain the oracle — the
differential suite in ``tests/test_epoch_columnar.py`` pins scalar ==
columnar on randomized states).

Reference analogue: ``consensus/state_processing/src/per_epoch_processing/``
(base + altair), which runs the same passes as compiled per-validator
loops; here each pass is O(1) numpy kernels over the full registry, the
same shape a jnp/device tier would consume.

Fallback discipline: every :class:`Fallback` raise happens BEFORE the
first state mutation (all preconditions are pure reads), so the caller
can always rerun the scalar path from scratch.
"""

from __future__ import annotations

import numpy as np

from ...types.chain_spec import ChainSpec, FAR_FUTURE_EPOCH
from ...types.preset import Preset
from .columns import (
    FF_U64,
    FINALITY_DELAY_LIMIT,
    SCORE_LIMIT,
    Columns,
    Fallback,
)

_GENESIS_EPOCH = 0
_BASE_REWARDS_PER_EPOCH = 4


def _flag_mask(participation: np.ndarray, flag_index: int) -> np.ndarray:
    return (participation >> np.uint8(flag_index)) & np.uint8(1) != 0


def process_epoch_columnar(preset: Preset, spec: ChainSpec, state) -> None:
    """Full process_epoch over columnar views. Raises :class:`Fallback`
    (state untouched) when preconditions fail; otherwise leaves the state
    bit-identical to the scalar ``process_epoch``."""
    from .. import epoch as sc  # scalar module: shared cheap passes + helpers
    from ..helpers import get_current_epoch, get_previous_epoch

    fork = sc.fork_of(state)
    cols = Columns.from_state(state)
    n = cols.n
    cur = get_current_epoch(preset, state)
    prev = get_previous_epoch(preset, state)

    active_prev = cols.active_mask(prev)
    active_cur = cols.active_mask(cur)
    total = cols.total_active_balance(preset, cur)
    eligible = active_prev | (
        cols.slashed & (np.uint64(prev + 1) < cols.wd)
    )

    if fork == "phase0":
        pre = _phase0_precompute(preset, state, cols, prev, cur)
        scores = None
        prev_part = cur_part = None
    else:
        try:
            prev_part = np.fromiter(
                state.previous_epoch_participation, np.uint8, count=n
            )
            cur_part = np.fromiter(
                state.current_epoch_participation, np.uint8, count=n
            )
            scores = np.fromiter(state.inactivity_scores, np.int64, count=n)
        except (OverflowError, ValueError) as e:
            raise Fallback(str(e)) from e
        # score growth this epoch is bounded by +bias; check the post bound
        if n and int(scores.max()) + spec.inactivity_score_bias >= SCORE_LIMIT:
            raise Fallback("inactivity scores exceed exact-int64 bounds")
        pre = None

    # ---- remaining pure precondition checks (Fallback contract: nothing
    # below may raise Fallback once the first mutation lands) -------------
    # Post-justification finality delay can only be <= the pre-state value
    # (finalized_epoch is monotone within the pass), so the pre-state
    # bound is conservative.
    if prev - state.finalized_checkpoint.epoch >= FINALITY_DELAY_LIMIT:
        raise Fallback("finality delay exceeds exact-int64 bounds")
    if cur != _GENESIS_EPOCH:
        if fork == "phase0":
            _check_phase0_reward_bounds(preset, cols, pre, total)
        else:
            _check_altair_reward_bounds(preset, cols, active_prev, prev_part, total)

    # ---- justification & finalization (mutates checkpoints/bits) ---------
    if cur > _GENESIS_EPOCH + 1:
        if fork == "phase0":
            prev_bal = cols.sum_effective(
                preset, pre["target_att"] & ~cols.slashed
            )
            cur_bal = cols.sum_effective(
                preset, pre["target_att_cur"] & ~cols.slashed
            )
        else:
            unslashed_prev_tgt = (
                active_prev & ~cols.slashed & _flag_mask(prev_part, sc.TIMELY_TARGET_FLAG_INDEX)
            )
            unslashed_cur_tgt = (
                active_cur & ~cols.slashed & _flag_mask(cur_part, sc.TIMELY_TARGET_FLAG_INDEX)
            )
            prev_bal = cols.sum_effective(preset, unslashed_prev_tgt)
            cur_bal = cols.sum_effective(preset, unslashed_cur_tgt)
        sc._weigh_justification_and_finalization(preset, state, prev_bal, cur_bal)

    # finality delay / leak read the JUST-UPDATED finalized checkpoint,
    # matching the scalar pass order (bound pre-checked above).
    finality_delay = prev - state.finalized_checkpoint.epoch
    in_leak = finality_delay > preset.MIN_EPOCHS_TO_INACTIVITY_PENALTY

    # ---- rewards & penalties --------------------------------------------
    if fork == "phase0":
        if cur != _GENESIS_EPOCH:
            rewards, penalties = _phase0_deltas(
                preset, cols, pre, total, eligible, in_leak, finality_delay
            )
            cols.balances = np.maximum(cols.balances + rewards - penalties, 0)
    else:
        if cur != _GENESIS_EPOCH:
            unslashed_prev_tgt = (
                active_prev & ~cols.slashed & _flag_mask(prev_part, sc.TIMELY_TARGET_FLAG_INDEX)
            )
            # inactivity updates first (rewards read the updated scores)
            scores = _inactivity_updates(
                spec, scores, eligible, unslashed_prev_tgt, in_leak
            )
            state.inactivity_scores = scores.tolist()
            rewards, penalties = _altair_deltas(
                preset, spec, cols, fork, total, eligible, active_prev,
                prev_part, unslashed_prev_tgt, scores, in_leak,
            )
            cols.balances = np.maximum(cols.balances + rewards - penalties, 0)

    # ---- registry / slashings / effective balances -----------------------
    _registry_updates(preset, spec, state, cols, cur, active_cur)
    _process_slashings(preset, state, cols, fork, cur, total)
    sc.process_eth1_data_reset(preset, state)
    _effective_balance_updates(preset, cols)
    cols.write_balances(state)
    sc.process_slashings_reset(preset, state)
    sc.process_randao_mixes_reset(preset, state)
    sc.process_historical_roots_update(preset, state)
    if fork == "phase0":
        state.previous_epoch_attestations = state.current_epoch_attestations
        state.current_epoch_attestations = []
    else:
        state.previous_epoch_participation = state.current_epoch_participation
        state.current_epoch_participation = [0] * n
        sc.process_sync_committee_updates(preset, state)


def altair_reward_components(preset: Preset, spec: ChainSpec, state) -> dict:
    """Per-validator PREVIOUS-epoch attestation reward components for the
    Beacon API rewards endpoint (reference ``http_api`` attestation
    rewards; computed with the same columnar kernels as the live epoch
    transition). Pure: works on an internal copy.

    Returns arrays (len = validator count): ``source``/``target``/``head``
    (signed: reward if participating, -penalty if not), ``inactivity``
    (<= 0), plus ``eligible`` (bool) and ``ideal`` — a map of effective
    balance -> ideal (full-participation) source/target/head rewards."""
    import copy as _copy

    from .. import epoch as sc
    from ..helpers import get_current_epoch, get_previous_epoch, integer_squareroot

    st = _copy.deepcopy(state)
    cols = Columns.from_state(st)
    n = cols.n
    cur = get_current_epoch(preset, st)
    prev = get_previous_epoch(preset, st)
    active_prev = cols.active_mask(prev)
    active_cur = cols.active_mask(cur)
    total = cols.total_active_balance(preset, cur)
    eligible = active_prev | (cols.slashed & (np.uint64(prev + 1) < cols.wd))
    prev_part = np.fromiter(st.previous_epoch_participation, np.uint8, count=n)
    cur_part = np.fromiter(st.current_epoch_participation, np.uint8, count=n)
    scores = np.fromiter(st.inactivity_scores, np.int64, count=n)

    # replicate the pass order on the copy: justification first (the leak
    # flag reads the updated finalized checkpoint), then score updates
    if cur > _GENESIS_EPOCH + 1:
        unslashed_prev_tgt = (
            active_prev & ~cols.slashed & _flag_mask(prev_part, sc.TIMELY_TARGET_FLAG_INDEX)
        )
        unslashed_cur_tgt = (
            active_cur & ~cols.slashed & _flag_mask(cur_part, sc.TIMELY_TARGET_FLAG_INDEX)
        )
        sc._weigh_justification_and_finalization(
            preset, st,
            cols.sum_effective(preset, unslashed_prev_tgt),
            cols.sum_effective(preset, unslashed_cur_tgt),
        )
    finality_delay = prev - st.finalized_checkpoint.epoch
    in_leak = finality_delay > preset.MIN_EPOCHS_TO_INACTIVITY_PENALTY
    unslashed_prev_tgt = (
        active_prev & ~cols.slashed & _flag_mask(prev_part, sc.TIMELY_TARGET_FLAG_INDEX)
    )
    scores = _inactivity_updates(spec, scores, eligible, unslashed_prev_tgt, in_leak)

    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    base_per_increment = inc * preset.BASE_REWARD_FACTOR // integer_squareroot(total)
    base = (cols.eff // inc) * base_per_increment
    active_increments = total // inc
    out = {"eligible": eligible, "ideal": {}}
    names = {0: "source", 1: "target", 2: "head"}
    distinct_eff = sorted({int(e) for e in cols.eff[eligible]}) if n else []
    for eff in distinct_eff:
        out["ideal"][eff] = {}
    for flag_index, weight in enumerate(sc.PARTICIPATION_FLAG_WEIGHTS):
        unslashed = active_prev & ~cols.slashed & _flag_mask(prev_part, flag_index)
        ui = cols.sum_effective(preset, unslashed) // inc
        comp = np.zeros(n, np.int64)
        if not in_leak:
            numerator = base * (weight * ui)
            comp[unslashed] = numerator[unslashed] // (
                active_increments * sc.WEIGHT_DENOMINATOR
            )
        if flag_index != sc.TIMELY_HEAD_FLAG_INDEX:
            miss = eligible & ~unslashed
            comp[miss] = -((base[miss] * weight) // sc.WEIGHT_DENOMINATOR)
        out[names[flag_index]] = comp
        for eff in distinct_eff:
            b = eff // inc * base_per_increment
            out["ideal"][eff][names[flag_index]] = (
                0 if in_leak else b * weight * ui // (active_increments * sc.WEIGHT_DENOMINATOR)
            )
    quotient = (
        preset.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
        if sc.fork_of(st) == "altair"
        else preset.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
    )
    inact = np.zeros(n, np.int64)
    miss_tgt = eligible & ~unslashed_prev_tgt
    inact[miss_tgt] = -(
        (cols.eff[miss_tgt] * scores[miss_tgt]) // (spec.inactivity_score_bias * quotient)
    )
    out["inactivity"] = inact
    return out


# ---------------------------------------------------------------------------
# pure pre-mutation bound checks (Fallback may only come from these)
# ---------------------------------------------------------------------------

def _check_altair_reward_bounds(
    preset: Preset, cols: Columns, active_prev: np.ndarray,
    prev_part: np.ndarray, total: int,
) -> None:
    from .. import epoch as sc
    from ..helpers import integer_squareroot

    if not cols.n:
        return
    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    base_per_increment = inc * preset.BASE_REWARD_FACTOR // integer_squareroot(total)
    base_max = int(cols.eff.max()) // inc * base_per_increment  # base monotone in eff
    for flag_index, weight in enumerate(sc.PARTICIPATION_FLAG_WEIGHTS):
        unslashed = active_prev & ~cols.slashed & _flag_mask(prev_part, flag_index)
        ui = cols.sum_effective(preset, unslashed) // inc
        if base_max * weight * max(ui, 1) >= (1 << 62):
            raise Fallback("altair reward product exceeds int64")


def _check_phase0_reward_bounds(
    preset: Preset, cols: Columns, pre: dict, total: int
) -> None:
    from ..helpers import integer_squareroot

    if not cols.n:
        return
    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    base_max = (
        int(cols.eff.max())
        * preset.BASE_REWARD_FACTOR
        // integer_squareroot(total)
        // _BASE_REWARDS_PER_EPOCH
    )
    for name in ("source_att", "target_att", "head_att"):
        ai = cols.sum_effective(preset, pre[name] & ~cols.slashed) // inc
        if base_max * max(ai, 1) >= (1 << 62):
            raise Fallback("phase0 reward product exceeds int64")


# ---------------------------------------------------------------------------
# altair passes
# ---------------------------------------------------------------------------

def _inactivity_updates(
    spec: ChainSpec,
    scores: np.ndarray,
    eligible: np.ndarray,
    unslashed_prev_tgt: np.ndarray,
    in_leak: bool,
) -> np.ndarray:
    out = scores.copy()
    hit = eligible & unslashed_prev_tgt
    miss = eligible & ~unslashed_prev_tgt
    out[hit] -= np.minimum(1, out[hit])
    out[miss] += spec.inactivity_score_bias
    if not in_leak:
        out[eligible] -= np.minimum(
            spec.inactivity_score_recovery_rate, out[eligible]
        )
    return out


def _altair_deltas(
    preset: Preset,
    spec: ChainSpec,
    cols: Columns,
    fork: str,
    total: int,
    eligible: np.ndarray,
    active_prev: np.ndarray,
    prev_part: np.ndarray,
    unslashed_prev_tgt: np.ndarray,
    scores: np.ndarray,
    in_leak: bool,
):
    from .. import epoch as sc
    from ..helpers import integer_squareroot

    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    base_per_increment = inc * preset.BASE_REWARD_FACTOR // integer_squareroot(total)
    base = (cols.eff // inc) * base_per_increment
    active_increments = total // inc
    rewards = np.zeros(cols.n, np.int64)
    penalties = np.zeros(cols.n, np.int64)

    # int64-exactness: base <= (eff//inc)*inc*64/sqrt(total) <= 64*sqrt(total)
    # * (eff_max/total)... bounded directly instead:
    base_max = int(base.max()) if cols.n else 0

    for flag_index, weight in enumerate(sc.PARTICIPATION_FLAG_WEIGHTS):
        unslashed = active_prev & ~cols.slashed & _flag_mask(prev_part, flag_index)
        unslashed_increments = cols.sum_effective(preset, unslashed) // inc
        # pre-checked by _check_altair_reward_bounds; corruption-proof crash
        # is preferable to a post-mutation Fallback here
        assert base_max * weight * max(unslashed_increments, 1) < (1 << 62)
        if not in_leak:
            numerator = base * (weight * unslashed_increments)
            rewards[unslashed] += numerator[unslashed] // (
                active_increments * sc.WEIGHT_DENOMINATOR
            )
        if flag_index != sc.TIMELY_HEAD_FLAG_INDEX:
            miss = eligible & ~unslashed
            penalties[miss] += (base[miss] * weight) // sc.WEIGHT_DENOMINATOR

    quotient = (
        preset.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
        if fork == "altair"
        else preset.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
    )
    miss_tgt = eligible & ~unslashed_prev_tgt
    # eff < 2^36 and scores < 2^25 (guarded) => product < 2^61
    penalty_numerator = cols.eff[miss_tgt] * scores[miss_tgt]
    penalties[miss_tgt] += penalty_numerator // (
        spec.inactivity_score_bias * quotient
    )
    return rewards, penalties


# ---------------------------------------------------------------------------
# phase0 passes
# ---------------------------------------------------------------------------

def _phase0_precompute(preset: Preset, state, cols: Columns, prev: int, cur: int):
    """Pure precomputation of attester masks from pending attestations.

    Builds, per matching category, a bool[n] attester mask, plus the
    per-validator best (lowest inclusion-delay, earliest in list order)
    source attestation's delay and proposer. One CommitteeCache per epoch
    (the scalar path's per-attestation cache rebuild is the main reason
    it cannot scale)."""
    from ..epoch import _matching_attestations
    from ..helpers import (
        CommitteeCache,
        get_block_root,
        get_block_root_at_slot,
    )

    n = cols.n
    out = {
        "source_att": np.zeros(n, bool),
        "target_att": np.zeros(n, bool),
        "head_att": np.zeros(n, bool),
        "target_att_cur": np.zeros(n, bool),
    }

    caches: dict[int, CommitteeCache] = {}

    def attesters(a, epoch):
        cache = caches.get(epoch)
        if cache is None:
            cache = caches[epoch] = CommitteeCache(preset, state, epoch)
        committee = cache.committee(int(a.data.slot), int(a.data.index))
        bits = np.fromiter(a.aggregation_bits, bool, count=len(a.aggregation_bits))
        if len(bits) != len(committee):
            raise Fallback("aggregation bits length != committee size")
        return committee[bits]

    # current-epoch target attesters (justification only)
    cur_target_root = get_block_root(preset, state, cur)
    for a in _matching_attestations(preset, state, cur):
        if bytes(a.data.target.root) == bytes(cur_target_root):
            out["target_att_cur"][attesters(a, cur)] = True

    prev_target_root = get_block_root(preset, state, prev)
    atts = list(_matching_attestations(preset, state, prev))
    if len(atts) >= 1 << 20:
        raise Fallback("too many pending attestations for keyed min trick")

    # per-validator best source attestation: min over (delay, list position)
    best_key = np.full(n, np.iinfo(np.int64).max, np.int64)
    att_proposer = np.zeros(max(len(atts), 1), np.int64)
    att_delay = np.zeros(max(len(atts), 1), np.int64)
    for pos, a in enumerate(atts):
        who = attesters(a, prev)
        out["source_att"][who] = True
        delay = int(a.inclusion_delay)
        if not 1 <= delay < (1 << 20):
            # <1 would divide by zero; huge values would overflow the
            # int64 keyed-min trick below — scalar big-ints handle both
            raise Fallback("inclusion delay outside keyed-min range")
        att_proposer[pos] = int(a.proposer_index)
        att_delay[pos] = delay
        np.minimum.at(best_key, who, delay * (1 << 20) + pos)
        is_target = bytes(a.data.target.root) == bytes(prev_target_root)
        if is_target:
            out["target_att"][who] = True
            if bytes(a.data.beacon_block_root) == bytes(
                get_block_root_at_slot(preset, state, int(a.data.slot))
            ):
                out["head_att"][who] = True

    out["best_att_pos"] = best_key % (1 << 20)
    out["att_proposer"] = att_proposer
    out["att_delay"] = att_delay
    return out


def _phase0_deltas(
    preset: Preset,
    cols: Columns,
    pre: dict,
    total: int,
    eligible: np.ndarray,
    in_leak: bool,
    finality_delay: int,
):
    from ..helpers import integer_squareroot

    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    base = (
        cols.eff * preset.BASE_REWARD_FACTOR
        // integer_squareroot(total)
        // _BASE_REWARDS_PER_EPOCH
    )
    base_max = int(base.max()) if cols.n else 0
    rewards = np.zeros(cols.n, np.int64)
    penalties = np.zeros(cols.n, np.int64)

    for name in ("source_att", "target_att", "head_att"):
        unslashed = pre[name] & ~cols.slashed
        attesting_balance = cols.sum_effective(preset, unslashed)
        attesting_increments = attesting_balance // inc
        # pre-checked by _check_phase0_reward_bounds
        assert base_max * max(attesting_increments, 1) < (1 << 62)
        hit = eligible & unslashed
        if in_leak:
            rewards[hit] += base[hit]
        else:
            rewards[hit] += (base[hit] * attesting_increments) // (total // inc)
        miss = eligible & ~unslashed
        penalties[miss] += base[miss]

    # inclusion delay: unslashed source attesters reward themselves (scaled
    # by 1/delay) and the including block's proposer.
    src = pre["source_att"] & ~cols.slashed
    idx = np.nonzero(src)[0]
    if len(idx):
        pos = pre["best_att_pos"][idx]
        proposer_reward = base[idx] // preset.PROPOSER_REWARD_QUOTIENT
        np.add.at(rewards, pre["att_proposer"][pos], proposer_reward)
        max_attester = base[idx] - proposer_reward
        rewards[idx] += max_attester // pre["att_delay"][pos]

    if in_leak:
        penalties[eligible] += (
            _BASE_REWARDS_PER_EPOCH * base[eligible]
            - base[eligible] // preset.PROPOSER_REWARD_QUOTIENT
        )
        tgt_unslashed = pre["target_att"] & ~cols.slashed
        miss = eligible & ~tgt_unslashed
        # eff < 2^36, delay < 2^24 (guarded) => product < 2^60
        penalties[miss] += (
            cols.eff[miss] * finality_delay // preset.INACTIVITY_PENALTY_QUOTIENT
        )
    return rewards, penalties


# ---------------------------------------------------------------------------
# shared tail passes (registry / slashings / effective balances)
# ---------------------------------------------------------------------------

def _registry_updates(
    preset: Preset, spec: ChainSpec, state, cols: Columns, cur: int,
    active_cur: np.ndarray,
) -> None:
    from ..helpers import compute_activation_exit_epoch

    # activation-queue eligibility marking
    newly_eligible = (cols.act_elig == FF_U64) & (
        cols.eff == preset.MAX_EFFECTIVE_BALANCE
    )
    for i in np.nonzero(newly_eligible)[0]:
        cols.vals[i].activation_eligibility_epoch = cur + 1
    cols.act_elig[newly_eligible] = np.uint64(cur + 1)

    churn_limit = max(
        spec.min_per_epoch_churn_limit,
        int(active_cur.sum()) // spec.churn_limit_quotient,
    )

    # ejections (sequential exit-queue assignment over the few hits,
    # replicating initiate_validator_exit's fresh max/count per call)
    eject = active_cur & (cols.eff <= spec.ejection_balance) & (cols.exit == FF_U64)
    eject_idx = np.nonzero(eject)[0]
    if len(eject_idx):
        exited = cols.exit != FF_U64
        exit_queue_epoch = compute_activation_exit_epoch(preset, cur)
        if exited.any():
            exit_queue_epoch = max(exit_queue_epoch, int(cols.exit[exited].max()))
        churn = int((cols.exit == np.uint64(exit_queue_epoch)).sum())
        delay = spec.min_validator_withdrawability_delay
        for i in eject_idx:
            if churn >= churn_limit:
                exit_queue_epoch += 1
                churn = 0
            v = cols.vals[i]
            v.exit_epoch = exit_queue_epoch
            v.withdrawable_epoch = exit_queue_epoch + delay
            cols.exit[i] = np.uint64(exit_queue_epoch)
            cols.wd[i] = np.uint64(exit_queue_epoch + delay)
            churn += 1

    # activation queue: ordered by (eligibility epoch, index), churn-limited
    cand = (cols.act_elig <= np.uint64(state.finalized_checkpoint.epoch)) & (
        cols.act == FF_U64
    )
    ci = np.nonzero(cand)[0]
    if len(ci):
        order = np.lexsort((ci, cols.act_elig[ci]))
        activation_epoch = compute_activation_exit_epoch(preset, cur)
        for i in ci[order][:churn_limit]:
            cols.vals[i].activation_epoch = activation_epoch
            cols.act[i] = np.uint64(activation_epoch)


def _process_slashings(
    preset: Preset, state, cols: Columns, fork: str, cur: int, total: int
) -> None:
    mult = {
        "phase0": preset.PROPORTIONAL_SLASHING_MULTIPLIER,
        "altair": preset.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR,
        "bellatrix": preset.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX,
    }[fork]
    adjusted = min(sum(state.slashings) * mult, total)
    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    mask = cols.slashed & (
        np.uint64(cur + preset.EPOCHS_PER_SLASHINGS_VECTOR // 2) == cols.wd
    )
    if mask.any():
        # (eff//inc) * adjusted can brush 2^64 at the guard bounds, and the
        # hit set is tiny (slashed validators at their mid-withdrawability
        # epoch) — compute these few penalties with exact python ints.
        penalty = np.fromiter(
            (
                int(e) // inc * adjusted // total * inc
                for e in cols.eff[mask]
            ),
            np.int64,
            count=int(mask.sum()),
        )
        cols.balances[mask] = np.maximum(cols.balances[mask] - penalty, 0)


def _effective_balance_updates(preset: Preset, cols: Columns) -> None:
    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    hysteresis = inc // preset.HYSTERESIS_QUOTIENT
    down = hysteresis * preset.HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis * preset.HYSTERESIS_UPWARD_MULTIPLIER
    mask = (cols.balances + down < cols.eff) | (cols.eff + up < cols.balances)
    if mask.any():
        new_eff = np.minimum(
            cols.balances - cols.balances % inc, preset.MAX_EFFECTIVE_BALANCE
        )
        for i in np.nonzero(mask)[0]:
            cols.vals[i].effective_balance = int(new_eff[i])
        cols.eff[mask] = new_eff[mask]
