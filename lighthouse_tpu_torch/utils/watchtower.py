"""The watchtower: online anomaly detection over the node's own
timeseries, with latched incidents and correlated forensic bundles.

Every instrument the node grew so far — metrics/spans, the flight
recorder, the timeseries store + capacity estimator, the
pipeline profiler, the slot ledger — is a dial a HUMAN
reads after the fact. This module is the thing that watches them: a
background evaluator walks a declared **detector catalogue**
(:data:`DETECTORS`, linted like ``EVENT_KINDS``) over the timeseries
store and the slot ledger, and a firing detector latches an
**incident** plus one correlated forensic capture, turning the
one-off "headroom crossed its floor 2.5 s before the first miss
burst" reading into a standing, self-certifying alarm (the always-on
verification posture of the FPGA verification-engine monitor plane,
PAPERS.md arxiv 2112.02229).

* **Detector catalogue** — each detector declares name, input series
  (a ``series:<family>`` read from the timeseries store, or a
  ``probe:<name>`` computed from the registry / slot ledger), window,
  threshold, and severity (``info``/``warn``/``page``). Algorithms:
  ``zscore`` (rolling-window drift baseline: deviation must clear BOTH
  ``threshold`` standard deviations and an absolute ``min_delta`` —
  a flat baseline cannot page on noise), ``floor``/``ceil`` (level
  crossing with a hysteresis ``clear`` level), ``roc`` (rate of
  change per second over the window). The catalogue is sorted,
  snake_case, and every detector is documented in
  docs/OBSERVABILITY.md — all linted by
  tests/test_zgate4_metrics_lint.py.
* **Latched incidents, not spam.** A breach must persist ``sustain``
  consecutive evaluations to open an incident; a sustained breach is
  ONE incident with a growing duration; clearing enters a cooldown
  during which a re-breach REOPENS the same incident (a flap, not a
  new row). The ledger is bounded (``max_incidents``; old rows
  evicted, never reallocated).
* **Correlated capture.** Opening an incident writes one
  atomically-written JSON bundle (schema :data:`SCHEMA` =
  ``lighthouse_tpu.incident/1``): the flight-recorder tail, the
  relevant timeseries windows (± ``margin_s``), the newest slot
  report cards, pipeline-profiler attribution, the capacity block,
  any registered health provider's document, and the detector's own
  trigger trace (value, baseline, gate). Resolution atomically
  rewrites the same bundle so the post-margin window and the final
  duration land in the artifact. ``tools/incident_report.py`` renders
  a bundle into a human timeline; ``tools/forensics_report.py`` and
  ``tools/slot_report.py`` accept the same artifact.

Surfaces: ``GET /lighthouse/incidents``, the ``watchtower`` block of
``/lighthouse/health`` (per-detector state
``armed``/``firing``/``latched``/``cooldown``), ``watchtower_*``
metric families, ``incident_opened``/``incident_resolved`` journal
kinds, and ``tools/traffic_replay.py --watchtower`` which measures
**detection lead time** (incident-open vs the first deadline-miss
burst) as a first-class replay output.

Design constraints (the house observability discipline):

* torch-free at import (tools read bundles offline).
* DISABLED :func:`evaluate` costs well under 1 µs — one global check,
  no allocation (pinned like disabled spans).
* Thread-safe: detector/incident state mutates under one lock; any
  number of threads may call :func:`evaluate` while writers hammer
  the store. Journal writes and bundle I/O happen OUTSIDE the lock.

Env knobs (read at import; :func:`configure` overrides at runtime):

    LIGHTHOUSE_TPU_WATCHTOWER        1|0   evaluation enabled (default 1)
    LIGHTHOUSE_TPU_WT_INTERVAL_S     float evaluator period (default 2)
    LIGHTHOUSE_TPU_WT_COOLDOWN_S     float post-resolve reopen window (30)
    LIGHTHOUSE_TPU_WT_MAX_INCIDENTS  int   incident ledger bound (64)
    LIGHTHOUSE_TPU_WT_BUNDLE         1|0   write incident bundles (1)
    LIGHTHOUSE_TPU_WT_BUNDLE_DIR     path  bundle directory (tempdir)
    LIGHTHOUSE_TPU_WT_BUNDLE_RETAIN  int   newest bundles kept (8)
    LIGHTHOUSE_TPU_WT_MARGIN_S       float timeseries pre/post margin (10)
    LIGHTHOUSE_TPU_WT_FLIGHT_TAIL    int   journal events per bundle (256)
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from . import flight_recorder, metrics, slot_ledger, timeseries

SCHEMA = "lighthouse_tpu.incident/1"
BUNDLE_PREFIX = "lighthouse_tpu_incident_"

SEVERITIES = ("info", "warn", "page")
ALGOS = ("ceil", "floor", "roc", "zscore")
# the per-detector lifecycle /lighthouse/health shows; the gauge code
# for watchtower_detector_state uses the same order (armed=0 firing=1
# latched=2 cooldown=3)
STATES = ("armed", "firing", "latched", "cooldown")
_STATE_CODE = {s: i for i, s in enumerate(STATES)}
# "worst across labels" ordering for the health roll-up (an actively
# breaching label outranks a latched one outranks a cooling one)
_STATE_RANK = {"armed": 0, "cooldown": 1, "latched": 2, "firing": 3}

_env_int = flight_recorder._env_int
_env_float = flight_recorder._env_float


# ---------------------------------------------------------------------------
# The detector catalogue: sorted, snake_case, every entry documented in
# docs/OBSERVABILITY.md (linted by tests/test_zgate4_metrics_lint.py —
# an undeclared detector cannot silently appear)
# ---------------------------------------------------------------------------


class DetectorSpec:
    __slots__ = ("name", "algo", "source", "window_s", "threshold",
                 "clear", "direction", "min_points", "min_delta",
                 "sustain", "severity", "doc")

    def __init__(self, name: str, algo: str, source: str, window_s: float,
                 threshold: float, severity: str, doc: str,
                 clear: Optional[float] = None, direction: str = "above",
                 min_points: int = 4, min_delta: float = 0.0,
                 sustain: int = 1):
        self.name = name
        self.algo = algo
        self.source = source
        self.window_s = window_s
        self.threshold = threshold
        self.clear = clear
        self.direction = direction
        self.min_points = min_points
        self.min_delta = min_delta
        self.sustain = sustain
        self.severity = severity
        self.doc = doc


DETECTORS: Tuple[DetectorSpec, ...] = (
    DetectorSpec(
        "bubble_share_jump", "zscore",
        "series:capacity_shard_bubble_ratio",
        window_s=300.0, threshold=4.0, min_points=8, min_delta=0.15,
        sustain=2, severity="warn",
        doc="a shard's pipeline bubble share jumping out of its own "
            "recent baseline — overlap lost to serialized flushes",
    ),
    DetectorSpec(
        "first_sighting_hit_regression", "floor",
        "series:slot_first_sighting_hit_ratio",
        window_s=900.0, threshold=0.9, clear=0.97, min_points=1,
        sustain=2, severity="warn",
        doc="the per-epoch committee first-sighting hit ratio crossing "
            "below its floor — duty-lookahead holds the "
            "steady state at ~1.0, so a drop means epoch warms are "
            "failing (or the aggregate cache is collapsing) and first "
            "sightings are paying host EC sums again; the incident "
            "bundle's health snapshot carries the duty_lookahead block "
            "for direct attribution",
    ),
    DetectorSpec(
        "headroom_floor", "floor", "series:capacity_headroom_ratio",
        window_s=120.0, threshold=0.2, clear=0.35, min_points=1,
        sustain=2, severity="page",
        doc="capacity headroom crossing below its floor (the "
            "predictive dial: crossing PRECEDES the first deadline-"
            "miss burst on a saturation ramp); hysteresis resolves "
            "only above the clear level",
    ),
    DetectorSpec(
        "pack_share_drift", "zscore", "probe:pack_share",
        window_s=600.0, threshold=4.0, min_points=8, min_delta=0.1,
        sustain=2, severity="info",
        doc="host-side pack share of device verify wall drifting up — "
            "the host is becoming the bottleneck",
    ),
    DetectorSpec(
        "recompile_burst", "ceil", "series:capacity_recompiles_per_sec",
        window_s=120.0, threshold=0.5, clear=0.1, min_points=1,
        sustain=2, severity="warn",
        doc="device recompiles per second above the burst ceiling — "
            "traffic is escaping the padded rung ladder",
    ),
    DetectorSpec(
        "reupload_ratio_regression", "zscore",
        "series:capacity_pubkey_reupload_ratio",
        window_s=900.0, threshold=4.0, min_points=8, min_delta=0.1,
        sustain=2, severity="info",
        doc="the repeat-pubkey reupload ratio rising out of baseline — "
            "the device key-table dedup losing its hit rate",
    ),
    DetectorSpec(
        "slo_burn_spike", "roc", "series:capacity_slo_burn_rate",
        window_s=60.0, threshold=0.2, min_points=3, sustain=1,
        severity="page",
        doc="SLO miss-budget burn rate rising faster than the "
            "rate-of-change ceiling (budget/s) — sustained misses "
            "are seconds away",
    ),
    DetectorSpec(
        "verdict_p99_drift", "zscore", "probe:verdict_p99_ms",
        window_s=600.0, threshold=4.0, min_points=8, min_delta=10.0,
        sustain=2, severity="warn",
        doc="the in-slot verdict-latency p99 (slot-ledger report "
            "cards) drifting above its own recent baseline",
    ),
)


# ---------------------------------------------------------------------------
# Metric families (prefix `watchtower_`, declared in the zgate4 lint)
# ---------------------------------------------------------------------------

_EVALS_TOTAL = metrics.counter(
    "watchtower_evaluations_total",
    "detector-catalogue evaluation passes (background evaluator ticks "
    "+ explicit evaluate() calls)",
)
_EVAL_ERRORS = metrics.counter(
    "watchtower_evaluator_errors_total",
    "evaluation passes that raised (the pass is dropped, the thread "
    "survives) — a climbing rate with stalled "
    "watchtower_evaluations_total means the watchtower is blind",
)
_INCIDENTS_TOTAL = metrics.counter_vec(
    "watchtower_incidents_total",
    "incidents OPENED, by detector and severity (a reopen within the "
    "cooldown window is a flap on the existing incident, not a new "
    "one — dedup is the point)",
    ("detector", "severity"),
)
_INCIDENTS_OPEN = metrics.gauge(
    "watchtower_incidents_open",
    "incidents currently open (firing or latched) across every "
    "detector/label",
)
_DETECTOR_STATE = metrics.gauge_vec(
    "watchtower_detector_state",
    "per-detector lifecycle state, worst across labels: 0=armed "
    "1=firing 2=latched 3=cooldown (see docs/OBSERVABILITY.md)",
    ("detector",),
)
_BUNDLES_TOTAL = metrics.counter(
    "watchtower_bundles_written_total",
    "correlated incident bundles atomically written (open captures + "
    "resolve rewrites), schema lighthouse_tpu.incident/1",
)

# ---------------------------------------------------------------------------
# Enable / configure
# ---------------------------------------------------------------------------

_enabled = os.environ.get(
    "LIGHTHOUSE_TPU_WATCHTOWER", "1"
) not in ("", "0")
_interval_s = max(0.05, _env_float("LIGHTHOUSE_TPU_WT_INTERVAL_S", 2.0))
_cooldown_s = max(0.0, _env_float("LIGHTHOUSE_TPU_WT_COOLDOWN_S", 30.0))
_max_incidents = max(4, _env_int("LIGHTHOUSE_TPU_WT_MAX_INCIDENTS", 64))
_bundle = os.environ.get(
    "LIGHTHOUSE_TPU_WT_BUNDLE", "1"
) not in ("", "0")
_bundle_dir = os.environ.get("LIGHTHOUSE_TPU_WT_BUNDLE_DIR") or os.path.join(
    tempfile.gettempdir(), "lighthouse_tpu_incidents"
)
_bundle_retain = max(1, _env_int("LIGHTHOUSE_TPU_WT_BUNDLE_RETAIN", 8))
_margin_s = max(1.0, _env_float("LIGHTHOUSE_TPU_WT_MARGIN_S", 10.0))
_flight_tail = max(16, _env_int("LIGHTHOUSE_TPU_WT_FLIGHT_TAIL", 256))

# bounded per-(detector,label) probe history (probe sources have no
# ring in the store; series sources read the store's own rings)
_PROBE_POINTS = 512


def enabled() -> bool:
    return _enabled


def configure(
    enabled: Optional[bool] = None,
    interval_s: Optional[float] = None,
    cooldown_s: Optional[float] = None,
    max_incidents: Optional[int] = None,
    bundle: Optional[bool] = None,
    bundle_dir: Optional[str] = None,
    bundle_retain: Optional[int] = None,
    margin_s: Optional[float] = None,
) -> dict:
    """Override knobs at runtime; returns the PREVIOUS values so tests
    can restore with ``configure(**prev)`` (flight_recorder's
    contract)."""
    global _enabled, _interval_s, _cooldown_s, _max_incidents, _bundle
    global _bundle_dir, _bundle_retain, _margin_s
    with _lock:
        prev = {
            "enabled": _enabled,
            "interval_s": _interval_s,
            "cooldown_s": _cooldown_s,
            "max_incidents": _max_incidents,
            "bundle": _bundle,
            "bundle_dir": _bundle_dir,
            "bundle_retain": _bundle_retain,
            "margin_s": _margin_s,
        }
        if enabled is not None:
            _enabled = bool(enabled)
        if interval_s is not None:
            _interval_s = max(0.05, float(interval_s))
        if cooldown_s is not None:
            _cooldown_s = max(0.0, float(cooldown_s))
        if max_incidents is not None:
            _max_incidents = max(4, int(max_incidents))
            _resize_ledger()
        if bundle is not None:
            _bundle = bool(bundle)
        if bundle_dir is not None:
            _bundle_dir = str(bundle_dir)
        if bundle_retain is not None:
            _bundle_retain = max(1, int(bundle_retain))
        if margin_s is not None:
            _margin_s = max(1.0, float(margin_s))
    return prev


def bundle_dir() -> str:
    return _bundle_dir


# ---------------------------------------------------------------------------
# Runtime state
# ---------------------------------------------------------------------------


class _DetState:
    __slots__ = ("state", "streak", "since", "cooldown_until", "incident",
                 "value", "trace")

    def __init__(self):
        self.state = "armed"
        self.streak = 0
        self.since: Optional[float] = None
        self.cooldown_until = 0.0
        self.incident: Optional[dict] = None
        self.value: Optional[float] = None
        self.trace: Optional[dict] = None


_lock = threading.Lock()
_det: Dict[Tuple[str, str], _DetState] = {}
_probe_hist: Dict[Tuple[str, str], deque] = {}
_incidents: deque = deque(maxlen=_max_incidents)
_seq = 0
_evals = 0
_verdict_seen: Dict[str, Optional[int]] = {"slot": None}
_health_provider: Optional[Callable[[], dict]] = None


def _resize_ledger() -> None:
    """Called under _lock: rebuild the bounded ledger at the new cap,
    keeping the newest rows."""
    global _incidents
    _incidents = deque(_incidents, maxlen=_max_incidents)


def set_health_provider(fn: Optional[Callable[[], dict]]) -> None:
    """Register the callable whose document lands in the ``health``
    field of every bundle (the client wires the /lighthouse/health
    builder here; chain-less tools and replays leave it unset and the
    bundle still carries the utils-level blocks)."""
    global _health_provider
    _health_provider = fn


def reset() -> None:
    """Fresh detector state + incident ledger + probe history (knobs
    keep their values) — tests and replay runs start clean."""
    global _seq, _evals
    with _lock:
        _det.clear()
        _probe_hist.clear()
        _incidents.clear()
        _verdict_seen["slot"] = None
        _seq = 0
        _evals = 0
    for spec in DETECTORS:
        _DETECTOR_STATE.with_labels(spec.name).set(0)
    _INCIDENTS_OPEN.set(0)


# ---------------------------------------------------------------------------
# Probes: named value sources a detector can watch when the signal is
# not (only) a stored series — computed registry reads and slot-ledger
# walks, never the device
# ---------------------------------------------------------------------------


def _probe_pack_share() -> Dict[str, float]:
    """Host pack wall as a share of device verify wall, straight off
    the two registry histograms. Deliberately NOT
    ``transfer_ledger.summary()`` — that reads the device allocator
    for the memory block, which a per-tick evaluator must never do."""
    pack = metrics.get("bls_device_pack_seconds")
    verify = metrics.get("bls_device_verify_seconds")
    if pack is None or verify is None or not hasattr(pack, "children"):
        return {}
    pack_total = 0.0
    for labels, child in pack.children().items():
        if labels and labels[0] == "total":
            _t, s, _c = child.snapshot()
            pack_total += s
    verify_wall = 0.0
    if hasattr(verify, "children"):
        for _labels, child in verify.children().items():
            _t, s, _c = child.snapshot()
            verify_wall += s
    if verify_wall <= 0:
        return {}
    return {"": pack_total / verify_wall}


def _probe_verdict_p99() -> Dict[str, float]:
    """The newest slot report card's in-slot p99 — one point per slot
    (re-reading the same card contributes nothing; the baseline is
    slots, not evaluator ticks)."""
    for card in reversed(slot_ledger.slot_cards(last=3)):
        p99 = card.get("p99_ms")
        if p99 is None:
            continue
        if _verdict_seen["slot"] == card["slot"]:
            return {}
        _verdict_seen["slot"] = card["slot"]
        return {"": float(p99)}
    return {}


PROBES: Dict[str, Callable[[], Dict[str, float]]] = {
    "pack_share": _probe_pack_share,
    "verdict_p99_ms": _probe_verdict_p99,
}


# ---------------------------------------------------------------------------
# Algorithms: one reading -> (breached, cleared, value, trace). The
# middle ground (neither) is the hysteresis band that keeps an open
# incident latched.
# ---------------------------------------------------------------------------


def _eval_algo(spec: DetectorSpec, pts: List[Tuple[float, float]],
               now: float) -> Tuple[bool, bool, float, dict]:
    value = pts[-1][1]
    if spec.algo == "floor":
        clear = spec.clear if spec.clear is not None else spec.threshold
        breached = value < spec.threshold
        cleared = value >= clear
        trace = {"algo": "floor", "value": value,
                 "threshold": spec.threshold, "clear": clear,
                 "n_points": len(pts)}
    elif spec.algo == "ceil":
        clear = spec.clear if spec.clear is not None else spec.threshold
        breached = value > spec.threshold
        cleared = value <= clear
        trace = {"algo": "ceil", "value": value,
                 "threshold": spec.threshold, "clear": clear,
                 "n_points": len(pts)}
    elif spec.algo == "roc":
        slope = None
        breached, cleared = False, True
        if len(pts) >= max(2, spec.min_points):
            dt = pts[-1][0] - pts[0][0]
            slope = (pts[-1][1] - pts[0][1]) / dt if dt > 0 else 0.0
            breached = slope >= spec.threshold
            cleared = slope < spec.threshold * 0.5
        trace = {"algo": "roc", "value": value, "slope_per_s": slope,
                 "threshold": spec.threshold, "window_s": spec.window_s,
                 "n_points": len(pts)}
    else:  # zscore
        base = pts[:-1]
        breached, cleared = False, True
        mean = std = dev = gate = None
        if len(base) >= spec.min_points:
            mean = sum(v for _, v in base) / len(base)
            var = sum((v - mean) ** 2 for _, v in base) / len(base)
            std = var ** 0.5
            dev = (value - mean) if spec.direction == "above" \
                else (mean - value)
            # BOTH gates: `threshold` standard deviations AND the
            # absolute min_delta — a near-zero-variance baseline must
            # not page on an invisible wiggle
            gate = max(spec.threshold * std, spec.min_delta)
            breached = gate > 0 and dev >= gate
            cleared = gate <= 0 or dev < gate * 0.5
        trace = {"algo": "zscore", "value": value, "mean": mean,
                 "std": std, "deviation": dev, "gate": gate,
                 "direction": spec.direction, "n_points": len(pts)}
    return breached, cleared, value, trace


def _readings(spec: DetectorSpec, store: timeseries.TimeseriesStore,
              now: float) -> Dict[str, Tuple[bool, bool, float, dict]]:
    """Per-label algorithm outcomes for one detector. Called under
    _lock (probe history is module state); the store takes its own
    lock — store methods never call back into this module, so the
    ordering is acyclic."""
    kind, _, name = spec.source.partition(":")
    out: Dict[str, Tuple[bool, bool, float, dict]] = {}
    if kind == "series":
        d = store.doc(families=[name], tier="raw")
        for label, pts in d["families"].get(name, {}).items():
            win = [(p[0], p[1]) for p in pts
                   if p[0] >= now - spec.window_s]
            if win:
                out[label] = _eval_algo(spec, win, now)
    else:  # probe
        probe = PROBES.get(name)
        vals = probe() if probe is not None else {}
        for label, v in vals.items():
            hist = _probe_hist.get((spec.name, label))
            if hist is None:
                hist = _probe_hist[(spec.name, label)] = deque(
                    maxlen=_PROBE_POINTS
                )
            hist.append((now, float(v)))
            win = [p for p in hist if p[0] >= now - spec.window_s]
            if win:
                out[label] = _eval_algo(spec, win, now)
    return out


# ---------------------------------------------------------------------------
# The incident ledger + state machine
# ---------------------------------------------------------------------------


def _open_incident(spec: DetectorSpec, label: str, value: float,
                   trace: dict, now: float) -> dict:
    """Called under _lock."""
    global _seq
    _seq += 1
    inc = {
        "id": f"inc-{_seq:06d}",
        "detector": spec.name,
        "severity": spec.severity,
        "label": label,
        "opened_t": now,
        "opened_at": _iso(now),
        "resolved_t": None,
        "duration_s": 0.0,
        "last_breach_t": now,
        "flaps": 0,
        "value": value,
        "last_value": value,
        "threshold": spec.threshold,
        "trigger": trace,
        "bundle_path": None,
    }
    _incidents.append(inc)
    return inc


def _iso(t: float) -> str:
    return (time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t))
            + f".{int(t * 1000) % 1000:03d}Z")


def _step(spec: DetectorSpec, label: str, breached: bool, cleared: bool,
          value: float, trace: dict, now: float) -> Optional[tuple]:
    """One state-machine step for one (detector, label). Called under
    _lock; returns ("open"|"reopen"|"resolve", incident) when a
    transition needs journal/bundle work outside the lock."""
    key = (spec.name, label)
    st = _det.get(key)
    if st is None:
        st = _det[key] = _DetState()
    st.value = value
    st.trace = trace
    action = None
    if st.state == "armed":
        if breached:
            st.streak += 1
            if st.streak >= spec.sustain:
                inc = _open_incident(spec, label, value, trace, now)
                st.incident = inc
                st.state = "firing"
                st.since = now
                action = ("open", inc)
        else:
            st.streak = 0
    elif st.state in ("firing", "latched"):
        inc = st.incident
        if breached:
            if st.state == "latched":
                st.state = "firing"
                st.since = now
            if inc is not None:
                inc["last_breach_t"] = now
                inc["last_value"] = value
                inc["duration_s"] = round(now - inc["opened_t"], 6)
        elif cleared:
            st.state = "cooldown"
            st.since = now
            st.cooldown_until = now + _cooldown_s
            st.streak = 0
            if inc is not None and inc["resolved_t"] is None:
                inc["resolved_t"] = now
                inc["resolved_at"] = _iso(now)
                inc["duration_s"] = round(now - inc["opened_t"], 6)
                action = ("resolve", inc)
        elif st.state == "firing":
            # the hysteresis band: no longer breaching, not yet
            # cleared — the incident stays open, latched
            st.state = "latched"
            st.since = now
            if inc is not None:
                inc["duration_s"] = round(now - inc["opened_t"], 6)
    elif st.state == "cooldown":
        if breached:
            # dedup: a re-breach inside the cooldown REOPENS the same
            # incident as a flap instead of spamming a new row
            inc = st.incident
            st.state = "firing"
            st.since = now
            if inc is not None:
                inc["resolved_t"] = None
                inc.pop("resolved_at", None)
                inc["flaps"] += 1
                inc["last_breach_t"] = now
                inc["last_value"] = value
                action = ("reopen", inc)
        elif now >= st.cooldown_until:
            st.state = "armed"
            st.since = now
            st.streak = 0
    return action


# ---------------------------------------------------------------------------
# One evaluation pass (the hot-path seam; < 1 µs disabled)
# ---------------------------------------------------------------------------


def evaluate(now: Optional[float] = None) -> Optional[dict]:
    """Walk the detector catalogue once: read every detector's input,
    step its state machine, open/reopen/resolve incidents, write
    bundles. Returns ``{"t", "transitions"}`` (None when disabled — a
    single global check, pinned < 1 µs like disabled spans)."""
    if not _enabled:
        return None
    global _evals
    if now is None:
        now = time.time()
    store = timeseries.get_store()
    actions: List[tuple] = []
    with _lock:
        for spec in DETECTORS:
            for label, (breached, cleared, value, trace) in \
                    _readings(spec, store, now).items():
                act = _step(spec, label, breached, cleared, value,
                            trace, now)
                if act is not None:
                    actions.append((act[0], act[1], spec))
        open_n = sum(
            1 for st in _det.values() if st.state in ("firing", "latched")
        )
        worst: Dict[str, str] = {}
        for (name, _label), st in _det.items():
            cur = worst.get(name, "armed")
            if _STATE_RANK[st.state] >= _STATE_RANK[cur]:
                worst[name] = st.state
        _evals += 1
    # journal + metrics + bundle I/O outside the lock
    _EVALS_TOTAL.inc()
    _INCIDENTS_OPEN.set(open_n)
    for name, state in worst.items():
        _DETECTOR_STATE.with_labels(name).set(_STATE_CODE[state])
    transitions = []
    for action, inc, spec in actions:
        if action == "open":
            _INCIDENTS_TOTAL.with_labels(spec.name, spec.severity).inc()
            flight_recorder.record(
                "incident_opened",
                id=inc["id"], detector=spec.name, severity=spec.severity,
                label=inc["label"], value=inc["value"],
                threshold=spec.threshold,
            )
        elif action == "reopen":
            flight_recorder.record(
                "incident_opened",
                id=inc["id"], detector=spec.name, severity=spec.severity,
                label=inc["label"], value=inc["last_value"],
                threshold=spec.threshold, reopened=inc["flaps"],
            )
        else:  # resolve
            flight_recorder.record(
                "incident_resolved",
                id=inc["id"], detector=spec.name, severity=spec.severity,
                label=inc["label"], duration_s=inc["duration_s"],
            )
        if _bundle:
            try:
                path = _write_bundle(inc, spec, now)
                inc["bundle_path"] = path
            except OSError:
                _EVAL_ERRORS.inc()
        transitions.append({
            "action": action, "incident": inc["id"],
            "detector": spec.name, "label": inc["label"],
        })
    return {"t": now, "transitions": transitions}


# ---------------------------------------------------------------------------
# Correlated capture: the atomically-written incident bundle
# ---------------------------------------------------------------------------


def _bundle_doc(inc: dict, spec: DetectorSpec, now: float) -> dict:
    from . import pipeline_profiler

    store = timeseries.get_store()
    # the detector's own series plus the dials any triage starts from,
    # windowed margin_s before the open through margin_s after `now`
    fams = sorted({
        spec.source.partition(":")[2] if spec.source.startswith("series:")
        else None,
        "capacity_arrival_sets_per_sec",
        "capacity_deadline_miss_per_sec",
        "capacity_estimated_sets_per_sec",
        "capacity_headroom_ratio",
        "capacity_utilization",
    } - {None})
    window_s = (now - inc["opened_t"]) + 2 * _margin_s
    health = None
    provider = _health_provider
    if provider is not None:
        try:
            health = provider()
        except Exception:
            health = {"error": "health provider raised"}
    return {
        "schema": SCHEMA,
        "captured_at": _iso(now),
        "t": now,
        "pid": os.getpid(),
        "margin_s": _margin_s,
        "incident": dict(inc),
        "detector": _spec_doc(spec),
        "flight_recorder": flight_recorder.snapshot(
            trigger=f"incident:{spec.name}",
            context={"incident": inc["id"]},
        ),
        "timeseries": store.doc(families=fams, tier="raw",
                                window_s=window_s),
        "slot_cards": slot_ledger.slot_cards(last=8),
        "chain_time": slot_ledger.summary(),
        "profiler": pipeline_profiler.summary(),
        "capacity": timeseries.capacity_summary(),
        "health": health,
    }


def _write_bundle(inc: dict, spec: DetectorSpec, now: float) -> str:
    """Write (or, at resolve time, atomically REWRITE) the incident's
    bundle: tmp file in the target directory + os.replace, so a reader
    never sees a torn document."""
    doc = _bundle_doc(inc, spec, now)
    # trim the flight tail to the configured bound
    evs = doc["flight_recorder"].get("events", [])
    if len(evs) > _flight_tail:
        doc["flight_recorder"]["events"] = evs[-_flight_tail:]
    os.makedirs(_bundle_dir, exist_ok=True)
    path = inc.get("bundle_path") or os.path.join(
        _bundle_dir,
        f"{BUNDLE_PREFIX}{int(inc['opened_t'] * 1000)}_{inc['id']}.json",
    )
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    os.replace(tmp, path)
    _BUNDLES_TOTAL.inc()
    _apply_retention()
    return path


def _apply_retention() -> None:
    try:
        names = sorted(
            n for n in os.listdir(_bundle_dir)
            if n.startswith(BUNDLE_PREFIX) and n.endswith(".json")
        )
        for n in names[:-_bundle_retain]:
            os.unlink(os.path.join(_bundle_dir, n))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Introspection: the incident ledger, the health block, the catalogue
# ---------------------------------------------------------------------------


def incidents(limit: Optional[int] = None,
              open_only: bool = False) -> List[dict]:
    """Retained incidents, oldest first; ``limit`` keeps the newest N
    (after the open filter)."""
    with _lock:
        out = [dict(i) for i in _incidents]
    if open_only:
        out = [i for i in out if i["resolved_t"] is None]
    if limit is not None:
        out = out[-limit:] if limit > 0 else []
    return out


def _spec_doc(spec: DetectorSpec) -> dict:
    return {
        "name": spec.name, "algo": spec.algo, "source": spec.source,
        "window_s": spec.window_s, "threshold": spec.threshold,
        "clear": spec.clear, "direction": spec.direction,
        "min_points": spec.min_points, "min_delta": spec.min_delta,
        "sustain": spec.sustain, "severity": spec.severity,
        "doc": spec.doc,
    }


def catalogue() -> List[dict]:
    """The declared detector catalogue as documents (the endpoint, the
    docs table, and tools/incident_report.py --list-detectors)."""
    return [_spec_doc(s) for s in DETECTORS]


def summary() -> dict:
    """The ``watchtower`` block of ``/lighthouse/health``: per-detector
    state (worst across labels, plus each label's reading), incident
    accounting, evaluator state, bundle config."""
    with _lock:
        detectors = {}
        for spec in DETECTORS:
            labels = {}
            worst = "armed"
            for (name, label), st in _det.items():
                if name != spec.name:
                    continue
                labels[label] = {
                    "state": st.state,
                    "value": st.value,
                    "since": st.since,
                    "incident": (
                        st.incident["id"] if st.incident else None
                    ),
                }
                if _STATE_RANK[st.state] > _STATE_RANK[worst]:
                    worst = st.state
            detectors[spec.name] = {
                "state": worst,
                "severity": spec.severity,
                "algo": spec.algo,
                "source": spec.source,
                "labels": labels,
            }
        open_n = sum(
            1 for st in _det.values() if st.state in ("firing", "latched")
        )
        retained = len(_incidents)
        opened = _seq
        evals = _evals
    return {
        "enabled": _enabled,
        "evaluator": {
            "running": evaluator_running(),
            "interval_s": (
                _evaluator.interval_s if _evaluator is not None
                else _interval_s
            ),
            "evaluations_total": evals,
        },
        "detectors": detectors,
        "incidents": {
            "open": open_n,
            "opened_total": opened,
            "retained": retained,
            "max_retained": _max_incidents,
        },
        "cooldown_s": _cooldown_s,
        "bundle": {
            "enabled": _bundle,
            "dir": _bundle_dir,
            "retain": _bundle_retain,
            "margin_s": _margin_s,
        },
    }


# ---------------------------------------------------------------------------
# Background evaluator
# ---------------------------------------------------------------------------


class Evaluator:
    """Background thread calling :func:`evaluate` every ``interval_s``
    (the timeseries Sampler's shape — started by the client lifecycle,
    tools, tests)."""

    def __init__(self, interval_s: Optional[float] = None):
        self.interval_s = float(
            interval_s if interval_s is not None else _interval_s
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Evaluator":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="watchtower-evaluator", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                evaluate()
            except Exception:
                # an evaluation crash must never kill the thread — and
                # never pass silently (the sampler's error-counter
                # convention)
                _EVAL_ERRORS.inc()
            self._stop.wait(self.interval_s)


_evaluator: Optional[Evaluator] = None
_evaluator_lock = threading.Lock()


def start_evaluator(interval_s: Optional[float] = None) -> Evaluator:
    global _evaluator
    with _evaluator_lock:
        if _evaluator is None or not _evaluator.running():
            _evaluator = Evaluator(interval_s=interval_s)
        e = _evaluator
        e.start()
    return e


def stop_evaluator() -> None:
    global _evaluator
    with _evaluator_lock:
        e = _evaluator
        _evaluator = None
    # join OUTSIDE the lock: the evaluator thread may be mid-evaluate()
    if e is not None:
        e.stop()


def evaluator_running() -> bool:
    e = _evaluator
    return e is not None and e.running()
