"""The port's telemetry modules against the JAX package's.

``utils/slot_ledger.py``, ``transfer_ledger.py``, ``pipeline_profiler.py``
and ``timeseries.py`` are the port's own copies of the JAX package's
torch-free and jax-free modules. One seeded event stream, with explicit
``(t0, t1)`` stamps drawn by numpy (and a scripted clock where a module
reads ``time.perf_counter`` itself), goes through each package's modules
in a fresh interpreter, so both registries start empty: their summaries,
rows, journal events and the ``gather()`` lines of their families must
be equal. Floats are compared exactly (the arithmetic is the same code);
the HELP text of a family is the port's own wording, so the lines
compared are the TYPE and sample lines. The profiler's overlap ``basis``
is prose and is left out of the summary compared.

Also here: every metric family the port registers exists in the JAX
package with the same type, label names and buckets; the JAX families
the port does not register are all produced by modules ROADMAP item 15
(node wiring) or later items take, each named with its reason; the
port's ``gather()`` parses as Prometheus text; and the disabled hooks
cost one global check.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import pkgutil
import re
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The driver run in a fresh interpreter: each package's modules, one
# seeded stream, one JSON document per package on the last line.
SCRIPT = r'''
import json, re, sys, time, types
sys.path.insert(0, ROOT)
import importlib
import numpy as np

def family_lines(text, names):
    """The TYPE and sample lines of the families ``names``."""
    out = []
    for line in text.splitlines():
        if line.startswith("# HELP"):
            continue
        tok = line.split()[2] if line.startswith("# TYPE") else re.split(r"[{ ]", line)[0]
        for n in names:
            if tok == n or tok in (n + "_bucket", n + "_sum", n + "_count"):
                out.append(line)
                break
    return out

def events(fr, kind):
    return [e["fields"] for e in fr.events([kind])]

def run(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    metrics = m("utils.metrics")
    slot_clock = m("utils.slot_clock")
    fr = m("utils.flight_recorder")
    sl = m("utils.slot_ledger")
    tl = m("utils.transfer_ledger")
    pp = m("utils.pipeline_profiler")
    ts = m("utils.timeseries")
    # the source families the sampler reads, as their producers register them
    m("verification_service.batcher")
    m("compile_service.service")
    m("crypto.device.mesh")
    fr.configure(capacity=8192, enabled=True)
    fr.clear()
    doc = {}

    # -- slot ledger --------------------------------------------------------
    rng = np.random.default_rng(11)
    clock = slot_clock.ManualSlotClock(genesis_time=0, seconds_per_slot=12,
                                       slots_per_epoch=8)
    prev_clock = slot_clock.set_clock(clock)
    clock.set_slot(5)
    sl.reset()
    sl.configure(enabled=True, max_slots=6, max_epochs=3)
    kinds = ["unaggregated", "aggregate", "sync_committee", "block"]
    # chain time moves forward (an attribution to a slot older than every
    # retained card is the case the port handles differently:
    # test_slot_ledger_conserves_an_attribution_older_than_every_card)
    cur = 5
    for i in range(400):
        op = int(rng.integers(0, 10))
        if rng.random() < 0.15:
            cur += int(rng.integers(1, 4))
            clock.set_slot(cur)
        slot = cur if rng.random() < 0.85 else None
        if op == 0:
            sl.note_resolution(kinds[int(rng.integers(4))], "fused",
                               int(rng.integers(1, 65)), float(rng.random() * 0.3),
                               missed=bool(rng.random() < 0.3), slot=slot)
        elif op == 1:
            sl.note_rejection("attestation_rejected", slot=slot)
        elif op == 2:
            sl.note_h2d_bytes(int(rng.integers(1, 10**6)), slot=slot)
        elif op == 3:
            sl.note_bubble(float(rng.random() * 0.05), slot=slot)
        elif op == 4:
            sl.note_headroom(float(rng.random()), slot=slot)
        elif op == 5:
            sl.note_fresh_compile("stage2", slot=slot)
        elif op == 6:
            sl.note_bulk(admitted_sets=int(rng.integers(0, 128)),
                         parked_sets=int(rng.integers(0, 64)), slot=slot)
        elif op == 7:
            sl.note_lookahead(int(rng.integers(0, 8)), int(rng.integers(0, 4)),
                              int(rng.integers(0, 4)), slot=slot)
        else:
            sl.note_committee_sighting("first" if rng.random() < 0.4 else "hit",
                                       slot=slot)
        if i == 200:
            sl.configure(max_slots=3)
    model = sl.CommitteeSightingModel(min_repeats=2)
    model.prewarm([[1, 2, 3]])
    for _ in range(30):
        model.observe(sorted(int(v) for v in rng.choice(8, size=3, replace=False)),
                      slot=cur)
    sl.note_resolution("block", "bypass", 2, 0.01)  # the clock's slot
    doc["slot_ledger"] = {
        "cards": sl.slot_cards(), "last2": sl.slot_cards(last=2),
        "epochs": sl.epoch_cards(), "lifetime": sl.lifetime_totals(),
        "evicted": sl.evicted_totals(), "summary": sl.summary(),
        "model": [model.first, model.hits, model.hit_ratio(), model.prewarmed],
        "gather": family_lines(metrics.gather(), (
            "slot_ledger_slots", "slot_ledger_evicted_total",
            "slot_ledger_events_total", "key_table_first_sighting_hit_ratio")),
    }
    sl.configure(max_slots=64, max_epochs=64)
    slot_clock.set_clock(prev_clock)

    # -- transfer ledger ----------------------------------------------------
    rng = np.random.default_rng(12)
    tl.configure(enabled=True, window=4)
    pool = [bytes(rng.integers(0, 256, size=256, dtype=np.uint8)) for _ in range(9)]
    pendings = []
    for i in range(60):
        b = int(rng.choice([1, 2, 4, 8, 16]))
        k = int(rng.choice([1, 2, 4, 8]))
        mm = int(rng.choice([1, 2, 4]))
        n_sets = int(rng.integers(1, b + 1))
        pk_slots = int(rng.integers(n_sets, n_sets * k + 1))
        m_req = int(rng.integers(1, mm + 1))
        indexed = bool(rng.random() < 0.3)
        model_b = tl.operand_bytes_model(b, k, mm, indexed=indexed)
        live_b = tl.live_operand_bytes(n_sets, pk_slots, m_req, indexed=indexed)
        nbytes = {op: model_b[op] for op in ("pubkeys", "signatures", "messages", "aux")}
        blobs = [] if indexed else [pool[int(j)] for j in rng.integers(0, 9, size=pk_slots)]
        phases = {p: float(rng.random() * 1e-3) for p in tl.PACK_PHASES}
        kind = kinds[int(rng.integers(4))]
        path = ["fused", "sub_batch", "bisection"][int(rng.integers(3))]
        if i == 30:
            tl.configure(enabled=False)
        if i == 34:
            tl.configure(enabled=True)
        with tl.context(kind, path):
            tl.note_pack(n_sets, b, k, mm, pk_slots, m_req, phases,
                         sum(phases.values()), nbytes, blobs, indexed=indexed)
            pendings.append(tl.pending_pack())
            r = rng.random()
            if r < 0.6:
                tl.commit_verify(bool(rng.random() < 0.8), d2h_bytes=1)
            elif r < 0.8:
                tl.commit_verify(None, d2h_bytes=0)
            else:
                tl.note_op_bytes({"pubkeys": int(rng.integers(0, 5000)),
                                  "padding": int(rng.integers(0, 500))},
                                 kind="msm" if rng.random() < 0.5 else None)
        if rng.random() < 0.2:
            tl.record_cpu(int(rng.integers(1, 10)))
        doc.setdefault("models", []).append([model_b, live_b])
    tl.commit_verify(True)  # a leftover staged row is committed once
    doc["transfer_ledger"] = {
        "summary": tl.summary(), "tracker": tl.tracker().summary(),
        "ratio": [tl.tracker().ratio(), tl.tracker().ratio("aggregate")],
        "pending": pendings, "rows": events(fr, "transfer_ledger"),
        "gather": family_lines(metrics.gather(), (
            "bls_device_h2d_bytes_total", "bls_device_d2h_bytes_total",
            "bls_device_pack_seconds", "bls_device_pubkey_reupload_ratio",
            "device_memory_bytes", "bls_device_ledger_rows_total")),
    }

    # -- pipeline profiler ----------------------------------------------------
    rng = np.random.default_rng(13)
    now = {"t": 1000.0}
    pp.time = types.SimpleNamespace(perf_counter=lambda: now["t"],
                                    time=time.time, monotonic=time.monotonic)
    pp.reset()
    pp.configure(enabled=True, max_activity=64, retention_s=5.0)
    compile_hook = getattr(pp, "note_compile_wall", None)
    t = 1000.0
    rows = []
    for f in range(40):
        t0 = t
        t += float(rng.random() * 0.05)
        pp.note_idle_begin(t0)
        if rng.random() < 0.3:
            # a dispatch that lands while the flush thread still waits
            pp.note_stage_wall("stage3", 0, t0 + 0.001, t0 + 0.002)
        pp.note_idle_end(t0, t)
        if rng.random() < 0.3:
            # a capture beside the traffic: the port's compile hook, the
            # JAX package's fallback wall outside any flush (the same
            # `compile` activity, no flush phase)
            c0 = t - float(rng.random() * 0.05)
            c1 = t + float(rng.random() * 0.05)
            (compile_hook or pp.note_fallback_wall)(c0, c1)
        now["t"] = t
        rec = pp.flush_begin(trigger="deadline", kinds="unaggregated",
                             n_submissions=int(rng.integers(1, 9)),
                             n_sets=int(rng.integers(1, 65)),
                             queue_wait_s=float(rng.random() * 0.1))
        dp = float(rng.random() * 0.002)
        pp.note_plan_wall(t, t + dp, record=rec)
        t += dp
        n_sub = int(rng.integers(1, 4))
        with pp.flush_scope(rec):
            for _ in range(n_sub):
                shard = int(rng.integers(0, 2))
                dpk = float(rng.random() * 0.01)
                pp.note_pack_wall(t, t + dpk)
                t += dpk
                for stage in ("stage1", "stage2", "stage3"):
                    ds = float(rng.random() * 0.03)
                    back = float(rng.random() * 0.004) if rng.random() < 0.2 else 0.0
                    pp.note_stage_wall(stage, shard, t - back, t + ds,
                                       fresh=bool(rng.random() < 0.1))
                    t += ds + float(rng.random() * 0.002)
                if rng.random() < 0.2:
                    dfb = float(rng.random() * 0.02)
                    pp.note_fallback_wall(t, t + dfb)
                    t += dfb
        t += float(rng.random() * 0.003)
        now["t"] = t
        rows.append(pp.flush_end(rec, verdict=bool(rng.random() < 0.9),
                                 mode="planned" if n_sub > 1 else "single",
                                 n_sub_batches=n_sub))
    summ = pp.summary()
    summ["overlap_potential"].pop("basis")
    doc["pipeline_profiler"] = {
        "summary": summ, "bubble_rows": pp.bubble_rows(),
        "ratios": [pp.shard_bubble_ratio(i) for i in (0, 1, 2, None)],
        "rows": rows, "events": events(fr, "pipeline_flush"),
        "exact": {str(i): [sum(st.causes.values()), st.idle_s]
                  for i, st in pp._shards.items()},
        "gather": family_lines(metrics.gather(), (
            "bls_device_bubble_seconds_total", "bls_device_shard_busy_seconds_total",
            "verification_scheduler_flush_phase_seconds_total",
            "verification_scheduler_flush_thread_saturation",
            "verification_scheduler_overlap_potential_ratio")),
    }

    # -- timeseries ------------------------------------------------------------
    rng = np.random.default_rng(14)
    ts.reset()
    ts.configure(enabled=True)
    get = metrics.get
    out = []
    tnow = 1.7e9
    for step in range(24):
        tnow += 10.0 + float(rng.random())
        for kind in kinds[:3]:
            get("verification_scheduler_arrival_sets_total").with_labels(
                kind, "fused").inc(int(rng.integers(0, 400)))
            get("verification_scheduler_sets_total").with_labels(kind).inc(
                int(rng.integers(0, 400)))
        get("verification_scheduler_arrival_sets_total").with_labels(
            "backfill", "bulk").inc(int(rng.integers(0, 200)))
        get("verification_scheduler_bulk_sets_total").with_labels("backfill").inc(
            int(rng.integers(0, 150)))
        get("verification_scheduler_queue_depth").set(int(rng.integers(0, 64)))
        get("verification_scheduler_batch_occupancy_ratio").set(float(rng.random()))
        get("verification_scheduler_dp_shards").set(2)
        if step == 8:
            get("compile_service_measured_cost_seconds_per_set").set(0.0021)
        if step >= 14:
            for shard in ("0", "1"):
                get("bls_device_shard_verify_seconds").with_labels(shard).observe(
                    float(rng.random() * 0.2))
                get("bls_device_shard_sets_total").with_labels(shard).inc(
                    int(rng.integers(1, 64)))
        out.append(ts.sample(now=tnow))
    store = ts.get_store()
    doc["timeseries"] = {
        "samples": out, "last": ts.last_estimate(),
        "cost": list(ts.measured_cost_per_set()),
        "models": [ts.estimate_capacity(a, c, s, publish=False)
                   for a, c, s in ((100.0, 0.002, 1), (900.0, 0.002, 2),
                                   (5.0, None, 0), (None, 0.01, 3))],
        "docs": [store.doc(tier=tier) for tier in ts.TIER_NAMES],
        "window": store.points("capacity_headroom_ratio", window_s=60.0, now=tnow),
        "stats": store.stats(),
        "families": [s.family for s in ts.SAMPLE_FAMILIES],
        "capacity": {k: v for k, v in ts.capacity_summary().items()},
        "gather": family_lines(metrics.gather(), (
            "capacity_estimated_sets_per_sec", "capacity_utilization",
            "capacity_headroom_ratio", "capacity_sampler_samples_total",
            "capacity_sampler_errors_total", "capacity_sampler_memory_bytes")),
    }
    return doc

print(json.dumps({"jax": run("lighthouse_tpu"), "torch": run("lighthouse_tpu_torch")}))
'''


@pytest.fixture(scope="module")
def streams():
    """Both packages' documents, from one fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + SCRIPT],
        capture_output=True, text=True, timeout=300, check=True, cwd=str(ROOT),
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ["slot_ledger", "transfer_ledger",
                                    "pipeline_profiler", "timeseries"])
def test_module_matches_jax_on_a_seeded_stream(streams, module):
    """Every summary, row, journal event and family line of the module is
    the JAX module's on the same stream."""
    jax_doc, torch_doc = streams["jax"][module], streams["torch"][module]
    assert torch_doc.keys() == jax_doc.keys()
    for key in jax_doc:
        assert torch_doc[key] == jax_doc[key], (module, key)
    assert torch_doc["gather"] and any(
        not line.startswith("#") for line in torch_doc["gather"])


def test_streams_exercise_what_they_compare(streams):
    """The stream is not vacuous: eviction, disabled commits, every bubble
    cause, overlapping dispatches and every cost source happened, and the
    per-cause split sums to the idle time."""
    t = streams["torch"]
    sl = t["slot_ledger"]
    assert sl["summary"]["cards_evicted"] > 0 and len(sl["cards"]) == 3
    for name, total in sl["lifetime"].items():
        kept = sum(c[name] for c in sl["cards"])
        assert kept + sl["evicted"][name] == pytest.approx(total, abs=1e-9)
    assert t["models"] == streams["jax"]["models"]
    tl = t["transfer_ledger"]
    assert {r["verdict"] for r in tl["rows"]} == {True, False, None}
    assert tl["tracker"]["reuploaded_bytes"] > 0
    pp = t["pipeline_profiler"]
    assert set(pp["bubble_rows"]) == {"pack", "plan", "compile", "queue_empty", "other"}
    assert len(pp["events"]) == len(pp["rows"]) == 40
    for causes, idle in pp["exact"].values():
        assert causes == pytest.approx(idle, rel=1e-12, abs=1e-12)
    sources = {s["cost_source"] for s in t["timeseries"]["samples"] if s}
    assert {"flush_wall", "compile_service", "shard_verify"} <= sources
    assert t["timeseries"]["last"]["headroom_ratio"] is not None


def test_slot_ledger_conserves_an_attribution_older_than_every_card():
    """A fault of the JAX module, fixed in the port: with the ledger full,
    an attribution to a slot older than every retained card creates a
    card that retention evicts before the update lands, so the JAX
    ledger's retained + evicted totals fall short of its lifetime totals
    by that update. The port updates the card, then evicts it: retained
    + evicted == lifetime. Everything else agrees."""
    from lighthouse_tpu.utils import slot_ledger as jsl
    from lighthouse_tpu_torch.utils import slot_ledger as tsl

    got = {}
    for name, sl in (("jax", jsl), ("torch", tsl)):
        prev = sl.configure(enabled=True, max_slots=3)
        sl.reset()
        try:
            for slot in (10, 11, 12, 5):
                sl.note_resolution("aggregate", "fused", 4, 0.01, slot=slot)
            kept = sum(c["sets"] for c in sl.slot_cards())
            got[name] = (kept, sl.evicted_totals()["sets"], sl.lifetime_totals()["sets"],
                         [c["slot"] for c in sl.slot_cards()])
        finally:
            sl.reset()
            sl.configure(**prev)
    assert got["torch"] == (12, 4, 16, [10, 11, 12])
    assert got["jax"] == (12, 0, 16, [10, 11, 12])


# ---------------------------------------------------------------------------
# Family parity
# ---------------------------------------------------------------------------

# The JAX modules whose families the port does not register, each with
# the reason it waits. Every JAX family the port lacks must come from one
# of these modules.
NOT_PORTED = {
    "beacon_chain/attestation_verification.py": "the chain runtime: item 15 (node wiring)",
    "beacon_chain/block_verification.py": "the chain runtime: item 15",
    "beacon_chain/chain.py": "the chain runtime: item 15",
    "beacon_chain/validator_monitor.py": "the chain runtime: item 15",
    "beacon_processor/processor.py": "the work queues in front of the scheduler: item 15",
    "duty_lookahead/__init__.py": "the committee precompute's caller is the node: item 15",
    "http_api/server.py": "the HTTP surface: item 15",
    "network/peer_manager.py": "networking: item 15",
    "network/service.py": "networking and sync: item 15",
    "operation_pool/device_agg.py": "the operation pool: item 15",
    "operation_pool/pool.py": "the operation pool: item 15",
    "slasher/slasher.py": "the slasher: item 15",
    "store/hot_cold.py": "storage: item 15",
    "utils/logging.py": "the node's structured log: item 15",
    "utils/monitoring.py": "the monitoring push loop: item 15",
    "utils/watchtower.py": "the incident detectors read the node's series: item 15",
    "validator_client/preparation_service.py": "the validator client: item 15",
    "validator_client/services.py": "the validator client: item 15",
}


def _source_families(pkg_root: pathlib.Path) -> dict:
    """Family name -> the module (relative path) that registers it."""
    out = {}
    for path in sorted(pkg_root.rglob("*.py")):
        for m in re.finditer(r'metrics\.\w+\(\s*"(\w+)"', path.read_text()):
            out[m.group(1)] = str(path.relative_to(pkg_root))
    return out


def _shape(metric):
    """(class, label names, buckets) of one registered family."""
    labels = getattr(metric, "labelnames", ())
    buckets = getattr(metric, "buckets", None)
    if buckets is None and hasattr(metric, "_kw"):
        buckets = metric._kw.get("buckets")
    return type(metric).__name__, tuple(labels), None if buckets is None else tuple(buckets)


def test_every_port_family_has_the_jax_type_and_labels():
    import lighthouse_tpu_torch
    from lighthouse_tpu.utils import metrics as jmetrics
    from lighthouse_tpu_torch.utils import metrics as tmetrics

    for mod in pkgutil.walk_packages(lighthouse_tpu_torch.__path__, "lighthouse_tpu_torch."):
        importlib.import_module(mod.name)
    jax_sources = _source_families(ROOT / "lighthouse_tpu")
    torch_sources = _source_families(ROOT / "lighthouse_tpu_torch")
    registered = tmetrics.registry_snapshot()
    assert set(torch_sources) <= set(registered)
    for name in torch_sources:
        importlib.import_module("lighthouse_tpu." + jax_sources[name][:-3].replace("/", ".")
                                .removesuffix(".__init__"))
    jregistered = jmetrics.registry_snapshot()
    for name in torch_sources:
        assert _shape(registered[name]) == _shape(jregistered[name]), name
    missing = {name: mod for name, mod in jax_sources.items() if name not in torch_sources}
    assert set(missing.values()) == set(NOT_PORTED)
    # the telemetry this slice ported is all there
    assert {"bls_device_stage_seconds", "bls_device_pack_seconds",
            "bls_device_bubble_seconds_total", "bls_device_shard_busy_seconds_total",
            "device_memory_bytes", "capacity_headroom_ratio",
            "compile_service_compile_seconds", "bls_device_key_table_sets_total",
            "slot_ledger_events_total"} <= set(torch_sources)


_LINE = re.compile(
    r'^(# HELP [a-z_][a-z0-9_]* .*'
    r'|# TYPE [a-z_][a-z0-9_]* (counter|gauge|histogram)'
    r'|[a-z_][a-z0-9_]*(\{[a-z_][a-z0-9_]*="(?:[^"\\\n]|\\["\\n])*"'
    r'(,[a-z_][a-z0-9_]*="(?:[^"\\\n]|\\["\\n])*")*\})? '
    r'(-?[0-9.e+-]+|[+-]Inf|NaN))$'
)


def test_gather_parses_as_prometheus_text():
    import lighthouse_tpu_torch
    from lighthouse_tpu_torch.utils import metrics as tmetrics

    for mod in pkgutil.walk_packages(lighthouse_tpu_torch.__path__, "lighthouse_tpu_torch."):
        importlib.import_module(mod.name)
    text = tmetrics.gather()
    bad = [line for line in text.splitlines() if not _LINE.match(line)]
    assert not bad, bad[:5]
    samples = tmetrics.parse_exposition(text)
    types = re.findall(r"^# TYPE (\S+) ", text, re.M)
    assert len(types) == len(set(types)) >= 80 and samples is not None


def test_disabled_hooks_cost_one_global_check():
    """With every knob off, each hot-path hook returns after one global
    check: the minimum over repeats (the box is loaded) of a call is
    well under a microsecond."""
    from lighthouse_tpu_torch.utils import (
        pipeline_profiler as tpp, slot_ledger as tsl, timeseries as tts,
        transfer_ledger as ttl)

    prev = (ttl.configure(enabled=False), tpp.configure(enabled=False),
            tsl.configure(enabled=False), tts.configure(enabled=False))
    try:
        hooks = (
            lambda: ttl.note_pack(1, 1, 1, 1, 1, 1, {}, 0.0, {}, ()),
            lambda: ttl.note_op_bytes({}),
            lambda: ttl.record_cpu(1),
            lambda: tpp.note_stage_wall("stage1", 0, 0.0, 1.0),
            lambda: tpp.note_pack_wall(0.0, 1.0),
            lambda: tpp.note_compile_begin(0.0),
            lambda: tpp.note_compile_wall(0.0, 1.0),
            lambda: tpp.flush_begin("t", "k", 1, 1, 0.0),
            lambda: tsl.note_resolution("k", "p", 1, 0.1),
            lambda: tsl.note_h2d_bytes(1),
            lambda: tts.sample(),
        )
        n = 2000
        for hook in hooks:
            best = float("inf")
            for _ in range(7):
                t0 = time.perf_counter()
                for _ in range(n):
                    hook()
                best = min(best, (time.perf_counter() - t0) / n)
            assert best < 1e-6, (hook, best)
    finally:
        ttl.configure(**prev[0])
        tpp.configure(**prev[1])
        tsl.configure(**prev[2])
        tts.configure(**prev[3])
