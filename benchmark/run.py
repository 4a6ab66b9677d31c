#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``lighthouse_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout: a configuration (``benchmark/configs/<config>.json``), a
traffic mix (``benchmark/traffic/<traffic>.json``) and the cell's own
settings (``benchmark/cells/<cell>.json``: the rungs it warms, the slice a
traced run profiles, the sample the check takes). Every metric is read by
``benchmark/metrics/<name>.py``.

A run:

1. set-up: makes the cell's units from the seed (``generator.py``), builds
   the registry and signs every set (``inputs.py``, the frozen C library),
   builds the port's verification stack (``stack.py``) and waits until its
   compile service has captured the cell's rungs, then runs the warm-up
   units (negative slots) through the same path;
2. the window: ``--seconds`` of load (``drive.py``); with ``--trace 1``
   the profiler records the cell's trace slice of it (``devtrace.py``);
3. the check: a sample of the window's verdicts, drawn from the seed,
   against the plain reference (``reference.py``), in worker processes,
   after the stack is stopped;
4. the result: the numbers compared, each with its limit, as the last
   lines of standard error, and one JSON line as the last line of
   standard output.

Without a CUDA device, or with fewer than the cell asks for, the run
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lighthouse_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything the harness knows of cell ``name``, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return name in m.get("workloads", [name])

    return {
        "name": name, "cell": cell,
        "cfg": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "settings": json.loads((BENCH / "cells" / f"{name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def reader(metric: str):
    """The ``read(run)`` of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What the metric readers read: the cell, the units and their
    records, the dispatches and the program's counters over the window,
    the traced slice's counters and its device trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _check_task(items):
    from benchmark import reference

    return reference.verdicts(items)


def _set_verdicts(units, sigs_of, pairs, ex, workers: int) -> dict:
    """(unit, set) -> does the set verify, by the plain reference; the sets
    of one message go to one task, so that each message is hashed once."""
    by_msg: dict = {}
    for i, j in pairs:
        by_msg.setdefault(units[i].sets[j].msg, []).append((i, j))
    tasks = [[] for _ in range(max(1, workers) * 4)]
    for k, group in enumerate(sorted(by_msg.values(), key=len, reverse=True)):
        tasks[k % len(tasks)].extend(group)
    items = [[(sigs_of[i][j], units[i].sets[j].members, units[i].sets[j].msg) for i, j in t]
             for t in tasks]
    done = ex.map(_check_task, items) if ex is not None else map(_check_task, items)
    out = {}
    for t, verdicts in zip(tasks, done):
        out.update(zip(t, verdicts))
    return out


def reference_verdicts(units, sigs_of, picks, workers: int):
    """(unit index -> does every set of it verify, sets checked), by the
    plain reference in ``workers`` processes. The sets the generator
    signed wrongly are checked first: a unit one of them fails needs no
    more (the reference still decides it: a marked set that verifies
    sends its unit to the full check)."""
    marked = [(i, j) for i in picks for j, s in enumerate(units[i].sets) if s.bad]

    def run(ex):
        checked = _set_verdicts(units, sigs_of, marked, ex, workers)
        failed = {i for (i, _j), v in checked.items() if not v}
        rest = [(i, j) for i in picks if i not in failed
                for j in range(len(units[i].sets)) if (i, j) not in checked]
        checked.update(_set_verdicts(units, sigs_of, rest, ex, workers))
        ok = dict.fromkeys(picks, True)
        for (i, _j), v in checked.items():
            ok[i] = ok[i] and v
        return ok, len(checked)

    if workers <= 1:
        return run(None)
    import multiprocessing

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return run(ex)


def pick_sample(units, window, recs, settings, rng) -> list:
    """The window records the check compares: every unit that carries a
    wrongly signed set and got a verdict, and units that verify drawn
    from the seed, at least one, up to ``check.max_sets`` sets of them."""
    budget = int(settings["check"]["max_sets"])
    done = [k for k, r in enumerate(recs) if "verdict" in r]
    bad = [k for k in done if any(s.bad for s in units[window[k]].sets)]
    picks, n = list(bad), 0
    clean = 0
    for j in rng.permutation(len(done)).tolist():
        k = done[j]
        size = len(units[window[k]].sets)
        if k in bad or (clean and n + size > budget):
            continue
        picks.append(k)
        n += size
        clean += 1
    return picks


def summary(rows, c0, c1) -> str:
    """One line on what the window's dispatches and counters did."""
    from collections import Counter

    import numpy as np

    rungs = Counter(tuple(r["rung"]) for r in rows if "rung" in r)
    walls = [r["t1"] - r["t0"] for r in rows]
    delta = {k: c1[k] - c0[k] for k in ("agg_sum_s", "fallback_calls", "captures", "graphs")
             if k in c1}
    cold = {k: c1["cold_routes"][k] - c0["cold_routes"].get(k, 0)
            for k in c1.get("cold_routes", {})}
    table = {k: c1["table_sets"][k] - c0["table_sets"][k] for k in c1["table_sets"]}
    return (f"dispatches {len(rows)}, device seconds {sum(walls):.2f}, sets/dispatch "
            f"{np.mean([r['n_sets'] for r in rows]) if rows else 0:.1f}, rungs "
            f"{dict(rungs.most_common(8))}, counters {delta}, cold routes {cold}, table sets "
            f"{table}")


def unit_profile(recs, rows) -> str:
    """One line on each unit of the window: its wall, and of that the
    dispatches' host resolve + pack, their stages, and the rest (the
    scheduler's queue and hand-off), all in ms; a slow start or a stall
    shows here."""
    out = []
    for r in recs:
        if r.get("t1") is None:
            out.append("-")
            continue
        mine = [d for d in rows if r["t0"] <= d["t0"] and d["t1"] <= r["t1"]]
        host = sum(d.get("resolve_s", 0.0) + d.get("pack_s", 0.0) for d in mine)
        stages = sum(d.get("stages_s", 0.0) for d in mine)
        wall = r["t1"] - r["t0"]
        rest = wall - sum(d["t1"] - d["t0"] for d in mine)
        out.append(f"{wall * 1e3:.0f}/{host * 1e3:.0f}/{stages * 1e3:.0f}/{rest * 1e3:.0f}")
    return "units wall/host/stages/rest ms: " + " ".join(out)


class GcClock:
    """The cyclic collector's passes and their seconds while ``on``."""

    def __init__(self):
        self.on = False
        self.n = [0, 0, 0]
        self.s = [0.0, 0.0, 0.0]
        self._t = None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self._t
            self._t = None

    def line(self) -> str:
        return "collector in the window: " + ", ".join(
            f"gen{g} {self.n[g]} in {self.s[g]:.3f} s" for g in range(3))


def _core(cpu: int) -> str:
    """The CPUs of ``cpu``'s physical core, as the kernel lists them."""
    try:
        return Path(f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list").read_text().strip()
    except OSError:
        return str(cpu)


def pin_threads(own_tid: int):
    """For the window: thread ``own_tid`` (the scheduler's flush thread,
    which does the host's share of every dispatch) alone on the last
    CPU this process may use, and this process's other threads off that
    CPU's physical core, so that none of them shares its core. Returns
    the CPUs to hand back with :func:`unpin_threads`, or None where
    there is no core to spare."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
        mine = _core(cpus[-1])
        rest = {c for c in cpus if _core(c) != mine}
        if not rest:
            return None
        for tid in os.listdir("/proc/self/task"):
            os.sched_setaffinity(int(tid), {cpus[-1]} if int(tid) == own_tid else rest)
    except OSError:
        return None
    return set(cpus)


def unpin_threads(cpus) -> None:
    if cpus:
        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), cpus)
            except OSError:
                pass


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             verify=None, workers: int | None = None, log=print) -> dict:
    """One run of a cell (``spec`` from :func:`load_cell`); the result
    line's fields and the numbers compared. ``verify`` replaces the
    program's batch verifier under the scheduler (the tests' faults and
    the control)."""
    import numpy as np

    from benchmark import devtrace, drive, generator, inputs, stack

    settings, traffic, cfg = spec["settings"], spec["traffic"], spec["cfg"]
    workers = workers or max(1, (os.cpu_count() or 2) - 1)
    t = time.perf_counter()
    units = generator.generate(cfg, traffic, seed, seconds)
    log(f"units {len(units)} ({sum(len(u.sets) for u in units)} sets) in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    keys = stack.program_keys(inputs.registry_xy(int(cfg["validators"])))
    log(f"registry of {len(keys)} keys in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    st = stack.Stack(keys, settings["rungs"], device=device, verify=verify)
    log(f"key table synced, compile service started in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    specs = [s for u in units for s in u.sets]
    flat = inputs.sign_sets(specs, workers)
    sigs_of, k = [], 0
    for u in units:
        sigs_of.append(flat[k:k + len(u.sets)])
        k += len(u.sets)
    psets = [stack.program_sets(u.sets, sigs_of[i], keys) for i, u in enumerate(units)]
    log(f"signed {len(specs)} sets with {workers} workers in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    st.wait_warm()
    log(f"rungs {settings['rungs']} warm after {time.perf_counter() - t:.2f} s more")

    sched = st.scheduler
    chain = st.bulk_chain()
    from lighthouse_tpu_torch.verification_service import backend_verify_bulk

    def call(i):
        u = units[i]
        if u.entry == "bulk":
            return backend_verify_bulk(chain, psets[i], u.kind)
        return sched.verify_now(psets[i], u.kind)

    pre = [i for i, u in enumerate(units) if u.slot < 0]
    w0 = st.counters()
    window = [i for i, u in enumerate(units) if u.slot >= 0]
    t = time.perf_counter()
    for i in pre:
        call(i)
    st.wait_warm()
    w1 = st.counters()
    log(f"warm-up units {len(pre)} in {time.perf_counter() - t:.2f} s; "
        + summary([], w0, w1).split(", rungs {}, ")[1])

    # the inputs of every unit are made: the collector need not scan them
    # again (a full pass over them takes about a second)
    gc.collect()
    gc.freeze()
    flusher = sched._thread.native_id if sched._thread is not None else None
    pinned = pin_threads(flusher) if flusher is not None else None
    log(f"flush thread {'on CPU ' + str(max(pinned)) + ' alone' if pinned else 'not pinned'}")
    tr = devtrace.Trace() if trace else None
    c0 = st.counters()
    traced = {}
    if tr is not None:
        # the profiler's start takes seconds: before the window's clock, so
        # that the slice holds the window's first dispatches
        tr.start()
        traced["c0"] = st.counters()
    trace_end = [None]

    def tick():
        if trace_end[0] is not None and time.perf_counter() >= trace_end[0]:
            tr.stop()
            traced["c1"] = st.counters()
            trace_end[0] = None

    st.dispatches.recording = True
    gcc = GcClock()
    gcc.on = True
    setup_s = process_age_s()
    start = time.perf_counter()
    if tr is not None:
        trace_end[0] = start + float(settings["trace_seconds"])
    recs = drive.closed(window, call, start + seconds, on_each=tick)
    if tr is not None and trace_end[0] is not None:
        tr.stop()
        traced["c1"] = st.counters()
    st.dispatches.recording = False
    end = time.perf_counter()
    gcc.on = False
    unpin_threads(pinned)
    c1 = st.counters()
    log(f"window: {len(recs)} units in {end - start:.2f} s")
    if len(recs) == len(window) and end - start < seconds:
        log(f"the window ran out of units after {end - start:.2f} s of {seconds} s: the program "
            f"verified more than the mix's ceiling_sets_per_s")
    if tr is not None:
        tr.read()
    log(summary(st.dispatches.rows, c0, c1))
    log(unit_profile(recs, st.dispatches.rows))
    log(gcc.line() + "; bulk admission excursions "
        + str(st.scheduler._admission.status().get("excursions_total")))
    if tr is not None:
        log(f"trace: {tr.n_events} events over {tr.window_s:.2f} s, stopped in {tr.stop_s:.2f} s, "
            f"read in {tr.read_s:.2f} s")

    import torch

    on_card = device != "cpu" and torch.cuda.is_available()
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    dispatches = list(st.dispatches.rows)
    st.close()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded forbidden modules: {', '.join(found)}")

    run = Run(spec=spec, units=units, window=window, recs=recs, start=start, end=end,
              seconds=seconds, setup_s=setup_s, dispatches=dispatches, c0=c0, c1=c1,
              trace=tr, traced=traced, cfg=cfg, traffic=traffic, device=dev)
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the check, once the stack is stopped
    t = time.perf_counter()
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 7])
    picks = pick_sample(units, window, recs, settings, rng)
    truth, checked_sets = reference_verdicts(units, sigs_of, [window[k] for k in picks], workers)
    mismatches = sum(1 for k in picks if recs[k]["verdict"] != truth[window[k]])
    missing = sum(1 for r in recs if "verdict" not in r)
    log(f"check: {len(picks)} units ({checked_sets} sets checked, "
        f"{sum(1 for k in picks if not truth[window[k]])} that do not verify) in "
        f"{time.perf_counter() - t:.2f} s")
    checks = {"verdict_mismatches": {"value": mismatches, "limit": 0},
              "missing_verdicts": {"value": missing, "limit": 0}}
    out = {"correct": mismatches == 0 and missing == 0,
           "attempted": len(recs),
           "failed": missing,
           "metrics": metrics,
           "device": dev}
    if tr is not None:
        out["breakdown"] = devtrace.breakdown(tr, dispatches)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    build = BENCH / "_build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    spec = load_cell(args.workload)

    import torch

    want = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"needs {want} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), log=log)
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # every worker process has been joined; end without the interpreter's
    # teardown, which aborts on native threads the program leaves parked
    os._exit(code)
