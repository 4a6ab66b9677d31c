"""The node around the port's chain against the JAX package's.

Exact equality on shared inputs throughout:

* the beacon processor's admissions, shed counts, queue lengths and the
  batches it drains, by priority and LIFO, up to each kind's ceiling;
* the watchtower's transitions and incidents on one seeded series;
* the monitoring payloads (their volatile fields aside) and push loop;
* the lockfile's behaviour on a data directory;
* the HTTP API: the status codes and bodies of a fixed list of routes
  served by a JAX node and a port node, both built by their
  ``ClientBuilder`` on ``fake`` from the same genesis, after the same
  blocks and attestations;
* the CLI parser's subcommands, flags and defaults, with ``cuda`` where
  JAX has ``tpu``.

And the port alone: a ``ClientBuilder`` with the ``cuda`` backend on the
CPU wires the aggregator, mesh, key table, lookahead, compile service and
scheduler in the JAX builder's order; the options and commands
that need item 15c's modules say so; ``python -m lighthouse_tpu_torch bn``
comes up and stops on SIGTERM.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import random
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest
import torch

import lighthouse_tpu.beacon_processor as jbp
import lighthouse_tpu.cli as jcli
import lighthouse_tpu.client as jclient
import lighthouse_tpu_torch.beacon_processor as tbp
import lighthouse_tpu_torch.cli as tcli
import lighthouse_tpu_torch.client as tclient
from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.testing.harness import StateHarness as JHarness
from lighthouse_tpu.types import types_for as jtypes_for
from lighthouse_tpu.types.chain_spec import minimal_spec as jminimal_spec
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu.utils import (
    flight_recorder as jfr, lockfile as jlock, metrics as jmetrics, monitoring as jmon,
    slot_clock as jclock, timeseries as jts, watchtower as jwt)
from lighthouse_tpu_torch.compile_service import service as tservice
from lighthouse_tpu_torch.crypto import backend as tbackend
from lighthouse_tpu_torch.crypto.device import key_table as tkey_table, mesh as tmesh
from lighthouse_tpu_torch.types import types_for as ttypes_for
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as tminimal_spec
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL
from lighthouse_tpu_torch.utils import (
    flight_recorder as tfr, lockfile as tlock, metrics as tmetrics, monitoring as tmon,
    slot_clock as tclock, timeseries as tts, watchtower as twt)
from lighthouse_tpu_torch.utils.pending import NotPortedError

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _backends():
    saved = [(m, m._active, m._active_name) for m in (jbackend, tbackend)]
    yield
    for m, active, name in saved:
        m._active, m._active_name = active, name


# ---------------------------------------------------------------------------
# Beacon processor
# ---------------------------------------------------------------------------

def _processor_run(bp, metrics, fr) -> dict:
    """Admissions, sheds and drained batches of one fixed submission mix
    on a processor with no workers (batches drained by hand)."""
    W = bp.WorkKind
    proc = bp.BeaconProcessor({}, n_workers=0, queue_bounds={k: 5 for k in W},
                              batch_ceilings={W.GOSSIP_ATTESTATION: 3,
                                              W.GOSSIP_AGGREGATE: 2,
                                              W.GOSSIP_SYNC_MESSAGE: 4})
    dropped = metrics.get("beacon_processor_dropped_total").value
    sheds = fr.status()["recorded_total"]
    order = [W.GOSSIP_ATTESTATION] * 7 + [W.GOSSIP_BLOCK] * 2 + [W.GOSSIP_AGGREGATE] * 6 + [
        W.GOSSIP_SYNC_MESSAGE] * 6 + [W.CHAIN_SEGMENT, W.API_REQUEST, W.GOSSIP_SYNC_CONTRIBUTION]
    try:
        admitted = [proc.submit(bp.Work(k, i)) for i, k in enumerate(order)]
        queues = proc.queue_lengths()
        batches = []
        with proc._lock:
            while (got := proc._next_batch()) is not None:
                batches.append((got[0].name, [w.item for w in got[1]]))
    finally:
        proc.shutdown()
    shed_events = [e["fields"]["kind"] for e in fr.events(["queue_shed"])
                   if e["seq"] >= sheds]
    return {"admitted": admitted, "queues": queues, "batches": batches,
            "dropped": metrics.get("beacon_processor_dropped_total").value - dropped,
            "shed_events": shed_events}


def test_beacon_processor_queues_and_sheds_match_jax():
    got = _processor_run(tbp, tmetrics, tfr)
    assert got == _processor_run(jbp, jmetrics, jfr)
    assert got["dropped"] == 4 and len(got["shed_events"]) == 4
    assert got["batches"][0][0] == "CHAIN_SEGMENT"


def test_beacon_processor_workers_deliver_results_like_jax():
    """Workers run the handlers: every item's result reaches its callback."""
    out = {}
    for name, bp in (("jax", jbp), ("torch", tbp)):
        got, done = {}, threading.Event()

        def cb(i):
            def f(r):
                got[i] = r
                if len(got) == 20:
                    done.set()
            return f

        proc = bp.BeaconProcessor({bp.WorkKind.GOSSIP_ATTESTATION: lambda xs: [2 * x for x in xs],
                                   bp.WorkKind.GOSSIP_BLOCK: lambda x: -x}, n_workers=2)
        try:
            for i in range(20):
                kind = bp.WorkKind.GOSSIP_BLOCK if i % 5 == 0 else bp.WorkKind.GOSSIP_ATTESTATION
                assert proc.submit(bp.Work(kind, i, done=cb(i)))
            assert done.wait(10)
        finally:
            proc.shutdown()
        out[name] = got
    assert out["torch"] == out["jax"] == {i: (-i if i % 5 == 0 else 2 * i) for i in range(20)}


# ---------------------------------------------------------------------------
# Watchtower, monitoring, lockfile
# ---------------------------------------------------------------------------

def _watchtower_run(wt, ts, fr, tmp) -> dict:
    prev_fr = fr.configure(enabled=True, dump=False)
    ts.reset()
    prev_ts = ts.configure(enabled=True)
    wt.reset()
    prev = wt.configure(enabled=True, cooldown_s=5.0, bundle=False,
                        bundle_dir=str(tmp), bundle_retain=4)
    seq0 = fr.status()["recorded_total"]
    rng = random.Random(7)
    t0 = 1_000_000.0
    transitions = []
    try:
        store = ts.get_store()
        for i in range(40):
            head = 0.6 if i < 10 or i > 30 else rng.choice((0.05, 0.1, 0.3, 0.5))
            store.record("capacity_headroom_ratio", head, t=t0 + i)
            store.record("capacity_deadline_miss_per_sec", rng.random() * (i > 20), t=t0 + i)
            transitions.append(wt.evaluate(now=t0 + i)["transitions"])
        incidents = wt.incidents()
        journal = [(e["kind"], e["fields"].get("detector")) for e in
                   fr.events(["incident_opened", "incident_resolved"]) if e["seq"] >= seq0]
    finally:
        wt.configure(**prev)
        wt.reset()
        ts.configure(**prev_ts)
        ts.reset()
        fr.configure(**prev_fr)
    return {"transitions": transitions, "incidents": incidents, "journal": journal}


def test_watchtower_incidents_on_a_seeded_series_match_jax(tmp_path):
    got = _watchtower_run(twt, tts, tfr, tmp_path / "t")
    assert got == _watchtower_run(jwt, jts, jfr, tmp_path / "j")
    assert got["incidents"] and got["journal"]


class _Collector:
    """A local HTTP endpoint that keeps every POSTed document."""

    def __init__(self):
        self.docs = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                outer.docs.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _steady(doc):
    """A monitoring document without its clock- and process-bound fields."""
    doc = json.loads(json.dumps(doc))
    doc["general"].pop("timestamp")
    doc["process"] = sorted(doc["process"])
    return doc


def test_monitoring_payloads_and_backoff_match_jax():
    chain = SimpleNamespace(
        head_state=SimpleNamespace(slot=17),
        fork_choice=SimpleNamespace(store=SimpleNamespace(finalized_checkpoint=(2, bytes(32)))),
        network=None)
    assert _steady(tmon.collect(chain)) == _steady(jmon.collect(chain))
    out = {}
    for name, mon in (("jax", jmon), ("torch", tmon)):
        col = _Collector()
        try:
            svc = mon.MonitoringService(chain, col.url, interval_s=30.0, base_backoff_s=1.0)
            assert svc.push_once()
            random.seed(11)
            waits = [svc.next_wait(k) for k in range(7)]
        finally:
            col.close()
        out[name] = ([_steady(d) for d in col.docs], waits, svc.sent, svc.errors)
    assert out["torch"] == out["jax"]


def _lockfile_run(mod, d: pathlib.Path) -> list:
    d.mkdir()
    path = str(d / "beacon.lock")
    steps = []
    lock = mod.Lockfile(path).acquire()
    steps.append(("held", os.path.exists(path)))
    try:
        mod.Lockfile(path).acquire()
        steps.append(("second", "acquired"))
    except mod.LockfileError:
        steps.append(("second", "refused"))
    lock.release()
    steps.append(("released", os.path.exists(path)))
    with open(path, "w") as f:
        f.write("999999999")  # a stale lock: no such process
    again = mod.Lockfile(path).acquire()
    steps.append(("stale", open(path).read() == str(os.getpid())))
    again.release()
    steps.append(("end", os.path.exists(path)))
    return steps


def test_lockfile_behaviour_matches_jax(tmp_path):
    got = _lockfile_run(tlock, tmp_path / "t")
    assert got == _lockfile_run(jlock, tmp_path / "j")
    assert got == [("held", True), ("second", "refused"), ("released", False),
                   ("stale", True), ("end", False)]
    from lighthouse_tpu_torch.utils import Lockfile, LockfileError

    assert (Lockfile, LockfileError) == (tlock.Lockfile, tlock.LockfileError)


# ---------------------------------------------------------------------------
# HTTP API: a JAX node and a port node on the same chain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain_bytes():
    """The JAX harness's genesis (8 validators, phase0), BLOCKS fake-signed
    blocks and the last slot's attestations, as bytes."""
    saved = (jbackend._active, jbackend._active_name)
    jbackend.set_backend("fake")
    try:
        h = JHarness(JMINIMAL, jminimal_spec(), 8, fake_sign=True)
        genesis = type(h.state).encode(h.state)
        blocks = [type(b).encode(b) for b in h.extend_chain(BLOCKS, strategy="none")]
        atts = [type(a).encode(a) for a in h.attestations_for_slot(h.state, h.state.slot)]
    finally:
        jbackend._active, jbackend._active_name = saved
    return genesis, blocks, atts


def _node(client_mod, types_for, preset, spec, clock_mod, chain_bytes):
    genesis, blocks, atts = chain_bytes
    t = types_for(preset)
    clock = clock_mod.ManualSlotClock(0, spec.seconds_per_slot, preset.SLOTS_PER_EPOCH)
    client = (client_mod.ClientBuilder(
        client_mod.ClientConfig(preset_base="minimal", bls_backend="fake", http_port=0,
                                verification_scheduler=False), spec)
        .with_genesis_state(t.state["phase0"].decode(genesis)).with_slot_clock(clock).build())
    for raw in blocks:
        sb = t.signed_block["phase0"].decode(raw)
        clock.set_slot(sb.message.slot)
        client.chain.process_block(sb)
    for raw in atts:
        client.chain.op_pool.insert_attestation(t.Attestation.decode(raw))
    client.api.start()
    return client


ROUTES = (
    "/eth/v1/node/version", "/eth/v1/node/syncing", "/eth/v1/node/identity",
    "/eth/v1/node/peer_count", "/eth/v1/beacon/genesis", "/eth/v1/beacon/headers/head",
    "/eth/v1/beacon/headers/2", "/eth/v1/beacon/headers", "/eth/v2/beacon/blocks/head",
    "/eth/v2/beacon/blocks/3", "/eth/v1/beacon/blocks/head/root",
    "/eth/v1/beacon/blocks/head/attestations", "/eth/v1/beacon/states/head/root",
    "/eth/v1/beacon/states/head/fork", "/eth/v1/beacon/states/head/finality_checkpoints",
    "/eth/v1/beacon/states/head/validators", "/eth/v1/beacon/states/head/validators/3",
    "/eth/v1/beacon/states/head/validator_balances?id=0,5",
    "/eth/v1/beacon/states/head/committees", "/eth/v1/beacon/pool/attestations",
    "/eth/v1/beacon/pool/voluntary_exits", "/eth/v1/config/spec",
    "/eth/v1/config/fork_schedule", "/eth/v1/config/deposit_contract",
    "/eth/v1/debug/beacon/heads", "/eth/v1/validator/duties/proposer/0",
    f"/eth/v1/validator/attestation_data?slot={BLOCKS}&committee_index=0",
    f"/eth/v2/validator/blocks/{BLOCKS + 1}?randao_reveal=0x{'c0' + '00' * 95}",
    "/eth/v1/beacon/rewards/blocks/head",
    # errors: an unknown route, a malformed block id, a state not held
    "/eth/v1/nope", "/eth/v1/beacon/headers/0xzz", "/eth/v1/beacon/states/999/root",
)


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_routes_match_a_jax_node_on_the_same_chain(chain_bytes):
    nodes = {
        "jax": _node(jclient, jtypes_for, JMINIMAL, jminimal_spec(), jclock, chain_bytes),
        "torch": _node(tclient, ttypes_for, TMINIMAL, tminimal_spec(), tclock, chain_bytes),
    }
    try:
        got = {name: {r: _get(c.api.port, r) for r in ROUTES} for name, c in nodes.items()}
    finally:
        for c in nodes.values():
            c.stop()
    for r in ROUTES:
        assert got["torch"][r] == got["jax"][r], r
    # JAX's codes for a slot or a malformed root as a block id, and for a
    # state not held
    assert {r: got["torch"][r][0] for r in ROUTES if got["torch"][r][0] != 200} == {
        "/eth/v1/nope": 404, "/eth/v1/beacon/headers/0xzz": 500,
        "/eth/v1/beacon/states/999/root": 400, "/eth/v1/beacon/headers/2": 400,
        "/eth/v2/beacon/blocks/3": 400}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _shape(parser: argparse.ArgumentParser, tpu_to_cuda: bool) -> dict:
    """Each (sub)command's flags: dest, default, choices, required, nargs."""
    out = {}

    def walk(p, name):
        rows = []
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for sub, sp in a.choices.items():
                    walk(sp, f"{name} {sub}")
                continue
            choices, default = a.choices, a.default
            if tpu_to_cuda and a.dest == "bls_backend":
                choices = sorted({"cuda" if c == "tpu" else c for c in choices})
                default = "cuda" if default == "cpu" else default
            elif a.dest == "bls_backend":
                choices = sorted(choices)
            rows.append((a.dest, default, None if choices is None else list(choices),
                         a.required, a.nargs))
        out[name] = rows

    walk(parser, "")
    return out


def test_cli_parser_matches_jax_with_cuda_for_tpu():
    got, want = _shape(tcli.build_parser(), False), _shape(jcli.build_parser(), True)
    assert got == want
    assert {"bn", "vc", "am", "db", "lcli", "boot-node"} <= {k.split()[0] for k in got if k}
    args = tcli.build_parser().parse_args(["bn"])
    assert (args.bls_backend, args.http_port) == (tbackend.DEFAULT, 5052) == ("cuda", 5052)


def test_item_15c_options_and_commands_say_so(chain_bytes, capsys, tmp_path):
    t = ttypes_for(TMINIMAL)
    genesis = t.state["phase0"].decode(chain_bytes[0])
    for cfg in ({"slasher": True}, {"listen_port": 0}):
        b = tclient.ClientBuilder(tclient.ClientConfig(
            preset_base="minimal", bls_backend="fake", http_enabled=False, **cfg),
            tminimal_spec()).with_genesis_state(genesis)
        with pytest.raises(NotPortedError, match="ROADMAP item 15c"):
            b.build()
    with pytest.raises(NotPortedError, match="eth2_client"):
        tclient.ClientBuilder(tclient.ClientConfig(preset_base="minimal")).with_checkpoint_sync(
            "http://127.0.0.1:9")
    for argv in (["vc", "--beacon-node", "http://127.0.0.1:9"],
                 ["am", "wallet-create", "--name", "w", "--out", str(tmp_path / "w")],
                 ["boot-node"], ["lcli", "generate-bootnode-record", "--out", "x"]):
        assert tcli.main(argv) == 2
        assert "ROADMAP item 15c" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The port's device wiring and entry point
# ---------------------------------------------------------------------------

def test_client_wires_the_cuda_backend_on_the_cpu_in_jax_order(chain_bytes, monkeypatch):
    import lighthouse_tpu_torch.duty_lookahead as tla
    import lighthouse_tpu_torch.operation_pool as tpool
    import lighthouse_tpu_torch.verification_service as tvs

    calls = []

    def wrap(cls, name, label, run=True):
        orig = getattr(cls, name)

        def f(self, *a, **k):
            calls.append(label)
            return orig(self, *a, **k) if run else self
        monkeypatch.setattr(cls, name, f)

    wrap(tpool.DeviceAggregator, "__init__", "aggregator")
    wrap(tmesh.DeviceMesh, "__init__", "mesh")
    wrap(tkey_table.DeviceKeyTable, "sync", "key_table")
    wrap(tla.DutyLookahead, "start", "lookahead", run=False)
    wrap(tservice.CompileService, "start", "compile_service", run=False)
    wrap(tvs.VerificationScheduler, "start", "scheduler")
    t = ttypes_for(TMINIMAL)
    client = tclient.ClientBuilder(
        tclient.ClientConfig(preset_base="minimal", bls_backend="cuda", device="cpu",
                             http_enabled=False, device_msm=True, duty_lookahead=True),
        tminimal_spec()).with_genesis_state(t.state["phase0"].decode(chain_bytes[0])).build()
    chain = client.chain
    try:
        assert calls == ["aggregator", "mesh", "key_table", "lookahead", "compile_service",
                         "scheduler"]
        assert tbackend.active().device == torch.device("cpu")
        assert chain.op_pool._device_agg.device == "cpu"
        assert chain.device_mesh.devices == [torch.device("cpu")]
        assert tmesh.get_active_mesh() is chain.device_mesh
        assert tkey_table.get_table() is chain.device_key_table
        assert chain.device_key_table.status()["validators_resident"] == 8
        assert chain.duty_lookahead.device == "cpu" and chain.compile_service.device == "cpu"
        assert tservice.get_service() is chain.compile_service
        assert chain.verification_scheduler is not None and chain._key_table_listener
        assert tservice.msm_warm_enabled()
    finally:
        client.stop()
        tservice.set_msm_warm_enabled(False)
    assert tkey_table.get_table() is None and tmesh.get_active_mesh() is None
    assert tservice.get_service() is None


def test_bn_entry_point_comes_up_and_stops_on_sigterm(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "lighthouse_tpu_torch", "bn", "--bls-backend", "fake",
         "--preset", "minimal", "--interop-validators", "8", "--http-port", "0",
         "--datadir", str(tmp_path)],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("beacon node up"):
                break
        assert line.startswith("beacon node up"), line
        port = int(line.split("127.0.0.1:")[1].split()[0])
        assert _get(port, "/eth/v1/node/health")[0] == 200
        assert (tmp_path / "beacon.lock").exists()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not (tmp_path / "beacon.lock").exists()
