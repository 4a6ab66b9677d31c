"""Standard Beacon API over the stdlib threading HTTP server (reference:
``beacon_node/http_api/src/lib.rs`` — one router over the chain; routes
from ``:483``; plus the ``/metrics`` scrape endpoint of
``beacon_node/http_metrics``).

Routes implemented (the set the validator client + checkpoint sync
consume):

    GET  /eth/v1/node/health | /eth/v1/node/version | /eth/v1/node/syncing
    GET  /eth/v1/beacon/genesis
    GET  /eth/v1/beacon/states/{state_id}/root
    GET  /eth/v1/beacon/states/{state_id}/fork
    GET  /eth/v1/beacon/states/{state_id}/finality_checkpoints
    GET  /eth/v1/beacon/states/{state_id}/validators
    GET  /eth/v1/beacon/headers/{block_id}
    GET  /eth/v2/beacon/blocks/{block_id}            (+ .ssz via Accept)
    POST /eth/v1/beacon/blocks
    GET/POST /eth/v1/beacon/pool/attestations
    POST /eth/v1/beacon/pool/voluntary_exits
    POST /eth/v1/beacon/pool/attester_slashings
    POST /eth/v1/beacon/pool/proposer_slashings
    GET  /eth/v1/beacon/states/{state_id}/committees
    GET  /eth/v1/node/identity | /eth/v1/node/peers
    GET  /eth/v1/beacon/light_client/{bootstrap/{root},finality_update,optimistic_update}
    POST /eth/v1/beacon/pool/sync_committees
    GET  /eth/v2/debug/beacon/states/{state_id}  (SSZ, checkpoint sync)
    GET  /eth/v1/config/spec
    GET  /eth/v1/validator/duties/proposer/{epoch}
    POST /eth/v1/validator/duties/attester/{epoch}
    POST /eth/v1/validator/duties/sync/{epoch}
    GET  /eth/v2/validator/blocks/{slot}
    GET  /eth/v1/validator/attestation_data
    GET  /eth/v1/validator/aggregate_attestation
    POST /eth/v1/validator/aggregate_and_proofs
    GET  /eth/v1/validator/blinded_blocks/{slot}
    POST /eth/v1/beacon/blinded_blocks
    GET  /eth/v1/beacon/rewards/blocks/{block_id}
    POST /eth/v1/beacon/rewards/attestations/{epoch}
    POST /eth/v1/validator/liveness/{epoch}
    GET  /eth/v1/node/peer_count | /eth/v1/node/peers/{peer_id}
    GET  /eth/v1/beacon/headers (+ ?slot= / ?parent_root= filters)
    GET  /eth/v1/beacon/blocks/{block_id}/root
    GET  /eth/v1/beacon/blocks/{block_id}/attestations
    GET  /eth/v1/beacon/states/{state_id}/validators/{validator_id}
    GET  /eth/v1/beacon/deposit_snapshot
    GET  /eth/v1/debug/beacon/heads
    GET  /lighthouse/health (short-TTL cached snapshot, see below)
    GET  /lighthouse/timeseries (?family=&window=&tier= filters)
    GET  /lighthouse/slots (?view=slots|epochs, ?last=N)
    GET  /lighthouse/incidents (?limit=N, ?open=1 — the watchtower ledger)
    GET  /metrics
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..ssz import hash_tree_root
from ..ssz.json import from_json, to_json
from ..state_transition import (
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
    partial_state_advance,
)
from ..state_transition.epoch import fork_of
from ..beacon_chain.pubkey_cache import PubkeyCacheError
from ..types.containers import FORK_IDS as _FORK_IDS
from ..utils import metrics, tracing

_HTTP_REQS = metrics.counter_vec(
    "http_api_requests_total",
    "beacon API requests by method and response code",
    ("method", "code"),
)
_HTTP_SECONDS = metrics.histogram(
    "http_api_request_seconds", "beacon API request handling wall time"
)

# /lighthouse/health snapshot TTL: assembling the
# document walks EVERY collector — scheduler, ledgers, profiler, mesh,
# capacity — so concurrent scrapers (dashboards + the watchtower
# evaluator's health provider) must not multiply that cost on the HTTP
# threads. 0 disables caching (every scrape re-collects).
try:
    _HEALTH_TTL_S = max(
        0.0, float(os.environ.get("LIGHTHOUSE_TPU_HEALTH_TTL_S", "") or 1.0)
    )
except ValueError:
    _HEALTH_TTL_S = 1.0


def build_health_doc(chain) -> dict:
    """Assemble the ONE consolidated node-health document (reference:
    the lighthouse-specific API namespace pulls common/system_health +
    monitoring_api process/beacon data): host stats, process + beacon-
    node state, beacon-processor queue depths, peer counts, and every
    instrument's own block — the page an operator reads first when the
    node misbehaves. Module-level so the watchtower's incident bundles
    can snapshot the same document the endpoint serves; callers wanting
    the short-TTL cache go through ``BeaconApiServer._health_doc``."""
    from ..utils import (
        fault_injection,
        flight_recorder,
        monitoring,
        pipeline_profiler,
        slot_ledger,
        system_health,
        timeseries,
        transfer_ledger,
        watchtower,
    )

    doc = {"system": system_health.observe()}
    try:
        doc.update(monitoring.collect(chain))
    except Exception as e:  # a degraded chain still reports hosts
        doc["collect_error"] = repr(e)
    proc = getattr(chain, "beacon_processor", None)
    doc["beacon_processor"] = (
        None
        if proc is None
        else {
            "queues": proc.queue_lengths(),
            "dropped_total": metrics.get(
                "beacon_processor_dropped_total"
            ).value,
        }
    )
    # derived from the collected doc: one transport read, one fact —
    # and UNKNOWN (null) when collect failed, never a fabricated
    # "0 peers" on the page operators read first
    bn = doc.get("beacon_node")
    doc["network"] = (
        None if bn is None else {"peer_count": bn.get("peers", 0)}
    )
    doc["flight_recorder"] = flight_recorder.status()
    # continuous-batching scheduler: queue depth + batch occupancy
    # (null when the chain runs without one)
    sched = getattr(chain, "verification_scheduler", None)
    doc["verification_scheduler"] = (
        None if sched is None else sched.status()
    )
    # verdict-latency SLO: rolling p50/p99 + deadline-miss ratio per
    # caller kind over the scheduler's sample window (null when the
    # chain runs without a scheduler) — the page that answers "what
    # are submitters experiencing right now", certified offline by
    # tools/traffic_replay.py (docs/TRAFFIC_REPLAY.md)
    doc["slo"] = None if sched is None else sched.slo_summary()
    # AOT compile service: warm-shape surface, compile queue and
    # persistent-cache state (null when the node runs without one)
    csvc = getattr(chain, "compile_service", None)
    doc["compile_service"] = None if csvc is None else csvc.status()
    # data-movement ledger: per-operand/per-kind H2D bytes,
    # pack-phase seconds + pack share of verify wall, repeat-pubkey
    # re-upload window, device memory — the evidence base for the
    # device-resident pubkey table (ROADMAP item 2); rendered by
    # tools/transfer_report.py
    doc["data_movement"] = transfer_ledger.summary()
    # device-resident pubkey table: residency, index-shipped
    # vs raw-shipped sets (hit ratio), the aggregate-sum cache and
    # upload accounting (null when the node runs without one)
    ktable = getattr(chain, "device_key_table", None)
    doc["key_table"] = None if ktable is None else ktable.status()
    # duty-lookahead precompute: worker state, warmed epoch,
    # per-path committee counts, pre-insert outcomes and the
    # failure/backoff posture (null when the node runs without the
    # worker — no key table, or disabled by config/env)
    lookahead = getattr(chain, "duty_lookahead", None)
    doc["duty_lookahead"] = None if lookahead is None else lookahead.status()
    # served dp mesh: per-chip sets/s, shard health,
    # per-chip device memory and the aggregate throughput the dp axis
    # delivers (null when the node runs single-device)
    dmesh = getattr(chain, "device_mesh", None)
    doc["mesh"] = None if dmesh is None else dmesh.status()
    # pipeline-occupancy profiler: per-shard device bubble
    # ratios with cause attribution, flush critical-path phase totals,
    # flush-thread saturation and the overlap-potential projection —
    # the evidence base for ROADMAP item 5; rendered by
    # tools/pipeline_report.py
    doc["pipeline"] = pipeline_profiler.summary()
    # fault injection: armed fault points + their
    # call/injection counters — served ONLY while a chaos run is
    # armed; a production node without chaos config shows null here
    # (and pays one global check per fault seam)
    doc["fault_injection"] = (
        fault_injection.status() if fault_injection.armed() else None
    )
    # capacity & saturation: the timeseries sampler's state
    # + memory accounting, the sampled family catalogue and the latest
    # capacity/headroom estimate — the dial ROADMAP item 2's admission
    # control reads; history at /lighthouse/timeseries, rendered by
    # tools/capacity_report.py
    doc["capacity"] = timeseries.capacity_summary()
    # chain-time attribution: the slot ledger's rollup
    # state — current slot/epoch, retained report cards, lifetime
    # totals and the latest epoch's first-sighting ratio (ROADMAP
    # item 3's go/no-go dial); per-slot cards at /lighthouse/slots,
    # rendered by tools/slot_report.py
    doc["chain_time"] = slot_ledger.summary()
    # the watchtower: per-detector state (armed/firing/
    # latched/cooldown), incident accounting, evaluator + bundle
    # config; the incident ledger itself at /lighthouse/incidents,
    # bundles rendered by tools/incident_report.py
    doc["watchtower"] = watchtower.summary()
    return doc


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class BeaconApiServer:
    """``chain`` is the BeaconChain; ``op_pool`` its pool. Runs on a
    daemon thread; ``port=0`` picks a free port (tests)."""

    def __init__(self, chain, host: str = "127.0.0.1", port: int = 5052):
        self.chain = chain
        # blinded-block flow: payload-header root -> full payload, filled
        # at blinded production, consumed (popped) at blinded submission
        # (the in-process stand-in for the builder's payload reveal);
        # bounded FIFO so polling production cannot leak payloads
        from collections import OrderedDict as _OD

        self._payload_cache: dict = _OD()
        self._payload_cache_cap = 8
        # handlers run on ThreadingHTTPServer threads: insert/evict/pop race
        self._payload_cache_lock = threading.Lock()
        # short-TTL /lighthouse/health snapshot:
        # N concurrent scrapes inside the TTL do ONE underlying collect
        # (pinned by the stampede test); (monotonic_t, doc)
        self._health_lock = threading.Lock()
        self._health_cache: tuple = (0.0, None)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                outer._dispatch(self, "GET")

            def do_POST(self):
                outer._dispatch(self, "POST")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def _health_doc(self) -> dict:
        """The ``/lighthouse/health`` document through the short-TTL
        snapshot cache: scrapes landing inside ``_HEALTH_TTL_S`` of the
        last collect are served the cached document; the collect runs
        UNDER the lock so a thundering herd does exactly one walk. TTL
        0 disables caching."""
        if _HEALTH_TTL_S <= 0:
            return build_health_doc(self.chain)
        with self._health_lock:
            t, doc = self._health_cache
            if doc is not None and time.monotonic() - t < _HEALTH_TTL_S:
                return doc
            doc = build_health_doc(self.chain)
            self._health_cache = (time.monotonic(), doc)
            return doc

    # -- plumbing --------------------------------------------------------

    def _dispatch(self, req, method: str) -> None:
        url = urlparse(req.path)
        # repeated params join to a comma list (the spec's ?id=1&id=2 and
        # ?id=1,2 forms become equivalent)
        query = {k: ",".join(v) for k, v in parse_qs(url.query).items()}
        counted = False  # one request = one http_api_requests_total sample
        try:
            body = None
            if method == "POST":
                n = int(req.headers.get("Content-Length") or 0)
                raw = req.rfile.read(n) if n else b""
                try:
                    body = json.loads(raw) if raw else None
                except json.JSONDecodeError as e:
                    # a counted 400, not an uncounted dropped connection
                    raise ApiError(400, f"malformed JSON body: {e}")
            if url.path == "/eth/v1/events":
                if method != "GET":
                    raise ApiError(405, "GET only")
                # SSE streams until disconnect: counted once it ends
                # cleanly, never timed; a failure mid-setup falls through
                # to the 500 accounting below
                self._stream_events(req, query)
                _HTTP_REQS.with_labels(method, "200").inc()
                counted = True
                return
            with tracing.span(
                "http_api.request", method=method, path=url.path
            ), _HTTP_SECONDS.time():
                out = self._route(method, url.path, query, body)
            if out is None:
                payload, ctype = b"", "application/json"
            elif isinstance(out, bytes):
                payload, ctype = out, "application/octet-stream"
            elif isinstance(out, str):
                payload, ctype = out.encode(), "text/plain; charset=utf-8"
            else:
                payload, ctype = json.dumps(out).encode(), "application/json"
            # counted only once the response is fully serialized: a
            # serialization bug is a 500, a failed write after this point
            # is the client going away (not re-counted)
            _HTTP_REQS.with_labels(method, "200").inc()
            counted = True
            req.send_response(200)
            req.send_header("Content-Type", ctype)
            req.send_header("Content-Length", str(len(payload)))
            req.end_headers()
            req.wfile.write(payload)
        except ApiError as e:
            if not counted:
                _HTTP_REQS.with_labels(method, str(e.status)).inc()
            payload = json.dumps(
                {"code": e.status, "message": e.message}
            ).encode()
            req.send_response(e.status)
            req.send_header("Content-Type", "application/json")
            req.send_header("Content-Length", str(len(payload)))
            req.end_headers()
            req.wfile.write(payload)
        except Exception as e:  # internal error -> 500 with message
            # a write failure after the 200 was counted (client went
            # away) must not re-count the request as a 500
            if not counted:
                _HTTP_REQS.with_labels(method, "500").inc()
            payload = json.dumps({"code": 500, "message": repr(e)}).encode()
            try:
                req.send_response(500)
                req.send_header("Content-Type", "application/json")
                req.send_header("Content-Length", str(len(payload)))
                req.end_headers()
                req.wfile.write(payload)
            except Exception:
                pass

    def _stream_events(self, req, query) -> None:
        """Server-sent events (reference http_api ``events`` route):
        ``head`` and ``finalized_checkpoint`` topics, polled off the
        chain's canonical head; streams until the client disconnects
        (periodic keepalive comments bound disconnect detection and stop
        dead-connection threads accumulating)."""
        import time as _time

        topics = set((query.get("topics") or "head").split(","))
        chain = self.chain
        req.send_response(200)
        req.send_header("Content-Type", "text/event-stream")
        req.send_header("Cache-Control", "no-cache")
        req.end_headers()
        last_head = None
        last_epoch = None
        # a new subscriber must NOT get a synthetic event for a
        # finalization that happened long ago
        last_fin = chain.fork_choice.store.finalized_checkpoint
        last_write = _time.monotonic()
        try:
            while True:
                head = chain.head_block_root
                if "head" in topics and head != last_head:
                    last_head = head
                    # derive slot + state root from the STORED block:
                    # immune to the non-atomic head_block_root/head_state
                    # update in recompute_head
                    block = chain.store.get_block(head)
                    if block is not None:
                        slot = block.message.slot
                        state_root = bytes(block.message.state_root)
                    else:  # anchor edge: fall back to the state
                        state = chain.head_state
                        slot = state.slot
                        state_root = hash_tree_root(state)
                    epoch = slot // chain.preset.SLOTS_PER_EPOCH
                    data = {
                        "slot": str(slot),
                        "block": "0x" + head.hex(),
                        "state": "0x" + state_root.hex(),
                        "epoch_transition": (
                            last_epoch is not None and epoch != last_epoch
                        ),
                    }
                    last_epoch = epoch
                    req.wfile.write(
                        b"event: head\ndata: " + json.dumps(data).encode() + b"\n\n"
                    )
                    req.wfile.flush()
                    last_write = _time.monotonic()
                fin = chain.fork_choice.store.finalized_checkpoint
                if "finalized_checkpoint" in topics and fin != last_fin:
                    last_fin = fin
                    data = {
                        "epoch": str(fin[0]),
                        "block": "0x" + fin[1].hex(),
                    }
                    req.wfile.write(
                        b"event: finalized_checkpoint\ndata: "
                        + json.dumps(data).encode() + b"\n\n"
                    )
                    req.wfile.flush()
                    last_write = _time.monotonic()
                if _time.monotonic() - last_write > 5.0:
                    req.wfile.write(b":keepalive\n\n")
                    req.wfile.flush()
                    last_write = _time.monotonic()
                _time.sleep(0.2)
        except (BrokenPipeError, ConnectionResetError, OSError):
            return

    # -- state/block resolution ------------------------------------------

    def _state_for(self, state_id: str):
        chain = self.chain
        if state_id == "head":
            return chain.head_state
        if state_id == "genesis":
            return chain.store.get_state(chain.store.get_genesis_state_root())
        if state_id == "finalized":
            _, root = chain.fork_choice.store.finalized_checkpoint
            block = chain.store.get_block(root)
            if block is None:
                return chain.head_state
            return chain.store.get_state(bytes(block.message.state_root))
        if state_id.startswith("0x"):
            st = chain.store.get_state(bytes.fromhex(state_id[2:]))
            if st is None:
                raise ApiError(404, f"state {state_id} not found")
            return st
        raise ApiError(400, f"unsupported state id {state_id!r}")

    def _block_for(self, block_id: str):
        chain = self.chain
        if block_id == "head":
            root = chain.head_block_root
        elif block_id == "genesis":
            root = chain.genesis_block_root
        elif block_id == "finalized":
            _, root = chain.fork_choice.store.finalized_checkpoint
        elif block_id.startswith("0x"):
            root = bytes.fromhex(block_id[2:])
        else:
            raise ApiError(400, f"unsupported block id {block_id!r}")
        block = chain.store.get_block(root)
        if block is None:
            raise ApiError(404, f"block {block_id} not found")
        return root, block

    # -- router ----------------------------------------------------------

    def _route(self, method, path, query, body):
        chain = self.chain
        t = chain.types

        if path == "/eth/v1/node/health":
            return None
        if path == "/eth/v1/node/version":
            return {"data": {"version": "lighthouse_tpu/0.2.0"}}
        if path == "/eth/v1/node/syncing":
            head_slot = chain.head_state.slot
            current = chain.slot()
            return {
                "data": {
                    "head_slot": str(head_slot),
                    "sync_distance": str(max(0, current - head_slot)),
                    "is_syncing": current > head_slot + 1,
                    "is_optimistic": False,
                    "el_offline": False,
                }
            }
        if path == "/eth/v1/beacon/genesis":
            st = chain.store.get_state(chain.store.get_genesis_state_root())
            return {
                "data": {
                    "genesis_time": str(st.genesis_time),
                    "genesis_validators_root": "0x"
                    + bytes(st.genesis_validators_root).hex(),
                    "genesis_fork_version": "0x"
                    + bytes(chain.spec.genesis_fork_version).hex(),
                }
            }
        if path == "/eth/v1/config/spec":
            return {"data": chain.spec.to_api_dict(chain.preset)}
        if path == "/eth/v1/config/deposit_contract":
            return {
                "data": {
                    "chain_id": str(chain.spec.deposit_chain_id),
                    "address": "0x"
                    + bytes(chain.spec.deposit_contract_address).hex(),
                }
            }
        if path == "/eth/v1/config/fork_schedule":
            spec = chain.spec
            entries = []
            prev_version = spec.genesis_fork_version
            for fork in ("phase0", "altair", "bellatrix"):
                epoch = spec.fork_epoch_for(fork)
                if epoch is None:
                    continue
                version = spec.fork_version_for(fork)
                entries.append(
                    {
                        "previous_version": "0x" + bytes(prev_version).hex(),
                        "current_version": "0x" + bytes(version).hex(),
                        "epoch": str(epoch),
                    }
                )
                prev_version = version
            return {"data": entries}
        if path == "/metrics":
            return metrics.gather()
        if path == "/lighthouse/health":
            # the consolidated node-health document (assembled by
            # build_health_doc) through the short-TTL snapshot cache —
            # concurrent scrapes do ONE collector walk per TTL
            return {"data": self._health_doc()}
        if path == "/lighthouse/flight_recorder":
            # live journal tail: ?kind=a,b filters, ?limit=N bounds the
            # reply (newest events win); recorder status rides along
            from ..utils import flight_recorder

            kinds = None
            if "kind" in query:
                kinds = [k for k in query["kind"].split(",") if k]
            try:
                limit = int(query.get("limit", "256"))
            except ValueError:
                raise ApiError(400, "malformed limit parameter")
            return {
                "data": {
                    **flight_recorder.status(),
                    "events": flight_recorder.events(kinds=kinds, limit=limit),
                }
            }
        if path == "/lighthouse/timeseries":
            # retained on-node metrics history: ?family=a,b
            # filters to those series families, ?tier=raw|1m|10m picks
            # the downsampling tier, ?window=SECONDS keeps only points
            # newer than now − window. The latest capacity estimate
            # rides along so one fetch answers "how much headroom, and
            # which way is it trending".
            from ..utils import timeseries

            families = None
            if "family" in query:
                families = [f for f in query["family"].split(",") if f]
            tier = query.get("tier", "raw")
            window_s = None
            if "window" in query:
                try:
                    window_s = float(query["window"])
                except ValueError:
                    raise ApiError(400, "malformed window parameter")
                # nan compares False against every timestamp (silently
                # empty series), negative/inf windows are nonsense —
                # all are 400s per the documented grammar
                if window_s != window_s or window_s < 0 \
                        or window_s == float("inf"):
                    raise ApiError(400, "malformed window parameter")
            try:
                doc = timeseries.get_store().doc(
                    families=families, tier=tier, window_s=window_s
                )
            except ValueError as e:
                raise ApiError(400, str(e))
            doc["estimate"] = timeseries.last_estimate()
            return {"data": doc}
        if path == "/lighthouse/slots":
            # per-slot report cards: ?view=slots (default)
            # serves the retained slot cards, ?view=epochs the epoch
            # first-sighting rollup; ?last=N keeps only the N newest
            # rows. Lifetime + evicted totals ride along so a reader
            # can verify conservation (retained + evicted == lifetime)
            # from one fetch.
            from ..utils import slot_ledger

            view = query.get("view", "slots")
            if view not in ("slots", "epochs"):
                raise ApiError(400, "malformed view parameter")
            last = None
            if "last" in query:
                try:
                    last = int(query["last"])
                except ValueError:
                    raise ApiError(400, "malformed last parameter")
                if last < 0:
                    raise ApiError(400, "malformed last parameter")
            rows = (
                slot_ledger.slot_cards(last=last)
                if view == "slots"
                else slot_ledger.epoch_cards(last=last)
            )
            return {
                "data": {
                    "schema": slot_ledger.SCHEMA,
                    "view": view,
                    "chain_time": slot_ledger.summary(),
                    "rows": rows,
                    "lifetime": slot_ledger.lifetime_totals(),
                    "evicted": slot_ledger.evicted_totals(),
                }
            }
        if path == "/lighthouse/incidents":
            # the watchtower's incident ledger: ?limit=N
            # keeps the newest rows, ?open=1 filters to still-open
            # incidents; the per-detector state block and the declared
            # catalogue ride along so one fetch answers "what is
            # armed, what fired, and what does it watch". Bundles on
            # disk (schema lighthouse_tpu.incident/1) are rendered by
            # tools/incident_report.py.
            from ..utils import watchtower

            limit = None
            if "limit" in query:
                try:
                    limit = int(query["limit"])
                except ValueError:
                    raise ApiError(400, "malformed limit parameter")
                if limit < 0:
                    raise ApiError(400, "malformed limit parameter")
            open_q = query.get("open", "0")
            if open_q not in ("0", "1"):
                raise ApiError(400, "malformed open parameter")
            return {
                "data": {
                    "bundle_schema": watchtower.SCHEMA,
                    "watchtower": watchtower.summary(),
                    "catalogue": watchtower.catalogue(),
                    "incidents": watchtower.incidents(
                        limit=limit, open_only=open_q == "1"
                    ),
                }
            }


        m = re.fullmatch(r"/eth/v1/beacon/states/([^/]+)/root", path)
        if m:
            st = self._state_for(m.group(1))
            return {"data": {"root": "0x" + hash_tree_root(st).hex()}}
        m = re.fullmatch(r"/eth/v1/beacon/states/([^/]+)/fork", path)
        if m:
            st = self._state_for(m.group(1))
            return {"data": to_json(type(st.fork), st.fork)}
        m = re.fullmatch(
            r"/eth/v1/beacon/states/([^/]+)/finality_checkpoints", path
        )
        if m:
            st = self._state_for(m.group(1))
            cp = lambda c: {"epoch": str(c.epoch), "root": "0x" + bytes(c.root).hex()}
            return {
                "data": {
                    "previous_justified": cp(st.previous_justified_checkpoint),
                    "current_justified": cp(st.current_justified_checkpoint),
                    "finalized": cp(st.finalized_checkpoint),
                }
            }
        m = re.fullmatch(r"/eth/v1/beacon/states/([^/]+)/validator_balances", path)
        if m:
            st = self._state_for(m.group(1))
            ids = _parse_validator_ids(query)
            out = []
            for i, bal in enumerate(st.balances):
                if ids is not None:
                    pk_hex = "0x" + bytes(st.validators[i].pubkey).hex()
                    if str(i) not in ids and pk_hex not in ids:
                        continue
                out.append({"index": str(i), "balance": str(bal)})
            return {"data": out}

        m = re.fullmatch(r"/eth/v1/beacon/states/([^/]+)/sync_committees", path)
        if m:
            st = self._state_for(m.group(1))
            if fork_of(st) == "phase0":
                raise ApiError(400, "state has no sync committees (phase0)")
            P = chain.preset
            state_epoch = int(st.slot) // P.SLOTS_PER_EPOCH
            period = state_epoch // P.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
            committee = st.current_sync_committee
            if "epoch" in query:
                want_period = int(query["epoch"]) // P.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
                if want_period == period + 1:
                    committee = st.next_sync_committee
                elif want_period != period:
                    raise ApiError(
                        400, f"epoch outside the state's sync-committee periods"
                    )
            indices = []
            for pk in committee.pubkeys:
                idx = chain.pubkey_cache.get_index(bytes(pk))
                if idx is not None:
                    indices.append(idx)
            sub = P.sync_subcommittee_size or 1
            aggregates = [
                [str(i) for i in indices[k : k + sub]]
                for k in range(0, len(indices), sub)
            ]
            return {
                "data": {
                    "validators": [str(i) for i in indices],
                    "validator_aggregates": aggregates,
                }
            }

        m = re.fullmatch(r"/eth/v1/beacon/pool/(voluntary_exits|attester_slashings|proposer_slashings)", path)
        if m and method == "GET":
            pool = chain.op_pool
            if pool is None:
                return {"data": []}
            kind = m.group(1)
            tpe = {
                "voluntary_exits": t.SignedVoluntaryExit,
                "attester_slashings": t.AttesterSlashing,
                "proposer_slashings": t.ProposerSlashing,
            }[kind]
            return {"data": [to_json(tpe, o) for o in pool.contents()[kind]]}

        m = re.fullmatch(r"/eth/v1/beacon/states/([^/]+)/validators", path)
        if m:
            st = self._state_for(m.group(1))
            ids = _parse_validator_ids(query)
            out = []
            for i, (v, bal) in enumerate(zip(st.validators, st.balances)):
                pk_hex = "0x" + bytes(v.pubkey).hex()
                if ids is not None and str(i) not in ids and pk_hex not in ids:
                    continue
                out.append(
                    {
                        "index": str(i),
                        "balance": str(bal),
                        "status": _validator_status(chain.preset, st, v),
                        "validator": to_json(type(v), v),
                    }
                )
            return {"data": out}

        m = re.fullmatch(r"/eth/v1/beacon/states/([^/]+)/committees", path)
        if m:
            st = self._state_for(m.group(1))
            P = chain.preset
            try:
                epoch = (
                    int(query["epoch"])
                    if "epoch" in query
                    else st.slot // P.SLOTS_PER_EPOCH
                )
                want_slot = int(query["slot"]) if "slot" in query else None
                want_index = int(query["index"]) if "index" in query else None
            except ValueError:
                raise ApiError(400, "malformed epoch/slot/index parameter")
            head_epoch = chain.head_state.slot // P.SLOTS_PER_EPOCH
            # lookahead is only defined one epoch out; unbounded epochs
            # would make the shuffling cache advance a state arbitrarily
            # far (CPU DoS)
            if epoch > head_epoch + 1:
                raise ApiError(400, f"epoch {epoch} beyond lookahead")
            cache = chain.shuffling_cache.get(chain, epoch, chain.head_block_root)
            out = []
            for slot in range(
                epoch * P.SLOTS_PER_EPOCH, (epoch + 1) * P.SLOTS_PER_EPOCH
            ):
                if want_slot is not None and slot != want_slot:
                    continue
                for index in range(cache.committees_per_slot):
                    if want_index is not None and index != want_index:
                        continue
                    out.append(
                        {
                            "index": str(index),
                            "slot": str(slot),
                            "validators": [
                                str(int(v)) for v in cache.committee(slot, index)
                            ],
                        }
                    )
            return {"data": out}

        if path == "/eth/v1/node/identity":
            net = getattr(chain, "network", None)
            return {
                "data": {
                    "peer_id": f"lighthouse_tpu-{chain.genesis_block_root.hex()[:8]}",
                    "enr": "",
                    "p2p_addresses": (
                        [f"/ip4/127.0.0.1/tcp/{net.port}"] if net else []
                    ),
                    "discovery_addresses": [],
                    "metadata": {"seq_number": "0", "attnets": "0x" + "ff" * 8},
                }
            }
        if path == "/eth/v1/node/peers":
            net = getattr(chain, "network", None)
            peers = []
            if net is not None:
                peers = [_peer_json(p) for p in net.transport.peers_snapshot()]
            return {"data": peers, "meta": {"count": len(peers)}}

        m = re.fullmatch(r"/eth/v1/beacon/light_client/bootstrap/([^/]+)", path)
        if m:
            from ..beacon_chain.light_client import produce_bootstrap

            # the id is a BLOCK root per the beacon-API spec
            _root, block = self._block_for(m.group(1))
            st = chain.store.get_state(bytes(block.message.state_root))
            if st is None:
                raise ApiError(404, "state for bootstrap block unavailable")
            if not hasattr(st, "current_sync_committee"):
                raise ApiError(400, "pre-altair state has no light-client data")
            boot = produce_bootstrap(chain, st)
            return {"version": fork_of(st), "data": to_json(type(boot), boot)}
        if path == "/eth/v1/beacon/light_client/finality_update":
            from ..beacon_chain.light_client import produce_finality_update

            if not hasattr(chain.head_state, "current_sync_committee"):
                raise ApiError(400, "pre-altair state has no light-client data")
            upd = produce_finality_update(chain)
            if upd is None:
                raise ApiError(404, "no finality yet")
            return {
                "version": fork_of(chain.head_state),
                "data": to_json(type(upd), upd),
            }
        if path == "/eth/v1/beacon/light_client/optimistic_update":
            from ..beacon_chain.light_client import produce_optimistic_update

            if not hasattr(chain.head_state, "current_sync_committee"):
                raise ApiError(400, "pre-altair state has no light-client data")
            upd = produce_optimistic_update(chain)
            return {
                "version": fork_of(chain.head_state),
                "data": to_json(type(upd), upd),
            }

        m = re.fullmatch(r"/eth/v2/debug/beacon/states/([^/]+)", path)
        if m:
            # SSZ bytes (checkpoint-sync serving, reference http_api
            # debug routes + SURVEY §5 checkpoint sync)
            st = self._state_for(m.group(1))
            return bytes([_FORK_IDS[fork_of(st)]]) + type(st).encode(st)

        m = re.fullmatch(r"/eth/v1/beacon/headers/([^/]+)", path)
        if m:
            root, block = self._block_for(m.group(1))
            msg = block.message
            header = {
                "slot": str(msg.slot),
                "proposer_index": str(msg.proposer_index),
                "parent_root": "0x" + bytes(msg.parent_root).hex(),
                "state_root": "0x" + bytes(msg.state_root).hex(),
                "body_root": "0x" + hash_tree_root(msg.body).hex(),
            }
            return {
                "data": {
                    "root": "0x" + root.hex(),
                    "canonical": True,
                    "header": {
                        "message": header,
                        "signature": "0x" + bytes(block.signature).hex(),
                    },
                }
            }
        if path == "/eth/v1/beacon/headers":
            # canonical head when unfiltered; ?slot= / ?parent_root= list
            # matching blocks across the fork-choice DAG (reference
            # http_api/src/lib.rs:975 block_headers)
            proto = chain.fork_choice.proto
            head_root = chain.head_block_root
            matches = []
            if "slot" in query or "parent_root" in query:
                want_slot = int(query["slot"]) if "slot" in query else None
                want_parent = (
                    bytes.fromhex(query["parent_root"][2:])
                    if "parent_root" in query
                    else None
                )
                for node in proto.nodes:
                    if want_slot is not None and node.slot != want_slot:
                        continue
                    if want_parent is not None:
                        p = proto.nodes[node.parent] if node.parent is not None else None
                        if p is None or p.root != want_parent:
                            continue
                    matches.append(node.root)
            else:
                matches = [head_root]
            out = []
            for root in matches:
                block = chain.store.get_block(root)
                if block is None:
                    continue
                canonical = (
                    proto.ancestor_at_slot(head_root, block.message.slot) == root
                )
                out.append(_header_json(root, block, canonical))
            return {"data": out}
        m = re.fullmatch(r"/eth/v1/beacon/blocks/([^/]+)/root", path)
        if m:
            root, _ = self._block_for(m.group(1))
            return {"data": {"root": "0x" + root.hex()}}
        m = re.fullmatch(r"/eth/v1/beacon/blocks/([^/]+)/attestations", path)
        if m:
            root, block = self._block_for(m.group(1))
            return {
                "version": _fork_of_block(t, block),
                "data": [
                    to_json(type(a), a)
                    for a in block.message.body.attestations
                ],
            }
        m = re.fullmatch(
            r"/eth/v1/beacon/states/([^/]+)/validators/([^/]+)", path
        )
        if m:
            st = self._state_for(m.group(1))
            vid = m.group(2)
            idx = None
            if vid.startswith("0x"):
                try:
                    pk = bytes.fromhex(vid[2:])
                except ValueError:
                    raise ApiError(400, f"malformed pubkey {vid!r}")
                for i, v in enumerate(st.validators):
                    if bytes(v.pubkey) == pk:
                        idx = i
                        break
            else:
                try:
                    idx = int(vid)
                except ValueError:
                    raise ApiError(400, f"malformed validator id {vid!r}")
            if idx is None or not 0 <= idx < len(st.validators):
                raise ApiError(404, f"validator {vid} not found")
            v = st.validators[idx]
            return {
                "data": {
                    "index": str(idx),
                    "balance": str(st.balances[idx]),
                    "status": _validator_status(chain.preset, st, v),
                    "validator": to_json(type(v), v),
                }
            }
        if path == "/eth/v1/beacon/deposit_snapshot":
            # EIP-4881 deposit-tree snapshot (reference :1657); served from
            # the eth1 service's incremental tree when wired
            eth1 = getattr(chain, "eth1", None)
            if eth1 is None:
                raise ApiError(404, "no eth1 service attached")
            with eth1._lock:
                count = len(eth1.deposits)
                tree = eth1.deposit_tree
                root = tree.root(count)
                # EIP-4881: roots of the complete left subtrees covering
                # `count` leaves (one per set bit, high to low)
                finalized = []
                acc = 0
                for d in range(len(tree.levels) - 1, -1, -1):
                    if count & (1 << d):
                        finalized.append(
                            "0x" + tree._node(d, acc >> d, count).hex()
                        )
                        acc += 1 << d
                # read under the SAME lock: a concurrent eth1 update must
                # not advance the block pointer past the snapshotted count
                blocks = eth1.blocks
                last = blocks[-1] if blocks else None
            return {
                "data": {
                    "finalized": finalized,
                    "deposit_root": "0x" + root.hex(),
                    "deposit_count": str(count),
                    "execution_block_hash": (
                        "0x" + last.hash.hex() if last else "0x" + "00" * 32
                    ),
                    "execution_block_height": str(last.number if last else 0),
                }
            }
        if path == "/eth/v1/debug/beacon/heads":
            # viable fork-choice leaves (reference :1821): nodes that are
            # no other node's parent
            proto = chain.fork_choice.proto
            parents = {n.parent for n in proto.nodes if n.parent is not None}
            out = [
                {
                    "slot": str(n.slot),
                    "root": "0x" + n.root.hex(),
                    "execution_optimistic": False,
                }
                for i, n in enumerate(proto.nodes)
                if i not in parents
            ]
            return {"data": out}
        m = re.fullmatch(r"/eth/v1/node/peers/([^/]+)", path)
        if m:
            net = getattr(chain, "network", None)
            if net is not None:
                for peer in net.transport.peers_snapshot():
                    if peer.node_id == m.group(1):
                        return {"data": _peer_json(peer)}
            raise ApiError(404, f"peer {m.group(1)} not known")
        m = re.fullmatch(r"/eth/v2/beacon/blocks/([^/]+)", path)
        if m:
            root, block = self._block_for(m.group(1))
            return {
                "version": _fork_of_block(t, block),
                "data": to_json(type(block), block),
            }
        if path == "/eth/v1/beacon/blocks" and method == "POST":
            fork = body.get("version") if isinstance(body, dict) and "version" in body else None
            payload = body["data"] if isinstance(body, dict) and "data" in body else body
            fork = fork or fork_of(chain.head_state)
            sb = from_json(t.signed_block[fork], payload)
            try:
                chain.process_block(sb)
            except Exception as e:
                raise ApiError(400, f"block rejected: {e}")
            _publish(chain, "publish_block", sb)
            return None

        if path == "/eth/v1/beacon/pool/attestations":
            if method == "GET":
                return {"data": []}  # pending pool dump (not tracked per-data)
            results = []
            for obj in body:
                att = from_json(t.Attestation, obj)
                try:
                    v = chain.verify_unaggregated_attestation_for_gossip(att)
                    chain.apply_attestation_to_fork_choice(v)
                    if chain.op_pool is not None:
                        chain.op_pool.insert_attestation(att)
                    _publish(chain, "publish_attestation", att, int(att.data.index))
                except Exception as e:
                    results.append(str(e))
            if results:
                raise ApiError(400, "; ".join(results))
            return None
        if path == "/eth/v1/beacon/pool/voluntary_exits" and method == "POST":
            ex = from_json(t.SignedVoluntaryExit, body)
            if chain.op_pool is not None:
                chain.op_pool.insert_voluntary_exit(ex)
            _publish(chain, "publish_voluntary_exit", ex)
            return None
        if path == "/eth/v1/beacon/pool/attester_slashings" and method == "POST":
            s = from_json(t.AttesterSlashing, body)
            if chain.op_pool is not None:
                chain.op_pool.insert_attester_slashing(s)
            chain.on_attester_slashing(s)
            _publish(chain, "publish_attester_slashing", s)
            return None
        if path == "/eth/v1/beacon/pool/proposer_slashings" and method == "POST":
            s = from_json(t.ProposerSlashing, body)
            if chain.op_pool is not None:
                chain.op_pool.insert_proposer_slashing(s)
            _publish(chain, "publish_proposer_slashing", s)
            return None

        if path == "/eth/v1/beacon/pool/sync_committees" and method == "POST":
            st = chain.head_state
            if not hasattr(st, "current_sync_committee"):
                raise ApiError(400, "pre-altair state has no sync committee")
            from ..crypto import bls as _bls
            from ..types.chain_spec import DOMAIN_SYNC_COMMITTEE
            from ..types.domains import compute_signing_root, get_domain

            rejected = 0
            for obj in body:
                vi = int(obj["validator_index"])
                slot = int(obj["slot"])
                if not 0 <= vi < len(st.validators):
                    rejected += 1
                    continue
                committee = _sync_committee_for_slot(chain, st, slot)
                if committee is None:
                    rejected += 1
                    continue
                pk_raw = bytes(st.validators[vi].pubkey)
                positions = [i for i, c in enumerate(committee) if c == pk_raw]
                if not positions:
                    rejected += 1
                    continue
                root = bytes.fromhex(obj["beacon_block_root"][2:])
                sig_raw = bytes.fromhex(obj["signature"][2:])
                # verify BEFORE pooling: a junk signature must never be
                # able to poison block production
                domain = get_domain(
                    chain.spec, st, DOMAIN_SYNC_COMMITTEE,
                    slot // chain.preset.SLOTS_PER_EPOCH,
                )
                signing_root = compute_signing_root(None, root, domain)
                try:
                    sig = _bls.Signature.deserialize(sig_raw)
                    pk = chain.pubkey_cache.get(vi)
                    ok = sig.verify(pk, signing_root)
                except (_bls.BlsError, PubkeyCacheError):
                    ok = False
                if not ok:
                    rejected += 1
                    continue
                for pos in positions:
                    chain.op_pool.insert_sync_committee_message(
                        slot, root, pos, sig_raw
                    )
                # propagate node->node on the per-subnet gossip topics
                # (reference topics.rs:19-20, sync_committee_{subnet})
                net = getattr(chain, "network", None)
                if net is not None:
                    msg = t.SyncCommitteeMessage(
                        slot=slot,
                        beacon_block_root=root,
                        validator_index=vi,
                        signature=sig_raw,
                    )
                    sub_size = chain.preset.sync_subcommittee_size
                    for subnet in sorted({p // sub_size for p in positions}):
                        net.publish_sync_committee_message(msg, subnet)
            if rejected:
                raise ApiError(400, f"{rejected} sync message(s) rejected")
            return None

        m = re.fullmatch(r"/eth/v1/validator/duties/sync/(\d+)", path)
        if m and method == "POST":
            st = chain.head_state
            if not hasattr(st, "current_sync_committee"):
                return {"data": []}
            epoch = int(m.group(1))
            committee_b = _sync_committee_for_epoch(chain, st, epoch)
            if committee_b is None:
                raise ApiError(
                    400, "epoch outside current/next sync-committee period"
                )
            wanted = {int(i) for i in (body or [])}
            committee = committee_b
            by_pk = {}
            for i, v in enumerate(st.validators):
                by_pk[bytes(v.pubkey)] = i
            duties = []
            seen = {}
            for pos, pk in enumerate(committee):
                vi = by_pk.get(pk)
                if vi is None or (wanted and vi not in wanted):
                    continue
                seen.setdefault(vi, []).append(pos)
            for vi, positions in seen.items():
                duties.append(
                    {
                        "pubkey": "0x" + bytes(st.validators[vi].pubkey).hex(),
                        "validator_index": str(vi),
                        "validator_sync_committee_indices": [
                            str(p) for p in positions
                        ],
                    }
                )
            return {"data": duties}

        m = re.fullmatch(r"/eth/v1/validator/duties/proposer/(\d+)", path)
        if m:
            epoch = int(m.group(1))
            P = chain.preset
            st = chain.head_state
            start = epoch * P.SLOTS_PER_EPOCH
            proposers = chain.proposers_for_epoch(epoch)
            duties = []
            for slot, proposer in zip(
                range(start, start + P.SLOTS_PER_EPOCH), proposers
            ):
                duties.append(
                    {
                        "pubkey": "0x"
                        + bytes(st.validators[proposer].pubkey).hex(),
                        "validator_index": str(proposer),
                        "slot": str(slot),
                    }
                )
            return {
                "dependent_root": "0x" + chain.head_block_root.hex(),
                "execution_optimistic": False,
                "data": duties,
            }
        m = re.fullmatch(r"/eth/v1/validator/duties/attester/(\d+)", path)
        if m:
            epoch = int(m.group(1))
            P = chain.preset
            wanted = {int(i) for i in (body or [])}
            st = chain.head_state
            cache = chain.shuffling_cache.get(chain, epoch, chain.head_block_root)
            duties = []
            for slot in range(
                epoch * P.SLOTS_PER_EPOCH, (epoch + 1) * P.SLOTS_PER_EPOCH
            ):
                for index in range(cache.committees_per_slot):
                    committee = cache.committee(slot, index)
                    for pos, vi in enumerate(committee):
                        vi = int(vi)
                        if wanted and vi not in wanted:
                            continue
                        duties.append(
                            {
                                "pubkey": "0x"
                                + bytes(st.validators[vi].pubkey).hex(),
                                "validator_index": str(vi),
                                "committee_index": str(index),
                                "committee_length": str(len(committee)),
                                "committees_at_slot": str(
                                    cache.committees_per_slot
                                ),
                                "validator_committee_index": str(pos),
                                "slot": str(slot),
                            }
                        )
            return {
                "dependent_root": "0x" + chain.head_block_root.hex(),
                "execution_optimistic": False,
                "data": duties,
            }
        m = re.fullmatch(r"/eth/v2/validator/blocks/(\d+)", path)
        if m:
            slot = int(m.group(1))
            randao = bytes.fromhex(query["randao_reveal"][2:])
            graffiti = (
                bytes.fromhex(query["graffiti"][2:])
                if "graffiti" in query
                else bytes(32)
            )
            block, _proposer = chain.produce_block_on_state(slot, randao, graffiti)
            return {
                "version": fork_of(chain.head_state),
                "data": to_json(type(block), block),
            }

        m = re.fullmatch(r"/eth/v1/validator/blinded_blocks/(\d+)", path)
        if m:
            # blinded production (reference http_api blinded-block routes +
            # builder flow): bellatrix payloads are replaced by their
            # header; the full payload is cached for the submit leg
            slot = int(m.group(1))
            randao = bytes.fromhex(query["randao_reveal"][2:])
            graffiti = (
                bytes.fromhex(query["graffiti"][2:])
                if "graffiti" in query
                else bytes(32)
            )
            block, _proposer = chain.produce_block_on_state(slot, randao, graffiti)
            fork = fork_of(chain.head_state)
            if fork != "bellatrix":
                return {"version": fork, "data": to_json(type(block), block)}
            blinded, payload = _blind_block(t, block)
            header = blinded.body.execution_payload_header
            with self._payload_cache_lock:
                self._payload_cache[
                    hash_tree_root(t.ExecutionPayloadHeader, header)
                ] = payload
                while len(self._payload_cache) > self._payload_cache_cap:
                    self._payload_cache.popitem(last=False)
            return {
                "version": fork,
                "data": to_json(t.BlindedBeaconBlockBellatrix, blinded),
            }

        if path == "/eth/v1/beacon/blinded_blocks" and method == "POST":
            payload_json = (
                body["data"] if isinstance(body, dict) and "data" in body else body
            )
            fork = fork_of(chain.head_state)
            if fork != "bellatrix":
                sb = from_json(t.signed_block[fork], payload_json)
            else:
                sbb = from_json(t.SignedBlindedBeaconBlockBellatrix, payload_json)
                header = sbb.message.body.execution_payload_header
                with self._payload_cache_lock:
                    payload = self._payload_cache.pop(
                        hash_tree_root(t.ExecutionPayloadHeader, header), None
                    )
                if payload is None:
                    raise ApiError(400, "unknown payload header (not produced here)")
                bb = sbb.message
                full_body = t.block_body["bellatrix"](
                    **{
                        name: getattr(bb.body, name)
                        for name, _ in t.BlindedBeaconBlockBodyBellatrix.fields
                        if name != "execution_payload_header"
                    },
                    execution_payload=payload,
                )
                full = t.block["bellatrix"](
                    slot=bb.slot,
                    proposer_index=bb.proposer_index,
                    parent_root=bb.parent_root,
                    state_root=bb.state_root,
                    body=full_body,
                )
                sb = t.signed_block["bellatrix"](
                    message=full, signature=sbb.signature
                )
            try:
                chain.process_block(sb)
            except Exception as e:
                raise ApiError(400, f"block rejected: {e}")
            _publish(chain, "publish_block", sb)
            return None

        m = re.fullmatch(r"/eth/v1/beacon/rewards/blocks/([^/]+)", path)
        if m:
            return _block_rewards(chain, t, *self._block_for(m.group(1)))

        m = re.fullmatch(r"/eth/v1/beacon/rewards/attestations/(\d+)", path)
        if m and method == "POST":
            return _attestation_rewards(
                chain, t, int(m.group(1)), body or []
            )

        m = re.fullmatch(r"/eth/v1/validator/liveness/(\d+)", path)
        if m and method == "POST":
            epoch = int(m.group(1))
            out = []
            for idx in body or []:
                v = int(idx)
                live = (
                    chain.observed_attesters.is_known(v, epoch)
                    or chain.observed_aggregators.is_known(v, epoch)
                )
                out.append({"index": str(v), "is_live": bool(live)})
            return {"data": out}

        if path == "/eth/v1/node/peer_count":
            net = getattr(chain, "network", None)
            n = net.transport.peer_count() if net is not None else 0
            return {
                "data": {
                    "disconnected": "0",
                    "connecting": "0",
                    "connected": str(n),
                    "disconnecting": "0",
                }
            }
        if path == "/eth/v1/validator/attestation_data":
            slot = int(query["slot"])
            index = int(query["committee_index"])
            data = chain.produce_unaggregated_attestation(slot, index)
            return {"data": to_json(type(data), data)}
        if path == "/eth/v1/validator/aggregate_attestation":
            slot = int(query["slot"])
            data_root = bytes.fromhex(query["attestation_data_root"][2:])
            agg = _best_aggregate(chain, slot, data_root)
            if agg is None:
                raise ApiError(404, "no matching aggregate")
            return {"data": to_json(type(agg), agg)}
        if path == "/eth/v1/validator/aggregate_and_proofs" and method == "POST":
            for obj in body:
                sa = from_json(t.SignedAggregateAndProof, obj)
                v = chain.verify_aggregated_attestation_for_gossip(sa)
                chain.apply_attestation_to_fork_choice(v)
                if chain.op_pool is not None:
                    chain.op_pool.insert_attestation(sa.message.aggregate)
            return None

        # -- sync-committee aggregation surface (reference
        #    http_api/src/lib.rs:2375-2518) -------------------------------
        if path == "/eth/v1/validator/sync_committee_contribution":
            slot = int(query["slot"])
            subc = int(query["subcommittee_index"])
            root = bytes.fromhex(query["beacon_block_root"][2:])
            contribution = (
                chain.op_pool.sync_contribution_for(slot, root, subc)
                if chain.op_pool is not None
                else None
            )
            if contribution is None:
                raise ApiError(404, "no matching sync contribution")
            return {"data": to_json(type(contribution), contribution)}
        if path == "/eth/v1/validator/contribution_and_proofs" and method == "POST":
            from ..beacon_chain import (
                SyncCommitteeError,
                verify_sync_contribution,
            )

            failures = []
            for obj in body:
                sc = from_json(t.SignedContributionAndProof, obj)
                try:
                    verify_sync_contribution(chain, sc)
                except SyncCommitteeError as e:
                    # duplicates are normal between competing aggregators
                    # of the same subcommittee — not a client error
                    if e.kind not in (
                        "ContributionAlreadyKnown",
                        "AggregatorAlreadyKnown",
                    ):
                        failures.append(str(e))
                    continue
                if chain.op_pool is not None:
                    chain.op_pool.insert_sync_contribution(sc.message.contribution)
                net = getattr(chain, "network", None)
                if net is not None:
                    net.publish_sync_contribution(sc)
            if failures:
                raise ApiError(400, "; ".join(failures))
            return None
        if (
            path == "/eth/v1/validator/beacon_committee_subscriptions"
            and method == "POST"
        ):
            subs = getattr(chain, "committee_subscriptions", None)
            if subs is None:
                subs = chain.committee_subscriptions = []
            subs.extend(body)
            return None
        if (
            path == "/eth/v1/validator/sync_committee_subscriptions"
            and method == "POST"
        ):
            subs = getattr(chain, "sync_committee_subscriptions", None)
            if subs is None:
                subs = chain.sync_committee_subscriptions = []
            subs.extend(body)
            return None
        if path == "/eth/v1/validator/prepare_beacon_proposer" and method == "POST":
            prep = getattr(chain, "proposer_preparations", None)
            if prep is None:
                prep = chain.proposer_preparations = {}
            for obj in body:
                prep[int(obj["validator_index"])] = obj["fee_recipient"]
            return None
        if path == "/eth/v1/validator/register_validator" and method == "POST":
            regs = getattr(chain, "validator_registrations", None)
            if regs is None:
                regs = chain.validator_registrations = {}
            for obj in body:
                msg = obj.get("message", obj)
                regs[msg["pubkey"]] = msg
            return None

        raise ApiError(404, f"no route for {method} {path}")


def _sync_committee_for_epoch(chain, state, epoch: int):
    """Pubkey list for the sync-committee period containing ``epoch``:
    current period -> current committee, next period -> next committee,
    anything else -> None (the state cannot know it)."""
    P = chain.preset
    period = epoch // P.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    head_period = (
        state.slot // P.SLOTS_PER_EPOCH
    ) // P.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    if period == head_period:
        return [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    if period == head_period + 1:
        return [bytes(pk) for pk in state.next_sync_committee.pubkeys]
    return None


def _sync_committee_for_slot(chain, state, slot: int):
    return _sync_committee_for_epoch(
        chain, state, slot // chain.preset.SLOTS_PER_EPOCH
    )


def _validator_status(P, state, v) -> str:
    from ..types.chain_spec import FAR_FUTURE_EPOCH

    epoch = state.slot // P.SLOTS_PER_EPOCH
    if v.activation_epoch > epoch:
        return (
            "pending_queued"
            if v.activation_eligibility_epoch != FAR_FUTURE_EPOCH
            else "pending_initialized"
        )
    if epoch < v.exit_epoch:
        return "active_slashed" if v.slashed else "active_ongoing"
    if epoch < v.withdrawable_epoch:
        return "exited_slashed" if v.slashed else "exited_unslashed"
    return "withdrawal_possible"


def _header_json(root: bytes, block, canonical: bool) -> dict:
    msg = block.message
    return {
        "root": "0x" + root.hex(),
        "canonical": canonical,
        "header": {
            "message": {
                "slot": str(msg.slot),
                "proposer_index": str(msg.proposer_index),
                "parent_root": "0x" + bytes(msg.parent_root).hex(),
                "state_root": "0x" + bytes(msg.state_root).hex(),
                "body_root": "0x" + hash_tree_root(msg.body).hex(),
            },
            "signature": "0x" + bytes(block.signature).hex(),
        },
    }


def _peer_json(peer) -> dict:
    return {
        "peer_id": peer.node_id,
        "last_seen_p2p_address": f"/ip4/{peer.addr[0]}/tcp/{peer.addr[1]}",
        "state": "connected",
        "direction": "outbound",
        "enr": "",
    }


def _fork_of_block(t, signed_block) -> str:
    for fork, cls in t.signed_block.items():
        if isinstance(signed_block, cls):
            return fork
    return "phase0"


def _best_aggregate(chain, slot: int, data_root: bytes):
    """Best-coverage aggregate for (slot, data_root) from the op pool
    (the naive-aggregation-pool read path)."""
    pool = chain.op_pool
    if pool is None:
        return None
    t = chain.types
    with pool._lock:
        entry = pool._attestations.get(bytes(data_root))
        if entry is None:
            return None
        data, groups = entry
        if data.slot != slot or not groups:
            return None
        best = max(groups, key=lambda g: sum(g.aggregation_bits))
        return t.Attestation(
            aggregation_bits=list(best.aggregation_bits),
            data=data,
            signature=best.signature,
        )


def _parse_validator_ids(query) -> set | None:
    """Spec ValidatorId filter: ?id=1,2 / repeated ?id= / 0x-pubkeys."""
    ids = {
        x
        for chunk in query.get("id", "").split(",")
        for x in [chunk.strip()]
        if x
    }
    return ids or None


def _publish(chain, method: str, *args) -> None:
    """Gossip an API-submitted object when a network is attached
    (reference: the publish routes gossip after import)."""
    net = getattr(chain, "network", None)
    if net is None:
        return
    try:
        getattr(net, method)(*args)
    except Exception:
        pass  # gossip is best-effort; the object is already imported


def _blind_block(t, block):
    """Full bellatrix block -> (blinded block, extracted payload).
    The header's transactions_root commits to the withheld payload."""
    payload = block.body.execution_payload
    header = t.ExecutionPayloadHeader(
        **{
            name: getattr(payload, name)
            for name, _ in t.ExecutionPayloadHeader.fields
            if name != "transactions_root"
        },
        transactions_root=hash_tree_root(
            dict(t.ExecutionPayload.fields)["transactions"], payload.transactions
        ),
    )
    body = t.BlindedBeaconBlockBodyBellatrix(
        **{
            name: getattr(block.body, name)
            for name, _ in t.BlindedBeaconBlockBodyBellatrix.fields
            if name != "execution_payload_header"
        },
        execution_payload_header=header,
    )
    blinded = t.BlindedBeaconBlockBellatrix(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=block.state_root,
        body=body,
    )
    return blinded, payload


def _block_rewards(chain, t, root, signed_block):
    """Proposer reward decomposition for one block (reference http_api
    block-rewards route): each component measured as the proposer-balance
    delta of applying exactly that op class with the REAL op processors —
    no formula duplication to drift."""
    import copy as _copy

    from ..state_transition import block as st_block
    from ..state_transition import partial_state_advance
    from ..state_transition.block import (
        state_pubkey_bytes_resolver,
        state_pubkey_resolver,
    )

    block = signed_block.message
    preset, spec = chain.preset, chain.spec
    parent = chain.state_at_block_root(bytes(block.parent_root))
    state = partial_state_advance(
        preset, spec, _copy.deepcopy(parent), int(block.slot)
    )
    fork = fork_of(state)
    proposer = int(block.proposer_index)
    resolver = state_pubkey_resolver(state)

    def bal() -> int:
        return int(state.balances[proposer])

    components = {}
    b0 = bal()
    for ps in block.body.proposer_slashings:
        st_block.process_proposer_slashing(preset, spec, state, ps, fork, False, resolver)
    components["proposer_slashings"] = bal() - b0
    b0 = bal()
    for asl in block.body.attester_slashings:
        st_block.process_attester_slashing(preset, spec, state, asl, fork, False, resolver)
    components["attester_slashings"] = bal() - b0
    b0 = bal()
    for att in block.body.attestations:
        st_block.process_attestation(preset, spec, state, att, fork, False, resolver)
    components["attestations"] = bal() - b0
    components["sync_aggregate"] = 0
    if fork != "phase0":
        # spec definition: proposer_reward per included bit — NOT the raw
        # proposer-balance delta, which on small committees also contains
        # the proposer's own participant reward
        _, proposer_per_bit = st_block.sync_aggregate_rewards(preset, state)
        n_bits = sum(
            1 for b in block.body.sync_aggregate.sync_committee_bits if b
        )
        components["sync_aggregate"] = proposer_per_bit * n_bits
        st_block.process_sync_aggregate(
            preset, spec, state, int(block.slot), block.body.sync_aggregate,
            False, state_pubkey_bytes_resolver(state),
        )
    return {
        "execution_optimistic": False,
        "finalized": False,
        "data": {
            "proposer_index": str(proposer),
            "total": str(sum(components.values())),
            "attestations": str(components["attestations"]),
            "sync_aggregate": str(components["sync_aggregate"]),
            "proposer_slashings": str(components["proposer_slashings"]),
            "attester_slashings": str(components["attester_slashings"]),
        },
    }


def _phase0_attestation_rewards(chain, state, indices) -> dict:
    """Phase0 attestation rewards from PendingAttestations (un-501s the
    route; reference computes the same from get_attestation_deltas —
    ``consensus/state_processing/src/per_epoch_processing/base/rewards_and_penalties.rs``).
    Per spec semantics: attested components earn the proportional reward,
    missed components cost the full base reward (negative)."""
    from ..state_transition.epoch import (
        _base_reward_phase0,
        _eligible_indices,
        _is_in_inactivity_leak,
        _matching_attestations,
        _matching_head_attestations,
        _matching_target_attestations,
        _unslashed_attesting_indices,
    )
    from ..state_transition.helpers import (
        get_previous_epoch,
        get_total_active_balance,
        get_total_balance,
    )

    P = chain.preset
    previous = get_previous_epoch(P, state)
    total = get_total_active_balance(P, state)
    increment = P.EFFECTIVE_BALANCE_INCREMENT
    in_leak = _is_in_inactivity_leak(P, state)
    eligible = _eligible_indices(P, state)

    if indices:
        want = [int(i) for i in indices]
        n = len(state.validators)
        for i in want:
            if not 0 <= i < n:
                raise ApiError(400, f"validator index {i} out of range")
    else:
        want = eligible

    comps = {}
    ideal_by_eff: dict[int, dict[str, int]] = {}
    for name, atts in (
        ("source", _matching_attestations(P, state, previous)),
        ("target", _matching_target_attestations(P, state, previous)),
        ("head", _matching_head_attestations(P, state, previous)),
    ):
        unslashed = set(_unslashed_attesting_indices(P, state, atts))
        attesting_balance = get_total_balance(P, state, unslashed)
        vals = {}
        eligible_set = set(eligible)
        for i in want:
            if i not in eligible_set:
                vals[i] = 0
                continue
            base = _base_reward_phase0(P, state, total, i)
            if i in unslashed:
                vals[i] = (
                    base if in_leak
                    else base * (attesting_balance // increment) // (total // increment)
                )
            else:
                vals[i] = -base
        comps[name] = vals
        for i in eligible:
            eff = int(state.validators[i].effective_balance)
            base = _base_reward_phase0(P, state, total, i)
            ideal_by_eff.setdefault(eff, {})[name] = (
                base if in_leak
                else base * (attesting_balance // increment) // (total // increment)
            )

    total_rewards = [
        {
            "validator_index": str(i),
            "head": str(comps["head"][i]),
            "target": str(comps["target"][i]),
            "source": str(comps["source"][i]),
            "inactivity": "0",
        }
        for i in want
    ]
    ideal = [
        {
            "effective_balance": str(eff),
            "head": str(v.get("head", 0)),
            "target": str(v.get("target", 0)),
            "source": str(v.get("source", 0)),
            "inactivity": "0",
        }
        for eff, v in sorted(ideal_by_eff.items())
    ]
    return {"data": {"ideal_rewards": ideal, "total_rewards": total_rewards}}


def _attestation_rewards(chain, t, epoch: int, indices) -> dict:
    """Attestation rewards for ``epoch`` (reference http_api
    attestation-rewards route): per-validator source/target/head +
    inactivity from the columnar reward kernels, computed on a state
    whose PREVIOUS epoch is the requested one."""
    from ..state_transition.helpers import compute_epoch_at_slot
    from ..state_transition.state.epoch import altair_reward_components

    state = chain.head_state
    cur = compute_epoch_at_slot(chain.preset, state.slot)
    if fork_of(state) == "phase0":
        if cur < epoch + 1:
            raise ApiError(400, f"epoch {epoch} is not yet complete (current {cur})")
        if cur > epoch + 1:
            raise ApiError(501, "historical attestation rewards not supported")
        return _phase0_attestation_rewards(chain, state, indices)
    # rewards for epoch E are defined once E is the PREVIOUS epoch of a
    # completed head (advancing a copy cannot conjure the attestations,
    # and an unbounded requested epoch would be a remote CPU sink)
    if cur < epoch + 1:
        raise ApiError(400, f"epoch {epoch} is not yet complete (current {cur})")
    if cur > epoch + 1:
        raise ApiError(501, "historical attestation rewards not supported")
    comp = altair_reward_components(chain.preset, chain.spec, state)
    if indices:
        want = [int(i) for i in indices]
        n = len(state.validators)
        for i in want:
            if not 0 <= i < n:
                raise ApiError(400, f"validator index {i} out of range")
    else:
        want = [
            i for i in range(len(state.validators)) if comp["eligible"][i]
        ]
    total = [
        {
            "validator_index": str(i),
            "head": str(int(comp["head"][i])),
            "target": str(int(comp["target"][i])),
            "source": str(int(comp["source"][i])),
            "inactivity": str(int(comp["inactivity"][i])),
        }
        for i in want
    ]
    ideal = [
        {
            "effective_balance": str(eff),
            "head": str(int(v["head"])),
            "target": str(int(v["target"])),
            "source": str(int(v["source"])),
            "inactivity": "0",
        }
        for eff, v in sorted(comp["ideal"].items())
    ]
    return {"data": {"ideal_rewards": ideal, "total_rewards": total}}
