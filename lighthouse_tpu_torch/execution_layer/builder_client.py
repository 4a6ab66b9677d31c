"""External block-builder (MEV-boost) HTTP client + in-process mock
(reference: ``beacon_node/builder_client/src/lib.rs`` — status /
register_validators / get_header / submit_blinded_block over the
builder-specs REST API).

The BN uses this when ``--builder <url>`` is configured: registrations
forwarded from the VC's ``register_validator`` route, a header fetched at
proposal time, and the signed blinded block submitted back for unblinding.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class BuilderError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"builder HTTP {status}: {message}")
        self.status = status


class BuilderHttpClient:
    """Thin typed client over the builder-specs routes."""

    def __init__(self, base_url: str, timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _req(self, method: str, path: str, body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                raw = r.read()
                return json.loads(raw) if raw else None
        except urllib.error.HTTPError as e:
            raise BuilderError(e.code, e.read().decode(errors="replace")) from None
        except OSError as e:
            raise BuilderError(0, str(e)) from None

    # -- builder-specs surface -------------------------------------------

    def status(self) -> bool:
        self._req("GET", "/eth/v1/builder/status")
        return True

    def register_validators(self, registrations: list) -> None:
        self._req("POST", "/eth/v1/builder/validators", registrations)

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes):
        return self._req(
            "GET",
            f"/eth/v1/builder/header/{slot}/0x{bytes(parent_hash).hex()}"
            f"/0x{bytes(pubkey).hex()}",
        )["data"]

    def submit_blinded_block(self, signed_blinded_block_json):
        return self._req(
            "POST", "/eth/v1/builder/blinded_blocks", signed_blinded_block_json
        )["data"]


class MockBuilder:
    """In-process builder server for tests (reference
    ``execution_layer/src/test_utils`` mock builder): records
    registrations, serves a canned header bid, and unblinds submissions."""

    def __init__(self, port: int = 0, bid_value_wei: int = 10**18):
        self.registrations: dict[str, dict] = {}
        self.headers_served: list[tuple] = []
        self.submitted: list = []
        self.bid_value_wei = bid_value_wei
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, obj=None) -> None:
                payload = json.dumps(obj).encode() if obj is not None else b""
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path == "/eth/v1/builder/status":
                    return self._reply(200, {})
                if self.path.startswith("/eth/v1/builder/header/"):
                    parts = self.path.split("/")
                    slot, parent_hash, pubkey = parts[5], parts[6], parts[7]
                    outer.headers_served.append((int(slot), parent_hash, pubkey))
                    return self._reply(
                        200,
                        {
                            "version": "bellatrix",
                            "data": {
                                "message": {
                                    "header": {"parent_hash": parent_hash},
                                    "value": str(outer.bid_value_wei),
                                    "pubkey": pubkey,
                                },
                                "signature": "0x" + "00" * 96,
                            },
                        },
                    )
                return self._reply(404, {"message": "no route"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"null")
                if self.path == "/eth/v1/builder/validators":
                    for reg in body or []:
                        msg = reg.get("message", {})
                        outer.registrations[msg.get("pubkey", "")] = reg
                    return self._reply(200, {})
                if self.path == "/eth/v1/builder/blinded_blocks":
                    outer.submitted.append(body)
                    return self._reply(
                        200, {"version": "bellatrix", "data": {"unblinded": True}}
                    )
                return self._reply(404, {"message": "no route"})

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_port
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def start(self) -> "MockBuilder":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"
