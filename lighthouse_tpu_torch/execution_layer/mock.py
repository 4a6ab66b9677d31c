"""Mock execution layer: an in-process engine-API HTTP server that
accepts everything (reference: ``execution_layer/src/test_utils`` —
MockExecutionLayer + mock server used by BeaconChainHarness and the
simulator).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MockExecutionLayer:
    """Configurable verdicts: set ``payload_status`` to INVALID/SYNCING to
    exercise the optimistic/invalid paths."""

    def __init__(self, port: int = 0):
        self.payload_status = "VALID"
        self.requests: list[dict] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else {}
                outer.requests.append(body)
                method = body.get("method", "")
                result: object = None
                if method == "engine_newPayloadV1":
                    result = {
                        "status": outer.payload_status,
                        "latestValidHash": body["params"][0].get("blockHash"),
                        "validationError": None,
                    }
                elif method == "engine_forkchoiceUpdatedV1":
                    has_attrs = body["params"][1] is not None
                    result = {
                        "payloadStatus": {"status": outer.payload_status},
                        "payloadId": "0x0000000000000001" if has_attrs else None,
                    }
                elif method == "engine_getPayloadV1":
                    result = outer._empty_payload()
                payload = json.dumps(
                    {"jsonrpc": "2.0", "id": body.get("id"), "result": result}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    @staticmethod
    def _empty_payload() -> dict:
        z32 = "0x" + "00" * 32
        return {
            "parentHash": z32,
            "feeRecipient": "0x" + "00" * 20,
            "stateRoot": z32,
            "receiptsRoot": z32,
            "logsBloom": "0x" + "00" * 256,
            "prevRandao": z32,
            "blockNumber": "0x0",
            "gasLimit": "0x1c9c380",
            "gasUsed": "0x0",
            "timestamp": "0x0",
            "extraData": "0x",
            "baseFeePerGas": "0x7",
            "blockHash": z32,
            "transactions": [],
        }

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
