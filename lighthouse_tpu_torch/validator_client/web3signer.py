"""Web3Signer remote signing (reference: ``signing_method.rs:78-169`` —
the VC posts signing roots to an external signer service holding the
keys; plus ``testing/web3signer_tests``' real-signer rig, here an
in-process mock).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class Web3SignerError(Exception):
    pass


class Web3SignerClient:
    """Minimal client for the Web3Signer eth2 signing API."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def sign(self, pubkey: bytes, signing_root: bytes,
             artifact_type: str = "AGGREGATION_SLOT") -> bytes:
        """POST the signing root. NOTE: a production Web3Signer validates
        per-type request metadata (fork_info + the full object) beyond the
        signing root; this client implements the signingRoot-carrying
        subset that the in-repo mock (and permissive signer configs)
        accept. Extending to full artifact payloads is additive — the
        ValidatorStore seam passes through here for every signature."""
        body = json.dumps(
            {"type": artifact_type, "signingRoot": "0x" + signing_root.hex()}
        ).encode()
        req = urllib.request.Request(
            f"{self.base}/api/v1/eth2/sign/0x{pubkey.hex()}",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                out = json.loads(r.read())
        except OSError as e:
            raise Web3SignerError(f"signer unreachable: {e}") from None
        sig = out.get("signature", "")
        if not sig.startswith("0x"):
            raise Web3SignerError("signer returned no signature")
        return bytes.fromhex(sig[2:])

    def public_keys(self) -> list[bytes]:
        req = urllib.request.Request(self.base + "/api/v1/eth2/publicKeys")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return [bytes.fromhex(p[2:]) for p in json.loads(r.read())]


class MockWeb3Signer:
    """In-process signer holding real secret keys (the role the Java
    Web3Signer binary plays in the reference's web3signer_tests)."""

    def __init__(self, secret_keys, port: int = 0):
        self._keys = {
            sk.public_key().serialize(): sk for sk in secret_keys
        }
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/api/v1/eth2/publicKeys":
                    payload = json.dumps(
                        ["0x" + pk.hex() for pk in outer._keys]
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                self.send_response(404)
                self.end_headers()

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else {}
                if self.path.startswith("/api/v1/eth2/sign/0x"):
                    pk = bytes.fromhex(self.path.rsplit("/0x", 1)[1])
                    sk = outer._keys.get(pk)
                    if sk is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    root = bytes.fromhex(body["signingRoot"][2:])
                    sig = sk.sign(root).serialize()
                    payload = json.dumps({"signature": "0x" + sig.hex()}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                self.send_response(404)
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
