"""Keymanager API (reference: ``validator_client/src/http_api`` — the
standardized key-manager routes with bearer-token auth):

    GET    /eth/v1/keystores          list local keys
    POST   /eth/v1/keystores          import keystores (+passwords)
    DELETE /eth/v1/keystores          delete keys (+ slashing data export)
    GET    /eth/v1/remotekeys         list Web3Signer-backed keys
    POST   /eth/v1/remotekeys         register remote keys (pubkey + url)
    DELETE /eth/v1/remotekeys         deregister remote keys
"""

from __future__ import annotations

import hmac
import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _parse_pubkey(s: str) -> bytes:
    """0x-prefixed 48-byte hex pubkey, strictly validated."""
    if not isinstance(s, str) or not s.startswith("0x"):
        raise ValueError("pubkey must be 0x-prefixed hex")
    pk = bytes.fromhex(s[2:])
    if len(pk) != 48:
        raise ValueError(f"pubkey must be 48 bytes, got {len(pk)}")
    return pk


class KeymanagerApi:
    def __init__(self, store, host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None):
        self.store = store
        self.token = token or secrets.token_hex(16)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _auth(self) -> bool:
                # bytes operands: compare_digest raises TypeError on
                # non-ASCII str, which would crash the handler
                header = self.headers.get("Authorization", "")
                return hmac.compare_digest(
                    header.encode("utf-8", "surrogateescape"),
                    f"Bearer {outer.token}".encode(),
                )

            def _reply(self, code: int, obj) -> None:
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if not self._auth():
                    return self._reply(403, {"message": "invalid token"})
                if self.path == "/eth/v1/keystores":
                    data = [
                        {
                            "validating_pubkey": "0x" + pk.hex(),
                            "derivation_path": "",
                            "readonly": False,
                        }
                        for pk in outer.store.pubkeys()
                        if outer.store.is_local(pk)
                    ]
                    return self._reply(200, {"data": data})
                if self.path == "/eth/v1/remotekeys":
                    data = [
                        {
                            "pubkey": "0x" + pk.hex(),
                            "url": outer.store.remote_url(pk),
                            "readonly": False,
                        }
                        for pk in outer.store.pubkeys()
                        if not outer.store.is_local(pk)
                    ]
                    return self._reply(200, {"data": data})
                self._reply(404, {"message": "not found"})

            def do_POST(self):
                if not self._auth():
                    return self._reply(403, {"message": "invalid token"})
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else {}
                if self.path == "/eth/v1/keystores":
                    out = []
                    for ks_raw, pw in zip(
                        body.get("keystores", []), body.get("passwords", [])
                    ):
                        try:
                            ks = (
                                json.loads(ks_raw)
                                if isinstance(ks_raw, str)
                                else ks_raw
                            )
                            outer.store.add_keystore(ks, pw)
                            out.append({"status": "imported"})
                        except Exception as e:
                            out.append({"status": "error", "message": str(e)})
                    return self._reply(200, {"data": out})
                if self.path == "/eth/v1/remotekeys":
                    from .web3signer import Web3SignerClient

                    out = []
                    for rk in body.get("remote_keys", []):
                        try:
                            pk = _parse_pubkey(rk["pubkey"])
                            if outer.store.has(pk):
                                out.append({"status": "duplicate"})
                                continue
                            outer.store.add_remote_key(
                                pk, Web3SignerClient(rk["url"])
                            )
                            out.append({"status": "imported"})
                        except Exception as e:
                            out.append({"status": "error", "message": str(e)})
                    return self._reply(200, {"data": out})
                self._reply(404, {"message": "not found"})

            def do_DELETE(self):
                if not self._auth():
                    return self._reply(403, {"message": "invalid token"})
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else {}
                if self.path == "/eth/v1/keystores":
                    out = []
                    for pk_hex in body.get("pubkeys", []):
                        pk = bytes.fromhex(pk_hex[2:])
                        ok = outer.store.remove(pk)
                        out.append({"status": "deleted" if ok else "not_found"})
                    # EIP-3076 slashing data rides along, per the keymanager spec
                    return self._reply(
                        200,
                        {
                            "data": out,
                            "slashing_protection": outer.store.slashing_db.export_json(),
                        },
                    )
                if self.path == "/eth/v1/remotekeys":
                    out = []
                    for pk_hex in body.get("pubkeys", []):
                        try:
                            pk = _parse_pubkey(pk_hex)
                            if not outer.store.has(pk):
                                out.append({"status": "not_found"})
                            elif outer.store.is_local(pk):
                                # a LOCAL key must go through the keystores
                                # route (which exports slashing data)
                                out.append({
                                    "status": "error",
                                    "message": "local key: use /eth/v1/keystores",
                                })
                            else:
                                outer.store.remove(pk)
                                out.append({"status": "deleted"})
                        except Exception as e:
                            out.append({"status": "error", "message": str(e)})
                    return self._reply(200, {"data": out})
                self._reply(404, {"message": "not found"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
