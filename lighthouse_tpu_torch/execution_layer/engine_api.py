"""Engine API JSON-RPC client (reference:
``execution_layer/src/engine_api/http.rs:31-41,667-722`` —
``engine_newPayloadV1``, ``engine_forkchoiceUpdatedV1``,
``engine_getPayloadV1`` with JWT auth).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.request


class EngineApiError(Exception):
    pass


class PayloadStatus:
    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"


def _jwt(secret: bytes) -> str:
    """HS256 JWT with an iat claim (the engine-API auth scheme)."""
    header = base64.urlsafe_b64encode(
        json.dumps({"alg": "HS256", "typ": "JWT"}).encode()
    ).rstrip(b"=")
    claims = base64.urlsafe_b64encode(
        json.dumps({"iat": int(time.time())}).encode()
    ).rstrip(b"=")
    signing_input = header + b"." + claims
    sig = base64.urlsafe_b64encode(
        hmac.new(secret, signing_input, hashlib.sha256).digest()
    ).rstrip(b"=")
    return (signing_input + b"." + sig).decode()


class EngineApiClient:
    def __init__(self, url: str, jwt_secret: bytes | None = None, timeout: float = 8.0):
        self.url = url
        self.jwt_secret = jwt_secret
        self.timeout = timeout
        self._id = 0

    def _call(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "method": method, "params": params, "id": self._id}
        ).encode()
        headers = {"Content-Type": "application/json"}
        if self.jwt_secret:
            headers["Authorization"] = "Bearer " + _jwt(self.jwt_secret)
        req = urllib.request.Request(self.url, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                out = json.loads(r.read())
        except OSError as e:
            raise EngineApiError(f"engine unreachable: {e}") from None
        except ValueError as e:  # non-JSON body (HTML error page, truncation)
            raise EngineApiError(f"engine returned non-JSON: {e}") from None
        if not isinstance(out, dict):
            raise EngineApiError("engine returned non-object response")
        err = out.get("error")
        if err:
            msg = err.get("message", "engine error") if isinstance(err, dict) else str(err)
            raise EngineApiError(msg)
        return out.get("result")

    # -- the three verbs -------------------------------------------------

    def new_payload(self, payload_json: dict) -> dict:
        return self._call("engine_newPayloadV1", [payload_json])

    def forkchoice_updated(self, state: dict, attributes: dict | None = None) -> dict:
        return self._call("engine_forkchoiceUpdatedV1", [state, attributes])

    def get_payload(self, payload_id: str) -> dict:
        return self._call("engine_getPayloadV1", [payload_id])
