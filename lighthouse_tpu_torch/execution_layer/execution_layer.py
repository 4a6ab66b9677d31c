"""ExecutionLayer service: engine state machine + payload plumbing
(reference: ``execution_layer/src/lib.rs`` + ``engines.rs`` — upcheck /
retry, falling back to SYNCING-optimistic verdicts when the EL is out).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..fork_choice.proto_array import ExecutionStatus
from .engine_api import EngineApiClient, EngineApiError, PayloadStatus


class ExecutionLayer:
    def __init__(self, engine: EngineApiClient):
        self.engine = engine
        self._lock = threading.Lock()
        self._online = True
        self._payload_cache: dict[bytes, dict] = {}

    # -- engine state ----------------------------------------------------

    def upcheck(self) -> bool:
        try:
            self.engine.forkchoice_updated(
                {
                    "headBlockHash": "0x" + "00" * 32,
                    "safeBlockHash": "0x" + "00" * 32,
                    "finalizedBlockHash": "0x" + "00" * 32,
                },
                None,
            )
            online = True
        except EngineApiError:
            online = False
        with self._lock:
            self._online = online
        return online

    @property
    def online(self) -> bool:
        with self._lock:
            return self._online

    # -- consensus-side entry points -------------------------------------

    def notify_new_payload(self, payload_json: dict) -> ExecutionStatus:
        """-> fork-choice execution status (optimistic on EL outage, the
        reference's optimistic-sync behaviour)."""
        try:
            out = self.engine.new_payload(payload_json)
        except EngineApiError:
            with self._lock:
                self._online = False
            return ExecutionStatus.OPTIMISTIC
        status = (out or {}).get("status", PayloadStatus.SYNCING)
        if status == PayloadStatus.VALID:
            return ExecutionStatus.VALID
        if status == PayloadStatus.INVALID:
            return ExecutionStatus.INVALID
        return ExecutionStatus.OPTIMISTIC

    def notify_forkchoice_updated(
        self,
        head_block_hash: bytes,
        finalized_block_hash: bytes,
        payload_attributes: dict | None = None,
    ) -> Optional[str]:
        """-> payload_id when attributes were supplied (block production)."""
        try:
            out = self.engine.forkchoice_updated(
                {
                    "headBlockHash": "0x" + head_block_hash.hex(),
                    "safeBlockHash": "0x" + head_block_hash.hex(),
                    "finalizedBlockHash": "0x" + finalized_block_hash.hex(),
                },
                payload_attributes,
            )
        except EngineApiError:
            with self._lock:
                self._online = False
            return None
        return (out or {}).get("payloadId")

    def get_payload(self, payload_id: str) -> Optional[dict]:
        try:
            return self.engine.get_payload(payload_id)
        except EngineApiError:
            return None
