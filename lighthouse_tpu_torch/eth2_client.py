"""Typed Beacon-API HTTP client (reference: ``common/eth2/src/lib.rs:140``
— the SDK the validator client and checkpoint sync use, with
``beacon_node_fallback``-style multi-node redundancy in
``validator_client/``).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

from .ssz.json import from_json, to_json


class BeaconNodeError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class BeaconNodeClient:
    def __init__(self, base_url: str, types, timeout: float = 10.0):
        self.base = base_url.rstrip("/")
        self.t = types
        self.timeout = timeout

    # -- raw -------------------------------------------------------------

    def _get(self, path: str, params: dict | None = None):
        url = self.base + path
        if params:
            from urllib.parse import urlencode

            url += "?" + urlencode(params)
        return self._req(urllib.request.Request(url))

    def _post(self, path: str, body) -> object:
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            self.base + path, data=data,
            headers={"Content-Type": "application/json"},
        )
        return self._req(req)

    def _req(self, req):
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                raw = r.read()
                if not raw:
                    return None
                ctype = r.headers.get("Content-Type", "")
                return json.loads(raw) if "json" in ctype else raw
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("message", "")
            except Exception:
                msg = ""
            raise BeaconNodeError(e.code, msg) from None
        except urllib.error.URLError as e:
            raise BeaconNodeError(0, str(e.reason)) from None

    # -- node ------------------------------------------------------------

    def health(self) -> bool:
        try:
            self._get("/eth/v1/node/health")
            return True
        except BeaconNodeError:
            return False

    def syncing(self) -> dict:
        return self._get("/eth/v1/node/syncing")["data"]

    def genesis(self) -> dict:
        return self._get("/eth/v1/beacon/genesis")["data"]

    def spec(self) -> dict:
        return self._get("/eth/v1/config/spec")["data"]

    # -- beacon ----------------------------------------------------------

    def state_finality_checkpoints(self, state_id: str = "head") -> dict:
        return self._get(
            f"/eth/v1/beacon/states/{state_id}/finality_checkpoints"
        )["data"]

    def validators(self, state_id: str = "head", id: str | None = None) -> list:
        params = {"id": id} if id else None
        return self._get(
            f"/eth/v1/beacon/states/{state_id}/validators", params
        )["data"]

    def state_ssz(self, state_id: str = "finalized"):
        """Fork byte + SSZ state (checkpoint-sync bootstrap)."""
        from .types.containers import FORK_NAMES

        raw = self._get(f"/eth/v2/debug/beacon/states/{state_id}")
        fork = FORK_NAMES[raw[0]]
        return self.t.state[fork].decode(bytes(raw[1:]))

    def block(self, block_id: str = "head"):
        out = self._get(f"/eth/v2/beacon/blocks/{block_id}")
        return from_json(self.t.signed_block[out["version"]], out["data"])

    def header(self, block_id: str = "head") -> dict:
        return self._get(f"/eth/v1/beacon/headers/{block_id}")["data"]

    def publish_block(self, signed_block) -> None:
        fork = next(
            f for f, cls in self.t.signed_block.items()
            if isinstance(signed_block, cls)
        )
        self._post(
            "/eth/v1/beacon/blocks",
            {"version": fork, "data": to_json(type(signed_block), signed_block)},
        )

    def publish_attestations(self, attestations) -> None:
        self._post(
            "/eth/v1/beacon/pool/attestations",
            [to_json(type(a), a) for a in attestations],
        )

    def publish_voluntary_exit(self, signed_exit) -> None:
        self._post(
            "/eth/v1/beacon/pool/voluntary_exits",
            to_json(type(signed_exit), signed_exit),
        )

    # -- validator -------------------------------------------------------

    def proposer_duties(self, epoch: int) -> dict:
        return self._get(f"/eth/v1/validator/duties/proposer/{epoch}")

    def attester_duties(self, epoch: int, validator_indices) -> dict:
        return self._post(
            f"/eth/v1/validator/duties/attester/{epoch}",
            [str(i) for i in validator_indices],
        )

    def produce_block(self, slot: int, randao_reveal: bytes, graffiti: bytes = bytes(32)):
        out = self._get(
            f"/eth/v2/validator/blocks/{slot}",
            {
                "randao_reveal": "0x" + randao_reveal.hex(),
                "graffiti": "0x" + graffiti.hex(),
            },
        )
        return from_json(self.t.block[out["version"]], out["data"])

    def attestation_data(self, slot: int, committee_index: int):
        out = self._get(
            "/eth/v1/validator/attestation_data",
            {"slot": slot, "committee_index": committee_index},
        )
        return from_json(self.t.AttestationData, out["data"])

    def aggregate_attestation(self, slot: int, attestation_data_root: bytes):
        out = self._get(
            "/eth/v1/validator/aggregate_attestation",
            {
                "slot": slot,
                "attestation_data_root": "0x" + attestation_data_root.hex(),
            },
        )
        return from_json(self.t.Attestation, out["data"])

    def sync_duties(self, epoch: int, validator_indices) -> dict:
        return self._post(
            f"/eth/v1/validator/duties/sync/{epoch}",
            [str(i) for i in validator_indices],
        )

    def publish_sync_committee_messages(self, messages) -> None:
        """messages: [{slot, beacon_block_root, validator_index, signature}]"""
        self._post("/eth/v1/beacon/pool/sync_committees", messages)

    def sync_committee_contribution(
        self, slot: int, subcommittee_index: int, beacon_block_root: bytes
    ):
        out = self._get(
            "/eth/v1/validator/sync_committee_contribution",
            {
                "slot": slot,
                "subcommittee_index": subcommittee_index,
                "beacon_block_root": "0x" + bytes(beacon_block_root).hex(),
            },
        )
        return from_json(self.t.SyncCommitteeContribution, out["data"])

    def publish_contribution_and_proofs(self, signed_contributions) -> None:
        self._post(
            "/eth/v1/validator/contribution_and_proofs",
            [
                to_json(self.t.SignedContributionAndProof, sc)
                for sc in signed_contributions
            ],
        )

    def beacon_committee_subscriptions(self, subscriptions) -> None:
        self._post("/eth/v1/validator/beacon_committee_subscriptions", subscriptions)

    def sync_committee_subscriptions(self, subscriptions) -> None:
        self._post("/eth/v1/validator/sync_committee_subscriptions", subscriptions)

    def prepare_beacon_proposer(self, preparations) -> None:
        """preparations: [{validator_index, fee_recipient}]"""
        self._post("/eth/v1/validator/prepare_beacon_proposer", preparations)

    def register_validator(self, registrations) -> None:
        self._post("/eth/v1/validator/register_validator", registrations)

    def publish_aggregate_and_proofs(self, signed_aggregates) -> None:
        self._post(
            "/eth/v1/validator/aggregate_and_proofs",
            [to_json(type(s), s) for s in signed_aggregates],
        )
