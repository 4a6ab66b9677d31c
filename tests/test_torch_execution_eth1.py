"""The port's eth1 service and execution layer against the JAX package's.

Host code with no device caller: equality on shared inputs is the proof.

* ``DepositTree``: over seeded leaves, the root at every count and the
  proofs of every leaf at full and truncated counts;
* ``Eth1Service``: the eth1-data vote and the SSZ bytes of
  ``deposits_for_block`` over the same seeded deposit logs, with deposits
  that arrive after the vote;
* the engine API across the packages (the port's client against the JAX
  mock EL, the JAX client against the port's): the fork-choice statuses
  for a valid, an invalid, a syncing and an offline EL, the payload id and
  payload, and the requests the mock recorded; the HS256 JWTs at a fixed
  ``time.time``;
* ``BuilderHttpClient`` against each package's ``MockBuilder``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import lighthouse_tpu.execution_layer.engine_api as jengine
import lighthouse_tpu_torch.execution_layer.engine_api as tengine
from lighthouse_tpu.eth1 import Eth1Service as JEth1Service, MockEth1Endpoint as JEndpoint
from lighthouse_tpu.eth1.service import DepositTree as JDepositTree
from lighthouse_tpu.execution_layer import (
    EngineApiClient as JClient, ExecutionLayer as JEL, MockExecutionLayer as JMockEL)
from lighthouse_tpu.execution_layer.builder_client import (
    BuilderError as JBuilderError, BuilderHttpClient as JBuilderClient, MockBuilder as JMockBuilder)
from lighthouse_tpu.state_transition.merkle import is_valid_merkle_branch
from lighthouse_tpu.types.chain_spec import minimal_spec as jminimal_spec
from lighthouse_tpu.types.containers import types_for as jtypes_for
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu_torch.eth1 import Eth1Service as TEth1Service, MockEth1Endpoint as TEndpoint
from lighthouse_tpu_torch.eth1.service import DepositTree as TDepositTree
from lighthouse_tpu_torch.execution_layer import (
    EngineApiClient as TClient, ExecutionLayer as TEL, MockExecutionLayer as TMockEL)
from lighthouse_tpu_torch.execution_layer.builder_client import (
    BuilderError as TBuilderError, BuilderHttpClient as TBuilderClient, MockBuilder as TMockBuilder)
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as tminimal_spec
from lighthouse_tpu_torch.types.containers import types_for as ttypes_for
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL

JT, TT = jtypes_for(JMINIMAL), ttypes_for(TMINIMAL)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# eth1
# ---------------------------------------------------------------------------

def test_deposit_tree_roots_and_proofs_equal_jax():
    leaves = [bytes(r) for r in np.random.default_rng(3).integers(0, 256, (37, 32),
                                                                    dtype=np.uint8)]
    jt, tt = JDepositTree(), TDepositTree()
    for i, leaf in enumerate(leaves):
        jt.push(leaf)
        tt.push(leaf)
        assert tt.root() == jt.root()
    for count in (1, 2, 5, 16, 17, 31, 37):
        root = tt.root(count)
        assert root == jt.root(count)
        for i in range(count):
            proof = tt.proof(i, count)
            assert proof == jt.proof(i, count)
            assert is_valid_merkle_branch(leaves[i], proof, 33, i, root)


def _endpoint(cls, rng_seed: int = 5):
    rng = np.random.default_rng(rng_seed)
    ep = cls()
    for i in range(6):
        ep.add_deposit(pubkey=bytes(rng.integers(0, 256, 48, dtype=np.uint8)),
                       withdrawal_credentials=bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
                       amount=32 * 10**9, signature=bytes(rng.integers(0, 256, 96,
                                                                     dtype=np.uint8)),
                       block_number=10 + 2 * i)
    ep.seal_block(14, timestamp=1000)
    ep.seal_block(21, timestamp=1012)
    return ep


def _eth1_run(ep_cls, svc_cls, t, preset, spec) -> dict:
    ep = _endpoint(ep_cls)
    svc = svc_cls(ep, preset, spec)
    state = t.state["phase0"]()
    empty_vote = t.Eth1Data.encode(svc.eth1_data_vote(state))
    svc.update()
    vote = svc.eth1_data_vote(state)
    state.eth1_data = vote
    state.eth1_deposit_index = 1
    for j in (90, 91):  # after the vote: the proofs stay against the voted root
        ep.add_deposit(pubkey=bytes([j]) * 48, withdrawal_credentials=bytes(32),
                       amount=32 * 10**9, signature=bytes(96), block_number=j)
    svc.update()
    return {"empty": empty_vote, "vote": t.Eth1Data.encode(vote),
            "deposits": [t.Deposit.encode(d) for d in svc.deposits_for_block(state, 16)],
            "capped": [t.Deposit.encode(d) for d in svc.deposits_for_block(state, 2)],
            "tree": svc.deposit_tree.root()}


def test_eth1_votes_and_deposits_equal_jax():
    got = _eth1_run(TEndpoint, TEth1Service, TT, TMINIMAL, tminimal_spec())
    want = _eth1_run(JEndpoint, JEth1Service, JT, JMINIMAL, jminimal_spec())
    assert got == want
    vote = TT.Eth1Data.decode(got["vote"])
    assert vote.deposit_count == 6 and len(got["deposits"]) == 5 and len(got["capped"]) == 2


# ---------------------------------------------------------------------------
# execution layer
# ---------------------------------------------------------------------------

def _el_run(el_cls, client_cls, mock) -> dict:
    el = el_cls(client_cls(mock.url, jwt_secret=b"s" * 32))
    out = {"upcheck": el.upcheck()}
    out["valid"] = el.notify_new_payload({"blockHash": "0x" + "11" * 32}).value
    out["payload_id"] = el.notify_forkchoice_updated(b"\x22" * 32, b"\x00" * 32,
                                                     {"timestamp": "0x0"})
    out["payload"] = el.get_payload(out["payload_id"])
    mock.payload_status = "INVALID"
    out["invalid"] = el.notify_new_payload({"blockHash": "0x" + "11" * 32}).value
    mock.payload_status = "SYNCING"
    out["syncing"] = el.notify_new_payload({"blockHash": "0x" + "11" * 32}).value
    out["no_attrs"] = el.notify_forkchoice_updated(b"\x22" * 32, b"\x00" * 32)
    mock.payload_status = "VALID"
    out["requests"] = [{k: v for k, v in r.items() if k != "id"} for r in mock.requests]
    dead = el_cls(client_cls("http://127.0.0.1:1"))
    out["offline"] = (dead.notify_new_payload({}).value, dead.upcheck(), dead.online,
                      dead.notify_forkchoice_updated(b"\x00" * 32, b"\x00" * 32),
                      dead.get_payload("0x01"))
    return out


def test_engine_api_across_the_packages():
    runs = {}
    for label, el_cls, client_cls, mock_cls in (
            ("torch on jax mock", TEL, TClient, JMockEL),
            ("jax on torch mock", JEL, JClient, TMockEL),
            ("jax on jax mock", JEL, JClient, JMockEL)):
        mock = mock_cls()
        try:
            runs[label] = _el_run(el_cls, client_cls, mock)
        finally:
            mock.stop()
    assert runs["torch on jax mock"] == runs["jax on jax mock"] == runs["jax on torch mock"]
    got = runs["torch on jax mock"]
    assert (got["upcheck"], got["valid"], got["invalid"], got["syncing"]) == (
        True, "valid", "invalid", "optimistic")
    assert got["offline"] == ("optimistic", False, False, None, None)
    assert got["payload_id"] == "0x0000000000000001" and got["payload"]["blockNumber"] == "0x0"


def test_jwts_equal_jax_at_a_fixed_time(monkeypatch):
    for mod in (jengine, tengine):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.5)
    for secret in (b"s" * 32, bytes(range(32))):
        assert tengine._jwt(secret) == jengine._jwt(secret)
    assert tengine.PayloadStatus.__dict__.items() >= {
        k: v for k, v in jengine.PayloadStatus.__dict__.items() if k.isupper()}.items()


REG = {"message": {"fee_recipient": "0x" + "bb" * 20, "gas_limit": "30000000",
                   "timestamp": "1", "pubkey": "0x" + "cc" * 48},
       "signature": "0x" + "00" * 96}


def _builder_run(client_cls, error_cls, mock) -> dict:
    client = client_cls(mock.url)
    out = {"status": client.status()}
    client.register_validators([REG])
    out["bid"] = client.get_header(7, b"\x11" * 32, b"\xcc" * 48)
    out["unblinded"] = client.submit_blinded_block({"signed": "blinded"})
    with pytest.raises(error_cls) as e:
        client._req("GET", "/eth/v1/builder/nope")
    out["error"] = (e.value.status, str(e.value))
    out["mock"] = (mock.registrations, mock.headers_served, mock.submitted)
    return out


def test_builder_client_against_each_mock():
    runs = {}
    for label, client_cls, error_cls, mock_cls in (
            ("torch on jax mock", TBuilderClient, TBuilderError, JMockBuilder),
            ("jax on torch mock", JBuilderClient, JBuilderError, TMockBuilder),
            ("torch on torch mock", TBuilderClient, TBuilderError, TMockBuilder)):
        mock = mock_cls(port=0).start()
        try:
            runs[label] = _builder_run(client_cls, error_cls, mock)
        finally:
            mock.stop()
    errors = {k: v.pop("error") for k, v in runs.items()}
    assert runs["torch on jax mock"] == runs["jax on torch mock"] == runs["torch on torch mock"]
    assert {e[0] for e in errors.values()} == {404}
    got = runs["torch on torch mock"]
    assert got["bid"]["message"]["value"] == str(10**18)
    assert got["unblinded"] == {"unblinded": True}
    assert got["mock"][0] == {"0x" + "cc" * 48: REG}
