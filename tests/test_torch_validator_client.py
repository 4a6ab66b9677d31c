"""The port's validator client, eth2 HTTP client, checkpoint sync,
fork-choice runner and the commands that need them, against the JAX
package's.

* one minimal epoch (phase0, eight validators) of a port VC against a
  port ``BeaconApiServer`` on ``fake``: every block, attestation and
  aggregate it publishes is byte-equal to the JAX VC's against a JAX node
  on the same chain (BLS signing is deterministic), and both chains end at
  the same head; at altair, where a JAX node costs a minute an epoch, the
  port VC alone, its sync committee messages signed as the JAX validator
  store signs them;
* slashing protection refuses a double proposal;
* checkpoint sync from a port API into a ``ClientBuilder`` node that
  listens and dials its boot node (``listen_port``, ``boot_nodes``):
  range sync brings it to the boot node's head, and it backfills the
  history below its anchor over RPC;
* the fork-choice runner gives the JAX runner's checks;
* ``vc --help``, ``am wallet-create``, ``boot-node`` and ``lcli
  generate-bootnode-record`` run (they exited 2 before the port had the
  modules).
"""

from __future__ import annotations

import copy
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

from lighthouse_tpu.beacon_chain import BeaconChain as JChain
from lighthouse_tpu.crypto import backend as jbackend
from lighthouse_tpu.eth2_client import BeaconNodeClient as JClient
from lighthouse_tpu.http_api import BeaconApiServer as JApi
from lighthouse_tpu.network import noise as jnoise
from lighthouse_tpu.operation_pool import OperationPool as JPool
from lighthouse_tpu.state_transition import interop_secret_key as jsecret
from lighthouse_tpu.ssz import hash_tree_root as jhtr
from lighthouse_tpu.state_transition import store_replayer as jreplayer
from lighthouse_tpu.store import HotColdDB as JDB, MemoryStore as JMem
from lighthouse_tpu.testing.fork_choice_runner import ForkChoiceRunner as JRunner
from lighthouse_tpu.testing.harness import StateHarness as JHarness
from lighthouse_tpu.types.chain_spec import minimal_spec as jminimal
from lighthouse_tpu.types.preset import MINIMAL as JMINIMAL
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as JClock
from lighthouse_tpu.validator_client import (
    BeaconNodeFallback as JFallback, ValidatorClient as JVC, ValidatorStore as JStore)
from lighthouse_tpu_torch import cli as tcli
from lighthouse_tpu_torch.beacon_chain import BeaconChain as TChain
from lighthouse_tpu_torch.client import ClientBuilder, ClientConfig
from lighthouse_tpu_torch.crypto import backend as tbackend
from lighthouse_tpu_torch.eth2_client import BeaconNodeClient as TClient
from lighthouse_tpu_torch.http_api import BeaconApiServer as TApi
from lighthouse_tpu_torch.keys import SlashingProtectionError
from lighthouse_tpu_torch.network import Transport
from lighthouse_tpu_torch.network.service import PROTO_STATUS
from lighthouse_tpu_torch.operation_pool import OperationPool as TPool
from lighthouse_tpu_torch.state_transition import interop_secret_key as tsecret
from lighthouse_tpu_torch.ssz import hash_tree_root as thtr
from lighthouse_tpu_torch.state_transition import store_replayer as treplayer
from lighthouse_tpu_torch.store import HotColdDB as TDB, MemoryStore as TMem
from lighthouse_tpu_torch.store.iter import block_roots_iter
from lighthouse_tpu_torch.testing.fork_choice_runner import ForkChoiceRunner as TRunner
from lighthouse_tpu_torch.testing.harness import StateHarness as THarness
from lighthouse_tpu_torch.testing.simulator import LocalNetwork
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as tminimal
from lighthouse_tpu_torch.types.preset import MINIMAL as TMINIMAL
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as TClock
from lighthouse_tpu_torch.validator_client import (
    BeaconNodeFallback as TFallback, ValidatorClient as TVC, ValidatorStore as TStore)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_VALIDATORS = 8

JAX = dict(harness=JHarness, preset=JMINIMAL, spec=jminimal, chain=JChain, db=JDB, mem=JMem,
           replayer=jreplayer, clock=JClock, pool=JPool, api=JApi, client=JClient,
           fallback=JFallback, store=JStore, vc=JVC, secret=jsecret, htr=jhtr)
PORT = dict(harness=THarness, preset=TMINIMAL, spec=tminimal, chain=TChain, db=TDB, mem=TMem,
            replayer=treplayer, clock=TClock, pool=TPool, api=TApi, client=TClient,
            fallback=TFallback, store=TStore, vc=TVC, secret=tsecret, htr=thtr)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fake_backends():
    saved = [(m, m._active, m._active_name) for m in (jbackend, tbackend)]
    jbackend.set_backend("fake")
    tbackend.set_backend("fake")
    yield
    for m, active, name in saved:
        m._active, m._active_name = active, name


def _node(pkg, fork: str = "phase0"):
    h = pkg["harness"](pkg["preset"], pkg["spec"](altair_fork_epoch=0 if fork == "altair"
                                                  else None),
                       N_VALIDATORS, fork_name=fork, fake_sign=True)
    genesis = copy.deepcopy(h.state)
    db = pkg["db"](pkg["mem"](), h.t, h.spec, pkg["replayer"](h.preset, h.spec))
    clock = pkg["clock"](genesis.genesis_time, h.spec.seconds_per_slot)
    chain = pkg["chain"](h.preset, h.spec, h.t, db, genesis, slot_clock=clock)
    chain.op_pool = pkg["pool"](h.preset, h.spec, h.t)
    return h, chain, clock, pkg["api"](chain, port=0).start()


def _recording_fallback(base):
    class Recording(base):
        """Every object the VC publishes, in order: SSZ bytes, or the JSON
        of what it sends as JSON."""

        def __init__(self, clients):
            super().__init__(clients)
            self.published = []

        def call(self, fn_name, *args, **kwargs):
            if fn_name.startswith("publish_"):
                items = args[0] if isinstance(args[0], list) else [args[0]]
                self.published.append((fn_name, [
                    json.dumps(x, sort_keys=True).encode() if isinstance(x, dict)
                    else type(x).encode(x) for x in items]))
            return super().call(fn_name, *args, **kwargs)

    return Recording


def _vc_epoch(pkg, fork: str = "phase0") -> dict:
    h, chain, clock, server = _node(pkg, fork)
    try:
        url = f"http://127.0.0.1:{server.port}"
        store = pkg["store"](h.spec, h.preset, h.t, genesis_validators_root=bytes(
            chain.head_state.genesis_validators_root))
        for i in range(N_VALIDATORS):
            store.add_secret_key(pkg["secret"](i))
        nodes = _recording_fallback(pkg["fallback"])([pkg["client"](url, h.t)])
        vc = pkg["vc"](store, nodes, h.t, h.preset, clock)
        for slot in range(1, h.preset.SLOTS_PER_EPOCH + 2):
            clock.set_slot(slot)
            chain.on_tick(slot)
            vc.on_slot(slot)
        return {"published": nodes.published, "head": chain.head_block_root,
                "slot": chain.head_state.slot, "pool": chain.op_pool.n_attestations(),
                "store": store}
    finally:
        server.stop()


def test_a_port_vc_epoch_publishes_the_jax_vcs_bytes(fake_backends):
    port, jax = _vc_epoch(PORT), _vc_epoch(JAX)
    assert port["published"] == jax["published"]
    kinds = {k for k, _ in port["published"]}
    assert kinds == {"publish_block", "publish_attestations", "publish_aggregate_and_proofs"}
    blocks = sum(len(v) for k, v in port["published"] if k == "publish_block")
    assert blocks == TMINIMAL.SLOTS_PER_EPOCH + 1
    assert (port["head"], port["slot"], port["pool"]) == (jax["head"], jax["slot"], jax["pool"])
    assert port["slot"] == TMINIMAL.SLOTS_PER_EPOCH + 1 and port["pool"] > 0
    # slashing protection: the store refuses a second block at a signed slot
    store = port["store"]
    pk = store.pubkeys()[0]
    t = THarness(TMINIMAL, tminimal(), N_VALIDATORS, fake_sign=True).t
    store.sign_block(pk, t.block["phase0"](slot=40, proposer_index=0))
    with pytest.raises(SlashingProtectionError):
        store.sign_block(pk, t.block["phase0"](slot=40, proposer_index=0,
                                               parent_root=b"\x02" * 32))


def test_a_port_vc_epoch_at_altair_signs_its_sync_duties_as_jax_does(fake_backends):
    """The port VC alone at altair (a JAX node there costs a minute an
    epoch): every sync committee message it publishes carries the JAX
    validator store's signature for the same slot, root and key, and it
    publishes contributions, which the port node accepts."""
    port = _vc_epoch(PORT, fork="altair")
    kinds = {k for k, _ in port["published"]}
    assert {"publish_sync_committee_messages", "publish_contribution_and_proofs"} <= kinds
    from lighthouse_tpu.types import types_for as jtypes_for

    jstore = JStore(jminimal(altair_fork_epoch=0), JMINIMAL, jtypes_for(JMINIMAL),
                    genesis_validators_root=port["store"].genesis_validators_root)
    pks = [jstore.add_secret_key(jsecret(i)) for i in range(N_VALIDATORS)]
    msgs = [json.loads(m) for k, batch in port["published"]
            if k == "publish_sync_committee_messages" for m in batch]
    assert len(msgs) >= TMINIMAL.SLOTS_PER_EPOCH
    for m in msgs:
        sig = jstore.sign_sync_committee_message(pks[int(m["validator_index"])],
                                                 int(m["slot"]),
                                                 bytes.fromhex(m["beacon_block_root"][2:]))
        assert m["signature"] == "0x" + sig.hex()
    assert port["slot"] == TMINIMAL.SLOTS_PER_EPOCH + 1


def test_checkpoint_sync_from_a_port_api_then_backfill_over_the_network(fake_backends):
    net = LocalNetwork(1, validator_count=N_VALIDATORS)
    api = TApi(net.nodes[0].chain, port=0).start()
    client = None
    try:
        P = net.h.preset
        for _ in range(4 * P.SLOTS_PER_EPOCH):
            net.tick_slot(attest=True)
        src = net.nodes[0]
        fin_epoch = src.chain.fork_choice.store.finalized_checkpoint[0]
        assert fin_epoch >= 1
        cfg = ClientConfig(preset_base="minimal", http_enabled=False, bls_backend="fake",
                           listen_port=0, boot_nodes=(f"127.0.0.1:{src.net.port}",))
        client = ClientBuilder(cfg, tminimal()).with_checkpoint_sync(
            f"http://127.0.0.1:{api.port}").with_slot_clock(net.clock).build()
        anchor = client.chain.head_state.slot
        assert 0 < fin_epoch * P.SLOTS_PER_EPOCH <= anchor < src.chain.head_state.slot
        peers = client.network.transport.peers_snapshot()
        assert len(peers) == 1 and peers[0].node_id == src.net.transport.node_id

        # the boot node's status is ahead: range sync brings the head up
        def synced():
            client.chain.recompute_head()
            return client.chain.head_block_root == src.chain.head_block_root
        deadline = time.monotonic() + 30
        while not synced():
            assert time.monotonic() < deadline, "range sync did not reach the boot node's head"
            time.sleep(0.05)
        stored = client.network.backfill.run(peers[0])
        assert client.network.backfill.complete and stored > 0
        slots = [s for s, _ in block_roots_iter(client.chain.store, client.chain.head_block_root)]
        assert min(slots) <= 1
    finally:
        if client is not None:
            client.stop()
        api.stop()
        net.close()


def test_fork_choice_runner_gives_the_jax_runners_checks(fake_backends):
    out = {}
    for name, pkg, runner in (("port", PORT, TRunner), ("jax", JAX, JRunner)):
        h = pkg["harness"](pkg["preset"], pkg["spec"](), N_VALIDATORS, fake_sign=True)
        anchor_block = h.t.block["phase0"](
            slot=0, proposer_index=0, parent_root=bytes(32),
            state_root=pkg["htr"](h.state), body=h.t.block_body["phase0"]())
        r = runner(h.preset, h.spec, "phase0", copy.deepcopy(h.state), anchor_block)
        checks = []
        for slot in range(1, 3 * h.preset.SLOTS_PER_EPOCH + 2):
            r.on_tick(h.state.genesis_time + slot * h.spec.seconds_per_slot)
            atts = h.attestations_for_slot(h.state, slot - 1) if slot > 1 else []
            sb = h.produce_block(slot, attestations=atts[:h.preset.MAX_ATTESTATIONS])
            h.process_block(sb, strategy="none")
            r.on_block(sb)
            for att in h.attestations_for_slot(h.state, slot):
                r.on_attestation(att)
            checks.append(r.checks())
        out[name] = checks
    assert out["port"] == out["jax"]
    assert out["port"][-1]["head"]["slot"] == 3 * TMINIMAL.SLOTS_PER_EPOCH + 1
    assert out["port"][-1]["justified_checkpoint"]["epoch"] >= 1


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------

def test_vc_and_am_commands_run(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["vc", "--help"])
    assert e.value.code == 0 and "--beacon-node" in capsys.readouterr().out
    monkeypatch.setattr(tcli.getpass, "getpass", lambda prompt="": "wallet-pass")
    out = tmp_path / "wallet.json"
    assert tcli.main(["am", "wallet-create", "--name", "w", "--out", str(out),
                      "--kdf-work", "1024"]) == 0
    wallet = json.loads(out.read_text())
    assert (wallet["name"], wallet["nextaccount"], wallet["version"]) == ("w", 0, 1)
    from lighthouse_tpu_torch.keys import Wallet

    assert len(Wallet(wallet).decrypt_seed("wallet-pass")) == 32


def test_bootnode_record_equals_jax_and_boot_node_serves(tmp_path):
    rec = tmp_path / "rec.json"
    assert tcli.main(["lcli", "generate-bootnode-record", "--seed", "boot", "--port", "9100",
                      "--out", str(rec)]) == 0
    got = json.loads(rec.read_text())
    ident = jnoise.Identity.from_seed(b"boot")
    assert got == {"node_id": ident.node_id, "static_pubkey": "0x" + ident.public.hex(),
                   "host": "127.0.0.1", "port": 9100}
    proc = subprocess.Popen(
        [sys.executable, "-m", "lighthouse_tpu_torch", "boot-node", "--port", "0"],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t = Transport()
    try:
        line = proc.stdout.readline()
        assert line.startswith("boot node up on port"), line
        port = int(line.split()[-1])
        peer = t.dial("127.0.0.1", port)
        assert peer is not None
        status = json.loads(peer.request(PROTO_STATUS.encode(),
                                         json.dumps({"listen_port": t.port}).encode(),
                                         timeout=10))
        assert status == {"boot_node": True, "head_slot": 0}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
    finally:
        t.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
