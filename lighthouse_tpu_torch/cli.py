"""CLI / process runtime (reference: the ``lighthouse`` binary —
``lighthouse/src/main.rs:34,339-343`` dispatching ``bn|vc|am|db``, with
``lighthouse/environment`` owning runtime + shutdown; the north-star
``--bls-backend cuda`` flag lands exactly here): the port of the JAX
package's ``cli.py``.

    python -m lighthouse_tpu_torch bn --preset minimal --interop-validators 64
    python -m lighthouse_tpu_torch bn --bls-backend fake --http-port 0
    python -m lighthouse_tpu_torch vc --beacon-node http://127.0.0.1:5052 ...
    python -m lighthouse_tpu_torch am wallet-create|validator-create ...
    python -m lighthouse_tpu_torch lcli interop-genesis --out genesis.ssz
    python -m lighthouse_tpu_torch db inspect --datadir ...
"""

from __future__ import annotations

import argparse
import getpass
import json
import signal
import sys
import threading

from .crypto.backend import DEFAULT as _DEFAULT_BACKEND


def _add_global_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--preset", choices=["mainnet", "minimal"], default="mainnet",
        help="compile-time preset analogue (EthSpec selection)",
    )
    p.add_argument(
        "--bls-backend",
        choices=["cuda", "cpu", "cpu-native", "fake"],
        default=_DEFAULT_BACKEND,
        help="BLS execution backend (the card's batch verifier is 'cuda')",
    )
    p.add_argument("--datadir", default=None)


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(prog="lighthouse_tpu_torch")
    sub = top.add_subparsers(dest="command", required=True)

    bn = sub.add_parser("bn", help="run a beacon node")
    _add_global_flags(bn)
    bn.add_argument("--http-port", type=int, default=5052)
    bn.add_argument("--http-host", default="127.0.0.1")
    bn.add_argument("--interop-validators", type=int, default=None,
                    help="quick-start genesis with N deterministic validators")
    bn.add_argument("--genesis-time", type=int, default=None)
    bn.add_argument("--workers", type=int, default=2)
    bn.add_argument("--listen-port", type=int, default=None,
                    help="p2p listen port (0 = free port; omit = no p2p)")
    bn.add_argument("--boot-nodes", nargs="*", default=[],
                    help="host:port addresses to dial at startup")
    bn.add_argument("--monitoring-endpoint", default=None,
                    help="POST process/beacon health to this URL every minute")

    vc = sub.add_parser("vc", help="run a validator client")
    _add_global_flags(vc)
    vc.add_argument("--beacon-node", action="append", required=True,
                    help="beacon node URL (repeatable for fallback)")
    vc.add_argument("--keystore", action="append", default=[],
                    help="EIP-2335 keystore path (repeatable)")
    vc.add_argument("--interop-keys", type=str, default=None,
                    help="range like 0:8 of deterministic interop keys")
    vc.add_argument("--graffiti-file", default=None,
                    help="per-validator graffiti mapping, reread each proposal")

    am = sub.add_parser("am", help="account manager")
    _add_global_flags(am)
    am_sub = am.add_subparsers(dest="am_command", required=True)
    w = am_sub.add_parser("wallet-create")
    w.add_argument("--name", required=True)
    w.add_argument("--out", required=True)
    w.add_argument("--kdf-work", type=int, default=None,
                   help="scrypt work factor override (tests/low-memory)")
    v = am_sub.add_parser("validator-create")
    v.add_argument("--wallet", required=True)
    v.add_argument("--out-dir", required=True)
    v.add_argument("--count", type=int, default=1)
    v.add_argument("--kdf-work", type=int, default=None)
    d = am_sub.add_parser(
        "validator-deposits",
        help="build DepositData (launchpad deposit_data.json) from keystores",
    )
    d.add_argument("--validator-dir", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--amount-gwei", type=int, default=32 * 10**9)
    d.add_argument("--password", default=None, help="keystore password (else prompt)")
    d.add_argument("--spec", choices=["mainnet", "minimal"], default="mainnet")
    x = am_sub.add_parser(
        "validator-exit", help="sign (and optionally publish) a voluntary exit"
    )
    x.add_argument("--keystore", required=True)
    x.add_argument("--validator-index", type=int, required=True)
    x.add_argument("--epoch", type=int, required=True)
    x.add_argument("--genesis-validators-root", required=True, help="0x-hex root")
    x.add_argument("--out", required=True)
    x.add_argument("--password", default=None)
    x.add_argument("--spec", choices=["mainnet", "minimal"], default="mainnet")
    x.add_argument("--beacon-url", default=None, help="POST the exit to this BN")

    bnode = sub.add_parser("boot-node", help="standalone peer-exchange bootstrap server")
    bnode.add_argument("--port", type=int, default=9000)

    lcli = sub.add_parser("lcli", help="dev/ops tools (reference lcli)")
    lcli_sub = lcli.add_subparsers(dest="lcli_command", required=True)
    ss = lcli_sub.add_parser("skip-slots", help="advance a state N slots")
    ss.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    ss.add_argument("--state", required=True, help="SSZ state file (fork byte prefixed)")
    ss.add_argument("--slots", type=int, required=True)
    ss.add_argument("--out", required=True)
    pr = lcli_sub.add_parser("pretty-ssz", help="decode an SSZ object to JSON")
    pr.add_argument("--preset", choices=["mainnet", "minimal"], default="mainnet")
    pr.add_argument("--type", required=True, dest="type_name")
    pr.add_argument("--file", required=True)
    ig = lcli_sub.add_parser("interop-genesis", help="write an interop genesis state")
    ig.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    ig.add_argument("--validators", type=int, default=64)
    ig.add_argument("--genesis-time", type=int, default=0)
    ig.add_argument("--out", required=True)
    tb = lcli_sub.add_parser("transition-blocks", help="apply SSZ blocks to a state")
    tb.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    tb.add_argument("--state", required=True)
    tb.add_argument("--blocks", nargs="+", required=True)
    tb.add_argument("--out", required=True)

    rr = lcli_sub.add_parser("state-root", help="hash_tree_root of an SSZ state")
    rr.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    rr.add_argument("--state", required=True)
    br = lcli_sub.add_parser("block-root", help="hash_tree_root of an SSZ signed block")
    br.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    br.add_argument("--block", required=True)
    nt = lcli_sub.add_parser(
        "new-testnet", help="write a testnet directory (config + genesis)"
    )
    nt.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    nt.add_argument("--validators", type=int, default=64)
    nt.add_argument("--genesis-time", type=int, default=0)
    nt.add_argument("--out-dir", dest="out_dir", required=True)
    eg = lcli_sub.add_parser(
        "eth1-genesis",
        help="genesis from (mock) eth1 deposit-contract logs",
    )
    eg.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    eg.add_argument("--validators", type=int, default=64)
    eg.add_argument("--genesis-time", type=int, default=0)
    eg.add_argument("--out", required=True)
    bk = lcli_sub.add_parser(
        "generate-bootnode-record",
        help="write a bootnode identity + address record (ENR analogue)",
    )
    bk.add_argument("--seed", default=None, help="deterministic identity seed")
    bk.add_argument("--host", default="127.0.0.1")
    bk.add_argument("--port", type=int, default=9000)
    bk.add_argument("--out", required=True)

    db = sub.add_parser("db", help="database manager")
    _add_global_flags(db)
    db_sub = db.add_subparsers(dest="db_command", required=True)
    inspect = db_sub.add_parser("inspect")
    inspect.add_argument("--datadir", default=None)
    ver = db_sub.add_parser("version", help="print the on-disk schema version")
    ver.add_argument("--datadir", required=True)
    mig = db_sub.add_parser("migrate", help="migrate the store to the latest schema")
    mig.add_argument("--datadir", required=True)
    pru = db_sub.add_parser(
        "prune", help="drop redundant pre-split hot snapshots + compact"
    )
    pru.add_argument("--datadir", required=True)

    return top


def run_bn(args) -> int:
    from .client import ClientBuilder, ClientConfig
    from .types.chain_spec import minimal_spec
    from .utils import metrics

    listen_port = args.listen_port
    if args.boot_nodes and listen_port is None:
        # boot nodes imply p2p: dialing without a listener would silently
        # no-op in the builder
        listen_port = 0
        print("--boot-nodes given without --listen-port: listening on a free port")
    cfg = ClientConfig(
        preset_base=args.preset,
        datadir=args.datadir,
        http_host=args.http_host,
        http_port=args.http_port,
        bls_backend=args.bls_backend,
        n_workers=args.workers,
        listen_port=listen_port,
        boot_nodes=tuple(args.boot_nodes),
        monitoring_endpoint=args.monitoring_endpoint,
    )
    spec = minimal_spec() if args.preset == "minimal" else None
    builder = ClientBuilder(cfg, spec)
    if args.interop_validators:
        import time as _time

        builder.with_interop_genesis(
            args.interop_validators,
            genesis_time=args.genesis_time or int(_time.time()),
        )
    client = builder.build().start()
    print(
        f"beacon node up: http://{args.http_host}:{client.api.port} "
        f"(backend={args.bls_backend}, preset={args.preset})",
        flush=True,
    )
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    client.stop()
    return 0


SLASHING_DB = "slashing_protection.sqlite"


def run_vc(args) -> int:
    from .eth2_client import BeaconNodeClient
    from .types.chain_spec import minimal_spec, mainnet_spec
    from .types.containers import types_for
    from .types.preset import PRESETS
    from .utils.slot_clock import SystemTimeSlotClock
    from .validator_client import BeaconNodeFallback, ValidatorClient, ValidatorStore

    preset = PRESETS[args.preset]
    spec = minimal_spec() if args.preset == "minimal" else mainnet_spec()
    t = types_for(preset)
    clients = [BeaconNodeClient(u, t) for u in args.beacon_node]
    nodes = BeaconNodeFallback(clients)
    genesis = nodes.call("genesis")
    gvr = bytes.fromhex(genesis["genesis_validators_root"][2:])
    slashing_db = None
    if args.datadir:
        # the signing history outlives the process (the JAX vc keeps it in
        # memory whatever --datadir says, so a restart forgets it)
        import os

        from .keys import SlashingDatabase

        slashing_db = SlashingDatabase(os.path.join(args.datadir, SLASHING_DB),
                                       genesis_validators_root=gvr)
    store = ValidatorStore(spec, preset, t, genesis_validators_root=gvr,
                           slashing_db=slashing_db)
    if args.interop_keys:
        from .state_transition import interop_secret_key

        lo, hi = (int(x) for x in args.interop_keys.split(":"))
        for i in range(lo, hi):
            store.add_secret_key(interop_secret_key(i))
    for path in args.keystore:
        with open(path) as f:
            ks = json.load(f)
        store.add_keystore(ks, getpass.getpass(f"password for {path}: "))
    clock = SystemTimeSlotClock(int(genesis["genesis_time"]), spec.seconds_per_slot)
    graffiti_file = None
    if args.graffiti_file:
        from .validator_client.graffiti import GraffitiFile

        graffiti_file = GraffitiFile(args.graffiti_file)
    vc = ValidatorClient(store, nodes, t, preset, clock, graffiti_file=graffiti_file)
    print(f"validator client up: {len(store.pubkeys())} keys", flush=True)
    signal.signal(signal.SIGINT, lambda *a: vc.stop())
    signal.signal(signal.SIGTERM, lambda *a: vc.stop())
    vc.run_forever()
    return 0


def run_am(args) -> int:
    from .keys import Wallet, save

    if args.am_command == "wallet-create":
        password = getpass.getpass("wallet password: ")
        w = Wallet.create(args.name, password, kdf_work=args.kdf_work)
        with open(args.out, "w") as f:
            json.dump(w.json, f, indent=2)
        print(f"wallet written to {args.out}")
        return 0
    if args.am_command == "validator-create":
        import os

        with open(args.wallet) as f:
            wobj = json.load(f)
        w = Wallet(wobj)
        wallet_pw = getpass.getpass("wallet password: ")
        ks_pw = getpass.getpass("keystore password: ")
        os.makedirs(args.out_dir, exist_ok=True)
        for _ in range(args.count):
            signing, withdrawal = w.next_validator(wallet_pw, ks_pw, kdf_work=args.kdf_work)
            stem = signing["pubkey"][:12]
            save(signing, f"{args.out_dir}/keystore-{stem}.json")
            save(withdrawal, f"{args.out_dir}/withdrawal-{stem}.json")
            print(f"validator 0x{signing['pubkey'][:16]}… written")
        with open(args.wallet, "w") as f:
            json.dump(w.json, f, indent=2)
        return 0
    if args.am_command == "validator-deposits":
        return _am_validator_deposits(args)
    if args.am_command == "validator-exit":
        return _am_validator_exit(args)
    return 1


def _am_spec(name: str):
    from .types.chain_spec import mainnet_spec, minimal_spec

    return minimal_spec() if name == "minimal" else mainnet_spec()


def _am_validator_deposits(args) -> int:
    """DepositData per keystore in --validator-dir (reference
    ``account_manager`` deposit creation; EF launchpad deposit_data.json
    shape: signed DepositMessage under DOMAIN_DEPOSIT with a zeroed
    genesis_validators_root)."""
    import getpass
    import glob
    import os

    from .crypto import bls
    from .keys.keystore import decrypt, load
    from .ssz import hash_tree_root
    from .types.chain_spec import DOMAIN_DEPOSIT
    from .types.containers import types_for
    from .types.domains import compute_domain, compute_signing_root
    from .types.preset import PRESETS

    spec = _am_spec(args.spec)
    t = types_for(PRESETS[args.spec])
    password = args.password or getpass.getpass("keystore password: ")
    out = []
    paths = sorted(glob.glob(os.path.join(args.validator_dir, "keystore-*.json")))
    if not paths:
        print("no keystore-*.json files found", file=sys.stderr)
        return 1
    for path in paths:
        ks = load(path)
        sk = bls.SecretKey.deserialize(decrypt(ks, password))
        pubkey = sk.public_key().serialize()
        # BLS withdrawal credentials: 0x00 || sha256(pubkey)[1:]
        import hashlib as _hashlib

        cred = b"\x00" + _hashlib.sha256(pubkey).digest()[1:]
        msg = t.DepositMessage(
            pubkey=pubkey, withdrawal_credentials=cred, amount=args.amount_gwei
        )
        domain = compute_domain(
            spec, DOMAIN_DEPOSIT, spec.genesis_fork_version, bytes(32)
        )
        root = compute_signing_root(t.DepositMessage, msg, domain)
        sig = sk.sign(root).serialize()
        dd = t.DepositData(
            pubkey=pubkey, withdrawal_credentials=cred,
            amount=args.amount_gwei, signature=sig,
        )
        out.append(
            {
                "pubkey": pubkey.hex(),
                "withdrawal_credentials": cred.hex(),
                "amount": args.amount_gwei,
                "signature": sig.hex(),
                "deposit_message_root": root.hex(),
                "deposit_data_root": hash_tree_root(t.DepositData, dd).hex(),
                "fork_version": spec.genesis_fork_version.hex(),
            }
        )
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {len(out)} deposit(s) to {args.out}")
    return 0


def _am_validator_exit(args) -> int:
    """Sign a VoluntaryExit offline (reference ``account_manager`` exit):
    domain from DOMAIN_VOLUNTARY_EXIT at --epoch against the supplied
    genesis validators root; optional publish to --beacon-url."""
    import getpass

    from .crypto import bls
    from .keys.keystore import decrypt, load
    from .types.chain_spec import DOMAIN_VOLUNTARY_EXIT
    from .types.containers import types_for
    from .types.domains import compute_domain, compute_signing_root
    from .types.preset import PRESETS

    spec = _am_spec(args.spec)
    t = types_for(PRESETS[args.spec])
    password = args.password or getpass.getpass("keystore password: ")
    sk = bls.SecretKey.deserialize(decrypt(load(args.keystore), password))
    gvr = bytes.fromhex(args.genesis_validators_root.removeprefix("0x"))
    exit_msg = t.VoluntaryExit(epoch=args.epoch, validator_index=args.validator_index)
    domain = compute_domain(
        spec, DOMAIN_VOLUNTARY_EXIT, spec.fork_version_at_epoch(args.epoch), gvr
    )
    root = compute_signing_root(t.VoluntaryExit, exit_msg, domain)
    signed = t.SignedVoluntaryExit(
        message=exit_msg, signature=sk.sign(root).serialize()
    )
    from .ssz.json import to_json

    doc = to_json(t.SignedVoluntaryExit, signed)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote signed exit for validator {args.validator_index} to {args.out}")
    if args.beacon_url:
        import urllib.request

        req = urllib.request.Request(
            args.beacon_url.rstrip("/") + "/eth/v1/beacon/pool/voluntary_exits",
            data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            print(f"published: HTTP {r.status}")
    return 0


def run_boot_node(args) -> int:
    """Chain-less peer-exchange hub (reference ``boot_node``: a
    standalone discv5 server; here the transport's peer-exchange protocol
    plays the discovery role)."""
    import json as _json
    import threading as _threading

    from .network.service import PROTO_PEER_EXCHANGE, PROTO_PING, PROTO_STATUS
    from .network.transport import Transport

    t = Transport(port=args.port)

    def on_request(peer, protocol, payload):
        if protocol == PROTO_PEER_EXCHANGE:
            peers = [
                [p.addr[0], p.remote_listen_port]
                for p in t.peers_snapshot()
                if p.remote_listen_port
            ]
            return _json.dumps(peers).encode()
        if protocol == PROTO_STATUS:
            try:
                theirs = _json.loads(payload)
                peer.remote_listen_port = theirs.get("listen_port")
            except ValueError:
                pass
            return _json.dumps({"boot_node": True, "head_slot": 0}).encode()
        if protocol == PROTO_PING:
            return b"pong"
        return b""

    t.on_request = on_request
    print(f"boot node up on port {t.port}", flush=True)
    stop = _threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    t.close()
    return 0


def run_lcli(args) -> int:
    if args.lcli_command == "generate-bootnode-record":
        import json as _json

        from .network import noise as _noise

        ident = (
            _noise.Identity.from_seed(args.seed.encode())
            if args.seed else _noise.Identity()
        )
        rec = {
            "node_id": ident.node_id,
            "static_pubkey": "0x" + ident.public.hex(),
            "host": args.host,
            "port": args.port,
        }
        with open(args.out, "w") as f:
            _json.dump(rec, f, indent=1)
        print(f"bootnode record {ident.node_id[:16]}... -> {args.out}")
        return 0
    from .ssz.json import to_json
    from .state_transition import interop_genesis_state, per_slot_processing, process_block
    from .state_transition.epoch import fork_of
    from .types.chain_spec import mainnet_spec, minimal_spec
    from .types.containers import types_for
    from .types.preset import PRESETS

    preset = PRESETS[args.preset]
    spec = minimal_spec() if args.preset == "minimal" else mainnet_spec()
    from .types.containers import FORK_IDS as ids, FORK_NAMES as forks

    t = types_for(preset)

    def read_state(path):
        raw = open(path, "rb").read()
        return t.state[forks[raw[0]]].decode(raw[1:])

    def write_state(path, st):
        with open(path, "wb") as f:
            f.write(bytes([ids[fork_of(st)]]) + type(st).encode(st))

    if args.lcli_command == "interop-genesis":
        st = interop_genesis_state(
            preset, spec, args.validators, genesis_time=args.genesis_time
        )
        write_state(args.out, st)
        print(f"wrote genesis state ({len(st.validators)} validators) to {args.out}")
        return 0
    if args.lcli_command == "skip-slots":
        st = read_state(args.state)
        for _ in range(args.slots):
            st = per_slot_processing(preset, spec, st)
        write_state(args.out, st)
        print(f"advanced to slot {st.slot}")
        return 0
    if args.lcli_command == "transition-blocks":
        st = read_state(args.state)
        import struct as _struct

        for path in args.blocks:
            raw = open(path, "rb").read()
            # fork of a block follows ITS slot (may be past a fork
            # boundary the state has not crossed yet): slot is the first
            # u64 of the message, at fixed offset 4 (signature offset) + 0
            slot = _struct.unpack_from("<Q", raw, 4)[0]
            fork = spec.fork_name_at_epoch(slot // preset.SLOTS_PER_EPOCH)
            sb = t.signed_block[fork].decode(raw)
            while st.slot < sb.message.slot:
                st = per_slot_processing(preset, spec, st)
            process_block(preset, spec, st, sb, fork_of(st), signature_strategy="none")
        write_state(args.out, st)
        print(f"applied {len(args.blocks)} block(s); state at slot {st.slot}")
        return 0
    if args.lcli_command == "pretty-ssz":
        raw = open(args.file, "rb").read()
        tpe = getattr(t, args.type_name, None)
        if tpe is None:
            print(f"unknown type {args.type_name}", file=sys.stderr)
            return 1
        obj = tpe.decode(raw)
        print(json.dumps(to_json(tpe, obj), indent=2))
        return 0
    if args.lcli_command == "state-root":
        st = read_state(args.state)
        from .ssz import hash_tree_root as _htr

        print("0x" + _htr(st).hex())
        return 0
    if args.lcli_command == "block-root":
        import struct as _struct

        from .ssz import hash_tree_root as _htr

        raw = open(args.block, "rb").read()
        # fork auto-detection from the block slot (same scheme as
        # transition-blocks): SignedBeaconBlock = offset(4) + sig(96) +
        # message, whose first field is the u64 slot
        (slot,) = _struct.unpack_from("<Q", raw, 100)
        fork = spec.fork_name_at_epoch(slot // preset.SLOTS_PER_EPOCH)
        sb = t.signed_block[fork].decode(raw)
        print("0x" + _htr(type(sb.message), sb.message).hex())
        return 0
    if args.lcli_command == "eth1-genesis":
        # reference lcli eth1-genesis: build genesis from deposit-contract
        # logs; here the deposits are built locally with signed
        # DepositData (the real-chain variant needs an eth1 RPC)
        import hashlib as _hashlib

        from .ssz.sha256 import hash32_concat as _h32
        from .state_transition.genesis import (
            initialize_beacon_state_from_eth1,
            interop_secret_key,
        )
        from .types.chain_spec import DOMAIN_DEPOSIT
        from .types.domains import compute_domain, compute_signing_root

        deposits = []
        domain = compute_domain(
            spec, DOMAIN_DEPOSIT, spec.genesis_fork_version, bytes(32)
        )
        for i in range(args.validators):
            sk = interop_secret_key(i)
            pubkey = sk.public_key().serialize()
            cred = b"\x00" + _hashlib.sha256(pubkey).digest()[1:]
            msg = t.DepositMessage(
                pubkey=pubkey, withdrawal_credentials=cred,
                amount=preset.MAX_EFFECTIVE_BALANCE,
            )
            root = compute_signing_root(t.DepositMessage, msg, domain)
            dd = t.DepositData(
                pubkey=pubkey, withdrawal_credentials=cred,
                amount=preset.MAX_EFFECTIVE_BALANCE,
                signature=sk.sign(root).serialize(),
            )
            deposits.append(t.Deposit(data=dd))
        # deterministic mock eth1 block hash (same rule the mock endpoint
        # uses); initialize_* recomputes the incremental deposit root
        # itself from `deposits`
        eth1_hash = _h32((1).to_bytes(32, "little"), b"eth1".ljust(32, b"\x00"))
        st = initialize_beacon_state_from_eth1(
            preset, spec, eth1_hash, args.genesis_time or 1, deposits
        )
        write_state(args.out, st)
        print(
            f"wrote eth1 genesis ({len(st.validators)} validators, "
            f"deposit_root 0x{bytes(st.eth1_data.deposit_root).hex()[:16]}...) "
            f"to {args.out}"
        )
        return 0
    if args.lcli_command == "new-testnet":
        import os as _os

        import yaml as _yaml

        _os.makedirs(args.out_dir, exist_ok=True)
        st = interop_genesis_state(
            preset, spec, args.validators, genesis_time=args.genesis_time
        )
        write_state(f"{args.out_dir}/genesis.ssz", st)
        cfg = {
            "PRESET_BASE": args.preset,
            "MIN_GENESIS_TIME": int(args.genesis_time),
            "GENESIS_FORK_VERSION": "0x" + spec.genesis_fork_version.hex(),
            "SECONDS_PER_SLOT": int(spec.seconds_per_slot),
            "GENESIS_VALIDATORS_ROOT": "0x"
            + bytes(st.genesis_validators_root).hex(),
            "MIN_PER_EPOCH_CHURN_LIMIT": int(spec.min_per_epoch_churn_limit),
            "CHURN_LIMIT_QUOTIENT": int(spec.churn_limit_quotient),
            "EJECTION_BALANCE": int(spec.ejection_balance),
        }
        with open(f"{args.out_dir}/config.yaml", "w") as f:
            _yaml.safe_dump(cfg, f)
        with open(f"{args.out_dir}/boot_nodes.yaml", "w") as f:
            _yaml.safe_dump([], f)
        print(
            f"testnet dir {args.out_dir}: genesis.ssz "
            f"({args.validators} validators), config.yaml, boot_nodes.yaml"
        )
        return 0
    return 1


def run_db(args) -> int:
    from .store import Column, SqliteStore

    if args.db_command == "inspect":
        if not args.datadir:
            print("--datadir required", file=sys.stderr)
            return 1
        kv = SqliteStore(f"{args.datadir}/chain.sqlite")
        for col, name in [
            (Column.BLOCK, "blocks"),
            (Column.STATE, "hot state snapshots"),
            (Column.STATE_SUMMARY, "hot state summaries"),
            (Column.COLD_STATE, "cold restore points"),
        ]:
            print(f"{name}: {sum(1 for _ in kv.keys(col))}")
        head = kv.get(Column.METADATA, b"head")
        print(f"head: {head.hex() if head else None}")
        return 0
    if args.db_command == "version":
        kv = SqliteStore(f"{args.datadir}/chain.sqlite")
        print(f"schema version: {_db_schema_version(kv)}")
        return 0
    if args.db_command == "migrate":
        kv = SqliteStore(f"{args.datadir}/chain.sqlite")
        v = _db_schema_version(kv)
        for target, fn in sorted(_DB_MIGRATIONS.items()):
            if v < target:
                fn(kv)
                kv.put(Column.METADATA, b"schema", str(target).encode())
                print(f"migrated v{v} -> v{target}")
                v = target
        print(f"store at schema v{v} (latest {DB_SCHEMA_LATEST})")
        return 0
    if args.db_command == "prune":
        import struct as _struct

        kv = SqliteStore(f"{args.datadir}/chain.sqlite")
        raw = kv.get(Column.METADATA, b"split")
        split = _struct.unpack("<Q", raw)[0] if raw else 0
        # pre-split hot snapshots are redundant once migrated to the
        # freezer (reference database_manager prune-states); the head
        # state is safe because head slot >= split always holds
        dropped = 0
        for key in list(kv.keys(Column.STATE)):
            data = kv.get(Column.STATE, key)
            if data is None:
                continue
            # every BeaconState starts [fork_id u8][genesis_time u64]
            # [genesis_validators_root 32][slot u64]
            slot = int.from_bytes(data[1 + 8 + 32 : 1 + 8 + 32 + 8], "little")
            if slot and slot < split:
                kv.delete(Column.STATE, key)
                dropped += 1
        # pre-split summaries must go WITH their base snapshots: a kept
        # summary whose replay chain bottoms out in a deleted snapshot
        # would fail to load (StateSummary starts [slot u64])
        for key in list(kv.keys(Column.STATE_SUMMARY)):
            data = kv.get(Column.STATE_SUMMARY, key)
            if data is None:
                continue
            slot = int.from_bytes(data[:8], "little")
            if slot and slot < split:
                kv.delete(Column.STATE_SUMMARY, key)
                dropped += 1
        try:
            kv._conn.execute("VACUUM")
        except Exception:
            pass
        print(f"dropped {dropped} pre-split hot snapshots (split slot {split})")
        return 0
    return 1


DB_SCHEMA_LATEST = 1
# target version -> migration fn(kv); v1 is the current layout, so the
# table is empty — the framework (version stamp + ordered apply) mirrors
# the reference's schema_change.rs
_DB_MIGRATIONS: dict = {}


def _db_schema_version(kv) -> int:
    from .store import Column

    raw = kv.get(Column.METADATA, b"schema")
    return int(raw.decode()) if raw else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "bn":
        return run_bn(args)
    if args.command == "vc":
        return run_vc(args)
    if args.command == "am":
        return run_am(args)
    if args.command == "db":
        return run_db(args)
    if args.command == "boot-node":
        return run_boot_node(args)
    if args.command == "lcli":
        return run_lcli(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
