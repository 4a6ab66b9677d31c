"""``lighthouse_tpu_torch`` stands alone: it never imports JAX, jaxlib,
any module of the ``lighthouse_tpu`` package or ``cryptography`` (which the
card's machine need not have: the port carries its own X25519,
ChaCha20-Poly1305 and AES-128-CTR).

Two checks: a static walk over every import statement of the package's
sources (whose file tree is the JAX package's, give or take two named
lists: the files the port leaves out, each with its reason, and the
port's own files), and a fresh interpreter that imports the whole package and shows
that the import added no ``jax*`` and no ``lighthouse_tpu``/
``lighthouse_tpu.*`` and no ``cryptography`` module to ``sys.modules`` (against a snapshot taken
just before the import).
"""

import ast
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "lighthouse_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lighthouse_tpu", "cryptography")
# The JAX package's files the port leaves out, with the reason.
LEFT_OUT = {
    "crypto/device/pallas_fp.py": "K1's Pallas kernel: fp_mul_kernel in csrc/fp_kernels.cu",
    "crypto/device/pallas_fp2.py": "K2's and K3's Pallas kernels: fp2_mul_kernel and "
                                   "fp2_sq_kernel in csrc/fp_kernels.cu",
    "compile_service/cache.py": "it wraps XLA's persistent compilation cache; a CUDA graph "
                                "cannot be written to disk",
}
# The port's own files, with no JAX counterpart.
PORT_ONLY = {"crypto/device/graphs.py", "crypto/device/kernels.py", "crypto/device/linear.py",
             "utils/crypto.py"}


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_forbidden_import_statements():
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) >= 110
    names = {str(p.relative_to(PKG)) for p in sources}
    jax_names = {str(p.relative_to(ROOT / "lighthouse_tpu"))
                 for p in (ROOT / "lighthouse_tpu").rglob("*.py")}
    assert set(LEFT_OUT) <= jax_names and not PORT_ONLY & jax_names
    assert names == (jax_names - set(LEFT_OUT)) | PORT_ONLY, (
        sorted(names ^ ((jax_names - set(LEFT_OUT)) | PORT_ONLY)))
    assert {"crypto/device/key_table.py", "crypto/device/msm.py",
            "crypto/device/graphs.py", "compile_service/service.py",
            "compile_service/lowering.py", "verification_service/planner.py",
            "utils/slot_clock.py", "verification_service/batcher.py",
            "verification_service/slo.py", "verification_service/admission.py",
            "verification_service/traffic.py", "utils/metrics.py", "utils/tracing.py",
            "utils/flight_recorder.py", "crypto/native.py", "_native/__init__.py",
            "crypto/device/mesh.py", "utils/fault_injection.py",
            "utils/slot_ledger.py", "utils/transfer_ledger.py",
            "utils/pipeline_profiler.py", "utils/timeseries.py",
            "types/containers.py", "types/chain_spec.py", "ssz/core.py", "ssz/sha256.py",
            "ssz/cache.py", "utils/logging.py", "crypto/backend.py", "crypto/cpu/bls.py",
            "crypto/cpu/pairing.py", "state_transition/block.py",
            "state_transition/signature_sets.py", "state_transition/state/epoch.py",
            "fork_choice/proto_array.py", "fork_choice/persistence.py", "store/kv.py",
            "store/hot_cold.py", "beacon_chain/chain.py", "beacon_chain/pubkey_cache.py",
            "beacon_chain/attestation_verification.py",
            "beacon_chain/sync_committee_verification.py", "testing/harness.py",
            "operation_pool/pool.py", "operation_pool/device_agg.py",
            "operation_pool/persistence.py", "duty_lookahead/__init__.py",
            "beacon_processor/processor.py", "utils/watchtower.py", "utils/monitoring.py",
            "utils/system_health.py", "utils/lockfile.py", "beacon_chain/light_client.py",
            "http_api/server.py", "client.py", "cli.py", "__main__.py",
            "testing/fork_choice_runner.py", "utils/snappy.py", "_native/__init__.py",
            "utils/crypto.py", "network/noise.py", "network/transport.py", "network/mesh.py",
            "network/discovery.py", "network/peer_manager.py", "network/service.py",
            "eth2_client.py", "keys/derivation.py", "keys/keystore.py",
            "keys/slashing_protection.py", "keys/wallet.py",
            "validator_client/validator_store.py", "validator_client/services.py",
            "validator_client/preparation_service.py", "validator_client/graffiti.py",
            "validator_client/http_api.py", "validator_client/web3signer.py",
            "testing/simulator.py", "slasher/__init__.py", "slasher/slasher.py",
            "eth1/__init__.py", "eth1/service.py", "execution_layer/__init__.py",
            "execution_layer/engine_api.py", "execution_layer/execution_layer.py",
            "execution_layer/mock.py", "execution_layer/builder_client.py"} <= names
    bad = []
    for path in sources:
        for name in _imports(ast.parse(path.read_text(), str(path))):
            if _forbidden(name):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
    assert not _forbidden("lighthouse_tpu_torch.crypto")
    assert _forbidden("lighthouse_tpu.crypto") and _forbidden("jax.numpy")
    assert _forbidden("cryptography.hazmat.primitives.ciphers.aead")


def test_import_adds_no_jax_or_reference_module():
    code = f"""
import json, pkgutil, sys, importlib
sys.path.insert(0, {str(ROOT)!r})
before = set(sys.modules)
import lighthouse_tpu_torch
for m in pkgutil.walk_packages(lighthouse_tpu_torch.__path__, "lighthouse_tpu_torch."):
    importlib.import_module(m.name)
added = sorted(set(sys.modules) - before)
print(json.dumps(added))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, check=True, cwd=str(ROOT),
    )
    added = json.loads(out.stdout.strip().splitlines()[-1])
    ported = [m for m in added if m.startswith("lighthouse_tpu_torch.")]
    for mod in ("crypto.device.kernels", "crypto.device.bls", "crypto.device.key_table",
                "crypto.device.msm", "crypto.device.graphs", "compile_service.service",
                "compile_service.lowering", "verification_service.planner",
                "utils.slot_clock", "verification_service.batcher",
                "verification_service.traffic", "crypto.native", "_native",
                "crypto.device.mesh", "utils.fault_injection",
                "utils.slot_ledger", "utils.transfer_ledger",
                "utils.pipeline_profiler", "utils.timeseries", "types.containers",
                "ssz.core", "ssz.sha256", "utils.logging", "crypto.backend", "crypto.cpu.bls",
                "crypto.cpu.pairing", "state_transition.block", "state_transition.epoch",
                "fork_choice.fork_choice", "store.hot_cold", "beacon_chain.chain",
                "beacon_chain.block_verification", "testing.harness",
                "operation_pool.device_agg", "duty_lookahead", "beacon_processor.processor",
                "utils.watchtower", "http_api.server", "client", "cli",
                "utils.snappy", "utils.crypto", "network.noise", "network.service",
                "eth2_client", "keys.keystore", "validator_client.services",
                "testing.simulator", "testing.fork_choice_runner", "slasher.slasher",
                "eth1.service", "execution_layer.engine_api",
                "execution_layer.execution_layer", "execution_layer.mock",
                "execution_layer.builder_client"):
        assert f"lighthouse_tpu_torch.{mod}" in ported
    leaked = [m for m in added if _forbidden(m) or m.startswith("jax")]
    assert not leaked, leaked
    assert "triton" not in added
