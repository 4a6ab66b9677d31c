"""``lighthouse_tpu_torch`` stands alone: it never imports JAX, jaxlib or
any module of the ``lighthouse_tpu`` package.

Two checks: a static walk over every import statement of the package's
sources, and a fresh interpreter that imports the whole package and shows
that the import added no ``jax*`` and no ``lighthouse_tpu``/
``lighthouse_tpu.*`` module to ``sys.modules`` (against a snapshot taken
just before the import).
"""

import ast
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "lighthouse_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lighthouse_tpu")


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
            "http_api/server.py", "client.py", "cli.py", "__main__.py"} <= names
    bad = []
    for path in sources:
        for name in _imports(ast.parse(path.read_text(), str(path))):
            if _forbidden(name):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
    assert not _forbidden("lighthouse_tpu_torch.crypto")
    assert _forbidden("lighthouse_tpu.crypto") and _forbidden("jax.numpy")


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
                "utils.watchtower", "http_api.server", "client", "cli"):
        assert f"lighthouse_tpu_torch.{mod}" in ported
    leaked = [m for m in added if _forbidden(m) or m.startswith("jax")]
    assert not leaked, leaked
    assert "triton" not in added
