"""What the benchmark imports: no run module names ``jax``, ``jaxlib``,
``flax`` or ``lighthouse_tpu`` at the top level of any import, and the
reference names nothing of the program either. Names are compared whole,
before the first dot: ``lighthouse_tpu_torch`` is the program, not the
JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
RUN_MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
NEVER = {"jax", "jaxlib", "flax", "lighthouse_tpu"}


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", RUN_MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_run_modules_import_no_jax(path):
    assert not top_level_imports(path) & NEVER


def test_reference_imports_nothing_of_the_program():
    names = top_level_imports(BENCH / "reference.py")
    assert not names & (NEVER | {"lighthouse_tpu_torch", "benchmark", "torch"})
    # and in a process of its own, nothing of either package is loaded
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference as r; "
            "r.expected_signature([1, 2], bytes(32)); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(BENCH.parent))
    loaded = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            check=True, timeout=120).stdout
    for name in NEVER | {"lighthouse_tpu_torch", "torch"}:
        assert f"'{name}'" not in loaded


def test_names_are_compared_whole():
    from benchmark import run

    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "lighthouse_tpu")
    sys.modules.setdefault("lighthouse_tpu_torch_probe_x", sys)
    try:
        assert "lighthouse_tpu_torch_probe_x" not in run.forbidden_modules()
    finally:
        del sys.modules["lighthouse_tpu_torch_probe_x"]
