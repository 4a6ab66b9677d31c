"""Without a card the run fails and prints no result: it never falls
back to the CPU. The tests run where there is no card; the one check
that needs the card's absence skips on a machine that has one."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def run(cwd: Path, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gnosis.sync", "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result(no_card):
    res = run(ROOT)
    assert res.returncode == 2
    assert res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    # a directory with BENCHMARK.json and the benchmark's files only
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    res = run(tmp_path)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


def test_every_cell_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        for part in (f"traffic/{cell['traffic']}.json", f"cells/{cell['name']}.json"):
            assert (ROOT / "benchmark" / part).exists(), part
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists(), m["name"]
