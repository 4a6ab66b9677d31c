"""The control on the card: the program with half of every batch left
out (a verifier that checks the first half of the sets it is handed and
says nothing of the rest) in the program's place, each cell at its own
size, on three seeds. The check must find it not correct every time.

Run on the card with
``python -m pytest benchmark/tests/test_portbench_control.py -m cuda -s``;
without one it skips."""

import sys

import pytest

from benchmark import run

pytestmark = pytest.mark.cuda

SEEDS = (2**31 + 1201, 2**31 + 1202, 2**31 + 1203)
# the cells' own window, so that the check compares as many calls as a run does
SECONDS = {"gnosis.sync": 24.0}


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs the program on the card")


def half_left_out(sets):
    from lighthouse_tpu_torch.crypto import bls

    sets = list(sets)
    return bls.verify_signature_sets(sets[:(len(sets) + 1) // 2])


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_control_is_not_correct(card, cell):
    spec = run.load_cell(cell)
    outs = []
    for seed in SEEDS:
        out = run.run_cell(spec, seed, SECONDS[cell], False, verify=half_left_out,
                           log=lambda *a: print(*a, file=sys.stderr))
        print(f"control {cell} seed {seed}: {out['checks']}", flush=True)
        outs.append(out)
    assert all(out["correct"] is False for out in outs)
    assert all(out["checks"]["verdict_mismatches"]["value"] >= 1 for out in outs)
