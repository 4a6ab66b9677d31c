"""The check catches a broken timed path: a run driven on the CPU at a
small size, with the program's batch verifier replaced by the plain
reference (sound) or by the reference with one fault planted, comes out
correct only when sound. The harness's look for a card is skipped; the
generator, the signer, the scheduler, the load and the check all run."""

import sys

import pytest

from benchmark import reference, run

SMALL = {"validators": 2048, "slots_per_epoch": 4, "max_committees_per_slot": 4,
         "target_committee_size": 16, "max_attestations": 8, "sync_committee_size": 32}


def sound(sets):
    sets = list(sets)
    return bool(sets) and all(reference.set_verifies(s.signature.serialize(), s.signing_indices,
                                                     s.message) for s in sets)


def unchanged(sets):
    """Does no work and says every batch verifies."""
    return True


def all_false(sets):
    """Says no batch verifies."""
    return False


def half_left_out(sets):
    """Verifies the first half of the batch and leaves the rest out."""
    sets = list(sets)
    return sound(sets[:(len(sets) + 1) // 2])


class Flipped:
    """Every third dispatch's verdict, altered where it is produced."""

    def __init__(self):
        self.n = 0

    def __call__(self, sets):
        self.n += 1
        out = sound(sets)
        return (not out) if self.n % 3 == 0 else out


def small():
    spec = run.load_cell("gnosis.sync")
    spec["cfg"] = dict(spec["cfg"], **SMALL)
    spec["traffic"] = dict(spec["traffic"], ceiling_sets_per_s=40)
    spec["settings"] = dict(spec["settings"], rungs=[], check={"max_sets": 10**6})
    return spec


@pytest.mark.parametrize("fault", ["sound", "unchanged", "half_left_out", "flipped", "all_false"])
def test_check_catches_each_fault(fault):
    verify = {"sound": sound, "unchanged": unchanged, "half_left_out": half_left_out,
              "flipped": Flipped(), "all_false": all_false}[fault]
    out = run.run_cell(small(), 2**31 + 77, 3.0, False, device="cpu", verify=verify,
                       workers=1, log=lambda *a: print(*a, file=sys.stderr))
    assert out["correct"] is (fault == "sound"), out["checks"]
    assert list(out)[-1] == "checks"
