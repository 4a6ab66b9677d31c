"""Mean sets per device dispatch, counted around the scheduler's verifier."""

from benchmark import readers


def read(run):
    return readers.mean_sets_per_dispatch(run)
