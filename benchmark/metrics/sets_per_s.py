"""Sets of the segments completed, over the time from the first submission
to the last verdict."""

from benchmark import readers


def read(run):
    return readers.sets_per_s(run)
