"""Seconds from the process's start to its first timed submission."""

from benchmark import readers


def read(run):
    return run.setup_s
