"""The share of the traced slice in which no kernel ran (torch.profiler), %."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
