"""Device time of every kernel but K1-K3 inside the dispatches that lie
wholly in the traced slice, per such dispatch (torch.profiler), ms."""

from benchmark import readers


def read(run):
    return readers.glue_ms(run)
