"""Mean key-table resolve plus host pack per dispatch (CudaBackend.last_batch), ms."""

from benchmark import readers


def read(run):
    return readers.host_ms(run)
