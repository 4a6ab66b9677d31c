"""Mean stage 1 + 2 + 3 seconds per dispatch (CudaBackend.last_batch), ms."""

from benchmark import readers


def read(run):
    return readers.stage_ms(run)
