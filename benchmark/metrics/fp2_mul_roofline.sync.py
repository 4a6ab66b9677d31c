"""fp2_mul's least time (its launches counted in the traced slice, at
roofline.py's peaks) over its profiler device time, %."""

from benchmark import readers


def read(run):
    return readers.kernel_roofline_pct(run, "fp2_mul")
