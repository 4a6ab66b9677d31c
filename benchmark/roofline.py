"""The yardstick of the kernels: the H100's peaks and the least time each
hand-written kernel (K1-K3 of ``lighthouse_tpu_torch/csrc/fp_kernels.cu``)
could take, a frozen copy of ``chip_smoke.py``'s ``bound()``.

A lane of each kernel reads its operands and writes its result once
(``LANE_BYTES``) and does ``MACS`` int32 multiply-adds: the 32 x 32
schoolbook limb products of each Fp product plus the folds of its
reductions (``kernels.macs_per_lane`` of the port at the time of copying;
a test holds the two equal). The least time of one launch of ``lanes``
lanes is the larger of its bytes over HBM's bandwidth and its operations
over the int32 multiply-add rate.
"""

from __future__ import annotations

from typing import Dict, Tuple

MEM_RATE = 3.35e12         # bytes/s, H100 SXM HBM3 (NVIDIA data sheet)
INT32_MAC_RATE = 16.75e12  # int32 multiply-adds/s: 64 INT32 lanes/SM x 132 SMs x 1.98 GHz

# kernel -> (the name its launches carry in the profiler, bytes a lane, int32 MACs a lane)
KERNELS: Dict[str, Tuple[str, int, int]] = {
    "fp_mul_cols": ("fp_mul_kernel", 3 * 32 * 4, 2240),
    "fp2_mul": ("fp2_mul_kernel", 3 * 64 * 4, 6976),
    "fp2_sq": ("fp2_sq_kernel", 2 * 64 * 4, 4672),
}


def bound_s(kernel: str, lanes: int) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time one launch of
    ``lanes`` lanes of ``kernel`` could take, and what bounds it."""
    _, lane_bytes, macs = KERNELS[kernel]
    byte_s = lanes * lane_bytes / MEM_RATE
    op_s = lanes * macs / INT32_MAC_RATE
    return (byte_s, "bytes") if byte_s >= op_s else (op_s, "operations")


def least_seconds(kernel: str, lane_hist) -> float:
    """The least time of every launch counted in ``lane_hist`` ({lanes:
    launches})."""
    return sum(n * bound_s(kernel, int(lanes))[0] for lanes, n in lane_hist.items())
