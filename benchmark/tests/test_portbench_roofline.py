"""The frozen copy of the kernels' roofline arithmetic gives PERF.md's
bytes and int32 multiply-adds per lane, and the port's own count."""

import pytest

from benchmark import roofline


@pytest.mark.parametrize("kernel,lane_bytes,macs", [
    ("fp_mul_cols", 384, 2240), ("fp2_mul", 768, 6976), ("fp2_sq", 512, 4672)])
def test_per_lane_counts(kernel, lane_bytes, macs):
    _name, b, m = roofline.KERNELS[kernel]
    assert (b, m) == (lane_bytes, macs)
    from lighthouse_tpu_torch.crypto.device import kernels

    assert kernels.macs_per_lane(kernel) == macs


def test_bound_is_the_larger_side():
    # K1 at 147,456 lanes: 2240 MACs a lane at 16.75e12/s beat 384 B at 3.35e12 B/s
    s, by = roofline.bound_s("fp_mul_cols", 147456)
    assert by == "operations"
    assert s == pytest.approx(147456 * 2240 / 16.75e12)
    assert roofline.least_seconds("fp_mul_cols", {147456: 2, 1: 3}) == pytest.approx(
        2 * s + 3 * roofline.bound_s("fp_mul_cols", 1)[0])
