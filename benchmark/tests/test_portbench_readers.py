"""The readers' arithmetic on a made-up traced slice: the glue's device
time counts only kernels inside the dispatches that lie wholly in the
slice, and the idle share is the slice's time with no kernel running."""

from types import SimpleNamespace

import pytest

from benchmark import devtrace, readers


def traced_run():
    tr = devtrace.Trace()
    tr.entered, tr.t0, tr.t1, tr.stop_s = 0.5, 1.0, 3.0, 0.1
    tr.kernels = [
        (0.9, 1.05, "add_kernel"),          # the dispatch cut by the slice's start
        (1.2, 1.3, "add_kernel"),           # dispatch A
        (1.3, 1.35, "fp_mul_kernel<true>"),  # dispatch A, K1
        (2.0, 2.25, "mul_kernel"),          # dispatch B
        (2.9, 3.0, "copy_kernel"),          # the dispatch cut by the slice's end
    ]
    rows = [{"t0": 0.8, "t1": 1.1, "n_sets": 4}, {"t0": 1.15, "t1": 1.5, "n_sets": 4},
            {"t0": 1.9, "t1": 2.4, "n_sets": 4}, {"t0": 2.8, "t1": 3.2, "n_sets": 4}]
    return SimpleNamespace(trace=tr, dispatches=rows)


def test_glue_counts_whole_dispatches_only():
    assert readers.glue_ms(traced_run()) == pytest.approx((0.1 + 0.25) / 2 * 1e3)


def test_idle_share_of_the_slice():
    # busy: 1.0-1.05, 1.2-1.35, 2.0-2.25, 2.9-3.0 = 0.55 s of 2 s
    assert readers.idle_pct(traced_run()) == pytest.approx((1 - 0.55 / 2) * 100)


def test_nothing_to_read_gives_none():
    run = traced_run()
    run.dispatches = []
    assert readers.glue_ms(run) is None
    assert readers.glue_ms(SimpleNamespace(trace=None, dispatches=[])) is None
