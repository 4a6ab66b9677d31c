"""Device-side G2 signature aggregation for the operation pool: the port
of the JAX package's ``operation_pool/device_agg.py``.

The pool's aggregation sites (greedy attestation merge on insert, sync
contribution assembly, block sync-aggregate assembly) are host-side
point-addition folds over ``AggregateSignature.add_assign``. With the
device MSM surface open (``crypto/device/msm.py``) those folds can run
as ONE masked point-sum on the card: :class:`DeviceAggregator`
batches the decoded G2 points, pads to the MSM ladder's warm rungs
(``compile_service.service.MSM_RUNGS``), and dispatches
``crypto/device/bls.py::device_sum_g2`` on its ``device`` (``cuda``
unless the caller asks for the CPU) — the same captured program the
compile service warms under the "msm" stage label, whose field products
are the K1-K3 kernels.

Strictly opt-in (``ClientConfig.device_msm``, default off) and strictly
a fast path: the aggregate is the same group element either way, and
serialization compresses the canonical affine point, so the flag-on
output is BYTE-IDENTICAL to the host fold (pinned by
``tests/test_torch_operation_pool.py`` on the CPU and
``tests/test_torch_kernels_cuda.py`` on the card). A batch below
``min_batch`` returns None and the caller's host fold serves (counted
``small``). A device failure is journaled either way; on a caller that
asked for the CPU it also returns None, so the host fold serves, counted
``op_pool_device_agg_total{outcome="fallback"}`` as in the JAX package,
while on the card it raises :class:`DeviceAggregationError`: the port
never serves a card's sum with the host fold.
"""

from __future__ import annotations

import time

from ..utils import flight_recorder, metrics, tracing

_AGG = metrics.counter_vec(
    "op_pool_device_agg_total",
    "operation-pool aggregate computations by path: ok = one device G2 "
    "point-sum served (dispatched under the bls stage label \"msm\"), "
    "fallback = the device path failed and the host add_assign fold "
    "served, small = batch below min_batch (host fold, device never "
    "tried)",
    ("outcome",),
)


class DeviceAggregationError(RuntimeError):
    """The G2 sum failed on the card (see the module docstring)."""


class DeviceAggregator:
    """Sums decoded G2 signature points on device (see module docstring).

    ``min_batch`` keeps tiny folds (the 2-point greedy attestation
    merge) on the host by default — a device round-trip per gossip
    insert would be pure overhead; sync-committee assembly over dozens
    to hundreds of messages is where the batched sum pays.
    """

    def __init__(self, min_batch: int = 2, device="cuda"):
        self.min_batch = max(1, int(min_batch))
        self.device = device

    @staticmethod
    def _pad_n(n: int):
        """Smallest warm MSM rung covering ``n``; None (= the generic
        ``_round_up`` pad) when ``n`` exceeds the ladder."""
        from ..compile_service.service import MSM_RUNGS

        for r in sorted(MSM_RUNGS):
            if r >= n:
                return r
        return None

    def aggregate(self, sigs):
        """Decoded ``bls.Signature`` list -> ``bls.AggregateSignature``
        via one device point-sum, or None when the host fold should
        serve (a small batch, or a failure on the CPU). Raises
        :class:`DeviceAggregationError` when the sum fails on the card."""
        from ..crypto import bls

        if len(sigs) < self.min_batch:
            _AGG.with_labels("small").inc()
            return None
        pad_n = self._pad_n(len(sigs))
        t0 = time.perf_counter()
        try:
            with tracing.span(
                "op_pool.device_agg", n_points=len(sigs), pad_n=pad_n
            ):
                pts = [s.point_or_infinity() for s in sigs]
                from ..crypto.device import bls as dbls

                out = dbls.device_sum_g2(pts, pad_n=pad_n, device=self.device)
        except Exception as e:
            import torch

            on_card = torch.device(self.device).type == "cuda"
            outcome = "error" if on_card else "fallback"
            flight_recorder.record(
                "op_pool_device_agg",
                outcome=outcome,
                n_points=len(sigs),
                pad_n=pad_n,
                wall_s=round(time.perf_counter() - t0, 6),
                error=str(e)[:200],
            )
            if on_card:
                raise DeviceAggregationError(
                    f"device G2 sum of {len(sigs)} points on "
                    f"{self.device} failed: {e}") from e
            _AGG.with_labels("fallback").inc()
            return None
        _AGG.with_labels("ok").inc()
        flight_recorder.record(
            "op_pool_device_agg",
            outcome="ok",
            n_points=len(sigs),
            pad_n=pad_n,
            wall_s=round(time.perf_counter() - t0, 6),
        )
        if out.is_infinity():
            # the canonical infinity encoding, exactly like the host
            # fold's untouched AggregateSignature.infinity()
            return bls.AggregateSignature.infinity()
        return bls.AggregateSignature(out)
