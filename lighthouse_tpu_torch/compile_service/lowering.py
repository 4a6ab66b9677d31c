"""The staged programs' argument shapes at a rung, and the warm-up of
each: the port of the JAX package's ``compile_service/lowering.py``.

ONE definition of what the verifier dispatches at bucket rung (B, K, M)
(:func:`staged_dummy_args`, :func:`staged_captured`), shared by the
compile service's warm-up and the tests. Every warm-up dispatches through
``bls._run_stage``, so the stage graphs it captures are the ones traffic
replays and a warmed rung is not fresh for the first real batch.

A ``shard`` (a mesh shard index) scopes a warm-up to that shard
(:func:`_shard_scope`): its dummy arguments land on the shard's device
and the dispatch runs in the shard's scope, so the graphs are captured
on that device and the seen-shape accounting is the shard's. Shards that
share a card share its graphs: a second shard's warm-up replays them.

Every warm-up runs in ``bls.warming()``: the stage histogram and the
recompile counter see its dispatches as the JAX package's see its
warm-up, but the pipeline profiler records them as ``compile`` activity
and not as busy time on the shard (a capture occupies the card, yet it
is not traffic).

The JAX module's ``hlo_instruction_count``, ``timed_lower_compile`` and
``staged_instruction_counts`` measure XLA programs. Their counterpart
here is each captured graph's node count, in ``graphs.status()``.
"""

from __future__ import annotations

import contextlib

import torch

from ..crypto.device import bls as dbls
from ..crypto.device import fp
from ..crypto.device import mesh as mesh_mod

STAGES = ("stage1", "stage2", "stage3")


class StageWarmupError(RuntimeError):
    """One stage of a rung's warm-up failed. Carries which stage raised
    and the records of the stages that had already succeeded."""

    def __init__(self, stage: str, partial: dict, cause: BaseException):
        super().__init__(f"{stage}: {cause!r}")
        self.stage = stage
        self.partial = partial
        self.__cause__ = cause


def staged_dummy_args(B: int, K: int, M: int, device="cuda") -> dict:
    """Zero tensors on ``device`` with exactly the (shape, dtype) of each
    stage's arguments at rung (B, K, M): the keys of its graphs."""
    i32, b8 = torch.int32, torch.bool

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "stage1": (
            z(B, 2, fp.NL),             # sig_x
            z(B, dtype=b8),             # sig_larger
            z(M, 2, 2, fp.NL),          # msg_u
        ),
        "stage2": (
            z(B, K, 2, fp.NL),          # pk_xy
            z(B, K, dtype=b8),          # pk_mask
            z(B, 2, 2, fp.NL),          # sig_xy
            z(B, 2),                    # rand
            z(B, dtype=b8),             # set_mask
        ),
        "stage3": (
            z(B, fp.NL),                # pk_x
            z(B, fp.NL),                # pk_y
            z(B, dtype=b8),             # pk_inf
            z(B, 2, fp.NL),             # msg_aff_x
            z(B, 2, fp.NL),             # msg_aff_y
            z(B, dtype=b8),             # msg_aff_inf
            z(2, fp.NL),                # acc_x
            z(2, fp.NL),                # acc_y
            z(dtype=b8),                # acc_inf
        ),
    }


def staged_captured() -> dict:
    """The module-level captured stage programs the verifier dispatches
    (the counterpart of ``staged_jitted``): warming these is what fills
    the graph cache real traffic replays."""
    return {"stage1": dbls._stage1, "stage2": dbls._stage2, "stage3": dbls._stage3}


@contextlib.contextmanager
def _shard_scope(shard):
    """The scope a warm-up runs under: ``bls.warming()``, inside
    ``mesh.dispatch_to`` for a mesh shard (the thread-local shard and, for
    a CUDA shard, its device; nothing more without a mesh or a shard)."""
    if shard is None or mesh_mod.get_active_mesh() is None:
        scope = contextlib.nullcontext()
    else:
        scope = mesh_mod.dispatch_to(int(shard))
    with scope, dbls.warming():
        yield


def warm_staged(B: int, K: int, M: int, device="cuda", shard=None) -> dict:
    """Capture the three stage graphs at rung (B, K, M) on ``device`` (on
    ``shard``'s device, in its scope, when a mesh shard is given) by
    dispatching each captured program on zero arguments through
    ``bls._run_stage``. On the CPU nothing is captured: the stages run
    once eagerly. No lock is held across the rung: each stage's capture
    takes the device's capture lock for that stage alone
    (``graphs.CapturedProgram``), and other threads replay warm graphs
    meanwhile. Returns ``{stage: {seconds, fresh}}``."""
    out = {}
    with _shard_scope(shard):
        args = staged_dummy_args(B, K, M, mesh_mod.device_of(shard, device))
        progs = staged_captured()
        for stage in STAGES:
            try:
                _, elapsed, fresh = dbls._run_stage(stage, progs[stage], *args[stage])
            except Exception as e:
                raise StageWarmupError(stage, out, e)
            out[stage] = {"seconds": elapsed, "fresh": fresh}
    return out


def warm_gather(B: int, K: int, table, shard=None) -> dict:
    """Run the key table's gather once at rung (B, K) against ``table``'s
    current tensors (``shard``'s replica when a mesh shard is given),
    through ``bls._run_stage`` under the stage label "gather". The gather
    stays eager (``bls.verify_batch_raw_staged_gather`` says why), so this
    captures nothing: it records the shape as seen."""
    with _shard_scope(shard):
        dev, agg = table.device_arrays()
        if dev is None:
            raise StageWarmupError("gather", {},
                                   RuntimeError("key table has no device rows"))
        idx = torch.zeros((B, K), dtype=torch.int32, device=dev.device)
        try:
            _, elapsed, fresh = dbls._run_stage("gather", dbls._gather_fn, dev, agg, idx)
        except Exception as e:
            raise StageWarmupError("gather", {}, e)
    return {"seconds": elapsed, "fresh": fresh}


def warm_msm(n: int, device="cuda", shard=None) -> dict:
    """Capture the G1 MSM and the G2 sum graphs at point-count rung ``n``
    (on ``shard``'s device, in its scope, when a mesh shard is given)
    through ``bls._run_stage`` under the shared stage label "msm" (their
    argument shapes differ, so each has its own graph)."""
    with _shard_scope(shard):
        return _warm_msm(n, mesh_mod.device_of(shard, device))


def _warm_msm(n: int, device) -> dict:
    seconds, fresh = 0.0, False
    g1_args = (
        torch.zeros((n, 2, fp.NL), dtype=torch.int32, device=device),     # pt_xy
        torch.ones((n,), dtype=torch.bool, device=device),                # pt_inf
        torch.zeros((n, 2), dtype=torch.int32, device=device),            # scalars
    )
    g2_args = (
        torch.zeros((n, 2, 2, fp.NL), dtype=torch.int32, device=device),  # pt_xy
        torch.ones((n,), dtype=torch.bool, device=device),                # pt_inf
    )
    for prog, args in ((dbls._msm, g1_args), (dbls._g2sum, g2_args)):
        try:
            _, elapsed, was_fresh = dbls._run_stage("msm", prog, *args)
        except Exception as e:
            raise StageWarmupError("msm", {}, e)
        seconds += elapsed
        fresh = fresh or was_fresh
    return {"seconds": seconds, "fresh": fresh}
