"""Compile service: ahead-of-time capture of the staged verifier's CUDA
graphs and warm-shape routing (see ``service.py``). ``CudaBackend`` pads
its batches to warm rungs through :meth:`CompileService.pads_for` when a
service is attached with :func:`set_service` and started."""

from .service import (
    DEFAULT_RUNGS,
    MSM_RUNGS,
    CompileService,
    WarmShapeRegistry,
    clear_service,
    get_active_service,
    get_service,
    invalidate_registry,
    set_msm_warm_enabled,
    set_service,
)

__all__ = [
    "DEFAULT_RUNGS",
    "MSM_RUNGS",
    "CompileService",
    "WarmShapeRegistry",
    "clear_service",
    "get_active_service",
    "get_service",
    "invalidate_registry",
    "set_msm_warm_enabled",
    "set_service",
]
