"""Device BLS12-381 stack in torch: fp -> fp2 -> tower -> curve / htc ->
pairing -> bls, over JAX's limb layout (``int32[..., 32]`` 12-bit limbs).

Every function works on the device its input tensors lie on. The three
field funnels (``fp.mul``, ``fp2.mul``, ``fp2.sq``) run the active engine
of their switch (``fp.set_impl``, ``fp2.set_impl``; the Miller-loop steps
``pairing.set_line_impl``). The defaults, ``pallas_int8``,
``fused_pallas`` and ``fused``, go to hand-written CUDA kernels on a
CUDA tensor and to their plain torch versions on a CPU tensor
(``kernels.py``); the composed engines are plain torch everywhere.
"""


def reset_compiled_state() -> None:
    """Drop every captured device program and the accounting keyed on it:
    the one call to make around an engine switch.

    * ``graphs.reset()``: every CUDA graph (each holds the engines it was
      captured under; its key names them, so none would replay under
      another engine, but its pool stays on the card until dropped);
    * ``bls.reset_recompile_tracking()``: the seen argument signatures
      (the next dispatches ARE fresh captures);
    * the compile service's warm-shape registry (when one is attached):
      rungs that would now capture must stop routing as warm, and the
      worker re-warms its plan under the active engines.
    """
    from ...compile_service import service as _csvc
    from . import bls as _bls
    from . import graphs as _graphs

    _graphs.reset()
    _bls.reset_recompile_tracking()
    _csvc.invalidate_registry()
