"""Device BLS12-381 stack in torch: fp -> fp2 -> tower -> curve / htc ->
pairing -> bls, over JAX's limb layout (``int32[..., 32]`` 12-bit limbs).

Every function works on the device its input tensors lie on. The three
field funnels (``fp.mul``, ``fp2.mul``, ``fp2.sq``) go to hand-written
CUDA kernels on a CUDA tensor and to their plain torch versions on a CPU
tensor (``kernels.py``).
"""
