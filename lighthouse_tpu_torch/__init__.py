"""lighthouse_tpu_torch: the PyTorch/CUDA port of lighthouse_tpu's device
crypto, for an NVIDIA H100.

The first slice is BLS12-381 batch verification of signature sets
(``crypto.bls.verify_signature_sets``), with the three field funnels as
hand-written CUDA kernels (``crypto/device/kernels.py``,
``csrc/fp_kernels.cu``). The package imports ``torch`` and ``numpy`` and
never JAX or the ``lighthouse_tpu`` package: it keeps its own copies of
the host constants and oracles it needs.
"""
