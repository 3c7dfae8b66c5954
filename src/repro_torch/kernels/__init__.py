"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built by
``nvcc`` for ``sm_90a`` and bound with ``ctypes``) with their plain
PyTorch versions beside them.  Reference: ``src/repro/kernels/`` — every
Pallas TPU kernel there has its counterpart here (K1 ``qmatmul``, K2
``fused_mlp``, K3 and K5-K7 ``cordic``, K4 ``flashattn``).  ``linalg``
holds the engine's deferred-correction matmul (C3), plain JAX in the
reference, which torch cannot compute on the card without a kernel."""
