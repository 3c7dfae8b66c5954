"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built by
``nvcc`` for ``sm_90a`` and bound with ``ctypes``) with their plain
PyTorch versions beside them.  Reference: ``src/repro/kernels/`` (the
Pallas TPU kernels K1-K4 of the serving path; K5-K7 wait, see
ROADMAP.md queue 2)."""
