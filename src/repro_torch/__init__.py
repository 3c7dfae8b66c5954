"""PyTorch + CUDA port of the dynamic-precision math engine and the
serving stack built on it, for one NVIDIA H100.

Reference package: ``src/repro`` (JAX).  Every module here names the
reference file it ports; the port never imports ``jax`` or ``repro``.
Entry points run on the card (``device=None`` means ``"cuda"``) and
raise when there is none; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels, as the tests do.
"""

from repro_torch.compat import resolve_device

__all__ = ["resolve_device"]
