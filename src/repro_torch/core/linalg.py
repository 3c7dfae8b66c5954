"""Fixed-point linear algebra with deferred-shift accumulation (paper
§3.3, §5.3; Listing 3).

Reference: ``src/repro/core/linalg.py``.

* ``qmatmul_deferred``    — the paper's kernel: products summed in 64
  bits over each K tile, ONE rounding shift per (output, K tile), tiles
  combined by a saturating int32 add.  On a CPU tensor it is the plain
  PyTorch version, on a CUDA tensor the hand-written kernel
  ``kernels/csrc/linalg.cu`` (``kernels.linalg``; torch has no integer
  matmul for int32 operands on the card), or it raises.
* ``qmatmul_per_element`` — the strawman: ``q_mul`` rounds after every
  product; int64 intermediates, int32 (wrapping) sum.  Plain torch, off
  the engine.
* ``matmul_float``        — the IEEE 754 path: an f32 ``torch.matmul``
  with TF32 off (``compat.py``), as XLA computes the reference's.
* ``derive_tile_size``    — paper Eq. 17 generalised (a copy).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.qformat import q_mul
from repro_torch.kernels.linalg import qmatmul_deferred

__all__ = [
    "matmul_float",
    "qmatmul_per_element",
    "qmatmul_deferred",
    "derive_tile_size",
]


def derive_tile_size(workspace_bytes: int, element_bytes: int = 4, align: int = 1) -> int:
    """Paper Eq. 17 generalised: largest b with ``3 * b**2 * bytes`` in
    the working set (A, B, C tiles), rounded down to a power of two and
    then to ``align``."""
    b = int(math.isqrt(workspace_bytes // (3 * element_bytes)))
    b = 1 << (b.bit_length() - 1) if b > 0 else 1
    if align > 1:
        b = max((b // align) * align, align)
    return b


def matmul_float(a, b) -> torch.Tensor:
    """IEEE 754 precise path (f32 in, f32 accumulate)."""
    a = torch.as_tensor(a)
    return torch.matmul(a.to(torch.float32), torch.as_tensor(b, device=a.device).to(torch.float32))


def qmatmul_per_element(a_q, b_q, *, frac_bits: int = 16, rounding: bool = True) -> torch.Tensor:
    """Strawman: rounds after every scalar multiply (the paper's 'b
    rounding events'), then sums the shifted Q products as int32 (the
    int64 sum's low word: a wrapping int32 sum)."""
    a_q = torch.as_tensor(a_q).to(torch.int32)
    b_q = torch.as_tensor(b_q, device=a_q.device).to(torch.int32)
    prods = q_mul(a_q[:, :, None], b_q[None, :, :], frac_bits=frac_bits, rounding=rounding)
    s = prods.to(torch.int64).sum(dim=1)
    return (((s + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)
