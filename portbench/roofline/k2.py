"""K2, the fused SwiGLU (``fused_swiglu``): the gate and up int8 products
of one (M, K) activation and the CORDIC epilogue, float32 (M, F) out.

Operations count the two products; the epilogue's integer work is not
counted, so the share is that of the products' rate.
"""

from __future__ import annotations


def ops(m: int, k: int, f: int) -> float:
    return 4.0 * m * k * f


def nbytes(m: int, k: int, f: int) -> float:
    return m * k + 2 * k * f + 8 * f + 4 + 4 * m * f
