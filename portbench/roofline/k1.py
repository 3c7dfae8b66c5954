"""K1, the int8 x int8 matmul with the ``float`` epilogue (``qmatmul``):
operations and bytes of one product, counted from its shape.

(M, K) int8 activations with one exponent, (K, N) int8 weights with one
exponent a column, (M, N) float32 out.  Only the M live rows count: a
decode tick's lanes that hold no request are left out.
"""

from __future__ import annotations


def ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def nbytes(m: int, k: int, n: int) -> float:
    return m * k + k * n + 4 * n + 4 + 4 * m * n
