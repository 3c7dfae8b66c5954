"""G2 and G1, the grouped expert entries (``fused_swiglu_grouped``,
``qmatmul_grouped``), from their routed shapes.

A call holds G experts of M rows each (the capacity times the batch
rows); ``live_rows`` of them carry tokens and ``live_experts`` experts
have any.  Operations count the live rows, weight bytes the live
experts, and every output row is written once (the kernels write the
dead rows as the zero accumulator's output).
"""

from __future__ import annotations


def g2_ops(live_rows: int, k: int, f: int) -> float:
    return 4.0 * live_rows * k * f


def g2_bytes(g: int, m: int, k: int, f: int, live_rows: int, live_experts: int) -> float:
    return live_experts * (2 * k * f + 8 * f) + live_rows * k + 4 * g * m * f + 4


def g1_ops(live_rows: int, k: int, n: int) -> float:
    return 2.0 * live_rows * k * n


def g1_bytes(g: int, m: int, k: int, n: int, live_rows: int, live_experts: int) -> float:
    return live_experts * (k * n + 4 * n) + live_rows * k + 4 * g * m * n + 4
