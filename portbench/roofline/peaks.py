"""The table of peaks of one NVIDIA H100 (SXM, NVIDIA's data sheet, dense
rates without sparsity) and the least time of a call.

Frozen with the benchmark: every roofline share and ``mfu`` is counted
against these numbers.  They assume the card's full power limit of
700 W; a run records the limit it found beside its numbers.
"""

from __future__ import annotations

#: HBM3 bandwidth, bytes a second
HBM_BYTES_S = 3.35e12

#: operations a second by the precision they run in
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def least_s(nbytes: float, ops: float, kind: str) -> float:
    """The least time the card could take for a call: the larger of its
    bytes over the bandwidth and its operations over the peak of
    ``kind``."""
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS[kind])


def bound_by(nbytes: float, ops: float, kind: str) -> str:
    """Which of the two terms of :func:`least_s` bounds the call."""
    return "bytes" if nbytes / HBM_BYTES_S >= ops / PEAK_OPS[kind] else "operations"
