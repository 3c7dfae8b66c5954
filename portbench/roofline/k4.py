"""K4, flash attention (``flash_attention``) over one prompt: H query
heads over KV heads, causal, an optional window.

Operations are the two products, QK^T and PV, over the (query, key)
pairs the mask keeps; bytes read q, k and v once and write the output
once, in the element size of the rung (2 for bf16, 4 for f32).
"""

from __future__ import annotations

from typing import Optional


def pairs(s: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal mask keeps over s positions."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    w = window
    return w * (w + 1) // 2 + (s - w) * w


def ops(s: int, h: int, d: int, dv: int, window: Optional[int] = None) -> float:
    return 2.0 * h * pairs(s, window) * (d + dv)


def nbytes(s: int, h: int, kv: int, d: int, dv: int, esz: int) -> float:
    return esz * (s * h * (d + dv) + s * kv * (d + dv))
