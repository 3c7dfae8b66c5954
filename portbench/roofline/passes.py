"""The work a ``q16_16`` pass of a decoder needs, from the configuration's
numbers: the products each layer makes, and the model's operations by
the precision they run in.

These count the function, not the implementation: a pass over M live
rows needs, in every layer, the q, k, v and o projections (K1), then
either the gate / up products (K2) and the down projection (K1), or the
router and k experts a token (G2, G1); a prefill of S tokens also needs
attention over its S positions (K4, bf16 on this rung).  A decode step
attends in float32 and every pass's head is a float32 product.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.roofline import k1, k2, k4
from portbench.roofline.peaks import least_s


def attn_dims(spec: dict) -> Tuple[int, int, int, int]:
    return int(spec["d_model"]), int(spec["n_heads"]), int(spec["n_kv_heads"]), int(spec["head_dim"])


def dense_products(spec: dict) -> List[Tuple[str, int, int]]:
    """One layer's K1 / K2 products as (kernel, K, N): K2's N is the
    hidden width F."""
    d, h, kv, hd = attn_dims(spec)
    out = [("k1", d, h * hd), ("k1", d, kv * hd), ("k1", d, kv * hd), ("k1", h * hd, d)]
    if spec["layer"]["ffn"] == "mlp":
        out += [("k2", d, int(spec["d_ff"])), ("k1", int(spec["d_ff"]), d)]
    return out


def k1k2_least_s(spec: dict, m: int) -> float:
    """Least time of the K1 / K2 products of a pass over ``m`` live rows."""
    t = 0.0
    for kern, kk, n in dense_products(spec):
        if kern == "k1":
            t += least_s(k1.nbytes(m, kk, n), k1.ops(m, kk, n), "int8")
        else:
            t += least_s(k2.nbytes(m, kk, n), k2.ops(m, kk, n), "int8")
    return t * int(spec["n_layers"])


def k4_least_s(spec: dict, s: int) -> float:
    """Least time of the bf16 prefill attention over ``s`` positions."""
    _, h, kv, hd = attn_dims(spec)
    window = spec["layer"].get("window")
    one = least_s(k4.nbytes(s, h, kv, hd, hd, 2), k4.ops(s, h, hd, hd, window), "bf16")
    return one * int(spec["n_layers"])


def _matmul_params(spec: dict) -> Tuple[float, float]:
    """(int8 product weights a token meets in one layer, f32 router
    weights a token meets in one layer)."""
    d, h, kv, hd = attn_dims(spec)
    proj = d * h * hd * 2 + d * kv * hd * 2
    if spec["layer"]["ffn"] == "mlp":
        return float(proj + 3 * d * int(spec["d_ff"])), 0.0
    moe = spec["moe"]
    return (float(proj + int(moe["top_k"]) * 3 * d * int(spec["d_ff"])),
            float(d * int(moe["num_experts"])))


def prefill_ops(spec: dict, s: int) -> Dict[str, float]:
    """Model operations of one prefill of ``s`` tokens by precision."""
    d, h, _, hd = attn_dims(spec)
    L = int(spec["n_layers"])
    w8, wf = _matmul_params(spec)
    window = spec["layer"].get("window")
    return {"int8": 2.0 * s * w8 * L,
            "bf16": k4.ops(s, h, hd, hd, window) * L,
            "f32": 2.0 * s * wf * L + 2.0 * d * int(spec["vocab"])}


def decode_ops(spec: dict, pos: int) -> Dict[str, float]:
    """Model operations of one decode step of one lane at position
    ``pos`` (it attends over ``pos + 1`` keys) by precision."""
    d, h, _, hd = attn_dims(spec)
    L = int(spec["n_layers"])
    w8, wf = _matmul_params(spec)
    window = spec["layer"].get("window")
    keys = pos + 1 if window is None else min(pos + 1, int(window))
    return {"int8": 2.0 * w8 * L,
            "f32": (2.0 * wf + 4.0 * h * hd * keys) * L + 2.0 * d * int(spec["vocab"])}
