"""Mixture-of-Experts with sort-based capacity dispatch.

Reference: ``src/repro/models/moe.py`` — ``moe_specs``, ``_capacity``,
``_fused_expert_mlp`` and ``moe_forward``.  Routing is batch-local, as
there: per batch row, top-k over the f32 router softmax (renormalised),
a stable sort of the (token, pick) pairs by expert, position in expert
from the sorted order, tokens past the capacity
``C = max(8, ceil8(S k / E * capacity_factor))`` dropped, a gather into
``(B, E, C, d)``, the experts' SwiGLU with every expert weight read once,
and the gated combine.

The places where bits would differ from the reference unless handled:

* **top-k ties.**  ``jax.lax.top_k`` returns the lower expert first on
  equal probabilities (a row whose normed input is zero routes on a
  uniform softmax: masked lanes are one case, and on the FAST rung the
  experts they pick move every lane's per-tensor exponent).  ``torch.
  topk`` promises no order, so the port takes the first k of a STABLE
  descending sort;
* **dispatch.**  ``argsort(stable=True)`` as in the reference; the
  dropping scatter of token ids writes dropped picks to a sink column
  ``E*C`` that is never read (torch has no dropping scatter);
* **combine.**  The reference adds a token's k contributions with
  ``.at[token].add`` in the sorted (expert-major) order, into f32 zeros.
  ``index_add_`` on the card adds with atomics in no fixed order, so the
  port gathers each token's k contributions and sums them from 0 in
  ascending expert order (a token's experts are distinct, so that is the
  sorted order), deterministic on every device;
* **rungs.**  The expert dtype is f32 on ``exact`` and bf16 otherwise,
  the FAST output included (the reference casts ``_fused_expert_mlp``'s
  f32 output to it); ``fast8`` snaps the gathered tokens to Q8.8 first.

FAST on cached int8 expert weights (``w_gate_q`` present) is
:func:`_fused_expert_mlp`: two grouped launches a layer, K2's grouped
entry for the gate / up products with the CORDIC ``swiglu_body_q16``
epilogue and K1's grouped entry for the down projection, the expert as
the launch's group.  Both take the dispatch's live rows, ``counts``
clipped at C as (E, B) int32: the kernels read them on the device and
skip the padding rows and the experts no token picked (their rows are
zeros, so their outputs are the zero accumulator's, which the kernels
write without computing them: the same bits).  The per-tensor
quantizations of the gathered tokens and of the hidden activation stay
plain torch, as the dense path's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compat import gather_inner
from repro_torch.core.quantization import quantize_pow2
from repro_torch.kernels.fused_mlp import fused_swiglu_grouped
from repro_torch.kernels.qmatmul import qmatmul_grouped
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Spec,
    attn_norm_spec,
    is_fast_mode,
    no_constrain,
    psilu,
    rms_norm,
    snap_q8_8,
)

__all__ = ["moe_specs", "moe_forward", "top_k_stable"]


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "norm": attn_norm_spec(d),
        "router": Spec((d, E), ("embed", None), scale=0.02),
        "w_gate": Spec((E, d, f), ("expert", "embed", "mlp")),
        "w_up": Spec((E, d, f), ("expert", "embed", "mlp")),
        "w_down": Spec((E, f, d), ("expert", "mlp", "embed")),
    }


def _capacity(T: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(T * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _fused_expert_mlp(params: dict, xe: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Fused FAST expert SwiGLU on cached int8 weights (the serving
    path): ``xe`` (B, E, C, d) -> (B, E, C, d) f32; ``rows`` (E, B) int32:
    the live rows of each expert's C in each batch row.

    The gathered tokens are quantized ONCE per layer (per tensor), laid
    out as a contiguous (E, B*C, d), and run through K2's grouped entry
    (gate and up int8 products, per-(expert, channel) exponents, the
    CORDIC sigmoid on the Q16.16 gate) and, after one per-tensor
    quantization of the hidden activation, K1's grouped entry with the
    ``float`` epilogue (``acc * 2**(e_a + e_d)``, an exact power of two:
    the reference's XLA ``exp2`` is a few ulp off on the CPU)."""
    gq, ge = params["w_gate_q"]["q"], params["w_gate_q"]["exp"]   # (E,d,f), (E,1,f)
    uq, ue = params["w_up_q"]["q"], params["w_up_q"]["exp"]
    dq, de = params["w_down_q"]["q"], params["w_down_q"]["exp"]   # (E,f,d), (E,1,d)
    B, E, C, d = xe.shape
    f = gq.shape[-1]

    xq = quantize_pow2(xe, bits=8, axis=None)
    x_g = xq.q.transpose(0, 1).reshape(E, B * C, d).contiguous()
    act = fused_swiglu_grouped(x_g, gq, uq, xq.exp, ge.reshape(E, f), ue.reshape(E, f),
                               rows=rows)
    aq = quantize_pow2(act, bits=8, axis=None)
    ye = qmatmul_grouped(aq.q, dq, aq.exp, de.reshape(E, d), "float", rows=rows)
    return ye.reshape(E, B, C, d).transpose(0, 1)


def moe_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, mode: str = "precise", *,
                aux: bool = True, constrain=no_constrain) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux losses (2,) f32:
    load balance and router z).  ``aux=False`` (serving, which reads no
    loss) skips the losses' reductions and returns None for them: eager
    torch, unlike the reference's jit, would run them as dead code."""
    B, S, d = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    dev = x.device
    h = gather_inner(rms_norm(x, params["norm"], cfg.rms_eps))                  # (B,S,d)
    N = S * k
    C = _capacity(S, cfg)

    logits = torch.matmul(h.to(torch.float32), params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                         # (B,S,E)
    gate_vals, idx = top_k_stable(probs, k)                       # (B,S,k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # ---- sort-based dispatch, per batch row ---------------------------------
    flat_e = idx.reshape(B, N)
    order = torch.argsort(flat_e, dim=-1, stable=True)           # token order kept
    sorted_e = flat_e.gather(-1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))                       # (B,E)
    seg_start = torch.cumsum(counts, dim=-1) - counts             # exclusive
    pos_in_e = torch.arange(N, device=dev)[None, :] - seg_start.gather(-1, sorted_e)
    keep = pos_in_e < C
    slot = sorted_e * C + pos_in_e                                # (B,N) in [0, E*C) if kept
    token = order // k                                            # source position

    # token id per expert row; dropped picks go to the sink column E*C,
    # empty rows keep the sentinel S (the zero row appended to h)
    idx_buf = torch.full((B, E * C + 1), S, dtype=torch.int64, device=dev)
    idx_buf.scatter_(1, torch.where(keep, slot, E * C), token)
    lanes = torch.arange(B, device=dev)[:, None]
    h_pad = torch.cat([h, torch.zeros((B, 1, d), dtype=h.dtype, device=dev)], dim=1)
    xe = h_pad[lanes, idx_buf[:, :E * C]].reshape(B, E, C, d)    # GATHER
    xe = constrain(xe, "moe4d")

    # ---- the experts' SwiGLU: weights read once per layer -------------------
    dt = torch.float32 if mode == "exact" else torch.bfloat16
    if is_fast_mode(mode) and "w_gate_q" in params:
        if mode == "fast8":
            xe = snap_q8_8(xe)
        rows = counts.clamp(max=C).t().to(torch.int32, memory_format=torch.contiguous_format)
        ye = constrain(_fused_expert_mlp(params, xe, rows).to(dt), "moe4d")
    else:
        gate = torch.einsum("becd,edf->becf", xe.to(dt), params["w_gate"].to(dt))
        up = torch.einsum("becd,edf->becf", xe.to(dt), params["w_up"].to(dt))
        act = psilu(gate.to(torch.float32), mode).to(dt) * up
        ye = constrain(torch.einsum("becf,efd->becd", act, params["w_down"].to(dt)), "moe4d")

    # ---- combine: each token's k picks in ascending expert order -----------
    gate_sorted = gate_vals.reshape(B, N).gather(-1, order)
    picked = ye.reshape(B, E * C, d)[lanes, torch.where(keep, slot, 0)]       # (B,N,d)
    contrib = constrain(picked * (gate_sorted * keep).to(picked.dtype)[..., None], "moe3d")
    # sorted position of each (token, pick) pair; a token's picks in
    # sorted order are its picks in ascending expert order
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(N, device=dev).expand(B, N))
    rank = rank.reshape(B, S, k).sort(dim=-1).values
    by_token = contrib[lanes[:, :, None], rank].to(torch.float32)            # (B,S,k,d)
    y = torch.zeros((B, S, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + by_token[:, :, j]
    y = constrain(y, "residual")

    if not aux:
        return y.to(x.dtype), None
    # ---- aux losses -----------------------------------------------------------
    frac_tokens = counts.to(torch.float32).mean(dim=0) / N * k
    frac_prob = probs.mean(dim=(0, 1))
    lb = E * torch.sum(frac_tokens * frac_prob) / k
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y.to(x.dtype), torch.stack([lb, z])
