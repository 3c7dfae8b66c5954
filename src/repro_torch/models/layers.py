"""Shared layers: parameter specs, RMSNorm, SwiGLU MLP, rotary tables
and the precision-dispatched matmul ``pdot``.

Reference: ``src/repro/models/layers.py``.  The FAST (``q16_16``) rung
runs on the port's kernels:

* ``pdot`` FAST quantizes the activation ONCE per tensor (amax over the
  whole batch — the coupling ``decode_step``'s ``lane_mask`` exists for)
  and runs K1 (``kernels.qmatmul``) on the cached int8 weights;
* ``rope_tables`` FAST is the exact Q0.64 phase plus K3
  (``kernels.cordic.rope_sincos_q16``, both in one launch);
* ``swiglu_mlp`` FAST on cached weights is K2 (``kernels.fused_mlp``)
  followed by K1 for ``w_down``; without cached weights it is K1 for the
  gate and up products and ``psilu``;
* ``ptanh`` / ``psigmoid`` / ``psilu`` / ``softcap`` FAST run the Q16.16
  CORDIC ``tanh`` / ``sigmoid`` on K5 (``kernels.cordic.universal``).

Float casts sit where the reference has them: FAST ``pdot`` returns
bf16, the fused hidden stage is cast to bf16 before the down
projection.  The EXACT rung is float32 ``torch.matmul`` with TF32 off
(``compat``).

Training differentiates the FAST rung as the reference's ``custom_vjp``
rules do (``layers.py:132-297``): the K1 dot's backward is the
straight-through estimator in float (``gx = g w^T`` in f32, cast to x's
dtype; ``gw = x^T g``), K5's tanh and sigmoid take their analytic
derivatives ``g (1 - y^2)`` and ``g y (1 - y)`` from the saved output.
The autograd Functions (``kernels.qmatmul.DotFastSTE``,
:class:`CordicSTE`) are entered only when autograd records: a serving
pass runs the bare kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.compat import (gather_contraction, gather_inner, grad_layout, product_out,
                                replicated_like)
from repro_torch.core.qformat import Q16_16, from_fixed
from repro_torch.core.quantization import quantize_pow2
from repro_torch.kernels.cordic import rope_sincos_q16
from repro_torch.kernels.cordic.ops import unary_op
from repro_torch.kernels.fused_mlp import fused_swiglu
from repro_torch.kernels.qmatmul.ops import DotFastSTE, qmatmul_float
from repro_torch.kernels.qmatmul.ops import wq_parts as _wq_parts

__all__ = [
    "Spec",
    "init_from_specs",
    "rms_norm",
    "pdot",
    "dot_fast_int8",
    "CordicSTE",
    "FAST_MODES",
    "is_fast_mode",
    "snap_q8_8",
    "ptanh",
    "psigmoid",
    "psilu",
    "softcap",
    "rope_tables",
    "apply_rope",
    "swiglu_mlp",
    "mlp_specs",
    "attn_norm_spec",
    "WEIGHT_KEYS",
    "attach_quantized_weights",
    "no_constrain",
    "split_heads",
    "merge_heads",
]


def no_constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The models' default ``constrain`` hook: the identity.  The sharded
    cells (``launch.steps._make_constrain``) pass one that lays a
    ``residual``, ``heads4d``, ``moe4d`` or ``moe3d`` activation out on
    the mesh; on a plain tensor every hook returns its input."""
    return x


def split_heads(x: torch.Tensor, n: int, d: int, constrain=no_constrain) -> torch.Tensor:
    """(..., n*d) -> (..., n, d).  The hook sees the flat axis first as
    kind ``("heads3d", n)``: a sharded cell cannot split a sharded axis
    into ``n`` heads unless its mesh divides ``n`` (the port's own layout
    point; GSPMD reshards there unasked)."""
    return constrain(x, ("heads3d", n)).reshape(*x.shape[:-1], n, d)


def merge_heads(x: torch.Tensor, constrain=no_constrain) -> torch.Tensor:
    """(..., n, d) -> (..., n*d), :func:`split_heads` undone; in a sharded
    cell the gradient meets the hook as kind ``("heads3d", n)`` before it
    splits back into the heads."""
    n = x.shape[-2]
    y = x.reshape(*x.shape[:-2], n * x.shape[-1])
    return grad_layout(y, lambda g: constrain(g, ("heads3d", n)))


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter: shape, logical axes and init law."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"       # 'normal' | 'zeros' | 'ones' | 'uniform'
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def initializer(self, gen: torch.Generator, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        if self.init == "uniform":
            u = torch.rand(self.shape, generator=gen, dtype=self.dtype, device=device)
            return u.mul_(2 * scale).sub_(scale)
        return torch.randn(self.shape, generator=gen, dtype=self.dtype, device=device).mul_(scale)


def init_from_specs(specs, gen: torch.Generator, device):
    """Materialize a dict tree of Specs, drawing leaves in sorted-key
    order from ``gen`` (a generator on ``device``)."""
    if isinstance(specs, Spec):
        return specs.initializer(gen, device)
    return {k: init_from_specs(specs[k], gen, device) for k in sorted(specs)}


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

FAST_MODES = ("fast", "fast8")


def is_fast_mode(mode: str) -> bool:
    return mode in FAST_MODES


def snap_q8_8(x: torch.Tensor) -> torch.Tensor:
    """Round onto the Q8.8 grid (the q8_8 draft rung's activations)."""
    xf = torch.clamp(torch.round(x.to(torch.float32) * 256.0), -32768.0, 32767.0)
    return (xf * (1.0 / 256.0)).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 accumulation (stays on the float path in FAST)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(torch.float32))).to(x.dtype)


def _records(*ts: torch.Tensor) -> bool:
    """True when autograd records an op on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def dot_fast_int8(x: torch.Tensor, w: torch.Tensor, wq=None) -> torch.Tensor:
    """W8A8 matmul through K1: x quantized per tensor, weights per output
    channel (pre-quantized ``wq`` when given), ONE deferred rescale.
    Returns f32 of shape ``x.shape[:-1] + (N,)``; differentiable by the
    straight-through estimator (``kernels.qmatmul.DotFastSTE``)."""
    if _records(x, w):
        return DotFastSTE.apply(x, w, wq)
    return qmatmul_float(x, w, wq)


def pdot(x: torch.Tensor, w: torch.Tensor, mode: str = "precise", wq=None) -> torch.Tensor:
    """𝒟[matmul]: FAST -> K1 W8A8 (bf16 out); EXACT -> f32 matmul;
    PRECISE -> bf16 matmul.  A DTensor ``x`` has its inner dimensions
    gathered first, and so has the product's gradient, and ``w`` its
    contraction shards (``compat.gather_inner``, ``product_out``,
    ``gather_contraction``; K1 gathers its int8 operand itself)."""
    x = gather_inner(x)
    if is_fast_mode(mode):
        if mode == "fast8":
            x = snap_q8_8(x)
        return product_out(dot_fast_int8(x, w, wq=wq)).to(torch.bfloat16)
    dt = torch.float32 if mode == "exact" else torch.bfloat16
    return product_out(torch.matmul(x.to(dt), gather_contraction(x, w.to(dt))))


# ---------------------------------------------------------------------------
# precision-dispatched activations
# ---------------------------------------------------------------------------


class CordicSTE(torch.autograd.Function):
    """The reference's ``_tanh_fast`` / ``_sigmoid_fast``: the Q16.16
    CORDIC ``op`` on K5 forward, the analytic derivative from the saved
    output backward: ``g (1 - y^2)`` for tanh, ``g y (1 - y)`` for
    sigmoid."""

    @staticmethod
    def forward(ctx, x, op):
        y = unary_op(x, op)
        ctx.save_for_backward(y)
        ctx.op = op
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return (g * (1.0 - y * y) if ctx.op == "tanh" else g * y * (1.0 - y)), None


def _cordic(x: torch.Tensor, op: str) -> torch.Tensor:
    return CordicSTE.apply(x, op) if _records(x) else unary_op(x, op)


def ptanh(x: torch.Tensor, mode: str = "precise") -> torch.Tensor:
    """𝒟[tanh]: FAST -> Q16.16 CORDIC through K5 (analytic STE
    backward); otherwise IEEE-754.  Inputs are expected in f32."""
    if is_fast_mode(mode):
        return _cordic(x, "tanh")
    return torch.tanh(x)


def psigmoid(x: torch.Tensor, mode: str = "precise") -> torch.Tensor:
    """𝒟[sigmoid]: FAST -> Q16.16 CORDIC through K5 (analytic STE
    backward)."""
    if is_fast_mode(mode):
        return _cordic(x, "sigmoid")
    return torch.sigmoid(x)


def psilu(x: torch.Tensor, mode: str = "precise") -> torch.Tensor:
    """𝒟[silu]: x * sigmoid(x) with the sigmoid precision-dispatched; the
    product rule composes with the sigmoid's STE under autograd."""
    if is_fast_mode(mode):
        return x * _cordic(x, "sigmoid")
    return torch.nn.functional.silu(x)


def softcap(x: torch.Tensor, cap: Optional[float], mode: str = "precise") -> torch.Tensor:
    """Gemma-2 logit soft-capping ``cap * tanh(x / cap)`` in f32, with the
    tanh precision-dispatched (attention-score capping stays PRECISE by
    the reference's policy: ``kernels.flashattn`` and
    ``attention.decode_attention`` cap in f32)."""
    if cap is None:
        return x
    return (cap * ptanh(x.to(torch.float32) / cap, mode)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, rope_dim: int, base: float = 10000.0,
                mode: str = "precise"):
    """(…) int positions -> (…, rope_dim//2) f32 sin/cos tables.

    FAST: exact Q0.64 phase + 16-iteration CORDIC through K3.
    Otherwise: f32 ``sin``/``cos`` of ``pos * inv_freq``."""
    half = rope_dim // 2
    if is_fast_mode(mode):
        sin_q, cos_q = rope_sincos_q16(positions.to(torch.int32).contiguous(), rope_dim, base)
        return from_fixed(sin_q, Q16_16), from_fixed(cos_q, Q16_16)
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv_freq = replicated_like(positions, base ** (-2.0 * ar / rope_dim))
    angle = positions[..., None].to(torch.float32) * inv_freq
    return torch.sin(angle), torch.cos(angle)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (…, S, H, D); sin/cos (…, S, D//2) broadcast over heads;
    half-split (llama) convention, computed in f32, cast back."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(d_model: int, d_ff: int) -> dict:
    return {
        "norm": Spec((d_model,), ("embed",), init="zeros"),
        "w_gate": Spec((d_model, d_ff), ("embed", "mlp")),
        "w_up": Spec((d_model, d_ff), ("embed", "mlp")),
        "w_down": Spec((d_ff, d_model), ("mlp", "embed")),
    }


def attn_norm_spec(d_model: int) -> Spec:
    return Spec((d_model,), ("embed",), init="zeros")


def _fused_swiglu_fast(h: torch.Tensor, wgq, wuq) -> torch.Tensor:
    """One activation quantization feeding K2 on the cached int8 gate
    and up weights; f32 ``silu(h@Wg) * (h@Wu)``."""
    gq, ge = _wq_parts(wgq)
    uq, ue = _wq_parts(wuq)
    xq = quantize_pow2(h, bits=8, axis=None)
    K, F = gq.shape
    out = fused_swiglu(xq.q.reshape(-1, K), gq, uq, xq.exp, ge.reshape(-1), ue.reshape(-1))
    return out.reshape(*h.shape[:-1], F)


def swiglu_mlp(params: dict, x: torch.Tensor, mode: str = "precise", eps: float = 1e-5):
    """SwiGLU MLP with the per-op dispatch: FAST on cached weights is
    K2 then K1; otherwise three ``pdot`` products around ``psilu`` (FAST:
    K1 and the CORDIC sigmoid on K5)."""
    h = gather_inner(rms_norm(x, params["norm"], eps))
    if is_fast_mode(mode) and "w_gate_q" in params:
        if mode == "fast8":
            h = snap_q8_8(h)
        act = _fused_swiglu_fast(h, params["w_gate_q"], params["w_up_q"]).to(torch.bfloat16)
        return pdot(act, params["w_down"], mode, wq=params["w_down_q"])
    gate = pdot(h, params["w_gate"], mode)
    up = pdot(h, params["w_up"], mode)
    act = psilu(gate.to(torch.float32), mode).to(up.dtype) * up
    return pdot(act, params["w_down"], mode)


# ---------------------------------------------------------------------------
# quantize-once weight attachment (serving FAST path)
# ---------------------------------------------------------------------------

WEIGHT_KEYS = frozenset({
    "w_gate", "w_up", "w_down",
    "wq", "wk", "wv", "wo",
    "wq_a", "wq_b", "wkv_a",
    "wz", "wx", "wB", "wC", "wdt",
})


def attach_quantized_weights(params: dict, cache, *, level: str = "q16_16") -> dict:
    """``params`` with ``<key>_q = {"q": int8, "exp": int32}`` next to
    every :data:`WEIGHT_KEYS` matrix, quantized ONCE through ``cache``
    with one exponent per everything-but-the-contraction axis (per
    period and output channel for the stacked weights)."""
    def walk(node, path):
        if isinstance(node, dict):
            out = {k: walk(v, f"{path}/{k}") for k, v in node.items()}
            for k in sorted(WEIGHT_KEYS & node.keys()):
                w = node[k]
                if not isinstance(w, torch.Tensor) or w.ndim < 2:
                    continue
                axis = tuple(i for i in range(w.ndim) if i != w.ndim - 2)
                qt = cache.get(f"{path}/{k}", w, level=level, axis=axis)
                out[k + "_q"] = {"q": qt.q, "exp": qt.exp}
            return out
        return node

    return walk(params, "")
