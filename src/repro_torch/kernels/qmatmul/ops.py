"""Float-boundary ops over K1, and their straight-through gradient.

Reference: ``src/repro/kernels/qmatmul/ops.py`` — ``qmatmul`` (float in,
float out: the activation quantized per tensor, the weight per output
channel, the int8 product and one deferred power-of-two rescale), here
:func:`qmatmul_float`, which also takes the FAST rung's pre-quantized
weights and activations of any leading shape (the reference's
``models/layers.py::_dot_fast`` / ``_dot_fast_cached``); and
``qdot_ste``, its straight-through differentiable form.
:class:`DotFastSTE` is the one autograd Function of both
(``layers.py:217-297``, ``ops.py:80-98``): the forward on K1 (its plain
version on a CPU tensor), the backward the float products ``gx = g w^T``
(f32, cast to x's dtype) and ``gw = x^T g`` (in w's dtype), computed
outside the kernel as the reference's ``custom_vjp`` rules do.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import quantize_pow2
from repro_torch.kernels.qmatmul.qmatmul import qmatmul

__all__ = ["qmatmul_float", "qdot_ste", "DotFastSTE"]


def wq_parts(wq):
    """(int8 payload, exponents) of a pre-quantized weight: a QTensor or
    the ``{"q", "exp"}`` dict attached to parameter trees."""
    if isinstance(wq, dict):
        return wq["q"], wq["exp"]
    return wq.q, wq.exp


def qmatmul_float(x: torch.Tensor, w: torch.Tensor, wq=None) -> torch.Tensor:
    """float (..., K) x (K, N) -> float32 (..., N) through K1 (W8A8): x
    quantized per tensor, w per output channel (``wq`` when given)."""
    q, e = wq_parts(quantize_pow2(w, bits=8, axis=w.ndim - 1) if wq is None else wq)
    xq = quantize_pow2(x, bits=8, axis=None)
    K, N = q.shape
    out = qmatmul(xq.q.reshape(-1, K), q, xq.exp, e.reshape(-1), "float")
    return out.reshape(*x.shape[:-1], N)


class DotFastSTE(torch.autograd.Function):
    """:func:`qmatmul_float` forward, straight-through float backward."""

    @staticmethod
    def forward(ctx, x, w, wq=None):
        ctx.save_for_backward(x, w)
        return qmatmul_float(x, w, wq)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        gx = torch.matmul(g, w.to(torch.float32).T).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        gw = torch.matmul(x2.T, g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw, None


def qdot_ste(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quantized forward / float backward on (M,K) x (K,N) operands."""
    return DotFastSTE.apply(a, b)
