"""Power-of-two Q-format tensor quantization and the quantize-once
weight cache of the FAST path.

Reference: ``src/repro/core/quantization.py``.  Every scale is a power
of two, so a quantized tensor is ``q * 2**exp`` with an int32 exponent
per channel (or per tensor) and the rescale after an int8 product stays
one exact shift.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional, Tuple, Union

import torch

__all__ = [
    "QTensor",
    "quantize_pow2",
    "pow2_exponent",
    "dequantize_pow2",
    "quantize_q16",
    "compress_with_feedback",
    "QuantizedWeightCache",
]

#: channel spec: None (per-tensor), one axis, or a tuple of kept axes
Axis = Union[None, int, Tuple[int, ...]]


class QTensor(NamedTuple):
    """``value ~= q * 2.0**exp`` (exponents broadcast against ``q``)."""

    q: torch.Tensor
    exp: torch.Tensor
    axis: Axis = None

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def shape(self):
        return self.q.shape


_STORAGE = {8: torch.int8, 16: torch.int16, 32: torch.int32}


@functools.lru_cache(maxsize=None)
def _ln2(device: torch.device) -> torch.Tensor:
    """f32 ``log(2)`` as a tensor on ``device``: dividing by a tensor
    stays a true division on the card, where a Python-scalar divisor
    becomes a multiply by its reciprocal."""
    return torch.log(torch.tensor(2.0, dtype=torch.float32)).to(device)


def pow2_exponent(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """int32 ``ceil(log2(amax)) - (bits-1)`` in the reference's f32 form
    (``jnp.log2`` is ``log(x) / log(2)``), 0 where ``amax == 0``: the
    shared power-of-two exponent of :func:`quantize_pow2` and of the
    compressed gradient mean (``optim.grad_compress``)."""
    safe = torch.clamp_min(amax, 1e-30)
    e = torch.ceil(torch.log(safe) / _ln2(safe.device)).to(torch.int32) - (bits - 1)
    return torch.where(amax > 0, e, torch.zeros_like(e))


def quantize_pow2(x: torch.Tensor, bits: int = 8, axis: Axis = None) -> QTensor:
    """Quantize to a power-of-two-scaled integer grid.

    The exponent is ``ceil(log2(amax)) - (bits-1)`` per channel (per
    tensor for ``axis=None``), computed in float32 exactly as the
    reference does: ``jnp.log2`` is ``log(x) / log(2)`` in f32, which
    just above a power of two rounds back to the integer (a correctly
    rounded ``torch.log2`` would not), and the payload then clips to
    ``2**(bits-1) - 1``.  ``amax == 0`` gives exponent 0.  The payload
    rounds half to even.  ``axis`` may be a tuple of KEPT axes.
    """
    x = x.to(torch.float32)
    if axis is None:
        amax = x.abs().amax()
    else:
        keep = {a % x.ndim for a in (axis if isinstance(axis, tuple) else (axis,))}
        reduce_axes = tuple(i for i in range(x.ndim) if i not in keep)
        amax = x.abs().amax(dim=reduce_axes, keepdim=True) if reduce_axes else x.abs()
    e = pow2_exponent(amax, bits)
    scale = torch.exp2(-e.to(torch.float32))  # 2**-e, exact for |e| < 127
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x * scale), -qmax - 1, qmax).to(_STORAGE[bits])
    return QTensor(q=q, exp=e, axis=axis)


def dequantize_pow2(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Exact shift-only dequantization: ``q * 2.0**exp``."""
    return qt.q.to(dtype) * torch.exp2(qt.exp.to(dtype))


def quantize_q16(x: torch.Tensor) -> QTensor:
    """Fixed global Q16.16 (the paper's format) as a QTensor: the raw
    int32 words of ``to_fixed`` with exponent -16 (reference
    ``core/quantization.py:93``)."""
    from repro_torch.core.qformat import Q16_16, to_fixed

    q = to_fixed(x, Q16_16)
    return QTensor(q=q, exp=torch.tensor(-16, dtype=torch.int32, device=q.device), axis=None)


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor,
                           bits: int = 8) -> Tuple[QTensor, torch.Tensor]:
    """Error-feedback Q-format gradient compression (reference
    ``core/quantization.py:102``): quantize ``grad + residual`` to
    ``bits`` with one power-of-two scale for the tensor and return the
    new residual, the quantization error, so the error is recirculated
    rather than lost (EF-SGD)."""
    g = torch.as_tensor(grad).to(torch.float32) + residual
    qt = quantize_pow2(g, bits=bits, axis=None)
    return qt, g - dequantize_pow2(qt)


class QuantizedWeightCache:
    """Weights quantized ONCE per ``(param_name, level)`` — never per
    call.  ``quantize_calls`` / ``hits`` are the counting hooks
    (registry metrics ``weight_quantize_total`` /
    ``weight_cache_hits_total``) that let tests assert the decode loop
    quantizes no weight.  Invalidation goes through the engine's
    two-phase barrier (:meth:`MathEngine.invalidate_weights`)."""

    def __init__(self, bits: int = 8, registry=None):
        from repro_torch.runtime.telemetry import MetricsRegistry

        self.bits = bits
        self._store: dict = {}
        self._specs: dict = {}
        self._lock = threading.RLock()
        self._bind(registry if registry is not None else MetricsRegistry())

    def _bind(self, registry) -> None:
        self._registry = registry
        self._m_quantize = registry.counter(
            "weight_quantize_total", "weight quantizations performed (cache misses)"
        )
        self._m_hits = registry.counter(
            "weight_cache_hits_total", "pre-quantized weight reuses (cache hits)"
        )

    def use_registry(self, registry) -> None:
        """Re-home the counting hooks onto a shared registry, carrying
        the current counts over."""
        with self._lock:
            q, h = self.quantize_calls, self.hits
            self._bind(registry)
            if q:
                self._m_quantize.inc(q)
            if h:
                self._m_hits.inc(h)

    @property
    def registry(self):
        return self._registry

    @property
    def quantize_calls(self) -> int:
        return int(self._m_quantize.value())

    @property
    def hits(self) -> int:
        return int(self._m_hits.value())

    def get(self, name: str, w: torch.Tensor, *, level: str = "q16_16", axis: Axis = None) -> QTensor:
        """The quantized form of ``w``, computed at most once per
        ``(name, level)``; a hit checks shape/dtype/axis, not values."""
        key = (name, level)
        spec = (tuple(w.shape), str(w.dtype), axis)
        with self._lock:
            hit = self._store.get(key)
            if hit is not None:
                if self._specs[key] != spec:
                    raise ValueError(
                        f"QuantizedWeightCache: {key} cached with spec "
                        f"{self._specs[key]}, requested {spec} — different "
                        f"param under the same name? invalidate first."
                    )
                self._m_hits.inc()
                return hit
        qt = quantize_pow2(w, bits=self.bits, axis=axis)
        with self._lock:
            self._m_quantize.inc()
            self._store.setdefault(key, qt)
            self._specs[key] = spec
            return self._store[key]

    def invalidate(self, name: Optional[str] = None) -> int:
        with self._lock:
            if name is None:
                n = len(self._store)
                self._store.clear()
                self._specs.clear()
                return n
            victims = [k for k in self._store if k[0] == name]
            for k in victims:
                del self._store[k]
                del self._specs[k]
            return len(victims)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def __contains__(self, key) -> bool:
        with self._lock:
            if isinstance(key, tuple):
                return key in self._store
            return any(k[0] == key for k in self._store)
