"""K5-K7: the universal CORDIC family on int32 Q-format words.

Replaces the Pallas TPU kernels of ``src/repro/kernels/cordic/
universal.py``: ``_unary_kernel`` (K5, ``universal_kernel_call``),
``_atan2_kernel`` (K6, ``atan2_kernel_call``) and ``_div_kernel`` (K7,
``div_kernel_call``); the CUDA source is ``kernels/csrc/universal.cu``,
its per-element functions are in ``kernels/csrc/cordic.cuh``.

Each wrapper runs its plain PyTorch version (the bodies of
``core.cordic``, which the reference kernels run too) for a CPU tensor
and launches its kernel for a CUDA tensor — the same bits either way —
and counts its launches.  Inputs are int32 of any shape; the kernels
walk the flat words one thread per element, so there is no block
padding to keep total (the reference pads with 0, on which every op is
defined).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.compat import check_launch, current_stream, kernel_function, ptr
from repro_torch.core.cordic import (
    HYPER_STAGES,
    angle_consts,
    atan2_q16_body,
    atan_table,
    atanh_table,
    div_q16_body,
    exp_q16_body,
    hyper_gain_inverse,
    hyperbolic_schedule,
    log_q16_body,
    sigmoid_q16_body,
    sqrt_q16_body,
    tanh_q16_body,
)

__all__ = [
    "UNARY_OPS",
    "universal_unary",
    "universal_unary_plain",
    "atan2_q16",
    "atan2_q16_plain",
    "div_q16",
    "div_q16_plain",
]

#: op name -> elementwise Q16.16 body (the kernel's op code is the index)
UNARY_OPS = {
    "sqrt": sqrt_q16_body,
    "exp": exp_q16_body,
    "log": log_q16_body,
    "tanh": tanh_q16_body,
    "sigmoid": sigmoid_q16_body,
}
_OP_CODE = {name: i for i, name in enumerate(UNARY_OPS)}
#: the kernels' limits (schedule and table sizes of their parameter banks)
MAX_STAGES = 64
MAX_ITERATIONS = 32

_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_I32S = ctypes.POINTER(ctypes.c_int32)
#: repro_universal_unary(in, out, n, op, shift, atanh, stages, k_h_inv, stream)
_UNARY_ARGS = (_P, _P, _N, _I, _I32S, _I32S, _I, _I, _P)
#: repro_universal_atan2(y, x, out, n, table, iterations, pi, stream)
_ATAN2_ARGS = (_P, _P, _P, _N, _I32S, _I, _I, _P)
#: repro_universal_div(num, den, out, n, iterations, stream)
_DIV_ARGS = (_P, _P, _P, _N, _I, _P)


def _check_op(op: str) -> None:
    if op not in UNARY_OPS:
        raise ValueError(f"unknown universal op {op!r}; have {sorted(UNARY_OPS)}")


def _route(name: str, *ts: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU);
    raises on anything the kernel does not take."""
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 operands required, got {t.dtype}")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: operands on several devices")
    if len({tuple(t.shape) for t in ts}) != 1:
        raise ValueError(f"{name}: operand shapes differ: {[tuple(t.shape) for t in ts]}")
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return True


def universal_unary_plain(w_q: torch.Tensor, op: str, stages: int = HYPER_STAGES):
    """The plain PyTorch version of K5 (any device)."""
    _check_op(op)
    return UNARY_OPS[op](w_q, stages)


def atan2_q16_plain(y_q, x_q, iterations: int = 16, frac_bits: int = 16):
    """The plain PyTorch version of K6 (any device)."""
    return atan2_q16_body(y_q, x_q, iterations, frac_bits)


def div_q16_plain(num_q, den_q, iterations: int = 17):
    """The plain PyTorch version of K7 (any device)."""
    return div_q16_body(num_q, den_q, iterations)


@functools.lru_cache(maxsize=None)
def _hyper_params(stages: int):
    if not 0 <= stages <= MAX_STAGES:
        raise ValueError(f"universal_unary: stages {stages} outside [0, {MAX_STAGES}]")
    sched = hyperbolic_schedule(stages)
    n = max(stages, 1)
    shift = (ctypes.c_int32 * n)(*sched)
    atanh = (ctypes.c_int32 * n)(*[int(v) for v in atanh_table(sched, 29)])
    return shift, atanh, hyper_gain_inverse(sched, 29)


@functools.lru_cache(maxsize=None)
def _atan_params(iterations: int, frac_bits: int):
    if not 0 <= iterations <= MAX_ITERATIONS:
        raise ValueError(f"atan2_q16: iterations {iterations} outside [0, {MAX_ITERATIONS}]")
    table = (ctypes.c_int32 * max(iterations, 1))(*[int(v) for v in atan_table(iterations, frac_bits)])
    return table, angle_consts(frac_bits)[0]


def universal_unary(w_q: torch.Tensor, op: str, stages: int = HYPER_STAGES) -> torch.Tensor:
    """Elementwise Q16.16 ``op`` (sqrt, exp, log, tanh, sigmoid) on int32
    words of any shape, through K5."""
    _check_op(op)
    if not _route("universal_unary", w_q):
        return universal_unary_plain(w_q, op, stages)
    shift, atanh, k_h_inv = _hyper_params(stages)
    out = torch.empty_like(w_q)
    if w_q.numel():
        rc = kernel_function("universal", "repro_universal_unary", _UNARY_ARGS)(
            ptr(w_q), ptr(out), w_q.numel(), _OP_CODE[op], shift, atanh, stages, k_h_inv,
            current_stream(w_q))
        check_launch("universal", rc, f"universal_unary({op})")
        universal_unary.launches += 1
    return out


universal_unary.launches = 0


def atan2_q16(y_q: torch.Tensor, x_q: torch.Tensor, iterations: int = 16,
              frac_bits: int = 16) -> torch.Tensor:
    """atan2(y, x) on int32 Q(m.n) words of one shape, through K6;
    ``frac_bits`` is the output angle format (24: the Q8.24 rung)."""
    if not _route("atan2_q16", y_q, x_q):
        return atan2_q16_plain(y_q, x_q, iterations, frac_bits)
    table, pi = _atan_params(iterations, frac_bits)
    out = torch.empty_like(y_q)
    if y_q.numel():
        rc = kernel_function("universal", "repro_universal_atan2", _ATAN2_ARGS)(
            ptr(y_q), ptr(x_q), ptr(out), y_q.numel(), table, iterations, pi,
            current_stream(y_q))
        check_launch("universal", rc, "atan2_q16")
        atan2_q16.launches += 1
    return out


atan2_q16.launches = 0


def div_q16(num_q: torch.Tensor, den_q: torch.Tensor, iterations: int = 17) -> torch.Tensor:
    """Full-range Q16.16 ``num / den`` on int32 words of one shape,
    through K7 (den == 0 saturates, 0 / 0 = 0)."""
    if not _route("div_q16", num_q, den_q):
        return div_q16_plain(num_q, den_q, iterations)
    if not 0 <= iterations <= MAX_ITERATIONS:
        raise ValueError(f"div_q16: iterations {iterations} outside [0, {MAX_ITERATIONS}]")
    out = torch.empty_like(num_q)
    if num_q.numel():
        rc = kernel_function("universal", "repro_universal_div", _DIV_ARGS)(
            ptr(num_q), ptr(den_q), ptr(out), num_q.numel(), iterations, current_stream(num_q))
        check_launch("universal", rc, "div_q16")
        div_q16.launches += 1
    return out


div_q16.launches = 0
