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
walk the flat words, so there is no block padding to keep total (the
reference pads with 0, on which every op is defined).

K6 and K7 also have float entries, the engine's ``q16_16`` and ``q8_24``
ops in one pass: :func:`atan2_f32`, :func:`atan2_24_f32` and
:func:`div_f32` read float32 and write float32, and are bit for bit the
chain ``core.qformat.to_fixed`` -> the integer kernel -> ``from_fixed``
(``atan2_24_f32`` normalises by max(|y|, |x|) first, as
``src/repro/core/cordic.py::cordic_atan2_24``) run on the same device;
that chain is their plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.compat import (check_launch, current_stream, dtensor_local, from_local,
                                is_dtensor, kernel_function, meta_kernel, ptr,
                                settled_placements)
from repro_torch.core.cordic import (
    HYPER_STAGES,
    ITER_Q24,
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
from repro_torch.core.qformat import Q8_24, Q16_16, from_fixed, to_fixed

__all__ = [
    "UNARY_OPS",
    "universal_unary",
    "universal_unary_plain",
    "atan2_q16",
    "atan2_q16_plain",
    "div_q16",
    "div_q16_plain",
    "atan2_f32",
    "atan2_f32_plain",
    "atan2_24_f32",
    "atan2_24_f32_plain",
    "div_f32",
    "div_f32_plain",
    "FLOAT_EDGES",
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
#: repro_universal_atan2[_f32 | _24_f32](y, x, out, n, table, iterations, pi, stream)
_ATAN2_ARGS = (_P, _P, _P, _N, _I32S, _I, _I, _P)
#: repro_universal_div[_f32](num, den, out, n, iterations, stream)
_DIV_ARGS = (_P, _P, _P, _N, _I, _P)


def _check_op(op: str) -> None:
    if op not in UNARY_OPS:
        raise ValueError(f"unknown universal op {op!r}; have {sorted(UNARY_OPS)}")


def _route(name: str, *ts: torch.Tensor, dtype: torch.dtype = torch.int32) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU);
    raises on anything the kernel does not take."""
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} operands required, got {t.dtype}")
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


def atan2_f32_plain(y, x, iterations: int = 16):
    """The plain version of K6's Q16.16 float entry (any device)."""
    return from_fixed(atan2_q16_body(to_fixed(y, Q16_16), to_fixed(x, Q16_16), iterations, 16),
                      Q16_16)


#: the smallest normal float32
_F32_TINY = 2.0 ** -126

#: float32 values at the edges of the float entries' boundary, which their
#: checks pair every way: NaN, +-inf, +-0, subnormals, the smallest
#: normal, halves of the Q16.16 and Q8.24 grids, +-32768 (the Q16.16
#: saturation) and its neighbours, the f32 extremes
FLOAT_EDGES = (
    0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1e-45, -1e-45, 1e-40, -1e-40,
    _F32_TINY, 2.0**-17, -(2.0**-17), 3 * 2.0**-17, -3 * 2.0**-17, 0.5 / 65536, 1.5 / 65536,
    -2.5 / 65536, 1000.5 / 65536, 2.0**-25, 3 * 2.0**-25, -(2.0**-25), 1.0, -1.0, 0.5, 32768.0,
    -32768.0, 32767.998046875, 32768.00390625, -32767.998046875, -32768.00390625, 65536.0,
    -65536.0, 3.4e38, -3.4e38, 123.456, -7.25,
)


def _flush_subnormals(v: torch.Tensor) -> torch.Tensor:
    """Subnormal operands as zero, as XLA computes the reference (on the
    TPU and on the CPU alike); a NaN stays."""
    return torch.where(v.abs() < _F32_TINY, torch.zeros_like(v), v)


def atan2_24_f32_plain(y, x, iterations: int = ITER_Q24):
    """The plain version of K6's Q8.24 float entry (any device): the
    operands normalised by max(|y|, |x|), so any f32 magnitude fits the
    Q8.24 word (atan2 is scale-invariant).  Subnormal operands count as
    zero, as in the reference: only this normalisation can tell them
    apart (2**-149 / 2**-149 is 1), the Q16.16 rounding makes them 0."""
    y, x = _flush_subnormals(y), _flush_subnormals(x)
    m = torch.maximum(y.abs(), x.abs())
    s = torch.where(m > 0, m, torch.ones_like(m))
    out = atan2_q16_body(to_fixed(y / s, Q8_24), to_fixed(x / s, Q8_24), iterations, 24)
    return from_fixed(out, Q8_24)


def div_f32_plain(num, den, iterations: int = 17):
    """The plain version of K7's float entry (any device)."""
    return from_fixed(div_q16_body(to_fixed(num, Q16_16), to_fixed(den, Q16_16), iterations),
                      Q16_16)


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
        raise ValueError(f"atan2: iterations {iterations} outside [0, {MAX_ITERATIONS}]")
    table = (ctypes.c_int32 * max(iterations, 1))(*[int(v) for v in atan_table(iterations, frac_bits)])
    return table, angle_consts(frac_bits)[0]


def _unary_ops_bound(op: str, stages: int) -> int:
    """K5's integer operations for one word on its longest branch
    (``chip_smoke.py``'s ``unary_ops`` counts, which pick the branch from
    the data; a traced call has none): a CORDIC step 6, an ilog2 15, a
    shift 4, a 17-step linear division 15 + 8 + 85."""
    step, ilog2, shift = 6, 15, 4
    lindiv = ilog2 + 2 * shift + 5 * 17
    if op == "exp":
        return 2 + 16 + step * stages
    if op in ("sqrt", "log"):
        return 2 + 10 + ilog2 + 2 * shift + step * stages
    return 12 + 16 + step * stages + lindiv + (3 if op == "sigmoid" else 0)


def universal_unary(w_q: torch.Tensor, op: str, stages: int = HYPER_STAGES) -> torch.Tensor:
    """Elementwise Q16.16 ``op`` (sqrt, exp, log, tanh, sigmoid) on int32
    words of any shape, through K5."""
    _check_op(op)
    if is_dtensor(w_q):
        # elementwise: the local shards' words
        pl = settled_placements(w_q)
        return from_local(universal_unary(dtensor_local(w_q, pl), op, stages),
                          w_q.device_mesh, pl)
    if w_q.device.type == "meta":
        return meta_kernel("universal_unary", _unary_ops_bound(op, stages) * w_q.numel(),
                           8.0 * w_q.numel(), torch.empty_like(w_q, device="meta"))
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


def _atan2(entry, export: str, y, x, iterations: int, frac_bits: int) -> torch.Tensor:
    """Launch K6 through the C export ``export``, counted on ``entry``."""
    table, pi = _atan_params(iterations, frac_bits)
    out = torch.empty_like(y)
    if y.numel():
        rc = kernel_function("universal", export, _ATAN2_ARGS)(
            ptr(y), ptr(x), ptr(out), y.numel(), table, iterations, pi, current_stream(y))
        check_launch("universal", rc, entry.__name__)
        entry.launches += 1
    return out


def _div(entry, export: str, num, den, iterations: int) -> torch.Tensor:
    """Launch K7 through the C export ``export``, counted on ``entry``."""
    if not 0 <= iterations <= MAX_ITERATIONS:
        raise ValueError(f"{entry.__name__}: iterations {iterations} outside "
                         f"[0, {MAX_ITERATIONS}]")
    out = torch.empty_like(num)
    if num.numel():
        rc = kernel_function("universal", export, _DIV_ARGS)(
            ptr(num), ptr(den), ptr(out), num.numel(), iterations, current_stream(num))
        check_launch("universal", rc, entry.__name__)
        entry.launches += 1
    return out


def atan2_q16(y_q: torch.Tensor, x_q: torch.Tensor, iterations: int = 16,
              frac_bits: int = 16) -> torch.Tensor:
    """atan2(y, x) on int32 Q(m.n) words of one shape, through K6;
    ``frac_bits`` is the output angle format (24: the Q8.24 rung)."""
    if not _route("atan2_q16", y_q, x_q):
        return atan2_q16_plain(y_q, x_q, iterations, frac_bits)
    return _atan2(atan2_q16, "repro_universal_atan2", y_q, x_q, iterations, frac_bits)


def atan2_f32(y: torch.Tensor, x: torch.Tensor, iterations: int = 16) -> torch.Tensor:
    """The engine's ``q16_16`` atan2 on float32 tensors of one shape, in
    one K6 pass: Q16.16 operands, angle and result."""
    if not _route("atan2_f32", y, x, dtype=torch.float32):
        return atan2_f32_plain(y, x, iterations)
    return _atan2(atan2_f32, "repro_universal_atan2_f32", y, x, iterations, 16)


def atan2_24_f32(y: torch.Tensor, x: torch.Tensor, iterations: int = ITER_Q24) -> torch.Tensor:
    """The engine's ``q8_24`` atan2 on float32 tensors of one shape, in
    one K6 pass: operands normalised by max(|y|, |x|), Q8.24 words."""
    if not _route("atan2_24_f32", y, x, dtype=torch.float32):
        return atan2_24_f32_plain(y, x, iterations)
    return _atan2(atan2_24_f32, "repro_universal_atan2_24_f32", y, x, iterations, 24)


def div_q16(num_q: torch.Tensor, den_q: torch.Tensor, iterations: int = 17) -> torch.Tensor:
    """Full-range Q16.16 ``num / den`` on int32 words of one shape,
    through K7 (den == 0 saturates, 0 / 0 = 0)."""
    if not _route("div_q16", num_q, den_q):
        return div_q16_plain(num_q, den_q, iterations)
    return _div(div_q16, "repro_universal_div", num_q, den_q, iterations)


def div_f32(num: torch.Tensor, den: torch.Tensor, iterations: int = 17) -> torch.Tensor:
    """The engine's ``q16_16`` division on float32 tensors of one shape,
    in one K7 pass (saturates at the Q16.16 envelope)."""
    if not _route("div_f32", num, den, dtype=torch.float32):
        return div_f32_plain(num, den, iterations)
    return _div(div_f32, "repro_universal_div_f32", num, den, iterations)


atan2_q16.launches = atan2_f32.launches = atan2_24_f32.launches = 0
div_q16.launches = div_f32.launches = 0
