"""K1: tiled Q-format int8 matmul with ONE deferred power-of-two
correction.

Replaces the Pallas TPU kernel ``src/repro/kernels/qmatmul/qmatmul.py::
_kernel`` (launched by ``qmatmul_kernel_call``); the CUDA source is
``kernels/csrc/qmatmul.cu`` on the shapes of ``int8_gemm.cuh``.

Contract: ``a_q`` (M, K) int8 x ``b_q`` (K, N) int8 accumulated exactly
in int32, then one correction with ``e = ea + eb[n]``:

* ``"float"``: ``acc * 2**e`` in f32;
* ``"q16"``: Q16.16 by a shift of ``e + 16`` — left (wrapping, no
  saturation) or round-half-up right, with shift counts of 32 or more
  giving 0 on the left and the sign fill on the right;
* ``"int32"``: the raw accumulator.

On the H100 the decode shapes (M <= 8) are bound by reading ``b_q``
once (bytes): a skinny dp4a matrix-vector shape streams it.  Prefill
shapes (M > 8) are bound by int8 operations and run on the tensor cores,
as the TPU kernel runs them on its matrix unit: ``mma.sync`` s8 tiles of
64 or 128 rows by 128 columns, K streamed through a four-stage
``cp.async`` ring, and ``b_q`` kept in the reference (K, N) layout —
the tensor cores' k-major fragments come out of its row-major tile by a
permuted ``ldmatrix .trans``.  Integer sums are exact in any order, so
both shapes are bit-exact against :func:`qmatmul_plain`.

:func:`qmatmul` is the wrapper: the plain PyTorch version for a CPU
tensor, the kernel for a CUDA tensor (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.compat import check_launch, current_stream, kernel_function, ptr

__all__ = ["EPILOGUES", "qmatmul", "qmatmul_plain", "MAX_K"]

EPILOGUES = ("float", "q16", "int32")
_P, _I = ctypes.c_void_p, ctypes.c_int
#: repro_qmatmul(A, B, ea, eb, out, M, N, K, mode, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
#: int32 accumulation of int8 products is exact up to this depth
MAX_K = 1 << 17


def _acc_exact(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 product as int64: every partial sum is an integer
    below 2**53, so a float64 matmul is exact in any summation order
    (and runs on the card, where integer matmuls do not)."""
    return (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(torch.int64)


def _epilogue_plain(acc: torch.Tensor, e: torch.Tensor, epilogue: str) -> torch.Tensor:
    """``acc`` int32 (M, N), ``e`` int32 broadcastable (N,)."""
    if epilogue == "int32":
        return acc
    if epilogue == "float":
        return acc.to(torch.float32) * torch.exp2(e.to(torch.float32))
    s = (e + 16).expand_as(acc)
    sr = torch.clamp_min(-s, 0)
    sl = torch.clamp_min(s, 0)
    one = torch.ones_like(acc)
    half = torch.where(sr > 0, one << torch.clamp_min(sr - 1, 0), torch.zeros_like(acc))
    shifted = (acc + half) >> sr
    return torch.where(s >= 0, acc << sl, shifted)


def qmatmul_plain(a_q, b_q, ea, eb, epilogue: str = "float") -> torch.Tensor:
    """The plain PyTorch version of K1 (same contract, any device)."""
    acc = _acc_exact(a_q, b_q).to(torch.int32)  # wraps like the int32 accumulator
    e = ea.to(torch.int32).reshape(()) + eb.to(torch.int32).reshape(-1)
    return _epilogue_plain(acc, e, epilogue)


def _check(a_q, b_q, ea, eb, epilogue):
    if epilogue not in EPILOGUES:
        raise ValueError(f"qmatmul: epilogue {epilogue!r} not in {EPILOGUES}")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"qmatmul: int8 operands required, got {a_q.dtype} x {b_q.dtype}")
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"qmatmul: shapes {tuple(a_q.shape)} x {tuple(b_q.shape)}")
    M, K = a_q.shape
    N = b_q.shape[1]
    if K > MAX_K:
        raise ValueError(f"qmatmul: K={K} > 2**17, int32 accumulation would not be exact")
    if ea.numel() != 1 or eb.numel() != N:
        raise ValueError(f"qmatmul: exponents {tuple(ea.shape)}, {tuple(eb.shape)} for N={N}")
    devs = {t.device for t in (a_q, b_q, ea, eb)}
    if len(devs) != 1:
        raise ValueError(f"qmatmul: operands on several devices {devs}")
    return M, K, N


def qmatmul(a_q: torch.Tensor, b_q: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor,
            epilogue: str = "float") -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) f32 or int32 through K1.

    ``ea``: per-tensor activation exponent (one int32 element);
    ``eb``: per-column weight exponents (N int32), both on the same
    device as the operands — the kernel reads them there, so no host
    synchronisation is needed.
    """
    M, K, N = _check(a_q, b_q, ea, eb, epilogue)
    if a_q.device.type == "cpu":
        return qmatmul_plain(a_q, b_q, ea, eb, epilogue)
    if a_q.device.type != "cuda":
        raise ValueError(f"qmatmul: unsupported device {a_q.device}")
    for name, t in (("a_q", a_q), ("b_q", b_q), ("eb", eb)):
        if not t.is_contiguous():
            raise ValueError(f"qmatmul: {name} must be contiguous")
    if ea.dtype != torch.int32 or eb.dtype != torch.int32:
        raise TypeError("qmatmul: int32 exponents required")
    if K % 4 or N % 4:
        raise ValueError(f"qmatmul: the kernel needs K and N multiples of 4 (K={K}, N={N})")
    out = torch.empty((M, N), dtype=torch.float32 if epilogue == "float" else torch.int32,
                      device=a_q.device)
    if M == 0 or N == 0:
        return out
    ea1 = ea.reshape(1).contiguous()
    rc = kernel_function("qmatmul", "repro_qmatmul", _ARGTYPES)(
        ptr(a_q), ptr(b_q), ptr(ea1), ptr(eb), ptr(out), M, N, K,
        EPILOGUES.index(epilogue), current_stream(a_q),
    )
    check_launch("qmatmul", rc, "qmatmul")
    qmatmul.launches += 1
    return out


qmatmul.launches = 0
