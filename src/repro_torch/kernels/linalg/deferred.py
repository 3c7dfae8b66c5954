"""C3: the deferred-correction Q-format matmul (paper Listing 3).

Replaces no TPU kernel: the reference computes it in plain JAX
(``src/repro/core/linalg.py::qmatmul_deferred``).  PyTorch has no
integer matmul for int32 operands on the card (``torch._int_mm`` is int8
only, and a library call), so the engine's ``q16_16`` matmul on a CUDA
tensor launches the hand-written kernel ``kernels/csrc/linalg.cu``.

Contract (the reference's): over each K tile of ``tile_k`` (the last one
ragged) the products are summed in 64-bit two's complement, wrapping mod
2**64; ``2**(frac_bits-1)`` is added when ``rounding``; one arithmetic
right shift by ``frac_bits``; the low 32 bits as int32; tiles combined in
order by a saturating int32 add (``core.qformat.q_add_sat``) or, with
``saturate=False``, a wrapping one.

:func:`qmatmul_deferred_plain` states the same contract in plain torch
and runs on the CPU and on the card (torch has no CUDA int64 matmul):
each operand is split into 16-bit limbs, whose per-tile products and
sums are integers below 2**53 for ``tile_k`` up to 2**21, so a float64
matmul gives them exactly in any summation order; the shifted word is
then read out of the limb sums with int64 arithmetic that cannot
overflow.  Only the bits ``[frac_bits, frac_bits + 32)`` of the tile sum
reach the result, all below bit 63, so the wrap mod 2**64 never shows.

:func:`qmatmul_deferred` is the wrapper: the plain version for a CPU
tensor, the kernel for a CUDA tensor (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.compat import check_launch, current_stream, kernel_function, ptr

__all__ = ["qmatmul_deferred", "qmatmul_deferred_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: repro_qmatmul_deferred(A, B, C, M, N, K, tile_k, frac_bits, rounding, saturate, stream)
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
#: the plain version's float64 limb sums are exact up to this tile depth
_MAX_PLAIN_TILE_K = 1 << 21
#: output elements of one float64 limb product in the plain version
_PLAIN_CHUNK = 1 << 22
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def _check(a_q, b_q, frac_bits, tile_k):
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"qmatmul_deferred: shapes {tuple(a_q.shape)} x {tuple(b_q.shape)}")
    if a_q.device != b_q.device:
        raise ValueError(f"qmatmul_deferred: operands on {a_q.device} and {b_q.device}")
    if not 0 < frac_bits < 32:
        raise ValueError(f"qmatmul_deferred: frac_bits {frac_bits} outside (0, 32)")
    if tile_k < 1:
        raise ValueError(f"qmatmul_deferred: tile_k {tile_k} < 1")


def _tile_words(hh, mid, ll, frac_bits: int, rounding: bool) -> torch.Tensor:
    """int64 limb sums of tile sums S = hh * 2**32 + mid * 2**16 + ll ->
    the low 32 bits of ``(S + round) >> frac_bits`` as int64 int32 values.

    With mid = mid_hi * 2**16 + mid_lo and L = ll + round + mid_lo * 2**16
    (0 <= L < 2**54), S + round = H * 2**32 + (L mod 2**32) where H = hh +
    mid_hi + (L >> 32); the shift's low word is then
    (H mod 2**f) << (32 - f) | (L mod 2**32) >> f."""
    f = frac_bits
    L = ll + ((mid & 0xFFFF) << 16)
    if rounding:
        L = L + (1 << (f - 1))
    H = hh + (mid >> 16) + (L >> 32)
    u = ((H & ((1 << f) - 1)) << (32 - f)) | ((L & 0xFFFFFFFF) >> f)
    return u - ((u >> 31) << 32)


def qmatmul_deferred_plain(a_q: torch.Tensor, b_q: torch.Tensor, *, frac_bits: int = 16,
                           rounding: bool = True, tile_k: int = 32,
                           saturate: bool = True) -> torch.Tensor:
    """The plain PyTorch version (same contract, any device; see the
    module docstring for why the float64 limb sums are exact)."""
    _check(a_q, b_q, frac_bits, tile_k)
    if tile_k > _MAX_PLAIN_TILE_K:
        raise ValueError(f"qmatmul_deferred_plain: tile_k {tile_k} > 2**21 (limb sums inexact)")
    a = a_q.to(torch.int32).to(torch.int64)
    b = b_q.to(torch.int32).to(torch.int64)
    M, K = a.shape
    N = b.shape[1]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=torch.int32, device=a.device)
    n_tiles = -(-K // tile_k)
    pad = n_tiles * tile_k - K
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    # signed high limbs in [-2**15, 2**15), unsigned low limbs in [0, 2**16)
    a_hi = (a >> 16).double().reshape(M, n_tiles, tile_k).transpose(0, 1)
    a_lo = (a & 0xFFFF).double().reshape(M, n_tiles, tile_k).transpose(0, 1)
    b_hi = (b >> 16).double().reshape(n_tiles, tile_k, N)
    b_lo = (b & 0xFFFF).double().reshape(n_tiles, tile_k, N)
    c = torch.zeros((M, N), dtype=torch.int64, device=a.device)
    step = max(1, _PLAIN_CHUNK // (M * N))
    for t0 in range(0, n_tiles, step):
        t = slice(t0, t0 + step)
        hh = torch.bmm(a_hi[t], b_hi[t]).to(torch.int64)
        ll = torch.bmm(a_lo[t], b_lo[t]).to(torch.int64)
        mid = torch.bmm(torch.cat([a_hi[t], a_lo[t]], dim=2),
                        torch.cat([b_lo[t], b_hi[t]], dim=1)).to(torch.int64)
        words = _tile_words(hh, mid, ll, frac_bits, rounding)
        if saturate:
            # q_add_sat of two int32 words is the clamp of their exact sum
            for w in words:
                c.add_(w).clamp_(_INT32_MIN, _INT32_MAX)
        else:
            c.add_(words.sum(dim=0))
    if not saturate:
        c = ((c + 2**31) & 0xFFFFFFFF) - 2**31
    return c.to(torch.int32)


def qmatmul_deferred(a_q: torch.Tensor, b_q: torch.Tensor, *, frac_bits: int = 16,
                     rounding: bool = True, tile_k: int = 32,
                     saturate: bool = True) -> torch.Tensor:
    """(M, K) x (K, N) Q-format words -> (M, N) int32 through the deferred
    kernel (the plain version for a CPU tensor).  Operands of another
    dtype are cast to int32 first, as the reference's ``jnp.asarray``."""
    _check(a_q, b_q, frac_bits, tile_k)
    if a_q.device.type == "cpu":
        return qmatmul_deferred_plain(a_q, b_q, frac_bits=frac_bits, rounding=rounding,
                                      tile_k=tile_k, saturate=saturate)
    if a_q.device.type != "cuda":
        raise ValueError(f"qmatmul_deferred: unsupported device {a_q.device}")
    a = a_q.to(torch.int32).contiguous()
    b = b_q.to(torch.int32).contiguous()
    M, K = a.shape
    N = b.shape[1]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=torch.int32, device=a.device)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    rc = kernel_function("linalg", "repro_qmatmul_deferred", _ARGTYPES)(
        ptr(a), ptr(b), ptr(out), M, N, K, min(tile_k, K), frac_bits, int(rounding),
        int(saturate), current_stream(a),
    )
    check_launch("linalg", rc, "qmatmul_deferred")
    qmatmul_deferred.launches += 1
    return out


qmatmul_deferred.launches = 0
