"""Q-format fixed-point arithmetic core (paper §3.1, §5.1; Listing 1).

Reference: ``src/repro/core/qformat.py``.  The reference computes the
widened 32x32 -> 64 product with paired uint32 limbs because default
JAX has no 64-bit integers; PyTorch has int64, so the product is
formed directly in int64 and the low 32 bits are kept — bit-exact with
the limb arithmetic (rounding add, arithmetic shift, wrap to int32,
optional saturation on the high word's sign).

The limb helpers themselves (``widening_mul_i32``, ``add_64``,
``add_64_pair``, ``shift_right_64``) are kept for callers that work on
(hi, lo) pairs: each word is an int64 tensor holding the uint32 value
(0 .. 2**32 - 1), bit-equal to the reference's uint32 words.
``static_footprint_bytes`` is the paper's 88-byte decomposition.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "QFormat",
    "Q16_16",
    "Q8_24",
    "Q1_15",
    "Q8_8",
    "Q0_7",
    "Q2_6",
    "to_fixed",
    "from_fixed",
    "q_add",
    "q_sub",
    "q_add_sat",
    "q_sub_sat",
    "q_mul",
    "q_mul_sat",
    "q_neg",
    "widening_mul_i32",
    "add_64",
    "add_64_pair",
    "shift_right_64",
    "static_footprint_bytes",
]


@dataclasses.dataclass(frozen=True)
class QFormat:
    """A signed Q(m.n) fixed-point format; ``int_bits`` includes the
    sign bit (Q16.16 = one 32-bit word)."""

    int_bits: int
    frac_bits: int
    name: str = ""

    def __post_init__(self):
        total = self.int_bits + self.frac_bits
        if total not in (8, 16, 32):
            raise ValueError(f"Q{self.int_bits}.{self.frac_bits}: word width {total} unsupported")

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits

    @property
    def dtype(self) -> torch.dtype:
        return {8: torch.int8, 16: torch.int16, 32: torch.int32}[self.total_bits]

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def resolution(self) -> float:
        return 2.0 ** (-self.frac_bits)

    @property
    def raw_min(self) -> int:
        return -(2 ** (self.total_bits - 1))

    @property
    def raw_max(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def min_value(self) -> float:
        return self.raw_min / self.scale

    @property
    def max_value(self) -> float:
        return self.raw_max / self.scale


Q16_16 = QFormat(16, 16, "paper Q16.16")
Q8_24 = QFormat(8, 24, "high-precision angle")
Q8_8 = QFormat(8, 8, "int16 activations")
Q1_15 = QFormat(1, 15, "int16 normalized")
Q0_7 = QFormat(1, 7, "int8 normalized")
Q2_6 = QFormat(2, 6, "int8 dynamic")


def to_fixed(x: torch.Tensor, fmt: QFormat = Q16_16, *, saturate: bool = True) -> torch.Tensor:
    """Round-to-nearest-even float -> Q(m.n) raw integer, saturating
    after the cast (``2**31 - 1`` is not representable in f32)."""
    scaled = torch.round(torch.as_tensor(x).to(torch.float32) * fmt.scale)
    # keep the f32 -> int32 conversion inside int32 range (out-of-range
    # values are replaced by the saturation masks below)
    raw = scaled.clamp(-(2.0 ** 31), 2.0 ** 31 - 128).to(torch.int32).to(fmt.dtype)
    if saturate:
        hi_f = 2.0 ** (fmt.total_bits - 1)
        raw = torch.where(scaled >= hi_f, torch.full_like(raw, fmt.raw_max), raw)
        raw = torch.where(scaled < -hi_f, torch.full_like(raw, fmt.raw_min), raw)
    return raw


def from_fixed(v: torch.Tensor, fmt: QFormat = Q16_16, dtype=torch.float32) -> torch.Tensor:
    """Q(m.n) raw integer -> float (exact power-of-two scale)."""
    return v.to(dtype) / fmt.scale


def q_add(a, b):
    """Exact Q addition; wraps on overflow like the C ``addQ``."""
    return a + b


def q_sub(a, b):
    return a - b


def q_neg(a):
    return -a


def _sat_bounds(dtype):
    info = torch.iinfo(dtype)
    return info.min, info.max


def q_add_sat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating add: clamps instead of wrapping (paper §3.1.2)."""
    c = a + b
    lo, hi = _sat_bounds(a.dtype)
    pos_over = (a > 0) & (b > 0) & (c < 0)
    neg_over = (a < 0) & (b < 0) & (c >= 0)
    c = torch.where(pos_over, torch.full_like(c, hi), c)
    return torch.where(neg_over, torch.full_like(c, lo), c)


def q_sub_sat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c = a - b
    lo, hi = _sat_bounds(a.dtype)
    pos_over = (a >= 0) & (b < 0) & (c < 0)
    neg_over = (a < 0) & (b > 0) & (c >= 0)
    c = torch.where(pos_over, torch.full_like(c, hi), c)
    return torch.where(neg_over, torch.full_like(c, lo), c)


def q_mul(a, b, *, frac_bits: int = 16, rounding: bool = True, saturate: bool = False):
    """Q(m.n) multiply with a 64-bit intermediate and ONE shift.

    ``rounding`` adds ``2**(n-1)`` before the arithmetic shift; the
    result is the low 32 bits (wrapping) or, with ``saturate``, the
    int32 clamp chosen by the sign of the shifted 64-bit value.
    """
    a = torch.as_tensor(a, dtype=torch.int32)
    b = torch.as_tensor(b, dtype=torch.int32, device=a.device)
    p = a.to(torch.int64) * b.to(torch.int64)
    if rounding:
        p = p + (1 << (frac_bits - 1))
    p = p >> frac_bits
    result = p.to(torch.int32)  # low 32 bits (two's-complement wrap)
    if saturate:
        fits = p == result.to(torch.int64)
        sat = torch.where(p >= 0, torch.full_like(result, 0x7FFFFFFF),
                          torch.full_like(result, -0x80000000))
        result = torch.where(fits, result, sat)
    return result


def q_mul_sat(a, b, *, frac_bits: int = 16, rounding: bool = True):
    return q_mul(a, b, frac_bits=frac_bits, rounding=rounding, saturate=True)


# ---------------------------------------------------------------------------
# Widening 32x32 -> 64 multiply as (hi, lo) uint32 words (paper §8.1 / §8.5)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _u32(w) -> torch.Tensor:
    """A uint32 word (given as any integer tensor) as int64 in [0, 2**32)."""
    return torch.as_tensor(w).to(torch.int64) & _U32


def widening_mul_i32(a, b):
    """Exact signed 32x32 -> 64-bit product as a (hi, lo) pair of uint32
    words: ``value = hi << 32 | lo`` read as int64.  The product is formed
    in int64 (|a * b| <= 2**62, no overflow) and split."""
    a = torch.as_tensor(a, dtype=torch.int32)
    b = torch.as_tensor(b, dtype=torch.int32, device=a.device)
    p = a.to(torch.int64) * b.to(torch.int64)
    return (p >> 32) & _U32, p & _U32


def add_64(hi, lo, addend_u32):
    """(hi, lo) + a small unsigned addend, with the carry into hi."""
    hi, lo = _u32(hi), _u32(lo)
    lo2 = (lo + _u32(addend_u32)) & _U32
    return (hi + (lo2 < lo).to(torch.int64)) & _U32, lo2


def add_64_pair(hi1, lo1, hi2, lo2):
    """Two's-complement 64-bit add of two (hi, lo) pairs (wraps mod 2**64)."""
    lo1 = _u32(lo1)
    lo = (lo1 + _u32(lo2)) & _U32
    return (_u32(hi1) + _u32(hi2) + (lo < lo1).to(torch.int64)) & _U32, lo


def shift_right_64(hi, lo, n: int):
    """Arithmetic right shift of a two's-complement (hi, lo) pair by 0 < n < 32."""
    if not 0 < n < 32:
        raise ValueError("shift must be in (0, 32)")
    hi, lo = _u32(hi), _u32(lo)
    lo2 = ((lo >> n) | (hi << (32 - n))) & _U32
    hi_signed = hi - ((hi >> 31) << 32)
    return (hi_signed >> n) & _U32, lo2


# ---------------------------------------------------------------------------
# Static footprint accounting (paper §4.3.2: 88 bytes total)
# ---------------------------------------------------------------------------


def static_footprint_bytes(num_ops: int = 6, cordic_iters: int = 16) -> dict:
    """The paper's static-memory decomposition: a dispatch table of
    |F| 4-byte pointers and a CORDIC atan table of ``iters`` 4-byte
    words (88 = 24 + 64 for the paper's numbers)."""
    dispatch = num_ops * 4
    atan_table = cordic_iters * 4
    return {
        "dispatch_table_bytes": dispatch,
        "cordic_table_bytes": atan_table,
        "total_bytes": dispatch + atan_table,
    }
