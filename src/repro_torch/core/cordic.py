"""CORDIC bodies on int32 tensors (paper §3.2, §5.2; Listing 2).

Reference: ``src/repro/core/cordic.py``.  Ported here:

* circular rotation: ``cordic_sincos_q16`` with ``_range_reduce_q``,
  the atan table and the gain (the FAST RoPE tables, kernel K3), and
  ``cordic_rotate_q16`` (rotation of given vectors);
* circular vectoring: ``atan2_q16_body`` (kernel K6) and ``atan2_q24``;
* the hyperbolic helpers ``_ilog2``, ``_shift_signed``,
  ``_round_shift_right``, ``_hyper_vectoring``/``_hyper_rotation``, the
  linear-vectoring divide ``_linear_div_q16`` and ``div_q16_body``
  (kernel K7), ``sqrt_q16_body``, ``exp_q16_body``, ``log_q16_body``,
  ``tanh_q16_body`` and ``sigmoid_q16_body`` (kernel K5; the sigmoid is
  also the in-kernel sigmoid of the fused SwiGLU, kernel K2);
* the float-boundary sincos ``cordic_sincos``/``cordic_sincos24``
  (K3: on a CUDA tensor the kernel, on a CPU tensor these bodies — the
  same bits either way).  The reference's other float-boundary wrappers
  (``cordic_atan2``, ``cordic_atan2_24``, ``cordic_div``,
  ``cordic_sqrt``/``exp``/``log``/``tanh``/``sigmoid``) are the public
  ops of ``kernels/cordic/ops.py``, over kernels K5-K7;
* the exact RoPE phase ``rope_inv_freq_q64`` / ``exact_rope_phase_q16``,
  computed in int64 masked to 32 bits — bit-exact with the reference's
  uint32-limb arithmetic.

These are the PLAIN PyTorch bodies: int32 tensors with the reference's
integer semantics (wrapping add/sub, shifts where a count of 32 or more
gives 0 on the left and the sign fill on the right — PyTorch's int32
shifts already behave so).  The CUDA kernels in ``kernels/csrc``
implement the same functions and are held against these.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.qformat import Q8_24, from_fixed, q_mul, to_fixed

__all__ = [
    "ATAN_TABLE_Q16",
    "CORDIC_K_INV_Q16",
    "PI_Q16",
    "HALF_PI_Q16",
    "TWO_PI_Q16",
    "LN2_Q16",
    "INV_LN2_Q16",
    "EXP_SAT_HI_Q16",
    "EXP_FLUSH_LO_Q16",
    "HYPER_STAGES",
    "ITER_Q24",
    "angle_consts",
    "atan_table",
    "gain_inverse",
    "hyperbolic_schedule",
    "atanh_table",
    "hyper_gain_inverse",
    "cordic_sincos_q16",
    "cordic_sincos",
    "cordic_sincos24",
    "cordic_rotate_q16",
    "atan2_q16_body",
    "atan2_q24",
    "div_q16_body",
    "sqrt_q16_body",
    "exp_q16_body",
    "log_q16_body",
    "tanh_q16_body",
    "sigmoid_q16_body",
    "rope_inv_freq_q64",
    "exact_rope_phase_q16",
]

_U16 = 1 << 16


def atan_table(iterations: int, frac_bits: int = 16) -> np.ndarray:
    """``round(atan(2**-i) * 2**frac_bits)`` for i in [0, iterations)."""
    scale = float(1 << frac_bits)
    return np.array(
        [int(round(math.atan(2.0 ** -i) * scale)) for i in range(iterations)], dtype=np.int32
    )


def gain_inverse(iterations: int, frac_bits: int = 16) -> int:
    """``round(K_n**-1 * 2**frac_bits)`` (K_inf = 1.64676...)."""
    k = 1.0
    for i in range(iterations):
        k *= math.sqrt(1.0 + 2.0 ** (-2 * i))
    return int(round((1.0 / k) * (1 << frac_bits)))


def angle_consts(frac_bits: int = 16) -> Tuple[int, int, int]:
    """(pi, pi/2, 2*pi) as raw Q(m.n) integers."""
    scale = 1 << frac_bits
    return (
        int(round(math.pi * scale)),
        int(round(math.pi / 2 * scale)),
        int(round(2 * math.pi * scale)),
    )


ATAN_TABLE_Q16 = atan_table(16)
CORDIC_K_INV_Q16 = gain_inverse(16)
PI_Q16, HALF_PI_Q16, TWO_PI_Q16 = angle_consts(16)
ITER_Q24 = 24

assert CORDIC_K_INV_Q16 == 39797, "paper §5.2 constant mismatch"
assert PI_Q16 == 205887 and HALF_PI_Q16 == 102944, "paper §5.2 constants"


def _i32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, int(v), dtype=torch.int32)


def _range_reduce_q(theta_q: torch.Tensor, frac_bits: int = 16):
    """Branchless reduction of any int32 Q(m.n) angle to [-pi/2, pi/2];
    returns (reduced, negate) — negate applies to BOTH sin and cos."""
    pi, half_pi, two_pi = angle_consts(frac_bits)
    theta_q = theta_q.to(torch.int32)
    # int32 add wraps near INT32_MAX, as in the reference; floor-mod
    r = torch.remainder(theta_q + pi, two_pi) - pi
    hi = r > half_pi
    lo = r < -half_pi
    r = torch.where(hi, r - pi, r)
    r = torch.where(lo, r + pi, r)
    return r, hi | lo


def cordic_sincos_q16(theta_q: torch.Tensor, iterations: int = 16, frac_bits: int = 16):
    """Rotation-mode CORDIC (paper Listing 2, corrected fold): raw
    Q(m.n) int32 angles of any shape -> (sin, cos) raw int32."""
    table = atan_table(iterations, frac_bits)
    k_inv = gain_inverse(iterations, frac_bits)
    z, negate = _range_reduce_q(theta_q, frac_bits)
    x = _i32(k_inv, z)
    y = torch.zeros_like(z)
    for i in range(iterations):
        d_pos = z >= 0
        xs = x >> i
        ys = y >> i
        x, y, z = (
            torch.where(d_pos, x - ys, x + ys),
            torch.where(d_pos, y + xs, y - xs),
            torch.where(d_pos, z - int(table[i]), z + int(table[i])),
        )
    return torch.where(negate, -y, y), torch.where(negate, -x, x)


def cordic_sincos(theta: torch.Tensor, iterations: int = 16):
    """Float in / float out Q16.16 sincos through kernel K3."""
    from repro_torch.kernels.cordic.ops import sincos

    return sincos(theta, iterations)


def cordic_sincos24(theta: torch.Tensor, iterations: int = ITER_Q24):
    """Q8.24 sincos (the ``q8_24`` rung) through kernel K3."""
    from repro_torch.kernels.cordic import cordic_sincos as k3

    s, c = k3(to_fixed(theta, Q8_24), iterations=iterations, frac_bits=24)
    return from_fixed(s, Q8_24), from_fixed(c, Q8_24)


def cordic_rotate_q16(x_q, y_q, theta_q, iterations: int = 16, frac_bits: int = 16):
    """Rotate fixed-point vectors (x, y) by theta, multiplier-free: the
    gain is folded in by pre-scaling with K^-1 (a rounded Q(m.n)
    product).  The angle is reduced on the Q16.16 circle whatever
    ``frac_bits`` is, as in the reference."""
    table = atan_table(iterations, frac_bits)
    k_inv = gain_inverse(iterations, frac_bits)
    z, negate = _range_reduce_q(theta_q, 16)
    x = q_mul(torch.as_tensor(x_q, dtype=torch.int32), k_inv, frac_bits=frac_bits)
    y = q_mul(torch.as_tensor(y_q, dtype=torch.int32), k_inv, frac_bits=frac_bits)
    for i in range(iterations):
        d_pos = z >= 0
        xs = x >> i
        ys = y >> i
        x, y, z = (
            torch.where(d_pos, x - ys, x + ys),
            torch.where(d_pos, y + xs, y - xs),
            torch.where(d_pos, z - int(table[i]), z + int(table[i])),
        )
    return torch.where(negate, -x, x), torch.where(negate, -y, y)


# ---------------------------------------------------------------------------
# hyperbolic + linear modes (Walther), Q3.29 internal datapath
# ---------------------------------------------------------------------------

HYPER_STAGES = 20
_HFRAC = 29

LN2_Q16 = int(round(math.log(2.0) * _U16))
INV_LN2_Q16 = int(round((1.0 / math.log(2.0)) * _U16))
EXP_SAT_HI_Q16 = int(round(math.log(32768.0) * _U16))
EXP_FLUSH_LO_Q16 = int(round(math.log(2.0 ** -17) * _U16))
_RAW_MAX = (1 << 31) - 1
_RAW_MIN = -(1 << 31)


def hyperbolic_schedule(stages: int) -> Tuple[int, ...]:
    """Shift indices 1, 2, 3, 4, 4, 5, ... with repeats at 4, 13, 40, ..."""
    idx, i, rep = [], 1, 4
    while len(idx) < stages:
        idx.append(i)
        if i == rep and len(idx) < stages:
            idx.append(i)
            rep = 3 * rep + 1
        i += 1
    return tuple(idx[:stages])


def atanh_table(schedule: Tuple[int, ...], frac_bits: int = _HFRAC) -> np.ndarray:
    scale = float(1 << frac_bits)
    return np.array(
        [int(round(math.atanh(2.0 ** -i) * scale)) for i in schedule], dtype=np.int64
    )


def hyper_gain_inverse(schedule: Tuple[int, ...], frac_bits: int = _HFRAC) -> int:
    k = 1.0
    for i in schedule:
        k *= math.sqrt(1.0 - 2.0 ** (-2 * i))
    return int(round((1.0 / k) * (1 << frac_bits)))


def _clamp_raw(v: torch.Tensor) -> torch.Tensor:
    """Clamp INT32_MIN to INT32_MIN+1 so |v| and -v never wrap."""
    return torch.clamp_min(v.to(torch.int32), _RAW_MIN + 1)


def _ilog2(v: torch.Tensor) -> torch.Tensor:
    """Branchless floor(log2(v)) for v >= 1 (5-step binary cascade)."""
    v = v.to(torch.int32)
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        gt = v >= (1 << s)
        n = n + torch.where(gt, s, 0).to(torch.int32)
        v = torch.where(gt, v >> s, v)
    return n


def _shift_signed(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``v * 2**-s`` with a per-element signed count (s < 0 => left)."""
    return (v >> torch.clamp_min(s, 0)) << torch.clamp_min(-s, 0)


def _round_shift_right(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest arithmetic right shift by a count >= 0."""
    one = torch.ones_like(v)
    half = torch.where(s > 0, one << torch.clamp_min(s - 1, 0), torch.zeros_like(v))
    return (v + half) >> s


def _hyper_vectoring(x, y, z, stages: int):
    sched = hyperbolic_schedule(stages)
    table = atanh_table(sched, _HFRAC)
    for j, i in enumerate(sched):
        neg = y < 0
        xs = x >> i
        ys = y >> i
        t = int(table[j])
        x, y, z = (
            torch.where(neg, x + ys, x - ys),
            torch.where(neg, y + xs, y - xs),
            torch.where(neg, z - t, z + t),
        )
    return x, y, z


def _hyper_rotation(x, y, z, stages: int):
    sched = hyperbolic_schedule(stages)
    table = atanh_table(sched, _HFRAC)
    for j, i in enumerate(sched):
        pos = z >= 0
        xs = x >> i
        ys = y >> i
        t = int(table[j])
        x, y, z = (
            torch.where(pos, x + ys, x - ys),
            torch.where(pos, y + xs, y - xs),
            torch.where(pos, z - t, z + t),
        )
    return x, y, z


def _linear_div_q16(num: torch.Tensor, den: torch.Tensor, iterations: int = 17):
    """Linear-vectoring division num/den in Q16.16 for den > 0, |num| <= den."""
    num = num.to(torch.int32)
    den = den.to(torch.int32)
    b = _ilog2(torch.clamp_min(den, 1))
    s = _HFRAC - b
    x = _shift_signed(den, -s)
    y = _shift_signed(num, -s)
    z = torch.zeros_like(x)
    for i in range(iterations):
        pos = y >= 0
        xs = x >> i
        t = _U16 >> i
        y = torch.where(pos, y - xs, y + xs)
        z = torch.where(pos, z + t, z - t)
    return z


def div_q16_body(num_q: torch.Tensor, den_q: torch.Tensor, iterations: int = 17):
    """Full-range Q16.16 ``num/den`` (den == 0 saturates, 0/0 = 0)."""
    num = _clamp_raw(num_q)
    den = _clamp_raw(den_q)
    an = num.abs()
    ad = den.abs()
    bn = _ilog2(torch.clamp_min(an, 1))
    bd = _ilog2(torch.clamp_min(ad, 1))
    nn = _shift_signed(an, bn - _HFRAC)
    dd = _shift_signed(ad, bd - _HFRAC)
    z = _linear_div_q16(nn, torch.clamp_min(dd, 1), iterations)
    e = bn - bd
    zr = _round_shift_right(z, torch.clamp_min(-e, 0))
    sl = torch.clamp_min(e, 0)
    fits = zr <= (_i32(_RAW_MAX, zr) >> sl)
    mag = torch.where(fits, zr << sl, _i32(_RAW_MAX, zr))
    out = torch.where((num < 0) != (den < 0), -mag, mag)
    sat = torch.where(num > 0, _i32(_RAW_MAX, num), _i32(_RAW_MIN + 1, num))
    return torch.where(
        den_q.to(torch.int32) == 0, torch.where(num == 0, torch.zeros_like(num), sat), out
    )


def atan2_q16_body(y_q, x_q, iterations: int = 16, frac_bits: int = 16):
    """Circular-vectoring atan2 on Q(m.n) operands.  The operands are
    normalised so max(|x|, |y|) sits at bit 28 (atan2 is scale-invariant,
    so ``frac_bits`` selects only the output angle format: 24 is the
    Q8.24 rung); x < 0 is folded into the right half-plane by point
    reflection and +/-pi restored from the sign of y; atan2(0, 0) = 0."""
    y0 = _clamp_raw(y_q)
    x0 = _clamp_raw(x_q)
    table = atan_table(iterations, frac_bits)
    pi_q = angle_consts(frac_bits)[0]
    neg_x = x0 < 0
    x1 = torch.where(neg_x, -x0, x0)
    y1 = torch.where(neg_x, -y0, y0)
    m = torch.maximum(x1.abs(), y1.abs())
    s = 28 - _ilog2(torch.clamp_min(m, 1))
    x1 = _shift_signed(x1, -s)
    y1 = _shift_signed(y1, -s)
    z = torch.zeros_like(x1)
    for i in range(iterations):
        neg = y1 < 0
        xs = x1 >> i
        ys = y1 >> i
        t = int(table[i])
        x1, y1, z = (
            torch.where(neg, x1 - ys, x1 + ys),
            torch.where(neg, y1 + xs, y1 - xs),
            torch.where(neg, z - t, z + t),
        )
    half_turn = torch.where(y0 < 0, _i32(-pi_q, y0), _i32(pi_q, y0))
    out = torch.where(neg_x, z + half_turn, z)
    return torch.where((x0 == 0) & (y0 == 0), torch.zeros_like(out), out)


def atan2_q24(y_q, x_q, iterations: int = ITER_Q24):
    """atan2 with a Q8.24 output angle (the ``q8_24`` rung)."""
    return atan2_q16_body(y_q, x_q, iterations=iterations, frac_bits=24)


def sqrt_q16_body(w_q, stages: int = HYPER_STAGES):
    """Hyperbolic-vectoring square root on Q16.16; w <= 0 returns 0.
    w = u * 2**s with s even and u in [0.5, 2); sqrt(u) is the vectoring
    magnitude of (u + 1/4, u - 1/4) times K_h^-1 (Q3.29)."""
    w = _clamp_raw(w_q)
    k_h_inv = hyper_gain_inverse(hyperbolic_schedule(stages), _HFRAC)
    b = _ilog2(torch.clamp_min(w, 1))
    s0 = b - 16
    s = torch.where((s0 & 1) == 0, s0, s0 + 1)
    u = _shift_signed(w, s)
    u29 = u << (_HFRAC - 16)
    quarter = 1 << (_HFRAC - 2)
    x, _, _ = _hyper_vectoring(u29 + quarter, u29 - quarter, torch.zeros_like(u29), stages)
    r29 = q_mul(x, k_h_inv, frac_bits=_HFRAC)
    out = _round_shift_right(r29, (_HFRAC - 16) - (s >> 1))
    return torch.where(w <= 0, torch.zeros_like(out), out)


def _q_mul16(a: torch.Tensor, b: int) -> torch.Tensor:
    """Rounded Q16.16 product (core.qformat.q_mul at its defaults)."""
    return ((a.to(torch.int64) * b + (1 << 15)) >> 16).to(torch.int32)


def exp_q16_body(t_q: torch.Tensor, stages: int = HYPER_STAGES):
    """Hyperbolic-rotation exponential on Q16.16 with ln2 reduction;
    saturates above ln(32768), flushes to 0 below ln(2^-17)."""
    t = t_q.to(torch.int32)
    k_h_inv = hyper_gain_inverse(hyperbolic_schedule(stages), _HFRAC)
    tc = torch.clamp(t, EXP_FLUSH_LO_Q16 - _U16, EXP_SAT_HI_Q16 + _U16)
    k = (_q_mul16(tc, INV_LN2_Q16) + (1 << 15)) >> 16
    r = tc - k * LN2_Q16
    x, y, _ = _hyper_rotation(_i32(k_h_inv, t), torch.zeros_like(t), r << (_HFRAC - 16), stages)
    er = x + y
    sh = (_HFRAC - 16) - k
    rs = _round_shift_right(er, torch.clamp_min(sh, 0))
    sl = torch.clamp_min(-sh, 0)
    fits = rs <= (_i32(_RAW_MAX, rs) >> sl)
    out = torch.where(fits, rs << sl, _i32(_RAW_MAX, rs))
    out = torch.where(t >= EXP_SAT_HI_Q16, _i32(_RAW_MAX, out), out)
    return torch.where(t <= EXP_FLUSH_LO_Q16, torch.zeros_like(out), out)


def log_q16_body(w_q, stages: int = HYPER_STAGES):
    """Hyperbolic-vectoring natural log on Q16.16: ln w = 2*atanh((u-1)/
    (u+1)) + k*ln2 for u = w*2**-k in [1, 2); w <= 0 returns Q16.16 min."""
    w = _clamp_raw(w_q)
    b = _ilog2(torch.clamp_min(w, 1))
    k = b - 16
    u = _shift_signed(w, k)
    u29 = u << (_HFRAC - 16)
    one29 = 1 << _HFRAC
    _, _, z = _hyper_vectoring(u29 + one29, u29 - one29, torch.zeros_like(u29), stages)
    lnu = (z + (1 << (_HFRAC - 18))) >> (_HFRAC - 17)
    return torch.where(w <= 0, _i32(_RAW_MIN, w), lnu + k * LN2_Q16)


def tanh_q16_body(t_q: torch.Tensor, stages: int = HYPER_STAGES):
    """tanh on Q16.16: sinh/cosh + linear divide for |t| <= 1, the
    ``exp_q16_body`` tail (1 - e^-2|t|)/(1 + e^-2|t|) beyond."""
    t = _clamp_raw(t_q)
    at = t.abs()
    k_h_inv = hyper_gain_inverse(hyperbolic_schedule(stages), _HFRAC)
    ts = torch.clamp_max(at, _U16)
    x, y, _ = _hyper_rotation(_i32(k_h_inv, t), torch.zeros_like(t), ts << (_HFRAC - 16), stages)
    near = _linear_div_q16(y >> (_HFRAC - 16), torch.clamp_min(x >> (_HFRAC - 16), 1))
    a2 = torch.clamp_max(at, -EXP_FLUSH_LO_Q16)
    e = exp_q16_body(-(a2 << 1), stages)
    far = _linear_div_q16(_U16 - e, _U16 + e)
    mag = torch.clamp_max(torch.where(at <= _U16, near, far), _U16)
    return torch.where(t < 0, -mag, mag)


def sigmoid_q16_body(t_q: torch.Tensor, stages: int = HYPER_STAGES):
    """sigmoid(t) = (1 + tanh(t/2)) / 2 on Q16.16."""
    t = _clamp_raw(t_q)
    th = tanh_q16_body(t >> 1, stages)
    return (th + (_U16 + 1)) >> 1


# ---------------------------------------------------------------------------
# exact long-context RoPE phase
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def rope_inv_freq_q64(head_dim: int, base: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair rotary frequency as a Q0.64 fraction of a turn, as
    (hi, lo) uint32 limbs of ``round(base**(-2j/d) / (2*pi) * 2**64)``."""
    half = head_dim // 2
    hi = np.zeros((half,), np.uint32)
    lo = np.zeros((half,), np.uint32)
    for j in range(half):
        turns = (base ** (-2.0 * j / head_dim)) / (2.0 * math.pi)
        q = min(int(round(turns * float(1 << 64))), (1 << 64) - 1)
        hi[j] = (q >> 32) & _M32
        lo[j] = q & _M32
    return hi, lo


def _mulhi_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High word of the unsigned 32x32 -> 64 product; operands are int64
    tensors holding uint32 values (16-bit split keeps int64 exact)."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    return (a * b_hi + ((a * b_lo) >> 16)) >> 16


def _mullo_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low word (mod 2**32) of the unsigned 32x32 product."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    return (a_lo * b + (((a_hi * b) & 0xFFFF) << 16)) & _M32


def exact_rope_phase_q16(positions, f_hi, f_lo) -> torch.Tensor:
    """``(pos * f) mod 1`` turn, exactly, scaled to Q16.16 radians.

    ``positions`` (any int dtype, values < 2**32 after the uint32 cast)
    and the uint32 frequency limbs broadcast against each other.  In
    int64 masked to 32 bits: the high word of ``pos * f_lo`` plus
    ``pos * f_hi mod 2**32`` is the Q0.32 turn, multiplied by 2*pi in
    Q16.16 and rounded on bit 31.
    """
    pos = torch.as_tensor(positions).to(torch.int64) & _M32
    f_hi = torch.as_tensor(f_hi).to(torch.int64).to(pos.device) & _M32
    f_lo = torch.as_tensor(f_lo).to(torch.int64).to(pos.device) & _M32
    frac_hi = (_mullo_u32(pos, f_hi) + _mulhi_u32(pos, f_lo)) & _M32
    t = frac_hi * TWO_PI_Q16  # < 2**51, exact in int64
    theta = ((t >> 32) + ((t >> 31) & 1)) & _M32
    return theta.to(torch.int32)
