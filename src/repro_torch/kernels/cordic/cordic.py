"""K3: rotation-mode CORDIC sincos on int32 Q(m.n) angles.

Replaces the Pallas TPU kernel ``src/repro/kernels/cordic/cordic.py::
_kernel`` (launched by ``cordic_kernel_call``); the CUDA source is
``kernels/csrc/cordic.cu``.  Floor-mod reduction to [-pi, pi), fold to
[-pi/2, pi/2] with a sign flip of both outputs, then ``iterations``
shift-add steps from ``x0 = K^-1`` with the atan table in the kernel's
parameter bank (16 iterations in Q16.16 as on the TPU; the same kernel
takes the Q8.24 rung's 24).

Two wrappers over the one kernel, each with its own launch count:

* :func:`cordic_sincos` — elementwise on given angles;
* :func:`rope_sincos_q16` — the FAST RoPE tables: the exact phase step
  (``core.cordic.exact_rope_phase_q16``) fused in front, so positions go
  in and the Q16.16 sin/cos tables come out in one launch.

On the H100 the kernel is bound by neither bytes (12 B per element) nor
integer operations (~100 per element) at RoPE sizes; it is one small
launch per layer.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.compat import (check_launch, current_stream, dtensor_local, from_local,
                                is_dtensor, kernel_function, meta_kernel, ptr,
                                settled_placements)
from repro_torch.core.cordic import (
    angle_consts,
    atan_table,
    cordic_sincos_q16,
    exact_rope_phase_q16,
    gain_inverse,
    rope_inv_freq_q64,
)

__all__ = [
    "cordic_sincos",
    "cordic_sincos_plain",
    "rope_sincos_q16",
    "rope_sincos_plain",
    "rope_freq_limbs",
]


def cordic_sincos_plain(theta_q, iterations: int = 16, frac_bits: int = 16):
    """The plain PyTorch version of K3 (any device)."""
    return cordic_sincos_q16(theta_q, iterations=iterations, frac_bits=frac_bits)


@functools.lru_cache(maxsize=None)
def rope_freq_limbs(rope_dim: int, base: float):
    """The Q0.64 turn frequencies as two int64 arrays of uint32 values."""
    hi, lo = rope_inv_freq_q64(rope_dim, base)
    return hi.astype(np.int64), lo.astype(np.int64)


def rope_sincos_plain(positions, rope_dim: int, base: float = 10000.0):
    """Plain RoPE tables: exact phase, then CORDIC; (…) int positions ->
    (…, rope_dim//2) Q16.16 int32 sin, cos."""
    hi, lo = rope_freq_limbs(rope_dim, float(base))
    dev = positions.device
    theta = exact_rope_phase_q16(
        positions[..., None], torch.from_numpy(hi).to(dev)[None, :],
        torch.from_numpy(lo).to(dev)[None, :],
    )
    return cordic_sincos_q16(theta)


_P, _I = ctypes.c_void_p, ctypes.c_int
#: repro_cordic_sincos(theta, pos, fhi, flo, half, n, sin, cos, table,
#:                     iterations, k_inv, pi, half_pi, two_pi, stream)
_ARGTYPES = (_P, _P, _P, _P, _I, ctypes.c_longlong, _P, _P, ctypes.POINTER(ctypes.c_int32),
             _I, _I, _I, _I, _I, _P)


def _params(iterations: int, frac_bits: int):
    if not 0 <= iterations <= 32:
        raise ValueError(f"cordic: iterations {iterations} outside [0, 32]")
    table = (ctypes.c_int32 * max(iterations, 1))(*[int(v) for v in atan_table(iterations, frac_bits)])
    pi, half_pi, two_pi = angle_consts(frac_bits)
    return table, gain_inverse(iterations, frac_bits), pi, half_pi, two_pi


def _launch(theta, pos, fhi, flo, half, n, sin_q, cos_q, iterations, frac_bits, like):
    table, k_inv, pi, half_pi, two_pi = _params(iterations, frac_bits)
    rc = kernel_function("cordic", "repro_cordic_sincos", _ARGTYPES)(
        ptr(theta), ptr(pos), ptr(fhi), ptr(flo), half, n, ptr(sin_q), ptr(cos_q), table,
        iterations, k_inv, pi, half_pi, two_pi, current_stream(like),
    )
    check_launch("cordic", rc, "cordic_sincos")


def cordic_sincos(theta_q: torch.Tensor, iterations: int = 16, frac_bits: int = 16):
    """int32 Q(m.n) angles of any shape -> (sin, cos) int32 via K3."""
    if theta_q.dtype != torch.int32:
        raise TypeError(f"cordic_sincos: int32 angles required, got {theta_q.dtype}")
    if theta_q.device.type == "cpu":
        return cordic_sincos_plain(theta_q, iterations, frac_bits)
    if theta_q.device.type != "cuda":
        raise ValueError(f"cordic_sincos: unsupported device {theta_q.device}")
    if not theta_q.is_contiguous():
        raise ValueError("cordic_sincos: theta_q must be contiguous")
    sin_q = torch.empty_like(theta_q)
    cos_q = torch.empty_like(theta_q)
    if theta_q.numel():
        _launch(theta_q, None, None, None, 1, theta_q.numel(), sin_q, cos_q,
                iterations, frac_bits, theta_q)
        cordic_sincos.launches += 1
    return sin_q, cos_q


cordic_sincos.launches = 0


@functools.lru_cache(maxsize=None)
def _device_limbs(rope_dim: int, base: float, device: torch.device):
    hi, lo = rope_freq_limbs(rope_dim, base)
    # uint32 bit patterns carried in int32 storage for the kernel
    return (torch.from_numpy(hi.astype(np.uint32).view(np.int32)).to(device),
            torch.from_numpy(lo.astype(np.uint32).view(np.int32)).to(device))


def rope_sincos_q16(positions: torch.Tensor, rope_dim: int, base: float = 10000.0):
    """(…) int32 positions -> (…, rope_dim//2) Q16.16 int32 (sin, cos)
    through K3 with the exact phase step fused in."""
    if is_dtensor(positions):
        # elementwise in the positions: the local shards' tables
        pl = settled_placements(positions)
        tables = rope_sincos_q16(dtensor_local(positions, pl), rope_dim, base)
        return tuple(from_local(t, positions.device_mesh, pl) for t in tables)
    if positions.dtype != torch.int32:
        raise TypeError(f"rope_sincos_q16: int32 positions required, got {positions.dtype}")
    if positions.device.type == "cpu":
        return rope_sincos_plain(positions, rope_dim, base)
    if positions.device.type == "meta":
        n = positions.numel() * (rope_dim // 2)
        shape = tuple(positions.shape) + (rope_dim // 2,)
        out = tuple(torch.empty(shape, dtype=torch.int32, device="meta") for _ in range(2))
        # K3's RoPE form: the fused phase, the range reduction, 16 steps
        # and the sign flips a table entry (chip_smoke.py's k3_ops)
        return meta_kernel("rope_sincos_q16", (12 + 8 + 16 * 6 + 2) * n,
                           4 * positions.numel() + 4 * rope_dim + 8 * n, out)
    if positions.device.type != "cuda":
        raise ValueError(f"rope_sincos_q16: unsupported device {positions.device}")
    if not positions.is_contiguous():
        raise ValueError("rope_sincos_q16: positions must be contiguous")
    half = rope_dim // 2
    fhi, flo = _device_limbs(rope_dim, float(base), positions.device)
    shape = tuple(positions.shape) + (half,)
    sin_q = torch.empty(shape, dtype=torch.int32, device=positions.device)
    cos_q = torch.empty_like(sin_q)
    n = positions.numel() * half
    if n:
        _launch(None, positions, fhi, flo, half, n, sin_q, cos_q, 16, 16, positions)
        rope_sincos_q16.launches += 1
    return sin_q, cos_q


rope_sincos_q16.launches = 0
