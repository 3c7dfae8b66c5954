"""K2: fused FAST SwiGLU hidden stage with ONE combined correction.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_mlp/
fused_mlp.py::_kernel`` (launched by ``fused_swiglu_kernel_call``); the
CUDA source is ``kernels/csrc/fused_mlp.cu``, whose epilogue shares the
CORDIC device functions of ``cordic.cuh`` with K3.

One int8 ``x`` tile feeds two exact int32 accumulators (``x @ Wg`` and
``x @ Wu``); the epilogue :func:`swiglu_body_q16` — saturating rounding
shift of the gate into Q16.16, the CORDIC ``sigmoid_q16_body``, then
``(acc_g * acc_u) * sig * 2**(e_g + e_u - 16)`` in f32 — runs in
registers.  The down-projection stays unfused (one more K1 call).

On the H100 the decode shapes are bound by reading Wg and Wu (bytes),
prefill by int8 operations; the CORDIC epilogue costs a few hundred
integer operations per output, far below either.

:func:`fused_swiglu_grouped` (G2) is the same contract for G hidden
stages of one shape in one launch — ``x_q`` (G, M, K), ``wg_q``/``wu_q``
(G, K, F), one ``ea``, ``eg``/``eu`` (G, F) — the MoE experts' gate and
up products with this epilogue, which the reference computes as XLA
batched dots and :func:`swiglu_body_q16` (``src/repro/models/moe.py::
_fused_expert_mlp``; not a TPU kernel), on ragged groups: ``rows`` (G,
L) as for ``qmatmul_grouped`` (a dead row reads as zero and gets the
zero accumulator's outputs).  Its kernel is ``csrc/grouped_gemm.cuh``'s
persistent tiles over the live rows, with the sigmoid taken 4 columns a
thread on one CORDIC schedule (``cordic.cuh::sigmoid_q16_n``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.compat import (check_launch, current_stream, from_local, is_dtensor,
                                kernel_function, meta_kernel, ptr)
from repro_torch.core.cordic import sigmoid_q16_body
from repro_torch.kernels.qmatmul.qmatmul import (MAX_K, _acc_exact, check_rows,
                                                column_placements, local_part, product_placements,
                                                rows_part, zero_dead_rows)

__all__ = ["swiglu_body_q16", "fused_swiglu", "fused_swiglu_plain", "fused_swiglu_grouped"]

_RAW_MAX = (1 << 31) - 1
_P, _I = ctypes.c_void_p, ctypes.c_int
#: repro_fused_swiglu(x, wg, wu, ea, eg, eu, out, gate, sig, G, M, F, K, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
#: repro_fused_swiglu_grouped(x, wg, wu, ea, eg, eu, out, gate, sig, rows, G, M, F, K, L, stream)
_GROUPED_ARGTYPES = (_P,) * 10 + (_I,) * 5 + (_P,)


def swiglu_body_q16(acc_g, acc_u, e_g, e_u, *, return_parts: bool = False):
    """The fused epilogue's element contract (reference:
    ``fused_mlp.swiglu_body_q16``), on int32 tensors."""
    acc_g = acc_g.to(torch.int32)
    acc_u = acc_u.to(torch.int32)
    e_g = e_g.to(torch.int32)
    e_u = e_u.to(torch.int32)
    s = (e_g + 16).expand_as(acc_g)
    sr = torch.clamp(-s, 0, 31)
    sl = torch.clamp(s, 0, 31)
    one = torch.ones_like(acc_g)
    half = torch.where(sr > 0, one << torch.clamp_min(sr - 1, 0), torch.zeros_like(acc_g))
    shifted_r = (acc_g + half) >> sr
    lim = torch.full_like(acc_g, _RAW_MAX) >> sl
    shifted_l = torch.where(
        acc_g > lim,
        torch.full_like(acc_g, _RAW_MAX),
        torch.where(acc_g < -lim, torch.full_like(acc_g, -_RAW_MAX), acc_g << sl),
    )
    gate_q16 = torch.where(s >= 0, shifted_l, shifted_r)
    sig = sigmoid_q16_body(gate_q16)
    comb = torch.exp2((e_g + e_u - 16).to(torch.float32))
    out = (acc_g.to(torch.float32) * acc_u.to(torch.float32)) * sig.to(torch.float32) * comb
    if return_parts:
        return out, gate_q16, sig
    return out


def fused_swiglu_plain(x_q, wg_q, wu_q, ea, eg, eu, *, return_parts: bool = False, rows=None):
    """The plain PyTorch version of K2 (any device).  With a leading group
    axis — ``x_q`` (G, M, K), ``wg_q``/``wu_q`` (G, K, F), ``eg``/``eu``
    (G, F) — it is :func:`fused_swiglu_grouped`'s, group by group,
    ``rows`` (G, L) zeroing the dead rows first."""
    if rows is not None:
        check_rows("fused_swiglu_plain", rows, x_q.shape[0], x_q.shape[1], x_q.device)
        x_q = zero_dead_rows(x_q, rows)
    acc_g = _acc_exact(x_q, wg_q).to(torch.int32)
    acc_u = _acc_exact(x_q, wu_q).to(torch.int32)
    ea = ea.to(torch.int32).reshape(())
    e_shape = wg_q.shape[:-2] + (1, wg_q.shape[-1])
    e_g = ea + eg.to(torch.int32).reshape(e_shape)
    e_u = ea + eu.to(torch.int32).reshape(e_shape)
    return swiglu_body_q16(acc_g, acc_u, e_g, e_u, return_parts=return_parts)


def _run(wrapper, x_q, wg_q, wu_q, ea, eg, eu, return_parts, rows=None):
    """Check G hidden stages — ``x_q`` (G, M, K), ``wg_q``/``wu_q`` (G, K,
    F), ``eg``/``eu`` (G, F), ``rows`` (G, L) or None — and run them: the
    plain version for a CPU tensor, ONE launch for all G groups for a
    CUDA tensor (K2's tiles for :func:`fused_swiglu`, the ragged grouped
    kernel for :func:`fused_swiglu_grouped`; counted on
    ``wrapper.launches``), the contract's cost for a ``meta`` tensor
    (every row live), the local shards' stages for DTensors
    (``qmatmul.product_placements``), or raise."""
    if is_dtensor(x_q):
        from torch.distributed.tensor import Replicate

        pa, pb, po = product_placements(x_q, wg_q)
        pe = column_placements(pb)
        out = _run(wrapper, local_part(x_q, pa), local_part(wg_q, pb), local_part(wu_q, pb),
                   local_part(ea, [Replicate()] * len(pa)), local_part(eg, pe),
                   local_part(eu, pe), return_parts, rows_part(rows, x_q, pa))
        mesh = x_q.device_mesh
        return (tuple(from_local(o, mesh, po) for o in out) if return_parts
                else from_local(out, mesh, po))
    name = wrapper.__name__
    if x_q.dtype != torch.int8 or wg_q.dtype != torch.int8 or wu_q.dtype != torch.int8:
        raise TypeError(f"{name}: int8 operands required")
    if x_q.ndim != 3 or wg_q.ndim != 3 or wg_q.shape != wu_q.shape \
            or x_q.shape[0] != wg_q.shape[0] or x_q.shape[2] != wg_q.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(x_q.shape)} x {tuple(wg_q.shape)} / "
                         f"{tuple(wu_q.shape)}")
    G, M, K = x_q.shape
    F = wg_q.shape[2]
    if K > MAX_K:
        raise ValueError(f"{name}: K={K} > 2**17, int32 accumulation would not be exact")
    if ea.numel() != 1 or tuple(eg.shape) != (G, F) or tuple(eu.shape) != (G, F):
        raise ValueError(f"{name}: exponent shapes do not match (G, F) = ({G}, {F})")
    if len({t.device for t in (x_q, wg_q, wu_q, ea, eg, eu)}) != 1:
        raise ValueError(f"{name}: operands on several devices")
    if rows is not None:
        check_rows(name, rows, G, M, x_q.device)
    if x_q.device.type == "cpu":
        return fused_swiglu_plain(x_q, wg_q, wu_q, ea, eg, eu, return_parts=return_parts,
                                  rows=rows)
    if x_q.device.type == "meta":
        outs = [torch.empty((G, M, F), dtype=dt, device="meta")
                for dt in ((torch.float32, torch.int32, torch.int32) if return_parts
                           else (torch.float32,))]
        return meta_kernel(name, 4.0 * G * M * F * K,
                           G * (M * K + 2 * K * F + 8 * F) + 4 + 4 * len(outs) * G * M * F,
                           tuple(outs) if return_parts else outs[0])
    if x_q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_q.device}")
    for arg, t in (("x_q", x_q), ("wg_q", wg_q), ("wu_q", wu_q), ("eg", eg), ("eu", eu),
                   ("rows", rows)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if any(t.dtype != torch.int32 for t in (ea, eg, eu)):
        raise TypeError(f"{name}: int32 exponents required")
    if K % 4 or F % 4:
        raise ValueError(f"{name}: the kernel needs K and F multiples of 4 (K={K}, F={F})")
    dev = x_q.device
    out = torch.empty((G, M, F), dtype=torch.float32, device=dev)
    gate = sig = None
    if return_parts:
        gate = torch.empty((G, M, F), dtype=torch.int32, device=dev)
        sig = torch.empty((G, M, F), dtype=torch.int32, device=dev)
    if G and M and F:
        ea1 = ea.reshape(1).contiguous()
        if wrapper is fused_swiglu_grouped:
            rc = kernel_function("fused_mlp", "repro_fused_swiglu_grouped", _GROUPED_ARGTYPES)(
                ptr(x_q), ptr(wg_q), ptr(wu_q), ptr(ea1), ptr(eg), ptr(eu), ptr(out),
                ptr(gate), ptr(sig), ptr(rows), G, M, F, K, 1 if rows is None else rows.shape[1],
                current_stream(x_q),
            )
        else:
            rc = kernel_function("fused_mlp", "repro_fused_swiglu", _ARGTYPES)(
                ptr(x_q), ptr(wg_q), ptr(wu_q), ptr(ea1), ptr(eg), ptr(eu),
                ptr(out), ptr(gate), ptr(sig), G, M, F, K, current_stream(x_q),
            )
        check_launch("fused_mlp", rc, name)
        wrapper.launches += 1
    return (out, gate, sig) if return_parts else out


def fused_swiglu(x_q: torch.Tensor, wg_q: torch.Tensor, wu_q: torch.Tensor, ea: torch.Tensor,
                 eg: torch.Tensor, eu: torch.Tensor, *, return_parts: bool = False):
    """x_q (M, K) int8, wg_q/wu_q (K, F) int8, ea one int32, eg/eu (F,)
    int32 -> (M, F) f32 ``silu(x@Wg) * (x@Wu)`` through K2 — or
    ``(out, gate_q16, sig)`` with ``return_parts``."""
    if x_q.ndim != 2 or wg_q.ndim != 2 or wu_q.ndim != 2:
        raise ValueError(
            f"fused_swiglu: shapes {tuple(x_q.shape)} x {tuple(wg_q.shape)} / {tuple(wu_q.shape)}")
    res = _run(fused_swiglu, x_q[None], wg_q[None], wu_q[None], ea,
               eg.reshape(1, eg.numel()), eu.reshape(1, eu.numel()), return_parts)
    if return_parts:
        return tuple(None if t is None else t[0] for t in res)
    return res[0]


fused_swiglu.launches = 0


def fused_swiglu_grouped(x_q: torch.Tensor, wg_q: torch.Tensor, wu_q: torch.Tensor,
                         ea: torch.Tensor, eg: torch.Tensor, eu: torch.Tensor, *,
                         return_parts: bool = False, rows: Optional[torch.Tensor] = None):
    """x_q (G, M, K) int8, wg_q/wu_q (G, K, F) int8, ea one int32, eg/eu
    (G, F) int32 -> (G, M, F) f32: K2's contract for each group, one
    launch for all of them — or ``(out, gate_q16, sig)`` with
    ``return_parts``.  ``rows``: (G, L) int32 live rows of each lane
    block (None: every row live)."""
    return _run(fused_swiglu_grouped, x_q, wg_q, wu_q, ea, eg, eu, return_parts, rows)


fused_swiglu_grouped.launches = 0
