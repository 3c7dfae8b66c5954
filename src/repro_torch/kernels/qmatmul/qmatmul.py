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

:func:`qmatmul_grouped` is the same contract for G products of one
shape in one launch — ``a_q`` (G, M, K), ``b_q`` (G, K, N), one
``ea``, ``eb`` (G, N) — the MoE experts' down projection, which the
reference computes as an XLA batched dot
(``src/repro/models/moe.py::_fused_expert_mlp``; not a TPU kernel).
The kernel is K1's with the group as ``blockIdx.z``; :func:`qmatmul` is
its one-group case.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.compat import (check_launch, current_stream, dtensor_local, from_local,
                                is_dtensor, kernel_function, meta_kernel, ptr)

__all__ = ["EPILOGUES", "qmatmul", "qmatmul_plain", "qmatmul_grouped", "MAX_K"]

EPILOGUES = ("float", "q16", "int32")
_P, _I = ctypes.c_void_p, ctypes.c_int
#: repro_qmatmul(A, B, ea, eb, out, G, M, N, K, mode, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
#: int32 accumulation of int8 products is exact up to this depth
MAX_K = 1 << 17


def _acc_exact(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 product as int64: every partial sum is an integer
    below 2**53, so a float64 matmul is exact in any summation order
    (and runs on the card, where integer matmuls do not).  3-D operands
    multiply group by group."""
    return (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(torch.int64)


def _epilogue_plain(acc: torch.Tensor, e: torch.Tensor, epilogue: str) -> torch.Tensor:
    """``acc`` int32 (..., M, N), ``e`` int32 broadcastable against it."""
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
    """The plain PyTorch version of K1 (same contract, any device).  With
    a leading group axis — (G, M, K) x (G, K, N), ``eb`` (G, N) — it is
    :func:`qmatmul_grouped`'s, group by group."""
    acc = _acc_exact(a_q, b_q).to(torch.int32)  # wraps like the int32 accumulator
    N = b_q.shape[-1]
    e = ea.to(torch.int32).reshape(()) + eb.to(torch.int32).reshape(b_q.shape[:-2] + (1, N))
    return _epilogue_plain(acc, e, epilogue)


def product_placements(a, b):
    """Placements, per mesh dimension, under which a (G, M, K) x (G, K, N)
    product of DTensors runs on the local shards: the contraction K
    replicated, the groups sharded on both operands or neither, and a
    mesh dimension that would shard both the rows M and the columns N
    gathers the rows (activations, not weights).  Returns (a's, b's,
    the output's)."""
    from torch.distributed.tensor import Replicate, Shard

    pa, pb, po = [], [], []
    for x, y in zip(a.placements, b.placements):
        xs = x.dim if x.is_shard() and x.dim != 2 else None
        ys = y.dim if y.is_shard() and y.dim != 1 else None
        if xs == 0 or ys == 0:
            xs = ys = 0
        elif xs == 1 and ys == 2:
            xs = None
        pa.append(Replicate() if xs is None else Shard(xs))
        pb.append(Replicate() if ys is None else Shard(ys))
        po.append(Replicate() if xs is None and ys is None else Shard(ys if xs is None else xs))
    return pa, pb, po


def column_placements(pb):
    """Placements of (G, N) per-column exponents for a (G, K, N) operand
    placed as ``pb``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2) else Replicate()
            for p in pb]


def local_part(t, placements):
    """A DTensor's local shard under ``placements`` (a plain tensor is
    taken as replicated)."""
    return dtensor_local(t, placements) if is_dtensor(t) else t


def _run(wrapper, a_q, b_q, ea, eb, epilogue):
    """Check a (G, M, K) x (G, K, N) product and run it: the plain
    version for a CPU tensor, ONE K1 launch for all G groups for a CUDA
    tensor (counted on ``wrapper.launches``), the contract's cost for a
    ``meta`` tensor, the local shards' product for DTensors, or raise."""
    if is_dtensor(a_q):
        from torch.distributed.tensor import Replicate

        pa, pb, po = product_placements(a_q, b_q)
        out = _run(wrapper, local_part(a_q, pa), local_part(b_q, pb),
                   local_part(ea, [Replicate()] * len(pa)),
                   local_part(eb, column_placements(pb)), epilogue)
        return from_local(out, a_q.device_mesh, po)
    name = wrapper.__name__
    if epilogue not in EPILOGUES:
        raise ValueError(f"{name}: epilogue {epilogue!r} not in {EPILOGUES}")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"{name}: int8 operands required, got {a_q.dtype} x {b_q.dtype}")
    if a_q.ndim != 3 or b_q.ndim != 3 or a_q.shape[0] != b_q.shape[0] \
            or a_q.shape[2] != b_q.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(a_q.shape)} x {tuple(b_q.shape)}")
    G, M, K = a_q.shape
    N = b_q.shape[2]
    if K > MAX_K:
        raise ValueError(f"{name}: K={K} > 2**17, int32 accumulation would not be exact")
    if ea.numel() != 1 or tuple(eb.shape) != (G, N):
        raise ValueError(f"{name}: exponents {tuple(ea.shape)}, {tuple(eb.shape)} for "
                         f"(G, N) = ({G}, {N})")
    devs = {t.device for t in (a_q, b_q, ea, eb)}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {devs}")
    if a_q.device.type == "cpu":
        return qmatmul_plain(a_q, b_q, ea, eb, epilogue)
    if a_q.device.type == "meta":
        out = torch.empty((G, M, N), dtype=torch.float32 if epilogue == "float" else torch.int32,
                          device="meta")
        return meta_kernel(name, 2.0 * G * M * N * K,
                           G * (M * K + K * N + 4 * N) + 4 + 4 * G * M * N, out)
    if a_q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a_q.device}")
    for arg, t in (("a_q", a_q), ("b_q", b_q), ("eb", eb)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if ea.dtype != torch.int32 or eb.dtype != torch.int32:
        raise TypeError(f"{name}: int32 exponents required")
    if K % 4 or N % 4:
        raise ValueError(f"{name}: the kernel needs K and N multiples of 4 (K={K}, N={N})")
    out = torch.empty((G, M, N), dtype=torch.float32 if epilogue == "float" else torch.int32,
                      device=a_q.device)
    if G == 0 or M == 0 or N == 0:
        return out
    ea1 = ea.reshape(1).contiguous()
    rc = kernel_function("qmatmul", "repro_qmatmul", _ARGTYPES)(
        ptr(a_q), ptr(b_q), ptr(ea1), ptr(eb), ptr(out), G, M, N, K,
        EPILOGUES.index(epilogue), current_stream(a_q),
    )
    check_launch("qmatmul", rc, name)
    wrapper.launches += 1
    return out


def qmatmul(a_q: torch.Tensor, b_q: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor,
            epilogue: str = "float") -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) f32 or int32 through K1.

    ``ea``: per-tensor activation exponent (one int32 element);
    ``eb``: per-column weight exponents (N int32), both on the same
    device as the operands — the kernel reads them there, so no host
    synchronisation is needed.
    """
    if a_q.ndim != 2 or b_q.ndim != 2:
        raise ValueError(f"qmatmul: shapes {tuple(a_q.shape)} x {tuple(b_q.shape)}")
    return _run(qmatmul, a_q[None], b_q[None], ea, eb.reshape(1, eb.numel()), epilogue)[0]


qmatmul.launches = 0


def qmatmul_grouped(a_q: torch.Tensor, b_q: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor,
                    epilogue: str = "float") -> torch.Tensor:
    """(G, M, K) int8 x (G, K, N) int8 -> (G, M, N) f32 or int32: K1's
    contract for each group, one launch for all of them.  ``ea``: one
    int32 exponent shared by the groups; ``eb``: (G, N) int32."""
    return _run(qmatmul_grouped, a_q, b_q, ea, eb, epilogue)


qmatmul_grouped.launches = 0
