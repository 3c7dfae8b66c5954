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

:func:`qmatmul_grouped` (G1) is the same contract for G products of one
shape in one launch — ``a_q`` (G, M, K), ``b_q`` (G, K, N), one
``ea``, ``eb`` (G, N) — the MoE experts' down projection, which the
reference computes as an XLA batched dot
(``src/repro/models/moe.py::_fused_expert_mlp``; not a TPU kernel), on
RAGGED groups: ``rows`` (G, L) int32 gives the live rows of each of L
lane blocks of C = M / L rows, row ``l*C + j`` of group g being live iff
``j < rows[g, l]`` (:func:`live_rows`).  A dead row reads as zero and
gets the zero accumulator's output; ``rows=None`` makes every row live.
The kernel (``csrc/grouped_gemm.cuh``) reads ``rows`` on the device and
runs only the live rows' tiles, persistent over the (group, column tile,
row tile) items that hold one.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.compat import (check_launch, current_stream, dtensor_local, from_local,
                                is_dtensor, kernel_function, meta_kernel, ptr, replicated_like)

__all__ = ["EPILOGUES", "qmatmul", "qmatmul_plain", "qmatmul_grouped", "MAX_K", "live_rows"]

EPILOGUES = ("float", "q16", "int32")
_P, _I = ctypes.c_void_p, ctypes.c_int
#: repro_qmatmul(A, B, ea, eb, out, G, M, N, K, mode, stream)
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
#: repro_qmatmul_grouped(A, B, ea, eb, out, rows, G, M, N, K, L, mode, stream)
_GROUPED_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
#: int32 accumulation of int8 products is exact up to this depth
MAX_K = 1 << 17


def live_rows(rows: torch.Tensor, m: int) -> torch.Tensor:
    """(G, M) bool: row ``l*C + j`` of group g is live iff ``j <
    rows[g, l]``, for ``rows`` (G, L) and C = M / L."""
    g, lanes = rows.shape
    j = torch.arange(m // lanes, device=rows.device)
    return (j < rows[:, :, None]).reshape(g, m)


def check_rows(name: str, rows, g: int, m: int, device) -> None:
    """Raise unless ``rows`` is a (G, L) int32 tensor on ``device`` with L
    dividing M (a grouped entry's ragged rows)."""
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32:
        raise TypeError(f"{name}: rows must be an int32 tensor, got "
                        f"{getattr(rows, 'dtype', type(rows).__name__)}")
    if rows.ndim != 2 or rows.shape[0] != g or rows.shape[1] < 1 or m % rows.shape[1]:
        raise ValueError(f"{name}: rows {tuple(rows.shape)} is not (G, L) with L dividing M "
                         f"for (G, M) = ({g}, {m})")
    if rows.device != device:
        raise ValueError(f"{name}: rows on {rows.device}, operands on {device}")


def zero_dead_rows(a_q: torch.Tensor, rows) -> torch.Tensor:
    """``a_q`` (G, M, K) with the rows that ``rows`` marks dead zeroed."""
    return torch.where(live_rows(rows, a_q.shape[1])[..., None], a_q, torch.zeros_like(a_q))


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


def qmatmul_plain(a_q, b_q, ea, eb, epilogue: str = "float", rows=None) -> torch.Tensor:
    """The plain PyTorch version of K1 (same contract, any device).  With
    a leading group axis — (G, M, K) x (G, K, N), ``eb`` (G, N) — it is
    :func:`qmatmul_grouped`'s, group by group, ``rows`` (G, L) zeroing
    the dead rows first (:func:`live_rows`)."""
    if rows is not None:
        check_rows("qmatmul_plain", rows, a_q.shape[0], a_q.shape[1], a_q.device)
        a_q = zero_dead_rows(a_q, rows)
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


def rows_part(rows, a, pa):
    """The local (G, L) ``rows`` of the (G, M, K) operand ``a`` placed as
    ``pa``: sharded with its groups (the "expert" axis) or, where ``a``'s
    rows M are sharded, with its lane blocks; a plain tensor is taken as
    replicated on ``a``'s mesh."""
    from torch.distributed.tensor import Replicate, Shard

    if rows is None:
        return None
    if not is_dtensor(rows):
        rows = replicated_like(a, rows)
    return dtensor_local(rows, [p if p in (Shard(0), Shard(1)) else Replicate() for p in pa])


def _run(wrapper, a_q, b_q, ea, eb, epilogue, rows=None):
    """Check a (G, M, K) x (G, K, N) product and run it: the plain
    version for a CPU tensor, ONE launch for all G groups for a CUDA
    tensor (K1's tiles for :func:`qmatmul`, the ragged grouped kernel for
    :func:`qmatmul_grouped`; counted on ``wrapper.launches``), the
    contract's cost for a ``meta`` tensor (every row live: the counts are
    unknown there), the local shards' product for DTensors, or raise."""
    if is_dtensor(a_q):
        from torch.distributed.tensor import Replicate

        pa, pb, po = product_placements(a_q, b_q)
        out = _run(wrapper, local_part(a_q, pa), local_part(b_q, pb),
                   local_part(ea, [Replicate()] * len(pa)),
                   local_part(eb, column_placements(pb)), epilogue, rows_part(rows, a_q, pa))
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
    if rows is not None:
        check_rows(name, rows, G, M, a_q.device)
    if a_q.device.type == "cpu":
        return qmatmul_plain(a_q, b_q, ea, eb, epilogue, rows)
    if a_q.device.type == "meta":
        out = torch.empty((G, M, N), dtype=torch.float32 if epilogue == "float" else torch.int32,
                          device="meta")
        return meta_kernel(name, 2.0 * G * M * N * K,
                           G * (M * K + K * N + 4 * N) + 4 + 4 * G * M * N, out)
    if a_q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a_q.device}")
    for arg, t in (("a_q", a_q), ("b_q", b_q), ("eb", eb), ("rows", rows)):
        if t is not None and not t.is_contiguous():
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
    if wrapper is qmatmul_grouped:
        rc = kernel_function("qmatmul", "repro_qmatmul_grouped", _GROUPED_ARGTYPES)(
            ptr(a_q), ptr(b_q), ptr(ea1), ptr(eb), ptr(out), ptr(rows), G, M, N, K,
            1 if rows is None else rows.shape[1], EPILOGUES.index(epilogue), current_stream(a_q),
        )
    else:
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
                    epilogue: str = "float", *, rows: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(G, M, K) int8 x (G, K, N) int8 -> (G, M, N) f32 or int32: K1's
    contract for each group, one launch for all of them.  ``ea``: one
    int32 exponent shared by the groups; ``eb``: (G, N) int32; ``rows``:
    (G, L) int32 live rows of each lane block (None: every row live)."""
    return _run(qmatmul_grouped, a_q, b_q, ea, eb, epilogue, rows)


qmatmul_grouped.launches = 0
