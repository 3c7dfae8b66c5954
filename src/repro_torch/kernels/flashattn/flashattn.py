"""K4: flash-attention forward (online softmax), f32 or bf16, GQA.

Replaces the Pallas TPU kernel ``src/repro/kernels/flashattn/
flashattn.py::_kernel`` (launched by ``flash_attention_call``); the CUDA
source is ``kernels/csrc/flashattn.cu``.  It computes the function the
serving path runs, ``src/repro/models/attention.py::chunked_attention``
with keys from position 0 and ``q_positions = arange(S)``: q pre-scaled
by ``D**-0.5`` and rounded to q's dtype, f32 scores, the optional score
softcap ``cap * tanh(s / cap)`` (gemma2; in f32, before the mask, where
``chunked_attention(cap=...)`` applies it), -1e30 masks, the
running max / denominator / accumulator in f32 with ``p`` cast to v's
dtype before P.V, and one normalisation by ``max(l, 1e-30)``.

Padded keys are masked by ``k_pos < Skv``; the reference kernel's
padding hazard (a non-causal call with ragged Skv turning causal,
``flashattn.py:114-120``) is not copied.  GQA maps head ``h`` to kv head
``h // (H // KV)``; K and V are never repeated.  Head widths up to 256
(deepseek-7b 128, gemma2-2b 256).

On the H100 prefill attention is bound by operations (2*S*Skv*D per
head for each product, about half of it under the causal mask).  The
bf16 path (the ``q16_16`` rung) runs both products on the tensor cores,
as the TPU kernel runs them on its matrix unit: ``mma.sync`` bf16 tiles
with f32 accumulators, bf16 Q/K/V tiles in shared memory fed by a
two-stage ``cp.async`` ring, scores, softcap, masks and the online
softmax in registers, and p rounded to bf16 in registers as the A
operand of P.V; key tiles that the causal mask or the sliding window
hide from a whole query block are skipped.  The f32 path (the exact
rung) stays on CUDA-core FFMA, without TF32 or any tensor-core
instruction: both products are register-blocked outer products as in an
SGEMM, each lane a 4- or 8-row strip of a warp's 8 or 16 query rows,
with Q and K d-major and V row-major in shared memory so that one
128-bit load gives four operands, and K and V loads by ``cp.async``
overlapping the products.

Training differentiates it through :class:`FlashAttentionFn`: the
forward is K4 (its plain version on a CPU tensor), the backward
:func:`flash_attention_backward`, the gradient of ``chunked_attention``
written out in PyTorch, chunk by chunk over the keys.  The reference has
no backward kernel (XLA differentiates its scan), so this backward is
not a plain version of a kernel.  :func:`flash_attention` enters the
Function only when autograd records; a serving pass launches K4 bare.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.compat import (check_launch, current_stream, dtensor_local, from_local,
                                is_dtensor, kernel_function, meta_kernel, ptr)

__all__ = ["KEY_TILE", "NEG_INF", "FlashAttentionFn", "bf16_close", "flash_attention",
           "flash_attention_backward", "flash_attention_plain", "p_rounding_case"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: repro_flash_attention(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale,
#:                       causal, window, softcap, dtype, stream)
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, ctypes.c_float,
             _I, _P)
#: the kernel's widest head (its shared-memory tiles)
MAX_HEAD_DIM = 256
#: keys per tile of the bf16 kernel by head-width class: head widths up to
#: 128 take 64-key tiles, wider heads (to 256) 32-key tiles
KEY_TILE = {128: 64, 256: 32}


def _chunk(Skv: int, chunk: int) -> int:
    """``chunked_attention``'s key-chunk size for ``Skv`` keys."""
    if Skv >= 32768:
        chunk = min(chunk, 128)
    elif Skv >= 16384:
        chunk = min(chunk, 512)
    return min(chunk, Skv)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None, chunk: int = 1024):
    """The plain PyTorch version: ``chunked_attention`` with keys from
    position 0 and queries at ``arange(S)``.  q (B,S,H,Dq), k (B,Skv,KV,Dq),
    v (B,Skv,KV,Dv) -> (B,S,H,Dv) in q's dtype."""
    B, S, H, Dq = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(Dq)
    chunk = _chunk(Skv, chunk)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qr = (q.to(torch.float32) * scale).to(q.dtype).reshape(B, S, KV, G, Dq).to(torch.float32)
    qp = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, Dv), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        k_blk = k[:, c * chunk:(c + 1) * chunk].to(torch.float32)
        v_blk = v[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bskgd,bckd->bkgsc", qr, k_blk)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kp = c * chunk + torch.arange(chunk, device=q.device)[None, :]
        valid = kp < Skv
        if causal:
            valid = valid & (kp <= qp)
        if window is not None:
            valid = valid & (kp > qp - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgsc,bckd->bkgsd", p.to(v.dtype).to(torch.float32),
                          v_blk.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dv).to(q.dtype)


def _scores(qr, k_blk, c0: int, S: int, causal: bool, window, softcap):
    """One key chunk's f32 scores of the pre-scaled queries ``qr``
    (B,S,KV,G,D) f32 against ``k_blk`` (B,C,KV,D): (capped, masked
    scores (B,KV,G,S,C), tanh(t / cap) or None, the mask)."""
    t = torch.einsum("bskgd,bckd->bkgsc", qr, k_blk.to(torch.float32))
    th = None
    if softcap is not None:
        th = torch.tanh(t / softcap)
        t = softcap * th
    qp = torch.arange(S, device=qr.device)[:, None]
    kp = c0 + torch.arange(k_blk.shape[1], device=qr.device)[None, :]
    valid = torch.ones_like(kp - qp, dtype=torch.bool)
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    return torch.where(valid, t, torch.full_like(t, NEG_INF)), th, valid


def flash_attention_backward(q, k, v, dout, *, causal: bool = True,
                             window: Optional[int] = None, softcap: Optional[float] = None,
                             chunk: int = 1024):
    """(dq, dk, dv) of ``chunked_attention`` (keys from position 0,
    queries at ``arange(S)``) for the output cotangent ``dout``
    (B,S,H,Dv), in f32 and cast to each operand's dtype.  Two passes over
    ``chunked_attention``'s key chunks: the first recomputes the row max,
    the softmax denominator and the f32 output (p rounded to v's dtype
    before P.V, as the forward), the second each chunk's normalised P,
    then dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO * O)) times the
    softcap's derivative ``1 - tanh(t / cap)^2``, dQ += dS K and
    dK = dS^T Q; dq carries the ``D**-0.5`` pre-scale (the rounding of
    the scaled q to its dtype passes the gradient straight through, as
    XLA's derivative of the cast does)."""
    B, S, H, Dq = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    f32 = torch.float32
    scale = 1.0 / math.sqrt(Dq)
    chunk = _chunk(Skv, chunk)
    qr = (q.to(f32) * scale).to(q.dtype).reshape(B, S, KV, G, Dq).to(f32)
    do = dout.to(f32).reshape(B, S, KV, G, Dv).permute(0, 2, 3, 1, 4)     # (B,KV,G,S,Dv)
    blocks = [(c0, min(c0 + chunk, Skv)) for c0 in range(0, Skv, chunk)]
    m = torch.full((B, KV, G, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=f32, device=q.device)
    acc = torch.zeros((B, KV, G, S, Dv), dtype=f32, device=q.device)
    for c0, c1 in blocks:
        s, _, _ = _scores(qr, k[:, c0:c1], c0, S, causal, window, softcap)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgsc,bckd->bkgsd", p.to(v.dtype).to(f32), v[:, c0:c1].to(f32))
        m = m_new
    inv_l = 1.0 / torch.clamp_min(l, 1e-30)
    delta = (do * (acc * inv_l[..., None])).sum(dim=-1)                  # (B,KV,G,S)
    dqr = torch.zeros((B, S, KV, G, Dq), dtype=f32, device=q.device)
    dk = torch.zeros((B, Skv, KV, Dq), dtype=f32, device=q.device)
    dv = torch.zeros((B, Skv, KV, Dv), dtype=f32, device=q.device)
    for c0, c1 in blocks:
        k_blk, v_blk = k[:, c0:c1].to(f32), v[:, c0:c1].to(f32)
        s, th, valid = _scores(qr, k_blk, c0, S, causal, window, softcap)
        p = torch.where(valid, torch.exp(s - m[..., None]) * inv_l[..., None],
                        torch.zeros_like(s))
        dv[:, c0:c1] = torch.einsum("bkgsc,bkgsd->bckd", p, do)
        ds = p * (torch.einsum("bkgsd,bckd->bkgsc", do, v_blk) - delta[..., None])
        if th is not None:
            ds = ds * (1.0 - th * th)
        dqr += torch.einsum("bkgsc,bckd->bskgd", ds, k_blk)
        dk[:, c0:c1] = torch.einsum("bkgsc,bskgd->bckd", ds, qr)
    dq = (dqr * scale).reshape(B, S, H, Dq).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """K4 forward, :func:`flash_attention_backward` backward (q, k and v
    saved; the softmax statistics are recomputed there)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap)
        return _flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        dq, dk, dv = flash_attention_backward(q, k, v, dout, causal=causal, window=window,
                                              softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, softcap: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,D), k (B,Skv,KV,D), v (B,Skv,KV,Dv) -> (B,S,H,Dv) through
    K4; ``softcap`` caps the scores as ``chunked_attention(cap=...)``.
    Differentiable (:class:`FlashAttentionFn`) when autograd records.
    DTensor operands run on their local shards (:func:`_sharded`)."""
    if is_dtensor(q):
        return _sharded(q, k, v, causal=causal, window=window, softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    return _flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)


def _sharded(q, k, v, **kw):
    """Attention of DTensor operands on their local shards: a mesh
    dimension keeps its placement where q, k and v share it and it shards
    the batch (dim 0) or the heads (dim 2; contiguous blocks keep the GQA
    map ``h // (H // KV)`` local), and is replicated first otherwise."""
    from torch.distributed.tensor import Replicate

    pl = []
    for a, b, c in zip(q.placements, k.placements, v.placements):
        keep = a == b == c and (a.is_replicate() or (a.is_shard() and a.dim in (0, 2)))
        pl.append(a if keep else Replicate())
    out = flash_attention(*(dtensor_local(t, pl) for t in (q, k, v)), **kw)
    return from_local(out, q.device_mesh, pl)


def causal_pairs(S: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the mask leaves: queries at ``arange(S)``, keys
    at ``arange(Skv)``."""
    if not causal:
        return S * Skv
    i = torch.arange(S, dtype=torch.int64)
    hi = torch.clamp_max(i, Skv - 1)
    lo = torch.clamp_min(i - window + 1, 0) if window else torch.zeros_like(i)
    return int(torch.clamp_min(hi - lo + 1, 0).sum())


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                     window: Optional[int], softcap: Optional[float]) -> torch.Tensor:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: 4-D (B, S, heads, dim) operands required")
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    if k.shape != (B, Skv, KV, D) or v.shape[:3] != (B, Skv, KV) or H % KV:
        raise ValueError(
            f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: f32 or bf16 operands of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: operands on several devices")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type == "meta":
        # the contract's work: 2 (D + Dv) operations a (query, key) pair
        # and head; q, k, v read once, the output written once
        esz = q.element_size()
        out = torch.empty((B, S, H, Dv), dtype=q.dtype, device="meta")
        return meta_kernel("flash_attention",
                           2.0 * B * H * causal_pairs(S, Skv, causal, window) * (D + Dv),
                           esz * B * (S * H * (D + Dv) + Skv * KV * (D + Dv)), out)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims up to {MAX_HEAD_DIM} (D={D}, Dv={Dv})")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be positive, got {softcap}")
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    if B * S * H == 0:
        return out
    rc = kernel_function("flashattn", "repro_flash_attention", _ARGTYPES)(
        ptr(q), ptr(k), ptr(v), ptr(out), B, S, H, Skv, KV, D, Dv, 1.0 / math.sqrt(D),
        int(causal), int(window) if window else 0, float(softcap) if softcap else 0.0,
        _DTYPES[q.dtype], current_stream(q),
    )
    check_launch("flashattn", rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """K4's bf16 tolerance against its plain version, scaled to the
    output: 2**-6 of each element's magnitude plus the rms of its output
    row (one query and head).  The kernel rounds p against the running
    max of its key tiles (:data:`KEY_TILE`: 64 keys at D <= 128, 32 at
    D = 256), the plain version against that of 1024-key chunks, so the
    two differ by up to a bf16 ulp of p per key before the output's own
    bf16 rounding; the plain version run at both chunk sizes on the CPU
    differed by at most 0.65 of this tolerance over ten draws
    (``tests/test_torch_kernels.py`` holds the kernel's tiles to it)."""
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    tol = 2.0 ** -6 * (want.abs() + rms)
    return bool(((got - want).abs() <= tol).all())


def p_rounding_case(device="cpu"):
    """bf16 (q, k, v) where rounding p to bf16 before P.V moves the
    output far past :func:`bf16_close`: key 0 scores 0 (the row max from
    the first tile on), the others score -0.6875 or -0.69140625, whose
    p = 0.5028 and 0.5009 round to 0.5039 and 0.5, and their values
    +-100 cancel.  A kernel that leaves p unrounded fails the tolerance
    by about 10x."""
    S, n, D = 64, 1000, 64
    q = torch.zeros(1, S, 1, D)
    q[..., 0] = math.sqrt(D)                       # q * D**-0.5 = e0 exactly
    k = torch.zeros(1, n + 1, 1, D)
    k[0, 1::2, 0, 0] = -0.6875
    k[0, 2::2, 0, 0] = -0.69140625
    v = torch.zeros(1, n + 1, 1, D)
    v[0, 0] = 100.0
    v[0, 1::2] = 100.0
    v[0, 2::2] = -100.0
    return tuple(t.to(device, torch.bfloat16) for t in (q, k, v))
