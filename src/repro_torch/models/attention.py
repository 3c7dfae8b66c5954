"""GQA attention for prefill, single-token decode and segment decode.

Reference: ``src/repro/models/attention.py`` — the GQA path only:
``attn_specs``, ``init_attn_cache``, ``reset_attn_cache_slot``,
``truncate_attn_cache_slot``, ``_prefill_cache`` and
``attention_forward`` for prefill, S == 1 decode and S > 1 segments
(the speculative verify and chunked prefill), with sliding windows
(rolling-buffer caches of ``window`` rows) and gemma2's attention-score
softcap.  Prefill attention runs kernel K4 (``kernels.flashattn``, the
function of ``chunked_attention``, score softcap included);
``decode_attention`` and ``decode_attention_multi`` stay plain PyTorch,
as the reference has no Pallas kernel for them.  Score capping is f32 on
every rung (the reference's policy).

MLA (minicpm3): ``mla_specs``, ``init_mla_cache``,
``reset_mla_cache_slot`` and ``mla_forward``.  The cache holds the
latent ``ckv`` (B, L, kv_lora_rank), the shared rotated key part
``krope`` (B, L, rope_dim) and ``pos``; prefill expands the latent to
per-head keys and values and runs K4 (D = nope + rope, Dv = v_head_dim,
as many kv heads as heads); decode and segments use the absorbed form
(scores and values in the latent space), plain PyTorch in f32 as in the
reference.  Rollback, truncation and the in-place rules are the GQA
cache's: the same ``pos`` sentinel, the same ``seg_aux`` rows.

The int8 KV cache (``init_attn_cache(quantized=True)``, the reference's
Q-format cache): int8 ``k`` / ``v`` payloads with an int32 power-of-two
exponent per (row, kv head) in ``k_exp`` / ``v_exp`` (B, L, KV),
quantized by :func:`_q8` (``core.quantization.quantize_pow2`` with kept
axes, the one grid definition).  Prefill still attends the pass's own
float k / v (K4) and stores them quantized; decode and segment
attention fold the exponents into the scores and the probabilities
(``decode_attention(k_exp=, v_exp=)``), as the reference does.

Caches are updated IN PLACE (the reference returns new arrays): a
prefill writes rows ``[0, S)`` of the cache it is given, a decode one
row per lane, a segment S rows per lane.  With ``lane_mask`` a decode
writes only member lanes and computes every non-member lane as the
reference's pristine masked view would — that lane attends to its own
fresh key alone, so its output is its fresh value row — without
materialising a masked copy of the pool.  A segment given ``seg_aux``
records there, before it writes, the rows it overwrites (``slot``
(B, S) and the old ``k``, ``v``, ``pos`` rows): the rollback state
``models.model.commit_segment`` restores rejected rows from, which the
reference keeps as a whole pre-segment copy of the cache.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.compat import gather_inner, resolve_device
from repro_torch.core.quantization import quantize_pow2
from repro_torch.kernels.flashattn import NEG_INF, flash_attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (Spec, apply_rope, attn_norm_spec, merge_heads,
                                       no_constrain, pdot, rms_norm, rope_tables, split_heads)

__all__ = [
    "attn_specs",
    "mla_specs",
    "attention_forward",
    "mla_forward",
    "decode_attention",
    "decode_attention_multi",
    "init_attn_cache",
    "init_mla_cache",
    "reset_attn_cache_slot",
    "reset_mla_cache_slot",
    "truncate_attn_cache_slot",
]


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "norm": attn_norm_spec(d),
        "wq": Spec((d, h * hd), ("embed", "heads")),
        "wk": Spec((d, kv * hd), ("embed", "kv")),
        "wv": Spec((d, kv * hd), ("embed", "kv")),
        "wo": Spec((h * hd, d), ("heads", "embed")),
    }


def mla_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "norm": attn_norm_spec(d),
        "wq_a": Spec((d, m.q_lora_rank), ("embed", None)),
        "q_norm": Spec((m.q_lora_rank,), (None,), init="zeros"),
        "wq_b": Spec((m.q_lora_rank, h * qk), (None, "heads")),
        "wkv_a": Spec((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None)),
        "kv_norm": Spec((m.kv_lora_rank,), (None,), init="zeros"),
        "wkv_b": Spec((m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
                      (None, "heads")),
        "wo": Spec((h * m.v_head_dim, d), ("heads", "embed")),
    }


def init_attn_cache(cfg: ModelConfig, layer: LayerSpec, batch: int, max_len: int,
                    dtype=torch.float32, device=None, quantized: bool = False) -> dict:
    """``quantized``: int8 k / v payloads with int32 ``k_exp`` / ``v_exp``
    (B, L, KV), one power-of-two exponent per row and kv head."""
    device = resolve_device(device)
    L = min(layer.window, max_len) if layer.window else max_len
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    pdt = torch.int8 if quantized else dtype
    out = {
        "k": torch.zeros((batch, L, kv, hd), dtype=pdt, device=device),
        "v": torch.zeros((batch, L, kv, hd), dtype=pdt, device=device),
        "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device),
    }
    if quantized:
        out["k_exp"] = torch.zeros((batch, L, kv), dtype=torch.int32, device=device)
        out["v_exp"] = torch.zeros((batch, L, kv), dtype=torch.int32, device=device)
    return out


def _q8(x: torch.Tensor, axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 KV-cache quantization on the pow2 grid: one exponent per kept
    slice, ``axes`` (head_dim) reduced.  Returns ``(int8 payload,
    exponents)`` with the reduced axes squeezed away (the cache's
    ``k_exp`` / ``v_exp`` layout)."""
    red = {a % x.ndim for a in axes}
    keep = tuple(i for i in range(x.ndim) if i not in red)
    qt = quantize_pow2(x, bits=8, axis=keep)
    return qt.q, qt.exp.reshape([x.shape[i] for i in keep])


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> dict:
    """Latent cache: ``ckv`` (B, L, kv_lora_rank), ``krope`` (B, L,
    rope_dim), ``pos`` (B, L) at -1."""
    device = resolve_device(device)
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def reset_attn_cache_slot(cache: dict, slot) -> dict:
    """Pristine fill of one batch slot, in place: payloads 0, the
    position sentinel -1 (so the next occupant cannot attend to the
    evicted request's rows)."""
    for k, v in cache.items():
        v[slot] = -1 if k == "pos" else 0
    return cache


#: the MLA cache's reset is the GQA one (latent payloads, the same sentinel)
reset_mla_cache_slot = reset_attn_cache_slot


def truncate_attn_cache_slot(cache: dict, slot, keep_pos) -> dict:
    """Truncate-to-position form of :func:`reset_attn_cache_slot`, in
    place: entries of ONE batch slot whose position is ``>= keep_pos``
    go back to the pristine fill (payloads 0, pos -1); entries below are
    untouched bit for bit.  A pristine fill equals the pre-write
    contents only while the rolling buffer has not wrapped; a wrapped
    rollback goes through ``models.model.commit_segment``."""
    slot = int(slot)
    drop = cache["pos"][slot] >= keep_pos                      # (L,)
    for k, v in cache.items():
        row = v[slot]
        mask = drop.reshape((-1,) + (1,) * (row.ndim - 1))
        row.masked_fill_(mask, -1 if k == "pos" else 0)
    return cache


def decode_attention(q, k_cache, v_cache, kp, *, q_position, window=None, cap=None,
                     k_exp=None, v_exp=None):
    """Single-token decode: q (B,1,H,D) vs cache (B,L,KV,D); kp (B,L)
    slot positions (-1 = unwritten).  Plain PyTorch, f32 scores, capped
    as ``cap * tanh(s / cap)`` before the mask when ``cap`` is given.
    An int8 cache's exponents (B,L,KV) scale the scores (``k_exp``) and
    the probabilities (``v_exp``) by powers of two."""
    B, _, H, Dq = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    # the reference multiplies by the scale in q's dtype (a weak-typed
    # Python float becomes bf16 on the FAST rung); the product of two
    # bf16 values is exact in f32, so one rounding to q's dtype follows
    scale = torch.tensor(1.0 / math.sqrt(Dq), dtype=q.dtype).item()
    qr = (q[:, 0] * scale).reshape(B, KV, G, Dq)
    s = torch.einsum("bkgd,blkd->bkgl", qr.to(torch.float32), k_cache.to(torch.float32))
    if k_exp is not None:
        s = s * torch.exp2(k_exp.to(torch.float32)).transpose(1, 2)[:, :, None, :]
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qp = q_position[:, None, None, None]
    kpb = kp[:, None, None, :]
    valid = (kpb >= 0) & (kpb <= qp)
    if window is not None:
        valid = valid & (kpb > qp - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_exp is not None:
        p = p * torch.exp2(v_exp.to(torch.float32)).transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bkgl,blkd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, -1).to(q.dtype)


def decode_attention_multi(q, k_cache, v_cache, kp, *, q_positions, window=None, cap=None,
                           k_exp=None, v_exp=None):
    """Segment decode: S queries against a cache (the speculative-verify
    / chunked-continuation path).  q (B,S,H,D) vs cache (B,L,KV,D); kp
    (B,L) slot positions (-1 = unwritten); q_positions (B,S).  Each query
    masks keys by its OWN position, so within-segment causality holds
    after the whole segment's k/v are in the cache.  Plain PyTorch, f32
    scores (q is scaled in f32, as the reference does here); ``k_exp`` /
    ``v_exp`` as in :func:`decode_attention`."""
    B, S, H, Dq = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qr = (q.to(torch.float32) * (1.0 / math.sqrt(Dq))).reshape(B, S, KV, G, Dq)
    s = torch.einsum("bskgd,blkd->bkgsl", qr, k_cache.to(torch.float32))
    if k_exp is not None:
        s = s * torch.exp2(k_exp.to(torch.float32)).transpose(1, 2)[:, :, None, None, :]
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qp = q_positions[:, None, None, :, None]                   # (B,1,1,S,1)
    kpb = kp[:, None, None, None, :]                           # (B,1,1,1,L)
    valid = (kpb >= 0) & (kpb <= qp)
    if window is not None:
        valid = valid & (kpb > qp - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_exp is not None:
        p = p * torch.exp2(v_exp.to(torch.float32)).transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bkgsl,blkd->bskgd", p, v_cache.to(torch.float32))
    return out.reshape(B, S, H, -1).to(q.dtype)


def _segment_attention(cache: dict, q, k, v, positions, layer: LayerSpec, cfg: ModelConfig,
                       seg_aux: Optional[dict]):
    """S > 1 tokens against the cache at explicit positions, in place
    (the reference's segment path).  Full attention writes all S rows,
    then scores the S queries in one batch; a sliding window interleaves
    store and query per position, so that a write that wraps the rolling
    buffer cannot hide a row an earlier query's window still covers.  An
    int8 cache stores each row quantized (:func:`_rows`)."""
    B, S = positions.shape
    L = cache["k"].shape[1]
    if S > L:
        raise ValueError(f"segment length {S} exceeds cache length {L}")
    slots = (positions % L).to(torch.long)                     # (B, S)
    lanes = torch.arange(B, device=positions.device)
    if seg_aux is not None:
        seg_aux["slot"] = slots
        for name in cache:
            seg_aux[name] = cache[name][lanes[:, None], slots]
    rows = _rows(cache, k, v, positions)
    exps = {"k_exp": cache.get("k_exp"), "v_exp": cache.get("v_exp")}

    if layer.window is None:
        # the S slots are distinct (S <= L consecutive positions), so one
        # scatter writes what S single-row stores would
        for name, new in rows.items():
            cache[name][lanes[:, None], slots] = new.to(cache[name].dtype)
        return decode_attention_multi(q, cache["k"], cache["v"], cache["pos"],
                                      q_positions=positions, cap=cfg.attn_softcap, **exps)
    outs = []
    for s_i in range(S):
        for name, new in rows.items():
            cache[name][lanes, slots[:, s_i]] = new[:, s_i].to(cache[name].dtype)
        outs.append(decode_attention(q[:, s_i:s_i + 1], cache["k"], cache["v"], cache["pos"],
                                     q_position=positions[:, s_i], window=layer.window,
                                     cap=cfg.attn_softcap, **exps))
    return torch.cat(outs, dim=1)


def _rows(cache: dict, k, v, positions) -> dict:
    """The cache rows of new k / v (B, S, KV, D) at ``positions`` (B, S):
    float payloads, or on an int8 cache the payloads and their
    per-(row, kv-head) exponents (quantizing each row alone, as the
    reference's one-row stores do, gives the same bits)."""
    if "k_exp" not in cache:
        return {"k": k, "v": v, "pos": positions}
    qk, ek = _q8(k, axes=(3,))
    qv, ev = _q8(v, axes=(3,))
    return {"k": qk, "v": qv, "pos": positions, "k_exp": ek, "v_exp": ev}


def _prefill_cache(cache: dict, k, v, positions, window) -> dict:
    """Write a prefill segment starting at position 0 into ``cache`` in
    place: rows [0, S) for full attention; for a sliding window the
    last ``L`` tokens, rolled so each lands at slot ``pos % L``.  An int8
    cache gets the rows quantized, with their exponents."""
    S = k.shape[1]
    L = cache["k"].shape[1]

    def place(buf, seg):
        seg = seg.to(buf.dtype)
        if window is None or L >= S:
            buf[:, :S] = seg
        else:
            buf.copy_(torch.roll(seg[:, S - L:], S % L, dims=1))

    for name, seg in _rows(cache, k, v, positions).items():
        place(cache[name], seg)
    return cache


def attention_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, layer: LayerSpec, *,
                      positions: torch.Tensor, mode: str = "precise", cache=None,
                      prefill: bool = False, lane_mask: Optional[torch.Tensor] = None,
                      rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      seg_aux: Optional[dict] = None, constrain=no_constrain):
    """x (B,S,d) -> (out, cache).  ``cache=None``: no cache (positions
    must be ``arange(S)``); ``prefill``: K4 attention + rows [0, S)
    written; S == 1: decode against the cache; S > 1: a segment at
    ``positions`` (B,S) against the cache, its overwritten rows recorded
    in ``seg_aux`` when given.  ``rope``: the (sin, cos) tables of
    ``positions`` at this rung, built once a pass by the model
    (``rope_tables(positions, cfg.head_dim, cfg.rope_base, mode)``);
    without them they are built here.  ``constrain``: the sharded cells'
    layout hook (``heads4d`` on the rotated q, k and v, as the
    reference's ``attention.py:356-358``)."""
    B, S, _ = x.shape
    h = gather_inner(rms_norm(x, params["norm"], cfg.rms_eps))
    hd = cfg.head_dim
    q = split_heads(pdot(h, params["wq"], mode, wq=params.get("wq_q")), cfg.n_heads, hd, constrain)
    k = split_heads(pdot(h, params["wk"], mode, wq=params.get("wk_q")), cfg.n_kv_heads, hd,
                    constrain)
    v = split_heads(pdot(h, params["wv"], mode, wq=params.get("wv_q")), cfg.n_kv_heads, hd,
                    constrain)

    sin, cos = rope if rope is not None else rope_tables(positions, cfg.head_dim, cfg.rope_base,
                                                         mode)
    q = constrain(apply_rope(q, sin, cos), "heads4d")
    k = constrain(apply_rope(k, sin, cos), "heads4d")
    v = constrain(v, "heads4d")

    if cache is None or prefill:
        out = flash_attention(q, k, v.contiguous(), causal=True, window=layer.window,
                              softcap=cfg.attn_softcap)
        if prefill:
            cache = _prefill_cache(cache, k, v, positions, layer.window)
    elif S == 1:
        L = cache["k"].shape[1]
        slot = (positions[:, 0] % L).to(torch.long)
        lanes = torch.arange(B, device=x.device)
        rows = _rows(cache, k, v, positions)
        for name, new in rows.items():
            buf = cache[name]
            new = new[:, 0].to(buf.dtype)
            if lane_mask is not None:
                # non-members keep their row (a select, not a boolean
                # index: no device-to-host sync)
                keep = lane_mask.to(torch.bool).reshape((B,) + (1,) * (new.ndim - 1))
                new = torch.where(keep, new, buf[lanes, slot])
            buf[lanes, slot] = new
        out = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                               q_position=positions[:, 0], window=layer.window,
                               cap=cfg.attn_softcap, k_exp=cache.get("k_exp"),
                               v_exp=cache.get("v_exp"))
        if lane_mask is not None:
            G = cfg.n_heads // cfg.n_kv_heads
            own = v
            if "v_exp" in rows:
                # its stored row, dequantized (p = 1 on it, an exact
                # power-of-two scale)
                own = rows["v"].to(torch.float32) * torch.exp2(
                    rows["v_exp"].to(torch.float32))[..., None]
            own = own.repeat_interleave(G, dim=2).to(out.dtype)
            out = torch.where(lane_mask.to(torch.bool)[:, None, None, None], out, own)
    else:
        out = _segment_attention(cache, q, k, v, positions, layer, cfg, seg_aux)

    out = pdot(merge_heads(out, constrain), params["wo"], mode,
               wq=params.get("wo_q"))
    return out, cache


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 latent attention)
# ---------------------------------------------------------------------------


def _mla_absorbed(q_nope, q_rope, ckv_c, kr_c, kp, positions, w_uk, w_uv):
    """Absorbed-form attention of S queries against the latent cache, each
    query masking keys by its own position: q_nope (B,S,H,nope), q_rope
    (B,S,H,rope), cache rows ckv_c (B,L,r), kr_c (B,L,rope), kp (B,L)
    -> (B,S,H,vd) f32."""
    f32 = torch.float32
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope.to(f32), w_uk.to(f32))
    s = torch.einsum("bshr,blr->bshl", q_eff, ckv_c.to(f32))
    s = s + torch.einsum("bshd,bld->bshl", q_rope.to(f32), kr_c.to(f32))
    # a true division, as the reference's (not a product by the reciprocal)
    s = s / torch.full((), math.sqrt(q_nope.shape[-1] + q_rope.shape[-1]), dtype=f32,
                       device=s.device)
    valid = (kp[:, None, None, :] >= 0) & (kp[:, None, None, :] <= positions[:, :, None, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bshl,blr->bshr", p, ckv_c.to(f32))
    return torch.einsum("bshr,rhd->bshd", o_lat, w_uv.to(f32))


def mla_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                mode: str = "precise", cache=None, prefill: bool = False,
                lane_mask: Optional[torch.Tensor] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                seg_aux: Optional[dict] = None, constrain=no_constrain):
    """Multi-head latent attention, x (B,S,d) -> (out, cache), with the
    cases and in-place rules of :func:`attention_forward`: prefill on K4
    (latent expanded to per-head keys of nope + rope dims and values of
    v_head_dim), decode and segments in the absorbed form.  ``rope``: the
    pass's (sin, cos) tables of ``cfg.rope_dim``."""
    B, S, _ = x.shape
    m = cfg.mla
    H = cfg.n_heads
    nope, rope_d, vd, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank

    h = gather_inner(rms_norm(x, params["norm"], cfg.rms_eps))
    q_lat = rms_norm(pdot(h, params["wq_a"], mode, wq=params.get("wq_a_q")), params["q_norm"],
                     cfg.rms_eps)
    q = split_heads(pdot(q_lat, params["wq_b"], mode, wq=params.get("wq_b_q")), H, nope + rope_d,
                    constrain)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = pdot(h, params["wkv_a"], mode, wq=params.get("wkv_a_q"))
    ckv = rms_norm(kv_a[..., :r], params["kv_norm"], cfg.rms_eps)
    k_rope = kv_a[..., r:]                          # (B,S,rope) shared across heads

    sin, cos = rope if rope is not None else rope_tables(positions, rope_d, cfg.rope_base, mode)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0]

    w_b = params["wkv_b"].reshape(r, H, nope + vd)
    w_uk, w_uv = w_b[..., :nope], w_b[..., nope:]
    f32 = torch.float32

    if cache is None or prefill:
        k_nope = torch.einsum("bsr,rhd->bshd", ckv.to(f32), w_uk.to(f32)).to(x.dtype)
        v = torch.einsum("bsr,rhd->bshd", ckv.to(f32), w_uv.to(f32)).to(x.dtype)
        k_rope_b = k_rope[:, :, None, :].expand(B, S, H, rope_d).to(x.dtype)
        k = constrain(torch.cat([k_nope, k_rope_b], dim=-1), "heads4d")
        v = constrain(v, "heads4d")
        q_full = constrain(torch.cat([q_nope, q_rope], dim=-1), "heads4d")
        out = flash_attention(q_full, k, v.contiguous(), causal=True)
        if prefill:
            for name, seg in (("ckv", ckv), ("krope", k_rope), ("pos", positions)):
                cache[name][:, :S] = seg.to(cache[name].dtype)
    else:
        L = cache["ckv"].shape[1]
        if S > L:
            raise ValueError(f"segment length {S} exceeds cache length {L}")
        slots = (positions % L).to(torch.long)                 # (B, S)
        lanes = torch.arange(B, device=x.device)
        if seg_aux is not None:
            seg_aux["slot"] = slots
            for name in cache:
                seg_aux[name] = cache[name][lanes[:, None], slots]
        rows = {"ckv": ckv, "krope": k_rope, "pos": positions}
        for name, new in rows.items():
            buf = cache[name]
            new = new.to(buf.dtype)
            if lane_mask is not None:
                # S == 1: non-members keep their row
                keep = lane_mask.to(torch.bool).reshape((B, 1) + (1,) * (new.ndim - 2))
                new = torch.where(keep, new, buf[lanes[:, None], slots])
            buf[lanes[:, None], slots] = new
        out = _mla_absorbed(q_nope, q_rope, cache["ckv"], cache["krope"], cache["pos"],
                            positions, w_uk, w_uv)
        if lane_mask is not None:
            # a non-member lane as the pristine view computes it: p = 1 on
            # its own fresh row, so its latent output is that row
            own = ckv.to(cache["ckv"].dtype).to(f32)[:, :, None, :].expand(B, S, H, r)
            own = torch.einsum("bshr,rhd->bshd", own, w_uv.to(f32))
            out = torch.where(lane_mask.to(torch.bool)[:, None, None, None], out, own)
        out = out.to(x.dtype)

    out = pdot(merge_heads(out, constrain), params["wo"], mode, wq=params.get("wo_q"))
    return out, cache
