"""Mamba-2 (SSD, state-space duality) mixer layer.

Reference: ``src/repro/models/ssm.py`` — ``ssm_specs``,
``init_ssm_cache``, ``reset_ssm_cache_slot``, ``_causal_depthwise_conv``,
``_ssd_chunked``, ``_ssd_segment`` and ``ssm_forward``.  The reference
computes the SSD in XLA, with no Pallas kernel, so it is plain PyTorch
here, with the reference's dtypes:

* the five input projections and the output projection go through
  ``pdot``: on the FAST rung they run K1 on the cached int8 weights;
* the depthwise conv's output is silu'd in f32 and stored bf16, except
  on ``"exact"``, which keeps f32 (the serving rung);
* the SSD (chunked dual form for prefill, the recurrence for decode and
  segments) runs in f32.

Jamba's mamba layers reuse this block with d_state 16.

Caches are updated IN PLACE, as the port's attention caches are
(``models.attention``): a prefill writes ``state`` and ``conv`` of every
lane it is given; a decode with ``lane_mask`` writes member lanes only
and computes each non-member lane from a pristine view (zero state, zero
conv carry), which is what the reference's ``mask_cache_view`` hands it:
a live state would otherwise move the FAST rung's per-tensor activation
exponents of the members.  A segment (S > 1 without ``prefill``) runs
the recurrence from the cached state and records in ``seg_aux`` the
reference's rollback candidates, ``states`` (B,S,nh,ds,hd) and
``conv_hist`` (B,K-1+S,conv_dim), and the pre-segment ``state`` and
``conv`` (the reference's ``before``, which it keeps as a whole copy of
the pool): ``models.model.commit_segment`` picks from them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compat import gather_inner, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec, attn_norm_spec, merge_heads, no_constrain, pdot, rms_norm

__all__ = ["ssm_specs", "ssm_forward", "init_ssm_cache", "reset_ssm_cache_slot"]


def ssm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.d_inner(d)
    nh = s.n_heads(d)
    gs = s.n_groups * s.d_state
    conv_dim = d_in + 2 * gs
    return {
        "norm": attn_norm_spec(d),
        "wz": Spec((d, d_in), ("embed", "ssm")),
        "wx": Spec((d, d_in), ("embed", "ssm")),
        "wB": Spec((d, gs), ("embed", None)),
        "wC": Spec((d, gs), ("embed", None)),
        "wdt": Spec((d, nh), ("embed", None)),
        "conv_w": Spec((s.d_conv, conv_dim), (None, "ssm"), scale=0.5),
        "conv_b": Spec((conv_dim,), ("ssm",), init="zeros"),
        "A_log": Spec((nh,), (None,), init="uniform", scale=1.0),
        "D": Spec((nh,), (None,), init="ones"),
        "dt_bias": Spec((nh,), (None,), init="zeros"),
        "out_norm": Spec((d_in,), ("ssm",), init="zeros"),
        "wo": Spec((d_in, d), ("ssm", "embed")),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    """Zero recurrent ``state`` (B, nh, d_state, head_dim) and conv
    history ``conv`` (B, d_conv - 1, conv_dim)."""
    device = resolve_device(device)
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "state": torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=dtype, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def reset_ssm_cache_slot(cache: dict, slot) -> dict:
    """Zero one batch slot of an SSM cache, in place (the evicted
    request's state and conv history must not reach the next occupant)."""
    for v in cache.values():
        v[slot] = 0
    return cache


def _causal_depthwise_conv(x, w, b, carry: Optional[torch.Tensor] = None):
    """x (B, S, C) with window w (K, C); ``carry`` (B, K-1, C) the
    history (decode, segment) or None (zero left-pad).  Returns
    ``(out, new_carry)``; the operands promote as the reference's do."""
    K = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(carry.dtype, x.dtype)
    xp = torch.cat([carry.to(dt), x.to(dt)], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_carry = xp[:, -(K - 1):] if K > 1 else carry
    return out + b, new_carry


def _ssd_chunked(x, dt, A, B_, C_, chunk: int, initial_state=None):
    """SSD dual form.  x (B,S,nh,hd), dt (B,S,nh) positive, A (nh,)
    negative, B_ / C_ (B,S,ds) (one group, broadcast to heads);
    ``initial_state`` (B,nh,ds,hd) or zeros.  Returns (y (B,S,nh,hd) f32,
    final state (B,nh,ds,hd) f32).  Within a chunk a masked quadratic
    product, across chunks the carried state, each chunk upcast to f32
    on its own."""
    Bb, S, nh, hd = x.shape
    ds = B_.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B_ = torch.nn.functional.pad(B_, (0, 0, 0, pad))
        C_ = torch.nn.functional.pad(C_, (0, 0, 0, pad))
    f32 = torch.float32
    A = A.to(f32)
    if initial_state is None:
        state = torch.zeros((Bb, nh, ds, hd), dtype=f32, device=x.device)
    else:
        state = initial_state.to(f32)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xb, dtb, Bc, Cc = (v[:, sl].to(f32) for v in (x, dt, B_, C_))
        dA = dtb * A                                             # (B,L,nh)
        l = torch.cumsum(dA, dim=1)
        # mask BEFORE exp: the upper triangle's log-differences are positive
        logdiff = l[:, :, None, :] - l[:, None, :, :]            # (B,L,L,nh)
        logdiff = torch.where(causal[None, :, :, None], logdiff,
                              torch.full_like(logdiff, -float("inf")))
        decay = torch.exp(logdiff)
        cb = torch.einsum("bid,bjd->bij", Cc, Bc)
        w = cb[..., None] * decay * dtb[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhd->bihd", w, xb)
        y_inter = torch.einsum("bid,bhdp,bih->bihp", Cc, state, torch.exp(l))
        total = l[:, -1, :]                                      # (B,nh)
        inj = torch.einsum("bjd,bjhp,bjh->bhdp", Bc, xb,
                           torch.exp(total[:, None, :] - l) * dtb)
        state = state * torch.exp(total)[:, :, None, None] + inj
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y[:, :S], state


def _ssd_segment(xs, dt, A, Bp, Cp, state0):
    """The recurrence over a short segment, one position at a time, with
    the state AFTER every position kept (the speculative rollback
    candidates): each state is the single-token decode's ``state * exp(dt
    A) + dt B x`` (:func:`_recurrence_step`), bit for bit.  The
    injections and decays of all positions are computed at once and the
    states written in place, so a position costs two launches.
    xs (B,S,nh,hd), dt (B,S,nh), Bp / Cp (B,S,ds), state0 (B,nh,ds,hd) ->
    (y (B,S,nh,hd) f32, states (B,S,nh,ds,hd) f32)."""
    dA = torch.exp(dt * A)                                       # (B,S,nh)
    states = _injection(Bp, xs, dt)                              # (B,S,nh,ds,hd)
    prev = state0
    for i in range(xs.shape[1]):
        states[:, i] += prev * dA[:, i, :, None, None]
        prev = states[:, i]
    return torch.einsum("bsd,bshdp->bshp", Cp.to(torch.float32), states), states


def _injection(Bv, x, dt):
    """dt B x^T in f32: Bv (..., ds), x (..., nh, hd), dt (..., nh) ->
    (..., nh, ds, hd)."""
    f32 = torch.float32
    xd = x.to(f32) * dt[..., None]
    return Bv.to(f32)[..., None, :, None] * xd[..., :, None, :]


def _recurrence_step(state, x, dt, A, Bv, Cv):
    """h = exp(dt A) h + dt B x; y = C h (all f32).  x (B,nh,hd), dt
    (B,nh), Bv / Cv (B,ds), state (B,nh,ds,hd)."""
    dA = torch.exp(dt * A[None, :])
    state = state * dA[:, :, None, None] + _injection(Bv, x, dt)
    return state, torch.einsum("bd,bhdp->bhp", Cv.to(torch.float32), state)


def ssm_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "precise",
                cache: Optional[dict] = None, prefill: bool = False,
                lane_mask: Optional[torch.Tensor] = None,
                seg_aux: Optional[dict] = None,
                constrain=no_constrain) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B,S,d) -> (out, cache).  ``cache=None`` or ``prefill``: the
    chunked dual form from a zero state (``prefill`` writes the final
    ``state`` and ``conv`` in place); S == 1: one recurrence step from the
    cached state (``lane_mask``: members only, see the module docstring);
    S > 1: a segment from the cached state, its rollback candidates in
    ``seg_aux`` when given."""
    B, S, d = x.shape
    s = cfg.ssm
    d_in = s.d_inner(d)
    nh = s.n_heads(d)
    gs = s.n_groups * s.d_state
    f32 = torch.float32

    h = gather_inner(rms_norm(x, params["norm"], cfg.rms_eps))
    z = pdot(h, params["wz"], mode, wq=params.get("wz_q"))
    xs = pdot(h, params["wx"], mode, wq=params.get("wx_q"))
    Bp = pdot(h, params["wB"], mode, wq=params.get("wB_q"))
    Cp = pdot(h, params["wC"], mode, wq=params.get("wC_q"))
    dt_raw = pdot(h, params["wdt"], mode, wq=params.get("wdt_q"))

    conv_in = torch.cat([xs, Bp, Cp], dim=-1)
    keep = None
    carry = None
    if cache is not None and not prefill:
        carry = cache["conv"]
        if lane_mask is not None:
            keep = lane_mask.to(torch.bool)
            carry = torch.where(keep[:, None, None], carry, torch.zeros_like(carry))
    conv_out, new_conv = _causal_depthwise_conv(conv_in, params["conv_w"], params["conv_b"],
                                                carry=carry)
    # silu in f32, stored bf16 off the exact rung (the reference's buffers)
    conv_dt = f32 if mode == "exact" else torch.bfloat16
    conv_out = torch.nn.functional.silu(conv_out.to(f32)).to(conv_dt)
    xs = constrain(conv_out[..., :d_in].reshape(B, S, nh, s.head_dim), "heads4d")
    Bp = conv_out[..., d_in:d_in + gs]
    Cp = conv_out[..., d_in + gs:]

    dt = torch.logaddexp(dt_raw.to(f32) + params["dt_bias"][None, None, :],
                         torch.zeros((), dtype=f32, device=x.device))
    A = -torch.exp(params["A_log"].to(f32))

    if cache is None or prefill:
        y, final_state = _ssd_chunked(xs, dt, A, Bp, Cp, chunk=s.chunk)
        if prefill:
            cache["state"].copy_(final_state)
            cache["conv"].copy_(new_conv)
    elif S == 1:
        state = cache["state"]
        if keep is not None:
            state = torch.where(keep[:, None, None, None], state, torch.zeros_like(state))
        state, y = _recurrence_step(state, xs[:, 0], dt[:, 0], A, Bp[:, 0], Cp[:, 0])
        y = y[:, None]                                           # (B,1,nh,hd)
        if keep is not None:
            state = torch.where(keep[:, None, None, None], state, cache["state"])
            new_conv = torch.where(keep[:, None, None], new_conv.to(cache["conv"].dtype),
                                   cache["conv"])
        cache["state"].copy_(state)
        cache["conv"].copy_(new_conv)
    else:
        y, states = _ssd_segment(xs.to(f32), dt, A, Bp.to(f32), Cp.to(f32),
                                 cache["state"].to(f32))
        if seg_aux is not None:
            seg_aux["states"] = states
            # carry ++ this segment's conv inputs: the carry after
            # accepting ``a`` positions is rows [a, a + K - 1)
            seg_aux["conv_hist"] = torch.cat([cache["conv"].to(conv_in.dtype), conv_in], dim=1)
            seg_aux["state"] = cache["state"].clone()
            seg_aux["conv"] = cache["conv"].clone()
        cache["state"].copy_(states[:, -1])
        cache["conv"].copy_(new_conv)

    y = y + xs.to(f32) * params["D"][None, None, :, None]
    y = merge_heads(y, constrain)
    y = y * torch.nn.functional.silu(z.to(f32))
    y = rms_norm(y.to(x.dtype), params["out_norm"], cfg.rms_eps)
    out = pdot(y, params["wo"], mode, wq=params.get("wo_q"))
    return out, cache
