"""The language model: embeddings -> stacked periods -> head.

Reference: ``src/repro/models/model.py`` — ``param_specs``,
``init_params``, ``init_caches``, ``write_cache_slot``,
``reset_cache_slot``, ``prefill_step`` and ``decode_step`` (with
``lane_mask``).  Training (``train_loss``), ``segment_step`` /
``commit_segment`` and ``truncate_cache_slot`` wait for later slices
(ROADMAP.md queue 1 items 9 and 12).

Parameters and caches keep the reference's trees: nested dicts whose
``periods`` leaves are stacked ``(n_periods, ...)``; the forward walks
the periods in a Python loop over views of those leaves.  Cache updates
are in place (see ``models.attention``): a step returns the very cache
dict it was given, now holding the new rows.

Traps the reference sets, kept here:

* ``_embed`` rounds the table to bf16 before the gather; the exact rung
  then upcasts;
* the head is an f32 product of bf16-rounded inputs on the FAST rung
  (``jnp.dot(bf16, bf16, preferred_element_type=f32)``): inputs are
  rounded to bf16, upcast, and multiplied in f32 — ``torch.matmul`` on
  bf16 would round the output too.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compat import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec, init_from_specs, rms_norm, rope_tables, softcap
from repro_torch.models.transformer import init_period_cache, period_forward, period_specs

__all__ = [
    "param_specs",
    "init_params",
    "init_caches",
    "prefill_step",
    "decode_step",
    "reset_cache_slot",
    "write_cache_slot",
    "layer_params",
]


def _stack_spec(s: Spec, n: int) -> Spec:
    return Spec((n,) + s.shape, ("layer",) + s.axes, s.dtype, s.init, s.scale)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_specs(cfg: ModelConfig) -> dict:
    stacked = _map(lambda s: _stack_spec(s, cfg.n_periods), period_specs(cfg))
    out = {
        "embed": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "periods": stacked,
        "final_norm": Spec((cfg.d_model,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = Spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return out


# Alias used by config.param_count()
param_shapes = param_specs


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random parameters with the reference's init law, drawn from a
    ``torch.Generator`` on the target device seeded with ``seed`` (the
    numbers differ from JAX's; tests carry JAX parameters across with
    ``convert.params_from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_from_specs(param_specs(cfg), gen, dev)
    return _map(lambda x: x.to(dtype), params)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                device=None) -> dict:
    """Stacked ``(n_periods, batch, ...)`` cache tree: k/v payloads 0,
    position sentinel -1."""
    dev = resolve_device(device)
    one = init_period_cache(cfg, batch, max_len, dtype, dev)
    return _map(lambda x: x[None].repeat((cfg.n_periods,) + (1,) * x.ndim), one)


def reset_cache_slot(caches: dict, cfg: ModelConfig, slot: int) -> dict:
    """Reset ONE batch slot of a stacked pool to its pristine fill, in
    place (continuous-batching eviction hygiene)."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            else:
                v[:, slot] = -1 if k == "pos" else 0
    walk(caches)
    return caches


def write_cache_slot(pool: dict, single: dict, slot: int) -> dict:
    """Copy a single-request cache tree (leaves ``(n_periods, 1, ...)``)
    into batch slot ``slot`` of the pool, in place."""
    def walk(p, s):
        for k in p:
            if isinstance(p[k], dict):
                walk(p[k], s[k])
            else:
                p[k][:, slot] = s[k][:, 0].to(p[k].dtype)
    walk(pool, single)
    return pool


def layer_params(params: dict, i: int) -> dict:
    """Period ``i``'s parameters: views into the stacked leaves."""
    return _map(lambda x: x[i], params["periods"])


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.stub_prefix_len:
        raise NotImplementedError("modality stubs: ROADMAP.md queue 1 item 10")
    # the reference casts the table to bf16 BEFORE the gather
    return params["embed"][tokens].to(torch.bfloat16)


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor, mode: str) -> torch.Tensor:
    """Last-position logits, soft-capped (gemma2) at the rung's
    precision: the FAST cap is the CORDIC tanh on K5."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if mode == "exact":
        logits = torch.matmul(x.to(torch.float32), head.to(torch.float32))
    else:
        # f32 product of bf16-rounded operands
        logits = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                              head.to(torch.bfloat16).to(torch.float32))
    return softcap(logits, cfg.final_softcap, mode)


def _layers(params, x, caches, cfg, positions, mode, *, prefill, lane_mask=None):
    # every attention layer rotates by (head_dim, rope_base): one pair of
    # tables a pass (one K3 launch on the FAST rung), not one a layer
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_base, mode)
    for i in range(cfg.n_periods):
        cache_i = None if caches is None else _map(lambda c: c[i], caches)
        x, _ = period_forward(layer_params(params, i), x, cfg, positions=positions, mode=mode,
                              caches=cache_i, prefill=prefill, lane_mask=lane_mask, rope=rope)
    return x


def prefill_step(params: dict, tokens: torch.Tensor, caches: dict, cfg: ModelConfig,
                 mode: str = "precise"):
    """tokens (B,S) from position 0 -> (last-position logits (B,V) f32,
    caches) with rows [0, S) of ``caches`` written in place."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    x = _embed(params, tokens, cfg)
    if mode == "exact":
        x = x.to(torch.float32)
    x = _layers(params, x, caches, cfg, positions, mode, prefill=True)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    return _head(params, cfg, x[:, 0], mode), caches


def decode_step(params: dict, token: torch.Tensor, position: torch.Tensor, caches: dict,
                cfg: ModelConfig, mode: str = "precise",
                lane_mask: Optional[torch.Tensor] = None):
    """token (B,1) at ``position`` (B,) -> (logits (B,V) f32, caches).

    ``lane_mask`` (B,) zeroes non-member lanes at the embedding and
    leaves their cache rows untouched, computing them as the
    reference's pristine masked view would: the FAST rung's per-tensor
    activation exponents then cannot couple a lane to the others, so a
    slot's output is what it would be served alone.
    """
    B = token.shape[0]
    positions = position.reshape(B, 1).to(torch.int32)
    x = _embed(params, token, cfg)
    if mode == "exact":
        x = x.to(torch.float32)
    if lane_mask is not None:
        x = x * lane_mask.to(x.dtype)[:, None, None]
    x = _layers(params, x, caches, cfg, positions, mode, prefill=False, lane_mask=lane_mask)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(params, cfg, x[:, 0], mode), caches
