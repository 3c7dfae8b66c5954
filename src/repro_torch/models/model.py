"""The language model: embeddings -> stacked periods -> head.

Reference: ``src/repro/models/model.py`` — ``param_specs``,
``init_params``, ``init_caches``, ``cache_layout``, ``write_cache_slot``,
``reset_cache_slot``, ``truncate_cache_slot``, ``prefill_step``,
``decode_step`` (with ``lane_mask``), the segment steps
``segment_step`` / ``commit_segment`` that the paged server's chunked
prefill and the speculative verify run on, and training's
``train_loss`` (``_backbone_train``, ``_lm_head``, ``_chunked_ce``).

Modality stubs (phi-3-vision, musicgen): ``extra_embeds`` (B, P, d) are
precomputed patch or frame embeddings added onto the first
``cfg.stub_prefix_len`` token positions (``prefill_step`` and
``train_loss``'s batch key); without them a stub runs as plain text.
The servers stay text-only, as the reference's do.

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
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.compat import (gather_contraction, gather_inner, is_dtensor, keep_layout,
                                product_out, replicated_like, resolve_device,
                                settled_placements)
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Spec, init_from_specs, no_constrain, rms_norm,
                                       rope_tables, softcap)
from repro_torch.models.transformer import init_period_cache, period_forward, period_specs

__all__ = [
    "param_specs",
    "init_params",
    "init_caches",
    "cache_layout",
    "train_loss",
    "prefill_step",
    "decode_step",
    "segment_step",
    "commit_segment",
    "reset_cache_slot",
    "write_cache_slot",
    "truncate_cache_slot",
    "layer_params",
]


def _stack_spec(s: Spec, n: int) -> Spec:
    return Spec((n,) + s.shape, ("layer",) + s.axes, s.dtype, s.init, s.scale)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_specs(cfg: ModelConfig) -> dict:
    stacked = tree_map(lambda s: _stack_spec(s, cfg.n_periods), period_specs(cfg))
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
    return tree_map(lambda x: x.to(dtype), params)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                device=None, quantized: bool = False) -> dict:
    """Stacked ``(n_periods, batch, ...)`` cache tree: k/v payloads 0,
    position sentinel -1.  ``quantized``: the int8 KV cache (int8 k/v,
    int32 ``k_exp`` / ``v_exp`` per row and kv head)."""
    dev = resolve_device(device)
    one = init_period_cache(cfg, batch, max_len, dtype, dev, quantized=quantized)
    return tree_map(lambda x: x[None].repeat((cfg.n_periods,) + (1,) * x.ndim), one)


def cache_layout(cfg: ModelConfig, max_len: int):
    """The model's cache-memory layout, one entry per period position:
    ``(key, kind, L)`` with ``L`` the POSITION-INDEXED cache length
    (``min(window, max_len)`` for sliding-window attention, ``max_len``
    for full attention / MLA) or ``None`` for cumulative state (SSM)."""
    out = []
    for i, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            L = min(spec.window, max_len) if spec.window else max_len
            out.append((f"pos{i}", spec.kind, L))
        elif spec.kind == "mla":
            out.append((f"pos{i}", "mla", max_len))
        else:
            out.append((f"pos{i}", spec.kind, None))
    return out


def truncate_cache_slot(pool: dict, cfg: ModelConfig, slot: int, keep_pos,
                        ssm_snapshot=None) -> dict:
    """Roll ONE batch slot of a stacked pool back, in place, so only
    entries at positions ``< keep_pos`` survive; returns ``pool``.
    Position-indexed caches (attention, MLA) give the others the pristine
    fill.  SSM caches are cumulative, so their rollback takes
    ``ssm_snapshot``: ``pos{i} -> {"state", "conv"}`` with leaves
    ``(n_periods, ...)``, the slot's contents as of ``keep_pos`` (for
    example a candidate of :func:`segment_step`'s ``seg_aux``); without an
    entry for an SSM layer it raises, as the reference does."""
    for i, spec in enumerate(cfg.period):
        key = f"pos{i}"
        cache = pool[key]
        if spec.kind in ("attn", "mla"):
            for p in range(cache["pos"].shape[0]):
                attn.truncate_attn_cache_slot(tree_map(lambda c: c[p], cache), slot, keep_pos)
            continue
        if ssm_snapshot is None or key not in ssm_snapshot:
            raise ValueError("truncate_cache_slot: SSM caches are cumulative and need an "
                             f"ssm_snapshot entry for {key}")
        for name, leaf in cache.items():
            leaf[:, slot] = ssm_snapshot[key][name].to(leaf.dtype)
    return pool


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
    return tree_map(lambda x: x[i], params["periods"])


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    # the reference casts the table to bf16 BEFORE the gather (the same
    # values: the rows are rounded either way).  A sharded table (a DTensor)
    # goes through ``embedding``, which DTensor looks up shard by shard; its
    # masked partial sums are settled at once (DTensor reduces a masked
    # partial only once, and the residual is read twice)
    table = params["embed"]
    if is_dtensor(table):
        x = torch.nn.functional.embedding(tokens, table)
        x = x.redistribute(x.device_mesh, settled_placements(x)).to(torch.bfloat16)
    else:
        x = table[tokens].to(torch.bfloat16)
    if extra_embeds is not None and cfg.stub_prefix_len:
        P = cfg.stub_prefix_len
        x = torch.cat([x[:, :P] + extra_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def _lm_head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor, mode: str) -> torch.Tensor:
    """Last-position logits, soft-capped (gemma2) at the rung's
    precision: the FAST cap is the CORDIC tanh on K5."""
    head = _lm_head(params, cfg)
    x = gather_inner(x)
    if mode == "exact":
        logits = torch.matmul(x.to(torch.float32), head.to(torch.float32))
    else:
        # f32 product of bf16-rounded operands
        logits = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                              head.to(torch.bfloat16).to(torch.float32))
    return softcap(logits, cfg.final_softcap, mode)


def _layers(params, x, caches, cfg, positions, mode, *, prefill, lane_mask=None,
            seg_aux=None, constrain=no_constrain):
    """Walk the periods.  ``seg_aux``: a dict a segment pass fills with
    every layer's rollback state, stacked to leaves ``(n_periods, ...)``
    under ``pos{i}``."""
    # every attention (MLA) layer rotates by (rope_dim, rope_base): one pair
    # of tables a pass (one K3 launch on the FAST rung), not one a layer;
    # an attention-free model builds none
    rope = (rope_tables(positions, cfg.rope_dim, cfg.rope_base, mode)
            if cfg.has_attention else None)
    per_period = []
    for i in range(cfg.n_periods):
        cache_i = None if caches is None else tree_map(lambda c: c[i], caches)
        aux_i = {} if seg_aux is not None else None
        # the MoE aux losses are training's (train_loss); serving reads none
        x, _, _ = period_forward(layer_params(params, i), x, cfg, positions=positions,
                                 mode=mode, caches=cache_i, prefill=prefill,
                                 lane_mask=lane_mask, rope=rope, seg_aux=aux_i, aux=False,
                                 constrain=constrain)
        per_period.append(aux_i)
    if seg_aux is not None:
        for key in per_period[0]:
            seg_aux[key] = {name: torch.stack([a[key][name] for a in per_period])
                            for name in per_period[0][key]}
    return x


def prefill_step(params: dict, tokens: torch.Tensor, caches: dict, cfg: ModelConfig,
                 mode: str = "precise", extra_embeds: Optional[torch.Tensor] = None,
                 constrain=no_constrain):
    """tokens (B,S) from position 0 -> (last-position logits (B,V) f32,
    caches) with rows [0, S) of ``caches`` written in place.
    ``extra_embeds`` (B, P, d): a modality stub's prefix embeddings.
    ``constrain``: the sharded cells' layout hook (``layers.no_constrain``
    by default), handed to every layer."""
    B, S = tokens.shape
    positions = replicated_like(tokens, torch.arange(S, dtype=torch.int32,
                                                     device=tokens.device)[None].expand(B, S))
    x = _embed(params, tokens, cfg, extra_embeds)
    if mode == "exact":
        x = x.to(torch.float32)
    x = _layers(params, x, caches, cfg, positions, mode, prefill=True, constrain=constrain)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    return _head(params, cfg, x[:, 0], mode), caches


# ---------------------------------------------------------------------------
# training loss (chunked CE)
# ---------------------------------------------------------------------------


def _period_train(params: dict, i: int, x: torch.Tensor, cfg: ModelConfig, positions, mode,
                  rope, constrain=no_constrain):
    x, _, aux = period_forward(layer_params(params, i), x, cfg, positions=positions, mode=mode,
                               rope=rope, constrain=constrain)
    return x, aux


def _backbone_train(params: dict, x: torch.Tensor, cfg: ModelConfig, positions, mode: str,
                    remat: bool, constrain=no_constrain):
    """The periods without caches -> (x, summed MoE aux losses (2,)).
    ``remat``: each period is checkpointed (``jax.checkpoint`` per scanned
    period in the reference): the backward recomputes its forward,
    kernels included, and keeps only the period's input.  The RoPE
    tables are built once, outside the checkpoints (one K3 launch a FAST
    step), and enter each period as inputs."""
    rope = (rope_tables(positions, cfg.rope_dim, cfg.rope_base, mode)
            if cfg.has_attention else None)
    aux = replicated_like(x, torch.zeros((2,), dtype=torch.float32, device=x.device))
    for i in range(cfg.n_periods):
        if remat:
            # early stop off: the recompute runs the whole period, so a
            # step's launches are the same whatever autograd saves
            with set_checkpoint_early_stop(False):
                x, a = checkpoint(_period_train, params, i, x, cfg, positions, mode, rope,
                                  constrain, use_reentrant=False)
        else:
            x, a = _period_train(params, i, x, cfg, positions, mode, rope, constrain)
        aux = aux + a
    return x, aux


def _vocab_sharded(x) -> bool:
    """A DTensor whose last (vocab) dimension a mesh dimension of more
    than one device shards."""
    return is_dtensor(x) and any(p.is_shard(x.ndim - 1) and size > 1
                                 for p, size in zip(x.placements, x.device_mesh.shape))


def _ce_chunk(h, head, labels, mask, cap, mode):
    """One sequence chunk: logits = f32 product of the bf16-rounded
    hidden rows and head (the reference's ``jnp.dot(bf16, bf16,
    preferred_element_type=f32)``), the final softcap at the rung, then
    (sum CE, sum z, count)."""
    logits = product_out(torch.matmul(h.to(torch.bfloat16).to(torch.float32), head))
    logits = softcap(logits, cap, mode)
    V = logits.shape[-1]
    if _vocab_sharded(logits):
        # vocab-parallel: the shards' max and sum of exponentials meet in
        # two small all-reduces (DTensor's logsumexp would gather the rows);
        # the gradients keep the logits' layout
        logits = keep_layout(logits)
        m = logits.amax(dim=-1, keepdim=True).detach()
        lse = (m + torch.log(keep_layout(torch.exp(logits - m)).sum(dim=-1, keepdim=True)))[..., 0]
    else:
        lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # a sharded cell: each vocab shard sums the label logits it holds
        # (DTensor's masked gather has no meta kernel before torch 2.13)
        vocab = replicated_like(logits, torch.arange(V, device=logits.device))
        gold = torch.where(vocab == labels[..., None].to(torch.int64), logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    ce = (lse - gold) * mask
    return ce.sum(), ((lse * mask) ** 2).sum(), mask.sum()


def _chunked_ce(hidden, head, labels, mask, cfg: ModelConfig, chunk: int = 256,
                mode: str = "precise"):
    """hidden (B,S,d), head (d,V), labels / mask (B,S) -> (sum_loss,
    sum_zloss, count), chunk by chunk over the sequence.  Each chunk is
    checkpointed, so its (B, chunk, V) logits are transient: the backward
    recomputes them (the softcap's K5 launch included on the FAST rung).
    The head is rounded to bf16 once, outside the chunks."""
    hidden = gather_inner(hidden)  # a sharded cell's chunks slice whole rows
    S = hidden.shape[1]
    chunk = min(chunk, S)
    head = gather_contraction(hidden, head.to(torch.bfloat16).to(torch.float32))
    loss_s = z_s = cnt = replicated_like(hidden, torch.zeros((), dtype=torch.float32,
                                                             device=hidden.device))
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        with set_checkpoint_early_stop(False):
            l, z, n = checkpoint(_ce_chunk, hidden[:, sl], head, labels[:, sl], mask[:, sl],
                                 cfg.final_softcap, mode, use_reentrant=False)
        loss_s, z_s, cnt = loss_s + l, z_s + z, cnt + n
    return loss_s, z_s, cnt


def train_loss(params: dict, batch: dict, cfg: ModelConfig, mode: str = "precise",
               remat: bool = True, z_coef: float = 1e-4, constrain=no_constrain):
    """batch: ``tokens`` (B,S), ``labels`` (B,S), optional ``loss_mask``
    and ``extra_embeds`` -> (loss, metrics) with metrics ``ce``,
    ``z_loss``, ``tokens`` and, for MoE models, ``moe_lb`` / ``moe_z``
    (0-dim f32 tensors).  Differentiable: the FAST rung's kernels carry
    straight-through (K1, K5) or written-out (K4) gradients; no cache is
    touched.  ``constrain``: the sharded cells' layout hook, on the
    embedded residual (``model.py:285``) and in every layer."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    B, S = tokens.shape
    positions = replicated_like(tokens, torch.arange(S, dtype=torch.int32,
                                                     device=tokens.device)[None].expand(B, S))

    x = _embed(params, tokens, cfg, batch.get("extra_embeds"))
    x = constrain(x, "residual")
    x, aux = _backbone_train(params, x, cfg, positions, mode, remat, constrain)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)

    loss_s, z_s, cnt = _chunked_ce(x, _lm_head(params, cfg), labels, mask, cfg, mode=mode)
    denom = torch.clamp_min(cnt, 1.0)
    ce = loss_s / denom
    z_loss = z_coef * z_s / denom
    loss = ce + z_loss
    metrics = {"ce": ce, "z_loss": z_loss, "tokens": cnt}
    if cfg.moe is not None:
        lb, rz = aux[0] / cfg.n_periods, aux[1] / cfg.n_periods
        loss = loss + cfg.moe.aux_loss_coef * lb + cfg.moe.router_z_coef * rz
        metrics.update({"moe_lb": lb, "moe_z": rz})
    return loss, metrics


def decode_step(params: dict, token: torch.Tensor, position: torch.Tensor, caches: dict,
                cfg: ModelConfig, mode: str = "precise",
                lane_mask: Optional[torch.Tensor] = None, pristine_view: bool = True,
                constrain=no_constrain):
    """token (B,1) at ``position`` (B,) -> (logits (B,V) f32, caches).

    ``lane_mask`` (B,) zeroes non-member lanes at the embedding and
    leaves their cache rows untouched, computing them as the
    reference's pristine masked view would: the FAST rung's per-tensor
    activation exponents then cannot couple a lane to the others, so a
    slot's output is what it would be served alone.  With
    ``pristine_view=False`` the mask only zeroes the input, as the
    reference's ``decode_step`` does on an unmasked cache: non-member
    lanes attend to their own rows and write theirs like members (the
    speculative draft, whose writes are rolled back or dropped).
    """
    B = token.shape[0]
    positions = position.reshape(B, 1).to(torch.int32)
    x = _embed(params, token, cfg)
    if mode == "exact":
        x = x.to(torch.float32)
    if lane_mask is not None:
        x = x * lane_mask.to(x.dtype)[:, None, None]
    x = _layers(params, x, caches, cfg, positions, mode, prefill=False,
                lane_mask=lane_mask if pristine_view else None, constrain=constrain)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(params, cfg, x[:, 0], mode), caches


def segment_step(params: dict, tokens: torch.Tensor, positions: torch.Tensor, caches: dict,
                 cfg: ModelConfig, mode: str = "exact",
                 lane_mask: Optional[torch.Tensor] = None, constrain=no_constrain):
    """Mid-sequence segment forward: ``tokens`` (B,S) at explicit
    ``positions`` (B,S) against populated caches, all S positions in one
    pass (the speculative verify, a chunk of the chunked prefill).
    Returns ``(logits (B,S,V) f32, caches, seg_aux)``: the caches, updated
    in place, hold the whole segment; ``seg_aux`` holds, per period
    position ``pos{i}``, the slots an attention or MLA layer wrote
    (``slot`` (P,B,S)) and their pre-segment rows (``k``, ``v``
    (P,B,S,KV,D) or ``ckv``, ``krope``, and ``pos`` (P,B,S), and on an
    int8 cache ``k_exp``, ``v_exp`` (P,B,S,KV)), and for an SSM layer the
    per-position ``states``, the ``conv_hist`` and the pre-segment
    ``state`` and ``conv``, from which :func:`commit_segment` rolls
    rejected rows back.
    The logits are ``_head``'s per rung (the FAST final softcap on K5),
    the RoPE tables built once from the (B,S) positions (one K3 launch
    on the FAST rung).  ``lane_mask`` (B,) zeroes non-member lanes at the
    embedding, as the reference does; their rows are restored by
    ``commit_segment(active=lane_mask)``."""
    x = _embed(params, tokens, cfg)
    if mode == "exact":
        x = x.to(torch.float32)
    if lane_mask is not None:
        x = x * lane_mask.to(x.dtype)[:, None, None]
    seg_aux: dict = {}
    x = _layers(params, x, caches, cfg, positions.to(torch.int32), mode, prefill=False,
                seg_aux=seg_aux, constrain=constrain)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(params, cfg, x, mode), caches, seg_aux


def commit_segment(caches: dict, seg_aux: dict, cfg: ModelConfig, *, keep_pos, keep_count,
                   active) -> dict:
    """Merge a verified segment into the cache pool, in place, rolling
    REJECTED rows back bit for bit; returns ``caches``.

    The reference takes ``commit_segment(before, after, seg_aux, cfg,
    ...)`` and selects, per row, the pre-segment copy where the row's new
    position is ``> keep_pos`` or its lane is not ``active``.  The port
    keeps one pool, updated in place by :func:`segment_step`, so it takes
    that pool (the reference's ``after``) and restores those rows from
    the pre-segment rows ``seg_aux`` recorded (the only rows the segment
    changed, so the outcome equals the reference's leaf for leaf, wrapped
    sliding-window slots included).  SSM layers are cumulative: an active
    lane takes the state after its ``keep_count``-th position and the
    conv rows ``[keep_count, keep_count + K - 1)`` of the conv history,
    an inactive lane its pre-segment ``state`` and ``conv``.
    ``keep_pos`` (B,): last accepted position; ``keep_count`` (B,):
    accepted positions; ``active`` (B,) bool."""
    for i, spec in enumerate(cfg.period):
        key = f"pos{i}"
        cache, aux = caches[key], seg_aux[key]
        if spec.kind == "mamba":
            _commit_ssm(cache, aux, keep_count, active)
            continue
        slots = aux["slot"]                                        # (P, B, S)
        P, B, S = slots.shape
        per = torch.arange(P, device=slots.device)[:, None, None]
        lanes = torch.arange(B, device=slots.device)[None, :, None]
        new_pos = cache["pos"][per, lanes, slots]
        keep = torch.as_tensor(keep_pos, device=slots.device).reshape(1, B, 1)
        act = torch.as_tensor(active, device=slots.device).to(torch.bool).reshape(1, B, 1)
        rejected = (new_pos > keep) | ~act
        for name in cache:
            buf = cache[name]
            cur = buf[per, lanes, slots]
            mask = rejected.reshape(rejected.shape + (1,) * (cur.ndim - 3))
            buf[per, lanes, slots] = torch.where(mask, aux[name], cur)
    return caches


def _commit_ssm(cache: dict, aux: dict, keep_count, active) -> None:
    """The SSM branch of :func:`commit_segment` (the reference's
    ``model.py:492-510``), in place.  An ``aux`` without ``states`` (a
    speculative draft's save) offers no candidate: active lanes keep
    their current leaves."""
    B = aux["state"].shape[1]
    dev = aux["state"].device
    act = torch.as_tensor(active, device=dev).to(torch.bool).reshape(1, B)
    if "states" not in aux:
        sel, conv = cache["state"], cache["conv"]
    else:
        states = aux["states"]                                     # (P,B,S,nh,ds,hd)
        conv_hist = aux["conv_hist"]                               # (P,B,K-1+S,C)
        S = states.shape[2]
        Km1 = conv_hist.shape[2] - S
        kc = torch.as_tensor(keep_count, device=dev).to(torch.long).reshape(B)
        lanes = torch.arange(B, device=dev)
        sel = states[:, lanes, (kc - 1).clamp(0, S - 1)]           # (P,B,nh,ds,hd)
        rows = kc.clamp(0, S)[:, None] + torch.arange(Km1, device=dev)[None]   # (B,K-1)
        conv = conv_hist[:, lanes[:, None], rows]                  # (P,B,K-1,C)
    cache["state"].copy_(torch.where(act[..., None, None, None], sel.to(cache["state"].dtype),
                                     aux["state"]))
    cache["conv"].copy_(torch.where(act[..., None, None], conv.to(cache["conv"].dtype),
                                    aux["conv"]))
