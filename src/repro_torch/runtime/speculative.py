"""Ladder-speculative decoding: draft at a cheap rung, verify at f32.

Reference: ``src/repro/runtime/speculative.py`` — ``SPEC_DRAFT_LEVELS``,
``SPEC_CACHE_DTYPE``, ``SpeculativeConfig``, ``register_spec_steps``,
``LadderSpeculativeDecoder`` and ``vanilla_greedy_reference``.  A round:

1. **draft** — ``k`` greedy single-token ``decode_step`` passes at the
   draft rung (``q8_8`` -> the model's ``"fast8"``: activations snapped
   to the Q8.8 grid before K1/K2; ``q16_16`` -> ``"fast"``);
2. **verify** — the current token and the k drafts in ONE exact-rung
   ``segment_step`` of k+1 positions; the longest prefix of drafts that
   agrees with the verify's argmaxes, plus the verify's argmax after it,
   is committed (1 to k+1 tokens, each one vanilla f32 greedy decode
   would emit);
3. **rollback** — ``commit_segment`` restores every rejected row bit for
   bit.

What differs from the reference: the port's caches are updated in
place.  The reference drafts inside a jit and drops the draft's cache
writes with it; here every draft pass writes rows ``(pos + j) % L``
(j < k) of every lane of every attention cache.  On a contiguous pool
the draft therefore saves those B x k rows a layer first (in
``segment_step``'s ``seg_aux`` format; an SSM layer's whole ``state``
and ``conv``, which every pass changes) and writes them back after its
last pass, before the verify runs: otherwise the verify's ``seg_aux``
would record draft-rung bits and the commit would "restore" rejected
rows to them — and a rolling window's row ``(pos + j) % L`` past the
accepted prefix can still hold a position the next query covers.  A
paged pool drafts on a gathered view, a copy, which is simply dropped
(``restore=False``).  The draft computes its non-member lanes as the
reference does, from their own cache (``pristine_view=False``): on the
FAST rungs they share the per-tensor activation exponents.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.precision import MathEngine
from repro_torch.models import (
    commit_segment,
    decode_step,
    init_caches,
    prefill_step,
    segment_step,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attach_quantized_weights
from repro_torch.models.model import tree_map

__all__ = [
    "SPEC_DRAFT_LEVELS",
    "SPEC_CACHE_DTYPE",
    "SpeculativeConfig",
    "LadderSpeculativeDecoder",
    "register_spec_steps",
    "vanilla_greedy_reference",
]

#: draft rungs: engine level name -> model-layer dispatch string (the f32
#: verify rung is not a draft option)
SPEC_DRAFT_LEVELS = (("q8_8", "fast8"), ("q16_16", "fast"))

#: serving caches are f32 (the exact rung's consistency contract)
SPEC_CACHE_DTYPE = torch.float32


@dataclasses.dataclass
class SpeculativeConfig:
    """``k``: drafts a round; ``draft_level``: the starting rung, one of
    :data:`SPEC_DRAFT_LEVELS`; ``collect_trace``: keep a per-round host
    trace (drafts, verify argmaxes, commit counts, active lanes)."""

    k: int = 4
    draft_level: str = "q8_8"
    max_len: int = 256
    eos_id: Optional[int] = None
    collect_trace: bool = False

    def __post_init__(self):
        names = tuple(lv for lv, _ in SPEC_DRAFT_LEVELS)
        if self.k < 1:
            raise ValueError("speculative k must be >= 1")
        if self.draft_level not in names:
            raise ValueError(f"draft_level {self.draft_level!r} not a draft rung {names}")


def _min_window(cfg: ModelConfig) -> Optional[int]:
    ws = [l.window for l in cfg.period if l.window is not None]
    return min(ws) if ws else None


def _save_rows(caches: dict, pos: torch.Tensor, n: int) -> dict:
    """What ``n`` draft passes from ``pos`` overwrite, in ``segment_step``'s
    ``seg_aux`` format for ``commit_segment`` to write back: for every
    position-indexed cache (attention, MLA) the rows ``(pos + j) % L``
    (j < n) of every lane (``slot`` (P,B,n) and each leaf's rows); for
    every SSM cache a copy of its ``state`` and ``conv`` (O(1) a slot:
    the state is cumulative, so rows would not do), with no rollback
    candidates: the commit of an inactive lane takes these leaves."""
    B = pos.shape[0]
    lanes = torch.arange(B, device=pos.device)[:, None]
    offs = torch.arange(n, device=pos.device)[None]
    saved = {}
    for key, cache in caches.items():
        if "pos" not in cache:
            saved[key] = {"state": cache["state"].clone(), "conv": cache["conv"].clone()}
            continue
        P, _, L = cache["pos"].shape
        slots = (pos.to(torch.long)[:, None] + offs) % L                   # (B, n)
        saved[key] = {"slot": slots.expand(P, B, n)}
        for name, leaf in cache.items():
            saved[key][name] = leaf[:, lanes, slots]
    return saved


def register_spec_steps(engine: MathEngine, cfg: ModelConfig, k: int):
    """Register the draft on ``engine`` and return ``(draft_table, verify,
    draft_level_names)``.

    ``draft_table[level_idx](params, tok, pos, caches, lane_mask,
    restore=True)`` runs ``k`` greedy decode passes at that draft rung and
    returns the drafts (B, k); with ``restore`` it writes back every row
    it overwrote (a pool), without it the caches keep the draft's rows
    (a gathered view that is dropped).

    ``verify(params, tok, pos, drafts, caches, mask)`` runs the exact-rung
    segment of k+1 positions, takes the longest agreeing prefix and
    commits / rolls back ``caches`` in place.  Returns ``(preds (B,k+1),
    n_commit (B,), caches, new_tok (B,), new_pos (B,), finite (B,),
    amp (B,))``.
    """
    w = _min_window(cfg)
    if w is not None and k + 1 > w:
        raise ValueError(
            f"speculative k={k} needs k+1 <= smallest attention window ({w}): "
            "a verify segment must fit the rolling KV buffer")

    def make_draft(mode):
        def fn(params, tok, pos, caches, lane_mask, restore=True):
            saved = _save_rows(caches, pos, k) if restore else None
            t, p, drafts = tok, pos, []
            for _ in range(k):
                logits, _ = decode_step(params, t[:, None], p, caches, cfg, mode=mode,
                                        lane_mask=lane_mask, pristine_view=False)
                t = torch.argmax(logits, dim=-1).to(torch.int32)
                p = p + 1
                drafts.append(t)
            if restore:
                # every saved row is "rejected": written back bit for bit
                none = torch.zeros_like(lane_mask, dtype=torch.bool)
                commit_segment(caches, saved, cfg, keep_pos=pos, keep_count=none.to(torch.int32),
                               active=none)
            return torch.stack(drafts, dim=1)
        return fn

    engine.register("spec_draft", **{lv: make_draft(m) for lv, m in SPEC_DRAFT_LEVELS})
    draft_names = tuple(lv for lv, _ in SPEC_DRAFT_LEVELS)
    draft_table, _ = engine.switched("spec_draft", levels=draft_names)

    def verify(params, tok, pos, drafts, caches, mask):
        seg = torch.cat([tok[:, None], drafts], dim=1)                       # (B, k+1)
        seg_pos = pos[:, None] + torch.arange(k + 1, dtype=torch.int32, device=pos.device)[None]
        logits, caches, aux = segment_step(params, seg, seg_pos, caches, cfg, mode="exact",
                                           lane_mask=mask)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)                 # (B, k+1)
        match = (drafts == preds[:, :k]).to(torch.int32)
        m = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)           # (B,) in [0, k]
        n_commit = torch.where(mask, m + 1, torch.zeros_like(m))
        commit_segment(caches, aux, cfg, keep_pos=pos + m, keep_count=n_commit, active=mask)
        last = preds.gather(1, (n_commit - 1).clamp(0, k).to(torch.long)[:, None])[:, 0]
        new_tok = torch.where(mask, last, tok)
        new_pos = pos + n_commit
        finite = torch.isfinite(logits).all(dim=2).all(dim=1) | ~mask
        amp = torch.where(mask, logits.abs().amax(dim=(1, 2)), torch.zeros((), device=pos.device))
        return preds, n_commit, caches, new_tok, new_pos, finite, amp

    return draft_table, verify, draft_names


def _prefill_into(params, prompt, caches, slot: int, cfg: ModelConfig, device) -> int:
    """Exact-rung prefill of ``prompt`` straight into ``slot``'s rows (a
    view of the pool); returns the first generated token."""
    view = tree_map(lambda leaf: leaf[:, slot:slot + 1], caches)
    tokens = torch.tensor([list(prompt)], dtype=torch.int32, device=device)
    logits, _ = prefill_step(params, tokens, view, cfg, mode="exact")
    return int(torch.argmax(logits, dim=-1)[0])


class LadderSpeculativeDecoder:
    """Standalone speculative greedy decoder (the exactness-harness
    subject).  ``generate`` prefills each prompt at f32, then runs
    draft -> verify -> commit rounds until every lane has ``max_new``
    tokens (or EOS); the stream equals vanilla f32 greedy decode."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: SpeculativeConfig,
                 engine: Optional[MathEngine] = None, device=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.engine = engine or MathEngine(scfg.draft_level)
        self.params = attach_quantized_weights(tree_map(lambda x: x.to(self.device), params),
                                               self.engine.weight_cache, level="q16_16")
        self._draft, self._verify, self.draft_levels = register_spec_steps(
            self.engine, cfg, scfg.k)
        self.stats: Dict[str, int] = {"rounds": 0, "drafted": 0, "accepted": 0}
        self.trace: List[dict] = []

    @property
    def acceptance_rate(self) -> float:
        d = self.stats["drafted"]
        return self.stats["accepted"] / d if d else float("nan")

    def generate(self, prompts: Sequence[Sequence[int]], max_new: int = 32,
                 draft_level: Optional[str] = None) -> List[List[int]]:
        """Greedy speculative decode; per-prompt GENERATED tokens (the first
        from the f32 prefill).  Prompts may be ragged."""
        scfg, cfg, dev = self.scfg, self.cfg, self.device
        k = scfg.k
        B = len(prompts)
        li = self.draft_levels.index(draft_level or scfg.draft_level)
        need = max(len(p) for p in prompts) + max_new + k
        if need > scfg.max_len:
            raise ValueError(
                f"max_len {scfg.max_len} too small: longest prompt + max_new + k needs "
                f"{need} positions of speculative headroom")

        caches = init_caches(cfg, B, scfg.max_len, dtype=SPEC_CACHE_DTYPE, device=dev)
        tok = np.array([_prefill_into(self.params, p, caches, i, cfg, dev)
                        for i, p in enumerate(prompts)], np.int32)
        out: List[List[int]] = [[int(t)] for t in tok]
        done = np.zeros((B,), bool)
        if scfg.eos_id is not None:
            done |= tok == scfg.eos_id
        done |= max_new <= 1
        tok_d = torch.from_numpy(tok).to(dev)
        pos_d = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)

        while not done.all():
            mask = torch.from_numpy(~done).to(dev)
            drafts = self._draft[li](self.params, tok_d, pos_d, caches, mask)
            preds, n_commit, caches, tok_d, pos_d, _, _ = self._verify(
                self.params, tok_d, pos_d, drafts, caches, mask)
            preds_h = preds.cpu().numpy()
            n_h = n_commit.cpu().numpy()
            self.stats["rounds"] += 1
            self.stats["drafted"] += int(k * (~done).sum())
            self.stats["accepted"] += int(np.maximum(n_h - 1, 0).sum())
            if scfg.collect_trace:
                self.trace.append({"drafts": drafts.cpu().numpy(), "preds": preds_h.copy(),
                                   "n_commit": n_h.copy(), "active": (~done).copy()})
            for i in range(B):
                if done[i]:
                    continue
                for j in range(int(n_h[i])):
                    t = int(preds_h[i, j])
                    out[i].append(t)
                    if (scfg.eos_id is not None and t == scfg.eos_id) or len(out[i]) >= max_new:
                        done[i] = True
                        break
        return [o[:max_new] for o in out]


def vanilla_greedy_reference(cfg: ModelConfig, params: dict, prompts, max_new: int,
                             max_len: int, eos_id: Optional[int] = None,
                             engine: Optional[MathEngine] = None,
                             device=None) -> List[List[int]]:
    """The oracle: plain f32 greedy decode, one token at a time."""
    dev = resolve_device(device)
    engine = engine or MathEngine("f32")
    params = attach_quantized_weights(tree_map(lambda x: x.to(dev), params), engine.weight_cache,
                                      level="q16_16")
    outs = []
    for p in prompts:
        caches = init_caches(cfg, 1, max_len, dtype=SPEC_CACHE_DTYPE, device=dev)
        cur = _prefill_into(params, p, caches, 0, cfg, dev)
        toks, pos = [cur], len(p)
        while len(toks) < max_new and not (eos_id is not None and cur == eos_id):
            logits, _ = decode_step(params, torch.tensor([[cur]], dtype=torch.int32, device=dev),
                                    torch.tensor([pos], dtype=torch.int32, device=dev), caches,
                                    cfg, mode="exact")
            cur = int(torch.argmax(logits, dim=-1)[0])
            toks.append(cur)
            pos += 1
        outs.append(toks)
    return outs
