"""Serving runtime: static batching and continuous batching on the
precision ladder.

Reference: ``src/repro/runtime/serve.py`` — :class:`BatchedServer` and
:class:`ContinuousBatchingServer`, on the contiguous or the paged cache
pool (``ServingConfig.cache``), with chunked prefill, prefix sharing and
ladder-speculative requests.  The deprecated ``ServerConfig`` /
``ContinuousServerConfig`` shims are not carried over.

What is kept from the reference:

* per-slot ladder levels: one decode pass per DISTINCT active level,
  merged under the slot mask (``q16_16`` -> the model's ``"fast"`` mode
  on kernels K1-K4, ``f32`` -> ``"exact"``);
* the isolation contract: each pass zeroes non-member lanes at the
  input (``lane_mask``) and computes them as the reference's pristine
  masked-cache view would, so a request's tokens equal those it gets
  served alone at its level;
* the :class:`~repro_torch.core.arbiter.SlotArbiter` signals (finite
  flag and logit amplitude per slot) and the host-sync budget: with
  ``eos_id`` one (B, 3) pull per step, without it tokens stay in a
  device ring pulled once per request at eviction and health syncs
  every ``health_sync_every`` steps;
* the paged pool's lifecycle: admission one request at a time under
  ``can_admit``, prefix match, chunked prefill in fixed ``(1, C)``
  segments (``ceil(tail / C)`` chunks an admission; an SSM layer carries
  its state from chunk to chunk through the segment recurrence),
  ``ensure_rows`` (allocation, copy-on-write) before every step, pages
  released and SSM lanes zeroed at eviction;
* speculative requests: prefill at ``f32``, then rounds of k draft
  passes at the slot's DRAFT rung (a second ``SlotArbiter`` over
  ``SPEC_DRAFT_LEVELS``, escalated on sustained low acceptance) and one
  ``f32`` verify segment that commits 1..k+1 tokens; a lane without
  k rows of headroom takes a vanilla ``f32`` step;
* every metric name of the reference.

What differs: the steps are eager PyTorch.  ``MathEngine.switched``
returns a per-level table of step callables and the loop indexes it
with the level — there is nothing to trace, so the reference's retrace
detectors have no counterpart: ``retrace_total`` stays registered (the
metric catalogue is unchanged) and is never incremented.  The KV pool
is updated in place: admission prefills straight into the slot's rows
(a view from ``cache_ops.read``), decode passes write only their member
lanes' rows (and SSM states), eviction writes the pristine fill (zero
SSM state and conv history).  On the paged pool a
tick gathers one view of the pool (a copy), runs every level's pass on
it — each pass writes only its members' rows and computes the others as
pristine, the reference's masked view — and scatters the active lanes'
rows back once; a chunked admission gathers the slot once, runs its
chunks and scatters the slot once (no other step touches its pages in
between, so the bits are the reference's per-chunk gather and scatter).
Device-side masks are uploaded once per distinct membership and reused.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.arbiter import SlotArbiter
from repro_torch.core.precision import MathEngine, PrecisionLevel
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
from repro_torch.runtime.cachepool import CacheOps, ContiguousCacheOps, PagedCachePool
from repro_torch.runtime.config import SERVE_CACHE_DTYPE, SERVE_STEP_LEVELS, ServingConfig
from repro_torch.runtime.scheduler import ContinuousScheduler, FinishedRequest, Request
from repro_torch.runtime.speculative import SPEC_DRAFT_LEVELS, register_spec_steps
from repro_torch.runtime.telemetry import Telemetry

__all__ = [
    "ServingConfig",
    "BatchedServer",
    "ContinuousBatchingServer",
    "SERVE_STEP_LEVELS",
    "SERVE_CACHE_DTYPE",
]


def _finish(logits: torch.Tensor, temperature: float, gen: Optional[torch.Generator]):
    """Sample + per-slot health on the device: (tok (B,) int32, host
    view (B, 3) = [token, finite, amplitude])."""
    if temperature <= 0:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        u = torch.rand(logits.shape, generator=gen, device=logits.device).clamp_(1e-20, 1.0)
        tok = torch.argmax(logits.to(torch.float32) / temperature - torch.log(-torch.log(u)),
                           dim=-1).to(torch.int32)
    finite = torch.isfinite(logits).all(dim=-1)
    amp = logits.abs().amax(dim=-1)
    return tok, torch.stack([tok.to(torch.float32), finite.to(torch.float32), amp], dim=1)


class BatchedServer:
    """Static batching: up to ``n_slots`` prompts, right-padded to a
    common length, prefilled together and decoded lock-step at the
    server's single level — the simplest correctness oracle."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServingConfig, device=None):
        if scfg.cache != "contiguous":
            raise ValueError("BatchedServer supports cache='contiguous' only; the paged "
                             "pool lives on ContinuousBatchingServer")
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.telemetry = Telemetry(scfg.telemetry)
        self.engine = MathEngine(scfg.default_level)
        self.engine.weight_cache.use_registry(self.telemetry.registry)
        self.params = attach_quantized_weights(
            tree_map(lambda x: x.to(self.device), params), self.engine.weight_cache,
            level="q16_16")
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        cfg_ = cfg
        self.engine.register("prefill", **{
            lv: (lambda p, t, c, m=mode: prefill_step(p, t, c, cfg_, mode=m))
            for lv, mode in SERVE_STEP_LEVELS})
        self.engine.register("decode", **{
            lv: (lambda p, t, q, c, m=mode: decode_step(p, t, q, c, cfg_, mode=m))
            for lv, mode in SERVE_STEP_LEVELS})

    def metrics_snapshot(self) -> dict:
        return self.telemetry.registry.snapshot()

    def render_prometheus(self) -> str:
        return self.telemetry.render_prometheus()

    def set_level(self, level) -> float:
        return self.engine.set_level(level)

    set_mode = set_level

    @property
    def level(self) -> PrecisionLevel:
        return self.engine.level

    def generate(self, prompts: List[List[int]]) -> List[List[int]]:
        scfg = self.scfg
        assert len(prompts) <= scfg.n_slots
        B = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((B, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        caches = init_caches(self.cfg, B, scfg.max_len, dtype=SERVE_CACHE_DTYPE,
                             device=self.device)
        logits, caches = self.engine.call(
            "prefill", self.params, torch.from_numpy(toks).to(self.device), caches)
        cur, _ = _finish(logits, scfg.temperature, self._gen)
        gen = [cur]
        pos = torch.full((B,), plen, dtype=torch.int32, device=self.device)
        eos = scfg.eos_id
        done = np.zeros((B,), bool)
        for step in range(scfg.max_new - 1):
            if eos is not None:
                done |= gen[-1].cpu().numpy() == eos
                if done.all():
                    break
            if plen + step + 1 >= scfg.max_len:
                break
            logits, caches = self.engine.call("decode", self.params, gen[-1][:, None], pos, caches)
            gen.append(_finish(logits, scfg.temperature, self._gen)[0])
            pos = pos + 1
        mat = torch.stack(gen, dim=1).cpu().numpy()
        outs = []
        for i, p in enumerate(prompts):
            row = mat[i].tolist()
            if eos is not None and eos in row:
                row = row[: row.index(eos) + 1]
            outs.append(list(p) + row)
        return outs




class ContinuousBatchingServer:
    """Continuous-batching engine with per-request precision.

    Device state, allocated once: the KV ``pool`` behind ``cache_ops``
    (contiguous: ``n_slots`` lanes x ``max_len`` rows; paged: page groups
    behind block tables), the per-slot current token and next position,
    the generated-token ring and the health accumulator.  Host state:
    the :class:`ContinuousScheduler`, the :class:`SlotArbiter` and, with
    a speculative config, the draft arbiter.  See the module docstring
    for what is kept from the reference and what differs.
    """

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServingConfig, device=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.level_names = tuple(lv for lv, _ in SERVE_STEP_LEVELS)
        if scfg.default_level not in self.level_names:
            raise ValueError(f"default_level {scfg.default_level!r} not in {self.level_names}")
        if scfg.arbiter.n_levels != len(self.level_names):
            raise ValueError("arbiter ladder size must match SERVE_STEP_LEVELS")
        self.telemetry = Telemetry(scfg.telemetry)
        self._declare_metrics(self.telemetry.registry)
        self.engine = MathEngine(scfg.default_level)
        self.engine.weight_cache.use_registry(self.telemetry.registry)
        self.params = attach_quantized_weights(
            tree_map(lambda x: x.to(self.device), params), self.engine.weight_cache,
            level="q16_16")
        dev = self.device
        n = scfg.n_slots
        self.paged = scfg.cache == "paged"
        self.cache_ops: CacheOps
        if self.paged:
            self.cache_ops = PagedCachePool(
                cfg, n, scfg.max_len, scfg.page_size, dtype=SERVE_CACHE_DTYPE,
                n_pages=scfg.n_pages, prefix_sharing=scfg.prefix_sharing,
                registry=self.telemetry.registry, device=dev)
        else:
            self.cache_ops = ContiguousCacheOps(cfg, n, scfg.max_len, dtype=SERVE_CACHE_DTYPE,
                                                device=dev)
        self.pool = self.cache_ops.alloc()
        self._tok = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._gen_buf = torch.zeros((n, scfg.max_len), dtype=torch.int32, device=dev)
        self._gen_count = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._health_neutral = torch.tensor([[1.0, 0.0]] * n, dtype=torch.float32, device=dev)
        self._health = self._health_neutral.clone()
        self.scheduler = ContinuousScheduler(
            n, scfg.max_len, scfg.eos_id, levels=self.level_names,
            registry=self.telemetry.registry,
        )
        self.arbiter = SlotArbiter(n, scfg.arbiter)
        self.arbiter.on_switch = self._make_switch_hook("serve", self.level_names)
        # speculative mode: a SEPARATE per-slot arbiter over the DRAFT
        # rungs, driven by the acceptance rate
        self.draft_arbiter: Optional[SlotArbiter] = None
        if scfg.speculative is not None:
            draft_names = tuple(lv for lv, _ in SPEC_DRAFT_LEVELS)
            self.draft_arbiter = SlotArbiter(n, dataclasses.replace(
                scfg.arbiter, n_levels=len(draft_names),
                start_idx=draft_names.index(scfg.speculative.draft_level)))
            self.draft_arbiter.on_switch = self._make_switch_hook("draft", draft_names)
        self._gen = torch.Generator(device=dev).manual_seed(scfg.seed)
        self._masks: Dict[bytes, torch.Tensor] = {}
        self._step = 0
        self._rid_counter = 0
        self._req_t0: Dict[int, float] = {}
        if self.telemetry.on:
            self.telemetry.thread_name(0, "engine")
            for s in range(n):
                self.telemetry.thread_name(s + 1, f"slot{s}")
        self._build()

    # -- telemetry ----------------------------------------------------------

    def _declare_metrics(self, reg) -> None:
        """Every serving metric family of the reference, registered up
        front (``retrace_total`` stays at 0: nothing is traced)."""
        tb = self.scfg.telemetry.tick_buckets
        self._m_decode_ticks = reg.counter("decode_ticks_total", "pool decode steps executed")
        self._m_level_passes = reg.counter(
            "level_passes_total", "compiled pool passes per ladder level", labelnames=("level",))
        self._m_prefills = reg.counter("prefills_total", "request prefills (admissions)")
        self._m_prefill_chunks = reg.counter(
            "prefill_chunks_total", "fixed-shape chunk-prefill dispatches")
        self._m_prefix_hits = reg.counter(
            "prefix_cache_hits_total", "admissions that reused a shared prefix")
        self._m_prefix_reused = reg.counter(
            "prefix_tokens_reused_total", "prompt tokens served from shared prefix pages")
        self._m_spec_rounds = reg.counter("spec_rounds_total", "speculative draft/verify rounds")
        self._m_spec_drafted = reg.counter("spec_drafted_total", "draft tokens proposed")
        self._m_spec_accepted = reg.counter(
            "spec_accepted_total", "draft tokens accepted by f32 verify")
        self._m_spec_acc_rate = reg.gauge(
            "spec_acceptance_rate", "cumulative accepted/drafted ratio")
        self._m_retrace = reg.counter(
            "retrace_total", "jitted step-function (re)traces, by trace-time side effect",
            labelnames=("step",))
        self._m_finished = reg.counter(
            "requests_finished_total", "requests finished", labelnames=("reason",))
        self._m_tokens = reg.counter(
            "tokens_generated_total", "tokens committed to finished requests")
        self._m_syncs = reg.counter(
            "host_syncs_total", "device->host synchronizations", labelnames=("kind",))
        self._m_active = reg.gauge("active_slots", "slots bound to a request")
        self._m_arb = reg.counter(
            "arbiter_switches_total", "slot-arbiter rung switches",
            labelnames=("arbiter", "cause"))
        self._m_tick_s = reg.histogram(
            "tick_seconds", "decode-tick phase wall time (s)", labelnames=("phase",), buckets=tb)
        self._m_prefill_s = reg.histogram(
            "prefill_seconds", "admission prefill wall time (s)", buckets=tb)
        self._m_req_latency = reg.histogram(
            "request_latency_seconds", "admission->finish wall time (s)", buckets=tb)

    def _make_switch_hook(self, arbiter_name: str, rung_names):
        def hook(step, slot, old_idx, new_idx, cause):
            self._m_arb.inc(arbiter=arbiter_name, cause=cause)
            if self.telemetry.on:
                self.telemetry.instant("arbiter-switch", tid=slot + 1, args={
                    "arbiter": arbiter_name, "cause": cause,
                    "from": rung_names[old_idx], "to": rung_names[new_idx], "step": step,
                })
        return hook

    @property
    def stats(self) -> Dict[str, int]:
        """The historical counting-hook dict, a read-only registry view."""
        return {
            "decode_steps": int(self._m_decode_ticks.value()),
            "level_passes": int(self._m_level_passes.total()),
            "prefills": int(self._m_prefills.value()),
            "spec_rounds": int(self._m_spec_rounds.value()),
            "spec_drafted": int(self._m_spec_drafted.value()),
            "spec_accepted": int(self._m_spec_accepted.value()),
            "prefill_chunks": int(self._m_prefill_chunks.value()),
            "prefix_hits": int(self._m_prefix_hits.value()),
            "prefix_tokens_reused": int(self._m_prefix_reused.value()),
        }

    def _refresh_gauges(self) -> None:
        if self.paged:
            self.cache_ops.scrape_gauges()
        self._m_active.set(len(self.scheduler.active_slots()))

    def metrics_snapshot(self) -> dict:
        """Every metric, the page pool's occupancy gauges refreshed first."""
        self._refresh_gauges()
        return self.telemetry.registry.snapshot()

    def render_prometheus(self) -> str:
        self._refresh_gauges()
        return self.telemetry.render_prometheus()

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- step functions -------------------------------------------------------

    def _build(self):
        cfg = self.cfg

        def make_prefill(mode):
            def fn(params, tokens, caches):
                return prefill_step(params, tokens, caches, cfg, mode=mode)
            return fn

        def make_decode(mode):
            # lane_mask: non-member lanes zeroed at the input and kept out
            # of the pool — the slot-isolation contract
            def fn(params, tok, pos, caches, lane_mask):
                return decode_step(params, tok, pos, caches, cfg, mode=mode, lane_mask=lane_mask)
            return fn

        self.engine.register("prefill", **{lv: make_prefill(m) for lv, m in SERVE_STEP_LEVELS})
        self.engine.register("decode", **{lv: make_decode(m) for lv, m in SERVE_STEP_LEVELS})
        # per-level tables indexed by the ladder position
        self._prefill, _ = self.engine.switched("prefill", levels=self.level_names)
        self._decode, _ = self.engine.switched("decode", levels=self.level_names)

        self._spec_draft = self._spec_verify = None
        if self.scfg.speculative is not None:
            self._spec_draft, self._spec_verify, _ = register_spec_steps(
                self.engine, cfg, self.scfg.speculative.k)

        if self.paged:
            def make_chunk(mode):
                # one (1, C) segment of the chunked prefill on the slot's
                # view; the ragged last chunk's pad rows are rolled back
                def fn(params, tokens, positions, view, keep_pos, rows):
                    logits, _, aux = segment_step(params, tokens, positions, view, cfg, mode=mode)
                    commit_segment(view, aux, cfg, keep_pos=keep_pos,
                                   keep_count=torch.full_like(keep_pos, rows),
                                   active=torch.ones_like(keep_pos, dtype=torch.bool))
                    return logits[:, rows - 1], view
                return fn

            self.engine.register("chunk", **{lv: make_chunk(m) for lv, m in SERVE_STEP_LEVELS})
            self._chunk, _ = self.engine.switched("chunk", levels=self.level_names)

    def _mask(self, host_mask: np.ndarray) -> torch.Tensor:
        """Device copy of a (n_slots,) bool mask, uploaded once per
        distinct membership."""
        key = host_mask.tobytes()
        m = self._masks.get(key)
        if m is None:
            m = self._masks[key] = torch.from_numpy(host_mask.copy()).to(self.device)
        return m

    def _step_update(self, tok: torch.Tensor, hv: torch.Tensor, active: torch.Tensor) -> None:
        """Fold one decode step into the device state, in place: append
        active slots' tokens to their rings, advance counts/positions,
        accumulate health — no host round trip."""
        self._append(tok, active, 0)
        act = active.to(torch.int32)
        self._gen_count += act
        self._tok = torch.where(active, tok, self._tok)
        self._pos += act
        upd = torch.stack([torch.minimum(self._health[:, 0], hv[:, 1]),
                           torch.maximum(self._health[:, 1], hv[:, 2])], dim=1)
        self._health = torch.where(active[:, None], upd, self._health)

    def _append(self, tok: torch.Tensor, write: torch.Tensor, offset: int) -> None:
        """Write ``tok`` at ring index ``gen_count + offset`` of the lanes
        in ``write`` (others, and indices past the ring, keep theirs)."""
        L = self._gen_buf.shape[1]
        at = self._gen_count + offset
        w = write & (at < L)
        idx = torch.where(w, at, 0).to(torch.long)[:, None]
        cur = self._gen_buf.gather(1, idx)[:, 0]
        self._gen_buf.scatter_(1, idx, torch.where(w, tok, cur)[:, None])

    # -- admission / eviction -------------------------------------------------

    def _level_idx(self, req: Request) -> int:
        name = req.level or self.scfg.default_level
        if name not in self.level_names:
            raise ValueError(f"request {req.rid}: unknown level {name!r}")
        return self.level_names.index(name)

    def _admit(self, slot: int, req: Request) -> None:
        """Prefill the request at its own level (a speculative one at
        ``f32``, the exactness anchor) into its slot: straight into the
        slot's pristine rows (contiguous), or by chunked prefill into its
        pages (paged)."""
        tel = self.telemetry
        plen = len(req.prompt)
        if req.speculative:
            li = self.level_names.index("f32")
            self.draft_arbiter.reset_slot(slot)
        else:
            li = self._level_idx(req)
        self.arbiter.reset_slot(slot, li)
        t0 = 0.0
        if tel.on:
            t0 = time.perf_counter()
            self._req_t0[slot] = t0
            tel.async_begin("request", id=req.rid, tid=slot + 1, args={
                "rid": req.rid, "prompt_len": plen, "level": self.level_names[li],
                "speculative": req.speculative,
            })
        with tel.span("admit", tid=slot + 1,
                      args={"rid": req.rid, "prompt_len": plen} if tel.on else None):
            if self.paged:
                logits = self._prefill_chunked(slot, req.prompt, li)
            else:
                tokens = torch.tensor([req.prompt], dtype=torch.int32, device=self.device)
                logits, _ = self._prefill[li](self.params, tokens,
                                              self.cache_ops.read(self.pool, slot))
            self._m_prefills.inc()
            tok, hv = _finish(logits, self.scfg.temperature, self._gen)
            if tel.on and self.scfg.telemetry.sync_device:
                self._sync_device()
        if tel.on:
            self._m_prefill_s.observe(time.perf_counter() - t0)
        self._tok[slot] = tok[0]
        self._pos[slot] = plen
        self._gen_buf[slot, 0] = tok[0]
        self._gen_count[slot] = 1
        self._health[slot] = torch.stack([hv[0, 1], hv[0, 2]])
        eos_seen = False
        if self.scfg.eos_id is not None:
            self._m_syncs.inc(kind="eos")
            eos_seen = int(hv[0, 0].item()) == self.scfg.eos_id
        self._m_active.set(len(self.scheduler.active_slots()))
        reason = self.scheduler.advance(slot, eos=eos_seen)
        if reason is not None:
            self._finish_slot(slot, reason)

    def _prefill_chunked(self, slot: int, prompt: List[int], li: int) -> torch.Tensor:
        """Paged admission: prefix match + attach shared pages, then the
        unmatched tail through the fixed ``(1, C)`` chunk step — ``ceil(tail
        / C)`` chunks whatever the prompt length.  Returns the last prompt
        token's logits (1, vocab)."""
        pool: PagedCachePool = self.cache_ops
        self.pool, matched, chain = pool.prepare_admission(self.pool, slot, prompt)
        if matched:
            self._m_prefix_hits.inc()
            self._m_prefix_reused.inc(matched)
        C = self.scfg.resolved_chunk
        plen = len(prompt)
        dev = self.device
        # the tables are complete after prepare_admission: one gather, the
        # chunks, one scatter
        view = pool.slot_view(self.pool, pool.slot_tables(slot), slot)
        tel = self.telemetry
        last, start = None, matched
        while start < plen:
            r = min(C, plen - start)
            toks = np.zeros((1, C), np.int32)
            toks[0, :r] = prompt[start:start + r]
            with tel.span("prefill-chunk", tid=slot + 1,
                          args={"start": start, "rows": r} if tel.on else None):
                last, view = self._chunk[li](
                    self.params, torch.from_numpy(toks).to(dev),
                    torch.arange(start, start + C, dtype=torch.int32, device=dev)[None], view,
                    torch.tensor([start + r - 1], dtype=torch.int32, device=dev), r)
            self._m_prefill_chunks.inc()
            start += r
        # matched <= plen - 1 (the block of the first decode write is never
        # attached shared), so at least one chunk ran
        assert last is not None
        pool.slot_commit(self.pool, pool.scatter_ids(slot), slot, view)
        pool.finish_admission(slot, chain, matched)
        return last

    def _finish_slot(self, slot: int, reason: str) -> FinishedRequest:
        """Pull the request's tokens (its one device->host transfer in
        async mode), record it finished and reset the slot: its rows back
        to the pristine fill (contiguous) or its page references released
        (paged: a freed page is pristine-filled when it is next allocated)."""
        n = self.scheduler.n_generated(slot)
        self._m_syncs.inc(kind="evict")
        toks = self._gen_buf[slot, :n].tolist()
        fin = self.scheduler.finish(slot, toks, reason)
        self._m_finished.inc(reason=reason)
        self._m_tokens.inc(n)
        if self.telemetry.on:
            t0 = self._req_t0.pop(slot, None)
            if t0 is not None:
                self._m_req_latency.observe(time.perf_counter() - t0)
            self.telemetry.async_end("request", id=fin.rid, tid=slot + 1,
                                     args={"reason": reason, "n_generated": n})
        self.pool = self.cache_ops.reset(self.pool, slot)
        self._tok[slot] = 0
        self._pos[slot] = 0
        self._gen_count[slot] = 0
        self._m_active.set(len(self.scheduler.active_slots()))
        return fin

    # -- speculative round ----------------------------------------------------

    def _spec_round(self, spec_now: np.ndarray, k: int) -> None:
        """One draft/verify round for the speculative lanes: k drafts a lane
        at its DRAFT rung (one group of passes per rung present, merged
        under the rung's mask), one ``f32`` verify segment that commits or
        rolls back the pool, the committed tokens appended to the ring,
        and the acceptance rate fed to the draft arbiter.  The round's host
        sync is the commit counts and the verify's argmaxes."""
        tel = self.telemetry
        tel_on = tel.on
        rungs = self.draft_arbiter.idx
        present = sorted(set(int(v) for v in rungs[spec_now]))
        pool = self.cache_ops
        tables = pool.device_tables() if self.paged else None
        drafts = None
        with tel.span("draft", args={"rungs": len(present)} if tel_on else None):
            for ri in present:
                dmask = self._mask(spec_now & (rungs == ri))
                if self.paged:
                    # a gathered view is a copy: the draft's rows are dropped
                    part = self._spec_draft[ri](self.params, self._tok, self._pos,
                                                pool.device_view(self.pool, tables), dmask,
                                                restore=False)
                else:
                    part = self._spec_draft[ri](self.params, self._tok, self._pos, self.pool,
                                                dmask)
                drafts = part if drafts is None else torch.where(dmask[:, None], part, drafts)
        mask_dev = self._mask(spec_now)
        pos0 = self._pos
        with tel.span("verify", args={"k": k} if tel_on else None):
            caches = pool.device_view(self.pool, tables) if self.paged else self.pool
            preds, n_commit, caches, self._tok, self._pos, finite, amp = self._spec_verify(
                self.params, self._tok, pos0, drafts, caches, mask_dev)
            if self.paged:
                # the k+1 segment rows, rejected ones with their restored
                # pre-segment bits: the page-granular rollback
                pool.commit_rows(self.pool, tables, caches, pos0, mask_dev, n_rows=k + 1)
            for j in range(k + 1):
                self._append(preds[:, j], mask_dev & (j < n_commit), j)
            self._gen_count = self._gen_count + n_commit
        self._m_syncs.inc(kind="spec")
        n_h = n_commit.cpu().numpy()
        preds_h = preds.cpu().numpy()
        accepted = np.maximum(n_h - 1, 0)
        acc = np.where(spec_now, accepted / k, np.nan)
        self.draft_arbiter.observe(
            self._step, nonfinite=~finite.cpu().numpy(), amplitude=amp.cpu().numpy(),
            active=spec_now, acceptance=acc)
        self._m_spec_rounds.inc()
        self._m_spec_drafted.inc(int(k * spec_now.sum()))
        self._m_spec_accepted.inc(int(accepted[spec_now].sum()))
        if self._m_spec_drafted.value():
            self._m_spec_acc_rate.set(self._m_spec_accepted.value()
                                      / self._m_spec_drafted.value())
        eos_id = self.scfg.eos_id
        for slot in np.nonzero(spec_now)[0]:
            for j in range(int(n_h[slot])):
                eos = eos_id is not None and int(preds_h[slot, j]) == eos_id
                reason = self.scheduler.advance(int(slot), eos=eos)
                if reason is not None:
                    self._finish_slot(int(slot), reason)
                    break

    # -- the serving loop ---------------------------------------------------

    def serve(self, requests: Sequence[Request]) -> Dict[int, FinishedRequest]:
        """Run all requests to completion; returns {rid: FinishedRequest}."""
        seen = set()
        for r in requests:
            self.scheduler.validate(r)
            if r.speculative and self._spec_verify is None:
                raise ValueError(f"request {r.rid}: speculative=True but the server was "
                                 "built without a speculative config")
            if r.rid in seen:
                raise ValueError(f"duplicate request id {r.rid} within one serve() call")
            seen.add(r.rid)
        for r in requests:
            self.scheduler.submit(r)

        eos_mode = self.scfg.eos_id is not None
        wanted = [r.rid for r in requests]
        k = self.scfg.speculative.k if self.scfg.speculative is not None else 0
        tel = self.telemetry
        while self.scheduler.has_work():
            if not self.paged:
                for slot, req in self.scheduler.admit():
                    self._admit(slot, req)
            else:
                # one admission per admit() call: an admission takes pages,
                # so the next head's capacity check must see the new count
                while True:
                    pairs = self.scheduler.admit(lambda r: self.cache_ops.can_admit(r.prompt),
                                                 limit=1)
                    if not pairs:
                        break
                    self._admit(*pairs[0])
            active = self.scheduler.active_mask()
            if not active.any():
                continue  # everything admitted finished at its first token

            # a speculative lane without k rows of headroom takes a
            # vanilla f32 step this iteration
            spec_now = np.zeros_like(active)
            if self._spec_verify is not None:
                for s in np.nonzero(active)[0]:
                    if (self.scheduler.request_at(int(s)).speculative
                            and self.scheduler.position(int(s)) + k < self.scfg.max_len):
                        spec_now[s] = True
            van_now = active & ~spec_now

            if self.paged:
                # back this step's write targets (allocate, copy-on-write)
                # before the step reads the tables
                for s in np.nonzero(active)[0]:
                    p = self.scheduler.position(int(s))
                    hi = p + k if spec_now[s] else p
                    self.pool = self.cache_ops.ensure_rows(self.pool, int(s), p,
                                                           min(hi, self.scfg.max_len - 1))

            if spec_now.any():
                with tel.span("spec-round", args={"step": self._step,
                                                  "lanes": int(spec_now.sum())}
                              if tel.on else None):
                    self._spec_round(spec_now, k)

            if not van_now.any():
                self._step += 1
                continue
            tel_on = tel.on
            t0 = time.perf_counter() if tel_on else 0.0
            with tel.span("decode-tick", args={"step": self._step, "lanes": int(van_now.sum())}
                          if tel_on else None):
                levels = self.arbiter.idx
                present = sorted(set(int(v) for v in levels[van_now]))
                active_dev = self._mask(van_now)
                t1 = time.perf_counter() if tel_on else 0.0
                if self.paged:
                    tables = self.cache_ops.device_tables()
                    caches = self.cache_ops.device_view(self.pool, tables)
                else:
                    caches = self.pool
                logits = None
                for li in present:
                    mask = van_now & (levels == li)
                    mask_dev = active_dev if len(present) == 1 else self._mask(mask)
                    lv = self.level_names[li]
                    with tel.span("level-pass", args={"level": lv} if tel_on else None):
                        out, _ = self._decode[li](self.params, self._tok[:, None], self._pos,
                                                  caches, mask_dev)
                    logits = out if logits is None else torch.where(mask_dev[:, None], out, logits)
                    self._m_level_passes.inc(level=lv)
                if self.paged:
                    self.cache_ops.commit_rows(self.pool, tables, caches, self._pos, active_dev)
                del caches
                tok, hv = _finish(logits, self.scfg.temperature, self._gen)
                self._step_update(tok, hv, active_dev)
                self._m_decode_ticks.inc()
                if tel_on and self.scfg.telemetry.sync_device:
                    self._sync_device()
                t2 = time.perf_counter() if tel_on else 0.0
                self._step += 1

                eos_flags = np.zeros((self.scfg.n_slots,), bool)
                if eos_mode:
                    self._m_syncs.inc(kind="eos")
                    hv_host = hv.cpu().numpy()  # the per-step EOS pull
                    eos_flags = hv_host[:, 0].astype(np.int32) == self.scfg.eos_id
                    self.arbiter.observe(self._step, nonfinite=hv_host[:, 1] < 0.5,
                                         amplitude=hv_host[:, 2], active=van_now)
                elif self._step % self.scfg.health_sync_every == 0:
                    self._m_syncs.inc(kind="health")
                    h = self._health.cpu().numpy()  # periodic aggregated sync
                    self.arbiter.observe(self._step, nonfinite=h[:, 0] < 0.5,
                                         amplitude=h[:, 1], active=van_now)
                    self._health = self._health_neutral.clone()

                for slot in np.nonzero(van_now)[0]:
                    reason = self.scheduler.advance(int(slot), eos=bool(eos_flags[slot]))
                    if reason is not None:
                        self._finish_slot(int(slot), reason)
            if tel_on:
                t3 = time.perf_counter()
                self._m_tick_s.observe(t1 - t0, phase="host_schedule")
                self._m_tick_s.observe(t2 - t1, phase="device_dispatch")
                self._m_tick_s.observe(t3 - t2, phase="sync")

        return {rid: self.scheduler.pop_finished(rid) for rid in wanted}

    def next_rid(self) -> int:
        rid = self._rid_counter
        self._rid_counter += 1
        return rid

    def generate(self, prompts: List[List[int]], max_new: int = 32,
                 level: Optional[str] = None, speculative: bool = False) -> List[List[int]]:
        """Serve the prompts and return token lists in input order."""
        reqs = [Request(rid=self.next_rid(), prompt=list(p), max_new=max_new, level=level,
                        speculative=speculative)
                for p in prompts]
        fins = self.serve(reqs)
        return [fins[r.rid].tokens for r in reqs]
