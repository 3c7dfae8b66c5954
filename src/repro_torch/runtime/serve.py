"""Serving runtime: static batching and continuous batching on the
precision ladder.

Reference: ``src/repro/runtime/serve.py`` — :class:`BatchedServer` and
:class:`ContinuousBatchingServer` on the contiguous cache.  The paged
pool and speculative decoding wait for ROADMAP.md queue 1 item 9
(``ServingConfig`` rejects them); the deprecated ``ServerConfig`` /
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
* every metric name of the reference.

What differs: the steps are eager PyTorch.  ``MathEngine.switched``
returns a per-level table of step callables and the loop indexes it
with the level — there is nothing to trace, so the reference's retrace
detectors have no counterpart: ``retrace_total`` stays registered (the
metric catalogue is unchanged) and is never incremented.  The KV pool
is updated in place: admission prefills straight into the slot's rows
(a view from ``cache_ops.read``), decode passes write only their member
lanes' rows, eviction writes the pristine fill.  Device-side masks are
uploaded once per distinct membership and reused.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.arbiter import SlotArbiter
from repro_torch.core.precision import MathEngine, PrecisionLevel
from repro_torch.models import decode_step, init_caches, prefill_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attach_quantized_weights
from repro_torch.runtime.cachepool import ContiguousCacheOps
from repro_torch.runtime.config import SERVE_CACHE_DTYPE, SERVE_STEP_LEVELS, ServingConfig
from repro_torch.runtime.scheduler import ContinuousScheduler, FinishedRequest, Request
from repro_torch.runtime.telemetry import Telemetry

__all__ = [
    "ServingConfig",
    "BatchedServer",
    "ContinuousBatchingServer",
    "SERVE_STEP_LEVELS",
    "SERVE_CACHE_DTYPE",
]


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


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
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.telemetry = Telemetry(scfg.telemetry)
        self.engine = MathEngine(scfg.default_level)
        self.engine.weight_cache.use_registry(self.telemetry.registry)
        self.params = attach_quantized_weights(
            _to_device(params, self.device), self.engine.weight_cache, level="q16_16")
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

    Device state, allocated once: the stacked KV ``pool`` for
    ``n_slots`` lanes x ``max_len`` rows, the per-slot current token and
    next position, the generated-token ring and the health accumulator.
    Host state: the :class:`ContinuousScheduler` and the
    :class:`SlotArbiter`.  See the module docstring for what is kept
    from the reference and what differs.
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
            _to_device(params, self.device), self.engine.weight_cache, level="q16_16")
        dev = self.device
        n = scfg.n_slots
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
        front (the paged, speculative and retrace families stay at 0)."""
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

    def metrics_snapshot(self) -> dict:
        self._m_active.set(len(self.scheduler.active_slots()))
        return self.telemetry.registry.snapshot()

    def render_prometheus(self) -> str:
        self._m_active.set(len(self.scheduler.active_slots()))
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
        L = self._gen_buf.shape[1]
        w = active & (self._gen_count < L)
        idx = torch.where(w, self._gen_count, 0).to(torch.long)[:, None]
        cur = self._gen_buf.gather(1, idx)[:, 0]
        self._gen_buf.scatter_(1, idx, torch.where(w, tok, cur)[:, None])
        act = active.to(torch.int32)
        self._gen_count += act
        self._tok = torch.where(active, tok, self._tok)
        self._pos += act
        upd = torch.stack([torch.minimum(self._health[:, 0], hv[:, 1]),
                           torch.maximum(self._health[:, 1], hv[:, 2])], dim=1)
        self._health = torch.where(active[:, None], upd, self._health)

    # -- admission / eviction -------------------------------------------------

    def _level_idx(self, req: Request) -> int:
        name = req.level or self.scfg.default_level
        if name not in self.level_names:
            raise ValueError(f"request {req.rid}: unknown level {name!r}")
        return self.level_names.index(name)

    def _admit(self, slot: int, req: Request) -> None:
        """Prefill the request at its own level straight into its slot's
        (pristine) rows of the pool."""
        tel = self.telemetry
        plen = len(req.prompt)
        li = self._level_idx(req)
        self.arbiter.reset_slot(slot, li)
        t0 = 0.0
        if tel.on:
            t0 = time.perf_counter()
            self._req_t0[slot] = t0
            tel.async_begin("request", id=req.rid, tid=slot + 1, args={
                "rid": req.rid, "prompt_len": plen, "level": self.level_names[li],
                "speculative": False,
            })
        with tel.span("admit", tid=slot + 1,
                      args={"rid": req.rid, "prompt_len": plen} if tel.on else None):
            tokens = torch.tensor([req.prompt], dtype=torch.int32, device=self.device)
            logits, _ = self._prefill[li](self.params, tokens, self.cache_ops.read(self.pool, slot))
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

    def _finish_slot(self, slot: int, reason: str) -> FinishedRequest:
        """Pull the request's tokens (its one device->host transfer in
        async mode), record it finished and reset the slot's rows."""
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
        self.cache_ops.reset(self.pool, slot)
        self._tok[slot] = 0
        self._pos[slot] = 0
        self._gen_count[slot] = 0
        self._m_active.set(len(self.scheduler.active_slots()))
        return fin

    # -- the serving loop ---------------------------------------------------

    def serve(self, requests: Sequence[Request]) -> Dict[int, FinishedRequest]:
        """Run all requests to completion; returns {rid: FinishedRequest}."""
        seen = set()
        for r in requests:
            self.scheduler.validate(r)
            if r.speculative:
                raise NotImplementedError(
                    f"request {r.rid}: speculative decoding is not ported yet "
                    "(ROADMAP.md queue 1 item 9)")
            if r.rid in seen:
                raise ValueError(f"duplicate request id {r.rid} within one serve() call")
            seen.add(r.rid)
        for r in requests:
            self.scheduler.submit(r)

        eos_mode = self.scfg.eos_id is not None
        wanted = [r.rid for r in requests]
        tel = self.telemetry
        while self.scheduler.has_work():
            for slot, req in self.scheduler.admit():
                self._admit(slot, req)
            van_now = self.scheduler.active_mask()
            if not van_now.any():
                continue  # everything admitted finished at its first token

            tel_on = tel.on
            t0 = time.perf_counter() if tel_on else 0.0
            with tel.span("decode-tick", args={"step": self._step, "lanes": int(van_now.sum())}
                          if tel_on else None):
                levels = self.arbiter.idx
                present = sorted(set(int(v) for v in levels[van_now]))
                active_dev = self._mask(van_now)
                t1 = time.perf_counter() if tel_on else 0.0
                logits = None
                for li in present:
                    mask = van_now & (levels == li)
                    mask_dev = active_dev if len(present) == 1 else self._mask(mask)
                    lv = self.level_names[li]
                    with tel.span("level-pass", args={"level": lv} if tel_on else None):
                        out, _ = self._decode[li](self.params, self._tok[:, None], self._pos,
                                                  self.pool, mask_dev)
                    logits = out if logits is None else torch.where(mask_dev[:, None], out, logits)
                    self._m_level_passes.inc(level=lv)
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
                 level: Optional[str] = None) -> List[List[int]]:
        """Serve the prompts and return token lists in input order."""
        reqs = [Request(rid=self.next_rid(), prompt=list(p), max_new=max_new, level=level)
                for p in prompts]
        fins = self.serve(reqs)
        return [fins[r.rid].tokens for r in reqs]
