"""The port's exactness harness for ladder-speculative decoding: the
counterpart of tests/spec_harness.py (which stays as it is and lends its
prompts and its NumPy acceptance simulator) for
``repro_torch.runtime.speculative``.

* :meth:`TorchExactnessHarness.run_exactness`: the speculative stream of
  one draft rung and seed, the decoder's counters, the simulator's
  replay of its trace, and the trace itself;
* :meth:`TorchExactnessHarness.run_rollback`: one real round on a
  contiguous pool (the draft at its rung, the exact verify and commit)
  held against the pre-round pool and against sequential ``f32`` decode
  of exactly the accepted tokens.  The port updates caches in place, so
  the draft itself is checked too: after its k passes the pool must be
  the pre-round pool bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from _torch_jax_child import SPEC_K, SPEC_MAX_LEN, SPEC_MAX_NEW
from repro_torch import models as tm
from repro_torch.configs import smoke
from repro_torch.convert import params_from_jax
from repro_torch.runtime.speculative import LadderSpeculativeDecoder, SpeculativeConfig
from spec_harness import make_prompts, simulate_acceptance

FAMILIES = ("deepseek_7b", "gemma2_2b")
TRACE_KEYS = ("drafts", "preds", "n_commit", "active")


def load_reference(path) -> tuple:
    """(npz dict, the port's parameters built from the child's JAX ones)."""
    ref = dict(np.load(path))
    tree: dict = {}
    for name, arr in ref.items():
        if name.startswith("param/") and not any(p.endswith("_q") for p in name.split("/")):
            node = tree
            parts = name.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return ref, params_from_jax(tree, device="cpu")


def _clone(tree):
    return {k: {n: v.clone() for n, v in node.items()} for k, node in tree.items()}


@dataclasses.dataclass
class Report:
    speculative: List[List[int]]
    accounting: Dict[str, int]
    simulator: Dict[str, int]
    trace: Dict[str, np.ndarray]

    @property
    def accounting_ok(self) -> bool:
        return all(self.accounting[key] == self.simulator[key]
                   for key in ("rounds", "drafted", "accepted"))

    @property
    def acceptance_rate(self) -> float:
        d = self.accounting["drafted"]
        return self.accounting["accepted"] / d if d else float("nan")


class TorchExactnessHarness:
    """One model and its trace-collecting decoders (one per draft rung)."""

    def __init__(self, family: str, params: dict, k: int = SPEC_K):
        self.family = family
        self.cfg = smoke(family)
        self.params = params
        self.k = k
        self._decoders: Dict[str, LadderSpeculativeDecoder] = {}
        self._runs: dict = {}  # the runs are deterministic: each is made once

    def decoder(self, rung: str) -> LadderSpeculativeDecoder:
        if rung not in self._decoders:
            self._decoders[rung] = LadderSpeculativeDecoder(
                self.cfg, self.params,
                SpeculativeConfig(k=self.k, draft_level=rung, max_len=SPEC_MAX_LEN,
                                  collect_trace=True),
                device="cpu")
        return self._decoders[rung]

    def run_exactness(self, rung: str, seed: int, max_new: int = SPEC_MAX_NEW) -> Report:
        key = ("exact", rung, seed, max_new)
        if key not in self._runs:
            self._runs[key] = self._run_exactness(rung, seed, max_new)
        return self._runs[key]

    def _run_exactness(self, rung: str, seed: int, max_new: int) -> Report:
        dec = self.decoder(rung)
        start, before = len(dec.trace), dict(dec.stats)
        spec = dec.generate(make_prompts(self.cfg.vocab, seed), max_new=max_new)
        rounds = dec.trace[start:]
        return Report(
            speculative=spec,
            accounting={key: dec.stats[key] - before[key] for key in before},
            simulator=simulate_acceptance(rounds, self.k),
            trace={key: np.stack([r[key] for r in rounds]) for key in TRACE_KEYS})

    def prefilled_pool(self, seed: int):
        """A contiguous pool with the seed's prompts prefilled at f32, the
        first tokens and the next positions."""
        cfg = self.cfg
        prompts = make_prompts(cfg.vocab, seed)
        pool = tm.init_caches(cfg, len(prompts), SPEC_MAX_LEN, device="cpu")
        tok = []
        for i, p in enumerate(prompts):
            view = {key: {n: v[:, i:i + 1] for n, v in node.items()} for key, node in pool.items()}
            logits, _ = tm.prefill_step(self.params_q(), torch.tensor([p], dtype=torch.int32),
                                        view, cfg, mode="exact")
            tok.append(int(logits.argmax()))
        return (pool, torch.tensor(tok, dtype=torch.int32),
                torch.tensor([len(p) for p in prompts], dtype=torch.int32))

    def params_q(self) -> dict:
        return self.decoder("q8_8").params

    def run_rollback(self, rung: str, seed: int, restore: bool = True) -> dict:
        """One real round on a contiguous pool; see the module docstring.
        ``restore=False`` drafts without writing the draft's rows back (the
        fault the restore exists for), to show what the checks catch."""
        key = ("rollback", rung, seed, restore)
        if key not in self._runs:
            self._runs[key] = self._run_rollback(rung, seed, restore)
        return self._runs[key]

    def _run_rollback(self, rung: str, seed: int, restore: bool) -> dict:
        cfg, k = self.cfg, self.k
        dec = self.decoder(rung)
        pool, tok, pos = self.prefilled_pool(seed)
        B = tok.shape[0]
        mask = torch.ones(B, dtype=torch.bool)
        before = _clone(pool)
        drafts = dec._draft[dec.draft_levels.index(rung)](dec.params, tok, pos, pool, mask,
                                                          restore=restore)
        draft_restored = all(torch.equal(pool[key][n], before[key][n])
                             for key in pool for n in pool[key])
        preds, n_commit, pool, _, _, _, _ = dec._verify(dec.params, tok, pos, drafts, pool, mask)
        n_h = n_commit.numpy()
        keep_pos = pos.numpy() + n_h - 1

        # sequential f32 decode of exactly the accepted tokens, from the
        # pre-round pool (a lane past its count is masked out)
        ref, t, p = _clone(before), tok.clone(), pos.clone()
        for j in range(int(n_h.max())):
            step = torch.from_numpy(j < n_h)
            tm.decode_step(self.params_q(), t[:, None], p, ref, cfg, mode="exact", lane_mask=step)
            nxt = preds[torch.arange(B), torch.from_numpy(np.minimum(j, n_h - 1))]
            t = torch.where(step, nxt, t)
            p = p + step.to(torch.int32)

        rejected_ok, kept_err, beyond, window_rows = True, 0.0, 0, 0
        offs = np.arange(k + 1)
        for key, cache in pool.items():
            L = cache["pos"].shape[-1]
            window = cfg.period[int(key[3:])].window
            for b in range(B):
                seg_pos = pos[b].item() + offs
                slots = torch.from_numpy(seg_pos % L)
                kept = torch.from_numpy(seg_pos <= keep_pos[b])
                for name in ("k", "v", "pos"):
                    got = cache[name][:, b, slots]
                    rejected_ok &= torch.equal(got[:, ~kept], before[key][name][:, b, slots][:, ~kept])
                    if name == "pos":
                        rejected_ok &= torch.equal(got[:, kept], ref[key][name][:, b, slots][:, kept])
                    else:
                        kept_err = max(kept_err, (got[:, kept] - ref[key][name][:, b, slots][:, kept])
                                       .abs().max().item() if kept.any() else 0.0)
                beyond += int((cache["pos"][:, b] > keep_pos[b]).sum())
                if window is not None:
                    # rejected slots that hold an older position the next
                    # query (at keep_pos + 1) still attends to
                    old = before[key]["pos"][:, b, slots[~kept]]
                    window_rows += int(((old > keep_pos[b] + 1 - window) & (old >= 0)).sum())
        # the next query, at keep_pos + 1, reads the committed rows
        last = preds[torch.arange(B), torch.from_numpy(n_h - 1)][:, None]
        nxt = torch.from_numpy(keep_pos + 1).to(torch.int32)
        got, _ = tm.decode_step(self.params_q(), last, nxt, pool, cfg, mode="exact")
        want, _ = tm.decode_step(self.params_q(), last, nxt, ref, cfg, mode="exact")
        return {"draft_restored": draft_restored, "rejected_bit_exact": bool(rejected_ok),
                "next_logit_gap": (got - want).abs().max().item(),
                "kept_max_err": kept_err, "positions_beyond_keep": beyond,
                "rejected_rows_in_next_window": window_rows,
                "had_rejections": bool((n_h < k + 1).any())}
