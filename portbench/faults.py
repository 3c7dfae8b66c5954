"""Faults planted under the timed path, to show that the check sees them.

Each fault is a function of the server's module that returns the name
of a module attribute and its broken replacement; the caller sets it
(``monkeypatch.setattr`` in the tests, ``plant`` in ``calibrate.py``)
and the server, which looks the name up at every call, serves through
it.  The faults a served cell on one card can have:

* ``kv_unwritten``: a decode step that leaves its state unchanged: the
  rows it writes into the KV pool are put back as they were, so every
  later step attends without the decoded tokens' keys and values;
* ``half_left_out``: half of the batch left out: a decode step computes
  the first half of the lanes only;
* ``token_altered``: a token altered where it is produced: every
  sampled token + 1.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def _pool_leaves(caches, batch: int) -> List[torch.Tensor]:
    """The leaves of a pool stacked as (periods, lanes, rows, ...)."""
    out = []
    stack = [caches]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, torch.Tensor) and node.ndim >= 3 and node.shape[1] == batch:
            out.append(node)
    return out


def kv_unwritten(serve_mod) -> Tuple[str, Callable]:
    step = serve_mod.decode_step

    def unwritten(params, tok, pos, caches, cfg, lane_mask=None, **kw):
        B = tok.shape[0]
        lanes = torch.arange(B, device=tok.device)
        leaves = _pool_leaves(caches, B)
        saved = []
        for leaf in leaves:
            slot = pos.reshape(-1).to(torch.long) % leaf.shape[2]
            saved.append((slot, leaf[:, lanes, slot].clone()))
        out = step(params, tok, pos, caches, cfg, lane_mask=lane_mask, **kw)
        for leaf, (slot, rows) in zip(leaves, saved):
            leaf[:, lanes, slot] = rows
        return out
    return "decode_step", unwritten


def half_left_out(serve_mod) -> Tuple[str, Callable]:
    step = serve_mod.decode_step

    def half(params, tok, pos, caches, cfg, lane_mask=None, **kw):
        if lane_mask is not None:
            lane_mask = lane_mask.clone()
            lane_mask[lane_mask.shape[0] // 2:] = False
        return step(params, tok, pos, caches, cfg, lane_mask=lane_mask, **kw)
    return "decode_step", half


def token_altered(serve_mod) -> Tuple[str, Callable]:
    finish = serve_mod._finish

    def altered(logits, temperature, gen):
        tok, hv = finish(logits, temperature, gen)
        return (tok + 1) % logits.shape[-1], hv
    return "_finish", altered


FAULTS: Dict[str, Callable] = {"kv_unwritten": kv_unwritten, "half_left_out": half_left_out,
                               "token_altered": token_altered}


def plant(name: str) -> Callable[[], None]:
    """Plant fault ``name`` in the server's module; returns the undo."""
    import repro_torch.runtime.serve as serve_mod

    attr, broken = FAULTS[name](serve_mod)
    orig = getattr(serve_mod, attr)
    setattr(serve_mod, attr, broken)
    return lambda: setattr(serve_mod, attr, orig)
