"""How ``correct`` is decided for a served cell.

After the window closes, a sample of whole served batches, drawn from
the seed (every batch holds the mix's longest request), is replayed
through the plain reference teacher-forced on each prompt and the
tokens that were served after it.  For every served token the
comparison reads its gap: how far the reference's logit of that token
lies below the reference's best logit at that position.  Decoding is
greedy, so a sound program serves the reference's best token or one
within rounding of it.  The numbers a cell's limits name
(``portbench/limits/<cell>.json``) are read from these gaps, each set
from the program's readings and from the control's (the reference
itself at int4 in the program's place) and the faults': see ``PERF.md``.
A request's first served token comes from its prefill; the others are
its decoded tokens, which alone see the KV pool that decode steps
write.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

#: the gaps at which ``summary`` reads the share of tokens over them
THRESHOLDS = (0.0, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0)


def draw_batches(served: Sequence[int], seed: int, tokens: int) -> List[int]:
    """Indices of the served batches to check, in an order drawn from the
    seed, until their served tokens reach ``tokens`` or none are left.
    Every batch holds the same lengths, so each holds the mix's longest
    request."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x636b])
    out, n = [], 0
    for i in rng.permutation(len(served)):
        if n >= tokens:
            break
        out.append(int(i))
        n += served[i]
    return out


def token_gaps(ref_logits: Sequence[torch.Tensor], served: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """Per sequence, the gap of each served token below the reference's
    best at its position."""
    out = []
    for lg, toks in zip(ref_logits, served):
        t = torch.as_tensor(list(toks), dtype=torch.long, device=lg.device)
        out.append((lg.amax(dim=-1) - lg.gather(1, t[:, None])[:, 0]).cpu())
    return out


def control_tokens(ctl_logits: Sequence[torch.Tensor]) -> List[List[int]]:
    """The tokens the control puts first at each position."""
    return [lg.argmax(dim=-1).tolist() for lg in ctl_logits]


def summary(gaps: Sequence[torch.Tensor]) -> dict:
    """The widest gap, its quantiles and the share of tokens over a few
    gaps, of one set of served tokens."""
    g = torch.cat(list(gaps)).to(torch.float64)
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)).tolist()
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "p50": q[0], "p90": q[1], "p99": q[2],
            "share_over": {str(t): float((g > t).to(torch.float64).mean())
                           for t in THRESHOLDS},
            "tokens": int(g.numel())}


def compare(gap: dict, limits: Optional[dict]) -> dict:
    """The numbers the cell's limits name, each beside its limit:

    * ``max_logit_gap``: the widest gap of the served tokens checked;
    * ``wide_gap_share``: the share of them whose gap exceeds the limits
      entry's ``gap``;
    * ``decoded_gap_share``: the same share over the decoded tokens only
      (every served token but each request's first).
    """
    limits = limits or {}
    out = {}
    if "max_logit_gap" in limits or not limits:
        out["max_logit_gap"] = {"value": gap.get("widest"),
                                "limit": limits.get("max_logit_gap", {}).get("limit")}
    for name, key in (("wide_gap_share", "gaps"), ("decoded_gap_share", "decoded")):
        if name in limits:
            lim = limits[name]
            out[name] = {"value": share_over(gap.get(key), lim["gap"]), "limit": lim["limit"]}
    return out


def share_over(gaps: Optional[torch.Tensor], t: float) -> Optional[float]:
    """The share of ``gaps`` over ``t``; None when there are none."""
    if gaps is None or not gaps.numel():
        return None
    return float((gaps > t).to(torch.float64).mean())


def load_limits(root: str, workload: str) -> Optional[dict]:
    path = os.path.join(root, "portbench", "limits", f"{workload}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
