"""The one traffic generator: offline batches drawn from a mix's data file.

A mix (``portbench/traffic/<name>.json``) gives the rung, the server's
``n_slots`` and ``max_len``, ``batch_requests`` and two length laws:

* ``prompt``: ``{"law": "lognormal", "median", "sigma", "min", "max"}``
  or ``{"law": "uniform", "min", "max"}``;
* ``output``: the same two laws, for the tokens each request generates.

Every batch holds the same lengths: request ``i`` of ``n`` takes the
``(i + 0.5) / n`` quantile of each law (clipped to ``[min, max]`` and
rounded).  The seed draws only which prompt length meets which output
length, the order of the requests, and the token ids, uniform over the
vocabulary.  So every seed asks for the same work.
"""

from __future__ import annotations

import json
import math
import statistics
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

LAWS = ("lognormal", "uniform")


def _quantile(law: dict, q: float) -> int:
    lo, hi = int(law["min"]), int(law["max"])
    if law["law"] == "lognormal":
        z = statistics.NormalDist().inv_cdf(q)
        v = float(law["median"]) * math.exp(float(law["sigma"]) * z)
        return int(min(max(round(v), lo), hi))
    if law["law"] == "uniform":
        return lo + min(int(q * (hi - lo + 1)), hi - lo)
    raise ValueError(f"unknown length law {law['law']!r}; known: {LAWS}")


@dataclass(frozen=True)
class Mix:
    name: str
    rung: str
    n_slots: int
    max_len: int
    batch_requests: int
    prompt: dict
    output: dict
    check_tokens: int

    @classmethod
    def load(cls, path: str, name: str) -> "Mix":
        with open(path) as f:
            d = json.load(f)
        mix = cls(name=name, rung=d["rung"], n_slots=int(d["n_slots"]),
                  max_len=int(d["max_len"]), batch_requests=int(d["batch_requests"]),
                  prompt=d["prompt"], output=d["output"], check_tokens=int(d["check_tokens"]))
        mix.validate()
        return mix

    def validate(self) -> None:
        if self.batch_requests < 1 or self.n_slots < 1:
            raise ValueError(f"{self.name}: batch_requests and n_slots must be >= 1")
        if min(self.prompt_lengths()) < 1 or min(self.output_lengths()) < 1:
            raise ValueError(f"{self.name}: every length must be >= 1")
        longest = max(self.prompt_lengths()) + max(self.output_lengths())
        if longest > self.max_len:
            raise ValueError(f"{self.name}: a prompt and its output ({longest}) exceed "
                             f"max_len {self.max_len}")

    def prompt_lengths(self) -> List[int]:
        n = self.batch_requests
        return [_quantile(self.prompt, (i + 0.5) / n) for i in range(n)]

    def output_lengths(self) -> List[int]:
        n = self.batch_requests
        return [_quantile(self.output, (i + 0.5) / n) for i in range(n)]

    def batch(self, seed: int, index: int, vocab: int) -> List[Tuple[List[int], int]]:
        """Batch ``index`` of seed ``seed``: ``batch_requests`` pairs of
        (prompt token ids, tokens to generate)."""
        rng = np.random.default_rng([int(seed) % (1 << 63), int(index), 0x7062])
        plens = rng.permutation(self.prompt_lengths())
        olens = rng.permutation(self.output_lengths())
        return [(rng.integers(0, vocab, int(p)).tolist(), int(o)) for p, o in zip(plens, olens)]

    def warmup(self, seed: int, vocab: int) -> List[Tuple[List[int], int]]:
        """One request per slot at the batch's longest prompts, each
        generating 2 tokens: every lane prefilled at the largest shapes
        the window meets, then one tick with every lane live."""
        rng = np.random.default_rng([int(seed) % (1 << 63), 0x7761726d])
        longest = sorted(self.prompt_lengths())[-self.n_slots:]
        return [(rng.integers(0, vocab, int(p)).tolist(), 2) for p in longest]
