"""Deterministic synthetic token pipeline.

Reference: ``src/repro/data/pipeline.py`` (numpy only; a near-copy, so
a batch is bit for bit the reference's).

Production shape: per-host sharded, deterministic in ``(step, host)``
so a restarted or replaced worker regenerates exactly the batches it
would have seen — the data-side half of fault tolerance (the
checkpoint provides the model-side half).

The generator is numpy's ``default_rng`` keyed by ``(seed, step)``:
batch i is a pure function of (seed, step), never of pipeline state, so
there is nothing to checkpoint and no drift after elastic re-sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "host_shard"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 42                 # the paper's LCG seed
    num_hosts: int = 1
    host_id: int = 0
    # synthetic structure: repeated motifs make the LM loss actually
    # decrease, so examples/train_tiny_lm.py shows real learning curves
    motif_len: int = 16
    num_motifs: int = 64


def host_shard(cfg: DataConfig) -> slice:
    assert cfg.global_batch % cfg.num_hosts == 0, (cfg.global_batch, cfg.num_hosts)
    per = cfg.global_batch // cfg.num_hosts
    return slice(cfg.host_id * per, (cfg.host_id + 1) * per)


class SyntheticLM:
    """Batches of next-token-predictable synthetic text."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        self._motifs = base.integers(
            0, cfg.vocab, size=(cfg.num_motifs, cfg.motif_len), dtype=np.int32
        )

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step: the (host-local) batch for that step."""
        cfg = self.cfg
        sl = host_shard(cfg)
        rng = np.random.default_rng((cfg.seed, step))
        n_rows = cfg.global_batch
        reps = -(-(cfg.seq_len + 1) // cfg.motif_len)
        idx = rng.integers(0, cfg.num_motifs, size=(n_rows, reps))
        stream = self._motifs[idx].reshape(n_rows, -1)[:, : cfg.seq_len + 1]
        # sprinkle noise so the task is not trivially memorizable
        noise_mask = rng.random((n_rows, cfg.seq_len + 1)) < 0.02
        noise = rng.integers(0, cfg.vocab, size=(n_rows, cfg.seq_len + 1), dtype=np.int32)
        stream = np.where(noise_mask, noise, stream).astype(np.int32)
        local = stream[sl]
        return {
            "tokens": local[:, :-1],
            "labels": local[:, 1:],
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
