#!/usr/bin/env python3
"""Where the time goes when the PyTorch port trains gemma2-2b on the card.

Usage (repository root, on a machine with an NVIDIA card)::

    python3 profile_torch_training.py [--seq 4096] [--out FILE]

Builds what ``chip_smoke.py``'s training phase trains (gemma2-2b at full
size, random weights from a seed, B = 1, ``SyntheticLM`` batches, AdamW)
and, per rung of ``TRAIN_STEP_LEVELS`` (``q16_16`` -> the ``"fast"``
mode, ``f32`` -> ``"precise"``), after one warm-up step:

* ``forward_ms``: ``train_loss`` without autograd (no remat recompute);
* ``forward_backward_ms``: ``train_loss`` and ``torch.autograd.grad``
  of every parameter (the remat recompute included);
* ``adamw_ms``: ``adamw_update`` (in place) on those gradients;
* ``step_ms``: one whole step (``make_train_step``), plain, and under
  ``torch.profiler`` the device's busy time (the summed times of its
  kernels and copies, one stream), the idle share ``1 - busy / plain
  wall``, the number of device operations and the kernels that take the
  most device time.

Every window ends in ``torch.cuda.synchronize()``; times are host clock
(milliseconds).  One JSON line per rung; the profiler's per-kernel
tables go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import TRAIN_SEQ  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=TRAIN_SEQ)
    ap.add_argument("--out", default=None,
                    help="profiler tables (default: build/profile-train.txt)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_training: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models.model import train_loss
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.train_loop import TRAIN_STEP_LEVELS, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_path = args.out or os.path.join(ROOT, "build", "profile-train.txt")
    cfg = get_config("gemma2_2b")
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=100)
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, TrainerConfig(ckpt_every=0, ckpt_dir=ckdir, seed=args.seed),
                          opt_cfg, DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=1,
                                              seed=args.seed))
    params, state = trainer.params, trainer.opt_state
    leaves = []

    def collect(node):
        for k in sorted(node):
            if isinstance(node[k], dict):
                collect(node[k])
            else:
                leaves.append(node[k])

    collect(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in trainer.data.batch(0).items()}
    sync = torch.cuda.synchronize

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    tables = []
    for level, mode in TRAIN_STEP_LEVELS:
        step = make_train_step(cfg, opt_cfg, mode)
        params, state, _ = step(params, state, batch)  # warm-up
        with torch.no_grad():
            _, fwd_ms = timed(lambda: float(train_loss(params, batch, cfg, mode=mode)[0]))

        def loss_and_grads():
            loss, _ = train_loss(params, batch, cfg, mode=mode)
            return torch.autograd.grad(loss, leaves)

        grads, fb_ms = timed(loss_and_grads)
        it = iter(grads)

        def rebuild(node):
            return {k: rebuild(node[k]) if isinstance(node[k], dict) else next(it)
                    for k in sorted(node)}

        gtree = rebuild(params)
        del grads, it
        _, opt_ms = timed(lambda: adamw_update(opt_cfg, params, gtree, state))
        del gtree
        torch.cuda.reset_peak_memory_stats()
        (params, state, _), step_ms = timed(lambda: step(params, state, batch))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            (params, state, _), prof_ms = timed(lambda: step(params, state, batch))
        events = prof.key_averages()
        on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in on_device)
        top = sorted(on_device, key=lambda e: e.self_device_time_total, reverse=True)
        rec = {"level": level, "mode": mode, "seq": args.seq, "batch": 1,
               "forward_ms": fwd_ms, "forward_backward_ms": fb_ms, "adamw_ms": opt_ms,
               "step_ms": step_ms, "tokens_per_s": args.seq / step_ms * 1e3,
               "peak_mem_gb": peak_gb, "device_busy_ms": busy_us / 1e3,
               "device_idle_share": 1.0 - busy_us / 1e3 / step_ms,
               "profiled_step_ms": prof_ms, "device_ops": sum(e.count for e in on_device),
               "top": [{"name": e.key[:70], "device_ms": e.self_device_time_total / 1e3,
                        "calls": e.count} for e in top[:12]],
               "nvidia_smi": smi}
        print(json.dumps(rec), flush=True)
        tables.append(f"=== {level} ({mode}) step, plain wall {step_ms:.3f} ms ===\n"
                      + events.table(sort_by="self_cuda_time_total", row_limit=40))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
