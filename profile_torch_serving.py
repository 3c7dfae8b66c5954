#!/usr/bin/env python3
"""Where the time goes when the PyTorch port serves a model on the card.

Usage (repository root, on a machine with an NVIDIA card)::

    python3 profile_torch_serving.py [--model MODEL] [--out FILE] [--windows prefill,decode]

Builds the full model (deepseek-7b by default, gemma2-2b,
granite-moe-3b-a800m, mamba2-1.3b or minicpm3-4b; jamba-v0.1-52b at full
width and one period of 8 layers, as ``chip_smoke.py`` runs it; random
weights from a seed) behind ``ContinuousBatchingServer(n_slots=4,
max_len=1024)`` (gemma2-2b and jamba: ``max_len=8192``) with the timing tier of the
server's telemetry on (no device barriers, no trace), and measures
windows of real ``serve()`` calls:

* ``prefill <n> <rung>``: one 480-token prompt (gemma2-2b: and one of
  4500 tokens, past the local layers' window; jamba too), ``max_new=1``;
* ``admit4``: four 64-token prompts, two per rung, ``max_new=1``;
* ``admit4+decode``: the same four with ``max_new=TICKS+1``; the
  difference of the two is ``decode``, ``TICKS`` mixed decode ticks;
* ``mixed``: the workload of ``chip_smoke.py`` (8 requests, prompt
  lengths 17-480, 16 new tokens each, half per rung; gemma2-2b adds one
  4500-token prompt per rung).

``--windows`` picks some of ``prefill``, ``decode`` and ``mixed`` (all by
default; the mixed window takes the longest to trace).

The warm-up serves one prompt of every timed length at both rungs, so
no timed window pays a kernel's first launch at its shapes (the cuBLAS
handles, the allocator's pools, the launchers' attribute setup).  Each
window is served twice on the same prompts: once plain, for the
host wall time and the server's ``tick_seconds`` / ``prefill_seconds``
sums, and once under ``torch.profiler`` for the device's busy time (the
summed times of the kernels and copies: one stream, so they do not
overlap).  The idle share is ``1 - busy / plain wall``; the wall time of
the profiled run, which tracing inflates, is printed beside it.  One JSON
line per window; the profiler's per-kernel tables go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import JAMBA_LAYERS  # noqa: E402

#: mirrors chip_smoke.py's mixed workload
PROMPT_LENS = (17, 32, 64, 96, 150, 200, 300, 480)
LEVELS = ("q16_16", "f32", "f32", "f32", "q16_16", "q16_16", "q16_16", "f32")
MAX_NEW = 16
#: decode ticks in the decode window
TICKS = 16
#: model -> (pool length, the long prompts its workload adds)
MODELS = {"deepseek_7b": (1024, ()), "gemma2_2b": (8192, (4500,)),
          "granite_moe_3b_a800m": (1024, ()), "mamba2_1_3b": (1024, ()),
          "minicpm3_4b": (1024, ()), "jamba_v01_52b": (8192, (4500,))}
#: models served at a cut depth (their f32 weights do not fit one card),
#: the depth chip_smoke.py serves them at
CUT_LAYERS = {"jamba_v01_52b": JAMBA_LAYERS}
PHASES = ("host_schedule", "device_dispatch", "sync")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="deepseek_7b")
    ap.add_argument("--out", default=None,
                    help="profiler tables (default: build/profile-<model>.txt)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--windows", default="prefill,decode,mixed",
                    help="comma-separated windows to time: prefill, decode, mixed")
    args = ap.parse_args(argv)
    windows = set(args.windows.split(","))
    if not windows <= {"prefill", "decode", "mixed"}:
        ap.error(f"--windows: unknown {sorted(windows - {'prefill', 'decode', 'mixed'})}")

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serving: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import ContinuousBatchingServer, Request, ServingConfig
    from repro_torch.runtime.telemetry import TelemetryConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    max_len, long_prompts = MODELS[args.model]
    out_path = args.out or os.path.join(ROOT, "build", f"profile-{args.model}.txt")
    cfg = get_config(args.model)
    if args.model in CUT_LAYERS:
        import dataclasses

        cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS[args.model])
    scfg = ServingConfig(n_slots=4, max_len=max_len,
                         telemetry=TelemetryConfig(enabled=True, trace=False))
    srv = ContinuousBatchingServer(cfg, init_params(cfg, seed=args.seed), scfg)
    rng = np.random.default_rng(args.seed)

    def prompt(n):
        return rng.integers(0, cfg.vocab, n).tolist()

    # warm-up at both rungs and every timed length: the prefill windows'
    # prompts, the decode window's 64-token lanes and the mixed workload's
    for n in sorted(set(PROMPT_LENS + (64,) + long_prompts)):
        srv.serve([Request(rid=srv.next_rid(), prompt=prompt(n), max_new=2, level=lv)
                   for lv in ("q16_16", "f32")])
    torch.cuda.synchronize()

    def phase_sums():
        snap = srv.metrics_snapshot()
        ticks = snap.get("tick_seconds", {})
        out = {p: ticks.get(f"phase={p}", {}).get("sum", 0.0) for p in PHASES}
        out["prefill"] = snap.get("prefill_seconds", {}).get("", {}).get("sum", 0.0)
        out["decode_ticks"] = snap["decode_ticks_total"]
        return out

    tables = []

    def window(name, specs):
        """Serve ``specs`` [(prompt, max_new, level)] plain, then under
        the profiler; print and return the window's record."""
        def requests():
            return [Request(rid=srv.next_rid(), prompt=p, max_new=n, level=lv)
                    for p, n, lv in specs]

        before = phase_sums()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.serve(requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = phase_sums()

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            srv.serve(requests())
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        events = prof.key_averages()
        on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in on_device)
        top = sorted(on_device, key=lambda e: e.self_device_time_total, reverse=True)
        rec = {
            "window": name, "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "profiled_wall_ms": prof_wall * 1e3,
            "device_ops": sum(e.count for e in on_device),
            "decode_ticks": after["decode_ticks"] - before["decode_ticks"],
            "host_ms": {k: (after[k] - before[k]) * 1e3 for k in PHASES + ("prefill",)},
            "top": [{"name": e.key[:60], "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top[:8]],
            "nvidia_smi": smi,
        }
        print(json.dumps(rec), flush=True)
        tables.append(f"=== {name} (plain wall {wall * 1e3:.3f} ms) ===\n"
                      + events.table(sort_by="self_cuda_time_total", row_limit=30))
        return rec

    for n in (480,) + long_prompts if "prefill" in windows else ():
        for lv in ("q16_16", "f32"):
            window(f"prefill {n} tokens at {lv}", [(prompt(n), 1, lv)])

    if "decode" in windows:
        four = [(prompt(64), lv) for lv in ("q16_16", "f32", "q16_16", "f32")]
        admit = window("admit4: four 64-token prefills (2 q16_16 + 2 f32)",
                       [(p, 1, lv) for p, lv in four])
        full = window(f"admit4+decode: the same four, {TICKS} decode ticks",
                      [(p, TICKS + 1, lv) for p, lv in four])
        wall = full["wall_ms"] - admit["wall_ms"]
        busy = full["device_busy_ms"] - admit["device_busy_ms"]
        print(json.dumps({
            "window": f"decode: {TICKS} mixed ticks, 4 lanes (admit4+decode - admit4)",
            "ticks": full["decode_ticks"], "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "wall_ms_per_tick": wall / TICKS, "device_busy_ms_per_tick": busy / TICKS,
            "host_ms_per_tick": {k: full["host_ms"][k] / TICKS for k in PHASES},
            "device_ops_per_tick": (full["device_ops"] - admit["device_ops"]) / TICKS,
            "nvidia_smi": smi,
        }), flush=True)

    if "mixed" in windows:
        lens = PROMPT_LENS + tuple(n for n in long_prompts for _ in range(2))
        levels = LEVELS + tuple(lv for _ in long_prompts for lv in ("q16_16", "f32"))
        mixed = [(prompt(n), MAX_NEW, lv) for n, lv in zip(lens, levels)]
        window(f"mixed: chip_smoke.py's {len(mixed)}-request workload", mixed)

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
