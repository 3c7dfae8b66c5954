#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

Usage (from the repository root, on a machine with the card)::

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --only kernels   # phases 1-2 only

Phases, each printing one JSON line:

1. device: ``nvidia-smi`` name and power limit, and the time to build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together);
2. kernels: K1 qmatmul, K2 fused SwiGLU, K3 CORDIC sincos and K4 flash
   attention against their plain PyTorch versions on the card, at
   deepseek-7b shapes — integer outputs bit-exact, float outputs within
   the stated tolerance — with kernel, plain and library times and the
   card's bound for the same work;
3. serving: ``ContinuousBatchingServer`` at the full published
   deepseek-7b width and depth (30 layers, random weights from a seed)
   answers 8 greedy requests, half at ``q16_16`` and half at ``f32``;
   every request must return 16 tokens, every kernel's launch counter
   must rise, logits must be finite, and the ``q16_16`` request that
   shared its passes only with ``f32`` lanes must give, served alone,
   the tokens it got in the mixed batch.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line again, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line is printed.  Without a card, or without the
rest of the repository beside it, the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


class Failure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(gen):
    """Returns {kernel name: record} with the slowest-shape numbers of
    each kernel; raises Failure on any disagreement."""
    import torch

    from repro_torch.kernels.cordic import (
        cordic_sincos,
        cordic_sincos_plain,
        rope_sincos_plain,
        rope_sincos_q16,
    )
    from repro_torch.kernels.flashattn import flash_attention, flash_attention_plain
    from repro_torch.kernels.fused_mlp import fused_swiglu, fused_swiglu_plain
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain

    dev = torch.device("cuda")
    records = {}

    def keep(name, rec):
        # the record of a kernel is the main-path shape with the most work
        if name not in records or rec["bound_ms"] >= records[name]["bound_ms"]:
            records[name] = rec

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8, device="cpu").to(dev)

    def i32(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32, device="cpu").to(dev)

    # K1 -------------------------------------------------------------------
    k1_cases = [(m, k, n, "float") for m in (1, 4, 512) for (k, n) in ((4096, 4096), (11008, 4096))]
    k1_cases += [(4, 4096, 4096, "q16"), (512, 4096, 4096, "int32")]
    for m, k, n, epi in k1_cases:
        a, b = i8(m, k), i8(k, n)
        ea = i32(-12, -4, 1)
        eb = i32(-30, 12, n) if epi == "q16" else i32(-12, -4, n)
        got = qmatmul(a, b, ea, eb, epi)
        want = qmatmul_plain(a, b, ea, eb, epi)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        err = (got.double() - want.double()).abs().max().item()
        rec = {"case": f"M={m} K={k} N={n} {epi}", "bit_exact": exact, "max_abs_err": err}
        require(exact, f"qmatmul {rec['case']} differs from its plain version (max err {err})")
        rec["ms"] = time_ms(lambda: qmatmul(a, b, ea, eb, epi))
        rec["plain_ms"] = time_ms(lambda: qmatmul_plain(a, b, ea, eb, epi), iters=5)
        rec["library_ms"] = (time_ms(lambda: torch._int_mm(a, b)) if m > 16 else None)
        out_bytes = 4 * m * n
        rec["bound_ms"], rec["bound_by"] = bound_ms(m * k + k * n + 4 * n + 4 + out_bytes,
                                                    2.0 * m * n * k, "int8")
        emit({"phase": "kernels", "kernel": "qmatmul", **rec})
        if epi == "float":
            keep("qmatmul", rec)

    # K2 -------------------------------------------------------------------
    for m in (1, 512):
        k, f = 4096, 11008
        x, wg, wu = i8(m, k), i8(k, f), i8(k, f)
        ea, eg, eu = i32(-8, -4, 1), i32(-12, -6, f), i32(-12, -6, f)
        out, gate, sig = fused_swiglu(x, wg, wu, ea, eg, eu, return_parts=True)
        w_out, w_gate, w_sig = fused_swiglu_plain(x, wg, wu, ea, eg, eu, return_parts=True)
        torch.cuda.synchronize()
        err = (out.double() - w_out.double()).abs().max().item()
        rel = ((out.double() - w_out.double()).abs() / w_out.double().abs().clamp_min(1e-30)).max().item()
        rec = {"case": f"M={m} K={k} F={f}", "gate_bit_exact": torch.equal(gate, w_gate),
               "sig_bit_exact": torch.equal(sig, w_sig), "max_abs_err": err, "max_rel_err": rel}
        require(rec["gate_bit_exact"] and rec["sig_bit_exact"],
                f"fused_swiglu {rec['case']}: gate/sigmoid differ from the plain version")
        # f32 rounding: one product order, each multiply rounded once
        require(rel <= 1e-6, f"fused_swiglu {rec['case']}: out rel err {rel} > 1e-6")
        rec["ms"] = time_ms(lambda: fused_swiglu(x, wg, wu, ea, eg, eu))
        rec["plain_ms"] = time_ms(lambda: fused_swiglu_plain(x, wg, wu, ea, eg, eu), iters=3)
        rec["library_ms"] = None
        rec["bound_ms"], rec["bound_by"] = bound_ms(m * k + 2 * k * f + 8 * f + 4 + 4 * m * f,
                                                    4.0 * m * k * f, "int8")
        emit({"phase": "kernels", "kernel": "fused_swiglu", **rec})
        keep("fused_swiglu", rec)

    # K3 -------------------------------------------------------------------
    pos = torch.arange(1024, dtype=torch.int32, device=dev)
    s_got, c_got = rope_sincos_q16(pos, 128)
    s_want, c_want = rope_sincos_plain(pos, 128)
    edges = torch.tensor([0, 1, -1, 2**31 - 1, -2**31, 2**31 - 205887, -2**31 + 205887,
                          102944, -102944, 205887, -205887, 411775, -411775, 2**30, -2**30],
                         dtype=torch.int32, device=dev)
    rnd = i32(-2**31, 2**31 - 1, 1 << 16)
    theta = torch.cat([edges, rnd])
    es, ec = cordic_sincos(theta)
    ws, wc = cordic_sincos_plain(theta)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in ((s_got, s_want), (c_got, c_want), (es, ws), (ec, wc)))
    rec = {"case": "1024 positions x 64 freqs + int32 edges", "bit_exact": exact,
           "max_abs_err": max((a - b).abs().max().item()
                              for a, b in ((s_got, s_want), (c_got, c_want), (es, ws), (ec, wc)))}
    require(exact, "cordic_sincos differs from its plain version")
    rec["ms"] = time_ms(lambda: rope_sincos_q16(pos, 128))
    rec["plain_ms"] = time_ms(lambda: rope_sincos_plain(pos, 128), iters=5)
    rec["library_ms"] = None
    n = pos.numel() * 64
    rec["bound_ms"], rec["bound_by"] = bound_ms(4 * pos.numel() + 8 * 64 + 8 * n, 0.0, "int8")
    emit({"phase": "kernels", "kernel": "cordic_sincos", **rec})
    keep("cordic_sincos", rec)

    # K4 -------------------------------------------------------------------
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k4_cases = [(s, dt, 32) for s in (17, 300, 1000) for dt in (torch.float32, torch.bfloat16)]
    k4_cases += [(300, torch.bfloat16, 8)]
    for s, dt, kv in k4_cases:
        h, d = 32, 128
        q = torch.randn(1, s, h, d, generator=gen).to(dev, dt)
        k = torch.randn(1, s, kv, d, generator=gen).to(dev, dt)
        v = torch.randn(1, s, kv, d, generator=gen).to(dev, dt)
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2e-3 if dt == torch.float32 else 2e-2
        name = "f32" if dt == torch.float32 else "bf16"
        rec = {"case": f"B=1 S={s} H={h} KV={kv} D={d} {name} causal", "max_abs_err": err,
               "tolerance": tol}
        require(math.isfinite(err) and err <= tol,
                f"flash_attention {rec['case']}: max err {err} > {tol}")
        rec["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=True))
        rec["plain_ms"] = time_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=5)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if kv == h:
            rec["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        else:
            rec["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
        pairs = s * (s + 1) / 2
        esz = 4 if dt == torch.float32 else 2
        rec["bound_ms"], rec["bound_by"] = bound_ms(esz * (2 * s * h * d + 2 * s * kv * d),
                                                    4.0 * h * pairs * d,
                                                    "f32" if dt == torch.float32 else "bf16")
        emit({"phase": "kernels", "kernel": "flash_attention", **rec})
        if dt == torch.bfloat16 and kv == h:
            keep("flash_attention", rec)
    return records


# ---------------------------------------------------------------------------
# phase 3: serving at the full deepseek-7b config
# ---------------------------------------------------------------------------

PROMPT_LENS = (17, 32, 64, 96, 150, 200, 300, 480)
MAX_NEW = 16


def _launch_counts():
    from repro_torch.kernels.cordic import cordic_sincos, rope_sincos_q16
    from repro_torch.kernels.flashattn import flash_attention
    from repro_torch.kernels.fused_mlp import fused_swiglu
    from repro_torch.kernels.qmatmul import qmatmul

    return {
        "qmatmul": qmatmul.launches,
        "fused_swiglu": fused_swiglu.launches,
        "cordic_sincos": cordic_sincos.launches + rope_sincos_q16.launches,
        "flash_attention": flash_attention.launches,
    }


def _reset_launch_counts():
    from repro_torch.kernels.cordic import cordic_sincos, rope_sincos_q16
    from repro_torch.kernels.flashattn import flash_attention
    from repro_torch.kernels.fused_mlp import fused_swiglu
    from repro_torch.kernels.qmatmul import qmatmul

    for fn in (qmatmul, fused_swiglu, cordic_sincos, rope_sincos_q16, flash_attention):
        fn.launches = 0


def serve_phase(seed: int):
    """Serve the mixed workload at the full deepseek-7b config; returns
    each kernel's launches in it."""
    import numpy as np
    import torch

    import repro_torch.runtime.serve as serve_mod
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import ContinuousBatchingServer, Request, ServingConfig

    cfg = get_config("deepseek_7b")
    dev = torch.device("cuda")
    max_len = 1024
    sync = torch.cuda.synchronize

    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=4, max_len=max_len),
                                   device=dev)
    sync()
    setup_s = time.perf_counter() - t0

    # every sampled row's logits must be finite: fold one device flag per
    # sampling call (no host sync inside the loop)
    finite_flags = []
    orig_finish = serve_mod._finish

    def finish_checked(logits, temperature, gen):
        finite_flags.append(torch.isfinite(logits).all())
        return orig_finish(logits, temperature, gen)

    serve_mod._finish = finish_checked

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    # FIFO over 4 slots: requests 0-3 run together, then 4-7.  Request 0
    # is the only q16_16 lane of its wave, so the isolation contract
    # (lanes of OTHER levels cannot perturb it) applies to it; q16_16
    # lanes sharing a pass share one per-tensor activation exponent by
    # design (reference serve.py docstring).
    levels = ["q16_16", "f32", "f32", "f32", "q16_16", "q16_16", "q16_16", "f32"]

    # warm-up: one short request per level (cuBLAS handles, allocator)
    srv.serve([Request(rid=srv.next_rid(), prompt=prompts[0][:8], max_new=2, level=lv)
               for lv in ("q16_16", "f32")])
    sync()

    reqs = [Request(rid=srv.next_rid(), prompt=p, max_new=MAX_NEW, level=lv)
            for p, lv in zip(prompts, levels)]
    stats0 = srv.stats
    _reset_launch_counts()
    t0 = time.perf_counter()
    fins = srv.serve(reqs)
    sync()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    ticks = srv.stats["decode_steps"] - stats0["decode_steps"]
    passes = srv.stats["level_passes"] - stats0["level_passes"]

    n_tokens = sum(f.n_generated for f in fins.values())
    all_finite = bool(torch.stack(finite_flags).all().item())

    # isolation contract: the q16_16 request alone gives its mixed-batch tokens
    iso = reqs[0]
    alone = srv.serve([Request(rid=srv.next_rid(), prompt=iso.prompt, max_new=MAX_NEW,
                               level="q16_16")])
    isolation_ok = next(iter(alone.values())).tokens == fins[iso.rid].tokens

    # launches of one prefill and of one decode pass, per level (a request
    # with max_new=1 is a prefill only; max_new=2 adds one decode tick)
    per_prefill, per_tick = {}, {}
    for lv in ("q16_16", "f32"):
        counts = []
        for n_new in (1, 2):
            _reset_launch_counts()
            srv.serve([Request(rid=srv.next_rid(), prompt=prompts[1], max_new=n_new, level=lv)])
            counts.append(_launch_counts())
        per_prefill[lv] = counts[0]
        per_tick[lv] = {k: counts[1][k] - counts[0][k] for k in counts[0]}

    # time to first token: one 480-token prompt alone per level
    ttft = {}
    for lv in ("q16_16", "f32"):
        sync()
        t1 = time.perf_counter()
        srv.serve([Request(rid=srv.next_rid(), prompt=prompts[-1], max_new=1, level=lv)])
        sync()
        ttft[lv] = (time.perf_counter() - t1) * 1e3
    serve_mod._finish = orig_finish

    emit({
        "phase": "serving", "model": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "n_slots": 4, "max_len": max_len, "requests": len(reqs), "prompt_lens": list(PROMPT_LENS),
        "max_new": MAX_NEW, "levels": levels, "generated_tokens": n_tokens,
        "serve_wall_s": wall, "tokens_per_s": n_tokens / wall,
        "ttft_ms_480": ttft, "setup_s": setup_s, "launches": launches,
        "launches_per_prefill": per_prefill, "launches_per_decode_tick": per_tick,
        "decode_ticks": ticks, "level_passes": passes,
        "all_logits_finite": all_finite, "isolation_ok": isolation_ok,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "nvidia_smi": nvidia_smi(),
    })
    for r in reqs:
        f = fins[r.rid]
        require(f.n_generated == MAX_NEW and len(f.tokens) == len(r.prompt) + MAX_NEW,
                f"request {r.rid} finished with {f.n_generated} tokens ({f.reason})")
    require(all_finite, "non-finite logits while serving")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched while serving")
    require(isolation_ok, "the q16_16 request served alone differs from its mixed-batch tokens")
    return launches


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="stop after the kernel phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the card", file=sys.stderr)
        return 2
    try:
        from repro_torch import compat
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc}); run from the "
              "repository root", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build = compat.build_kernels()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in compat.KERNEL_SOURCES:
        log = compat.BUILD_DIR / f"{name}.log"
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln][:8]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 3),
          "build_per_source_s": {k: round(v, 3) for k, v in build.items()}, "ptxas": ptxas})

    gen = torch.Generator().manual_seed(args.seed)
    records = check_kernels(gen)
    launches = {name: None for name in records}
    if args.only != "kernels":
        launches = serve_phase(args.seed)

    replaces = {
        "qmatmul": ("src/repro_torch/kernels/csrc/qmatmul.cu", "src/repro/kernels/qmatmul/qmatmul.py:50"),
        "fused_swiglu": ("src/repro_torch/kernels/csrc/fused_mlp.cu", "src/repro/kernels/fused_mlp/fused_mlp.py:115"),
        "cordic_sincos": ("src/repro_torch/kernels/csrc/cordic.cu", "src/repro/kernels/cordic/cordic.py:37"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flashattn.cu", "src/repro/kernels/flashattn/flashattn.py:37"),
    }
    kernels = []
    for name, (src, rep) in replaces.items():
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "case": r["case"],
        })
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
