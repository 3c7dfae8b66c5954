#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

Usage (from the repository root, on a machine with the card)::

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --only kernels   # phases 1-2 only
    python3 chip_smoke.py --only engine    # phases 1-3 (3b included)
    python3 chip_smoke.py --only kernels --root OTHER_CHECKOUT
                                           # another tree's kernels, same cases
    python3 chip_smoke.py --only moe [--root OTHER_CHECKOUT]
                                           # the MoE models' serving phases only

Phases, each printing JSON lines:

1. device: ``nvidia-smi`` name, power limit and maximum SM clock, the
   time to build the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and ptxas's registers
   and spills, then the count of tensor-core instructions (``HMMA`` /
   ``HGMMA``, ``IMMA`` / ``IGMMA``, from ``cuobjdump --dump-sass``) in
   K4's bf16 kernel and in K1's and K2's prefill tiles — none fails — and
   in K4's f32 kernel, the exact rung, with its ``FFMA`` and ``LDS.128``
   counts — any fails — and K3's, K5's and K6's instructions per CORDIC
   step, with K3's, K5's, K6's and K7's local memory (``LDL`` / ``STL``)
   — any fails — and K6's and K7's constant loads (a compiled schedule
   that loads one a step fails);
2. kernels: every kernel against its plain PyTorch version on the card —
   K1 qmatmul, K2 fused SwiGLU, K3 CORDIC sincos and K4 flash attention
   at deepseek-7b's and gemma2-2b's shapes (K1/K2 up to gemma2's
   4500-token prefill; K4 at head width 256, score softcap 50, window
   4096, 4500 tokens) and at the edges of the tensor-core tiles (K1 at
   M = 9..4500 with every epilogue and a ragged K, N; K4 bf16 and f32 at
   S = 17, 63, 65, 129, 1000 for D = 64, 128, 256, f32 also at widths off
   the 16-byte loads, a ragged non-causal Skv and windows past whole
   tiles), with a case that fails unless p is rounded to v's dtype, K3
   also on the engine's 2**24 angles (16 and 24 iterations), and K5-K7
   (the universal CORDIC family) on 2**24 words plus an edge-value tensor,
   K5 also on words whose every element is live (20, 13 and generic
   stage counts), K6 and K7 also at generic counts and through their
   float entries (``atan2_f32``, ``atan2_24_f32``, ``div_f32``: f32 in
   and out, held bit for bit against the to_fixed -> kernel -> from_fixed
   chain on 2**24 floats and a grid of float edges, NaN and +-inf
   included) — integer outputs bit-exact, float outputs within the stated
   tolerance — with kernel, plain and library times (device time: see
   :func:`time_ms`) and the card's bound for the same work; and the
   engine's deferred-correction matmul (C3, ``kernels/csrc/linalg.cu``)
   bit for bit against its plain version at M = K = N = 4096 (Q16.16 in
   [-1, 1), tile_k 32), on every M, K, N in (1, 17, 33, 1000) with tile_k
   in (1, 7, 32, 40, K), both roundings, saturating and wrapping, and on
   operands near +-32767.0 whose tiles saturate (library: the f32
   ``torch.matmul`` of the same shape, not the same function); from
   slice 9 also K1 and K2 at command-r-35b's widths (K2 K=8192 F=22528,
   K1 K=22528 N=8192; M = 4 and 480), K4 at head_dim 64 (24 heads over 8,
   S = 480 and 1000, f32 and bf16), and the grouped entries of the MoE
   experts, ``fused_swiglu_grouped`` and ``qmatmul_grouped``, bit for bit
   (out, and K2's gate and sigmoid parts) at granite-moe-3b-a800m's and
   mixtral-8x22b's prefill and decode shapes (GROUPED_K2 / GROUPED_K1)
   and at tile edges with every K1 epilogue, timed beside their bounds
   and a per-expert loop of ``torch._int_mm`` (library); from slice 13
   also at the 4500-token prefills' shapes, on routed rows (the port's
   own routing: granite 1- and 4-lane decode and 480-token prefill,
   mixtral's and jamba's 4-lane decode and 480-token prefill; each
   beside its routed bound, the live experts' weights and live rows), on
   the ``rows`` edges of both tile heights and right after NaN-filled
   blocks of the outputs' sizes were freed (an unwritten dead row fails);
3. engine: ``MathEngine`` calls atan2 div sqrt exp log tanh sigmoid sin
   cos on CUDA tensors of 2**24 elements at ``q16_16``, at ``f32`` and
   under ``PrecisionPolicy(default="q16_16", per_op={"atan2": "q8_24",
   "sin": "q8_24", "cos": "q8_24"})``; the fixed rungs must equal the
   plain bodies bit for bit and lie within the reference's accuracy
   bounds (tests/test_universal_cordic.py, tests/test_cordic.py,
   tests/test_precision_ladder.py) from the exact value, the policy's
   ``q8_24`` atan2 is timed, and K3 and K5-K7 must have run, K6 and K7
   through their float entries only (one pass an op);
3b. the engine's ``matmul`` at 4096**3 after one ``compile_op``: at
   ``q16_16`` (Q16.16 words) bit for bit the plain version with one
   kernel launch a call, at ``f32`` within the reference's float bound
   (tests/test_linalg.py::test_error_vs_float_bound: ceil(K/32) * 2**-17
   + 1e-6) of the float64 product, both rungs timed; then the port's
   three examples (``examples/torch_*.py``) run on the card, the
   sensor-fusion filter switching to f32 at step 180 and back at 239;
4. deepseek-7b serving: ``ContinuousBatchingServer`` at the full
   published width and depth (30 layers, random weights from a seed)
   answers 8 greedy requests, half at ``q16_16`` and half at ``f32``;
   every request must return 16 tokens, K1-K4 must have run, logits
   must be finite, the ``q16_16`` request that shared its passes only
   with ``f32`` lanes must give, served alone, its mixed-batch tokens,
   and K3 (the FAST RoPE tables) must run once per ``q16_16`` pass;
   then the segment steps from the served model's parameters: a
   480-token exact-rung prefill in a batch-1 cache, one ``segment_step``
   of S = 5 (the next token and 4 drafts) whose argmax at every position
   equals 5 sequential ``decode_step`` calls from a copy of the cache,
   ``commit_segment`` with keep_count 3 (accepted rows kept bit for bit
   and within f32 noise of the sequential decode's: layer 0 elementwise
   1e-4, every layer 1e-3 of the rows' rms; rejected rows the
   pre-segment rows bit for bit),
   the same segment on the FAST rung (K1, K2 and one K3 launch, finite
   logits), and a chunked prefill (128-token segments, the ragged last
   chunk's pad rows rolled back by ``commit_segment``) at ``f32`` that
   picks ``prefill_step``'s next token;
5. gemma2-2b serving (after deepseek-7b's weights are freed): the full
   published model (26 layers, local window 4096 / global, softcaps
   50 / 30, tied embeddings) on an 8192-token pool answers the same 8
   requests plus one 4500-token prompt per rung, which crosses the
   window in prefill and wraps the local layers' rolling buffers while
   decoding; every request returns 16 tokens, every logit is finite and
   within the final softcap (|logit| <= 30), K3 and K5 run once per
   ``q16_16`` pass, K4 once per layer of every prefill, and the isolation
   contract holds; then a segment of S = 5 at positions 4500-4504 after
   the 4500-token exact-rung prefill (the local layers' rolling buffers
   wrap inside it) whose argmaxes equal sequential decode at ``f32``, a
   commit with keep_count 2 that restores the wrapped slots bit for bit,
   and the same segment on the FAST rung (K1, K2, one K3 and one K5);
4b. (after 4's segments, on the same f32 tensors) deepseek-7b on the
   paged pool (4 slots, page 16, chunk 128): the 8 requests each return
   16 tokens with finite logits, the q16_16 request alone gives its
   batch tokens, the pool drains, K1-K3 run (K3 once per FAST chunk and
   pass) and K4 never; tokens/s, TTFT(480) and one ``device_view``
   gather timed beside the contiguous server's; then 4 speculative
   requests (17, 96, 300, 480 tokens, k = 4) at ``q8_8`` and at
   ``q16_16`` drafts against paged vanilla f32 on the same prompts:
   equal, or different only at a near tie (top-2 margin of the vanilla
   logits below 1e-2 at the first differing position), one K3 and the
   same K1 / K2 per draft pass; then 4 f32 requests sharing a 256-token
   prefix (chunk 16) against the same run without sharing: tokens equal,
   3 prefix hits, 768 tokens reused;
5b. (after 5's segments) gemma2-2b's 4500-token f32 request speculatively
   (k = 4, q16_16 drafts) on the contiguous pool (the draft's rollback
   across the window wrap) and on the paged pool (chunk 512): both give
   the mixed run's f32 tokens by the near-tie rule, one K3 and one K5
   per draft pass;
6. granite-moe-3b-a800m at its published width and depth (32 layers, 40
   experts top-8; slice 9): phase 4's mixed workload and TTFT(480) on the
   contiguous pool, with the MoE gates — every FAST pass launches the
   grouped K2 and K1 entries exactly ``n_layers`` times each and the dense
   K2 never, K4 ``n_layers`` times a contiguous prefill, the grouped
   entries' plain versions never run; then the int8 KV cache
   (``init_caches(quantized=True)``) against the f32 cache on a 480-token
   prefill and 16 teacher-forced decodes at both rungs (the largest
   logit difference against the logit scale, each cache's bytes); then
   4b's paged workload and speculative requests at ``q8_8`` and
   ``q16_16`` drafts (the grouped entries ``n_layers`` times a draft
   pass);
7. mixtral-8x22b at full width (d_model 6144, 8 experts of d_ff 16384,
   top-2, window 4096) and CUT_LAYERS of its 56 layers: the mixed
   workload plus one 4500-token prompt per rung on an 8192-token pool
   (a prompt crosses the window with MoE behind it), with the MoE gates;
8. command-r-35b at full width (d_model 8192, d_ff 22528, the 256000 x
   8192 tied embedding) and CUT_LAYERS of its 40 layers: six requests at
   both rungs on K1-K4;
9-11. (slice 10) mamba2-1.3b at full size (48 SSD layers), jamba-v0.1-52b
   at full width and JAMBA_LAYERS = 8 of its 32 layers (one period:
   attention, 7 mamba, 4 MLP, 4 MoE of 16 experts; max_len 8192 with a
   4500-token prompt per rung) and minicpm3-4b at full size (62 MLA
   layers): each serves the mixed workload on the contiguous pool, every
   FAST prefill and decode pass launching exactly its kernels
   (:func:`fast_pass_launches`: K1 on every projection, K2 once an MLP
   layer, the grouped entries once a MoE layer, K3 once a pass of a model
   with attention, none on mamba2) and K4 once an attention layer a
   prefill; then a segment against sequential decode (argmaxes equal,
   commits keeping latent rows and SSM states bit for bit and restoring
   rejected rows and an inactive lane bit for bit, a chunked f32 prefill
   picking ``prefill_step``'s token; every mamba layer alone, its
   segment's projections and norms run a row at a time, giving the
   decodes' states bit for bit), the contiguous draft restoring the
   pool bit for bit, the paged pool (chunked prefill, the SSM state
   carried from chunk to chunk, exact launches a chunk) and, for mamba2
   and minicpm3, speculative requests at both drafts on the paged pool
   held to vanilla ``f32`` by the near-tie rule; K1's and K2's plain
   versions must never run.  The kernels phase adds K1 at their
   projections (SLICE10_K1), K2 and the grouped entries at jamba's widths,
   K4 at D = 96, Dv = 64 and K3 at 16 frequencies;
12. (slice 11, in the kernels phase) K4's autograd Function: dq, dk, dv
   of bf16 operands (S = 17, 129, 1000; D = 64, 128, 256; 4 heads over
   2; without and with a window and softcap 50) within 1e-2 of each
   gradient's norm of f64 autograd through ``flash_attention_plain``,
   and forward + backward timed at gemma2-2b's training layer (S = 4096,
   8 over 4 heads of 256, cap 50) and at 32 x 128 beside SDPA's forward
   + backward;
13. gemma2-2b trained at full size by the ``Trainer`` (B = 1, S = 4096 of
   ``SyntheticLM``, checkpoints off): 3 steps at ``q16_16``,
   ``engine.set_level("f32")``, 3 more; every step's loss and grad norm
   finite, the parameters moved, step 0's ``q16_16`` loss within 0.5 of
   the ``f32`` loss on its batch, every step launching exactly
   :func:`train_step_launches` (K1, K3, K4, K5; remat's recompute
   counted; K2 never) and no plain version; step seconds, tokens/s and
   peak GB per rung;
14. the resume check on the card: gemma2's smoke config crashed at step
   10 and restarted from its checkpoint gives an uninterrupted run's
   losses for steps 10-15 within rel 1e-5 (retried under
   ``torch.use_deterministic_algorithms`` only if it fails, and then
   reported);
15. the modality stubs at full size, phi3-vision-4.2b (32 layers, d 3072,
   head_dim 96, prefix 576) and musicgen-large (48 layers, d 2048,
   head_dim 64, prefix 256): a 1000-token prefill with seeded
   ``extra_embeds`` and 16 greedy decodes at both rungs, exact launches a
   pass, finite logits, the prefix moving the logits, and without it the
   text model's logits bit for bit;
16. (slice 12) gemma2-2b's compressed data-parallel step at full size
   (B = 1, S = 4096 of ``SyntheticLM``) through ``make_dp_train_step``
   on a one-rank NCCL group (a local store) and a ("data",) mesh of 1:
   DP_STEPS, two FAST steps and one ``precise`` with ``compress_bits=8``,
   one ``precise`` with ``None`` (the f32 all-reduce); every loss and
   grad norm finite, each step launching exactly
   :func:`train_step_launches` at its rung, no plain version, the wire
   payloads int8 and 2 bytes an element (``2 x`` the padded numel), on
   step 0 the compressed mean equal to the local ``q 2**e`` and the new
   residual to ``g + r - q 2**e`` bit for bit on DP_RECORD, the group
   destroyed at the end; step seconds, the compression's milliseconds
   and peak GB reported;
17. (slice 12, after 16's group is gone) the dry-run
   (``launch.dryrun.run_cell``) of DRYRUN_CELLS on the (16, 16)
   ``single`` mesh at ``precise`` on a fake process group of 256 ranks:
   status ``ok``, FLOPs and collective bytes above zero, the per-device
   argument bytes equal to the rules' local shards; memory, FLOPs,
   collectives and the roofline terms reported as estimates (traced on
   meta tensors with the H100 constants, not measured).

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line again, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line is printed.  Without a card, or without the
rest of the repository beside it, the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
#: integer operations: 132 SMs x 128 lanes x the card's maximum SM clock
#: (read from nvidia-smi in main; operations per second).  An SM issues
#: four warp instructions a clock, to its 64 INT32 ALU lanes (shifts, adds,
#: logic, compares) and to the 64 lanes of its FMA pipe, which runs the
#: integer multiply-adds (IMAD: the CORDIC kernels' sign-scaled updates,
#: and the moves and adds ptxas puts there); counting the ALU lanes alone
#: put the K3 and K5 kernels above 100 % of their bound
N_SMS, INT32_LANES = 132, 128
DEVICE = "cuda"
#: words per K5-K7 check and per engine op
N_WORDS = 1 << 24


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


#: tensor-core instructions in SASS: mma.sync / wgmma, float and integer
TC_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA")
#: SASS instructions counted per kernel function: the tensor-core ones,
#: and FFMA and 128-bit shared-memory loads (the f32 attention kernel's
#: products and their operands)
SASS_OPS = {**{o: rf"\b{o}\b" for o in TC_OPS}, "FFMA": r"\bFFMA",
            "LDS.128": r"\bLDS[.\w]*\.128\b"}
#: library -> (kernel functions, the instructions each must hold): K1's
#: and K2's prefill tiles and the grouped entries' (G1, G2) tiles
TC_KERNELS = {"flashattn": (("flash_fwd_tc",), ("HMMA", "HGMMA")),
              "qmatmul": (("gemm_tc", "grouped_tc"), ("IMMA", "IGMMA")),
              "fused_mlp": (("gemm_tc", "grouped_tc"), ("IMMA", "IGMMA"))}
#: the exact rung's kernel: it must hold no tensor-core instruction (no TF32)
EXACT_KERNEL = ("flashattn", "flash_fwd_f32")


def sass_counts(lib: str, cuobjdump: str) -> dict:
    """{kernel function: {instruction: count}} of :data:`SASS_OPS` in
    ``lib``'s SASS (``cuobjdump --dump-sass``)."""
    import re

    text = subprocess.run([cuobjdump, "--dump-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    counts, func = {}, None
    ops = {name: re.compile(rx) for name, rx in SASS_OPS.items()}
    for line in text.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            counts[func] = {k: 0 for k in SASS_OPS}
        elif func is not None:
            for name, rx in ops.items():
                counts[func][name] += len(rx.findall(line))
    return counts


def sass_phase(compat) -> dict:
    """Counts the tensor-core instructions of the redesigned kernels in
    the built libraries, and the exact rung's FFMA and LDS.128; fails if a
    tensor-core kernel holds none, or the exact rung's kernel any."""
    cuobjdump = os.path.join(os.path.dirname(compat._nvcc()), "cuobjdump")
    out, libs = {}, {}
    for lib, (kernels, ops) in TC_KERNELS.items():
        libs[lib] = counts = sass_counts(str(compat._lib_path(lib)), cuobjdump)
        out[lib] = {}
        for kernel in kernels:
            mine = {f: c for f, c in counts.items() if kernel in f}
            require(bool(mine), f"lib{lib}.so holds no {kernel} kernel")
            for f, c in mine.items():
                require(sum(c[o] for o in ops) > 0, f"{f} in lib{lib}.so runs no {'/'.join(ops)}")
            out[lib][kernel] = {"functions": len(mine),
                                **{o: sum(c[o] for c in mine.values()) for o in TC_OPS}}
    lib, kernel = EXACT_KERNEL
    exact = {f: c for f, c in libs[lib].items() if kernel in f}
    require(bool(exact), f"lib{lib}.so holds no {kernel} kernel")
    for f, c in exact.items():
        require(sum(c[o] for o in TC_OPS) == 0, f"{f} (the exact rung) runs tensor-core "
                f"instructions: {c}")
    rung = {"kernel": kernel, "functions": len(exact),
            **{o: sum(c[o] for c in exact.values()) for o in SASS_OPS}}
    emit({"phase": "device", "tensor_core_sass": out, "exact_rung_sass": rung})
    return out


#: the CORDIC kernels K5 and K3: library -> a substring of their functions
CORDIC_KERNELS = {"universal": "unary", "cordic": "sincos"}
#: specialised step counts paired to count the instructions of one step:
#: K5's default schedule against the tests' 13 stages, K3's 24 iterations
#: (q8_24) against 16 (q16_16)
STEP_PAIRS = {"universal": (20, 13), "cordic": (24, 16)}


def sass_functions(lib: str, cuobjdump: str) -> dict:
    """{demangled function: [(address, opcode, branch target or None)]}
    of ``lib``'s SASS (``cuobjdump --dump-sass``)."""
    import re

    text = subprocess.run([cuobjdump, "--dump-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    rx = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        m = rx.search(line) if cur is not None else None
        if m:
            target = re.match(r"\s*(0x[0-9a-f]+)", m.group(3)) if "BRA" in m.group(2) else None
            cur.append((int(m.group(1), 16), m.group(2), int(target.group(1), 16) if target else None))
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(cuobjdump), "cu++filt")
    if os.path.exists(filt) and funcs:
        names = list(funcs)
        out = subprocess.run([filt, *names], capture_output=True, text=True).stdout.splitlines()
        if len(out) == len(names):
            funcs = {d.strip(): funcs[n] for n, d in zip(names, out)}
    return funcs


def cordic_sass(compat, src_dir: str, strict: bool) -> dict:
    """K5's and K3's SASS: instructions, local-memory accesses (LDL / STL),
    the bodies of their loops (backward branches, longest first) and, for
    each pair of specialisations in :data:`STEP_PAIRS`, the instructions
    of one CORDIC step of one element: their difference over the steps
    they differ by, the elements a thread steps together (``ILP`` in the
    source), the copies of the steps the kernel inlines and the step
    sequences an element runs (two for tanh and sigmoid); K6's and K7's
    under "pairs" (:func:`pair_sass`).  ``strict``: fail on any local
    memory."""
    import re

    cuobjdump = os.path.join(os.path.dirname(compat._nvcc()), "cuobjdump")
    out = {}
    for lib, key in CORDIC_KERNELS.items():
        funcs = sass_functions(str(compat._lib_path(lib)), cuobjdump)
        src = open(os.path.join(src_dir, f"{lib}.cu")).read()
        ilp = re.search(r"constexpr int ILP = (\d+);", src)
        # the step sequences of one element slot a kernel inlines: K5 once
        # per batch of a one-path tile (PER_THREAD / ILP, unrolled) and once
        # in its queue loop, K3 once
        per_thread = re.search(r"constexpr int PER_THREAD = (\d+);", src)
        copies = (int(per_thread.group(1)) // int(ilp.group(1)) + 1) if per_thread and ilp else 1
        rec = {}
        for name, ins in funcs.items():
            if key not in name:
                continue
            ops = [o for _, o, _ in ins if o != "NOP"]
            loops = sorted(((a - t) // 16 + 1 for a, _, t in ins if t is not None and t <= a),
                           reverse=True)
            rec[name] = {"instructions": len(ops), "LDL": sum(o.startswith("LDL") for o in ops),
                         "STL": sum(o.startswith("STL") for o in ops), "loops": loops[:6]}
            if strict:
                require(rec[name]["LDL"] + rec[name]["STL"] == 0,
                        f"{name} in lib{lib}.so uses local memory: {rec[name]}")
        hi, lo = STEP_PAIRS[lib]
        for name, r in rec.items():
            twin = name.replace(f"(int){hi}", f"(int){lo}").replace(f"Li{hi}E", f"Li{lo}E")
            if twin != name and twin in rec and ilp:
                # tanh and sigmoid (K5 ops 3, 4) step twice: near and far paths
                seqs = 2 if re.search(r"unary_kernel(<\(int\)|ILi)[34]\D", name) else 1
                r["instructions_per_step"] = ((r["instructions"] - rec[twin]["instructions"])
                                              / (hi - lo) / int(ilp.group(1)) / seqs / copies)
        out[lib] = rec
    out["pairs"] = pair_sass(compat, src_dir, cuobjdump, strict)
    emit({"phase": "device", "cordic_sass": out})
    return out


#: K6's two compiled schedules of int32 words, atan2_kernel<IO, FRAC, N>
#: at (0, 24, 24) and (0, 16, 16) as demangled and as mangled names, and
#: the steps they differ by
K6_SCHEDULES = (("<(int)0, (int)24, (int)24>", "ILi0ELi24ELi24EE"),
                ("<(int)0, (int)16, (int)16>", "ILi0ELi16ELi16EE"), 8)
#: the shortest schedule K6 or K7 compiles in (K6 at frac 16)
MIN_COMPILED_STEPS = 16


#: SASS opcodes that issue to an SM's FMA pipe (beside the ALU's 64 integer
#: lanes), to its conversion unit, and those that move data or steer
#: control rather than compute (not counted as a kernel's operations)
FMA_PIPE = ("IMAD", "FFMA", "FMUL", "FADD")
CONVERT = ("F2I", "I2F", "FRND", "MUFU", "FLO")
NOT_ARITH = ("LDG", "STG", "LDC", "ULDC", "S2R", "S2UR", "CS2R", "BRA", "EXIT", "BSSY",
             "BSYNC", "ULOP3", "UIADD3", "UMOV", "PLOP3", "CALL", "RET")


def pair_sass(compat, src_dir: str, cuobjdump: str, strict: bool) -> dict:
    """K6's and K7's SASS: instructions, local memory (LDL / STL), constant
    loads (LDC: a compiled kernel takes no table, so none a step) and the
    arithmetic by pipe (ALU, FMA pipe, conversions) of each function, and
    the instructions of one K6 step of one pair: the difference of its two
    compiled schedules over the steps they differ by and the pairs a
    thread takes (``V`` in the source).  ``strict``: fail on local memory,
    or on a compiled kernel with an LDC a step."""
    import re

    funcs = sass_functions(str(compat._lib_path("universal")), cuobjdump)
    v = re.search(r"constexpr int V = (\d+);", open(os.path.join(src_dir, "universal.cu")).read())
    out = {}
    for kernel in ("atan2_kernel", "div_kernel"):
        recs = {}
        for name, ins in funcs.items():
            if kernel not in name:
                continue
            base = [o.split(".")[0] for _, o, _ in ins if o != "NOP"]
            r = {"instructions": len(base), "LDL": base.count("LDL"), "STL": base.count("STL"),
                 "LDC": base.count("LDC"), "FMA": sum(o in FMA_PIPE for o in base),
                 "convert": sum(o in CONVERT for o in base),
                 "ALU": sum(o not in FMA_PIPE + CONVERT + NOT_ARITH for o in base)}
            recs[name] = r
            # a compiled schedule: the last template argument N is not 0
            compiled = not re.search(re.escape(kernel) + r"(?:<[^>]*\(int\)0>|I(?:Li\d+E)*Li0EE)",
                                     name)
            if strict:
                require(r["LDL"] + r["STL"] == 0, f"{name} uses local memory: {r}")
                require(not compiled or r["LDC"] < MIN_COMPILED_STEPS,
                        f"{name} (compiled) loads constants a step: {r}")
        out[kernel] = recs
    hi, lo = ([r for n, r in out["atan2_kernel"].items() if any(k in n for k in keys)]
              for keys in K6_SCHEDULES[:2])
    if len(hi) == 1 and len(lo) == 1 and v:
        out["atan2_kernel_instructions_per_step"] = (
            (hi[0]["instructions"] - lo[0]["instructions"]) / K6_SCHEDULES[2] / int(v.group(1)))
    elif strict:
        raise Failure("no atan2_kernel schedules (0, 24, 24) and (0, 16, 16) to count a step from")
    return out


#: SM clock (Hz) for the spin that holds the card while launches queue;
#: main() sets it from nvidia-smi
SPIN_CLOCK_HZ = 1.98e9


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events).

    The card first spins (``torch.cuda._sleep``) for twice the host time
    of the warm-up calls times ``iters`` (at most 2 s), so the host has
    queued every launch before the first one runs: the events time the
    device, not the wrapper's Python."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CLOCK_HZ * min(2.0 * iters * host_s + 1e-3, 2.0)))
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
# integer operations per element of the CORDIC kernels (the ops bound)
# ---------------------------------------------------------------------------
# K3 and K5 are counted from the bodies (src/repro_torch/kernels/csrc/
# cordic.cuh) as integer instructions: a CORDIC step is 2 shifts, 3 adds
# and 1 compare;
# the MSB cascade 5 x (compare, add, shift); a signed or rounding shift 4;
# the linear-vectoring divide normalises (cascade + 2 shifts) and runs 5
# ops per step.  Branches the data takes decide the count (an element on
# an early-exit path costs its few tests), as this run's inputs need.

STEP, ILOG2, SHIFT = 6, 15, 4


def _lindiv(iterations: int = 17) -> int:
    return ILOG2 + 2 * SHIFT + 5 * iterations


def _exp(stages: int) -> int:
    return 16 + STEP * stages


def unary_ops(op: str, w, stages: int) -> float:
    import torch

    n = w.numel()
    if op == "exp":
        live = int(((w > -772244) & (w < 681391)).sum())
        return 2.0 * n + live * _exp(stages)
    if op in ("sqrt", "log"):
        live = int((w > 0).sum())
        return 2.0 * n + live * (10 + ILOG2 + 2 * SHIFT + STEP * stages)
    t = torch.clamp_min(w, -(2**31) + 1)
    if op == "sigmoid":
        t = t >> 1
    at = t.abs()
    near = int((at <= 65536).sum())
    far_live = int(((at > 65536) & (at < 386122)).sum())
    far_early = n - near - far_live
    # past |t| = 5.89 exp(-2|t|) flushes to 0 and (1 - 0) / (1 + 0) is a
    # constant: the saturated tail costs its tests, not a division
    ops = (near * (10 + STEP * stages + _lindiv()) + far_live * (12 + _exp(stages) + _lindiv())
           + far_early * 8)
    return float(ops + (3 * n if op == "sigmoid" else 0))


# K6 and K7 are counted as the function needs, in K3's and K5's terms:
# a circular step is STEP, a linear-division step 5 (:func:`_lindiv`).
# A K6 pair adds the x < 0 fold-back and its tests (16), the ilog2 of
# max(|x|, |y|) and two normalising shifts; a K7 pair its signs, den == 0
# and saturation tests (20), two ilog2s and three shifts (two normalising,
# one by the exponent) — both operands go to the same bit, so the division
# needs no normalisation of its own.  (0, 0) and a zero denominator need
# only their tests (4 and 3), as this run's data says.  The float
# boundary adds a multiply and a rounding cast for each float in and a
# cast and a multiply out (BOUNDARY a pair); the Q8.24 rung also |y|,
# |x|, their max, s's compare and select, and one IEEE division (the
# larger operand's quotient is +-1): a reciprocal and five multiply-adds,
# its fast path.
BOUNDARY, DIVISION = 6, 6
NORMALISE = 5 + DIVISION


def atan2_ops(y, x, iterations: int) -> float:
    zero = int(((y == 0) & (x == 0)).sum())
    return 4.0 * zero + (y.numel() - zero) * (16 + ILOG2 + 2 * SHIFT + STEP * iterations)


def div_ops(num, den, iterations: int) -> float:
    zero = int((den == 0).sum())
    return 3.0 * zero + (num.numel() - zero) * (20 + 2 * ILOG2 + 3 * SHIFT + 5 * iterations)


def k3_ops(iterations: int = 16, rope: bool = False) -> int:
    """K3 per element: the fused RoPE phase (~12, RoPE form only), the
    range reduction (~8), the CORDIC steps and the sign flips."""
    return (12 if rope else 0) + 8 + iterations * STEP + 2


def k5_in_domain(op: str, n: int, gen):
    """int32 words on which every element of ``op`` takes a live path:
    sqrt and log over (0, 2**31), exp over +-10.0, tanh and sigmoid over
    +-4.0 (Q16.16)."""
    import torch

    lo, hi = {"sqrt": (1, 2**31 - 1), "log": (1, 2**31 - 1), "exp": (-10 * 65536, 10 * 65536),
              "tanh": (-4 * 65536, 4 * 65536), "sigmoid": (-4 * 65536, 4 * 65536)}[op]
    return torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int32)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(gen, strict: bool):
    """Returns {kernel name: record} with the record of each kernel's
    main-path shape with the most work (K5: tanh, the op serving runs;
    K6's and K7's float entries a record each); raises Failure on any
    disagreement.  ``strict``: the tree must have the float entries (a
    checkout given by --root may predate them)."""
    import torch

    from repro_torch.core.qformat import Q16_16, from_fixed
    from repro_torch.kernels.cordic import (
        UNARY_OPS,
        atan2_q16,
        atan2_q16_plain,
        cordic_sincos,
        cordic_sincos_plain,
        div_q16,
        div_q16_plain,
        rope_sincos_plain,
        rope_sincos_q16,
        universal_unary,
        universal_unary_plain,
    )
    from repro_torch.kernels.flashattn import (
        bf16_close,
        flash_attention,
        flash_attention_plain,
        p_rounding_case,
    )
    from repro_torch.kernels import fused_mlp as kfm
    from repro_torch.kernels.fused_mlp import fused_swiglu, fused_swiglu_plain
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain

    dev = torch.device(DEVICE)
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
    # deepseek-7b (K, N): wq/wk/wv/wo, w_down; gemma2-2b: wq, wk/wv, wo,
    # w_down — at decode (M=1, 4), prefill (512), the paged server's
    # 128-row prefill chunks and gemma2's 4500-token prefill; the model
    # runs the float epilogue, q16 and int32 once each
    k1_cases = [(m, k, n, "float") for m in (1, 4, PAGED_CHUNK, 512)
                for (k, n) in ((4096, 4096), (11008, 4096))]
    k1_cases += [(4, 4096, 4096, "q16"), (512, 4096, 4096, "int32")]
    k1_cases += [(PAGED_CHUNK, k, n, epi) for (k, n) in ((4096, 4096), (11008, 4096))
                 for epi in ("q16", "int32")]
    k1_cases += [(m, k, n, "float") for m in (1, 4, 512, LONG_PROMPT)
                 for (k, n) in ((2304, 2048), (2304, 1024), (2048, 2304), (9216, 2304))]
    k1_cases += [(m, k, n, epi) for (m, k, n) in ((4, 2304, 2048), (LONG_PROMPT, 9216, 2304))
                 for epi in ("q16", "int32")]
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

    # the tensor-core tiles' edges (64 or 128 rows, 128 columns, 64-deep k
    # steps; skinny below 9 rows) and a ragged K, N that takes the 4-byte
    # copies
    k1_edges = [(m, 2304, 2048) for m in (9, 16, 17, 65, 127, 129, 480, LONG_PROMPT)]
    k1_edges += [(m, 4100, 2052) for m in (9, 129, 480)]
    n_edges = 0
    for m, k, n in k1_edges:
        a, b = i8(m, k), i8(k, n)
        ea, eb = i32(-12, -4, 1), i32(-30, 12, n)
        for epi in ("float", "q16", "int32"):
            got, want = qmatmul(a, b, ea, eb, epi), qmatmul_plain(a, b, ea, eb, epi)
            require(torch.equal(got, want), f"qmatmul M={m} K={k} N={n} {epi} (tile edge) "
                    "differs from its plain version")
            n_edges += 1
    emit({"phase": "kernels", "kernel": "qmatmul", "case": "tile edges", "cases": n_edges,
          "shapes": [f"M={m} K={k} N={n}" for m, k, n in k1_edges], "bit_exact": True})

    # slice 10's projections (float epilogue), a decode tick and a 480-token
    # prefill: mamba2-1.3b's wz / wx (N=4096), wB / wC (128), wdt (64) and
    # wo (K=4096 N=2048); jamba's wB / wC (N=16) and wdt (128) at K=4096;
    # minicpm3-4b's wkv_a (K=2560 N=288) and wq_b (K=768 N=3840)
    for m, k, n in SLICE10_K1:
        a, b = i8(m, k), i8(k, n)
        ea, eb = i32(-12, -4, 1), i32(-12, -4, n)
        got, want = qmatmul(a, b, ea, eb), qmatmul_plain(a, b, ea, eb)
        torch.cuda.synchronize()
        rec = {"case": f"M={m} K={k} N={n} float ({SLICE10_K1[(m, k, n)]})",
               "bit_exact": torch.equal(got, want),
               "max_abs_err": (got.double() - want.double()).abs().max().item()}
        require(rec["bit_exact"], f"qmatmul {rec['case']} differs from its plain version")
        rec["ms"] = time_ms(lambda: qmatmul(a, b, ea, eb))
        rec["plain_ms"] = time_ms(lambda: qmatmul_plain(a, b, ea, eb), iters=5)
        rec["library_ms"] = time_ms(lambda: torch._int_mm(a, b)) if m > 16 else None
        rec["bound_ms"], rec["bound_by"] = bound_ms(m * k + k * n + 4 * n + 4 + 4 * m * n,
                                                    2.0 * m * n * k, "int8")
        emit({"phase": "kernels", "kernel": "qmatmul", **rec})
        keep("qmatmul", rec)

    # K2 -------------------------------------------------------------------
    # deepseek-7b (K=4096, F=11008) and gemma2-2b (K=2304, F=9216); M=4 is
    # a tick of four lanes and a draft pass, M=128 a paged prefill chunk
    k2_cases = [(m, 4096, 11008) for m in (1, 4, PAGED_CHUNK, 480, 512)]
    k2_cases += [(m, 2304, 9216) for m in (1, 4, 9, 512, LONG_PROMPT)]
    # slice 10: jamba's MLP (K=4096, F=14336) and minicpm3-4b's (2560, 6400)
    k2_cases += [(m, k, f) for m in (4, 480) for (k, f) in ((4096, 14336), (2560, 6400))]
    for m, k, f in k2_cases:
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

    # command-r-35b's widths (slice 9), the widest K1 / K2 run: K2 at K=8192
    # F=22528 and K1 (w_down) at K=22528 N=8192, a decode tick and a prefill
    for m in (4, CR_PROMPT):
        x, wg, wu = i8(m, 8192), i8(8192, 22528), i8(8192, 22528)
        ea, eg, eu = i32(-8, -4, 1), i32(-12, -6, 22528), i32(-12, -6, 22528)
        out, gate, sig = fused_swiglu(x, wg, wu, ea, eg, eu, return_parts=True)
        want = fused_swiglu_plain(x, wg, wu, ea, eg, eu, return_parts=True)
        require(all(torch.equal(a, b) for a, b in zip((out, gate, sig), want)),
                f"fused_swiglu M={m} K=8192 F=22528 (command-r) differs from its plain version")
        rec = {"case": f"M={m} K=8192 F=22528 (command-r)", "bit_exact": True,
               "ms": time_ms(lambda: fused_swiglu(x, wg, wu, ea, eg, eu))}
        rec["bound_ms"], rec["bound_by"] = bound_ms(m * 8192 + 2 * 8192 * 22528 + 8 * 22528 + 4
                                                    + 4 * m * 22528, 4.0 * m * 8192 * 22528,
                                                    "int8")
        emit({"phase": "kernels", "kernel": "fused_swiglu", **rec})
        del x, wg, wu
        a, b = i8(m, 22528), i8(22528, 8192)
        ea, eb = i32(-12, -4, 1), i32(-12, -4, 8192)
        require(torch.equal(qmatmul(a, b, ea, eb), qmatmul_plain(a, b, ea, eb)),
                f"qmatmul M={m} K=22528 N=8192 (command-r) differs from its plain version")
        rec = {"case": f"M={m} K=22528 N=8192 (command-r)", "bit_exact": True,
               "ms": time_ms(lambda: qmatmul(a, b, ea, eb)),
               "plain_ms": time_ms(lambda: qmatmul_plain(a, b, ea, eb), iters=3),
               "library_ms": time_ms(lambda: torch._int_mm(a, b)) if m > 16 else None}
        rec["bound_ms"], rec["bound_by"] = bound_ms(m * 22528 + 22528 * 8192 + 4 * 8192 + 4
                                                    + 4 * m * 8192, 2.0 * m * 8192 * 22528,
                                                    "int8")
        emit({"phase": "kernels", "kernel": "qmatmul", **rec})
        del a, b

    # the grouped K1 / K2 entries (slice 9): the MoE experts --------------
    if hasattr(kfm, "fused_swiglu_grouped"):
        check_grouped(records, keep, i8, i32)
    else:
        require(not strict, "the grouped K1 / K2 entries are missing")

    # K3 -------------------------------------------------------------------
    # deepseek-7b RoPE (128 wide: 64 frequencies) and gemma2-2b's (256: 128)
    edges = torch.tensor([0, 1, -1, 2**31 - 1, -2**31, 2**31 - 205887, -2**31 + 205887,
                          102944, -102944, 205887, -205887, 411775, -411775, 2**30, -2**30],
                         dtype=torch.int32, device=dev)
    theta = torch.cat([edges, i32(-2**31, 2**31 - 1, 1 << 16)])
    es, ec = cordic_sincos(theta)
    ws, wc = cordic_sincos_plain(theta)
    # and (slice 10) minicpm3-4b's MLA, whose rotated part is 32 wide: 16
    for n_pos, rope_dim in ((1024, 128), (4500, 256), (1024, 32)):
        pos = torch.arange(n_pos, dtype=torch.int32, device=dev)
        s_got, c_got = rope_sincos_q16(pos, rope_dim)
        s_want, c_want = rope_sincos_plain(pos, rope_dim)
        torch.cuda.synchronize()
        pairs = ((s_got, s_want), (c_got, c_want), (es, ws), (ec, wc))
        exact = all(torch.equal(a, b) for a, b in pairs)
        rec = {"case": f"{n_pos} positions x {rope_dim // 2} freqs + int32 edges",
               "bit_exact": exact,
               "max_abs_err": max((a - b).abs().max().item() for a, b in pairs)}
        require(exact, "cordic_sincos differs from its plain version")
        rec["ms"] = time_ms(lambda: rope_sincos_q16(pos, rope_dim))
        rec["plain_ms"] = time_ms(lambda: rope_sincos_plain(pos, rope_dim), iters=5)
        rec["library_ms"] = None
        n = n_pos * rope_dim // 2
        rec["bound_ms"], rec["bound_by"] = bound_ms(4 * n_pos + 4 * rope_dim + 8 * n,
                                                    float(k3_ops(rope=True)) * n, "int32")
        emit({"phase": "kernels", "kernel": "cordic_sincos", **rec})
        keep("cordic_sincos", rec)
    # the engine's sin / cos: 2**24 angles over the whole int32 circle, at
    # q16_16 (16 iterations) and q8_24 (24 iterations, frac bits 24)
    theta = i32(-2**31, 2**31 - 1, N_WORDS)
    tf = theta.float() / 65536.0
    for it in (16, 24):
        got, want = cordic_sincos(theta, it, it), cordic_sincos_plain(theta, it, it)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        rec = {"case": f"2**24 angles, iterations={it} frac_bits={it} (engine sin/cos)",
               "bit_exact": exact,
               "max_abs_err": max((a - b).abs().max().item() for a, b in zip(got, want))}
        require(exact, f"cordic_sincos {rec['case']} differs from its plain version")
        rec["ms"] = time_ms(lambda: cordic_sincos(theta, it, it))
        rec["plain_ms"] = time_ms(lambda: cordic_sincos_plain(theta, it, it), iters=2, warmup=1)
        rec["library_ms"] = time_ms(lambda: (torch.sin(tf), torch.cos(tf)))
        rec["library"] = "torch.sin + torch.cos on f32 (float analogue, not the same bits)"
        rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * N_WORDS, float(k3_ops(it)) * N_WORDS,
                                                    "int32")
        emit({"phase": "kernels", "kernel": "cordic_sincos", **rec})
    del theta, tf

    # K4 -------------------------------------------------------------------
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def k4_case(s, h, kv, d, dt, window=None, cap=None, scale=1.0, dv=None):
        dv = dv or d
        q = (scale * torch.randn(1, s, h, d, generator=gen)).to(dev, dt)
        k = (scale * torch.randn(1, s, kv, d, generator=gen)).to(dev, dt)
        v = torch.randn(1, s, kv, dv, generator=gen).to(dev, dt)
        kw = dict(causal=True, window=window, softcap=cap)
        got = flash_attention(q, k, v, **kw).float()
        want = flash_attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        name = "f32" if dt == torch.float32 else "bf16"
        rec = {"case": f"B=1 S={s} H={h} KV={kv} D={d}{f' Dv={dv}' if dv != d else ''} {name} "
                       f"causal window={window} softcap={cap}", "max_abs_err": err}
        if dt == torch.float32:
            rec["tolerance"] = "abs 2e-3"
            ok = math.isfinite(err) and err <= 2e-3
        else:
            rec["tolerance"] = "2**-6 * (|want| + row rms of want)"
            ok = math.isfinite(err) and bf16_close(got, want)
        require(ok, f"flash_attention {rec['case']}: max err {err} outside {rec['tolerance']}")
        rec["ms"] = time_ms(lambda: flash_attention(q, k, v, **kw))
        rec["plain_ms"] = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=3)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if cap is not None or window is not None:
            rec["library_ms"] = None   # SDPA has no score softcap
        elif kv == h:
            rec["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        else:
            rec["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
        pairs = sum(min(i + 1, window or s) for i in range(s))
        esz = 4 if dt == torch.float32 else 2
        rec["bound_ms"], rec["bound_by"] = bound_ms(esz * (s * h * (d + dv) + s * kv * (d + dv)),
                                                    2.0 * h * pairs * (d + dv),
                                                    "f32" if dt == torch.float32 else "bf16")
        emit({"phase": "kernels", "kernel": "flash_attention", **rec})
        keep("flash_attention", rec)

    for s in (17, 300, 1000):
        for dt in (torch.float32, torch.bfloat16):
            k4_case(s, 32, 32, 128, dt)
    k4_case(480, 32, 32, 128, torch.float32)   # deepseek-7b's TTFT prompt
    for dt in (torch.float32, torch.bfloat16):
        k4_case(300, 32, 8, 128, dt)
    # granite-moe-3b-a800m prefill (slice 9): head_dim 64, 24 heads over 8
    # kv heads — the <= 128 class with half of each 128-wide tile masked
    for s in (480, 1000):
        for dt in (torch.float32, torch.bfloat16):
            k4_case(s, 24, 8, 64, dt)
    # minicpm3-4b's MLA prefill (slice 10): 40 heads over 40, keys of
    # nope + rope = 96 and values of 64 (D != Dv in the <= 128 class)
    for dt in (torch.float32, torch.bfloat16):
        k4_case(480, 40, 40, 96, dt, dv=64)
    # gemma2-2b prefill: 8 heads of 256 over 4 kv heads, scores capped at
    # 50, the local layers' window of 4096 crossed by a 4500-token prompt
    for window in (None, 4096):
        for dt in (torch.float32, torch.bfloat16):
            k4_case(4500, 8, 4, 256, dt, window=window, cap=50.0, scale=2.0)
    # the bf16 kernel's 128- (64 at D = 256 on small grids) query blocks and
    # 64- (D <= 128) or 32-key (D = 256) tiles at and around their edges,
    # 32 heads over 8 kv heads
    worst = 0.0
    for s in (17, 63, 65, 129, 1000):
        for d in (64, 128, 256):
            q, k, v = (torch.randn(1, s, hh, d, generator=gen).to(dev, torch.bfloat16)
                       for hh in (32, 8, 8))
            got = flash_attention(q, k, v).float()
            want = flash_attention_plain(q, k, v).float()
            require(bf16_close(got, want), f"flash_attention bf16 S={s} D={d} 32/8 heads "
                    "(tile edge) outside 2**-6 * (|want| + row rms)")
            worst = max(worst, (got - want).abs().max().item())
    emit({"phase": "kernels", "kernel": "flash_attention", "case": "bf16 tile edges S in "
          "(17, 63, 65, 129, 1000) x D in (64, 128, 256), 32/8 heads", "max_abs_err": worst})
    # the f32 kernel's 64- or 128-query blocks and 128-key tiles at and
    # around their edges, 32 heads over 8 (S = 2000 fills the card with
    # 128-query blocks, S <= 129 takes 64), widths off the 16-byte loads
    # (D = 37, Dv = 22 takes the 4-byte path), a non-causal call with a
    # ragged Skv and windows past whole tiles; abs 2e-3 as every f32 case
    f32_edges = [dict(s=s, d=d) for s in (17, 63, 65, 129, 1000) for d in (64, 128, 256)]
    f32_edges += [dict(s=2000, d=128), dict(s=77, d=36, dv=20), dict(s=77, d=37, dv=22),
                  dict(s=70, skv=130, d=128, causal=False), dict(s=1000, d=128, window=130),
                  dict(s=1000, d=256, window=130, cap=50.0)]
    worst = 0.0
    for e in f32_edges:
        s, d, dv, skv = e["s"], e["d"], e.get("dv", e["d"]), e.get("skv", e["s"])
        q = torch.randn(1, s, 32, d, generator=gen).to(dev)
        k = torch.randn(1, skv, 8, d, generator=gen).to(dev)
        v = torch.randn(1, skv, 8, dv, generator=gen).to(dev)
        kw = dict(causal=e.get("causal", True), window=e.get("window"), softcap=e.get("cap"))
        got, want = flash_attention(q, k, v, **kw), flash_attention_plain(q, k, v, **kw)
        err = (got - want).abs().max().item()
        require(math.isfinite(err) and err <= 2e-3, f"flash_attention f32 {e} 32/8 heads (tile "
                f"edge): max err {err} outside abs 2e-3")
        worst = max(worst, err)
    emit({"phase": "kernels", "kernel": "flash_attention", "case": "f32 tile edges",
          "cases": f32_edges, "tolerance": "abs 2e-3", "max_abs_err": worst})
    # p must be rounded to v's dtype before P.V
    q, k, v = p_rounding_case(dev)
    got = flash_attention(q, k, v, causal=False).float()
    want = flash_attention_plain(q, k, v, causal=False).float()
    emit({"phase": "kernels", "kernel": "flash_attention", "case": "p rounded to bf16 before P.V",
          "max_abs_err": (got - want).abs().max().item(), "want_mean": want.mean().item()})
    require(bf16_close(got, want), "flash_attention: p is not rounded to v's dtype before P.V")

    # K5-K7 ----------------------------------------------------------------
    def words(seed):
        g = torch.Generator().manual_seed(seed)
        half = N_WORDS // 2
        return torch.cat([
            torch.randint(-(2**31), 2**31 - 1, (half,), generator=g, dtype=torch.int32),
            torch.randint(-40 * 65536, 40 * 65536, (N_WORDS - half,), generator=g,
                          dtype=torch.int32),
        ]).to(dev)

    edge_vals = [0, 1, -1, 2, -2, 3, 65535, 65536, 65537, -65536, 32768, 2**31 - 1, -(2**31),
                 -(2**31) + 1, 2**31 - 2, 123456789, -123456789, 681391, -772244, 2**30, -(2**30)]
    edge = torch.tensor(edge_vals + list(range(-40, 41)), dtype=torch.int32, device=dev)
    ey, ex = (t.reshape(-1).contiguous() for t in torch.meshgrid(edge, edge, indexing="ij"))

    w = words(5)
    wf = from_fixed(w, Q16_16)
    for op in sorted(UNARY_OPS):
        for stages in (20, 13):
            got, want = universal_unary(w, op, stages), universal_unary_plain(w, op, stages)
            g_e, w_e = universal_unary(edge, op, stages), universal_unary_plain(edge, op, stages)
            torch.cuda.synchronize()
            exact = torch.equal(got, want) and torch.equal(g_e, w_e)
            rec = {"case": f"{op} stages={stages} 2**24 words + {edge.numel()} edges",
                   "bit_exact": exact, "max_abs_err": (got.double() - want.double()).abs().max().item()}
            require(exact, f"universal_unary {rec['case']} differs from its plain version")
            rec["ms"] = time_ms(lambda: universal_unary(w, op, stages))
            rec["plain_ms"] = time_ms(lambda: universal_unary_plain(w, op, stages), iters=2, warmup=1)
            fn = getattr(torch, op)
            rec["library_ms"] = time_ms(lambda: fn(wf))
            rec["library"] = f"torch.{op} on f32 (float analogue, not the same bits)"
            rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * w.numel(),
                                                        unary_ops(op, w, stages), "int32")
            emit({"phase": "kernels", "kernel": "universal_unary", **rec})
            if op == "tanh" and stages == 20:
                records["universal_unary"] = rec
        # every element live (tanh / sigmoid still mix their near and far
        # paths), at the default schedule; generic schedules on a slice
        wi = k5_in_domain(op, N_WORDS, gen).to(dev)
        wif = from_fixed(wi, Q16_16)
        for stages in (20, 13, 7, 64):
            x = wi if stages in (20, 13) else wi[: 1 << 20]
            exact = (torch.equal(universal_unary(x, op, stages), universal_unary_plain(x, op, stages))
                     and torch.equal(universal_unary(edge, op, stages),
                                     universal_unary_plain(edge, op, stages)))
            require(exact, f"universal_unary {op} stages={stages} (in-domain words) differs "
                    "from its plain version")
        rec = {"case": f"{op} stages=20 2**24 in-domain words", "bit_exact": True,
               "checked_stages": [20, 13, 7, 64], "max_abs_err": 0.0,
               "ms": time_ms(lambda: universal_unary(wi, op, 20)),
               "plain_ms": time_ms(lambda: universal_unary_plain(wi, op, 20), iters=2, warmup=1),
               "library_ms": time_ms(lambda: getattr(torch, op)(wif))}
        rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * wi.numel(), unary_ops(op, wi, 20),
                                                    "int32")
        emit({"phase": "kernels", "kernel": "universal_unary", **rec})
        del wi, wif

    x = words(6)
    y = torch.roll(x, 7)
    xf, yf = from_fixed(x, Q16_16), from_fixed(y, Q16_16)
    for fb in (16, 24):
        got, want = atan2_q16(y, x, fb, fb), atan2_q16_plain(y, x, fb, fb)
        g_e, w_e = atan2_q16(ey, ex, fb, fb), atan2_q16_plain(ey, ex, fb, fb)
        torch.cuda.synchronize()
        exact = torch.equal(got, want) and torch.equal(g_e, w_e)
        rec = {"case": f"frac_bits={fb} iterations={fb} 2**24 pairs + {ey.numel()} edge pairs",
               "bit_exact": exact, "max_abs_err": (got.double() - want.double()).abs().max().item()}
        require(exact, f"atan2_q16 {rec['case']} differs from its plain version")
        rec["ms"] = time_ms(lambda: atan2_q16(y, x, fb, fb))
        rec["plain_ms"] = time_ms(lambda: atan2_q16_plain(y, x, fb, fb), iters=2, warmup=1)
        rec["library_ms"] = time_ms(lambda: torch.atan2(yf, xf))
        rec["library"] = "torch.atan2 on f32 (float analogue, not the same bits)"
        rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * x.numel(), atan2_ops(y, x, fb), "int32")
        emit({"phase": "kernels", "kernel": "atan2_q16", **rec})
        keep("atan2_q16", rec)

    got, want = div_q16(y, x), div_q16_plain(y, x)
    g_e, w_e = div_q16(ey, ex), div_q16_plain(ey, ex)
    torch.cuda.synchronize()
    exact = torch.equal(got, want) and torch.equal(g_e, w_e)
    rec = {"case": f"iterations=17 2**24 pairs + {ey.numel()} edge pairs (tiny and zero "
                   "denominators)", "bit_exact": exact,
           "max_abs_err": (got.double() - want.double()).abs().max().item()}
    require(exact, f"div_q16 {rec['case']} differs from its plain version")
    rec["ms"] = time_ms(lambda: div_q16(y, x))
    rec["plain_ms"] = time_ms(lambda: div_q16_plain(y, x), iters=2, warmup=1)
    rec["library_ms"] = time_ms(lambda: torch.div(yf, xf))
    rec["library"] = "torch.div on f32 (float analogue, not the same bits)"
    rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * x.numel(), div_ops(y, x, 17), "int32")
    emit({"phase": "kernels", "kernel": "div_q16", **rec})
    keep("div_q16", rec)

    # counts outside the compiled schedules (the per-element route), on
    # a slice of the words and on the edge grid
    ys, xs = y[: 1 << 20], x[: 1 << 20]
    for it, fb in ((7, 16), (32, 16), (7, 24), (32, 24), (16, 24)):
        require(torch.equal(atan2_q16(ys, xs, it, fb), atan2_q16_plain(ys, xs, it, fb))
                and torch.equal(atan2_q16(ey, ex, it, fb), atan2_q16_plain(ey, ex, it, fb)),
                f"atan2_q16 iterations={it} frac_bits={fb} differs from its plain version")
    for it in (9, 32):
        require(torch.equal(div_q16(ys, xs, it), div_q16_plain(ys, xs, it))
                and torch.equal(div_q16(ey, ex, it), div_q16_plain(ey, ex, it)),
                f"div_q16 iterations={it} differs from its plain version")
    emit({"phase": "kernels", "kernel": "atan2_q16 / div_q16", "case": "generic counts on "
          f"2**20 pairs + {ey.numel()} edge pairs", "atan2": [[7, 16], [32, 16], [7, 24],
          [32, 24], [16, 24]], "div": [9, 32], "bit_exact": True})

    from repro_torch.kernels import cordic as kc

    has_float = all(hasattr(kc, n) for n in FLOAT_ENTRIES)
    require(has_float or not strict, f"the float entries {FLOAT_ENTRIES} are missing")
    if has_float:
        check_float_entries(kc, xf, yf, keep)
    require(_has_c3() or not strict, "kernels.linalg (the deferred matmul) is missing")
    if _has_c3():
        del x, y, xf, yf, w, wf
        check_deferred(gen, keep)
    return records


#: the grouped entries' main-path shapes (E experts, M = B x C rows of
#: each, K, N): granite-moe-3b-a800m (40 experts, d_model 1536, d_ff 512)
#: at a 480-token prefill (C = 120) and a 4-lane decode pass (C = 8, the
#: capacity floor: M = 32), mixtral-8x22b (8 experts, 6144, 16384) at a
#: 480-token prefill (C = 152) and a decode pass; a single-lane pass (M =
#: 8) takes the skinny shape
GROUPED_K2 = ((40, 120, 1536, 512), (40, 32, 1536, 512), (40, 8, 1536, 512),
              (8, 152, 6144, 16384), (8, 32, 6144, 16384),
              # jamba-v0.1-52b (slice 10): 16 experts, a 480-token prefill's
              # 80 rows an expert and a 4-lane decode pass's 32
              (16, 80, 4096, 14336), (16, 32, 4096, 14336))
GROUPED_K1 = ((40, 120, 512, 1536), (40, 32, 512, 1536), (40, 8, 512, 1536),
              (8, 152, 16384, 6144), (8, 32, 16384, 6144),
              (16, 80, 14336, 4096), (16, 32, 14336, 4096))
#: slice 10's K1 shapes (M, K, N) -> the projection
SLICE10_K1 = {(m, k, n): what for m in (4, 480) for (k, n, what) in (
    (2048, 4096, "mamba2 wz / wx"), (2048, 128, "mamba2 wB / wC"), (2048, 64, "mamba2 wdt"),
    (4096, 2048, "mamba2 wo"), (4096, 16, "jamba wB / wC"), (4096, 128, "jamba wdt"),
    (2560, 288, "minicpm3 wkv_a"), (768, 3840, "minicpm3 wq_b"))}
#: tile edges: 64- / 128-row tiles, the skinny shape below 9 rows, and a
#: ragged K, N (the 4-byte copies)
GROUPED_EDGES = tuple((3, m, k, n) for m in (1, 8, 9, 65, 129) for (k, n) in ((1536, 512),
                                                                            (100, 52)))
#: the 4500-token prefills' grouped shapes (slice 13): jamba (C = 704) and
#: mixtral (C = 1408), bound by int8 operations
GROUPED_LONG_K2 = ((16, 704, 4096, 14336), (8, 1408, 6144, 16384))
GROUPED_LONG_K1 = ((16, 704, 14336, 4096), (8, 1408, 16384, 6144))
#: routed cases (slice 13): (model, E, top-k, K, N of G2, lanes, tokens a
#: lane); the rows are the port's own routing, ``top_k_stable`` over a
#: seeded softmax, counts clipped at the capacity C
ROUTED = (("granite", 40, 8, 1536, 512, 1, 1), ("granite", 40, 8, 1536, 512, 4, 1),
          ("granite", 40, 8, 1536, 512, 1, 480),
          ("mixtral", 8, 2, 6144, 16384, 4, 1), ("mixtral", 8, 2, 6144, 16384, 1, 480),
          ("jamba", 16, 2, 4096, 14336, 4, 1), ("jamba", 16, 2, 4096, 14336, 1, 480))
#: the rows contract's edges: (C, rows (G, L)) on the decode tiles (C <=
#: 16: 32 rows) and the prefill tiles (64 rows) -- an all-dead group, all
#: live (a count equal to C), live counts on both sides of a tile edge
#: (31 / 32 / 33, 63 / 64 / 65, 127 / 129) and of a lane block's edge,
#: and counts past the contract's range (negative, above C: clipped)
ROWS_EDGES = ((8, ((0,) * 8, (8,) * 8, (8, 8, 8, 8, 1, 0, 0, 0), (8, 8, 8, 7, 0, 0, 0, 0),
                   (8, 8, 8, 8, 0, 0, 0, 0), (3, 0, 8, 1, -2, 11, 2, 0))),
              (72, ((0, 0), (72, 72), (64, 1), (63, 0), (30, 34), (72, 57), (-1, 80))))


def _capacity(tokens: int, experts: int, k: int) -> int:
    """models.moe._capacity at the configs' capacity factor 1.25."""
    c = int(tokens * k / experts * 1.25)
    return max(8, -(-c // 8) * 8)


def routed_rows(experts: int, k: int, lanes: int, tokens: int, gen):
    """(E, lanes) int32 live rows and C: each lane's tokens routed by the
    port's ``top_k_stable`` over a seeded softmax, counts clipped at C."""
    import torch

    from repro_torch.models.moe import top_k_stable

    c = _capacity(tokens, experts, k)
    logits = torch.randn(lanes, tokens, experts, generator=gen)
    _, idx = top_k_stable(torch.softmax(logits, dim=-1), k)
    counts = torch.nn.functional.one_hot(idx.reshape(lanes, -1), experts).sum(1)
    return counts.clamp(max=c).t().to(torch.int32).contiguous(), c


def _takes_rows(fn) -> bool:
    """Whether a grouped entry has the rows contract (a --root checkout
    may predate it)."""
    import inspect

    return "rows" in inspect.signature(fn).parameters


def _poisoned(*shapes) -> None:
    """Allocate NaN-filled tensors of ``shapes`` and free them, so that the
    next allocations of those sizes reuse the blocks: a kernel that leaves
    an output element unwritten then fails a bit-exact comparison."""
    import torch

    dev = torch.device(DEVICE)
    held = [torch.full(s, float("nan"), device=dev) for s in shapes]
    torch.cuda.synchronize()
    del held


def check_grouped(records, keep, i8, i32):
    """The grouped K1 / K2 entries against their plain versions (bit for
    bit: out, and K2's gate and sigmoid parts) at GROUPED_K2 / GROUPED_K1,
    GROUPED_EDGES and the 4500-token shapes with every row live, then on
    ROUTED rows (beside the all-live bound, the routed bound: the live
    experts' weights, the live rows and every output row), on the
    ROWS_EDGES and right after NaN-filled blocks of the outputs' sizes
    were freed; timed beside their bounds; ``library_ms`` is a per-expert
    loop of ``torch._int_mm`` (gate and up for K2) where M > 16 and every
    row is live."""
    import torch

    from repro_torch.kernels.fused_mlp import fused_swiglu_grouped, fused_swiglu_plain
    from repro_torch.kernels.qmatmul import qmatmul_grouped, qmatmul_plain

    ragged = _takes_rows(fused_swiglu_grouped) and _takes_rows(qmatmul_grouped)
    gen = torch.Generator().manual_seed(23)
    dev = torch.device(DEVICE)

    def k2_inputs(g, m, k, f, rows=None):
        x = i8(g, m, k)
        if rows is not None and not ragged:
            x = _zero_dead(x, rows)  # the parent's kernel reads every row
        return (x, i8(g, k, f), i8(g, k, f), i32(-8, -4, 1), i32(-12, -6, g, f),
                i32(-12, -6, g, f))

    def k2_case(case, args, rows=None, routed=None, timed=True):
        kw = {"rows": rows} if ragged and rows is not None else {}
        got = fused_swiglu_grouped(*args, return_parts=True, **kw)
        want = fused_swiglu_plain(*args, return_parts=True, **kw)
        torch.cuda.synchronize()
        exact = [torch.equal(a, b) for a, b in zip(got, want)]
        err = (got[0].double() - want[0].double()).abs().max().item()
        require(all(exact), f"fused_swiglu_grouped {case}: out / gate / sigmoid bit-exact "
                f"{exact} against the plain version (max err {err})")
        if not timed:
            return None
        g, m, k = args[0].shape
        f = args[1].shape[2]
        slow = g * m * k * f > 2 ** 36  # plain calls of 0.1 s and more are timed once
        rec = {"case": case, "bit_exact": True, "max_abs_err": err,
               "ms": time_ms(lambda: fused_swiglu_grouped(*args, **kw)),
               "plain_ms": time_ms(lambda: fused_swiglu_plain(*args, **kw), iters=1 if slow else 3,
                                   warmup=1 if slow else 3)}
        x, wg, wu = args[:3]
        rec["library_ms"] = (time_ms(lambda: [(torch._int_mm(x[e], wg[e]),
                                               torch._int_mm(x[e], wu[e])) for e in range(g)])
                             if m > 16 and rows is None else None)
        rec["library"] = "per-expert torch._int_mm, gate and up (no epilogue)"
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            g * (m * k + 2 * k * f + 8 * f + 4 * m * f) + 4, 4.0 * g * m * k * f, "int8")
        if routed is not None:
            live_e, live_r = routed
            rec["live_experts"], rec["live_rows"] = live_e, live_r
            rec["all_live_bound_ms"] = rec["bound_ms"]
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                live_e * (2 * k * f + 8 * f) + live_r * k + 4 * g * m * f + 4,
                4.0 * live_r * k * f, "int8")
        emit({"phase": "kernels", "kernel": "fused_swiglu_grouped", **rec})
        keep("fused_swiglu_grouped", rec)
        return rec

    def k1_inputs(g, m, k, n, rows=None, epi="float"):
        a = i8(g, m, k)
        if rows is not None and not ragged:
            a = _zero_dead(a, rows)
        eb = i32(-30, 12, g, n) if epi == "q16" else i32(-12, -4, g, n)
        return a, i8(g, k, n), i32(-12, -4, 1), eb

    def k1_case(case, args, epi, rows=None, routed=None, timed=True):
        kw = {"rows": rows} if ragged and rows is not None else {}
        got = qmatmul_grouped(*args, epi, **kw)
        want = qmatmul_plain(*args, epi, **kw)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        require(torch.equal(got, want), f"qmatmul_grouped {case} {epi} differs from its plain "
                f"version (max err {err})")
        if not timed:
            return None
        a, b = args[:2]
        g, m, k = a.shape
        n = b.shape[2]
        rec = {"case": f"{case} {epi}", "bit_exact": True, "max_abs_err": err,
               "ms": time_ms(lambda: qmatmul_grouped(*args, epi, **kw)),
               "plain_ms": time_ms(lambda: qmatmul_plain(*args, epi, **kw), iters=3)}
        rec["library_ms"] = (time_ms(lambda: [torch._int_mm(a[e], b[e]) for e in range(g)])
                             if m > 16 and rows is None else None)
        rec["library"] = "per-expert torch._int_mm (no epilogue)"
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            g * (m * k + k * n + 4 * n + 4 * m * n) + 4, 2.0 * g * m * n * k, "int8")
        if routed is not None:
            live_e, live_r = routed
            rec["live_experts"], rec["live_rows"] = live_e, live_r
            rec["all_live_bound_ms"] = rec["bound_ms"]
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                live_e * (k * n + 4 * n) + live_r * k + 4 * g * m * n + 4,
                2.0 * live_r * k * n, "int8")
        emit({"phase": "kernels", "kernel": "qmatmul_grouped", **rec})
        keep("qmatmul_grouped", rec)
        return rec

    # every row live: the MoE and SSM slices' shapes, the tile edges, the
    # 4500-token prefills
    for (g, m, k, f) in GROUPED_K2 + GROUPED_EDGES + GROUPED_LONG_K2:
        k2_case(f"E={g} M={m} K={k} F={f}", k2_inputs(g, m, k, f),
                timed=(g, m, k, f) not in GROUPED_EDGES)
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "fused_swiglu_grouped", "case": "tile edges",
          "shapes": [f"E={g} M={m} K={k} F={f}" for g, m, k, f in GROUPED_EDGES],
          "bit_exact": True})
    for (g, m, k, n) in GROUPED_K1 + GROUPED_EDGES + GROUPED_LONG_K1:
        edge = (g, m, k, n) in GROUPED_EDGES
        for epi in ("float", "q16", "int32") if edge else ("float",):
            k1_case(f"E={g} M={m} K={k} N={n}", k1_inputs(g, m, k, n, epi=epi), epi,
                    timed=not edge)
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "qmatmul_grouped", "case": "tile edges, every epilogue",
          "shapes": [f"E={g} M={m} K={k} N={n}" for g, m, k, n in GROUPED_EDGES],
          "bit_exact": True})

    # routed: the port's routing; the parent's kernels (--root) run every
    # row of inputs whose dead rows are zero, as the model's are
    for model, e, top_k, k, f, lanes, tokens in ROUTED:
        rows, c = routed_rows(e, top_k, lanes, tokens, gen)
        rows = rows.to(dev)
        live = (int((rows.sum(1) > 0).sum()), int(rows.sum()))
        what = (f"{model} {'decode' if tokens == 1 else f'{tokens}-token prefill'}, "
                f"{lanes} lane{'s' if lanes > 1 else ''}, routed")
        m = lanes * c
        k2_case(f"E={e} M={m} K={k} F={f} ({what})", k2_inputs(e, m, k, f, rows), rows, live)
        k1_case(f"E={e} M={m} K={f} N={k} ({what})", k1_inputs(e, m, f, k, rows), "float",
                rows, live)
        torch.cuda.empty_cache()
    if not ragged:
        emit({"phase": "kernels", "grouped_rows": "not in this tree: routed cases ran every "
                                                  "row, the rows edges were skipped"})
        return

    # the rows contract's edges, on both tile heights, every K1 epilogue;
    # dead rows hold random bytes, which the kernels must read as zero
    n_cases = 0
    for c, table in ROWS_EDGES:
        rows = torch.tensor(table, dtype=torch.int32, device=dev)
        g, lanes = rows.shape
        for (k, n) in ((1536, 512), (100, 52)):
            k2_case(f"E={g} M={lanes * c} K={k} F={n} rows {table}",
                    k2_inputs(g, lanes * c, k, n), rows, timed=False)
            for epi in ("float", "q16", "int32"):
                k1_case(f"E={g} M={lanes * c} K={n} N={k} rows {table}",
                        k1_inputs(g, lanes * c, n, k, epi=epi), epi, rows, timed=False)
            n_cases += 4
    emit({"phase": "kernels", "kernel": "grouped", "case": "rows edges", "cases": n_cases,
          "rows": [t for _, t in ROWS_EDGES], "bit_exact": True})

    # an unwritten dead row must show: granite's routed 4-lane decode right
    # after NaN-filled blocks of each output's size were freed
    rows, c = routed_rows(40, 8, 4, 1, gen)
    rows = rows.to(dev)
    args = k2_inputs(40, 4 * c, 1536, 512)
    _poisoned(*[(40, 4 * c, 512)] * 3)
    k2_case("granite decode, 4 lanes, routed, after NaN blocks", args, rows, timed=False)
    args = k1_inputs(40, 4 * c, 512, 1536)
    _poisoned((40, 4 * c, 1536))
    k1_case("granite decode, 4 lanes, routed, after a NaN block", args, "float", rows,
            timed=False)
    emit({"phase": "kernels", "kernel": "grouped", "case": "dead rows after NaN-filled blocks",
          "live_rows": int(rows.sum()), "rows": 4 * c * 40, "bit_exact": True})


def _zero_dead(x, rows):
    """``x`` (G, M, K) with the rows ``rows`` marks dead zeroed (the
    model's padding rows), for a kernel without the rows contract."""
    import torch

    g, m, _ = x.shape
    j = torch.arange(m // rows.shape[1], device=x.device)
    live = (j < rows[:, :, None]).reshape(g, m)
    return torch.where(live[..., None], x, torch.zeros_like(x))


def check_float_entries(kc, xf, yf, keep):
    """K6's and K7's float entries (the engine's atan2 at q16_16 and q8_24,
    its div) against their plain versions, the to_fixed -> kernel ->
    from_fixed chain, on the card: 2**24 floats (Q16.16 grid values of
    the whole word range) and the float edge grid, NaN and +-inf
    included, bit for bit; at the engine's counts and, on a slice,
    generic ones."""
    import numpy as np
    import torch

    e = torch.tensor(np.array(kc.FLOAT_EDGES, dtype=np.float32), device=xf.device)
    fy, fx = (t.reshape(-1).contiguous() for t in torch.meshgrid(e, e, indexing="ij"))
    ys, xs = yf[: 1 << 20], xf[: 1 << 20]
    cases = (("atan2_f32", kc.atan2_f32, kc.atan2_f32_plain, 16, (7, 32), torch.atan2),
             ("atan2_24_f32", kc.atan2_24_f32, kc.atan2_24_f32_plain, 24, (7, 32, 16),
              torch.atan2),
             ("div_f32", kc.div_f32, kc.div_f32_plain, 17, (9, 32), torch.div))
    bits = lambda t: t.view(torch.int32)  # noqa: E731  (-0.0 is not 0.0)
    for name, fn, plain, it, generic, lib in cases:
        got, want = fn(yf, xf, it), plain(yf, xf, it)
        exact = (torch.equal(bits(got), bits(want))
                 and torch.equal(bits(fn(fy, fx, it)), bits(plain(fy, fx, it))))
        for g in generic:
            exact = exact and torch.equal(bits(fn(ys, xs, g)), bits(plain(ys, xs, g)))
            exact = exact and torch.equal(bits(fn(fy, fx, g)), bits(plain(fy, fx, g)))
        rec = {"case": f"iterations={it} 2**24 float pairs + {fy.numel()} float edge pairs "
                       f"(NaN, inf, -0.0, subnormals, halves, +-32768); generic {list(generic)} "
                       "on 2**20", "bit_exact": exact,
               "max_abs_err": (got.double() - want.double()).abs().max().item()}
        require(exact, f"{name} {rec['case']} differs from its plain version")
        rec["ms"] = time_ms(lambda: fn(yf, xf, it))
        rec["plain_ms"] = time_ms(lambda: plain(yf, xf, it), iters=2, warmup=1)
        rec["library_ms"] = time_ms(lambda: lib(yf, xf))
        rec["library"] = f"torch.{lib.__name__} on f32 (float analogue, not the same bits)"
        # (0, 0) and a zero denominator are the same words as floats
        ops = div_ops(yf, xf, it) if name == "div_f32" else atan2_ops(yf, xf, it)
        ops += xf.numel() * (BOUNDARY + (NORMALISE if name == "atan2_24_f32" else 0))
        rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * xf.numel(), ops, "int32")
        emit({"phase": "kernels", "kernel": name, **rec})
        keep(name, rec)


# C3, the deferred-correction matmul, is counted as the function needs:
# one 64-bit multiply-add a product is four 32-bit lane operations (the
# low and high words of the product, and a 64-bit add as two adds with
# carry; on the SM's FMA pipe one IMAD.WIDE issued over two cycles of its
# 64 lanes, so 128 lanes an SM a clock count it at the pipe's rate), and
# each output's flush a K tile 7 more (the rounding add as a 64-bit add
# 2, the shifted low word one funnel shift 1, the saturating add 4).
MAD64, FLUSH = 4, 7
#: the engine's matmul and the C3 kernel's main shape (Q16.16 in [-1, 1))
MATMUL_N = 4096
DEFERRED_DIMS = (1, 17, 33, 1000)


def deferred_ops(m: int, n: int, k: int, tile_k: int) -> float:
    return float(MAD64 * m * n * k + FLUSH * m * n * -(-k // tile_k))


def _has_c3() -> bool:
    import importlib.util

    return importlib.util.find_spec("repro_torch.kernels.linalg") is not None


def _q16_unit(n_rows: int, n_cols: int, gen):
    """Q16.16 words of uniform values in [-1, 1) on the card."""
    import torch

    u = torch.rand(n_rows, n_cols, generator=gen, dtype=torch.float64) * 2 - 1
    return torch.round(u * 65536).to(torch.int32).to(DEVICE)


def check_deferred(gen, keep):
    """C3's deferred-correction matmul against its plain version on the
    card, bit for bit: the engine's 4096**3 shape (timed, with the f32
    ``torch.matmul`` of the same shape as the library yardstick: the f32
    rung's function, not the same bits), the edge grid of M, K, N, tile_k,
    rounding and saturate on any int32 words, and operands near +-32767.0
    whose tiles saturate."""
    import torch

    from repro_torch.core.qformat import Q16_16, from_fixed
    from repro_torch.kernels.linalg import qmatmul_deferred, qmatmul_deferred_plain

    n = MATMUL_N
    a, b = _q16_unit(n, n, gen), _q16_unit(n, n, gen)
    got, want = qmatmul_deferred(a, b), qmatmul_deferred_plain(a, b)
    torch.cuda.synchronize()
    rec = {"case": f"M=K=N={n} Q16.16 in [-1, 1) tile_k=32 rounding saturate",
           "bit_exact": torch.equal(got, want),
           "max_abs_err": (got.long() - want.long()).abs().max().item()}
    require(rec["bit_exact"], f"qmatmul_deferred {rec['case']} differs from its plain version")
    rec["ms"] = time_ms(lambda: qmatmul_deferred(a, b), iters=5, warmup=1)
    rec["plain_ms"] = time_ms(lambda: qmatmul_deferred_plain(a, b), iters=2, warmup=1)
    af, bf = from_fixed(a, Q16_16), from_fixed(b, Q16_16)
    rec["library_ms"] = time_ms(lambda: torch.matmul(af, bf), iters=5, warmup=1)
    rec["library"] = "torch.matmul f32, TF32 off (the f32 rung; not the same function)"
    rec["bound_ms"], rec["bound_by"] = bound_ms(4.0 * 3 * n * n, deferred_ops(n, n, n, 32),
                                                "int32")
    emit({"phase": "kernels", "kernel": "deferred_matmul", **rec})
    keep("deferred_matmul", rec)
    del a, b, af, bf, got, want

    # the edge grid: any int32 words, so whole tiles wrap mod 2**64
    cases = 0
    for m in DEFERRED_DIMS:
        for k in DEFERRED_DIMS:
            for n_ in DEFERRED_DIMS:
                a = torch.randint(-(2**31), 2**31 - 1, (m, k), generator=gen,
                                  dtype=torch.int32).to(DEVICE)
                b = torch.randint(-(2**31), 2**31 - 1, (k, n_), generator=gen,
                                  dtype=torch.int32).to(DEVICE)
                for tile_k in sorted({1, 7, 32, 40, k}):
                    for rounding in (True, False):
                        for saturate in (True, False):
                            kw = dict(tile_k=tile_k, rounding=rounding, saturate=saturate)
                            require(torch.equal(qmatmul_deferred(a, b, **kw),
                                                qmatmul_deferred_plain(a, b, **kw)),
                                    f"qmatmul_deferred M={m} K={k} N={n_} {kw} differs from "
                                    "its plain version")
                            cases += 1
    # Q16.16 operands near +-32767.0 against ones within +-1: products near
    # the int32 edge, so one-deep tiles saturate across tiles
    saturated = 0
    for tile_k in (1, 2, 32):
        a = torch.randint(32760 * 65536, 2**31 - 1, (1000, 96), generator=gen, dtype=torch.int32)
        a = a * (torch.randint(0, 2, a.shape, generator=gen, dtype=torch.int32) * 2 - 1)
        b = torch.randint(-65536, 65537, (96, 1000), generator=gen, dtype=torch.int32)
        a, b = a.to(DEVICE), b.to(DEVICE)
        for saturate in (True, False):
            got = qmatmul_deferred(a, b, tile_k=tile_k, saturate=saturate)
            require(torch.equal(got, qmatmul_deferred_plain(a, b, tile_k=tile_k,
                                                            saturate=saturate)),
                    f"qmatmul_deferred saturating operands tile_k={tile_k} saturate={saturate} "
                    "differs from its plain version")
            if saturate and tile_k == 1:
                saturated = int((got.abs() == 2**31 - 1).sum())
    require(saturated > 0, "the saturating case saturated no output")
    emit({"phase": "kernels", "kernel": "deferred_matmul", "case": "edge grid M, K, N in "
          f"{DEFERRED_DIMS}, tile_k in (1, 7, 32, 40, K), both roundings, saturate on and off, "
          "int32 words; operands near +-32767.0 at tile_k 1, 2, 32", "cases": cases + 6,
          "saturated_outputs": saturated, "bit_exact": True})


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

#: K6's and K7's float entries: the same kernels reading and writing f32
FLOAT_ENTRIES = ("atan2_f32", "atan2_24_f32", "div_f32")
#: rows of the kernels line: K1-K7 (K6 and K7 counting the launches of all
#: their entries), then the float entries, each with its own launches
#: the grouped K1 / K2 entries of the MoE experts (slice 9)
GROUPED = ("fused_swiglu_grouped", "qmatmul_grouped")
KERNELS = ("qmatmul", "fused_swiglu", "cordic_sincos", "flash_attention", "universal_unary",
           "atan2_q16", "div_q16") + FLOAT_ENTRIES + ("deferred_matmul",) + GROUPED


def _wrappers():
    """{row of the kernels line: its wrappers}: each wrapper counts the
    launches it makes (K3's elementwise and RoPE forms; K6's and K7's
    int32 and float entries, where the tree has them; a float entry also
    on its own)."""
    from repro_torch.kernels import cordic as kc
    from repro_torch.kernels import fused_mlp as kfm
    from repro_torch.kernels import qmatmul as kqm
    from repro_torch.kernels.flashattn import flash_attention
    from repro_torch.kernels.fused_mlp import fused_swiglu
    from repro_torch.kernels.qmatmul import qmatmul

    def entries(*names):
        return tuple(getattr(kc, n) for n in names if hasattr(kc, n))

    c3 = ()
    if _has_c3():
        from repro_torch.kernels.linalg import qmatmul_deferred

        c3 = (qmatmul_deferred,)
    return {"qmatmul": (qmatmul,), "fused_swiglu": (fused_swiglu,), "deferred_matmul": c3,
            "cordic_sincos": (kc.cordic_sincos, kc.rope_sincos_q16),
            "flash_attention": (flash_attention,), "universal_unary": (kc.universal_unary,),
            "atan2_q16": entries("atan2_q16", "atan2_f32", "atan2_24_f32"),
            "div_q16": entries("div_q16", "div_f32"),
            **{name: entries(name) for name in FLOAT_ENTRIES},
            "fused_swiglu_grouped": tuple(getattr(kfm, n) for n in ("fused_swiglu_grouped",)
                                          if hasattr(kfm, n)),
            "qmatmul_grouped": tuple(getattr(kqm, n) for n in ("qmatmul_grouped",)
                                     if hasattr(kqm, n))}


def _launch_counts():
    return {name: sum(fn.launches for fn in fns) for name, fns in _wrappers().items()}


def _entry_counts():
    """{wrapper name: launches} of every wrapper."""
    return {fn.__name__: fn.launches for fns in _wrappers().values() for fn in fns}


def _reset_launch_counts():
    for fns in _wrappers().values():
        for fn in fns:
            fn.launches = 0


# ---------------------------------------------------------------------------
# phase 3: the engine's transcendental ops on the card
# ---------------------------------------------------------------------------

#: op -> (input ranges, accuracy bound from the exact value) as the
#: reference's tests state them (tests/test_universal_cordic.py,
#: tests/test_precision_ladder.py)
ENGINE_OPS = ("atan2", "div", "sqrt", "exp", "log", "tanh", "sigmoid", "sin", "cos")


def engine_phase(seed: int, strict: bool):
    """Every new engine op on CUDA tensors at q16_16, f32 and under a
    per-op policy; returns the K3 and K5-K7 launches of the run (K6's and
    K7's also by float entry) and the launches of every wrapper.
    ``strict``: K6 and K7 must run through their float entries only (a
    checkout given by --root may predate them)."""
    import torch

    from repro_torch.core.cordic import ITER_Q24
    from repro_torch.core.precision import MathEngine, PrecisionPolicy
    from repro_torch.core.qformat import Q8_24, Q16_16, from_fixed, to_fixed
    from repro_torch.kernels.cordic import (
        atan2_q16_plain,
        cordic_sincos_plain,
        div_q16_plain,
        universal_unary_plain,
    )

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()

    def grid(lo, hi, n=N_WORDS):
        # values on the Q16.16 grid, so every rung sees the same numbers
        u = torch.rand(n, generator=g, device=dev, dtype=torch.float64) * (hi - lo) + lo
        return (torch.round(u * 65536) / 65536).to(torch.float32)

    half = N_WORDS // 2
    inputs = {
        "atan2": (grid(-200.0, 200.0), grid(-200.0, 200.0)),
        "div": (torch.cat([grid(-30000.0, 30000.0, half), grid(-300.0, 300.0, half)]),
                torch.cat([grid(-30000.0, 30000.0, half), grid(-0.05, 0.05, half)])),
        "sqrt": (torch.cat([grid(2.0 ** -16, 1.0, half), grid(1.0, 32767.0, half)]),),
        "exp": (grid(-11.5, 10.39),),
        "log": (torch.cat([grid(2.0 ** -10, 1.0, half), grid(1.0, 32767.0, half)]),),
        "tanh": (grid(-16.0, 16.0),),
        "sigmoid": (grid(-20.0, 20.0),),
        "sin": (grid(-math.pi, math.pi),),
        "cos": (grid(-math.pi, math.pi),),
    }
    den = inputs["div"][1]
    inputs["div"] = (inputs["div"][0], torch.where(den == 0, torch.full_like(den, 2.0 ** -16), den))

    def plain(op, args):
        q = [to_fixed(a, Q16_16) for a in args]
        if op == "atan2":
            out = atan2_q16_plain(*q)
        elif op == "div":
            out = div_q16_plain(*q)
        elif op in ("sin", "cos"):
            out = cordic_sincos_plain(q[0])[op == "cos"]
        else:
            out = universal_unary_plain(q[0], op)
        return from_fixed(out, Q16_16)

    def bound(op, args, want):
        """The reference's accuracy bound, elementwise, and the mask of
        the elements it is stated for."""
        a = want.abs()
        if op == "atan2":
            return torch.full_like(want, 1e-4), torch.ones_like(want, dtype=torch.bool)
        if op == "div":
            return 2.0 ** -15 * (1.0 + a), a < 32767
        if op == "sqrt":
            return 2.0 ** -16 + 3e-5 * a, torch.ones_like(want, dtype=torch.bool)
        if op == "exp":
            return 2.0 ** -16 + 6e-5 * a, args[0] < 681391 / 65536
        # sin / cos: tests/test_cordic.py's ABS_TOL on [-pi, pi]
        tol = {"log": 8e-5, "tanh": 6e-5, "sigmoid": 5e-5, "sin": 8e-4, "cos": 8e-4}[op]
        return torch.full_like(want, tol), torch.ones_like(want, dtype=torch.bool)

    eng = MathEngine("q16_16")
    _reset_launch_counts()
    fixed = {op: eng.call(op, *args) for op, args in inputs.items()}
    policy = PrecisionPolicy(default="q16_16",
                             per_op={"atan2": "q8_24", "sin": "q8_24", "cos": "q8_24"})
    with eng.at(policy):
        pinned = {op: eng.call(op, *args) for op, args in inputs.items()}
    torch.cuda.synchronize()
    launches, by_entry = _launch_counts(), _entry_counts()
    with eng.at("f32"):
        exact = {op: eng.call(op, *args) for op, args in inputs.items()}

    out = {}
    for op, args in inputs.items():
        want_bits = plain(op, args)
        exact64 = exact[op].double()
        tol, mask = bound(op, args, exact64)
        err = (fixed[op].double() - exact64).abs()
        rec = {"bit_exact": torch.equal(fixed[op], want_bits),
               "max_err_vs_f32": err[mask].max().item(),
               "worst_err_over_bound": (err[mask] / tol[mask]).max().item(),
               "ms": time_ms(lambda: eng.call(op, *args), iters=5, warmup=1)}
        with eng.at("f32"):
            rec["f32_ms"] = time_ms(lambda: eng.call(op, *args), iters=5, warmup=1)
        require(rec["bit_exact"], f"engine {op} at q16_16 differs from the plain body")
        require(rec["worst_err_over_bound"] <= 1.0,
                f"engine {op} at q16_16 outside the reference's bound: {rec}")
        if op not in ("atan2", "sin", "cos"):
            require(torch.equal(pinned[op], fixed[op]), f"engine {op} under the policy moved")
        out[op] = rec

    # the policy's atan2 is the Q8.24 rung: K6 with 24 iterations on
    # operands normalised by max(|y|, |x|); held against float64 atan2
    # at the reference's 1e-6 plus the Q8.24 rounding of the normalised
    # operands (2 * 2**-25 / radius >= 1)
    y, x = inputs["atan2"]
    m = torch.maximum(y.abs(), x.abs())
    s = torch.where(m > 0, m, torch.ones_like(m))
    want24 = from_fixed(atan2_q16_plain(to_fixed(y / s, Q8_24), to_fixed(x / s, Q8_24),
                                        ITER_Q24, 24), Q8_24)
    err24 = (pinned["atan2"].double() - torch.atan2(y.double(), x.double())).abs().max().item()
    out["atan2@q8_24"] = {"bit_exact": torch.equal(pinned["atan2"], want24),
                          "max_err_vs_f64": err24}
    with eng.at(policy):
        out["atan2@q8_24"]["ms"] = time_ms(lambda: eng.call("atan2", y, x), iters=5, warmup=1)
    require(out["atan2@q8_24"]["bit_exact"], "engine atan2 under the policy differs from q8_24")
    require(err24 <= 1e-6 + 2.0 ** -24, f"engine atan2 at q8_24: error {err24} > 1e-6 + 2**-24")
    # the policy's sin / cos: K3 with 24 iterations on Q8.24 angles, held
    # bit-exact against the plain body and within tests/test_precision_ladder.py's
    # 2e-6 of the float64 sin / cos of the Q8.24 angle (here the angle itself:
    # Q16.16 grid values are Q8.24 words)
    for op in ("sin", "cos"):
        t = inputs[op][0]
        want = from_fixed(cordic_sincos_plain(to_fixed(t, Q8_24), ITER_Q24, 24)[op == "cos"],
                          Q8_24)
        exact_t = getattr(torch, op)(t.double())
        err = (pinned[op].double() - exact_t).abs().max().item()
        out[f"{op}@q8_24"] = {"bit_exact": torch.equal(pinned[op], want), "max_err_vs_f64": err}
        require(out[f"{op}@q8_24"]["bit_exact"], f"engine {op} under the policy differs from q8_24")
        require(err <= 2e-6, f"engine {op} at q8_24: error {err} > 2e-6")

    emit({"phase": "engine", "elements": N_WORDS, "ops": out, "launches": launches,
          "launches_by_entry": by_entry, "policy": repr(policy),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for name in ("cordic_sincos", "universal_unary", "atan2_q16", "div_q16"):
        require(launches[name] > 0, f"kernel {name} was not launched by the engine")
    # 5 unary ops twice (q16_16, policy), atan2, div, sin and cos twice each
    require(launches["universal_unary"] == 10 and launches["atan2_q16"] == 2
            and launches["div_q16"] == 2 and launches["cordic_sincos"] == 4,
            f"engine launches {launches}")
    # K6 and K7 through their float entries: the q16_16 atan2, the
    # policy's q8_24 atan2 and div at q16_16 twice; none through the int32
    # entries, so no eager float boundary around them
    if strict:
        k67 = {k: by_entry.get(k) for k in ("atan2_q16", "div_q16") + FLOAT_ENTRIES}
        require(k67 == {"atan2_q16": 0, "atan2_f32": 1, "atan2_24_f32": 1, "div_q16": 0,
                        "div_f32": 2}, f"engine launches of K6's and K7's entries {k67}")
    paths = ("cordic_sincos", "universal_unary", "atan2_q16", "div_q16") + FLOAT_ENTRIES
    return {k: launches[k] for k in paths if k in launches}, by_entry


def engine_matmul_phase(seed: int):
    """The engine's ``matmul`` (C3) at 4096**3 on both rungs after one
    ``compile_op``, then the port's three examples on the card; returns
    the deferred kernel's launches of the two timed-before-checked calls."""
    import contextlib
    import importlib.util
    import io

    import torch

    from repro_torch.core import linalg
    from repro_torch.core.precision import MathEngine
    from repro_torch.core.qformat import Q16_16, from_fixed
    from repro_torch.kernels.linalg import qmatmul_deferred_plain

    gen = torch.Generator().manual_seed(seed + 17)
    n = MATMUL_N
    a, b = _q16_unit(n, n, gen), _q16_unit(n, n, gen)
    af, bf = from_fixed(a, Q16_16), from_fixed(b, Q16_16)
    eng = MathEngine("q16_16")
    t0 = time.perf_counter()
    eng.compile_op("matmul", {"q16_16": linalg.qmatmul_deferred, "f32": linalg.matmul_float},
                   a[:64, :64].contiguous(), b[:64, :64].contiguous())
    compile_s = time.perf_counter() - t0
    _reset_launch_counts()
    fixed = eng.call("matmul", a, b)
    torch.cuda.synchronize()
    launches = _launch_counts()
    with eng.at("f32"):
        exact = eng.call("matmul", af, bf)
    want = (af.double() @ bf.double())
    tiles = -(-n // 32)
    limit = tiles * 2.0 ** -17 + 1e-6
    rec = {"case": f"M=K=N={n} Q16.16 operands in [-1, 1) (f32: the same values)",
           "compile_op_s": compile_s, "q16_16_launches": launches["deferred_matmul"],
           "q16_16_bit_exact": torch.equal(fixed, qmatmul_deferred_plain(a, b)),
           "q16_16_max_err_vs_f64": (from_fixed(fixed, Q16_16).double() - want).abs().max().item(),
           "f32_max_err_vs_f64": (exact.double() - want).abs().max().item(),
           "bound": f"ceil(K/32) * 2**-17 + 1e-6 = {limit}",
           "q16_16_ms": time_ms(lambda: eng.call("matmul", a, b), iters=5, warmup=1)}
    with eng.at("f32"):
        rec["f32_ms"] = time_ms(lambda: eng.call("matmul", af, bf), iters=5, warmup=1)
    del fixed, exact, want, a, b, af, bf
    require(rec["q16_16_bit_exact"], "engine matmul at q16_16 differs from the plain version")
    require(rec["q16_16_launches"] == 1, f"engine matmul at q16_16 launched the deferred kernel "
            f"{rec['q16_16_launches']} times, want 1")
    for rung in ("q16_16", "f32"):
        require(rec[f"{rung}_max_err_vs_f64"] <= limit,
                f"engine matmul at {rung} outside the reference's float bound: {rec}")

    # the port's examples, as a user runs them (on the card by default)
    examples = {}
    for name in ("torch_quickstart", "torch_sensor_fusion", "torch_precision_arbiter_demo"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = mod.main()
        examples[name] = out.getvalue().strip().splitlines()[-3:]
        if name == "torch_sensor_fusion":
            sw = [(st, str(lv), reason.split()[0]) for st, lv, reason, _ in res]
            examples["sensor_fusion_switches"] = sw
            require(sw == [(180, "f32", "grad-spike"), (239, "q8_24", "stable")],
                    f"the sensor-fusion example switched {sw}, the reference at 180 and 239")
    rec["examples"] = examples
    emit({"phase": "engine_matmul", **rec})
    return {"deferred_matmul": launches["deferred_matmul"]}


# ---------------------------------------------------------------------------
# phases 4-5: serving at full size
# ---------------------------------------------------------------------------

PROMPT_LENS = (17, 32, 64, 96, 150, 200, 300, 480)
LONG_PROMPT = 4500
MAX_NEW = 16
# FIFO over 4 slots: requests 0-3 run together, then 4-7 (then 8-9).
# Request 0 is the only q16_16 lane of its wave, so the isolation contract
# (lanes of OTHER levels cannot perturb it) applies to it; q16_16 lanes
# sharing a pass share one per-tensor activation exponent by design
# (reference serve.py docstring).
LEVELS = ("q16_16", "f32", "f32", "f32", "q16_16", "q16_16", "q16_16", "f32")


class _LogitWatch:
    """Folds one device flag per sampling call into a list: all logits
    finite and, with a cap, within it (no host sync inside the loop)."""

    def __init__(self, serve_mod, cap=None):
        import torch

        self.mod, self.orig, self.flags = serve_mod, serve_mod._finish, []

        def finish_checked(logits, temperature, gen):
            ok = torch.isfinite(logits).all()
            if cap is not None:
                ok = ok & (logits.abs() <= cap).all()
            self.flags.append(ok)
            return self.orig(logits, temperature, gen)

        serve_mod._finish = finish_checked

    def ok(self) -> bool:
        import torch

        return bool(torch.stack(self.flags).all().item())

    def close(self):
        self.mod._finish = self.orig


def _serve_model(name: str, seed: int, max_len: int, prompt_lens, levels, ttft_lens,
                 n_layers=None):
    """Serve the mixed workload at the full config of ``name`` (its depth
    cut to ``n_layers`` when given); returns the phase record (launch
    counts of the mixed run included) after the slice-1 checks common to
    every model."""
    import dataclasses

    import numpy as np
    import torch

    import repro_torch.runtime.serve as serve_mod
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import ContinuousBatchingServer, Request, ServingConfig

    cfg = get_config(name)
    published_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=4, max_len=max_len),
                                   device=dev)
    del params
    sync()
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in prompt_lens]

    # warm-up: one short request per level (cuBLAS handles, allocator)
    srv.serve([Request(rid=srv.next_rid(), prompt=prompts[0][:8], max_new=2, level=lv)
               for lv in ("q16_16", "f32")])
    sync()

    watch = _LogitWatch(serve_mod, cfg.final_softcap)
    reqs = [Request(rid=srv.next_rid(), prompt=p, max_new=MAX_NEW, level=lv)
            for p, lv in zip(prompts, levels)]
    stats0 = srv.stats
    passes0 = srv.metrics_snapshot()["level_passes_total"].get("level=q16_16", 0)
    _reset_launch_counts()
    t0 = time.perf_counter()
    fins = srv.serve(reqs)
    sync()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    ticks = srv.stats["decode_steps"] - stats0["decode_steps"]
    passes = srv.stats["level_passes"] - stats0["level_passes"]
    q16_passes = srv.metrics_snapshot()["level_passes_total"].get("level=q16_16", 0) - passes0
    logits_ok = watch.ok()
    n_tokens = sum(f.n_generated for f in fins.values())

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

    # time to first token: each prompt length of ttft_lens alone per level
    ttft = {}
    for n in ttft_lens:
        prompt = next(p for p in prompts if len(p) == n)
        for lv in ("q16_16", "f32"):
            sync()
            t1 = time.perf_counter()
            srv.serve([Request(rid=srv.next_rid(), prompt=prompt, max_new=1, level=lv)])
            sync()
            ttft[f"{lv}@{n}"] = (time.perf_counter() - t1) * 1e3
    logits_all_ok = watch.ok()
    watch.close()

    rec = {
        "phase": "serving", "model": cfg.name, "layers": cfg.n_layers,
        "published_layers": published_layers, "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "period": [f"{sp.kind}+{sp.ffn}" for sp in cfg.period],
        "ssm": dataclasses.asdict(cfg.ssm) if cfg.ssm else None,
        "mla": dataclasses.asdict(cfg.mla) if cfg.mla else None,
        "windows": [s.window for s in cfg.period],
        "softcaps": [cfg.attn_softcap, cfg.final_softcap],
        "experts": [cfg.moe.num_experts, cfg.moe.top_k] if cfg.moe else None,
        "n_slots": 4, "max_len": max_len, "requests": len(reqs),
        "prompt_lens": list(prompt_lens), "max_new": MAX_NEW, "levels": list(levels),
        "generated_tokens": n_tokens, "serve_wall_s": wall, "tokens_per_s": n_tokens / wall,
        "tokens_sha": hashlib.sha256(json.dumps([fins[r.rid].tokens for r in reqs])
                                     .encode()).hexdigest()[:16],
        "ttft_ms": ttft, "setup_s": setup_s, "launches": launches,
        "launches_per_prefill": per_prefill, "launches_per_decode_tick": per_tick,
        "decode_ticks": ticks, "level_passes": passes, "q16_16_passes": q16_passes,
        "q16_16_prefills": sum(lv == "q16_16" for lv in levels),
        "all_logits_ok": logits_all_ok, "isolation_ok": isolation_ok,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "nvidia_smi": nvidia_smi(),
    }
    emit(rec)
    for r in reqs:
        f = fins[r.rid]
        require(f.n_generated == MAX_NEW and len(f.tokens) == len(r.prompt) + MAX_NEW,
                f"{cfg.name}: request {r.rid} finished with {f.n_generated} tokens ({f.reason})")
    cap = f" and within |logit| <= {cfg.final_softcap}" if cfg.final_softcap else ""
    require(logits_ok and logits_all_ok, f"{cfg.name}: logits not all finite{cap}")
    require(isolation_ok, f"{cfg.name}: the q16_16 request served alone differs from its "
                          "mixed-batch tokens")
    # the FAST RoPE tables: one K3 launch per q16_16 pass (prefill or
    # decode) of a model with attention (none for an attention-free one),
    # none on the f32 rung
    k3 = int(cfg.has_attention)
    want_k3 = k3 * (rec["q16_16_prefills"] + rec["q16_16_passes"])
    require(rec["launches"]["cordic_sincos"] == want_k3,
            f"{cfg.name}: K3 launched {rec['launches']['cordic_sincos']} times, want {want_k3}")
    for lv, want in (("q16_16", k3), ("f32", 0)):
        got = (rec["launches_per_prefill"][lv]["cordic_sincos"],
               rec["launches_per_decode_tick"][lv]["cordic_sincos"])
        require(got == (want, want), f"{cfg.name}: a {lv} prefill / decode pass launched K3 "
                f"{got} times, want {want}")
    return rec, srv, prompts, [fins[r.rid].tokens for r in reqs]


#: one verify pass: the next token and k = 4 drafts
SEG_S = 4 + 1
#: the chunked prefill's fixed segment length
CHUNK = 128


def _clone_tree(tree):
    return {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in tree.items()}


def segment_phase(srv, cfg, prompt, max_len: int, keep_count: int, chunked: bool, seed: int):
    """The segment steps on the served model's parameters (batch 1):
    exact-rung prefill of ``prompt``, one ``segment_step`` of SEG_S tokens
    held against SEG_S sequential ``decode_step`` calls from a copy of the
    cache (argmax at every position), ``commit_segment`` with
    ``keep_count`` (accepted rows kept bit for bit, positions equal to the
    sequential decode's and rows within f32 noise of them — see below;
    rejected rows the pre-segment rows bit for bit, wrapped
    rolling-buffer slots included), the same segment on the FAST
    rung, and with ``chunked`` a chunked prefill at ``f32``.  Returns
    {path: launches}: the FAST segment's, counted from 0 just before it."""
    import numpy as np
    import torch

    from repro_torch import models as tm

    dev, sync, params = torch.device(DEVICE), torch.cuda.synchronize, srv.params
    n = len(prompt)
    caches = tm.init_caches(cfg, 1, max_len, device=dev)
    t0 = time.perf_counter()
    first_logits, _ = tm.prefill_step(params, torch.tensor([prompt], dtype=torch.int32,
                                                           device=dev), caches, cfg, mode="exact")
    first = int(first_logits.argmax())
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    drafts = np.random.default_rng(seed).integers(0, cfg.vocab, SEG_S - 1).tolist()
    seg = torch.tensor([[first] + drafts], dtype=torch.int32, device=dev)
    pos = torch.arange(n, n + SEG_S, dtype=torch.int32, device=dev)[None]
    before, seq = _clone_tree(caches), _clone_tree(caches)

    _reset_launch_counts()
    t0 = time.perf_counter()
    seg_logits, _, aux = tm.segment_step(params, seg, pos, caches, cfg, mode="exact")
    sync()
    seg_ms = (time.perf_counter() - t0) * 1e3
    exact_launches = _launch_counts()
    t0 = time.perf_counter()
    seq_logits = torch.stack([tm.decode_step(params, seg[:, i:i + 1], pos[:, i], seq, cfg,
                                             mode="exact")[0] for i in range(SEG_S)], dim=1)
    sync()
    seq_ms = (time.perf_counter() - t0) * 1e3
    argmax_seg = seg_logits.argmax(-1)[0].tolist()
    argmax_seq = seq_logits.argmax(-1)[0].tolist()
    gap = (seg_logits - seq_logits).abs().max().item()

    slots = {key: pos[0].long() % caches[key]["pos"].shape[-1] for key in caches}
    written = {key: {leaf: caches[key][leaf][:, 0, slots[key][:keep_count]].clone()
                     for leaf in ("k", "v", "pos")} for key in caches}
    tm.commit_segment(caches, aux, cfg, keep_pos=pos[:, keep_count - 1],
                      keep_count=torch.tensor([keep_count], device=dev),
                      active=torch.ones(1, dtype=torch.bool, device=dev))
    sync()
    # accepted rows: kept by the commit bit for bit, and the sequential
    # decode's within f32 noise.  Layer 0's rows come from one GEMM
    # reassociated (5 rows against 1), elementwise within 1e-4; deeper
    # layers compound it through the random weights, held at 1e-3 of
    # the rows' rms
    accepted_ok, rejected_ok, wrapped, layer0, depth = True, True, 0, 0.0, 0.0
    for key in caches:
        acc, rej = slots[key][:keep_count], slots[key][keep_count:]
        wrapped += int((before[key]["pos"][:, 0, rej] >= 0).sum())
        for leaf in ("k", "v", "pos"):
            got, want = caches[key][leaf][:, 0, acc], seq[key][leaf][:, 0, acc]
            accepted_ok &= torch.equal(got, written[key][leaf])
            if leaf == "pos":
                accepted_ok &= torch.equal(got, want)
            else:
                err = (got - want).abs()
                layer0 = max(layer0, (err[0] / (1 + want[0].abs())).max().item())
                rms = want.pow(2).flatten(1).mean(1).sqrt().clamp_min(1e-30)
                depth = max(depth, (err.flatten(1).amax(1) / rms).max().item())
            rejected_ok &= torch.equal(caches[key][leaf][:, 0, rej], before[key][leaf][:, 0, rej])
    accepted_ok &= layer0 <= 1e-4 and depth <= 1e-3

    # the same segment on the FAST rung, from the pre-segment cache
    for key in caches:
        for leaf in caches[key]:
            caches[key][leaf].copy_(before[key][leaf])
    del seq, before
    _reset_launch_counts()
    fast_logits, _, _ = tm.segment_step(params, seg, pos, caches, cfg, mode="fast")
    sync()
    fast_launches = _launch_counts()
    fast_finite = bool(torch.isfinite(fast_logits).all())
    del caches, aux, fast_logits

    rec = {"phase": "segment", "model": cfg.name, "layers": cfg.n_layers, "prompt_len": n,
           "positions": [n, n + SEG_S - 1], "drafts": len(drafts), "keep_count": keep_count,
           "argmax_segment": argmax_seg, "argmax_sequential": argmax_seq,
           "max_logit_gap": gap, "accepted_rows_layer0_max_err_over_1_plus_abs": layer0,
           "accepted_rows_max_err_over_rms": depth,
           "accepted_rows_ok": accepted_ok, "rejected_rows_bit_exact": rejected_ok,
           "rejected_rows_over_older_live_rows": wrapped, "prefill_ms": prefill_ms,
           "segment_ms": seg_ms, "sequential_decode_ms": seq_ms,
           "exact_segment_launches": {k: v for k, v in exact_launches.items() if v},
           "fast_segment_launches": {k: v for k, v in fast_launches.items() if v},
           "fast_logits_finite": fast_finite}

    if chunked:
        caches = tm.init_caches(cfg, 1, max_len, device=dev)
        t0 = time.perf_counter()
        for c0 in range(0, n, CHUNK):
            r = min(CHUNK, n - c0)
            toks = torch.zeros((1, CHUNK), dtype=torch.int32, device=dev)
            toks[0, :r] = torch.tensor(prompt[c0:c0 + r], dtype=torch.int32, device=dev)
            cpos = torch.arange(c0, c0 + CHUNK, dtype=torch.int32, device=dev)[None]
            logits, _, aux = tm.segment_step(params, toks, cpos, caches, cfg, mode="exact")
            tm.commit_segment(caches, aux, cfg, keep_pos=cpos[:, r - 1],
                              keep_count=torch.tensor([r], device=dev),
                              active=torch.ones(1, dtype=torch.bool, device=dev))
            last = logits[0, r - 1]
        sync()
        rec["chunked_prefill"] = {
            "chunk": CHUNK, "chunks": -(-n // CHUNK), "last_chunk_rows": n - CHUNK * (n // CHUNK),
            "next_token": int(last.argmax()), "prefill_next_token": first,
            "max_logit_gap": (last - first_logits[0]).abs().max().item(),
            "pad_rows_rolled_back": bool((caches["pos0"]["pos"][:, 0, n:] == -1).all()),
            "ms": (time.perf_counter() - t0) * 1e3}
        del caches, aux
    emit(rec)
    require(argmax_seg == argmax_seq, f"{cfg.name}: segment argmaxes {argmax_seg} differ from "
            f"sequential decode's {argmax_seq}")
    require(accepted_ok, f"{cfg.name}: commit_segment's accepted rows differ from the segment's "
            f"or from the sequential decode's (layer 0 {layer0}, over rms {depth})")
    require(rejected_ok, f"{cfg.name}: commit_segment did not restore the rejected rows")
    require(fast_finite, f"{cfg.name}: FAST segment logits not finite")
    if any(sp.window for sp in cfg.period):
        require(wrapped > 0, f"{cfg.name}: the segment wrapped no rolling-buffer slot")
    for k in ("qmatmul", "fused_swiglu"):
        require(fast_launches[k] > 0, f"{cfg.name}: the FAST segment launched no {k}")
    require(fast_launches["cordic_sincos"] == 1,
            f"{cfg.name}: the FAST segment launched K3 {fast_launches['cordic_sincos']} times")
    if cfg.final_softcap:
        require(fast_launches["universal_unary"] == 1,
                f"{cfg.name}: the FAST segment launched K5 {fast_launches['universal_unary']} times")
    if chunked:
        c = rec["chunked_prefill"]
        require(c["next_token"] == first and c["pad_rows_rolled_back"],
                f"{cfg.name}: chunked prefill {c} disagrees with prefill_step")
    return {"segment_fast": fast_launches}


def deepseek_phase(seed: int, strict: bool):
    """deepseek-7b: the slice-1 serving path (K1-K4), then the segment
    steps on its parameters, then (slice 8) the paged pool, speculative
    requests and prefix sharing on the same f32 parameters.  ``strict``:
    the tree must have the paged pool (a --root checkout may predate it)."""
    require(_has_paged() or not strict, "repro_torch.runtime.PagedCachePool is missing")
    rec, srv, prompts, tokens = _serve_model("deepseek_7b", seed, 1024, PROMPT_LENS, LEVELS,
                                             (480,))
    for name in ("qmatmul", "fused_swiglu", "cordic_sincos", "flash_attention"):
        require(rec["launches"][name] > 0, f"kernel {name} was not launched while serving")
    paths = {"serve": rec["launches"]}
    if _has_c3():
        prompt = next(p for p in prompts if len(p) == 480)
        paths.update(segment_phase(srv, srv.cfg, prompt, 1024, 3, True, seed))
    if _has_paged():
        cfg, params = srv.cfg, _release(srv)
        del srv
        paths.update(paged_phases(cfg, params, prompts, tokens, rec, seed))
    return paths


def gemma2_phase(seed: int, strict: bool):
    """gemma2-2b: sliding window, softcaps, tied head (K1-K5), then a
    segment across the local layers' window wrap, then (slice 8) its
    4500-token request served speculatively on both pools."""
    require(_has_paged() or not strict, "repro_torch.runtime.PagedCachePool is missing")
    rec, srv, prompts, tokens = _serve_model(
        "gemma2_2b", seed, 8192, PROMPT_LENS + (LONG_PROMPT, LONG_PROMPT),
        LEVELS + ("q16_16", "f32"), (480, LONG_PROMPT))
    launches = rec["launches"]
    for name in ("qmatmul", "fused_swiglu", "cordic_sincos", "flash_attention",
                 "universal_unary"):
        require(launches[name] > 0, f"gemma2-2b: kernel {name} was not launched while serving")
    # the final softcap: one K5 tanh per q16_16 pass (prefill or decode)
    want_k5 = rec["q16_16_prefills"] + rec["q16_16_passes"]
    require(launches["universal_unary"] == want_k5,
            f"gemma2-2b: K5 launched {launches['universal_unary']} times, want {want_k5}")
    require(launches["flash_attention"] == 26 * rec["requests"],
            f"gemma2-2b: K4 launched {launches['flash_attention']} times for "
            f"{rec['requests']} prefills, want 26 each")
    for lv in ("q16_16", "f32"):
        require(rec["launches_per_prefill"][lv]["flash_attention"] == 26,
                f"gemma2-2b: {lv} prefill launched K4 "
                f"{rec['launches_per_prefill'][lv]['flash_attention']} times, want 26")
    require(rec["launches_per_prefill"]["q16_16"]["universal_unary"] == 1
            and rec["launches_per_decode_tick"]["q16_16"]["universal_unary"] == 1,
            "gemma2-2b: K5 is not launched once per q16_16 pass")
    paths = {"serve": launches}
    if _has_c3():
        prompt = next(p for p in prompts if len(p) == LONG_PROMPT)
        seg = segment_phase(srv, srv.cfg, prompt, 8192, 2, False, seed)
        paths.update(seg)
    if _has_paged():
        # the 4500-token f32 request of the mixed run (the last one)
        prompt, want = prompts[-1], tokens[-1]
        cfg, params = srv.cfg, _release(srv)
        del srv
        paths.update(gemma2_spec_phase(cfg, params, prompt, want))
    return paths


# ---------------------------------------------------------------------------
# phases 4b-5b: the paged pool and ladder-speculative decoding (slice 8)
# ---------------------------------------------------------------------------

#: the paged servers' page and chunk, and the speculative rounds' drafts
PAGE, PAGED_CHUNK, SPEC_K = 16, 128, 4
#: the speculative requests' prompt lengths (taken from the mixed workload)
SPEC_LENS = (17, 96, 300, 480)
#: prefix sharing: 4 f32 requests, a 256-token prefix and 32-token tails
PREFIX_LEN, TAIL_LEN, PREFIX_NEW = 256, 32, 8
#: gemma2-2b's paged chunk
G2_CHUNK = 512
#: a speculative stream may differ from vanilla only at a near tie: the
#: top-2 margin of the vanilla logits at the first differing position
NEAR_TIE = 1e-2


def _has_paged() -> bool:
    """False only for a --root checkout older than the paged pool."""
    try:
        from repro_torch.runtime import PagedCachePool  # noqa: F401
    except ImportError:
        return False
    return True


def _release(srv):
    """Drop a server's KV pool and return its f32 parameter tensors (the
    int8 copies go with the server)."""
    import torch

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if not k.endswith("_q")}
        return node

    params = strip(srv.params)
    srv.pool = srv.params = None
    srv.engine.weight_cache.invalidate()  # the int8 copies
    gc.collect()
    torch.cuda.empty_cache()
    return params


def _route_replay(cfg, params, prefix, n_last: int) -> dict:
    """A MoE model's sensitivity to the exact rung's path at ``prefix``:
    the next token's logits and every layer's expert choices for the last
    ``n_last`` positions, computed (a) by ``prefill_step`` of all but the
    last token and one ``decode_step`` (vanilla decode's path) and (b) by
    ``prefill_step`` of the rest and one ``segment_step`` over the last
    ``n_last`` tokens (the verify's path), both in a batch-1 cache on a
    dropless copy of the config (capacity factor E / k: no token
    dropped, so only the paths differ).  Returns the logit gap, both
    argmaxes, path (a)'s top-2 margin and ``routing_flips``: the
    (position, layer) pairs whose expert set differs between the paths.
    A flip is a routing near tie: f32 noise of the order of the segment
    phase's logit gaps moved an expert across the top-k boundary, and
    the expert it swaps in changes the token's output by O(1).  A
    property of the model at that depth, reported: no gate reads it."""
    import dataclasses

    import torch

    from repro_torch import models as tm
    from repro_torch.models import moe as moe_mod

    m = cfg.moe
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    dev = torch.device(DEVICE)
    toks = torch.tensor([prefix], dtype=torch.int32, device=dev)
    n = len(prefix)
    picks, orig = [], moe_mod.top_k_stable

    def recorded(x, k):
        vals, idx = orig(x, k)
        picks.append(idx[0])
        return vals, idx

    moe_mod.top_k_stable = recorded
    try:
        caches = tm.init_caches(dropless, 1, n + 1, device=dev)
        tm.prefill_step(params, toks[:, :-1], caches, dropless, mode="exact")
        pre = list(picks)
        picks.clear()
        la, _ = tm.decode_step(params, toks[:, -1:], torch.tensor([n - 1], device=dev), caches,
                               dropless, mode="exact")
        route_a = [torch.cat([p[n - n_last:], d]) for p, d in zip(pre, picks)]
        picks.clear()
        caches = tm.init_caches(dropless, 1, n + 1, device=dev)
        tm.prefill_step(params, toks[:, :n - n_last], caches, dropless, mode="exact")
        picks.clear()
        lb, _, _ = tm.segment_step(params, toks[:, n - n_last:],
                                   torch.arange(n - n_last, n, device=dev)[None], caches,
                                   dropless, mode="exact")
        route_b = list(picks)
    finally:
        moe_mod.top_k_stable = orig
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum().item())
                for a, b in zip(route_a, route_b))
    top = la[0].topk(2).values
    return {"routing_flips": flips, "routed_pairs": n_last * len(route_a),
            "logit_gap": (la[0] - lb[0, -1]).abs().max().item(),
            "argmax_decode": int(la[0].argmax()), "argmax_segment": int(lb[0, -1].argmax()),
            "margin": (top[0] - top[1]).item()}


def _served_margin(srv, prompt, n_gen: int) -> dict:
    """Vanilla f32's choice of its ``n_gen``-th generated token of
    ``prompt``, replayed on ``srv``'s own path: the request served alone
    (slot 0) with ``max_new=n_gen``, and the top-2 margin of the logits
    of its last sampling call, with their argmax and whether the alone
    run's tokens are the batch's (``alone_tokens``)."""
    import repro_torch.runtime.serve as serve_mod
    from repro_torch.runtime import Request

    rows, orig = [], serve_mod._finish

    def recorded(logits, temperature, gen):
        rows.append(logits[0].float().clone())
        return orig(logits, temperature, gen)

    serve_mod._finish = recorded
    try:
        fin = srv.serve([Request(rid=srv.next_rid(), prompt=prompt, max_new=n_gen,
                                 level="f32")])
    finally:
        serve_mod._finish = orig
    top = rows[-1].topk(2)
    return {"margin": (top.values[0] - top.values[1]).item(),
            "argmax_alone": int(top.indices[0]),
            "alone_tokens": next(iter(fin.values())).tokens}


def _near_tie(cfg, params, prompt, want, got, srv=None) -> dict:
    """{"equal": bool} and, where ``got`` differs from ``want`` (the vanilla
    stream, prompt included), the first differing generated position and
    the top-2 margin there of the exact-rung logits of the vanilla prefix:
    for a dense model from ``prefill_step`` of that prefix; for a MoE
    model from vanilla's own served path (:func:`_served_margin` on
    ``srv``), since a one-shot prefill drops at capacity what the served
    chunks and decodes do not."""
    import torch

    from repro_torch import models as tm

    if got == want:
        return {"equal": True}
    i = next(j for j in range(len(prompt), len(want)) if j >= len(got) or got[j] != want[j])
    if cfg.moe:
        alone = _served_margin(srv, prompt, i - len(prompt) + 1)
        return {"equal": False, "first_diff": i - len(prompt), "margin": alone["margin"],
                "argmax_alone": alone["argmax_alone"], "vanilla_token": want[i],
                "alone_equals_batch": alone["alone_tokens"] == want[:i + 1]}
    caches = tm.init_caches(cfg, 1, len(want) + 1, device=torch.device(DEVICE))
    logits, _ = tm.prefill_step(params, torch.tensor([want[:i]], dtype=torch.int32,
                                                     device=torch.device(DEVICE)),
                                caches, cfg, mode="exact")
    top = logits[0].topk(2).values
    return {"equal": False, "first_diff": i - len(prompt), "margin": (top[0] - top[1]).item()}


def _count_drafts(srv) -> list:
    """Wrap the server's draft table; returns a one-item list counting
    draft PASSES (k a call)."""
    n = [0]
    k = srv.scfg.speculative.k

    def wrap(fn):
        def counted(*args, **kw):
            n[0] += k
            return fn(*args, **kw)
        return counted

    srv._spec_draft = tuple(wrap(fn) for fn in srv._spec_draft)
    return n


def _pool_drained(srv) -> bool:
    """No slot bound; on the paged pool every page free and every SSM
    lane zero."""
    if srv.scheduler.active_slots():
        return False
    if not srv.paged:
        return True
    snap = srv.metrics_snapshot()
    return all(snap["pages_live"][f"group={gk}"] == 0
               and snap["pages_free"][f"group={gk}"] == g["alloc"].n_pages - 1
               for gk, g in srv.cache_ops.groups.items()) and \
        not any(leaf.any() for node in srv.pool["slot"].values() for leaf in node.values())


def paged_phases(cfg, params, prompts, contig_tokens, contig, seed: int,
                 prefix_sharing: bool = True, max_len: int = 1024, levels=LEVELS,
                 speculative: bool = True):
    """``cfg`` (deepseek-7b; granite-moe-3b-a800m from slice 9; the SSM /
    MLA families from slice 10) on a paged pool of ``max_len`` rows a
    slot, then (``speculative``) speculative requests at both draft rungs
    against vanilla f32 on the paged pool (:func:`spec_phases`:
    identity-gated for a dense model, reported for a MoE one), then
    (``prefix_sharing``) prefix sharing against the same run with sharing
    off.  Every FAST chunk and pass must launch exactly
    :func:`fast_pass_launches`.  Returns {path: launches}."""
    import numpy as np
    import torch

    import repro_torch.runtime.serve as serve_mod
    from repro_torch.runtime import ContinuousBatchingServer, Request, ServingConfig

    dev, sync = torch.device(DEVICE), torch.cuda.synchronize
    paged = dict(n_slots=4, max_len=max_len, cache="paged", page_size=PAGE)
    paths = {}

    # -- the mixed workload through the paged pool --------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(**paged, prefill_chunk=PAGED_CHUNK),
                                   device=dev)
    sync()
    setup_s = time.perf_counter() - t0
    srv.serve([Request(rid=srv.next_rid(), prompt=prompts[0][:8], max_new=2, level=lv)
               for lv in ("q16_16", "f32")])
    sync()
    watch = _LogitWatch(serve_mod)
    reqs = [Request(rid=srv.next_rid(), prompt=p, max_new=MAX_NEW, level=lv)
            for p, lv in zip(prompts, levels)]
    q16_0 = srv.metrics_snapshot()["level_passes_total"].get("level=q16_16", 0)
    chunks0 = srv.stats["prefill_chunks"]
    _reset_launch_counts()
    t0 = time.perf_counter()
    fins = srv.serve(reqs)
    sync()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    q16_passes = srv.metrics_snapshot()["level_passes_total"].get("level=q16_16", 0) - q16_0
    chunks = srv.stats["prefill_chunks"] - chunks0
    drained = _pool_drained(srv)
    logits_ok = watch.ok()
    watch.close()
    got = [fins[r.rid].tokens for r in reqs]
    agree = sum(int(a == b) for g, c in zip(got, contig_tokens) for a, b in zip(g, c)) \
        - sum(len(p) for p in prompts)
    iso = srv.serve([Request(rid=srv.next_rid(), prompt=reqs[0].prompt, max_new=MAX_NEW,
                             level="q16_16")])
    isolation_ok = next(iter(iso.values())).tokens == got[0]
    # one gather of the whole pool (4 lanes x 1024 rows x 30 layers),
    # as every decode pass, draft and verify pays it
    tables = srv.cache_ops.device_tables()
    view_bytes = sum(v.numel() * v.element_size() for node in
                     srv.cache_ops.device_view(srv.pool, tables).values() for v in node.values())
    view_ms = time_ms(lambda: srv.cache_ops.device_view(srv.pool, tables), iters=5, warmup=2)
    ttft = {}
    long = next(p for p in prompts if len(p) == 480)
    for lv in ("q16_16", "f32"):
        sync()
        t1 = time.perf_counter()
        srv.serve([Request(rid=srv.next_rid(), prompt=long, max_new=1, level=lv)])
        sync()
        ttft[f"{lv}@480"] = (time.perf_counter() - t1) * 1e3
    n_tokens = sum(f.n_generated for f in fins.values())
    rec = {"phase": "paged", "model": cfg.name, "n_slots": 4, "max_len": max_len, "page_size": PAGE,
           "prefill_chunk": PAGED_CHUNK, "n_pages": srv.cache_ops.report()["groups"],
           "requests": len(reqs), "generated_tokens": n_tokens, "serve_wall_s": wall,
           "tokens_per_s": n_tokens / wall, "contiguous_tokens_per_s": contig["tokens_per_s"],
           "tokens_agreeing_with_contiguous": agree, "prefill_chunks": chunks,
           "launches": launches, "q16_16_passes": q16_passes, "pool_drained": drained,
           "all_logits_ok": logits_ok, "isolation_ok": isolation_ok,
           "device_view_ms": view_ms, "device_view_gb": view_bytes / 1e9,
           "device_view_bound_ms": 2 * view_bytes / HBM_BYTES_S * 1e3,
           "ttft_ms": ttft, "contiguous_ttft_ms": contig["ttft_ms"], "setup_s": setup_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "nvidia_smi": nvidia_smi()}
    emit(rec)
    del srv, fins, iso
    gc.collect()  # the server's hooks hold it in a reference cycle
    torch.cuda.empty_cache()
    for r, g in zip(reqs, got):
        require(len(g) == len(r.prompt) + MAX_NEW, f"paged: request {r.rid} gave {len(g)} tokens")
    require(logits_ok, "paged: logits not all finite")
    require(drained, "paged: the pool did not drain after the run")
    require(isolation_ok, "paged: the q16_16 request served alone differs from its batch tokens")
    require(launches["flash_attention"] == 0, "paged: chunked prefill launched K4")
    fast_chunks = sum(-(-len(p) // PAGED_CHUNK) for p, lv in zip(prompts, levels)
                      if lv == "q16_16")
    for name, n in fast_pass_launches(cfg).items():
        require(launches[name] == n * (fast_chunks + q16_passes),
                f"paged {cfg.name}: {name} launched {launches[name]} times, want {n} in "
                f"each of {fast_chunks} FAST chunks and {q16_passes} FAST passes")
    paths["paged"] = launches

    if speculative:
        spec_prompts = [next(p for p in prompts if len(p) == n) for n in SPEC_LENS]
        paths.update(spec_phases(cfg, params, spec_prompts, identity=not cfg.moe))

    if not prefix_sharing:
        return paths
    # -- prefix sharing against the same chunk grid without it ---------------
    rng = np.random.default_rng(seed + 1)
    prefix = rng.integers(0, cfg.vocab, PREFIX_LEN).tolist()
    shared = []
    for i in range(4):
        tail = rng.integers(0, cfg.vocab, TAIL_LEN).tolist()
        tail[0] = (prefix[-1] + 1 + i) % cfg.vocab   # the tails differ from their first token
        shared.append(prefix + tail)
    runs = {}
    for sharing in (False, True):
        torch.cuda.reset_peak_memory_stats()
        srv = ContinuousBatchingServer(cfg, params, ServingConfig(
            **paged, prefill_chunk=PAGE, prefix_sharing=sharing), device=dev)
        _reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        fins = srv.serve([Request(rid=i, prompt=p, max_new=PREFIX_NEW, level="f32")
                          for i, p in enumerate(shared)])
        sync()
        snap = srv.metrics_snapshot()
        runs[sharing] = {"tokens": [fins[i].tokens for i in range(4)],
                         "wall_s": time.perf_counter() - t0, **srv.stats,
                         "cow_copies_total": snap["cow_copies_total"],
                         "prefix_entries": snap["prefix_entries"],
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        launches = _launch_counts()
        del srv, fins
        gc.collect()
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    rec = {"phase": "prefix_sharing", "model": cfg.name, "prefix_len": PREFIX_LEN,
           "tail_len": TAIL_LEN, "max_new": PREFIX_NEW, "page_size": PAGE, "prefill_chunk": PAGE,
           "tokens_equal": on["tokens"] == off["tokens"],
           **{f"{k}_on": on[k] for k in on if k != "tokens"},
           **{f"{k}_off": off[k] for k in off if k != "tokens"}, "nvidia_smi": nvidia_smi()}
    emit(rec)
    require(rec["tokens_equal"], "prefix sharing: tokens differ from the run without it")
    require(on["prefix_hits"] == 3 and on["prefix_tokens_reused"] == 3 * PREFIX_LEN,
            f"prefix sharing: {on['prefix_hits']} hits, {on['prefix_tokens_reused']} tokens reused")
    paths["prefix_sharing"] = launches
    return paths


def spec_phases(cfg, params, spec_prompts, identity: bool, tag: str = "") -> dict:
    """Speculative requests (paged pool, k = SPEC_K) at both draft rungs
    against paged vanilla f32 on ``spec_prompts``; every draft pass launches exactly
    :func:`fast_pass_launches`.  With ``identity``
    every stream must equal vanilla's or part from it only at a near tie
    (:func:`_near_tie`), and each draft rung must have a draft accepted;
    without it (a MoE model at a depth where the exact rung's decode and
    verify paths part: ``moe_path_noise``) the streams and the acceptance
    are reported.  Returns {path + tag: launches}."""
    import torch

    import repro_torch.runtime.serve as serve_mod
    from repro_torch.runtime import ContinuousBatchingServer, Request, ServingConfig
    from repro_torch.runtime import SpeculativeConfig

    dev, sync = torch.device(DEVICE), torch.cuda.synchronize
    paged = dict(n_slots=4, max_len=1024, cache="paged", page_size=PAGE)
    vanilla, vanilla_wall, paths = None, None, {}
    for rung in ("q8_8", "q16_16"):
        torch.cuda.reset_peak_memory_stats()
        srv = ContinuousBatchingServer(cfg, params, ServingConfig(
            **paged, prefill_chunk=PAGED_CHUNK,
            speculative=SpeculativeConfig(k=SPEC_K, draft_level=rung, max_len=1024)), device=dev)
        srv.serve([Request(rid=srv.next_rid(), prompt=spec_prompts[0][:8], max_new=SPEC_K + 2,
                           speculative=True)])
        if vanilla is None:
            sync()
            t0 = time.perf_counter()
            v = srv.serve([Request(rid=srv.next_rid(), prompt=p, max_new=MAX_NEW, level="f32")
                           for p in spec_prompts])
            sync()
            vanilla_wall = time.perf_counter() - t0
            vanilla = [f.tokens for f in sorted(v.values(), key=lambda f: f.rid)]
        passes = _count_drafts(srv)
        stats0 = srv.stats
        sync()
        _reset_launch_counts()
        t0 = time.perf_counter()
        fins = srv.serve([Request(rid=srv.next_rid(), prompt=p, max_new=MAX_NEW, speculative=True)
                          for p in spec_prompts])
        sync()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        got = [f.tokens for f in sorted(fins.values(), key=lambda f: f.rid)]
        st = {k: srv.stats[k] - stats0[k] for k in ("spec_rounds", "spec_drafted",
                                                    "spec_accepted", "decode_steps")}
        ties = [_near_tie(cfg, params, p, w, g, srv) for p, w, g in zip(spec_prompts, vanilla, got)]
        names = tuple(lv for lv, _ in serve_mod.SPEC_DRAFT_LEVELS)
        rec = {
            "phase": "speculative", "model": cfg.name, "layers": cfg.n_layers,
            "identity_gated": identity, "draft_level": rung, "k": SPEC_K,
            "prompt_lens": list(SPEC_LENS), "max_new": MAX_NEW, **st,
            "acceptance_rate": st["spec_accepted"] / max(st["spec_drafted"], 1),
            "draft_passes": passes[0], "serve_wall_s": wall,
            "tokens_per_s": 4 * MAX_NEW / wall, "vanilla_f32_tokens_per_s": 4 * MAX_NEW / vanilla_wall,
            "draft_rungs_end": [names[i] for i in srv.draft_arbiter.idx],
            "draft_switches": [list(s) for s in srv.draft_arbiter.switches],
            "launches": launches,
            "launches_per_draft_pass": {k: v / max(passes[0], 1) for k, v in launches.items() if v},
            "vs_vanilla": ties, "pool_drained": _pool_drained(srv),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "nvidia_smi": nvidia_smi()}
        emit(rec)
        del srv, fins
        gc.collect()
        torch.cuda.empty_cache()
        for t in ties:
            require(not identity or t["equal"] or t["margin"] < NEAR_TIE,
                    f"speculative {rung}: differs from vanilla f32 beyond a near tie: {t}")
        require(rec["pool_drained"], f"speculative {rung}: the pool did not drain")
        require(st["spec_rounds"] > 0 and passes[0] > 0, f"speculative {rung}: no round ran")
        require(not identity or st["spec_accepted"] > 0,
                f"speculative {rung}: no draft token accepted in {st['spec_drafted']}")
        # the f32 verify launches none of them, nor K4 (chunked prefill)
        per = rec["launches_per_draft_pass"]
        want = {k: v for k, v in fast_pass_launches(cfg).items() if v}
        require({k: per.get(k) for k in want} == want and launches["flash_attention"] == 0,
                f"speculative {rung}: launches per draft pass {per}, want {want}; "
                f"K4 {launches['flash_attention']} times")
        paths[f"spec_draft_{rung}{tag}"] = launches
    return paths


def gemma2_spec_phase(cfg, params, prompt, want):
    """gemma2-2b: the 4500-token prompt speculatively (k=4, q16_16 drafts)
    on the contiguous pool (the draft's rollback across the window wrap)
    and on the paged pool; both against the f32 tokens of the mixed run."""
    import torch

    from repro_torch.runtime import ContinuousBatchingServer, Request, ServingConfig
    from repro_torch.runtime import SpeculativeConfig

    dev, sync = torch.device(DEVICE), torch.cuda.synchronize
    paths = {}
    for cache in ("contiguous", "paged"):
        torch.cuda.reset_peak_memory_stats()
        kw = dict(cache="paged", page_size=PAGE, prefill_chunk=G2_CHUNK) if cache == "paged" else {}
        srv = ContinuousBatchingServer(cfg, params, ServingConfig(
            n_slots=4, max_len=8192, **kw,
            speculative=SpeculativeConfig(k=SPEC_K, draft_level="q16_16", max_len=8192)),
            device=dev)
        passes = _count_drafts(srv)
        _reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        fins = srv.serve([Request(rid=0, prompt=prompt, max_new=MAX_NEW, speculative=True)])
        sync()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        tie = _near_tie(cfg, params, prompt, want, fins[0].tokens)
        rec = {"phase": "speculative", "model": cfg.name, "cache": cache, "prompt_len": len(prompt),
               "k": SPEC_K, "draft_level": "q16_16", "max_new": MAX_NEW, **srv.stats,
               "draft_passes": passes[0], "serve_wall_s": wall, "vs_vanilla": tie,
               "launches": launches,
               "launches_per_draft_pass": {k: v / max(passes[0], 1) for k, v in launches.items()
                                           if v and k != "flash_attention"},
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "nvidia_smi": nvidia_smi()}
        if cache == "paged":
            rec["prefill_chunk"] = G2_CHUNK
            rec["pool_drained"] = _pool_drained(srv)
        emit(rec)
        del srv, fins
        gc.collect()
        torch.cuda.empty_cache()
        require(tie["equal"] or tie["margin"] < NEAR_TIE,
                f"gemma2 speculative ({cache}): differs from f32 beyond a near tie: {tie}")
        require(rec["spec_rounds"] > 0 and rec.get("pool_drained", True),
                f"gemma2 speculative ({cache}): {rec['spec_rounds']} rounds, pool drained "
                f"{rec.get('pool_drained')}")
        per = rec["launches_per_draft_pass"]
        require(per.get("universal_unary") == 1 and per.get("cordic_sincos") == 1
                and per.get("qmatmul", 0) > 0 and per.get("fused_swiglu", 0) > 0,
                f"gemma2 speculative ({cache}): launches per draft pass {per}")
        # K4 only in the contiguous pool's f32 prefill_step, once a layer
        want_k4 = cfg.n_layers if cache == "contiguous" else 0
        require(launches["flash_attention"] == want_k4,
                f"gemma2 speculative ({cache}): K4 launched {launches['flash_attention']} "
                f"times, want {want_k4}")
        paths["spec_draft" if cache == "contiguous" else "spec_draft_paged"] = launches
    return paths


# ---------------------------------------------------------------------------
# phases 6-8: the MoE family, the int8 KV cache and command-r (slice 9)
# ---------------------------------------------------------------------------

#: mixtral-8x22b and command-r-35b run at full width and this depth (of 56
#: and 40 layers): their full f32 weights do not fit one card
CUT_LAYERS = 2
#: command-r's prompt lengths and rungs: request 0 is the only q16_16
#: lane of the first wave (the isolation contract)
CR_LENS = (17, 96, 300, 480, 64, 150)
CR_LEVELS = ("q16_16", "f32", "f32", "f32", "q16_16", "q16_16")
CR_PROMPT = 480
#: the int8 KV cache phase: a 480-token prefill and teacher-forced decodes
KV_PROMPT, KV_STEPS = 480, 16
#: the MoE speculative identity gate's depth: full width, and few enough
#: layers that the exact rung's decode and verify paths still agree (at
#: 32 random layers they part: moe_path_noise, tools/torch_moe_path_divergence.py)
SPEC_ID_LAYERS = 4


def _has_moe() -> bool:
    """False only for a --root checkout older than the MoE slice."""
    from repro_torch.configs import PORTED

    return "granite_moe_3b_a800m" in PORTED


def moe_gates(rec, cfg) -> None:
    """Per FAST pass of a MoE model: the grouped K2 and K1 entries
    exactly ``n_layers`` times each and the dense K2 never; K4 once a
    layer of every contiguous prefill; no grouped launch at ``f32``."""
    L = cfg.n_layers
    for lv, grouped in (("q16_16", L), ("f32", 0)):
        for what, counts in (("prefill", rec["launches_per_prefill"][lv]),
                             ("decode pass", rec["launches_per_decode_tick"][lv])):
            got = {k: counts[k] for k in GROUPED + ("fused_swiglu",)}
            require(got == {**{g: grouped for g in GROUPED}, "fused_swiglu": 0},
                    f"{cfg.name}: a {lv} {what} launched {got}, want the grouped entries "
                    f"{grouped} times each and the dense K2 never")
        require(rec["launches_per_prefill"][lv]["flash_attention"] == L,
                f"{cfg.name}: a {lv} prefill launched K4 "
                f"{rec['launches_per_prefill'][lv]['flash_attention']} times, want {L}")
    launches = rec["launches"]
    want = L * (rec["q16_16_prefills"] + rec["q16_16_passes"])
    for g in GROUPED:
        require(launches[g] == want, f"{cfg.name}: {g} launched {launches[g]} times in the "
                f"mixed run, want {want} (n_layers x FAST passes)")
    require(launches["fused_swiglu"] == 0, f"{cfg.name}: the dense K2 ran in the mixed run")
    require(launches["flash_attention"] == L * rec["requests"],
            f"{cfg.name}: K4 launched {launches['flash_attention']} times for "
            f"{rec['requests']} prefills, want {L} each")


def _count_plain(counts: dict):
    """Wrap K2's and K1's plain versions (which the wrappers, the grouped
    entries' included, must never reach with a CUDA tensor) so ``counts``
    sees every call; returns the undo."""
    import importlib

    saved = [(importlib.import_module("repro_torch.kernels.fused_mlp.fused_mlp"),
              "fused_swiglu_plain"),
             (importlib.import_module("repro_torch.kernels.qmatmul.qmatmul"),
              "qmatmul_plain")]
    originals = [getattr(mod, name) for mod, name in saved]

    def counted(name, fn):
        def wrapper(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapper

    for (mod, name), fn in zip(saved, originals):
        setattr(mod, name, counted(name, fn))

    def undo():
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)
    return undo


def _int8_rows_exact(c8: dict, c32: dict, rows) -> bool:
    """The int8 cache ``c8`` holds, at the positions ``rows(pos)`` selects,
    its f32 twin's rows quantized (``attention._q8``: payloads and
    exponents bit for bit) at the same positions, every layer."""
    import torch

    from repro_torch.models.attention import _q8

    ok = True
    for key, node in c32.items():
        sel = rows(node["pos"])
        ok &= torch.equal(c8[key]["pos"], node["pos"])
        for name in ("k", "v"):
            q, e = _q8(node[name], axes=(-1,))
            ok &= torch.equal(c8[key][name][sel], q[sel])
            ok &= torch.equal(c8[key][f"{name}_exp"][sel], e[sel])
    return bool(ok)


def int8_kv_phase(srv, prompt, seed: int) -> dict:
    """The served model's int8 KV cache (``init_caches(quantized=True)``)
    against its f32 cache on one request: a KV_PROMPT-token prefill and
    KV_STEPS teacher-forced decodes (the same random tokens fed to both),
    at each rung.  Gated: after the prefill every written row of the int8
    cache is its f32 twin's row quantized, bit for bit (placement and
    quantizer at the model's shapes); after the decodes so are the first
    layer's decode rows (its input is the forced token alone); and the
    int8 decode attention over the final cache equals the f32 decode
    attention over the same cache dequantized (both run in f32; powers of
    two scale exactly).  Reported: the largest logit difference against
    the f32 cache's logit scale and tests/test_quantized_kv.py's bound
    (0.08 * scale + 0.15: a random model's attention with weights at
    n_periods**-0.5, the reference's init law, is a hard max, which the
    cache's rounding can move), and the bytes of each cache."""
    import numpy as np
    import torch

    from repro_torch import models as tm
    from repro_torch.models.attention import decode_attention

    cfg, dev = srv.cfg, torch.device(DEVICE)
    forced = np.random.default_rng(seed + 2).integers(0, cfg.vocab, KV_STEPS)
    max_len = KV_PROMPT + KV_STEPS
    out = {"phase": "int8_kv_cache", "model": cfg.name, "prompt_len": KV_PROMPT,
           "decode_steps": KV_STEPS}
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    for lv, mode in (("q16_16", "fast"), ("f32", "exact")):
        logits, nbytes, caches = {}, {}, {}
        for quantized in (False, True):
            c = tm.init_caches(cfg, 1, max_len, device=dev, quantized=quantized)
            nbytes[quantized] = sum(v.numel() * v.element_size() for node in c.values()
                                    for v in node.values())
            lg, c = tm.prefill_step(srv.params, torch.tensor([prompt[:KV_PROMPT]], device=dev),
                                    c, cfg, mode=mode)
            if quantized:
                prefill_exact = _int8_rows_exact(c, pre32, lambda pos: pos >= 0)
                del pre32
            else:
                pre32 = {k: {n: t.clone() for n, t in node.items()} for k, node in c.items()}
            seq = [lg]
            for i in range(KV_STEPS):
                lg, c = tm.decode_step(srv.params, torch.tensor([[int(forced[i])]], device=dev),
                                       torch.tensor([KV_PROMPT + i], device=dev), c, cfg,
                                       mode=mode)
                seq.append(lg)
            logits[quantized], caches[quantized] = torch.stack(seq).float(), c
        c8, c32 = caches[True], caches[False]
        first = {k: {n: t[:1] for n, t in node.items()} for k, node in c8.items()}
        decode_exact = _int8_rows_exact(
            {k: v for k, v in first.items() if k == "pos0"},
            {k: {n: t[:1] for n, t in node.items()} for k, node in c32.items() if k == "pos0"},
            lambda pos: pos >= KV_PROMPT)
        # the decode attention on the last layer's final int8 cache, a
        # random query at the f32 cache's key scale
        node = {n: t[-1] for n, t in c8[f"pos{len(cfg.period) - 1}"].items()}
        k_rms = c32["pos0"]["k"][0].float().pow(2).mean().sqrt().item()
        q = torch.randn((1, 1, cfg.n_heads, cfg.head_dim), generator=gen, device=dev) * k_rms
        layer = cfg.period[-1]
        kw = dict(q_position=torch.tensor([max_len - 1], device=dev), window=layer.window,
                  cap=cfg.attn_softcap)
        att8 = decode_attention(q, node["k"], node["v"], node["pos"], k_exp=node["k_exp"],
                                v_exp=node["v_exp"], **kw)
        deq = {n: node[n].float() * torch.exp2(node[f"{n}_exp"].float())[..., None]
               for n in ("k", "v")}
        att32 = decode_attention(q, deq["k"], deq["v"], node["pos"], **kw)
        att_err = (att8 - att32).abs().max().item()
        diff = (logits[True] - logits[False]).abs().max().item()
        scale = logits[False].abs().max().item()
        out[lv] = {"prefill_rows_bit_exact": prefill_exact,
                   "first_layer_decode_rows_bit_exact": decode_exact,
                   "decode_attention_max_abs_err": att_err,
                   "decode_attention_scale": att32.abs().max().item(),
                   "decode_attention_bit_exact": bool(torch.equal(att8, att32)),
                   "k_rms_first_layer": k_rms,
                   "max_abs_logit_diff": diff, "logit_scale": scale,
                   "reference_bound": 0.08 * scale + 0.15,
                   "argmax_agree": int((logits[True].argmax(-1) == logits[False].argmax(-1))
                                       .sum().item()),
                   "positions": KV_STEPS + 1,
                   "finite": bool(torch.isfinite(logits[True]).all().item())}
        out["cache_bytes_f32"], out["cache_bytes_int8"] = nbytes[False], nbytes[True]
        del caches, c8, c32, first, node, deq
    out["nvidia_smi"] = nvidia_smi()
    emit(out)
    for lv in ("q16_16", "f32"):
        r = out[lv]
        what = f"{cfg.name} int8 KV cache ({lv})"
        require(r["finite"], f"{what}: logits not all finite")
        require(r["prefill_rows_bit_exact"], f"{what}: the prefill's rows are not the f32 "
                "cache's rows quantized")
        require(r["first_layer_decode_rows_bit_exact"], f"{what}: the first layer's decode "
                "rows are not the f32 cache's rows quantized")
        require(r["decode_attention_max_abs_err"] <= 1e-6 * r["decode_attention_scale"],
                f"{what}: decode attention over the int8 cache differs from it over the "
                f"dequantized cache by {r['decode_attention_max_abs_err']}")
    # int8 payloads and one int32 exponent per row and kv head of 64
    # values: 2 * (64 + 4) bytes against 2 * 64 * 4
    require(out["cache_bytes_int8"] < 0.3 * out["cache_bytes_f32"],
            f"int8 KV cache: {out['cache_bytes_int8']} bytes against {out['cache_bytes_f32']}")
    return out


def spec_identity_phase(name: str, seed: int) -> dict:
    """``name`` at full width cut to SPEC_ID_LAYERS layers: the exact
    rung's path noise at that depth (reported) and speculative requests
    at both draft rungs under the identity gate, their acceptance
    reported.  Returns {path: launches}."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(name), n_layers=SPEC_ID_LAYERS)
    params = init_params(cfg, seed=seed, device=torch.device(DEVICE))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    spec_prompts = [next(p for p in prompts if len(p) == n) for n in SPEC_LENS]
    emit({"phase": "moe_path_noise", "model": cfg.name, "layers": cfg.n_layers,
          "prefix_len": len(spec_prompts[-1]), "segment": 9,
          **_route_replay(cfg, params, spec_prompts[-1], 9), "nvidia_smi": nvidia_smi()})
    paths = spec_phases(cfg, params, spec_prompts, identity=True,
                        tag=f"_{SPEC_ID_LAYERS}_layers")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def granite_phase(seed: int, strict: bool):
    """granite-moe-3b-a800m at its published width and depth (32 layers, 40
    experts top-8): the mixed workload on the contiguous pool with the MoE
    gates, K1's and K2's plain versions never reached, the int8 KV cache,
    then the paged pool and speculative
    requests at both draft rungs (reported), then the speculative identity
    gate at SPEC_ID_LAYERS layers."""
    import torch

    plain = {}
    undo = _count_plain(plain)
    try:
        rec, srv, prompts, tokens = _serve_model("granite_moe_3b_a800m", seed, 1024,
                                                 PROMPT_LENS, LEVELS, (480,))
        moe_gates(rec, srv.cfg)
        paths = {"serve": rec["launches"]}
        int8_kv_phase(srv, next(p for p in prompts if len(p) == KV_PROMPT), seed)
        # the exact rung's path noise through 32 routed layers: the
        # KV_PROMPT-token request's prompt and first 8 tokens, decode
        # against segment (reported: why the identity gate runs at
        # SPEC_ID_LAYERS)
        long = next(t for p, t in zip(prompts, tokens) if len(p) == KV_PROMPT)
        emit({"phase": "moe_path_noise", "model": srv.cfg.name, "prefix_len": KV_PROMPT + 8,
              "segment": 9, **_route_replay(srv.cfg, srv.params, long[:KV_PROMPT + 8], 9),
              "nvidia_smi": nvidia_smi()})
        cfg, params = srv.cfg, _release(srv)
        del srv
        paths.update(paged_phases(cfg, params, prompts, tokens, rec, seed,
                                  prefix_sharing=False))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(spec_identity_phase("granite_moe_3b_a800m", seed))
    finally:
        undo()
    require(not plain, f"granite: the K1 / K2 plain versions ran on the card: {plain}")
    return paths


def mixtral_phase(seed: int, strict: bool):
    """mixtral-8x22b at full width (d_model 6144, 8 experts of 16384, top-2,
    window 4096), CUT_LAYERS of its 56 layers: the mixed workload plus one
    4500-token prompt per rung on an 8192-token pool, so a prompt crosses
    the window with MoE behind it; the MoE gates; the int8 KV cache."""
    plain = {}
    undo = _count_plain(plain)
    try:
        rec, srv, prompts, _ = _serve_model("mixtral_8x22b", seed, 8192,
                                            PROMPT_LENS + (LONG_PROMPT, LONG_PROMPT),
                                            LEVELS + ("q16_16", "f32"), (480, LONG_PROMPT),
                                            n_layers=CUT_LAYERS)
        int8_kv_phase(srv, next(p for p in prompts if len(p) == KV_PROMPT), seed)
    finally:
        undo()
    require(not plain, f"mixtral: the K1 / K2 plain versions ran on the card: {plain}")
    moe_gates(rec, srv.cfg)
    return {"serve": rec["launches"]}


def command_r_phase(seed: int, strict: bool):
    """command-r-35b at full width (d_model 8192, d_ff 22528, the 256000 x
    8192 tied embedding), CUT_LAYERS of its 40 layers: a few requests at
    both rungs on K1-K4 (K2 at K=8192 F=22528, K1 at K=22528), then the
    int8 KV cache at head_dim 128."""
    rec, srv, prompts, _ = _serve_model("command_r_35b", seed, 1024, CR_LENS, CR_LEVELS,
                                        (CR_PROMPT,), n_layers=CUT_LAYERS)
    launches = rec["launches"]
    for name in ("qmatmul", "fused_swiglu", "cordic_sincos", "flash_attention"):
        require(launches[name] > 0, f"command-r: kernel {name} was not launched while serving")
    require(launches["flash_attention"] == CUT_LAYERS * rec["requests"],
            f"command-r: K4 launched {launches['flash_attention']} times, want "
            f"{CUT_LAYERS} a prefill")
    int8_kv_phase(srv, next(p for p in prompts if len(p) == KV_PROMPT), seed)
    return {"serve": launches}



# ---------------------------------------------------------------------------
# phases 9-11: the SSM and MLA families (slice 10)
# ---------------------------------------------------------------------------

#: jamba-v0.1-52b runs at full width and one period (8 of its 32 layers:
#: the least depth with all four layer kinds); its 51.5 B f32 parameters
#: do not fit one card
JAMBA_LAYERS = 8


def _has_ssm() -> bool:
    """False only for a --root checkout older than the SSM / MLA slice."""
    from repro_torch.configs import PORTED

    return "mamba2_1_3b" in PORTED


def fast_pass_launches(cfg) -> dict:
    """The kernel launches of one FAST pass of ``cfg`` on cached int8
    weights (a prefill, a decode pass, a draft pass or a prefill chunk):
    K1 on every projection (4 a GQA or MLA layer, 6 a mamba layer, an
    MLP's ``w_down``), K2 once an MLP layer, the grouped K2 and K1 entries
    once a MoE layer, K3 once a pass of a model with attention."""
    k1 = k2 = moe = 0
    for sp in cfg.period:
        k1 += 6 if sp.kind == "mamba" else 4
        k1 += sp.ffn == "mlp"
        k2 += sp.ffn == "mlp"
        moe += sp.ffn == "moe"
    n = cfg.n_periods
    return {"qmatmul": n * k1, "fused_swiglu": n * k2, "cordic_sincos": int(cfg.has_attention),
            **{g: n * moe for g in GROUPED}}


def attn_layers(cfg) -> int:
    """Layers whose contiguous prefill runs K4 (GQA and MLA)."""
    return cfg.n_periods * sum(sp.kind in ("attn", "mla") for sp in cfg.period)


def family_gates(rec, cfg) -> None:
    """Every FAST prefill and decode pass launches exactly
    :func:`fast_pass_launches`, an f32 pass none of them; every prefill
    runs K4 once an attention layer, a decode pass never; the mixed run's
    totals are those counts times its FAST passes and prefills."""
    want = fast_pass_launches(cfg)
    for lv in ("q16_16", "f32"):
        exp = want if lv == "q16_16" else {k: 0 for k in want}
        for what, counts in (("prefill", rec["launches_per_prefill"][lv]),
                             ("decode pass", rec["launches_per_decode_tick"][lv])):
            got = {k: counts[k] for k in want}
            require(got == exp, f"{cfg.name}: a {lv} {what} launched {got}, want {exp}")
        k4 = (rec["launches_per_prefill"][lv]["flash_attention"],
              rec["launches_per_decode_tick"][lv]["flash_attention"])
        require(k4 == (attn_layers(cfg), 0), f"{cfg.name}: a {lv} prefill / decode pass "
                f"launched K4 {k4} times, want ({attn_layers(cfg)}, 0)")
    passes = rec["q16_16_prefills"] + rec["q16_16_passes"]
    for k, n in want.items():
        require(rec["launches"][k] == n * passes, f"{cfg.name}: {k} launched "
                f"{rec['launches'][k]} times in the mixed run, want {n} x {passes} FAST passes")
    require(rec["launches"]["flash_attention"] == attn_layers(cfg) * rec["requests"],
            f"{cfg.name}: K4 launched {rec['launches']['flash_attention']} times for "
            f"{rec['requests']} prefills, want {attn_layers(cfg)} each")


def _leaf_rows(cache, keep):
    """{leaf: rows} of one cache node: a position-indexed node's rows at
    ``keep`` (slots) of lane 0, an SSM node's lane 0 whole."""
    if "pos" in cache:
        return {leaf: cache[leaf][:, 0, keep] for leaf in cache}
    return {leaf: cache[leaf][:, 0] for leaf in cache}


#: the isolated mixer's prefill length (the segment phase's prompt)
ISO_PREFIX = 480


@contextlib.contextmanager
def _patched(mod, **fns):
    """Swap ``mod``'s functions for ``fns`` for the block's duration."""
    orig = {n: getattr(mod, n) for n in fns}
    for n, fn in fns.items():
        setattr(mod, n, fn)
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(mod, n, fn)


def _rowwise(fn):
    """``fn``, a per-position function of x (B,S,...), run one position at
    a time, at the shape a single-token decode gives it."""
    import torch

    def call(x, *a, **kw):
        return torch.cat([fn(x[:, t:t + 1], *a, **kw) for t in range(x.shape[1])], dim=1)
    return call


def _gap_over_rms(got, want) -> float:
    """max |got - want| over the rms of ``want``."""
    rms = want.pow(2).mean().sqrt().clamp_min(1e-30)
    return ((got - want).abs().max() / rms).item()


def ssm_isolation(params, cfg, keep_count: int, seed: int) -> dict:
    """Every mamba layer of ``cfg`` alone (exact rung, batch 1) on the
    same seeded layer inputs both ways: an ISO_PREFIX-row prefill, then
    one ``ssm_forward`` segment of SEG_S positions against SEG_S
    single-token decodes.  Returns, over the layers, the largest gap of
    the segment's state after ``keep_count`` positions, its last state
    and its conv carry to the decodes', over the decodes' rms: with the
    segment as served (its projections and norms over SEG_S rows) and
    with those run a row at a time, as a decode runs them."""
    import numpy as np
    import torch

    from repro_torch import models as tm
    from repro_torch.models import ssm as ssm_mod

    dev, gap = torch.device(DEVICE), _gap_over_rms
    rng = np.random.default_rng(seed)
    x0, xs = (torch.from_numpy(rng.standard_normal((1, n, cfg.d_model), dtype=np.float32)).to(dev)
              for n in (ISO_PREFIX, SEG_S))
    out = {"segment": 0.0, "segment_row_at_a_time": 0.0, "layers": 0}
    for i in range(cfg.n_periods):
        lp = tm.layer_params(params, i)
        for j, sp in enumerate(cfg.period):
            if sp.kind != "mamba":
                continue
            p = lp[f"pos{j}"]["mixer"]
            base = ssm_mod.init_ssm_cache(cfg, 1, device=dev)
            ssm_mod.ssm_forward(p, x0, cfg, mode="exact", cache=base, prefill=True)
            seq = {k: v.clone() for k, v in base.items()}
            seq_states = []
            for t in range(SEG_S):
                ssm_mod.ssm_forward(p, xs[:, t:t + 1], cfg, mode="exact", cache=seq)
                seq_states.append(seq["state"].clone())
            for what in ("segment", "segment_row_at_a_time"):
                seg, aux = {k: v.clone() for k, v in base.items()}, {}
                rows = (dict(pdot=_rowwise(ssm_mod.pdot), rms_norm=_rowwise(ssm_mod.rms_norm))
                        if what == "segment_row_at_a_time" else {})
                with _patched(ssm_mod, **rows):
                    ssm_mod.ssm_forward(p, xs, cfg, mode="exact", cache=seg, seg_aux=aux)
                out[what] = max(out[what], gap(aux["states"][:, keep_count - 1],
                                               seq_states[keep_count - 1]),
                                gap(seg["state"], seq["state"]), gap(seg["conv"], seq["conv"]))
            out["layers"] += 1
    return out


def _first_mamba_inputs(ssm_mod, cfg, into: list):
    """A spy for ``ssm_mod.ssm_forward`` that appends to ``into`` the input
    of the model's first mamba layer in every pass."""
    n = cfg.n_periods * sum(sp.kind == "mamba" for sp in cfg.period)
    orig, count = ssm_mod.ssm_forward, [0]

    def spy(params, x, *a, **kw):
        if count[0] % n == 0:
            into.append(x.clone())
        count[0] += 1
        return orig(params, x, *a, **kw)
    return spy


def hybrid_segment_phase(srv, cfg, prompt, max_len: int, keep_count: int, seed: int):
    """The segment steps of an SSM / MLA model on the served parameters
    (batch 1): exact-rung prefill of ``prompt``, one ``segment_step`` of
    SEG_S tokens whose argmaxes must equal SEG_S sequential
    ``decode_step`` calls; ``commit_segment`` at ``keep_count``: the
    accepted latent rows kept bit for bit, the rejected ones the
    pre-segment rows bit for bit, an SSM layer's state the segment's
    candidate after ``keep_count`` positions and its conv history the
    matching rows, bit for bit, and within f32 noise of the sequential
    decode's after ``keep_count`` steps (the model's first layer, when it
    is a mamba layer, within 1e-4 of the state's rms; deeper layers
    reported, with the gap of the first mamba layer's input); every mamba
    layer alone (:func:`ssm_isolation`) bit for bit once the segment's
    projections and norms run a row at a time; a second commit
    with the lane inactive restores the whole pre-segment cache bit for
    bit; the FAST segment launches exactly one pass's kernels; and a
    chunked f32 prefill (CHUNK-token segments, the SSM state carried from
    chunk to chunk) picks ``prefill_step``'s next token.  Returns
    {path: launches}."""
    import numpy as np
    import torch

    from repro_torch import models as tm
    from repro_torch.models import ssm as ssm_mod

    dev, sync, params = torch.device(DEVICE), torch.cuda.synchronize, srv.params
    has_ssm = any(sp.kind == "mamba" for sp in cfg.period)
    ins = []
    spy = dict(ssm_forward=_first_mamba_inputs(ssm_mod, cfg, ins)) if has_ssm else {}
    one = torch.ones(1, dtype=torch.bool, device=dev)
    n = len(prompt)
    caches = tm.init_caches(cfg, 1, max_len, device=dev)
    first_logits, _ = tm.prefill_step(params, torch.tensor([prompt], dtype=torch.int32,
                                                           device=dev), caches, cfg, mode="exact")
    first = int(first_logits.argmax())
    drafts = np.random.default_rng(seed).integers(0, cfg.vocab, SEG_S - 1).tolist()
    seg = torch.tensor([[first] + drafts], dtype=torch.int32, device=dev)
    pos = torch.arange(n, n + SEG_S, dtype=torch.int32, device=dev)[None]
    before, seq = _clone_tree(caches), _clone_tree(caches)
    seq_logits, seq_at_keep = [], None
    with _patched(ssm_mod, **spy):
        sync()
        t0 = time.perf_counter()
        seg_logits, _, aux = tm.segment_step(params, seg, pos, caches, cfg, mode="exact")
        sync()
        seg_ms = (time.perf_counter() - t0) * 1e3
        after = _clone_tree(caches)
        for i in range(SEG_S):
            seq_logits.append(tm.decode_step(params, seg[:, i:i + 1], pos[:, i], seq, cfg,
                                             mode="exact")[0])
            if i + 1 == keep_count:
                seq_at_keep = _clone_tree(seq)
    seq_logits = torch.stack(seq_logits, dim=1)
    # the first mamba layer's input, segment against the decodes
    input_gap = (max(_gap_over_rms(ins[0][:, t], ins[1 + t][:, 0]) for t in range(SEG_S))
                 if has_ssm else None)
    del ins
    argmax_seg = seg_logits.argmax(-1)[0].tolist()
    argmax_seq = seq_logits.argmax(-1)[0].tolist()

    tm.commit_segment(caches, aux, cfg, keep_pos=pos[:, keep_count - 1],
                      keep_count=torch.tensor([keep_count], device=dev), active=one)
    slots = pos[0].long()
    acc, rej = slots[:keep_count], slots[keep_count:]
    kept_ok, restored_ok, noise, noise0, first_ssm = True, True, 0.0, None, None
    for key, node in caches.items():
        if "pos" in node:
            for leaf in node:
                kept_ok &= torch.equal(node[leaf][:, 0, acc], after[key][leaf][:, 0, acc])
                restored_ok &= torch.equal(node[leaf][:, 0, rej], before[key][leaf][:, 0, rej])
            continue
        a = aux[key]
        kept_ok &= torch.equal(node["state"][:, 0], a["states"][:, 0, keep_count - 1])
        kept_ok &= torch.equal(node["conv"][:, 0], a["conv_hist"][:, 0, keep_count:
                                                                  keep_count + node["conv"].shape[2]]
                               .to(node["conv"].dtype))
        for leaf in ("state", "conv"):
            got, want = node[leaf][:, 0], seq_at_keep[key][leaf][:, 0]
            rms = want.pow(2).flatten(1).mean(1).sqrt().clamp_min(1e-30)
            per_layer = (got - want).abs().flatten(1).amax(1) / rms         # (P,)
            noise = max(noise, per_layer.max().item())
            first_ssm = first_ssm or key
            if key == first_ssm:
                noise0 = max(noise0 or 0.0, per_layer[0].item())
    # the same segment again with the lane inactive: nothing may change
    for key in caches:
        for leaf in caches[key]:
            caches[key][leaf].copy_(before[key][leaf])
    _, _, aux = tm.segment_step(params, seg, pos, caches, cfg, mode="exact")
    tm.commit_segment(caches, aux, cfg, keep_pos=pos[:, keep_count - 1],
                      keep_count=torch.tensor([keep_count], device=dev), active=~one)
    inactive_ok = all(torch.equal(caches[k][leaf], before[k][leaf])
                      for k in caches for leaf in caches[k])

    # the FAST segment from the pre-segment cache: one pass's kernels
    _reset_launch_counts()
    fast_logits, _, _ = tm.segment_step(params, seg, pos, caches, cfg, mode="fast")
    sync()
    fast_launches = _launch_counts()
    fast_finite = bool(torch.isfinite(fast_logits).all())
    del seq, seq_at_keep, before, after, aux, fast_logits
    iso = ssm_isolation(params, cfg, keep_count, seed) if has_ssm else None

    # the chunked f32 prefill, the SSM state carried through the segment path
    caches = tm.init_caches(cfg, 1, max_len, device=dev)
    sync()
    t0 = time.perf_counter()
    for c0 in range(0, n, CHUNK):
        r = min(CHUNK, n - c0)
        toks = torch.zeros((1, CHUNK), dtype=torch.int32, device=dev)
        toks[0, :r] = torch.tensor(prompt[c0:c0 + r], dtype=torch.int32, device=dev)
        cpos = torch.arange(c0, c0 + CHUNK, dtype=torch.int32, device=dev)[None]
        logits, _, caux = tm.segment_step(params, toks, cpos, caches, cfg, mode="exact")
        tm.commit_segment(caches, caux, cfg, keep_pos=cpos[:, r - 1],
                          keep_count=torch.tensor([r], device=dev), active=one)
        last = logits[0, r - 1]
        del caux
    sync()
    chunked = {"chunk": CHUNK, "chunks": -(-n // CHUNK), "next_token": int(last.argmax()),
               "prefill_next_token": first,
               "max_logit_gap": (last - first_logits[0]).abs().max().item(),
               "ms": (time.perf_counter() - t0) * 1e3,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    want_fast = fast_pass_launches(cfg)
    rec = {"phase": "segment", "model": cfg.name, "layers": cfg.n_layers, "prompt_len": n,
           "positions": [n, n + SEG_S - 1], "keep_count": keep_count,
           "argmax_segment": argmax_seg, "argmax_sequential": argmax_seq,
           "max_logit_gap": (seg_logits - seq_logits).abs().max().item(),
           "kept_bit_exact": kept_ok, "rejected_restored_bit_exact": restored_ok,
           "ssm_vs_sequential_max_err_over_rms": noise,
           "ssm_first_layer_vs_sequential_max_err_over_rms": noise0,
           "ssm_first_layer_input_gap_over_rms": input_gap,
           "ssm_mixer_alone_vs_sequential_max_err_over_rms": iso,
           "inactive_lane_bit_exact": inactive_ok,
           "segment_ms": seg_ms, "fast_segment_launches": {k: v for k, v in
                                                           fast_launches.items() if v},
           "fast_logits_finite": fast_finite, "chunked_prefill": chunked,
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    require(argmax_seg == argmax_seq, f"{cfg.name}: segment argmaxes {argmax_seg} differ from "
            f"sequential decode's {argmax_seq}")
    require(kept_ok and restored_ok and inactive_ok,
            f"{cfg.name}: commit_segment kept {kept_ok}, restored {restored_ok}, inactive lane "
            f"{inactive_ok}")
    # the committed SSM state against the sequential decode's.  Every
    # mamba layer alone, on the same inputs both ways: the segment's
    # projections and norms run over SEG_S rows, a decode's over one, and
    # that is the only difference: run a row at a time, the segment's
    # states and conv carry are the decodes' bit for bit (as served, the
    # gap is reported).  In the model, where the first layer is a mamba
    # layer (mamba2) its inputs are the same embeddings: within 1e-4.
    # Behind other layers (jamba's attention and MLP) the first mamba
    # layer's input already differs by ``input_gap``, and deeper layers
    # compound it through the cumulative state: reported
    require(iso is None or iso["segment_row_at_a_time"] == 0.0,
            f"{cfg.name}: a mamba layer's segment alone, run a row at a time, is {iso} of "
            "its rms off the sequential decode's")
    if first_ssm == "pos0":
        require(noise0 <= 1e-4, f"{cfg.name}: the first layer's committed SSM state is "
                f"{noise0} of its rms off the sequential decode's")
    require(fast_finite, f"{cfg.name}: FAST segment logits not finite")
    require({k: fast_launches[k] for k in want_fast} == want_fast,
            f"{cfg.name}: the FAST segment launched {fast_launches}, want {want_fast}")
    require(chunked["next_token"] == first, f"{cfg.name}: chunked prefill {chunked} disagrees "
            "with prefill_step")
    return {"segment_fast": fast_launches}


def draft_restore_phase(srv, cfg, prompts) -> dict:
    """The contiguous draft on a pool of 4 lanes, 3 of them prefilled at
    f32, the draft passes at each rung over lanes 0 and 1: afterwards the
    pool (attention rows, latent rows, SSM states and conv histories)
    equals the pre-draft pool bit for bit."""
    import torch

    from repro_torch import models as tm
    from repro_torch.runtime.speculative import register_spec_steps

    dev = torch.device(DEVICE)
    lens = [len(p) for p in prompts[:3]]
    pool = tm.init_caches(cfg, 4, max(lens) + SPEC_K + 1, device=dev)
    for i, p in enumerate(prompts[:3]):
        view = {k: {leaf: v[:, i:i + 1] for leaf, v in node.items()} for k, node in pool.items()}
        tm.prefill_step(srv.params, torch.tensor([p], dtype=torch.int32, device=dev), view, cfg,
                        mode="exact")
    before = _clone_tree(pool)
    draft, _, names = register_spec_steps(srv.engine, cfg, SPEC_K)
    tok = torch.tensor([7, 8, 9, 0], dtype=torch.int32, device=dev)
    pos = torch.tensor(lens + [0], dtype=torch.int32, device=dev)
    mask = torch.tensor([True, True, False, False], device=dev)
    out = {}
    for ri, name in enumerate(names):
        drafts = draft[ri](srv.params, tok, pos, pool, mask)
        out[name] = all(torch.equal(pool[k][leaf], before[k][leaf])
                        for k in pool for leaf in pool[k])
        require(drafts.shape == (4, SPEC_K), f"{cfg.name}: drafts {tuple(drafts.shape)}")
    emit({"phase": "draft_restore", "model": cfg.name, "lanes_drafted": 2,
          "pool_bit_exact_after_draft": out})
    require(all(out.values()), f"{cfg.name}: the contiguous draft did not restore the pool: {out}")
    del pool, before
    return {}


def family_phase(name: str, seed: int, max_len: int, prompt_lens, levels, ttft_lens,
                 n_layers=None, speculative: bool = True) -> dict:
    """One model of slice 10: the mixed workload on the contiguous pool
    with :func:`family_gates` (and the isolation contract), the segment
    steps (:func:`hybrid_segment_phase`) and the contiguous draft's
    restore, then on the same f32 tensors the paged pool (chunked prefill,
    no sharing) and (``speculative``) speculative requests on the paged
    pool, every FAST chunk and pass held to its exact launches; K1's and K2's plain
    versions must never run."""
    import torch

    plain = {}
    undo = _count_plain(plain)
    try:
        rec, srv, prompts, tokens = _serve_model(name, seed, max_len, prompt_lens, levels,
                                                 ttft_lens, n_layers=n_layers)
        cfg = srv.cfg
        family_gates(rec, cfg)
        paths = {"serve": rec["launches"]}
        paths.update(hybrid_segment_phase(srv, cfg, next(p for p in prompts if len(p) == 480),
                                          max_len, 3, seed))
        draft_restore_phase(srv, cfg, prompts)
        params = _release(srv)
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(paged_phases(cfg, params, prompts, tokens, rec, seed, prefix_sharing=False,
                                  max_len=max_len, levels=levels, speculative=speculative))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        undo()
    require(not plain, f"{name}: the K1 / K2 plain versions ran on the card: {plain}")
    return paths


def mamba2_phase(seed: int, strict: bool):
    """mamba2-1.3b at full size (48 SSD layers, d_model 2048, 64 heads of
    64, d_state 128): every projection on K1, no attention, so no K3 and
    no K4; contiguous, paged and speculative (paged pool; the contiguous
    draft's restore is :func:`draft_restore_phase`'s)."""
    return family_phase("mamba2_1_3b", seed, 1024, PROMPT_LENS, LEVELS, (480,))


def jamba_phase(seed: int, strict: bool):
    """jamba-v0.1-52b at full width and JAMBA_LAYERS layers (one period:
    attention, 7 mamba, 4 MLP and 4 MoE of 16 experts top-2) on an
    8192-token pool, with a 4500-token prompt per rung: contiguous and
    paged."""
    return family_phase("jamba_v01_52b", seed, 8192, PROMPT_LENS + (LONG_PROMPT, LONG_PROMPT),
                        LEVELS + ("q16_16", "f32"), (480, LONG_PROMPT), n_layers=JAMBA_LAYERS,
                        speculative=False)


def minicpm3_phase(seed: int, strict: bool):
    """minicpm3-4b at full size (62 MLA layers, 40 heads, q_lora 768,
    kv_lora 256, nope 64 / rope 32 / v 64): K4 at D = 96, Dv = 64 in
    prefill, the absorbed decode; contiguous, paged and speculative (paged
    pool)."""
    return family_phase("minicpm3_4b", seed, 1024, PROMPT_LENS, LEVELS, (480,))


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
# phases 12-15 (slice 11): K4's gradient, training gemma2-2b at full size,
# resume on the card, the modality stubs at full size
# ---------------------------------------------------------------------------

#: K4 gradient cases: (S, D) with GQA 4 heads over 2, bf16, each without
#: and with a window and score softcap
K4_GRAD_S, K4_GRAD_D = (17, 129, 1000), (64, 128, 256)
#: relative bound on ||d - d_ref|| / ||d_ref|| for dq, dk and dv (bf16
#: operands and cotangent; the Function's f32 backward against f64
#: autograd through the plain version)
K4_GRAD_TOL = 1e-2
#: (label, H, KV, D, softcap) of the timed forward + backward at S = 4096:
#: gemma2-2b's training layer (no library: SDPA has no softcap) and a
#: 32 x 128 layer without a cap beside SDPA's forward + backward
K4_GRAD_TIMED = (("gemma2_2b_train", 8, 4, 256, 50.0), ("32x128", 32, 32, 128, None))
TRAIN_SEQ, TRAIN_STEPS = 4096, 3
#: the resume check: gemma2's smoke config, crash at 10, 16 steps
RESUME_CRASH, RESUME_STEPS, RESUME_RTOL = 10, 16, 1e-5
STUB_PROMPT, STUB_DECODES = 1000, 16


def _has_train() -> bool:
    """False only for a --root checkout older than the training slice."""
    from repro_torch.kernels import flashattn

    return hasattr(flashattn, "FlashAttentionFn")


def _rel_err(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30)).item()


def check_flash_grad(gen) -> dict:
    """K4's autograd Function: dq, dk, dv against f64 autograd through
    ``flash_attention_plain`` on the card (K4_GRAD_S x K4_GRAD_D, GQA,
    without and with window and cap, bf16), then forward + backward timed
    at K4_GRAD_TIMED; returns the timed records."""
    import torch

    from repro_torch.kernels.flashattn import flash_attention, flash_attention_plain

    dev = torch.device(DEVICE)
    worst = 0.0
    for s in K4_GRAD_S:
        for d in K4_GRAD_D:
            for window, cap in ((None, None), (s // 3 + 1, 50.0)):
                q, k, v, g = (torch.randn(1, s, h, d, generator=gen).to(dev, torch.bfloat16)
                              for h in (4, 2, 2, 4))
                q, k, v = (t.requires_grad_(True) for t in (q, k, v))
                kw = dict(window=window, softcap=cap)
                before = flash_attention.launches
                got = torch.autograd.grad(flash_attention(q, k, v, **kw), (q, k, v), g)
                require(flash_attention.launches == before + 1,
                        "K4's autograd Function did not launch K4")
                ref_in = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
                want = torch.autograd.grad(flash_attention_plain(*ref_in, **kw), ref_in,
                                           g.double())
                errs = [_rel_err(a, b) for a, b in zip(got, want)]
                case = f"S={s} H=4 KV=2 D={d} bf16 window={window} softcap={cap}"
                require(all(math.isfinite(e) and e <= K4_GRAD_TOL for e in errs),
                        f"K4 gradient {case}: rel errors (dq, dk, dv) {errs} above "
                        f"{K4_GRAD_TOL}")
                worst = max(worst, *errs)
    emit({"phase": "kernels", "kernel": "flash_attention_grad", "cases": len(K4_GRAD_S) *
          len(K4_GRAD_D) * 2, "worst_rel_err": worst,
          "tolerance": f"||d - d_ref|| <= {K4_GRAD_TOL} ||d_ref|| for dq, dk, dv"})

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    S = TRAIN_SEQ
    for label, h, kv, d, cap in K4_GRAD_TIMED:
        q = torch.randn(1, S, h, d, generator=gen).to(dev, torch.bfloat16).requires_grad_(True)
        k = torch.randn(1, S, kv, d, generator=gen).to(dev, torch.bfloat16).requires_grad_(True)
        v = torch.randn(1, S, kv, d, generator=gen).to(dev, torch.bfloat16).requires_grad_(True)
        g = torch.randn(1, S, h, d, generator=gen).to(dev, torch.bfloat16)

        def fwd_bwd(fn=flash_attention):
            return torch.autograd.grad(fn(q, k, v, softcap=cap), (q, k, v), g)

        rec = {"name": "flash_attention_fwd_bwd", "case": f"{label}: B=1 S={S} H={h} KV={kv} "
               f"D={d} bf16 causal softcap={cap}",
               "ms": time_ms(fwd_bwd, iters=5, warmup=2),
               "plain_ms": time_ms(lambda: fwd_bwd(flash_attention_plain), iters=2, warmup=1)}
        if cap is None:
            qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            gt = g.transpose(1, 2).contiguous()
            rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
                sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), gt), iters=5, warmup=2)
            rec["library"] = "torch.nn.functional.scaled_dot_product_attention forward + backward"
        else:
            rec["library_ms"] = None   # SDPA has no score softcap
        pairs = S * (S + 1) // 2
        # forward QK^T and PV, backward dV, dP, dQ, dK: 6 (D + Dv) operations a
        # pair and head; q, k, v, dO read once, out, dq, dk, dv written once
        rec["bound_ms"], rec["bound_by"] = bound_ms(2 * (S * h * 4 * d + S * kv * 4 * d),
                                                    6.0 * h * pairs * 2 * d, "bf16")
        emit({"phase": "kernels", **rec})
        out[label] = rec
        del q, k, v, g
    return out


def train_step_launches(cfg, seq: int, fast: bool) -> dict:
    """Kernel launches of one training step of ``cfg`` at sequence length
    ``seq``, remat on (every period's forward runs twice: once forward,
    once recomputed in the backward; each CE chunk's too):

    * K1: 2 x (4 attention + 3 MLP projections) a layer (FAST only);
    * K4: 2 a layer (the bf16 forward and its recompute, both rungs);
    * K5: 2 a MLP layer (FAST ``psilu``) + 2 a CE chunk of 256 when the
      model has a final softcap (FAST only);
    * K3: 1 (the RoPE tables, once a step, outside the checkpoints; FAST);
    * K2 and the grouped entries: 0 (training keeps the unfused MLP)."""
    k1 = k4 = mlp = 0
    for sp in cfg.period:
        k1 += 4 * (sp.kind == "attn") + 3 * (sp.ffn == "mlp")
        k4 += sp.kind == "attn"
        mlp += sp.ffn == "mlp"
    n = cfg.n_periods
    chunks = -(-seq // 256) if cfg.final_softcap else 0
    f = int(fast)
    return {"qmatmul": f * 2 * n * k1, "flash_attention": 2 * n * k4,
            "universal_unary": f * (2 * n * mlp + 2 * chunks), "cordic_sincos": f,
            "fused_swiglu": 0, **{g: 0 for g in GROUPED}}


TRAIN_FORMULA = ("K1 = 2 x 7 x n_layers (FAST), K4 = 2 x n_layers, K5 = 2 x n_layers + "
                 "2 x ceil(S / 256) (FAST, final softcap), K3 = 1 (FAST), K2 = 0")


def _count_plain_k4(counts: dict):
    """Also count calls of K4's plain version; returns the undo."""
    from repro_torch.kernels.flashattn import flashattn as fa

    orig = fa.flash_attention_plain

    def wrapper(*args, **kw):
        counts["flash_attention_plain"] = counts.get("flash_attention_plain", 0) + 1
        return orig(*args, **kw)

    fa.flash_attention_plain = wrapper
    return lambda: setattr(fa, "flash_attention_plain", orig)


def train_phase(seed: int, strict: bool):
    """gemma2-2b at full size: the Trainer on SyntheticLM, B = 1,
    S = TRAIN_SEQ, TRAIN_STEPS steps at ``q16_16``, ``set_level("f32")``,
    TRAIN_STEPS more, checkpoints off."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models.model import train_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_config("gemma2_2b")
    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    n_steps = 2 * TRAIN_STEPS
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, TrainerConfig(total_steps=n_steps, ckpt_every=0, ckpt_dir=ckdir,
                                             start_mode="q16_16", seed=seed),
                          AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=n_steps),
                          DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=1,
                                     seed=seed),
                          device=dev)
        sync()
        setup_s = time.perf_counter() - t0
        def watched():
            return {"embed": trainer.params["embed"][:8],
                    "wq": trainer.params["periods"]["pos0"]["mixer"]["wq"][0, :8]}

        before = {k: v.detach().clone() for k, v in watched().items()}
        batch0 = {k: torch.from_numpy(v).to(dev) for k, v in trainer.data.batch(0).items()}
        with torch.no_grad():
            loss_f32_step0 = float(train_loss(trainer.params, batch0, cfg, mode="precise")[0])
        del batch0
        steps, paths = [], {}
        plain: dict = {}
        undo = [_count_plain(plain), _count_plain_k4(plain)]
        try:
            for s in range(n_steps):
                level = "q16_16" if s < TRAIN_STEPS else "f32"
                switch_us = trainer.engine.set_level(level) if s == TRAIN_STEPS else None
                _reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                sync()
                t1 = time.perf_counter()
                trainer.tcfg.total_steps, trainer.start_step = s + 1, s
                trainer.run()
                sync()
                dt = time.perf_counter() - t1
                counts = _launch_counts()
                h = trainer.history[-1]
                want = train_step_launches(cfg, TRAIN_SEQ, level == "q16_16")
                got = {k: counts[k] for k in want}
                rec = {"step": s, "level": h["level"], "loss": h["loss"],
                       "grad_norm": h["grad_norm"], "step_s": dt, "tokens_per_s": TRAIN_SEQ / dt,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": got, "want_launches": want, "formula": TRAIN_FORMULA}
                if switch_us is not None:
                    rec["switch_us"] = switch_us
                emit({"phase": "gemma2_2b_train", **rec})
                require(h["level"] == level, f"train step {s} ran at {h['level']}, want {level}")
                require(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
                        f"train step {s}: loss {h['loss']} grad norm {h['grad_norm']}")
                require(got == want, f"train step {s} ({level}) launched {got}, want {want} "
                        f"({TRAIN_FORMULA})")
                steps.append(rec)
                key = f"train_{level}"
                paths[key] = {k: paths.get(key, {}).get(k, 0) + counts[k] for k in counts}
        finally:
            for u in undo:
                u()
        require(not plain, f"training reached plain versions on the card: {plain}")
        changed = {k: not torch.equal(before[k], v) for k, v in watched().items()}
        require(all(changed.values()), f"training left parameters unchanged: {changed}")
        gap = abs(steps[0]["loss"] - loss_f32_step0)
        require(gap < 0.5, f"step 0's q16_16 loss {steps[0]['loss']} and f32 loss "
                f"{loss_f32_step0} differ by {gap} (bound 0.5)")
        rungs = {}
        for lv in ("q16_16", "f32"):
            rs = [r for r in steps if r["level"] == lv]
            warm = rs[1:] or rs
            rungs[lv] = {"step_s": [r["step_s"] for r in rs],
                         "mean_step_s_after_first": sum(r["step_s"] for r in warm) / len(warm),
                         "tokens_per_s_after_first": TRAIN_SEQ * len(warm) /
                         sum(r["step_s"] for r in warm),
                         "peak_mem_gb": max(r["peak_mem_gb"] for r in rs),
                         "launches_per_step": rs[0]["launches"]}
        emit({"phase": "gemma2_2b_train", "config": f"{cfg.name}: {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab}, tied {cfg.tie_embeddings}",
              "batch": 1, "seq": TRAIN_SEQ,
              "setup_s": setup_s,
              "loss_step0": {"q16_16": steps[0]["loss"], "f32": loss_f32_step0, "gap": gap},
              "rungs": rungs})
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def resume_phase(seed: int, strict: bool):
    """gemma2's smoke config on the card: crash at RESUME_CRASH, restart
    from the newest checkpoint, and the losses of steps RESUME_CRASH..15
    equal to an uninterrupted run's within rel RESUME_RTOL.  Run as is;
    only if that fails, again under ``torch.use_deterministic_algorithms``
    (reported)."""
    import tempfile

    import torch

    from repro_torch.configs import smoke
    from repro_torch.runtime import InjectedFailure, Trainer, TrainerConfig

    cfg = smoke("gemma2_2b")
    dev = torch.device(DEVICE)

    def trainer(d, **kw):
        return Trainer(cfg, TrainerConfig(total_steps=RESUME_STEPS, ckpt_every=4, ckpt_dir=d,
                                          seed=seed, **kw), device=dev)

    def attempt():
        with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
            try:
                trainer(a, crash_at_step=RESUME_CRASH).run()
                raise Failure("the injected failure did not fire")
            except InjectedFailure:
                pass
            t2 = trainer(a)
            require(t2.start_step == 8, f"resume started at {t2.start_step}, want 8")
            resumed = {h["step"]: h["loss"] for h in t2.run()["history"]}
            ref = {h["step"]: h["loss"] for h in trainer(b).run()["history"]}
        return {s: (resumed[s], ref[s]) for s in range(RESUME_CRASH, RESUME_STEPS)}

    _reset_launch_counts()
    pairs = attempt()
    deterministic = False
    ok = all(abs(r - w) <= RESUME_RTOL * abs(w) for r, w in pairs.values())
    if not ok:
        deterministic = True
        torch.use_deterministic_algorithms(True)
        try:
            pairs = attempt()
        finally:
            torch.use_deterministic_algorithms(False)
    worst = max(abs(r - w) / abs(w) for r, w in pairs.values())
    emit({"phase": "gemma2_2b_resume", "losses": {s: list(p) for s, p in pairs.items()},
          "worst_rel": worst, "bound_rel": RESUME_RTOL,
          "deterministic_algorithms": deterministic})
    require(worst <= RESUME_RTOL, f"resumed losses differ from the uninterrupted run by "
            f"{worst} (rel bound {RESUME_RTOL})")
    return {"resume": _launch_counts()}


def stub_phase(name: str, seed: int, strict: bool):
    """A modality stub at full size: a STUB_PROMPT-token prefill with
    seeded ``extra_embeds`` (normal, std 0.02) at both rungs, then
    STUB_DECODES greedy decodes; exact launches a pass, finite logits,
    the prefix moving the logits, and without it the text model's logits
    bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import QuantizedWeightCache
    from repro_torch.models.layers import attach_quantized_weights

    cfg = get_config(name)
    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    torch.cuda.reset_peak_memory_stats()
    params = tm.init_params(cfg, seed=seed, device=dev)
    pa = attach_quantized_weights(params, QuantizedWeightCache())
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, STUB_PROMPT))).to(dev)
    extra = torch.from_numpy(rng.normal(0, 0.02, (1, cfg.stub_prefix_len, cfg.d_model))
                             .astype(np.float32)).to(dev)
    text_cfg = dataclasses.replace(cfg, stub_prefix_len=0, modality_stub=None)
    max_len = STUB_PROMPT + STUB_DECODES
    want_pass = fast_pass_launches(cfg)
    paths, rec = {}, {"phase": name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                      "head_dim": cfg.head_dim, "prefix": cfg.stub_prefix_len,
                      "prompt": STUB_PROMPT}
    plain: dict = {}
    undo = _count_plain(plain)
    try:
        for lv, mode in (("q16_16", "fast"), ("f32", "exact")):
            p = pa if mode == "fast" else params
            _reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            logits, caches = tm.prefill_step(p, prompt, tm.init_caches(cfg, 1, max_len,
                                                                        device=dev),
                                             cfg, mode=mode, extra_embeds=extra)
            sync()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            pre = _launch_counts()
            exp = {k: (v if mode == "fast" else 0) for k, v in want_pass.items()}
            got = {k: pre[k] for k in exp}
            require(got == exp and pre["flash_attention"] == cfg.n_layers,
                    f"{name}: a {lv} prefill launched {got}, K4 {pre['flash_attention']}; "
                    f"want {exp}, K4 {cfg.n_layers}")
            total = dict(pre)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            finite = bool(torch.isfinite(logits).all())
            t0 = time.perf_counter()
            for i in range(STUB_DECODES):
                _reset_launch_counts()
                pos = torch.full((1,), STUB_PROMPT + i, dtype=torch.int32, device=dev)
                ld, caches = tm.decode_step(p, tok, pos, caches, cfg, mode=mode)
                dec = _launch_counts()
                got = {k: dec[k] for k in exp}
                require(got == exp and dec["flash_attention"] == 0,
                        f"{name}: a {lv} decode launched {got}, K4 {dec['flash_attention']}")
                total = {k: total[k] + dec[k] for k in total}
                finite &= bool(torch.isfinite(ld).all())
                tok = torch.argmax(ld, dim=-1)[:, None].to(torch.int32)
            sync()
            decode_ms = (time.perf_counter() - t0) * 1e3 / STUB_DECODES
            paths[f"serve_{lv}"] = total
            require(finite, f"{name}: non-finite logits at {lv}")
            text = tm.prefill_step(p, prompt, tm.init_caches(cfg, 1, max_len, device=dev), cfg,
                                   mode=mode)[0]
            plain_text = tm.prefill_step(p, prompt, tm.init_caches(text_cfg, 1, max_len,
                                                                   device=dev),
                                         text_cfg, mode=mode)[0]
            moved = (logits - text).abs().max().item()
            require(torch.equal(text, plain_text),
                    f"{name}: without extra_embeds the {lv} logits differ from the text model's")
            require(moved > 0, f"{name}: extra_embeds did not move the {lv} logits")
            rec[lv] = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
                       "launches_per_prefill": dict(pre),
                       "prefix_moves_logits_by": moved}
            del caches
    finally:
        undo()
    require(not plain, f"{name}: plain versions ran on the card: {plain}")
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(rec)
    del params, pa
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phases 16-17 (slice 12): the compressed data-parallel step, the dry-run
# ---------------------------------------------------------------------------

#: the data-parallel steps of phase 16: (model mode, compress_bits)
DP_STEPS = (("fast", 8), ("fast", 8), ("precise", 8), ("precise", None))
#: the leaves whose compressed mean is held to q 2**e bit for bit
DP_RECORD = ("embed", "periods/pos0/mixer/wq")
#: the production dry-run cells of phase 17 (tests/test_dryrun.py's pair)
DRYRUN_CELLS = (("gemma2_2b", "train_4k"), ("mamba2_1_3b", "decode_32k"))


def _has_dp() -> bool:
    """False only for a --root checkout older than the sharded slice."""
    import importlib.util

    return importlib.util.find_spec("repro_torch.optim.grad_compress") is not None


def _numel_tree(tree) -> int:
    from repro_torch.launch.steps import tree_leaves

    return sum(t.numel() for t in tree_leaves(tree))


def dp_train_phase(seed: int, strict: bool):
    """gemma2-2b at full size, B = 1, S = TRAIN_SEQ, through
    ``make_dp_train_step`` on a one-rank NCCL group and a ("data",) mesh
    of 1: DP_STEPS, each step's loss and grad norm finite, its launches
    exactly ``train_step_launches`` at its rung, no plain version, the
    wire payloads int8 and 2 bytes an element, the group destroyed at the
    end; on step 0 the world-1 identity on DP_RECORD."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state, make_dp_train_step
    from repro_torch.optim.grad_compress import tree_paths

    cfg = get_config("gemma2_2b")
    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    require(not dist.is_initialized(), "a process group stands before the DP phase")
    # one rank, a local store; gloo only for a CPU rehearsal
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo", store=dist.HashStore(),
                            rank=0, world_size=1)
    paths, plain = {}, {}
    undo = [_count_plain(plain), _count_plain_k4(plain)]
    try:
        mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("data",))
        t0 = time.perf_counter()
        params = init_params(cfg, seed=seed, device=dev)
        for _, t in tree_paths(params):
            t.requires_grad_(True)
        opt = init_opt_state(params)
        res = _zeros_tree(params)
        n_elem = _numel_tree(params)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=1,
                                      seed=seed))
        ocfg = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=len(DP_STEPS))
        sync()
        setup_s = time.perf_counter() - t0
        recs = []
        for s, (mode, bits) in enumerate(DP_STEPS):
            step = make_dp_train_step(cfg, ocfg, mesh, compress_bits=bits, mode=mode,
                                      record=DP_RECORD if s == 0 else ())
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(s).items()}
            _reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            sync()
            t1 = time.perf_counter()
            params, opt, res, m = step(params, opt, res, batch)
            sync()
            dt = time.perf_counter() - t1
            counts = _launch_counts()
            want = train_step_launches(cfg, TRAIN_SEQ, mode == "fast")
            got = {k: counts[k] for k in want}
            st = step.stats
            rec = {"step": s, "mode": mode, "compress_bits": bits, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]), "step_s": dt,
                   "tokens_per_s": TRAIN_SEQ / dt, "compress_ms": st["compress_s"] * 1e3,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": got, "want_launches": want}
            if bits is not None:
                rec.update(wire_bytes=st["wire_bytes"], padded_numel=st["padded_numel"],
                           f32_ring_bytes=8 * n_elem,
                           payload_dtypes=sorted(st["payload_dtypes"]))
                require(rec["payload_dtypes"] == ["torch.int8"],
                        f"DP step {s}: wire payloads {rec['payload_dtypes']}, want int8")
                require(st["padded_numel"] == n_elem and st["wire_bytes"] == 2 * n_elem,
                        f"DP step {s}: wire bytes {st['wire_bytes']} for {n_elem} elements "
                        "(want 2 a padded element)")
            if s == 0:
                ident = {}
                for path, r in st.pop("records").items():
                    deq = r["q"].to(torch.float32) * torch.exp2(r["e"].to(torch.float32))
                    ident[path] = {"mean": bool(torch.equal(r["mean"], deq)),
                                   "residual": bool(torch.equal(r["res"], r["g32"] - deq)),
                                   "numel": r["q"].numel(), "exponent": int(r["e"])}
                    del r, deq
                rec["world1_identity"] = ident
                require(set(ident) == set(DP_RECORD) and all(
                    v["mean"] and v["residual"] for v in ident.values()),
                        f"world-1 compressed mean is not q 2**e bit for bit: {ident}")
            emit({"phase": "gemma2_2b_dp_train", **rec})
            require(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
                    f"DP step {s}: loss {rec['loss']} grad norm {rec['grad_norm']}")
            require(got == want, f"DP step {s} ({mode}) launched {got}, want {want} "
                    f"({TRAIN_FORMULA})")
            key = f"dp_train_{mode}" + ("" if bits else "_f32_allreduce")
            paths[key] = {k: paths.get(key, {}).get(k, 0) + counts[k] for k in counts}
            recs.append(rec)
            del step, batch, m
        require(not plain, f"the DP step reached plain versions on the card: {plain}")
        emit({"phase": "gemma2_2b_dp_train", "config": f"{cfg.name}: {cfg.n_layers} layers, "
              f"{n_elem} parameters", "batch": 1, "seq": TRAIN_SEQ, "setup_s": setup_s,
              "world_size": dist.get_world_size(), "backend": dist.get_backend(),
              "step_s": {f"{r['mode']}/{r['compress_bits']}": r["step_s"] for r in recs},
              "compress_ms": {f"{r['mode']}/{r['compress_bits']}": r["compress_ms"]
                              for r in recs},
              "peak_mem_gb": max(r["peak_mem_gb"] for r in recs[1:]),
              "peak_mem_gb_step0_with_records": recs[0]["peak_mem_gb"]})
        del params, opt, res
    finally:
        for u in undo:
            u()
        if dist.is_initialized():
            dist.destroy_process_group()
    require(not dist.is_initialized(), "the DP phase left its process group standing")
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _zeros_tree(tree):
    import torch

    return {k: _zeros_tree(v) if isinstance(v, dict) else torch.zeros(
        v.shape, dtype=torch.float32, device=v.device) for k, v in tree.items()}


def _rule_arg_bytes(arch: str, shape_id: str, sizes: dict) -> int:
    """Per-device bytes of a cell's arguments from the rules alone: each
    leaf's global shape over the mesh axes its resolved mapping names."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import batch_pspec, train_rules
    from repro_torch.launch import steps
    from repro_torch.models import init_caches, param_specs
    from repro_torch.optim.adamw import opt_state_specs

    cfg = get_config(arch)
    cell = steps.SHAPES[shape_id]

    def local(shape, spec):
        n = 1
        for dim, entry in zip(shape, spec):
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            n *= dim // math.prod(sizes[a] for a in names)
        return n

    total = 0
    specs = list(steps.tree_leaves(param_specs(cfg)))
    if cell.kind == "train":
        rs = train_rules(sizes)
        specs += list(steps.tree_leaves(opt_state_specs(param_specs(cfg))))
        for sp in specs:
            total += local(sp.shape, rs.resolve(sp.axes, sp.shape)) * sp.dtype.itemsize
        return total + 2 * 4 * local((cell.batch, cell.seq), batch_pspec(rs, cell.batch))
    rs = steps._serve_ruleset(cfg, sizes)
    for sp in specs:
        total += local(sp.shape, rs.resolve(sp.axes, sp.shape)) * 2          # bf16
    caches = init_caches(cfg, cell.batch, cell.seq, device="meta")
    sh = steps._cache_shardings(caches, cfg, rs, cell.batch)
    for c, s in zip(steps.tree_leaves(caches), steps.tree_leaves(sh)):
        total += local(c.shape, s.spec) * c.element_size()
    return (total + 4 * local((cell.batch, 1), batch_pspec(rs, cell.batch))
            + 4 * local((cell.batch,), batch_pspec(rs, cell.batch, extra_dims=0)))


def dryrun_phase(seed: int, strict: bool):
    """The production dry-run (``launch.dryrun.run_cell``) of DRYRUN_CELLS
    on the (16, 16) ``single`` mesh at ``precise``, on a fake process
    group of 256 ranks (after phase 16's group is gone): status ``ok``,
    FLOPs and collective bytes above zero, the per-device argument bytes
    equal to the rules' local shards.  Traced on meta tensors with the
    H100 constants: estimates, not measurements."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_shape

    require(not dist.is_initialized(), "a process group stands before the dry-run")
    sizes = mesh_shape("single")
    for arch, shape_id in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape_id, "single", "precise", verbose=False)
        wall = time.perf_counter() - t0
        require(rec["status"] == "ok", f"dry-run {arch} x {shape_id}: {rec}")
        hc, mem = rec["hlo_costs"], rec["memory"]
        want_args = _rule_arg_bytes(arch, shape_id, sizes)
        emit({"phase": "dryrun", "cell": f"{arch} x {shape_id} x single (16, 16) precise",
              "estimate": "traced on meta tensors, NVIDIA H100 SXM data-sheet constants; "
                          "not a measurement",
              "build_s": rec["lower_s"], "trace_s": rec["compile_s"], "wall_s": wall,
              "memory_per_device": mem, "rule_argument_bytes": want_args,
              "flops_per_device": hc["flops"], "bytes_per_device": hc["bytes"],
              "collective_bytes": hc["collective_bytes"],
              "collective_counts": hc["collective_counts"],
              "kernel_calls": hc["kernel_calls"],
              "roofline": {k: rec["roofline"][k] for k in (
                  "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
                  "useful_flop_ratio", "roofline_fraction")},
              "dropped_rules": len(rec["dropped_rules"])})
        require(hc["flops"] > 0 and hc["total_collective_bytes"] > 0,
                f"dry-run {arch} x {shape_id}: flops {hc['flops']}, collective "
                f"{hc['total_collective_bytes']}")
        require(mem["argument_size_in_bytes"] == want_args,
                f"dry-run {arch} x {shape_id}: argument bytes {mem['argument_size_in_bytes']} "
                f"per device, the rules give {want_args}")
    require(not dist.is_initialized(), "the dry-run left its process group standing")
    return {}


REPLACES = {
    "qmatmul": ("src/repro_torch/kernels/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul/qmatmul.py:50"),
    "fused_swiglu": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                     "src/repro/kernels/fused_mlp/fused_mlp.py:115"),
    "cordic_sincos": ("src/repro_torch/kernels/csrc/cordic.cu",
                      "src/repro/kernels/cordic/cordic.py:37"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flashattn.cu",
                        "src/repro/kernels/flashattn/flashattn.py:37"),
    "universal_unary": ("src/repro_torch/kernels/csrc/universal.cu",
                        "src/repro/kernels/cordic/universal.py:51"),
    "atan2_q16": ("src/repro_torch/kernels/csrc/universal.cu",
                  "src/repro/kernels/cordic/universal.py:55"),
    "div_q16": ("src/repro_torch/kernels/csrc/universal.cu",
                "src/repro/kernels/cordic/universal.py:59"),
    # the float entries: the same TPU kernels, whose jitted float boundary
    # they take in
    "atan2_f32": ("src/repro_torch/kernels/csrc/universal.cu",
                  "src/repro/kernels/cordic/universal.py:55"),
    "atan2_24_f32": ("src/repro_torch/kernels/csrc/universal.cu",
                     "src/repro/kernels/cordic/universal.py:55"),
    "div_f32": ("src/repro_torch/kernels/csrc/universal.cu",
                "src/repro/kernels/cordic/universal.py:59"),
    # the engine's C3, which the reference computes in plain JAX
    "deferred_matmul": ("src/repro_torch/kernels/csrc/linalg.cu",
                        "src/repro/core/linalg.py::qmatmul_deferred (plain JAX, not a Pallas "
                        "kernel)"),
    # the MoE experts' products, XLA batched dots in the reference
    "fused_swiglu_grouped": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                             "src/repro/models/moe.py:64 (_fused_expert_mlp: XLA batched dots "
                             "and swiglu_body_q16, not a Pallas kernel)"),
    "qmatmul_grouped": ("src/repro_torch/kernels/csrc/qmatmul.cu",
                        "src/repro/models/moe.py:64 (_fused_expert_mlp: an XLA batched dot, "
                        "not a Pallas kernel)"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels", "engine", "moe"), default=None,
                    help="stop after the kernel phase, or after the engine phase; moe: the "
                         "build, then only the MoE models' serving phases (granite, mixtral, "
                         "jamba), for end-to-end A/B runs with --root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=None,
                    help="build and check the port of another checkout with this script's "
                         "cases and timing (old/new comparisons in one call); the "
                         "SASS checks then are not made")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root) if args.root else ROOT
    sys.path.insert(0, os.path.join(root, "src"))

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

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    PEAK_OPS["int32"] = N_SMS * INT32_LANES * clock_mhz * 1e6
    global SPIN_CLOCK_HZ
    SPIN_CLOCK_HZ = clock_mhz * 1e6
    t0 = time.perf_counter()
    build = compat.build_kernels()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in compat.KERNEL_SOURCES:
        log = compat.BUILD_DIR / f"{name}.log"
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "max_sm_clock_mhz": clock_mhz,
          "int32_ops_per_s": PEAK_OPS["int32"], "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": round(build_s, 3),
          "build_per_source_s": {k: round(v, 3) for k, v in build.items()}, "ptxas": ptxas})

    if root == ROOT:
        sass_phase(compat)
    else:
        emit({"phase": "device", "root": root, "tensor_core_sass": "not checked"})
    # reported for another checkout too, checked only for this one
    cordic_sass(compat, str(compat.CSRC_DIR), strict=root == ROOT)

    gen = torch.Generator().manual_seed(args.seed)
    torch.cuda.reset_peak_memory_stats()
    records = {}
    if args.only != "moe":
        records = check_kernels(gen, strict=root == ROOT)
        if _has_train():
            check_flash_grad(gen)
        else:
            require(root != ROOT, "K4's autograd Function (the training slice) is missing")
        emit({"phase": "kernels", "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "elapsed_s": time.perf_counter() - t_start})
    by_path, by_entry = {}, {}
    if args.only == "moe":
        for model, phase in (("granite_moe_3b_a800m", granite_phase),
                             ("mixtral_8x22b", mixtral_phase), ("jamba_v01_52b", jamba_phase)):
            gc.collect()
            torch.cuda.empty_cache()
            phase(args.seed, strict=root == ROOT)
            emit({"phase": f"{model} done", "elapsed_s": time.perf_counter() - t_start})
        print(nvidia_smi(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.only != "kernels":
        gc.collect()
        torch.cuda.empty_cache()
        by_path["engine"], by_entry = engine_phase(args.seed, strict=root == ROOT)
        if _has_c3():
            gc.collect()
            torch.cuda.empty_cache()
            by_path["engine_matmul"] = engine_matmul_phase(args.seed)
        emit({"phase": "engine done", "elapsed_s": time.perf_counter() - t_start})
    if args.only is None:
        models = [("deepseek_7b", deepseek_phase), ("gemma2_2b", gemma2_phase)]
        if _has_moe():
            models += [("granite_moe_3b_a800m", granite_phase), ("mixtral_8x22b", mixtral_phase),
                       ("command_r_35b", command_r_phase)]
        else:
            require(root != ROOT, "the MoE slice's configs are missing")
        if _has_ssm():
            models += [("mamba2_1_3b", mamba2_phase), ("jamba_v01_52b", jamba_phase),
                       ("minicpm3_4b", minicpm3_phase)]
        else:
            require(root != ROOT, "the SSM / MLA slice's configs are missing")
        if _has_train():
            models += [("gemma2_2b", train_phase), ("gemma2_2b", resume_phase),
                       ("phi3_vision_4_2b", lambda s, strict: stub_phase("phi3_vision_4_2b", s,
                                                                         strict)),
                       ("musicgen_large", lambda s, strict: stub_phase("musicgen_large", s,
                                                                       strict))]
        if _has_dp():
            models += [("gemma2_2b", dp_train_phase), ("dryrun", dryrun_phase)]
        else:
            require(root != ROOT, "the sharded slice's modules are missing")
        for model, phase in models:
            gc.collect()
            torch.cuda.empty_cache()
            paths = phase(args.seed, strict=root == ROOT)
            for key, counts in paths.items():
                by_path[model if key == "serve" else f"{model}_{key}"] = counts
            emit({"phase": f"{model} done", "elapsed_s": time.perf_counter() - t_start})

    kernels = []
    for name in KERNELS:
        if name not in records and root != ROOT:
            continue  # another checkout without the float entries
        src, rep = REPLACES[name]
        r = records[name]
        paths = {p: c[name] for p, c in by_path.items() if name in c}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(paths.values()) if by_path else None, "launches_by_path": paths,
            **({"engine_launches_by_entry": {fn.__name__: by_entry.get(fn.__name__, 0)
                                             for fn in _wrappers()[name]}}
               if name in ("atan2_q16", "div_q16") and by_entry else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "case": r["case"],
        })
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
