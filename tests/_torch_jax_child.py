"""Child process for the port's model tests: runs the JAX reference
model with XLA's excess-precision optimisation switched off (the flag
must be set before JAX starts, hence a process of its own), so every
bf16 cast of the FAST rung rounds where the source says it does.

Usage: XLA_FLAGS=--xla_allow_excess_precision=false \
           python tests/_torch_jax_child.py OUT.npz \
               [ARCH [model|segment|spec|paged|moe|serve|qkv|ssm|mla|hybrid|train]]

ARCH is ``deepseek_7b`` (default; tests/test_torch_model.py),
``gemma2_2b`` (tests/test_torch_gemma2.py) or, from the MoE slice,
``command_r_35b``, ``granite_moe_3b_a800m`` or ``mixtral_8x22b``
(tests/test_torch_families.py).  Writes the smoke model's parameters and
int8 weight payloads, and for each of the ``exact`` and ``fast`` modes
the prefill logits and caches, then the decode steps:

* deepseek_7b: one decode of token 12 at position 11;
* the others: DECODE_STEPS greedy decode steps, each feeding the argmax
  of the step before (``{mode}/tokens``), so gemma2's and mixtral's
  8-row sliding-window buffers wrap; logits of every step and the caches
  after the last.

With ``moe`` (tests/test_torch_moe.py, tests/test_torch_families.py) it
writes those records and also layer 0's ``moe_forward`` on MOE_X (a zero
row included: uniform routing, tied probabilities) at every mode
(``moe/{mode}/out``, ``moe/{mode}/aux``; FAST modes on the attached
int8 weights), and the same on MOE_DROP_X at capacity factor MOE_DROP_CF,
where tokens are dropped (``moe/drop/x``, ``moe/drop/{mode}/out``,
``moe/drop/{mode}/aux``).  With ``serve`` (tests/test_torch_families.py) it writes
instead the tokens of the reference test's static server
(``serve/batched``: ``BatchedServer`` at ``f32``, one slot,
BATCHED_PROMPT, 4 new tokens) and of PAGED_WORKLOAD through a paged
``ContinuousBatchingServer`` (``serve/paged/tokens{i}``).  With ``qkv``
(tests/test_torch_quantized_kv.py) it writes instead the reference's
int8-KV test run (``qkv/{bf16,int8}/logits``: prefill and 4
teacher-forced decodes at the default mode, parameters from
``PRNGKey(7)``) and, on the FAST rung with attached weights, an int8
cache after a two-lane prefill of SEG_PROMPT (``int8/c1``), one decode
(``int8/c2``), a segment of SEG_TOKENS from ``c1`` (``int8/seg``) and
its commit with keep_count 3, lane 1 inactive (``int8/commit``).

With ``ssm`` (mamba2_1_3b), ``mla`` (minicpm3_4b) or ``hybrid``
(jamba_v01_52b; tests/test_torch_ssm.py, tests/test_torch_mla.py,
tests/test_torch_hybrid_serving.py) it writes the model records above
and the static server's tokens (``serve/batched``), and with ``ssm`` and
``mla`` also the ``segment`` records below and layer 0's mixer
(``ssm_forward`` / ``mla_forward``, the attached int8 weights) at every
mode (MLA_MODES for ``mla``) on seeded inputs: a two-lane prefill of LAYER_X from a zero cache,
one decode step of LAYER_X1 from that cache and a segment of LAYER_XS
from it (``layer/{mode}/{prefill,decode,segment}/...``: the output and
the cache after, the SSM segment's ``seg_aux`` too), and for ``ssm``
the five input projections of LAYER_X (``layer/{mode}/proj/...``) and
``_ssd_chunked`` / ``_ssd_segment`` on SSD_SHAPE inputs (``ssd/...``).

With ``segment`` (tests/test_torch_segment.py) it writes instead an
exact-rung two-lane prefill of SEG_PROMPT (``c1/...``), and from that
cache, per mode, one ``segment_step`` of SEG_TOKENS at positions
11..15 (``{mode}/seg/logits``, ``{mode}/seg/after/...``; gemma2's 8-row
buffers wrap inside it), the same segment with lane 1 masked
(``{mode}/masked/...``), and ``commit_segment`` of the segment for
keep_count 1..5 on both lanes (``{mode}/commit{k}/...``) and for
keep_count 3 with lane 1 inactive (``{mode}/commit_inactive/...``).

With ``spec`` (tests/test_torch_speculative.py) it writes instead
``vanilla_greedy_reference``'s tokens for the prompts of SPEC_SEEDS
(``spec/vanilla``, SPEC_MAX_NEW each) and, per draft rung, the
speculative tokens and per-round trace of ``LadderSpeculativeDecoder``
(k = SPEC_K) on the prompts of seed 0 (``spec/{rung}/tokens``,
``spec/{rung}/{drafts,preds,n_commit,active}`` stacked by round).  With
``paged`` (tests/test_torch_paged_serving.py) it writes the tokens a
paged ``ContinuousBatchingServer`` gives PAGED_WORKLOAD in one mixed
batch (``paged/tokens{i}``).  Both use the unquantized parameters
(``param/...`` without the ``_q`` payloads), which the servers quantize
themselves.

With ``train`` (tests/test_torch_train.py, tests/test_torch_stubs.py)
ARCH is a comma list of archs; for each it writes the parameters of
``init_params(PRNGKey(0))`` (``{arch}/param/...``), the batch of
``tests/test_arch_smoke.py::make_batch`` (``{arch}/batch/...``) and, at
every mode of TRAIN_MODES, ``jax.value_and_grad`` of ``train_loss``: the
loss, the metrics and every gradient leaf
(``{arch}/train/{mode}/{loss,metrics/...,grad/...}``).  A modality stub
also gets the serving records of STUB_MODES on its attached weights:
``prefill_step`` of the batch's tokens with and without the batch's
``extra_embeds`` and one decode after the first
(``{arch}/stub/{mode}/{logits,logits_text,c1/...,logits_decode,c2/...}``).

With ``dp`` (tests/test_torch_grad_compress.py; ARCH gemma2_2b; the run
gets ``--xla_force_host_platform_device_count=8``) it writes the
reference's ``compressed_mean`` on an 8-device ``data`` mesh with
tests/test_grad_compress.py's inputs (``gc/g``: ``default_rng(0)``,
GC_SHAPE, one (64, 33) gradient a device), two rounds of error feedback
(``gc/mean1``, ``gc/res1``, ``gc/mean2``, ``gc/res2``, stacked by
device) and the exact ``pmean`` (``gc/exact``); then, on a 2-device
mesh, ``make_dp_train_step`` of the smoke model at ``"precise"`` for
every ``compress_bits`` of DP_BITS, one step each from the parameters of
``init_params(PRNGKey(0))`` (``dp/param/...``) on DP_BATCH rows of
``make_batch`` (``dp/batch/...``): the loss, the grad norm and the
parameters and device 0's residuals after the step
(``dp/{bits}/{loss,grad_norm,param/...,res/...}``, ``bits`` 8 or
``none``).

The ``spec`` and ``paged`` runs are shared by their two test modules:
:func:`start_shared` starts, once per test session (across xdist
workers too), every run that a collected module needs, and
:func:`wait_shared` waits for one of them.  The child writes its file
whole (a rename) or, when it fails, ``OUT``'s ``.err`` beside it.
"""

import atexit
import os
import subprocess
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke  # noqa: E402
from repro.core.quantization import QuantizedWeightCache  # noqa: E402
from repro.models import (  # noqa: E402
    commit_segment,
    decode_step,
    init_caches,
    init_params,
    prefill_step,
    segment_step,
)
from repro.models.layers import attach_quantized_weights  # noqa: E402

TOKENS = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]], np.int32)
NEXT = np.array([[12]], np.int32)
DECODE_STEPS = 6
SEG_PROMPT = np.stack([TOKENS[0], TOKENS[0] + 20]).astype(np.int32)
SEG_TOKENS = np.array([[12, 13, 14, 15, 16], [32, 33, 34, 35, 36]], np.int32)
SEG_POSITIONS = np.tile(np.arange(11, 16, dtype=np.int32), (2, 1))
SPEC_K = 3
SPEC_MAX_LEN = 64
SPEC_MAX_NEW = 12
SPEC_SEEDS = (0, 1)
#: moe_forward's input (B, S, d_model of the smoke configs); row (1, 0) is zero
MOE_X_SHAPE = (2, 12, 64)
MOE_MODES = ("exact", "precise", "fast", "fast8")
#: the capacity-drop records: 24 tokens a row at capacity factor 0.5 give
#: C = 8 a smoke expert (4 experts, top-2: 48 picks a row into 32 places),
#: so every row drops picks
MOE_DROP_X_SHAPE = (2, 24, 64)
MOE_DROP_CF = 0.5
BATCHED_PROMPT = list(range(2, 12))
#: the int8-KV test: batch, prompt length, teacher-forced decode steps
QKV_B, QKV_S, QKV_STEPS = 2, 24, 4
#: (prompt, max_new, level) of the paged server's mixed batch (2 slots)
PAGED_WORKLOAD = (
    ([1, 2, 3, 4, 5, 6], 6, "f32"),
    ([9, 8, 7, 6], 6, "q16_16"),
    ([5, 5, 5, 2, 2, 2, 7, 7, 1], 4, "q16_16"),
    ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 5, "f32"),
)
PAGED_MAX_LEN = 32
PAGED_PAGE_SIZE = 4
#: layer-level inputs of the ``ssm`` / ``mla`` records: (B, S, d_model)
LAYER_X_SHAPE = (2, 12, 64)
LAYER_SEG = 4
LAYER_MODES = ("exact", "precise", "fast", "fast8")
#: the ``mla`` layer records' modes: a FAST compile of the lone MLA layer
#: takes ~12 s of the CPU (the model records hold the FAST rung)
MLA_MODES = ("exact", "precise")
#: (B, S, heads, head_dim, d_state) of the ``ssd`` records
SSD_SHAPE = (2, 32, 3, 5, 7)
SSD_CHUNK = 8
#: the ``dp`` records: per-device gradients of the compressed mean, the
#: data-parallel step's batch (B, S), its devices, optimizer and bits
GC_SHAPE = (8, 64, 33)
DP_BATCH = (4, 32)
DP_DEVICES = 2
DP_OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10}
DP_BITS = (8, None)
#: extra XLA flags of a run by its mode
RUN_XLA_FLAGS = {"dp": " --xla_force_host_platform_device_count=8"}
#: the ``train`` records' modes per arch (the precise rung for all)
TRAIN_MODES = {"deepseek_7b": ("precise", "fast"), "granite_moe_3b_a800m": ("precise", "fast"),
               "mamba2_1_3b": ("precise", "fast")}
STUB_MODES = ("exact", "fast")
#: the ``train`` runs: four children, about equal in compile time
TRAIN_GROUPS = ("deepseek_7b,gemma2_2b,phi3_vision_4_2b",
                "granite_moe_3b_a800m,mixtral_8x22b,musicgen_large",
                "mamba2_1_3b,minicpm3_4b,command_r_35b",
                "jamba_v01_52b")
#: (arch, mode) -> the test module (or modules) that read the run
SHARED_RUNS = {
    **{(group, "train"): ("test_torch_train.py", "test_torch_stubs.py")
       for group in TRAIN_GROUPS},
    ("mamba2_1_3b", "ssm"): ("test_torch_ssm.py", "test_torch_hybrid_serving.py"),
    ("minicpm3_4b", "mla"): ("test_torch_mla.py", "test_torch_hybrid_serving.py"),
    ("jamba_v01_52b", "hybrid"): "test_torch_hybrid_serving.py",
    ("deepseek_7b", "paged"): "test_torch_paged_serving.py",
    ("deepseek_7b", "spec"): "test_torch_speculative.py",
    ("gemma2_2b", "spec"): "test_torch_speculative.py",
    ("granite_moe_3b_a800m", "moe"): "test_torch_moe.py",
    ("mixtral_8x22b", "moe"): "test_torch_moe.py",
    ("mixtral_8x22b", "serve"): "test_torch_families.py",
    ("command_r_35b", "model"): "test_torch_families.py",
    ("deepseek_7b", "qkv"): "test_torch_quantized_kv.py",
    ("gemma2_2b", "qkv"): "test_torch_quantized_kv.py",
    ("mixtral_8x22b", "qkv"): "test_torch_quantized_kv.py",
    ("gemma2_2b", "dp"): "test_torch_grad_compress.py",
}
_STARTED = {}


def _save(flat, key, leaves):
    for k, v in leaves.items():
        flat[f"{key}/{k}"] = np.asarray(v)


def _save_tree(flat, key, tree):
    for pos in tree:
        _save(flat, f"{key}/{pos}", tree[pos])


def segments(flat, cfg, pa):
    """The segment-step records of the module docstring."""
    S = SEG_TOKENS.shape[1]
    _, c1 = jax.jit(lambda p, t, c: prefill_step(p, t, c, cfg, mode="exact"))(
        pa, jnp.asarray(SEG_PROMPT), init_caches(cfg, 2, 32, dtype=jnp.float32))
    _save_tree(flat, "c1", c1)
    commit = jax.jit(lambda b, a, x, kp, kc, act: commit_segment(
        b, a, x, cfg, keep_pos=kp, keep_count=kc, active=act))
    toks, poss = jnp.asarray(SEG_TOKENS), jnp.asarray(SEG_POSITIONS)
    for mode in ("exact", "fast"):
        seg = jax.jit(lambda p, t, q, c, m: segment_step(p, t, q, c, cfg, mode=mode, lane_mask=m))
        logits, after, aux = seg(pa, toks, poss, c1, jnp.ones((2,), bool))
        flat[f"{mode}/seg/logits"] = np.asarray(logits)
        _save_tree(flat, f"{mode}/seg/after", after)
        m_logits, m_after, _ = seg(pa, toks, poss, c1, jnp.asarray([True, False]))
        flat[f"{mode}/masked/logits"] = np.asarray(m_logits)
        _save_tree(flat, f"{mode}/masked/after", m_after)
        for k in range(1, S + 1):
            kc = jnp.full((2,), k, jnp.int32)
            merged = commit(c1, after, aux, poss[:, k - 1], kc, jnp.ones((2,), bool))
            _save_tree(flat, f"{mode}/commit{k}", merged)
        merged = commit(c1, after, aux, poss[:, 2], jnp.full((2,), 3, jnp.int32),
                        jnp.asarray([True, False]))
        _save_tree(flat, f"{mode}/commit_inactive", merged)


def _unrolled_draft(dec, cfg):
    """``dec._draft`` with its ``lax.scan`` unrolled: the same k jitted
    ``decode_step`` calls of the scan body, whose cache writes are
    dropped.  XLA's CPU compile of gemma2's scanned FAST draft inside the
    rung switch does not finish in minutes; one decode step compiles in
    seconds."""
    from repro.models import decode_step
    from repro.runtime.speculative import SPEC_DRAFT_LEVELS

    steps = [jax.jit(lambda p, t, q, c, m, mode=mode: decode_step(
        p, t[:, None], q, c, cfg, mode=mode, lane_mask=m)) for _, mode in SPEC_DRAFT_LEVELS]

    def draft(li, params, tok, pos, caches, mask):
        drafts = []
        for _ in range(dec.scfg.k):
            logits, caches = steps[int(li)](params, tok, pos, caches, mask)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            pos = pos + 1
            drafts.append(tok)
        return jnp.stack(drafts, axis=1)
    return draft


def speculative(flat, cfg, params):
    """The ``spec`` records of the module docstring (gemma2_2b drafts
    through :func:`_unrolled_draft`)."""
    from repro.runtime.speculative import (
        LadderSpeculativeDecoder,
        SpeculativeConfig,
        vanilla_greedy_reference,
    )
    from spec_harness import make_prompts

    prompts = [p for seed in SPEC_SEEDS for p in make_prompts(cfg.vocab, seed)]
    flat["spec/vanilla"] = np.asarray(
        vanilla_greedy_reference(cfg, params, prompts, SPEC_MAX_NEW, SPEC_MAX_LEN), np.int32)
    dec = LadderSpeculativeDecoder(cfg, params, SpeculativeConfig(
        k=SPEC_K, max_len=SPEC_MAX_LEN, collect_trace=True))
    if any(spec.window for spec in cfg.period):
        dec._draft = _unrolled_draft(dec, cfg)
    for rung in ("q8_8", "q16_16"):
        start = len(dec.trace)
        toks = dec.generate(make_prompts(cfg.vocab, SPEC_SEEDS[0]), max_new=SPEC_MAX_NEW,
                            draft_level=rung)
        flat[f"spec/{rung}/tokens"] = np.asarray(toks, np.int32)
        for key in ("drafts", "preds", "n_commit", "active"):
            flat[f"spec/{rung}/{key}"] = np.stack([r[key] for r in dec.trace[start:]])


def paged(flat, cfg, params, key="paged/tokens"):
    """The ``paged`` records of the module docstring."""
    from repro.runtime.config import ServingConfig
    from repro.runtime.scheduler import Request
    from repro.runtime.serve import ContinuousBatchingServer

    srv = ContinuousBatchingServer(cfg, params, ServingConfig(
        n_slots=2, max_len=PAGED_MAX_LEN, cache="paged", page_size=PAGED_PAGE_SIZE))
    fins = srv.serve([Request(rid=i, prompt=list(p), max_new=n, level=lv)
                      for i, (p, n, lv) in enumerate(PAGED_WORKLOAD)])
    for i, fin in fins.items():
        flat[f"{key}{i}"] = np.asarray(fin.tokens, np.int32)


def moe(flat, cfg, params, pa):
    """The ``moe`` records of the module docstring."""
    import dataclasses

    from repro.models.moe import moe_forward

    x = np.random.default_rng(5).normal(size=MOE_X_SHAPE).astype(np.float32)
    x[1, 0] = 0.0
    xd = np.random.default_rng(6).normal(size=MOE_DROP_X_SHAPE).astype(np.float32)
    drop = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_DROP_CF))
    for key, c, v in (("moe", cfg, x), ("moe/drop", drop, xd)):
        flat[f"{key}/x"] = v
        for mode in MOE_MODES:
            ffn = jax.tree.map(lambda a: a[0], (params if mode in ("exact", "precise") else pa)
                               ["periods"]["pos0"]["ffn"])
            dt = jnp.float32 if mode == "exact" else jnp.bfloat16
            y, aux = jax.jit(lambda p, u, m=mode, c=c: moe_forward(p, u, c, m))(
                ffn, jnp.asarray(v, dt))
            flat[f"{key}/{mode}/out"] = np.asarray(y.astype(jnp.float32))
            flat[f"{key}/{mode}/aux"] = np.asarray(aux)


def layer_inputs():
    """(LAYER_X, LAYER_X1, LAYER_XS) from seed 9."""
    rng = np.random.default_rng(9)
    B, S, d = LAYER_X_SHAPE
    return tuple(rng.normal(size=(B, n, d)).astype(np.float32) for n in (S, 1, LAYER_SEG))


def ssd_inputs():
    """(x, dt, A, B, C, state0) of SSD_SHAPE from seed 10, the reference
    test's ranges."""
    rng = np.random.default_rng(10)
    Bb, S, nh, hd, ds = SSD_SHAPE
    return (rng.normal(0, 1, (Bb, S, nh, hd)).astype(np.float32),
            rng.uniform(0.01, 0.2, (Bb, S, nh)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32),
            rng.normal(0, 1, (Bb, S, ds)).astype(np.float32),
            rng.normal(0, 1, (Bb, S, ds)).astype(np.float32),
            rng.normal(0, 1, (Bb, nh, ds, hd)).astype(np.float32))


def mixer_layer(flat, cfg, pa, kind):
    """The ``layer/...`` (and for ``ssm`` the ``ssd/...``) records of the
    module docstring."""
    from repro.models import attention, ssm
    from repro.models.layers import pdot, rms_norm

    p0 = jax.tree.map(lambda a: a[0], pa["periods"]["pos0"]["mixer"])
    xs = layer_inputs()
    B, S, _ = LAYER_X_SHAPE
    pos = [jnp.broadcast_to(jnp.arange(a, b, dtype=jnp.int32)[None], (B, b - a))
           for a, b in ((0, S), (S, S + 1), (S, S + LAYER_SEG))]
    for mode in (LAYER_MODES if kind == "ssm" else MLA_MODES):
        dt = jnp.float32 if mode == "exact" else jnp.bfloat16
        x, x1, xseg = (jnp.asarray(v, dt) for v in xs)
        if kind == "ssm":
            def fwd(p, c, u, q, prefill, m=mode):
                aux = {}
                out, c = ssm.ssm_forward(p, u, cfg, mode=m, cache=c, prefill=prefill,
                                         seg_aux=aux)
                return out, c, aux
            cache0 = ssm.init_ssm_cache(cfg, B)
            h = rms_norm(x, p0["norm"], cfg.rms_eps)
            for w in ("wz", "wx", "wB", "wC", "wdt"):
                flat[f"layer/{mode}/proj/{w}"] = np.asarray(jax.jit(
                    lambda h, m=mode, w=w: pdot(h, p0[w], m, wq=p0.get(w + "_q")))(h)
                    .astype(jnp.float32))
        else:
            def fwd(p, c, u, q, prefill, m=mode):
                out, c = attention.mla_forward(p, u, cfg, positions=q, mode=m, cache=c,
                                               prefill=prefill)
                return out, c, {}
            cache0 = attention.init_mla_cache(cfg, B, 32, jnp.float32)
        run = jax.jit(fwd, static_argnums=(4,))
        out, c1, _ = run(p0, cache0, x, pos[0], True)
        for name, (o, c, aux) in (("prefill", (out, c1, {})),
                                  ("decode", run(p0, c1, x1, pos[1], False)),
                                  ("segment", run(p0, c1, xseg, pos[2], False))):
            flat[f"layer/{mode}/{name}/out"] = np.asarray(o.astype(jnp.float32))
            _save(flat, f"layer/{mode}/{name}/cache", c)
            # bf16 leaves widened (exactly) to f32: npz has no bf16
            _save(flat, f"layer/{mode}/{name}/aux",
                  {k: v.astype(jnp.float32) for k, v in aux.items()})
    if kind == "ssm":
        x, dt, A, Bm, Cm, s0 = (jnp.asarray(v) for v in ssd_inputs())
        y, final = jax.jit(lambda *a: ssm._ssd_chunked(*a, chunk=SSD_CHUNK))(x, dt, A, Bm, Cm)
        flat["ssd/chunked/y"], flat["ssd/chunked/final"] = np.asarray(y), np.asarray(final)
        y, final = jax.jit(lambda *a: ssm._ssd_chunked(*a[:5], chunk=SSD_CHUNK,
                                                       initial_state=a[5]))(x, dt, A, Bm, Cm, s0)
        flat["ssd/carried/y"], flat["ssd/carried/final"] = np.asarray(y), np.asarray(final)
        y, states = jax.jit(ssm._ssd_segment)(x[:, :5], dt[:, :5], A, Bm[:, :5], Cm[:, :5], s0)
        flat["ssd/segment/y"], flat["ssd/segment/states"] = np.asarray(y), np.asarray(states)


def serve(flat, cfg, params):
    """The ``serve`` records of the module docstring."""
    from repro.runtime.config import ServingConfig
    from repro.runtime.serve import BatchedServer

    srv = BatchedServer(cfg, params, ServingConfig(n_slots=1, max_len=64, max_new=4))
    flat["serve/batched"] = np.asarray(srv.generate([BATCHED_PROMPT])[0], np.int32)
    paged(flat, cfg, params, "serve/paged/tokens")


def qkv(flat, cfg):
    """The ``qkv`` records of the module docstring."""
    params = init_params(cfg, jax.random.PRNGKey(7))
    rng = np.random.default_rng(1)
    toks = jnp.asarray(rng.integers(0, cfg.vocab, (QKV_B, QKV_S)))
    forced = jnp.asarray(rng.integers(0, cfg.vocab, (QKV_STEPS, QKV_B, 1)))
    flat["qkv/params_seed"] = np.asarray(7)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["qkvparam/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    prefill = jax.jit(lambda p, t, c: prefill_step(p, t, c, cfg))
    decode = jax.jit(lambda p, t, q, c: decode_step(p, t, q, c, cfg))
    for name, kw in (("bf16", {}), ("int8", {"quantized": True})):
        logits, caches = prefill(params, toks, init_caches(cfg, QKV_B, 64, **kw))
        seq = [np.asarray(logits, np.float32)]
        pos = jnp.full((QKV_B,), QKV_S, jnp.int32)
        for i in range(QKV_STEPS):
            logits, caches = decode(params, forced[i], pos, caches)
            seq.append(np.asarray(logits, np.float32))
            pos = pos + 1
        flat[f"qkv/{name}/logits"] = np.stack(seq)

    pa = attach_quantized_weights(params, QuantizedWeightCache())
    c0 = init_caches(cfg, 2, 32, quantized=True)
    _, c1 = jax.jit(lambda p, t, c: prefill_step(p, t, c, cfg, mode="fast"))(
        pa, jnp.asarray(SEG_PROMPT), c0)
    _save_tree(flat, "int8/c1", c1)
    _, c2 = jax.jit(lambda p, t, q, c: decode_step(p, t, q, c, cfg, mode="fast"))(
        pa, jnp.asarray(SEG_TOKENS[:, :1]), jnp.asarray(SEG_POSITIONS[:, 0]), c1)
    _save_tree(flat, "int8/c2", c2)
    toks, poss = jnp.asarray(SEG_TOKENS), jnp.asarray(SEG_POSITIONS)
    logits, after, aux = jax.jit(lambda p, t, q, c: segment_step(p, t, q, c, cfg, mode="fast"))(
        pa, toks, poss, c1)
    flat["int8/seg/logits"] = np.asarray(logits)
    _save_tree(flat, "int8/seg", after)
    merged = jax.jit(lambda b, a, x: commit_segment(
        b, a, x, cfg, keep_pos=poss[:, 2], keep_count=jnp.full((2,), 3, jnp.int32),
        active=jnp.asarray([True, False])))(c1, after, aux)
    _save_tree(flat, "int8/commit", merged)


def make_batch(cfg, B=2, S=32, rng_seed=0):
    """``tests/test_arch_smoke.py::make_batch``."""
    rng = np.random.default_rng(rng_seed)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab, (B, S)))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.modality_stub:
        batch["extra_embeds"] = jnp.asarray(
            rng.normal(0, 0.02, (B, cfg.stub_prefix_len, cfg.d_model)), jnp.float32)
    return batch


def train(flat, arch):
    """The ``train`` records of the module docstring for one arch."""
    from repro.models import train_loss

    cfg = smoke(arch)
    params = init_params(cfg, jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat[f"{arch}/param/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    batch = make_batch(cfg)
    _save(flat, f"{arch}/batch", batch)
    for mode in TRAIN_MODES.get(arch, ("precise",)):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b, m=mode: train_loss(p, b, cfg, mode=m), has_aux=True))(params, batch)
        flat[f"{arch}/train/{mode}/loss"] = np.asarray(loss)
        _save(flat, f"{arch}/train/{mode}/metrics", metrics)
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            flat[f"{arch}/train/{mode}/grad/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    if not cfg.modality_stub:
        return
    pa = attach_quantized_weights(params, QuantizedWeightCache())
    B, S = batch["tokens"].shape
    for mode in STUB_MODES:
        prefill = jax.jit(lambda p, t, c, e, m=mode: prefill_step(p, t, c, cfg, mode=m,
                                                                  extra_embeds=e))
        decode = jax.jit(lambda p, t, q, c, m=mode: decode_step(p, t, q, c, cfg, mode=m))
        caches = init_caches(cfg, B, cfg.max_seq, dtype=jnp.float32)
        logits, c1 = prefill(pa, batch["tokens"], caches, batch["extra_embeds"])
        flat[f"{arch}/stub/{mode}/logits"] = np.asarray(logits)
        _save_tree(flat, f"{arch}/stub/{mode}/c1", c1)
        text, _ = prefill(pa, batch["tokens"], caches, None)
        flat[f"{arch}/stub/{mode}/logits_text"] = np.asarray(text)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        ld, c2 = decode(pa, tok, jnp.full((B,), S, jnp.int32), c1)
        flat[f"{arch}/stub/{mode}/logits_decode"] = np.asarray(ld)
        _save_tree(flat, f"{arch}/stub/{mode}/c2", c2)


def dp(flat, arch):
    """The ``dp`` records of the module docstring."""
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.optim.adamw import AdamWConfig, init_opt_state
    from repro.optim.grad_compress import compressed_mean, make_dp_train_step

    mesh8 = jax.make_mesh((GC_SHAPE[0],), ("data",))
    g = np.random.default_rng(0).normal(0, 1, GC_SHAPE).astype(np.float32)

    def worker(g_local, r_local):
        mean, new_res = compressed_mean({"w": g_local}, {"w": r_local}, "data", GC_SHAPE[0],
                                        bits=8)
        return mean["w"], new_res["w"], jax.lax.pmean(g_local, "data")

    f = jax.jit(shard_map(worker, mesh=mesh8, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data"), P("data")), check_vma=False))
    gl = jnp.asarray(g.reshape(-1, GC_SHAPE[2]))
    m1, r1, exact = f(gl, jnp.zeros_like(gl))
    m2, r2, _ = f(gl, r1)
    flat["gc/g"] = g
    for k, v in (("mean1", m1), ("res1", r1), ("mean2", m2), ("res2", r2), ("exact", exact)):
        flat[f"gc/{k}"] = np.asarray(v).reshape(GC_SHAPE)

    cfg = smoke(arch)
    params = init_params(cfg, jax.random.PRNGKey(0))
    _save_tree_paths(flat, "dp/param", params)
    batch = make_batch(cfg, *DP_BATCH)
    _save(flat, "dp/batch", batch)
    mesh2 = jax.make_mesh((DP_DEVICES,), ("data",), devices=jax.devices()[:DP_DEVICES])
    opt_cfg = AdamWConfig(**DP_OPT)
    for bits in DP_BITS:
        step = make_dp_train_step(cfg, opt_cfg, mesh2, compress_bits=bits, mode="precise")
        res = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        p1, _, r1, metrics = step(params, init_opt_state(params), res, batch)
        key = f"dp/{bits if bits is not None else 'none'}"
        flat[f"{key}/loss"] = np.asarray(metrics["loss"])
        flat[f"{key}/grad_norm"] = np.asarray(metrics["grad_norm"])
        _save_tree_paths(flat, f"{key}/param", p1)
        _save_tree_paths(flat, f"{key}/res", r1)


def _save_tree_paths(flat, key, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat[f"{key}/" + "/".join(k.key for k in path)] = np.asarray(leaf)


def main(out, arch="deepseek_7b", what=""):
    flat = {}
    if what == "dp":
        dp(flat, arch)
        _write(out, flat)
        return
    if what == "train":
        for a in arch.split(","):
            train(flat, a)
        _write(out, flat)
        return
    cfg = smoke(arch)
    if what == "qkv":
        qkv(flat, cfg)
        _write(out, flat)
        return
    params = init_params(cfg, jax.random.PRNGKey(3))
    pa = attach_quantized_weights(params, QuantizedWeightCache())
    for path, leaf in jax.tree_util.tree_flatten_with_path(pa)[0]:
        flat["param/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    if what in ("ssm", "mla", "hybrid"):
        from repro.runtime.config import ServingConfig
        from repro.runtime.serve import BatchedServer

        srv = BatchedServer(cfg, params, ServingConfig(n_slots=1, max_len=64, max_new=4))
        flat["serve/batched"] = np.asarray(srv.generate([BATCHED_PROMPT])[0], np.int32)
        if what != "hybrid":
            segments(flat, cfg, pa)
            mixer_layer(flat, cfg, pa, what)
    if what in ("segment", "spec", "paged", "serve"):
        {"segment": lambda: segments(flat, cfg, pa), "spec": lambda: speculative(flat, cfg, params),
         "paged": lambda: paged(flat, cfg, params),
         "serve": lambda: serve(flat, cfg, params)}[what]()
        _write(out, flat)
        return
    for mode in ("exact", "fast"):
        prefill = jax.jit(lambda p, t, c: prefill_step(p, t, c, cfg, mode=mode))
        decode = jax.jit(lambda p, t, q, c: decode_step(p, t, q, c, cfg, mode=mode))
        caches = init_caches(cfg, 1, 32, dtype=jnp.float32)
        lp, c1 = prefill(pa, jnp.asarray(TOKENS), caches)
        flat[f"{mode}/logits_prefill"] = np.asarray(lp)
        if arch == "deepseek_7b":
            _save(flat, f"{mode}/c1", c1["pos0"])
            ld, c2 = decode(pa, jnp.asarray(NEXT), jnp.asarray([TOKENS.shape[1]], jnp.int32), c1)
            _save(flat, f"{mode}/c2", c2["pos0"])
            flat[f"{mode}/logits_decode"] = np.asarray(ld)
            continue
        for pos in c1:
            _save(flat, f"{mode}/c1/{pos}", c1[pos])
        tokens, logits, c = [int(np.argmax(lp[0]))], [], c1
        for i in range(DECODE_STEPS):
            pos = jnp.asarray([TOKENS.shape[1] + i], jnp.int32)
            ld, c = decode(pa, jnp.asarray([[tokens[-1]]], jnp.int32), pos, c)
            logits.append(np.asarray(ld))
            tokens.append(int(np.argmax(ld[0])))
        for pos in c:
            _save(flat, f"{mode}/c2/{pos}", c[pos])
        flat[f"{mode}/logits_decode"] = np.stack(logits)
        flat[f"{mode}/tokens"] = np.asarray(tokens, np.int32)
    if what == "moe":
        moe(flat, cfg, params, pa)
    _write(out, flat)


def _write(out, flat):
    with open(out + ".part", "wb") as f:
        np.savez(f, **flat)
    os.replace(out + ".part", out)


# ---------------------------------------------------------------------------
# the parent side: the runs shared by the spec and paged test modules
# ---------------------------------------------------------------------------


def start_shared(request, tmp_path_factory):
    """Start each run of SHARED_RUNS whose module this session collected
    and no process of the session has claimed (a claim file made with
    O_EXCL); returns the directory the runs write to."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the session's, shared by its workers
    out_dir = root / "jax_shared"
    out_dir.mkdir(exist_ok=True)
    collected = {item.path.name for item in request.session.items}
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    for (arch, mode), modules in SHARED_RUNS.items():
        run_env = dict(env, XLA_FLAGS=env["XLA_FLAGS"] + RUN_XLA_FLAGS.get(mode, ""))
        out = out_dir / f"{arch}-{mode}.npz"
        if not collected & ({modules} if isinstance(modules, str) else set(modules)):
            continue
        try:
            os.close(os.open(out_dir / f"{arch}-{mode}.claim", os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            continue
        _STARTED[out] = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out),
                                          arch, mode], env=run_env)
    return out_dir


def wait_shared(out_dir, arch, mode, timeout=600):
    """The path of one shared run's file once it is written; raises if
    the run failed or did not finish in ``timeout`` seconds."""
    out = out_dir / f"{arch}-{mode}.npz"
    err = out.with_suffix(".err")
    deadline = time.monotonic() + timeout
    while not out.exists():
        proc = _STARTED.get(out)
        if err.exists() or (proc is not None and proc.poll() not in (None, 0)):
            raise RuntimeError(f"JAX run {arch} {mode} failed:\n"
                               + (err.read_text() if err.exists() else ""))
        if time.monotonic() > deadline:
            raise TimeoutError(f"JAX run {arch} {mode} did not finish in {timeout} s")
        time.sleep(0.1)
    return out


@atexit.register
def _finish_shared():
    # another worker may still wait for a run this process started
    for proc in _STARTED.values():
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()


if __name__ == "__main__":
    try:
        main(*sys.argv[1:])
    except BaseException:
        with open(os.path.splitext(sys.argv[1])[0] + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
