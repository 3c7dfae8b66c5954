"""Child process for the port's model tests: runs the JAX reference
model with XLA's excess-precision optimisation switched off (the flag
must be set before JAX starts, hence a process of its own), so every
bf16 cast of the FAST rung rounds where the source says it does.

Usage: XLA_FLAGS=--xla_allow_excess_precision=false \
           python tests/_torch_jax_child.py OUT.npz [ARCH [segment]]

ARCH is ``deepseek_7b`` (default; tests/test_torch_model.py) or
``gemma2_2b`` (tests/test_torch_gemma2.py).  Writes the smoke model's
parameters and int8 weight payloads, and for each of the ``exact`` and
``fast`` modes the prefill logits and caches, then the decode steps:

* deepseek_7b: one decode of token 12 at position 11;
* gemma2_2b: DECODE_STEPS greedy decode steps, each feeding the argmax
  of the step before (``{mode}/tokens``), so the 8-row sliding-window
  buffer wraps; logits of every step and the caches after the last.

With ``segment`` (tests/test_torch_segment.py) it writes instead an
exact-rung two-lane prefill of SEG_PROMPT (``c1/...``), and from that
cache, per mode, one ``segment_step`` of SEG_TOKENS at positions
11..15 (``{mode}/seg/logits``, ``{mode}/seg/after/...``; gemma2's 8-row
buffers wrap inside it), the same segment with lane 1 masked
(``{mode}/masked/...``), and ``commit_segment`` of the segment for
keep_count 1..5 on both lanes (``{mode}/commit{k}/...``) and for
keep_count 3 with lane 1 inactive (``{mode}/commit_inactive/...``).
"""

import os
import sys

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


def main(out, arch="deepseek_7b", what=""):
    cfg = smoke(arch)
    params = init_params(cfg, jax.random.PRNGKey(3))
    pa = attach_quantized_weights(params, QuantizedWeightCache())
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(pa)[0]:
        flat["param/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    if what == "segment":
        segments(flat, cfg, pa)
        np.savez(out, **flat)
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
    np.savez(out, **flat)


if __name__ == "__main__":
    main(*sys.argv[1:])
