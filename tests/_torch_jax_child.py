"""Child process for tests/test_torch_model.py: runs the JAX reference
model with XLA's excess-precision optimisation switched off (the flag
must be set before JAX starts, hence a process of its own), so every
bf16 cast of the FAST rung rounds where the source says it does.

Usage: XLA_FLAGS=--xla_allow_excess_precision=false \
           python tests/_torch_jax_child.py OUT.npz
Writes the smoke model's parameters and int8 weight payloads, and for
each of the ``exact`` and ``fast`` modes the prefill and decode logits
and the caches after each step."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke  # noqa: E402
from repro.core.quantization import QuantizedWeightCache  # noqa: E402
from repro.models import decode_step, init_caches, init_params, prefill_step  # noqa: E402
from repro.models.layers import attach_quantized_weights  # noqa: E402

TOKENS = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]], np.int32)
NEXT = np.array([[12]], np.int32)


def main(out):
    cfg = smoke("deepseek_7b")
    params = init_params(cfg, jax.random.PRNGKey(3))
    pa = attach_quantized_weights(params, QuantizedWeightCache())
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(pa)[0]:
        flat["param/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    for mode in ("exact", "fast"):
        caches = init_caches(cfg, 1, 32, dtype=jnp.float32)
        lp, c1 = jax.jit(lambda p, t, c: prefill_step(p, t, c, cfg, mode=mode))(
            pa, jnp.asarray(TOKENS), caches)
        flat[f"{mode}/c1"] = None
        for k, v in c1["pos0"].items():
            flat[f"{mode}/c1/{k}"] = np.asarray(v)
        ld, c2 = jax.jit(lambda p, t, q, c: decode_step(p, t, q, c, cfg, mode=mode))(
            pa, jnp.asarray(NEXT), jnp.asarray([TOKENS.shape[1]], jnp.int32), c1)
        for k, v in c2["pos0"].items():
            flat[f"{mode}/c2/{k}"] = np.asarray(v)
        flat[f"{mode}/logits_prefill"] = np.asarray(lp)
        flat[f"{mode}/logits_decode"] = np.asarray(ld)
        del flat[f"{mode}/c1"]
    np.savez(out, **flat)


if __name__ == "__main__":
    main(sys.argv[1])
