"""How far the exact (f32) rung's two ways of computing one next token
drift apart on a Mixture-of-Experts model, in the JAX reference and in
the PyTorch port, on the CPU.

The model is granite-moe-3b-a800m at its published width (d_model 1536,
24 heads of 64 over 8, 40 experts of d_ff 512, top-8) with random
weights from ``PRNGKey(0)``, cut to a small vocabulary (2048: the head's
width does not enter the drift) and to the given depths, with the
capacity factor at E / k so that no token is dropped.  For a random
prompt of ``--tokens`` tokens, the next-token logits come (a) from a
prefill of all but the last token and one decode step (vanilla decode's
path) and (b) from a prefill of all but the last two tokens and one
segment step over them (the speculative verify's path).  Both are exact
in exact arithmetic; in f32 they differ by summation order, and top-k
routing turns that noise into different experts once it reaches a
router's k-th / (k+1)-th boundary.  One JSON line per depth: each
package's largest logit gap between the paths and whether the argmaxes
agree.  The port gets JAX's parameters (``convert.params_from_jax``).

Usage::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_moe_path_divergence.py \\
        [--layers 4 8 16] [--tokens 64]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def _jax_gap(cfg, params, prompt):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import decode_step, init_caches, prefill_step, segment_step

    n = prompt.shape[1]
    toks = jnp.asarray(prompt)
    prefill = jax.jit(lambda p, t, c: prefill_step(p, t, c, cfg, mode="exact"))
    c = init_caches(cfg, 1, n + 1, dtype=jnp.float32)
    _, c = prefill(params, toks[:, :-1], c)
    la, _ = jax.jit(lambda p, t, q, c: decode_step(p, t, q, c, cfg, mode="exact"))(
        params, toks[:, -1:], jnp.asarray([n - 1]), c)
    c = init_caches(cfg, 1, n + 1, dtype=jnp.float32)
    _, c = prefill(params, toks[:, :-2], c)
    lb, _, _ = jax.jit(lambda p, t, q, c: segment_step(p, t, q, c, cfg, mode="exact"))(
        params, toks[:, -2:], jnp.arange(n - 2, n)[None], c)
    return np.asarray(la)[0], np.asarray(lb)[0, -1]


def _port_gap(cfg, params, prompt):
    import torch

    from repro_torch import models as tm

    n = prompt.shape[1]
    toks = torch.from_numpy(prompt)
    c = tm.init_caches(cfg, 1, n + 1, device="cpu")
    tm.prefill_step(params, toks[:, :-1], c, cfg, mode="exact")
    la, _ = tm.decode_step(params, toks[:, -1:], torch.tensor([n - 1]), c, cfg, mode="exact")
    c = tm.init_caches(cfg, 1, n + 1, device="cpu")
    tm.prefill_step(params, toks[:, :-2], c, cfg, mode="exact")
    lb, _, _ = tm.segment_step(params, toks[:, -2:], torch.arange(n - 2, n)[None], c, cfg,
                               mode="exact")
    return la[0].numpy(), lb[0, -1].numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    from repro.configs import get_config as j_get_config
    from repro.models import init_params
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.convert import params_from_jax

    for layers in args.layers:
        out = {"layers": layers, "tokens": args.tokens}
        jcfg, tcfg = (dataclasses.replace(
            c, n_layers=layers, vocab=2048,
            moe=dataclasses.replace(c.moe, capacity_factor=c.moe.num_experts / c.moe.top_k))
            for c in (j_get_config("granite_moe_3b_a800m"), t_get_config("granite_moe_3b_a800m")))
        params = init_params(jcfg, jax.random.PRNGKey(0))
        prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (1, args.tokens)).astype(np.int32)
        for name, gap, cfg, p in (
                ("jax", _jax_gap, jcfg, params),
                ("port", _port_gap, tcfg,
                 params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))):
            a, b = gap(cfg, p, prompt)
            out[f"{name}_logit_gap"] = float(np.abs(a - b).max())
            out[f"{name}_argmax_equal"] = bool(a.argmax() == b.argmax())
            out[f"{name}_logit_scale"] = float(np.abs(a).max())
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
