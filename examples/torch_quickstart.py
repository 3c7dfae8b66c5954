"""Quickstart: the Dynamic Precision Math Engine's public API on the
PyTorch port (mirrors ``examples/quickstart.py``).

One engine, several execution paths, O(1) runtime switching, on tensors
on the card (the CUDA kernels) or, with ``--device cpu``, on their plain
PyTorch versions.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import math

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core import (
    MathEngine,
    Mode,
    PrecisionPolicy,
    cordic_sincos,
    from_fixed,
    ladder_names,
    q_mul,
    quantize_pow2,
    rope_inv_freq_q64,
    static_footprint_bytes,
    to_fixed,
)
from repro_torch.kernels.cordic import ops as cordic_ops
from repro_torch.kernels.qmatmul import qmatmul


def main(device=None):
    dev = resolve_device(device)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    # --- paper C1: Q16.16 scalars on the integer pipeline ----------------
    a, b = to_fixed(t(3.25)), to_fixed(t(-1.5))
    print("Q16.16 3.25 * -1.5 =", float(from_fixed(q_mul(a, b))))  # -4.875

    # --- paper C2: CORDIC sincos, 64-byte table, 16 iterations (K3) ------
    theta = t(np.linspace(-np.pi, np.pi, 8))
    s, _ = cordic_sincos(theta)
    print("max |cordic - libm| =", float((s - torch.sin(theta)).abs().max()))

    # --- paper C3: tiled int8 matmul with deferred rescale (K1) ----------
    rng = np.random.default_rng(42)
    x = rng.uniform(-1, 1, (128, 256)).astype(np.float32)
    w = rng.uniform(-1, 1, (256, 128)).astype(np.float32)
    xq, wq = quantize_pow2(t(x), bits=8), quantize_pow2(t(w), bits=8, axis=1)
    y = qmatmul(xq.q, wq.q, xq.exp, wq.exp.reshape(-1), "float")  # W8A8, ONE rounding a element
    err = (y.cpu().double() - torch.from_numpy(x).double() @ torch.from_numpy(w).double()).abs()
    print(f"qmatmul vs float: max err {float(err.max()):.4f} (int8 grid)")

    # --- paper C3: the engine's matmul, deferred-shift Q16.16 -------------
    # (Listing 3: 64-bit sums over 32-deep K tiles, ONE rounding a tile)
    eng = MathEngine(Mode.PRECISE)
    exact = eng.call("matmul", t(x), t(w))
    eng.set_mode(Mode.FAST)
    fixed = from_fixed(eng.call("matmul", to_fixed(t(x)), to_fixed(t(w))))
    tiles = math.ceil(x.shape[1] / 32)
    print(f"matmul q16_16 vs f32: max err {float((fixed - exact).abs().max()):.2e} "
          f"(bound {tiles} tiles x 2**-17 + input rounding)")

    # --- paper C4: runtime switching, dispatch table D --------------------
    eng = MathEngine(Mode.PRECISE)
    print("precise sin(0.5) =", float(eng.call("sin", t(0.5))))
    us = eng.set_mode(Mode.FAST)       # two-phase barrier, O(1)
    print(f"switched to FAST in {us:.1f} us")
    print("fast    sin(0.5) =", float(eng.call("sin", t(0.5))))

    # --- beyond the paper: the precision LADDER ---------------------------
    print("ladder:", " < ".join(ladder_names()))
    with eng.at("q8_24"):              # scoped: Q8.24 CORDIC datapaths
        print("q8_24   sin(0.5) =", float(eng.call("sin", t(0.5))))
    pol = PrecisionPolicy(default="q16_16", per_op={"atan2": "q8_24"})
    with eng.at(pol):                  # per-op: trig high-precision, rest fast
        print("policy atan2(3,4) =", float(eng.call("atan2", t(3.0), t(4.0))))
    print("fast   div(10, 4) =", float(eng.call("div", t(10.0), t(4.0))))

    # --- the 88-byte static footprint (paper §4.3.2) ----------------------
    print("static footprint:", static_footprint_bytes())

    # --- RoPE tables more accurate than fp32 at 500k positions ------------
    f_hi, f_lo = (torch.from_numpy(f.astype(np.int64)).to(dev) for f in rope_inv_freq_q64(128))
    sin_t, _ = cordic_ops.rope_tables(torch.tensor([524287], device=dev), f_hi, f_lo)
    print("rope table at pos 524287:", sin_t[0, :3].cpu().numpy())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions (default: the card)")
    main(ap.parse_args().device)
