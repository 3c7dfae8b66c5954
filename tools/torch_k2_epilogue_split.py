#!/usr/bin/env python3
"""Split K2's time on the card between its products and its CORDIC epilogue.

Usage (repository root, on a machine with an NVIDIA card)::

    python3 tools/torch_k2_epilogue_split.py

Builds ``src/repro_torch/kernels/csrc/fused_mlp.cu`` twice into
``build/k2_epilogue_split/``: as it is, and with K2's ``SwigluEpilogue``
replaced by a plain store of both accumulators (``acc_g`` as the f32
output's bits, ``acc_u`` into the sigmoid output).  Then it times both
through ``repro_fused_swiglu`` with the group count G > 1 (K2's tiles with
the group on ``blockIdx.z``, the MoE experts' products before G2 had
kernels of its own) at the grouped shapes of ``chip_smoke.py``
(``GROUPED_K2`` and ``GROUPED_LONG_K2``), each twice, in the order as-is,
plain store, plain store, as-is.  One JSON line a shape, with the card's
name and power limit before and after.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: the K2 epilogue's first statement, before which the plain store goes
ANCHOR = "    using namespace rq;\n    const size_t col"
PLAIN_STORE = ("#ifdef PLAIN_STORE\n    { const size_t i = (static_cast<size_t>(z) * M + m) * N + n;"
               " out[i] = __int_as_float(acc_g); if (sig_out) sig_out[i] = acc_u; return; }\n#endif\n")


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch import compat

    if not torch.cuda.is_available():
        print("torch_k2_epilogue_split: needs an NVIDIA card", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "k2_epilogue_split")
    os.makedirs(out_dir, exist_ok=True)
    src = (compat.CSRC_DIR / "fused_mlp.cu").read_text()
    if ANCHOR not in src:
        raise RuntimeError("fused_mlp.cu: K2's epilogue does not start where this tool expects")
    cu = os.path.join(out_dir, "fused_mlp_split.cu")
    with open(cu, "w") as f:
        f.write(src.replace(ANCHOR, "    using namespace rq;\n" + PLAIN_STORE
                            + "    const size_t col", 1))
    P, I = ctypes.c_void_p, ctypes.c_int
    fns, procs = {}, []
    for name, flags in (("as_is", []), ("plain_store", ["-DPLAIN_STORE"])):
        so = os.path.join(out_dir, f"lib{name}.so")
        cmd = [compat._nvcc(), *compat.NVCC_FLAGS, *flags, "-I", str(compat.CSRC_DIR), "-o", so, cu]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    for name, so, proc in procs:
        log, _ = proc.communicate()
        print(json.dumps({"build": name, "rc": proc.returncode,
                          "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln]}), flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        fn = ctypes.CDLL(so).repro_fused_swiglu
        fn.argtypes = [P] * 9 + [I] * 4 + [P]
        fn.restype = I
        fns[name] = fn
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    cs.SPIN_CLOCK_HZ = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    for (g, m, k, f) in cs.GROUPED_K2 + cs.GROUPED_LONG_K2:
        x, wg, wu = i8(g, m, k), i8(g, k, f), i8(g, k, f)
        ea = torch.tensor([-6], dtype=torch.int32, device=dev)
        eg = torch.randint(-12, -6, (g, f), generator=gen, dtype=torch.int32).to(dev)
        eu = torch.randint(-12, -6, (g, f), generator=gen, dtype=torch.int32).to(dev)
        out = torch.empty((g, m, f), dtype=torch.float32, device=dev)
        sig = torch.empty((g, m, f), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run(name):
            rc = fns[name](x.data_ptr(), wg.data_ptr(), wu.data_ptr(), ea.data_ptr(),
                           eg.data_ptr(), eu.data_ptr(), out.data_ptr(), None,
                           sig.data_ptr() if name == "plain_store" else None, g, m, f, k, stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        times = {"as_is": [], "plain_store": []}
        for name in ("as_is", "plain_store", "plain_store", "as_is"):
            times[name].append(cs.time_ms(lambda: run(name), iters=10))
        print(json.dumps({"shape": [g, m, k, f], "as_is_ms": times["as_is"],
                          "plain_store_ms": times["plain_store"],
                          "bound_ms": cs.bound_ms(g * (m * k + 2 * k * f + 8 * f + 4 * m * f) + 4,
                                                  4.0 * g * m * k * f, "int8")}), flush=True)
        del x, wg, wu, out, sig
        torch.cuda.empty_cache()
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
