"""Batched serving on the PyTorch port (mirrors ``examples/serve_batched.py``):
prefill + lock-step decode with runtime precision switching between
requests (paper §7.2's hybrid strategy: the engine picks the path per
workload envelope).

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu] [--tiny]

``--device`` defaults to the card (the CUDA kernels); ``cpu`` runs their
plain PyTorch versions.  ``--tiny`` serves two requests of 4 new tokens
(CI).  Every number printed is measured in this run.
"""

import argparse

from repro_torch.configs import smoke
from repro_torch.core.precision import Mode
from repro_torch.models import init_params
from repro_torch.runtime import BatchedServer, ServingConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="two requests, 4 new tokens (CI)")
    args = ap.parse_args(argv)

    cfg = smoke("gemma2_2b")  # local/global alternating + softcaps
    params = init_params(cfg, seed=0, device=args.device)
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [2, 4, 6, 8, 10, 12]]
    if args.tiny:
        prompts = prompts[:2]
    srv = BatchedServer(cfg, params, ServingConfig(n_slots=4, max_len=64,
                                                   max_new=4 if args.tiny else 12),
                        device=args.device)

    out = {}
    print("PRECISE generations:")
    out["precise"] = srv.generate(prompts)
    for i, seq in enumerate(out["precise"]):
        print(f"  req{i}: {seq}")

    us = srv.set_mode(Mode.FAST)
    print(f"\nswitched to FAST (int8 W8A8) in {us:.1f} us")
    print("FAST generations:")
    out["fast"] = srv.generate(prompts)
    for i, seq in enumerate(out["fast"]):
        print(f"  req{i}: {seq}")
    srv.set_mode(Mode.PRECISE)
    us = srv.set_mode(Mode.FAST)
    print(f"steady-state switch latency: {us:.1f} us (measured here)")
    out["switch_us"] = us
    return out


if __name__ == "__main__":
    main()
