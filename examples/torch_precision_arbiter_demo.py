"""The dynamic precision arbiter on the PyTorch port, ladder edition
(mirrors ``examples/precision_arbiter_demo.py``): a cheap rung until the
numerics degrade (injected), one rung up on a gradient spike, straight
to f32 on a NaN, then stepwise back down after a stable window; the
engine switches through its two-phase barrier and then runs one op at
the final rung on the chosen device.

Run:  PYTHONPATH=src python examples/torch_precision_arbiter_demo.py [--device cpu]
"""

import argparse

import torch

from repro_torch.compat import resolve_device
from repro_torch.core import ArbiterConfig, MathEngine, PrecisionArbiter


def main(device=None):
    dev = resolve_device(device)
    ladder = ("q8_8", "q16_16", "q8_24", "f32")
    arb = PrecisionArbiter(ArbiterConfig(
        spike_factor=4.0, stable_steps=6, cooldown_steps=2,
        ladder=ladder, start_mode="q8_8",
    ))
    eng = MathEngine("q8_8")

    # healthy steps, then a gradient spike (one rung up), then a NaN
    # (straight to the top), then a long recovery (stepwise back down)
    telemetry = [(s, 2.0 - 0.01 * s, 1.0) for s in range(10)]
    telemetry += [(10, 1.9, 40.0)]                      # spike!
    telemetry += [(11, float("nan"), 1.0)]              # NaN!
    telemetry += [(s, 1.8 - 0.004 * s, 1.0) for s in range(12, 60)]

    for step, loss, gnorm in telemetry:
        rec = arb.observe(step, loss, gnorm)
        if rec is not None:
            us = eng.set_level(rec)
            reason = arb.decisions[-1][2]
            print(f"step {step:3d}: -> {str(rec).upper():8s} ({reason})  barrier {us:.1f} us")
    print(f"\ndecision log: {arb.decisions}")
    print(f"engine level at end: {eng.level.name} (rung {arb.rung} of {len(ladder) - 1})")
    x = torch.full((4,), 0.5, device=dev)
    print(f"sin(0.5) at {eng.level.name} on {dev}: {float(eng.call('sin', x)[0]):.7f}")
    return arb.decisions


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions (default: the card)")
    main(ap.parse_args().device)
