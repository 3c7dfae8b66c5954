"""Sensor-fusion demo on the PyTorch port: complementary-filter attitude
estimation on the precision ladder, with arbiter-driven switching
(mirrors ``examples/sensor_fusion.py``).

``atan2`` (the accelerometer attitude) and ``sqrt`` (the gravity-vector
norm) go through ``MathEngine``, so the same call sites run whatever
rung is active: the attitude policy puts atan2 on the Q8.24 CORDIC
datapath (kernel K6) and keeps sqrt on Q16.16 (K5).  A vibration burst
at steps 180-199 spikes the |a| telemetry; the ``PrecisionArbiter``
steps up (q8_24 -> f32) through the two-phase barrier and back down
after its stable window.

Run:  PYTHONPATH=src python examples/torch_sensor_fusion.py [--device cpu]
"""

import argparse
import math

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core import ArbiterConfig, MathEngine, PrecisionArbiter, PrecisionPolicy

DT = 0.01          # 100 Hz IMU
ALPHA = 0.98       # complementary-filter gyro weight
STEPS = 400
BURST = range(180, 200)  # vibration burst steps

#: the attitude policy: angle-sensitive atan2 at Q8.24, the |a| gate at
#: the cheap Q16.16 rung — per-op levels inside ONE context.
ATTITUDE_POLICY = PrecisionPolicy(default="q16_16", per_op={"atan2": "q8_24"})


def simulate_imu(rng):
    """True roll angle + gyro rate + accelerometer vector per step."""
    t = np.arange(STEPS) * DT
    roll = 0.6 * np.sin(2.0 * math.pi * 0.5 * t)            # rad
    rate = np.gradient(roll, DT)
    gyro = rate + rng.normal(0, 0.02, STEPS)                 # rad/s + noise
    ay = np.sin(roll) + rng.normal(0, 0.01, STEPS)           # g units
    az = np.cos(roll) + rng.normal(0, 0.01, STEPS)
    ax = rng.normal(0, 0.01, STEPS)
    for s in BURST:                                          # vibration burst
        ay[s] += rng.normal(0, 1.5)
        az[s] += rng.normal(0, 1.5)
    return roll, gyro, ax.astype(np.float32), ay.astype(np.float32), az.astype(np.float32)


def fuse(eng: MathEngine, arb, dev, gyro, ax, ay, az):
    """One pass of the complementary filter through the engine's ops."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    est = 0.0
    history, switches = [], []
    for s in range(STEPS):
        norm = float(eng.call("sqrt", t(np.float32(ax[s] ** 2 + ay[s] ** 2 + az[s] ** 2))))
        acc_roll = float(eng.call("atan2", t(ay[s]), t(az[s])))

        pred = est + gyro[s] * DT
        est = ALPHA * pred + (1.0 - ALPHA) * acc_roll
        history.append(est)

        if arb is None:
            continue
        # arbiter telemetry: innovation as "loss", |a|-deviation as the
        # spike channel (vibration shows up here first)
        innovation = abs(acc_roll - pred)
        rec = arb.observe(s, loss=innovation, grad_norm=abs(norm - 1.0) + 1e-3)
        if rec is not None:
            us = eng.set_level(rec)
            switches.append((s, rec, arb.decisions[-1][2], us))
    return np.array(history), switches


def main(device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(42)
    roll, gyro, ax, ay, az = simulate_imu(rng)
    quiet = np.ones(STEPS, bool)
    quiet[list(BURST)] = False

    def rms(est):
        return float(np.sqrt(np.mean((est - roll)[quiet] ** 2)))

    # ---- the ladder payoff: attitude accuracy per trig level -------------
    est_q16, _ = fuse(MathEngine("q16_16"), None, dev, gyro, ax, ay, az)
    eng24 = MathEngine("q16_16")
    with eng24.at(ATTITUDE_POLICY):
        est_q24, _ = fuse(eng24, None, dev, gyro, ax, ay, az)
    est_f32, _ = fuse(MathEngine("f32"), None, dev, gyro, ax, ay, az)
    r16, r24, r32 = rms(est_q16), rms(est_q24), rms(est_f32)
    print(f"device: {dev}")
    print("attitude RMS error (quiet) by trig level:")
    print(f"  q16_16          : {r16:.7f} rad")
    print(f"  q8_24 (policy)  : {r24:.7f} rad")
    print(f"  f32             : {r32:.7f} rad")
    print(f"  q8_24 vs q16_16 : {r16 - r24:+.2e} rad "
          f"(residual vs f32: {abs(r24 - r32):.2e}; "
          f"Q8.24 removes ~{100.0 * (1.0 - abs(r24 - r32) / max(abs(r16 - r32), 1e-12)):.0f}% "
          f"of the fixed-point attitude error)")

    # ---- arbiter-driven run: q8_24 attitude loop, f32 rescue rung --------
    # spikes only (regress_tol=inf: the innovation is a noisy signal)
    arb = PrecisionArbiter(ArbiterConfig(
        spike_factor=6.0, regress_tol=float("inf"),
        stable_steps=40, cooldown_steps=10,
        ladder=("q8_24", "f32"), start_mode="q8_24",
    ))
    eng = MathEngine("q8_24")
    est, switches = fuse(eng, arb, dev, gyro, ax, ay, az)

    err = np.abs(est - roll)
    print("\narbitrated run (ladder q8_24 -> f32):")
    print(f"attitude RMS error (quiet): {rms(est):.7f} rad")
    print(f"attitude max error (burst): {err[~quiet].max():.5f} rad")
    for s, lvl, reason, us in switches:
        print(f"step {s:3d}: -> {str(lvl).upper():8s} ({reason})  barrier {us:.1f} us")
    print(f"engine level at end: {eng.level.name}")

    y, x = torch.tensor([0.31], device=dev), torch.tensor([0.95], device=dev)
    a = float(MathEngine("q8_24").call("atan2", y, x))
    b = float(MathEngine("f32").call("atan2", y, x))
    print(f"atan2 q8_24 vs f32: {a:.7f} vs {b:.7f} (|d|={abs(a - b):.2e})")
    return switches


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions (default: the card)")
    main(ap.parse_args().device)
