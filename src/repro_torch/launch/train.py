"""Training driver.

Reference: ``src/repro/launch/train.py`` — its single-host smoke path
(``:22-52``): the family's reduced config, the ``Trainer`` with a
checkpoint every quarter of the run, resume from the newest checkpoint
in ``--ckpt-dir``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b --smoke \\
        --steps 20 --device cpu

``--device`` (default ``cuda``) is the port's: ``cpu`` runs the plain
versions of the kernels.  ``--mesh`` (the reference's production path on
a TPU pod) raises: the port's sharded cells are ROADMAP.md queue 1 item
13.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mode", default="precise", choices=["precise", "fast"])
    ap.add_argument("--arbiter", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh is not None:
        raise SystemExit(
            f"--mesh {args.mesh}: sharded training is not ported yet "
            "(ROADMAP.md queue 1 item 13); run the smoke path without --mesh")

    from repro_torch.configs import smoke
    from repro_torch.core.precision import Mode
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    cfg = smoke(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir,
        start_mode=Mode(args.mode),
        use_arbiter=args.arbiter,
    )
    out = Trainer(cfg, tcfg, device=args.device).run()
    print(f"final loss {out['final_loss']:.4f} after {args.steps} steps "
          f"({out['switches']} precision switches)")
    return out


if __name__ == "__main__":
    main()
