"""Training driver.

Reference: ``src/repro/launch/train.py`` — its single-host smoke path
(``:22-52``): the family's reduced config, the ``Trainer`` with a
checkpoint every quarter of the run, resume from the newest checkpoint
in ``--ckpt-dir``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b --smoke \\
        --steps 20 --device cpu

``--device`` (default ``cuda``) is the port's: ``cpu`` runs the plain
versions of the kernels.

``--mesh single|multi`` is the production path (``:53-80``): the sharded
train cell of ``launch.steps.build_cell`` on the (16, 16) or (2, 16, 16)
mesh, run step by step on SyntheticLM batches of the shape's size.  It
needs a process group of the mesh's size (``torchrun``'s environment,
one rank a card); with fewer ranks it exits and points to the dry-run
(``python -m repro_torch.launch.dryrun``), which checks the multi-pod
configuration on a fake process group.
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
    if args.mesh is not None and not args.smoke:
        return train_on_mesh(args)

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


def train_on_mesh(args):
    """The production path: the sharded train cell, step by step."""
    import math

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_by_name, mesh_shape

    need = math.prod(mesh_shape(args.mesh).values())
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise SystemExit(
            f"production mesh requested but this process group has {have} rank(s), the "
            f"{args.mesh} mesh needs {need}; use --smoke here, or launch on the cluster "
            "(the multi-pod configuration is validated by repro_torch.launch.dryrun)")

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import SHAPES, build_cell, place
    from repro_torch.models import init_params

    if args.device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    dev = torch.device(args.device, torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device(args.device)
    mesh = make_mesh_by_name(args.mesh)
    step, (p_ex, o_ex, b_ex), meta = build_cell(args.arch, args.shape, mesh, args.mode)
    cfg = get_config(args.arch)
    params = _place_tree(p_ex, init_params(cfg, seed=0, device=dev))
    opt = _place_tree(o_ex, o_ex, zeros=True, device=dev)
    cell = SHAPES[args.shape]
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=cell.seq, global_batch=cell.batch))
    for i in range(args.steps):
        batch = {k: place(b_ex[k], torch.from_numpy(v).to(dev))
                 for k, v in data.batch(i).items() if k in b_ex}
        params, opt, metrics = step(params, opt, batch)
        if i % 10 == 0 and dist.get_rank() == 0:
            print(f"step {i}: loss {float(metrics['loss'].full_tensor()):.4f}")
    return meta


def _place_tree(example, full, zeros: bool = False, device=None):
    """Place a tree of global tensors like the example tree (``zeros``:
    the zero optimizer state, built from the examples' shapes)."""
    import torch

    from repro_torch.launch.steps import place

    if isinstance(example, dict):
        return {k: _place_tree(example[k], full[k], zeros, device) for k in example}
    if isinstance(example, tuple):
        return type(example)(*(_place_tree(e, f, zeros, device) for e, f in zip(example, full)))
    if zeros:
        full = torch.zeros(example.shape, dtype=example.dtype, device=device)
    return place(example, full)


if __name__ == "__main__":
    main()
