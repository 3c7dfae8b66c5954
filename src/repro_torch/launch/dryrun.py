"""Multi-pod dry-run and roofline estimate on a fake process group.

Reference: ``src/repro/launch/dryrun.py:35-186`` — ``model_flops``,
``roofline``, ``run_cell`` and the ``main`` CLI, with the reference's
record fields.  The reference lowers and compiles each cell for a
512-device host platform and reads XLA's memory and cost analyses; the
port instead opens a FAKE process group (``torch.testing._internal.
distributed.fake_pg``: backend ``"fake"``, world size = the mesh's device
count, rank 0; collectives are accepted and do nothing), builds the cell
(``launch.steps.build_cell``: DTensor arguments on ``meta`` shards),
RUNS the step once on them under ``launch.cost_analysis.CostCounter``,
and closes the group again.  Nothing is allocated: every number is
counted from shapes, per device:

* ``memory``: ``argument_size_in_bytes`` (the local shards of the step's
  arguments), ``output_size_in_bytes`` (of its outputs),
  ``alias_size_in_bytes`` (outputs that are arguments updated in place),
  ``temp_size_in_bytes`` (the peak of the bytes the step held live);
* ``hlo_costs``: the counter's FLOPs, bytes and collectives (the
  reference's key, whose numbers came from HLO);
* ``roofline``: the three terms on the NVIDIA H100 constants of
  ``launch.mesh.HW`` — estimates, not measurements.

``lower_s`` is the time to build the cell and place its arguments,
``compile_s`` the time of the traced step (where XLA compiled).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k \\
        --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from pathlib import Path

from repro_torch.launch.cost_analysis import CostCounter, tensor_bytes
from repro_torch.launch.mesh import HW, make_mesh_by_name, mesh_shape
from repro_torch.launch.steps import SHAPES, SkipCell, build_cell, tree_leaves

__all__ = ["model_flops", "roofline", "run_cell", "fake_process_group", "main"]


def model_flops(meta: dict) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode), N = active params."""
    n = meta["active_params"]
    if meta["kind"] == "train":
        return 6.0 * n * meta["batch"] * meta["seq"]
    if meta["kind"] == "prefill":
        return 2.0 * n * meta["batch"] * meta["seq"]
    return 2.0 * n * meta["batch"]  # decode: one token per sequence


def roofline(meta, costs, n_chips, mode: str) -> dict:
    """costs: the per-device ``cost_analysis.Costs`` of the traced step."""
    flops_dev = float(costs.flops)
    bytes_dev = float(costs.bytes)
    coll_dev = float(costs.total_collective_bytes)
    peak = HW.PEAK_INT8_OPS if mode == "fast" else HW.PEAK_BF16_FLOPS
    terms = {
        "compute_s": flops_dev / peak,
        "memory_s": bytes_dev / HW.HBM_BW,
        "collective_s": coll_dev / HW.LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(meta)
    traced_global = flops_dev * n_chips
    bound_s = max(terms.values())
    ideal_s = mf / (n_chips * peak)
    hints = {
        "compute_s": "cut redundant FLOPs (remat's recompute, masked attention tiles) or move the "
                     "matmuls to the int8 rung (2x peak)",
        "memory_s": "fuse elementwise chains into the kernels, quantize weights / KV cache, or "
                    "shard the dominant resident tensor further",
        "collective_s": "overlap collectives with compute, compress gradients (Q-format int8), "
                        "or re-map the sharding to cut resharding",
    }
    return {
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "useful_flop_ratio": mf / traced_global if traced_global else 0.0,
        "roofline_fraction": (ideal_s / bound_s) if bound_s > 0 else 0.0,
        "hint": hints[dominant],
        "estimate": "traced on meta tensors with the NVIDIA H100 SXM data-sheet constants; "
                    "not a measurement",
    }


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks at rank 0 for the
    duration (no process group may stand already)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dry-run: a process group already stands; destroy it first")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch, shape_id, mesh_name, mode="precise", *, fsdp=True, remat=True,
             sharding="default", grad_accum=None, verbose=True):
    n_chips = math.prod(mesh_shape(mesh_name).values())
    rec = {"arch": arch, "shape": shape_id, "mesh": mesh_name, "mode": mode,
           "chips": n_chips, "fsdp": fsdp, "remat": remat, "sharding": sharding}
    with fake_process_group(n_chips):
        mesh = make_mesh_by_name(mesh_name)
        t0 = time.perf_counter()
        try:
            step, args, meta = build_cell(arch, shape_id, mesh, mode, fsdp=fsdp, remat=remat,
                                          sharding=sharding, grad_accum=grad_accum)
        except SkipCell as e:
            rec.update(status="skip", reason=str(e))
            if verbose:
                print(f"[skip] {arch} x {shape_id} x {mesh_name}: {e}")
            return rec
        arg_leaves = list(tree_leaves(args))
        t1 = time.perf_counter()
        with CostCounter() as cc:
            out = step(*args)
        t2 = time.perf_counter()
        costs = cc.costs
        costs.argument_bytes = float(sum(tensor_bytes(t) for t in arg_leaves))
        arg_ids = {id(t) for t in arg_leaves}
        out_leaves = [t for t in tree_leaves(out) if hasattr(t, "numel")]
        mem_rec = {
            "temp_size_in_bytes": costs.peak_bytes,
            "argument_size_in_bytes": costs.argument_bytes,
            "output_size_in_bytes": float(sum(tensor_bytes(t) for t in out_leaves)),
            "alias_size_in_bytes": float(sum(tensor_bytes(t) for t in out_leaves
                                             if id(t) in arg_ids)),
            "generated_code_size_in_bytes": None,
        }
        del out, args, arg_leaves, out_leaves
    rl = roofline(meta, costs, n_chips, mode)
    rec.update(
        status="ok",
        lower_s=round(t1 - t0, 2),
        compile_s=round(t2 - t1, 2),
        meta={k: v for k, v in meta.items() if k != "dropped_rules"},
        dropped_rules=[list(map(str, d)) for d in meta.get("dropped_rules", [])],
        memory=mem_rec,
        hlo_costs=costs.as_dict(),
        roofline=rl,
    )
    if verbose:
        print(f"[ok] {arch} x {shape_id} x {mesh_name} ({mode}) "
              f"build {rec['lower_s']}s trace {rec['compile_s']}s")
        print(f"     memory (per device, bytes): {mem_rec}")
        print(f"     traced: flops={costs.flops:.3e} bytes={costs.bytes:.3e} "
              f"collective={costs.total_collective_bytes:.3e} B in "
              f"{costs.total_collective_count:.0f} ops")
        print(f"     roofline (H100 estimate): compute={rl['compute_s']:.4f}s "
              f"memory={rl['memory_s']:.4f}s collective={rl['collective_s']:.4f}s -> dominant "
              f"{rl['dominant']}, fraction {rl['roofline_fraction']:.3f}, useful-FLOP ratio "
              f"{rl['useful_flop_ratio']:.3f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--mode", default="precise", choices=["precise", "fast"])
    ap.add_argument("--all", action="store_true", help="every arch x shape for --mesh")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--sharding", default="default", choices=["default", "pure_fsdp"])
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--tag", default="", help="suffix for result filenames")
    ap.add_argument("--out-dir", default="build/dryrun")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        from repro_torch.configs import ARCH_IDS

        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    records = []
    for arch, shape_id in cells:
        rec = run_cell(arch, shape_id, args.mesh, args.mode, fsdp=not args.no_fsdp,
                       remat=not args.no_remat, sharding=args.sharding,
                       grad_accum=args.grad_accum)
        tag = f"-{args.tag}" if args.tag else ""
        name = f"{arch}-{shape_id}-{args.mesh}-{args.mode}{tag}.json"
        (out_dir / name).write_text(json.dumps(rec, indent=2, default=str))
        print(f"     -> {out_dir / name}")
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
