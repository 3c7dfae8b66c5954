#!/usr/bin/env python3
"""Readings that the limits of ``portbench/limits/<cell>.json`` are set
from: for each seed, the program's numbers, the control's and those of
each fault planted under the timed path.

Usage, from the root of a checkout, on the card::

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--readings control,witness] [--faults kv_unwritten,half_left_out]

Each seed runs in this one process as a run of the cell does (weights
drawn from the seed, the server built and warmed up), serves the
batches a run's check needs at the cell's own load, and then reads on
the same sample of finished requests the gaps of the served tokens
under the int8 reference (the program's readings) and, for each of
``--readings``, the gaps of the tokens that reading puts first (the
control: the reference at int4; the witness: the reference with its
rotary phases moved by K3's error).  Each of ``--faults``
(``portbench/faults.py``) then serves the same seed with that fault
planted and is read the same way.  One JSON line a run.  The
benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, "build", "portbench-cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--readings", default="control",
                    help="comma-separated keys of harness.READINGS, or empty")
    ap.add_argument("--faults", default="", help="comma-separated faults, or empty")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import check, faults, harness
    from portbench.traffic import Mix

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    spec = harness.load_json(os.path.join(ROOT, conf["file"]))
    mix = Mix.load(os.path.join(ROOT, "portbench", "traffic", f"{cell['traffic']}.json"),
                   cell["traffic"])
    per_batch = sum(mix.output_lengths())
    batches = max(1, math.ceil(mix.check_tokens / per_batch))
    limits = check.load_limits(ROOT, args.workload)
    readings = [r for r in args.readings.split(",") if r]
    for s in args.seeds.split(","):
        for fault in [None] + [f for f in args.faults.split(",") if f]:
            undo = faults.plant(fault) if fault else None
            t0 = time.perf_counter()
            try:
                out = harness.run_cell(root=ROOT, workload=args.workload, spec=spec, mix=mix,
                                       seed=int(s), seconds=0.0, trace=False, per_layer=[],
                                       limits=limits, t_start=t0, device=args.device,
                                       min_batches=batches,
                                       readings=() if fault else readings)
            finally:
                if undo:
                    undo()
            rec = {"workload": args.workload, "seed": int(s), "fault": fault,
                   "correct": out["correct"], "checks": out["checks"],
                   "failed": out["failed"], "attempted": out["attempted"],
                   "program": out["window"]["gap_summary"],
                   "readings": out.get("readings"), "window": out["window"],
                   "run_s": time.perf_counter() - t0}
            print(json.dumps(rec), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
