#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print one JSON line.

Usage, from the root of a checkout, on a machine with an NVIDIA card::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/<mix>.json``).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py``.  The last line of standard output is
the result; the numbers compared by the check are the last lines of
standard error.  Without a CUDA card, or with fewer than the cell asks
for, it exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every build and kernel cache of the run at a fixed path inside the checkout
_CACHE = os.path.join(ROOT, "build", "portbench-cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")


def _fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return _fail(f"unknown workload {args.workload!r}; known: {sorted(cells)}")
    cell = cells[args.workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        return _fail(f"{args.workload} needs {cell['chips']} cards, "
                     f"found {torch.cuda.device_count()}")

    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import check, harness
    from portbench.traffic import Mix

    spec = harness.load_json(os.path.join(ROOT, conf["file"]))
    mix = Mix.load(os.path.join(ROOT, "portbench", "traffic", f"{cell['traffic']}.json"),
                   cell["traffic"])
    per_layer = [(m["name"], m["unit"]) for m in bench["per_layer"]
                 if args.workload in m.get("workloads", [args.workload])]
    out = harness.run_cell(root=ROOT, workload=args.workload, spec=spec, mix=mix,
                           seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           per_layer=per_layer, limits=check.load_limits(ROOT, args.workload),
                           t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"modules of the JAX side were loaded: {bad}", 3)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
