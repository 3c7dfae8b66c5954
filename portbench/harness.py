"""One run of one cell: set-up, the timed window, the traced reading and
the check against the plain reference.

Set-up draws the weights on the device from the seed (float32, the
type the server takes; one call a leaf of the port's stacked layout),
builds ``ContinuousBatchingServer`` on the mix's ``n_slots`` and
``max_len`` and warms it up with one request a slot at the batch's
longest prompts.  The window then serves one offline batch after
another through ``ContinuousBatchingServer.serve`` until ``seconds``
have passed, and finishes the batch in flight.  ``--trace 1`` turns the
server's telemetry on with device barriers, profiles the second batch
with ``torch.profiler`` and reads the per-layer metrics from it and from
the other batches.  The check runs once the window has closed, the
memory peak has been read and the server is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from portbench import check
from portbench.traffic import Mix

#: top-level module names that may not be loaded when a run ends
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


@dataclasses.dataclass
class Batch:
    requests: List[Tuple[int, int]]          # (prompt length, tokens served)
    wall_s: float
    profiled: bool = False
    before: Optional[dict] = None            # registry snapshots around the batch
    after: Optional[dict] = None


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader may read."""
    spec: dict
    mix: Mix
    batches: List[Batch]
    trace: Any = None                        # portbench.trace.Trace of the profiled batch
    grouped_calls: List[tuple] = dataclasses.field(default_factory=list)
    window_peak_bytes: Optional[int] = None

    def unprofiled(self) -> List[Batch]:
        return [b for b in self.batches if not b.profiled]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def model_config(spec: dict):
    """The port's ModelConfig of a configuration file."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import LayerSpec

    base = get_config(spec["arch"])
    lay = spec["layer"]
    moe = None
    if spec.get("moe"):
        m = spec["moe"]
        moe = dataclasses.replace(base.moe, num_experts=int(m["num_experts"]),
                                  top_k=int(m["top_k"]),
                                  capacity_factor=float(m["capacity_factor"]))
    return dataclasses.replace(
        base, d_model=int(spec["d_model"]), n_layers=int(spec["n_layers"]),
        period=(LayerSpec(kind=lay["kind"], window=lay.get("window"), ffn=lay["ffn"]),),
        vocab=int(spec["vocab"]), n_heads=int(spec["n_heads"]),
        n_kv_heads=int(spec["n_kv_heads"]), head_dim=int(spec["head_dim"]),
        d_ff=int(spec["d_ff"]), rope_base=float(spec["rope_base"]),
        rms_eps=float(spec["rms_eps"]), moe=moe)


def draw_params(cfg, seed: int, device) -> dict:
    """Float32 weights in the port's layout, drawn on ``device`` from
    ``seed``: normal with std 1/sqrt(rows of the matrix) unless the layout
    gives a scale (the embedding, the router), norm gains 0 (a gain of 1)."""
    from repro_torch.models import param_specs

    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        if node.init == "zeros" or len(node.shape) < 2:
            return torch.zeros(node.shape, dtype=torch.float32, device=device)
        scale = node.scale if node.scale is not None else node.shape[-2] ** -0.5
        return torch.randn(node.shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(scale)

    return draw(param_specs(cfg))


class _GroupedRecorder:
    """Records the shapes and live rows of the grouped expert calls while
    ``on`` (the traced batch only), by wrapping the two names the MoE
    block calls.  It holds the ``rows`` tensors and launches nothing."""

    def __init__(self):
        import repro_torch.models.moe as moe

        self.moe, self.on, self.calls = moe, False, []
        self.orig = {}
        for kind, name in (("g2", "fused_swiglu_grouped"), ("g1", "qmatmul_grouped")):
            fn = getattr(moe, name, None)
            if fn is None:
                continue
            self.orig[name] = fn
            setattr(moe, name, self._wrap(kind, fn))

    def _wrap(self, kind, fn):
        def wrapped(*args, **kw):
            if self.on:
                self.calls.append((kind, tuple(args[0].shape), tuple(args[1].shape),
                                   kw.get("rows")))
            return fn(*args, **kw)
        return wrapped

    def host_calls(self) -> List[tuple]:
        out = []
        for kind, xs, ws, rows in self.calls:
            out.append((kind, xs, ws, None if rows is None else rows.cpu().numpy()))
        return out

    def close(self):
        for name, fn in self.orig.items():
            setattr(self.moe, name, fn)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def load_reader(root: str, metric: str):
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(*, root: str, workload: str, spec: dict, mix: Mix, seed: int, seconds: float,
             trace: bool, per_layer: List[str], limits: Optional[dict], t_start: float,
             device: str = "cuda", min_batches: int = 1, readings: Sequence[str] = ()) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``min_batches`` and ``readings`` serve ``calibrate.py``: a window of
    at least that many batches, and further readings of the same sample
    (``READINGS``)."""
    from repro_torch.runtime import ContinuousBatchingServer, Request, ServingConfig
    from repro_torch.runtime.telemetry import TelemetryConfig

    dev = torch.device(device)
    cfg = model_config(spec)
    params = draw_params(cfg, seed, dev)
    tel = TelemetryConfig(enabled=trace, trace=trace, sync_device=trace)
    srv = ContinuousBatchingServer(
        cfg, params, ServingConfig(n_slots=mix.n_slots, max_len=mix.max_len,
                                   default_level=mix.rung, telemetry=tel), device=dev)
    recorder = _GroupedRecorder() if trace else None
    try:
        srv.serve([Request(rid=srv.next_rid(), prompt=p, max_new=n, level=mix.rung)
                   for p, n in mix.warmup(seed, cfg.vocab)])
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        run = Run(spec=spec, mix=mix, batches=[])
        finished = []          # (prompt, served tokens, asked, reason)
        served_batches = []    # per batch: (prompt, served tokens) in submission order
        b = 0
        prof_out = None
        while True:
            batch = mix.batch(seed, b, cfg.vocab)
            reqs = [Request(rid=srv.next_rid(), prompt=p, max_new=n, level=mix.rung)
                    for p, n in batch]
            profiled = trace and b == 1
            before = srv.metrics_snapshot() if trace else None
            t0 = time.perf_counter()
            if profiled:
                prof_out = _profiled_serve(srv, reqs, recorder, dev)
                fins = prof_out["fins"]
            else:
                fins = srv.serve(reqs)
            _sync(dev)
            wall = time.perf_counter() - t0
            after = srv.metrics_snapshot() if trace else None
            served = []
            for r in reqs:
                f = fins[r.rid]
                toks = list(f.tokens[len(r.prompt):])
                finished.append((r.prompt, toks, r.max_new, f.reason))
                served.append((len(r.prompt), len(toks)))
            served_batches.append([(r.prompt, finished[-len(reqs) + j][1])
                                   for j, r in enumerate(reqs)])
            run.batches.append(Batch(served, wall, profiled, before, after))
            b += 1
            if (time.perf_counter() - t_window >= seconds and b >= min_batches
                    and (not trace or b >= 2)):
                break
        _sync(dev)
        window_s = time.perf_counter() - t_window
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
        run.window_peak_bytes = peak
        snap = srv.metrics_snapshot()
        if prof_out is not None:
            run.trace = prof_out["trace"]
            run.grouped_calls = recorder.host_calls()
    finally:
        if recorder is not None:
            recorder.close()

    attempted = len(finished)
    failed = sum(len(s) != n or reason != "max_new" for _, s, n, reason in finished)
    escalations = int(sum(v for k, v in snap.get("arbiter_switches_total", {}).items()
                          if "arbiter=serve" in k))
    tokens = sum(len(s) for _, s, _, _ in finished)
    metrics: Dict[str, dict] = {}
    if not trace:
        metrics["output_tokens_per_s"] = {"value": tokens / window_s, "unit": "tokens/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        for name, unit in per_layer:
            v = load_reader(root, name)(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}

    # the check: the program's state freed first, the weights kept
    del srv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gap = check_served(spec, params, served_batches, seed, mix.check_tokens, mix.n_slots,
                       readings)
    check_s = time.perf_counter() - t_check

    checks = check.compare(gap, limits)
    checks["failed_requests"] = {"value": failed, "limit": 0}
    checks["rung_escalations"] = {"value": escalations, "limit": 0}
    correct = bool(limits) and all(c["value"] is not None and c["limit"] is not None
                                   and c["value"] <= c["limit"] for c in checks.values())
    device_rec: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": attempted, "failed": failed,
                           "metrics": metrics, "device": device_rec}
    if trace and run.trace is not None:
        device_rec["busy_s"] = run.trace.busy_s()
        device_rec["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": [[n, s] for n, s in run.trace.top_ops(10)],
                            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps()[:10]]}
        walls = [bt.wall_s for bt in run.unprofiled()]
        out["trace_cost"] = {"profiled_batch_s": prof_out["wall_s"],
                             "unprofiled_batch_s": walls,
                             "profile_read_s": prof_out["read_s"],
                             "launch_matched": run.trace.launch_matched,
                             "device_ops": len(run.trace.ops)}
    out["window"] = {"seconds": window_s, "batches": len(run.batches), "tokens": tokens,
                     "batch_s": [bt.wall_s for bt in run.batches],
                     "setup_s": setup_s, "check_s": check_s, "checked": gap["checked"],
                     "gap_summary": gap.get("program"),
                     "checked_tokens": gap["tokens"], "workload": workload, "seed": seed,
                     "card": _card() if dev.type == "cuda" else "cpu"}
    if readings:
        out["readings"] = {"program": gap["program"]}
        for r in readings:
            out["readings"][r] = gap[r]["summary"]
            out["readings"][r + "_checks"] = check.compare(gap[r], limits)
    out["checks"] = checks
    return out


def _profiled_serve(srv, reqs, recorder, dev) -> dict:
    """Serve one batch under ``torch.profiler``, with the two marks that
    tie the server tracer's clock to the profiler's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace as trace_mod

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    tracer = srv.telemetry.tracer
    recorder.calls.clear()
    with profile(activities=acts) as prof:
        with record_function(trace_mod.MARK_START):
            t_mark0 = tracer.now_us()
        t0 = time.perf_counter()
        recorder.on = True
        fins = srv.serve(reqs)
        _sync(dev)
        recorder.on = False
        wall = time.perf_counter() - t0
        with record_function(trace_mod.MARK_END):
            t_mark1 = tracer.now_us()
    t1 = time.perf_counter()
    tr = trace_mod.read(prof, (t_mark0, t_mark1), srv.telemetry.trace_export()["traceEvents"])
    return {"fins": fins, "trace": tr, "wall_s": wall, "read_s": time.perf_counter() - t1}


#: further readings of a check's sample: the control (the reference at
#: int4 in the program's place) and a witness (the reference with its
#: rotary phases moved by K3's CORDIC error, 1.4e-4 rad), each read as the
#: int8 reference's gaps of the tokens it puts first
READINGS = {"control": {"bits": 4}, "witness": {"bits": 8, "rope_jitter": 1.4e-4}}


def check_served(spec: dict, params: dict, batches, seed: int, tokens: int, n_slots: int,
                 readings: Sequence[str] = ()) -> dict:
    """The gaps of the served tokens of a sample of whole batches under
    the reference (``widest`` None when nothing was served): ``gaps``
    all of them, ``decoded`` each request's but its first.  For each of
    ``readings`` (keys of ``READINGS``) the same for the tokens that
    reading puts first on the same sequences.  ``batches``: per batch,
    its requests in submission order as (prompt, served tokens)."""
    from portbench.reference import ReferenceDecoder

    picked = check.draw_batches([sum(len(s) for _, s in b) for b in batches], seed, tokens)
    out = {"widest": None, "checked": 0, "tokens": 0}
    if not picked:
        return out
    ref = ReferenceDecoder(spec, params, bits=8)
    others = {r: ReferenceDecoder(spec, params, **READINGS[r]) for r in readings}
    gaps = []
    other_gaps = {r: [] for r in readings}
    for i in picked:
        reqs = batches[i]
        logits = ref.batch_logits(reqs, n_slots)
        gaps += check.token_gaps(logits, [s for _, s in reqs])
        for r, dec in others.items():
            other_gaps[r] += check.token_gaps(
                logits, check.control_tokens(dec.batch_logits(reqs, n_slots)))
        del logits
        out["checked"] += len(reqs)
        out["tokens"] += sum(len(s) for _, s in reqs)
    out.update(_gap_sets(gaps))
    out["program"] = out.pop("summary")
    for r in readings:
        out[r] = _gap_sets(other_gaps[r])
    return out


def _gap_sets(per_request: List[torch.Tensor]) -> dict:
    """All gaps, the decoded ones (each request's but its first), the
    widest, and a summary of both sets."""
    gaps = torch.cat(per_request)
    decoded = torch.cat([g[1:] for g in per_request])
    summ = {"all": check.summary([gaps])}
    if decoded.numel():
        summ["decoded"] = check.summary([decoded])
    return {"gaps": gaps, "decoded": decoded, "widest": float(gaps.max()), "summary": summ}


def forbidden_modules(names=None) -> List[str]:
    """The top-level names of ``FORBIDDEN`` among the loaded modules
    (``names``, by default ``sys.modules``), each compared whole."""
    loaded = list(sys.modules) if names is None else list(names)
    return sorted({m.split(".")[0] for m in loaded} & set(FORBIDDEN))
