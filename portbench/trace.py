"""Reading a ``torch.profiler`` trace of one served batch against the
server's own spans.

The traced run profiles one whole ``serve()`` call.  Two marks, user
annotations taken inside the profiler at its start and end, carry the
server tracer's clock (``Tracer.now_us``), so the tracer's spans
(``admit``, ``decode-tick``, ``level-pass``) can be laid on the
profiler's timeline.  One CUDA stream runs everything, so device
operations do not overlap; busy time is the union of their intervals
all the same.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

MARK_START = "portbench.window_start"
MARK_END = "portbench.window_end"

#: host calls that put an operation on the device
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaMemcpy", "cudaMemset", "cudaMemcpy2DAsync", "cudaMemcpyPeerAsync")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    launch_ns: Optional[int]   # host time of the call that launched it


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    args: dict


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]          # profiler clock, ns
    ops: List[DeviceOp]
    spans: List[Span]
    launch_matched: float            # share of device ops whose launch was found

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Union of the device operations' intervals inside the window."""
        return sum(b - a for a, b in self.merged()) / 1e9

    def merged(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        iv = sorted((max(o.start_ns, lo), min(o.start_ns + o.dur_ns, hi)) for o in self.ops)
        out: List[List[int]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def ops_matching(self, pattern) -> List[DeviceOp]:
        return [o for o in self.ops if pattern.search(o.name)]

    def launched_within(self, spans: Sequence[Span]) -> int:
        """Device operations launched inside any of ``spans`` (by the host
        time of their launch; an operation whose launch was not found is
        placed by its device start, which under the traced run's device
        barriers lies inside the span that launched it)."""
        iv = sorted((s.start_ns, s.end_ns) for s in spans)
        starts = [a for a, _ in iv]
        n = 0
        for o in self.ops:
            t = o.launch_ns if o.launch_ns is not None else o.start_ns
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                n += 1
        return n

    def idle_gaps(self, names=("admit", "decode-tick", "level-pass", "prefill-chunk")
                  ) -> List[Tuple[str, float]]:
        """Device idle time inside the window, summed by the innermost
        server span that encloses each gap's middle ("none" outside them),
        longest first (seconds)."""
        lo, hi = self.window
        merged = self.merged()
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        spans = [s for s in self.spans if s.name in names]
        # the innermost span of each piece between consecutive span edges
        cuts = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
        labels = []
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = [s for s in spans if s.start_ns <= mid <= s.end_ns]
            labels.append(min(inner, key=lambda s: s.end_ns - s.start_ns).name
                          if inner else "none")
        out: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            i = bisect.bisect_right(cuts, (a + b) / 2) - 1
            out[labels[i] if 0 <= i < len(labels) else "none"] += (b - a) / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by[short_name(o.name)] += o.dur_ns / 1e9
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def short_name(name: str) -> str:
    """A kernel's name without its parameter list, at most 120 characters."""
    base = name.split("(")[0].strip()
    if base.startswith("void "):
        base = base[5:]
    return base[:120]


def read(prof, mark_us: Tuple[float, float], tracer_events: Sequence[dict]) -> Trace:
    """Build a :class:`Trace` from a finished profiler, the tracer times
    read inside the two marks, and the tracer's exported events."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    marks: Dict[str, int] = {}
    runtime: Dict[int, int] = {}
    raw = []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            raw.append((name, e.start_ns(), e.duration_ns(), e.correlation_id(),
                        e.linked_correlation_id()))
        elif name in (MARK_START, MARK_END):
            marks[name] = e.start_ns()
        elif name in LAUNCHES:
            runtime[e.correlation_id()] = e.start_ns()
    if MARK_START not in marks or MARK_END not in marks:
        raise RuntimeError("the profiler recorded no window marks")
    lo, hi = marks[MARK_START], marks[MARK_END]
    offset = lo - int(mark_us[0] * 1e3)

    # which id of a device op names its launch: take the one that matches more
    by_corr = sum(r[3] in runtime for r in raw)
    by_link = sum(r[4] in runtime for r in raw)
    key = 3 if by_corr >= by_link else 4
    ops, matched = [], 0
    for r in raw:
        if not lo <= r[1] <= hi:
            continue
        launch = runtime.get(r[key])
        matched += launch is not None
        ops.append(DeviceOp(r[0], r[1], r[2], launch))
    spans = []
    for ev in tracer_events:
        if ev.get("ph") != "X":
            continue
        a = int(ev["ts"] * 1e3) + offset
        b = a + int(ev["dur"] * 1e3)
        if b >= lo and a <= hi:
            spans.append(Span(ev["name"], a, b, dict(ev.get("args") or {})))
    return Trace(window=(lo, hi), ops=ops, spans=spans,
                 launch_matched=matched / len(ops) if ops else 0.0)
