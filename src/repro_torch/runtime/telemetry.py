"""Runtime telemetry: metrics registry, per-request tracing, and the
decode-tick profiler — the observability layer the serving stack
reports through (see docs/observability.md for the metric catalogue
and span taxonomy).

Reference: ``src/repro/runtime/telemetry.py`` (stdlib only), kept as a
near-copy so the port never imports the JAX package.  In the port,
``sync_device`` barriers are ``torch.cuda.synchronize`` calls.

Zero dependencies beyond the stdlib, and a two-tier overhead contract:

* the **registry tier** (counters / gauges / histograms) is ALWAYS on.
  Its hot-path cost is one dict update per event — the same plain host
  integer increments the serving stack already paid for its ad-hoc
  counting hooks (``stats`` dicts, ``_chunk_traces``,
  ``QuantizedWeightCache.quantize_calls``), which this module now
  hosts as first-class metrics;
* the **profiler tier** (the span tracer and the per-tick phase
  histograms) is gated on :class:`TelemetryConfig` ``enabled``.
  Disabled (the default) it contributes *nothing*: no ``perf_counter``
  calls, no span objects, and — the contract the async decode path
  depends on — **no host syncs**.  Even enabled, device timing stays
  async unless ``sync_device=True`` explicitly opts into the
  device barriers that split device time from host time
  (the profiling mode, never the serving default).

Three export surfaces:

* ``registry.snapshot()`` — nested dict (embedded in every
  ``BENCH_*.json`` by ``benchmarks/run.py --json``);
* ``render_prometheus()`` — Prometheus text exposition format
  (``launch/serve.py --metrics-out``);
* ``Tracer.export()`` — Chrome ``trace_event`` JSON
  (``launch/serve.py --trace-out``), viewable in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "TelemetryConfig",
    "Telemetry",
    "render_prometheus",
    "DEFAULT_TIME_BUCKETS",
]

#: default histogram buckets for wall-clock phases (seconds): decode
#: ticks on smoke models land around 1-50 ms; real deployments at the
#: tail.  Cumulative ``le`` semantics at render time, +Inf implicit.
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labelnames: Tuple[str, ...], labels: Dict[str, Any]) -> Tuple[str, ...]:
    """Canonical child key: label VALUES in declaration order.  Every
    declared label must be supplied, no extras — a typo'd label name
    would otherwise silently fork a new time series."""
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared labelnames {sorted(labelnames)}"
        )
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_labels(labelnames: Tuple[str, ...], key: Tuple[str, ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(labelnames, key)) + list(extra)
    if not pairs:
        return ""
    def esc(v: str) -> str:
        return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
    return "{" + ",".join(f'{n}="{esc(v)}"' for n, v in pairs) + "}"


class _Metric:
    """Base: one named metric family holding per-label-tuple children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        return _label_key(self.labelnames, labels)


class Counter(_Metric):
    """Monotonic counter.  ``inc(n, **labels)`` on the hot path;
    ``value(**labels)`` reads (0 for a never-incremented child)."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        k = self._key(labels)
        self._values[k] = self._values.get(k, 0) + n

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0)

    def total(self) -> float:
        """Sum over every label combination."""
        return sum(self._values.values())

    def collect(self):
        return dict(self._values)


class Gauge(_Metric):
    """Point-in-time value; ``set`` / ``inc`` / ``dec``."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, v: float, **labels) -> None:
        self._values[self._key(labels)] = float(v)

    def inc(self, n: float = 1, **labels) -> None:
        k = self._key(labels)
        self._values[k] = self._values.get(k, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0)

    def collect(self):
        return dict(self._values)


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus ``le`` semantics).  Bucket
    counts are stored per-bucket and cumulated at render time, so
    ``observe`` is one bisect + three dict updates."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"histogram {self.name}: need at least one bucket")
        self.buckets = b
        # per label key: [bucket_counts list, sum, count]
        self._series: Dict[Tuple[str, ...], list] = {}

    def observe(self, v: float, **labels) -> None:
        k = self._key(labels)
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = [[0] * (len(self.buckets) + 1), 0.0, 0]
        counts, _, _ = s
        lo, hi = 0, len(self.buckets)
        while lo < hi:  # first bucket with le >= v
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        counts[lo] += 1
        s[1] += v
        s[2] += 1

    def snapshot_series(self, key: Tuple[str, ...]) -> dict:
        counts, total, n = self._series[key]
        cum, acc = {}, 0
        for le, c in zip(self.buckets, counts[:-1]):
            acc += c
            cum[repr(le)] = acc
        cum["+Inf"] = acc + counts[-1]
        return {"count": n, "sum": total, "buckets": cum}

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return s[2] if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return s[1] if s else 0.0

    def collect(self):
        return {k: self.snapshot_series(k) for k in self._series}


class MetricsRegistry:
    """Name -> metric family, get-or-create.  Re-registering a name
    returns the existing family; a kind/label mismatch raises (two
    subsystems silently sharing a name under different schemas is a
    bug, not a merge)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                    f"{m.labelnames}, requested {cls.kind}{tuple(labelnames)}"
                )
            return m
        m = cls(name, help, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def __iter__(self):
        return iter(self._metrics.values())

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """Nested dict of every metric: unlabeled scalars flatten to
        ``{name: value}``; labeled families map a ``k=v,...`` label
        string to the value; histograms expose
        ``{count, sum, buckets}``."""
        out: Dict[str, Any] = {}
        for m in self:
            if isinstance(m, Histogram):
                series = {",".join(f"{n}={v}" for n, v in zip(m.labelnames, k))
                          or "": s for k, s in m.collect().items()}
                out[m.name] = series
                continue
            vals = m.collect()
            if not m.labelnames:
                out[m.name] = vals.get((), 0)
            else:
                out[m.name] = {
                    ",".join(f"{n}={v}" for n, v in zip(m.labelnames, k)): val
                    for k, val in vals.items()
                }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for m in self:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for key in sorted(m.collect()):
                    s = m.snapshot_series(key)
                    for le, c in s["buckets"].items():
                        lab = _fmt_labels(m.labelnames, key, (("le", le),))
                        lines.append(f"{m.name}_bucket{lab} {c}")
                    lines.append(
                        f"{m.name}_sum{_fmt_labels(m.labelnames, key)} {s['sum']}")
                    lines.append(
                        f"{m.name}_count{_fmt_labels(m.labelnames, key)} {s['count']}")
                continue
            vals = m.collect()
            if not vals and not m.labelnames:
                vals = {(): 0}
            for key in sorted(vals):
                v = vals[key]
                v = int(v) if float(v).is_integer() else v
                lines.append(f"{m.name}{_fmt_labels(m.labelnames, key)} {v}")
        return "\n".join(lines) + "\n"


def render_prometheus(registry: MetricsRegistry) -> str:
    """Module-level alias for :meth:`MetricsRegistry.render_prometheus`."""
    return registry.render_prometheus()


# ---------------------------------------------------------------------------
# tracer: Chrome trace_event JSON
# ---------------------------------------------------------------------------


class _NullSpan:
    """The disabled-path span: a reusable no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span recorder exporting Chrome ``trace_event`` JSON.

    Event kinds used (see docs/observability.md for the taxonomy):

    * ``X`` complete spans — ``span()`` context manager (``ts``/``dur``
      in microseconds since tracer start);
    * ``b``/``e`` async-nestable pairs — request lifecycles that span
      many ticks and migrate between slots (``async_begin`` /
      ``async_end``, correlated by ``cat`` + ``id``);
    * ``i`` instants — point events (arbiter switches);
    * ``M`` metadata — thread names (``thread_name``).

    Bounded: past ``max_events`` new events are counted in ``dropped``
    instead of stored (a long-lived server must not grow host memory
    with lifetime traffic).
    """

    PID = 1

    def __init__(self, max_events: int = 200_000):
        if max_events < 1:
            raise ValueError("max_events must be >= 1")
        self.max_events = max_events
        self.events: List[dict] = []
        self.dropped = 0
        self._t0 = time.perf_counter_ns()
        self._names: Dict[int, str] = {}

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    @contextmanager
    def span(self, name: str, tid: int = 0, cat: str = "serve",
             args: Optional[dict] = None):
        t0 = self.now_us()
        try:
            yield self
        finally:
            ev = {"name": name, "cat": cat, "ph": "X", "pid": self.PID,
                  "tid": tid, "ts": t0, "dur": self.now_us() - t0}
            if args:
                ev["args"] = args
            self._emit(ev)

    def instant(self, name: str, tid: int = 0, cat: str = "serve",
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "pid": self.PID, "tid": tid, "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_begin(self, name: str, id: int, tid: int = 0,
                    cat: str = "request", args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "b", "id": id,
              "pid": self.PID, "tid": tid, "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_end(self, name: str, id: int, tid: int = 0,
                  cat: str = "request", args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "e", "id": id,
              "pid": self.PID, "tid": tid, "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def thread_name(self, tid: int, name: str) -> None:
        if self._names.get(tid) == name:
            return
        self._names[tid] = name
        self._emit({"name": "thread_name", "ph": "M", "pid": self.PID,
                    "tid": tid, "args": {"name": name}})

    def export(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)


# ---------------------------------------------------------------------------
# config + facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TelemetryConfig:
    """Profiler-tier knobs (the registry tier is always on).

    ``enabled`` gates EVERYTHING below — disabled (the default) the
    serving loop takes no timestamps, records no spans, and adds no
    host syncs (pinned by tests/test_telemetry.py).

    ``trace`` collects the per-request span tree (Chrome trace_event).
    ``sync_device`` inserts device barriers after the
    decode dispatch so the ``device_dispatch`` phase measures actual
    device time instead of async dispatch time — a profiling mode that
    DOES add per-tick syncs; never the serving default.
    """

    enabled: bool = False
    trace: bool = True
    trace_max_events: int = 200_000
    sync_device: bool = False
    tick_buckets: Tuple[float, ...] = DEFAULT_TIME_BUCKETS

    def __post_init__(self):
        if self.trace_max_events < 1:
            raise ValueError("trace_max_events must be >= 1")
        if self.sync_device and not self.enabled:
            raise ValueError("sync_device requires enabled=True")
        if not self.tick_buckets:
            raise ValueError("tick_buckets must be non-empty")


class Telemetry:
    """One registry + (optionally) one tracer, behind no-op guards.

    The serving stack holds exactly one of these per server; hot paths
    call ``span``/``instant``/``async_*`` unconditionally (no-ops when
    disabled) and guard *timestamp* work behind ``if telemetry.on:``.
    """

    def __init__(self, config: Optional[TelemetryConfig] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.config = config if config is not None else TelemetryConfig()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer: Optional[Tracer] = (
            Tracer(self.config.trace_max_events)
            if (self.config.enabled and self.config.trace) else None
        )

    @property
    def on(self) -> bool:
        """True when the profiler tier (timestamps + spans) is active."""
        return self.config.enabled

    # -- tracer passthroughs (no-ops when tracing is off) -------------------

    def span(self, name: str, tid: int = 0, cat: str = "serve",
             args: Optional[dict] = None):
        if self.tracer is None:
            return _NULL_SPAN
        return self.tracer.span(name, tid=tid, cat=cat, args=args)

    def instant(self, name: str, tid: int = 0, cat: str = "serve",
                args: Optional[dict] = None) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, tid=tid, cat=cat, args=args)

    def async_begin(self, name: str, id: int, tid: int = 0,
                    args: Optional[dict] = None) -> None:
        if self.tracer is not None:
            self.tracer.async_begin(name, id=id, tid=tid, args=args)

    def async_end(self, name: str, id: int, tid: int = 0,
                  args: Optional[dict] = None) -> None:
        if self.tracer is not None:
            self.tracer.async_end(name, id=id, tid=tid, args=args)

    def thread_name(self, tid: int, name: str) -> None:
        if self.tracer is not None:
            self.tracer.thread_name(tid, name)

    # -- exports ------------------------------------------------------------

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()

    def trace_export(self) -> dict:
        if self.tracer is None:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "otherData": {"dropped_events": 0}}
        return self.tracer.export()

    def write_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.trace_export(), f)
