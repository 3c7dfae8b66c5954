"""The port's telemetry (``repro_torch.runtime.telemetry``, a near-copy
of ``src/repro/runtime/telemetry.py``) and its wiring into the port's
``ContinuousBatchingServer``, mirroring tests/test_telemetry.py case for
case on the smoke gemma2_2b model on the CPU:

* registry and tracer units (counters and labels, kind and label
  mismatch, gauges, cumulative histogram buckets, the Prometheus
  exposition, snapshot shapes, spans and async events, the bounded event
  buffer, config validation);
* (a) the exported span tree reconciles with the server's stats on a
  paged mixed workload and on a speculative one;
* (b) the exported trace is valid Chrome ``trace_event`` JSON;
* (c) disabled telemetry is inert: the same tokens and host syncs;
* (d) the weight-cache aliases delegate to the registry.  The
  reference's retrace-counter test has no counterpart to reproduce:
  eager torch traces nothing, so ``retrace_total`` stays registered (the
  metric catalogue is the reference's) and is never incremented —
  :func:`test_retrace_counter_stays_zero_in_eager_torch` holds that.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.runtime import ContinuousBatchingServer, Request, ServingConfig  # noqa: E402
from repro_torch.runtime.speculative import SpeculativeConfig  # noqa: E402
from repro_torch.runtime.telemetry import (  # noqa: E402
    MetricsRegistry,
    TelemetryConfig,
    Tracer,
    render_prometheus,
)

MAX_LEN = 32
PROMPTS = [
    [1, 2, 3, 4, 5],
    [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17],
    [3, 1, 4],
]
BUDGETS = [4, 2, 6]   # mixed budgets: slot churn + eviction under test

_MODELS = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The smoke model's tensors are tiny: one intra-op thread serves them
    fastest beside the suite's other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch="gemma2-2b"):
    if arch not in _MODELS:
        cfg = smoke(arch)
        _MODELS[arch] = (cfg, init_params(cfg, seed=0, device="cpu"))
    return _MODELS[arch]


def _server(scfg):
    cfg, params = _model()
    return ContinuousBatchingServer(cfg, params, scfg, device="cpu")


def _requests(srv, speculative=False):
    return [
        Request(rid=srv.next_rid(), prompt=p, max_new=b,
                speculative=speculative)
        for p, b in zip(PROMPTS, BUDGETS)
    ]


def _spans(srv):
    """name -> count of complete (ph=X) spans in the exported trace."""
    counts = {}
    for ev in srv.telemetry.trace_export()["traceEvents"]:
        if ev["ph"] == "X":
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


# ---------------------------------------------------------------------------
# registry units
# ---------------------------------------------------------------------------


def test_counter_labels_and_totals():
    reg = MetricsRegistry()
    c = reg.counter("requests_total", "requests", labelnames=("reason",))
    c.inc(reason="eos")
    c.inc(3, reason="budget")
    assert c.value(reason="eos") == 1
    assert c.value(reason="budget") == 3
    assert c.value(reason="never") == 0
    assert c.total() == 4
    with pytest.raises(ValueError):
        c.inc(-1, reason="eos")


def test_registry_rejects_kind_and_label_mismatch():
    reg = MetricsRegistry()
    reg.counter("x_total", "x")
    with pytest.raises(ValueError):
        reg.gauge("x_total", "x")          # kind mismatch
    with pytest.raises(ValueError):
        reg.counter("x_total", "x", labelnames=("a",))  # label mismatch
    # get-or-create: same spec returns the same object
    assert reg.counter("x_total", "x") is reg.counter("x_total", "x")


def test_gauge_set_inc_dec():
    reg = MetricsRegistry()
    g = reg.gauge("depth", "queue depth")
    g.set(5)
    g.inc()
    g.dec(2)
    assert g.value() == 4


def test_histogram_cumulative_buckets():
    reg = MetricsRegistry()
    h = reg.histogram("lat", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    s = h.snapshot_series(())
    assert s["buckets"]["0.1"] == 1
    assert s["buckets"]["1.0"] == 3   # cumulative, not per-bucket
    assert s["buckets"]["10.0"] == 4
    assert s["buckets"]["+Inf"] == 5
    assert s["count"] == 5
    assert s["sum"] == pytest.approx(56.05)


def test_prometheus_exposition_format():
    reg = MetricsRegistry()
    reg.counter("ticks_total", "decode ticks").inc(7)
    reg.counter("fin_total", "finishes", labelnames=("reason",)).inc(reason="eos")
    reg.histogram("t_s", "seconds", buckets=(0.5,)).observe(0.25)
    text = render_prometheus(reg)
    assert "# TYPE ticks_total counter" in text
    assert "ticks_total 7" in text
    assert 'fin_total{reason="eos"} 1' in text
    assert 't_s_bucket{le="0.5"} 1' in text
    assert 't_s_bucket{le="+Inf"} 1' in text
    assert "t_s_count 1" in text


def test_snapshot_shapes():
    reg = MetricsRegistry()
    reg.counter("a_total", "a").inc(2)
    reg.counter("b_total", "b", labelnames=("k",)).inc(k="x")
    snap = reg.snapshot()
    assert snap["a_total"] == 2
    assert snap["b_total"] == {"k=x": 1}


# ---------------------------------------------------------------------------
# tracer units
# ---------------------------------------------------------------------------


def test_tracer_span_and_async_events():
    tr = Tracer()
    with tr.span("work", tid=2, args={"n": 3}):
        pass
    tr.async_begin("request", id=7, tid=1)
    tr.async_end("request", id=7, tid=1)
    tr.instant("switch", args={"slot": 0})
    tr.thread_name(2, "slot1")
    out = tr.export()
    evs = out["traceEvents"]
    x = [e for e in evs if e["ph"] == "X"]
    assert len(x) == 1 and x[0]["name"] == "work"
    assert x[0]["tid"] == 2 and x[0]["args"] == {"n": 3}
    assert x[0]["dur"] >= 0 and x[0]["ts"] >= 0
    assert [e["ph"] for e in evs if e.get("cat") == "request"] == ["b", "e"]
    assert out["displayTimeUnit"] == "ms"


def test_tracer_bounded_events():
    tr = Tracer(max_events=3)
    for i in range(10):
        tr.instant(f"i{i}")
    out = tr.export()
    assert len(out["traceEvents"]) == 3
    assert out["otherData"]["dropped_events"] == 7


def test_telemetry_config_validation():
    with pytest.raises(ValueError):
        TelemetryConfig(enabled=False, sync_device=True)


# ---------------------------------------------------------------------------
# (a) span tree reconciles with scheduler/decoder stats
# ---------------------------------------------------------------------------


def test_span_tree_reconciles_paged_mixed_workload():
    srv = _server(ServingConfig(n_slots=2, max_len=MAX_LEN, cache="paged", page_size=4,
                                telemetry=TelemetryConfig(enabled=True, trace=True)))
    reqs = _requests(srv)
    fins = srv.serve(reqs)
    assert sorted(fins) == sorted(r.rid for r in reqs)

    spans = _spans(srv)
    st = srv.stats
    assert spans.get("admit", 0) == st["prefills"] == len(reqs)
    assert spans.get("prefill-chunk", 0) == st["prefill_chunks"] > 0
    assert spans.get("decode-tick", 0) == st["decode_steps"] > 0
    assert spans.get("level-pass", 0) == st["level_passes"] > 0

    # request lifecycles: one b/e pair per request, ids == rids
    evs = srv.telemetry.trace_export()["traceEvents"]
    begins = [e["id"] for e in evs if e.get("cat") == "request" and e["ph"] == "b"]
    ends = [e["id"] for e in evs if e.get("cat") == "request" and e["ph"] == "e"]
    assert sorted(begins) == sorted(ends) == sorted(r.rid for r in reqs)

    # the snapshot agrees with the stats view of the same registry
    snap = srv.metrics_snapshot()
    assert snap["decode_ticks_total"] == st["decode_steps"]
    assert snap["prefills_total"] == st["prefills"]
    assert snap["tokens_generated_total"] == sum(f.n_generated for f in fins.values())
    assert snap["requests_finished_total"] == {"reason=max_new": len(reqs)}


def test_span_tree_reconciles_speculative_workload():
    srv = _server(ServingConfig(n_slots=2, max_len=MAX_LEN,
                                speculative=SpeculativeConfig(k=2, max_len=MAX_LEN),
                                telemetry=TelemetryConfig(enabled=True, trace=True)))
    fins = srv.serve(_requests(srv, speculative=True))
    assert len(fins) == len(PROMPTS)

    spans = _spans(srv)
    st = srv.stats
    assert st["spec_rounds"] > 0
    assert spans.get("spec-round", 0) == st["spec_rounds"]
    assert spans.get("draft", 0) == spans.get("verify", 0) == st["spec_rounds"]
    assert st["spec_drafted"] >= st["spec_accepted"] >= 0

    snap = srv.metrics_snapshot()
    assert snap["spec_rounds_total"] == st["spec_rounds"]
    assert snap["spec_drafted_total"] == st["spec_drafted"]
    assert snap["spec_accepted_total"] == st["spec_accepted"]


# ---------------------------------------------------------------------------
# (b) exported trace is valid Chrome trace_event JSON
# ---------------------------------------------------------------------------


def test_trace_export_is_valid_chrome_trace(tmp_path):
    srv = _server(ServingConfig(n_slots=2, max_len=MAX_LEN, cache="paged", page_size=4,
                                telemetry=TelemetryConfig(enabled=True, trace=True)))
    srv.serve(_requests(srv))

    path = tmp_path / "trace.json"
    srv.telemetry.write_trace(str(path))
    out = json.loads(path.read_text())  # round-trips through real JSON

    assert isinstance(out["traceEvents"], list) and out["traceEvents"]
    open_async = {}
    for ev in out["traceEvents"]:
        assert ev["ph"] in ("X", "b", "e", "i", "M")
        assert ev["pid"] == 1
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
        if ev["ph"] == "b":
            key = (ev["cat"], ev["id"])
            open_async[key] = open_async.get(key, 0) + 1
        if ev["ph"] == "e":
            key = (ev["cat"], ev["id"])
            open_async[key] = open_async.get(key, 0) - 1
    assert all(v == 0 for v in open_async.values()), "unbalanced async pairs"
    # thread-name metadata present for the engine lane
    names = [e["args"]["name"] for e in out["traceEvents"] if e["ph"] == "M"]
    assert "engine" in names


# ---------------------------------------------------------------------------
# (c) disabled telemetry: zero extra host syncs, bit-identical tokens
# ---------------------------------------------------------------------------


def test_disabled_telemetry_is_inert():
    def serve_with(enabled):
        srv = _server(ServingConfig(n_slots=2, max_len=MAX_LEN, cache="paged", page_size=4,
                                    telemetry=TelemetryConfig(enabled=enabled, trace=enabled)))
        fins = srv.serve(_requests(srv))
        return srv, [fins[r].tokens for r in sorted(fins)]

    srv_off, toks_off = serve_with(False)
    srv_on, toks_on = serve_with(True)

    # the profiler tier observes; it never changes what is served
    assert toks_on == toks_off

    # identical host-sync counts: spans and timers added no device pulls
    syncs_off = srv_off.metrics_snapshot().get("host_syncs_total", {})
    syncs_on = srv_on.metrics_snapshot().get("host_syncs_total", {})
    assert syncs_on == syncs_off
    # eviction syncs exactly once per finished request; no eos_id is set
    # so the only other sanctioned pull is the cadenced health sync
    assert syncs_off.get("kind=evict") == len(PROMPTS)
    assert set(syncs_off) <= {"kind=evict", "kind=health"}

    # disabled telemetry has no tracer; the export is empty but valid
    assert srv_off.telemetry.tracer is None
    assert srv_off.telemetry.trace_export()["traceEvents"] == []


# ---------------------------------------------------------------------------
# (d) no retraces in eager torch; weight-cache alias coherence
# ---------------------------------------------------------------------------


def test_retrace_counter_stays_zero_in_eager_torch():
    """The reference counts jit (re)traces of its step functions; the
    port's steps are eager, so the same two bursts (the second of other
    lengths) register ``retrace_total`` and never increment it, while the
    chunked prefill still runs a chunk per page of every prompt."""
    srv = _server(ServingConfig(n_slots=2, max_len=MAX_LEN, cache="paged", page_size=4,
                                prefill_chunk=4))
    srv.serve(_requests(srv))
    srv.serve([Request(rid=srv.next_rid(), prompt=p + [9], max_new=2) for p in PROMPTS])
    assert "retrace_total" in srv.telemetry.registry
    assert srv.telemetry.registry.get("retrace_total").total() == 0
    assert srv.stats["prefill_chunks"] == sum(-(-len(p) // 4) + -(-(len(p) + 1) // 4)
                                              for p in PROMPTS)


def test_weight_cache_aliases_delegate_to_registry():
    srv = _server(ServingConfig(n_slots=2, max_len=MAX_LEN))
    srv.serve(_requests(srv))
    wc = srv.engine.weight_cache
    snap = srv.metrics_snapshot()
    assert wc.quantize_calls == snap["weight_quantize_total"] > 0
    assert wc.hits == snap["weight_cache_hits_total"]
    assert wc.registry is srv.telemetry.registry
