"""Serving driver: batched generation with runtime precision modes.

Reference: ``src/repro/launch/serve.py`` — ``build_parser``,
``serving_config_from_args``, ``_write_outputs`` and ``main``, with one
flag more, ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b --continuous \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_7b \
        --continuous --paged --prefix-sharing --device cpu \
        --metrics-out metrics.prom --trace-out trace.json

``--continuous`` runs the continuous-batching engine (per-request
precision via ``--levels``) on a mixed-length/mixed-budget workload;
the default runs the static lock-step ``BatchedServer``.  Both routes
build ONE :class:`~repro_torch.runtime.config.ServingConfig` — assembled by
:func:`serving_config_from_args`, which is what
tests/test_torch_serve_cli.py pins: every cache/telemetry flag must round-trip
into a validated config.  ``--continuous --speculative`` serves every
request through ladder-speculative decoding (draft at ``--draft-level``,
verify at f32 — output identical to vanilla f32 greedy; watch
``spec_rounds`` / ``spec_accepted`` in the printed stats).  ``--paged``
switches the cache pool to fixed-size pages + block tables with chunked
prefill (``--prefill-chunk`` tokens per fixed-shape segment); add
``--prefix-sharing`` to share full prefix pages between requests
(full-context attention models only).

Telemetry outputs: ``--metrics-out FILE``
writes the Prometheus text exposition after serving; ``--trace-out
FILE`` writes the Chrome ``trace_event`` JSON (open in Perfetto).
Either flag turns the profiler tier on for the run.
"""

from __future__ import annotations

import argparse

MAX_LEN = 128


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="precise", choices=["precise", "fast"])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine instead of the static server")
    ap.add_argument("--slots", type=int, default=2,
                    help="device batch slots for --continuous")
    ap.add_argument("--levels", default=None,
                    help="comma list of per-request ladder levels for --continuous "
                         "(cycled over requests; e.g. 'q16_16,f32')")
    ap.add_argument("--speculative", action="store_true",
                    help="with --continuous: serve every request in "
                         "ladder-speculative mode (draft at --draft-level, "
                         "verify at f32 — output identical to vanilla f32)")
    ap.add_argument("--draft-level", default="q16_16", choices=["q8_8", "q16_16"],
                    help="draft rung for --speculative")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft tokens per speculative round")
    ap.add_argument("--paged", action="store_true",
                    help="with --continuous: paged cache pool + chunked prefill")
    ap.add_argument("--page-size", type=int, default=16,
                    help="cache rows per page for --paged")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill segment length (default: page size)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="with --paged: share full prefix pages across requests")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="total pages in the full-length pool (default: sized "
                         "to the slot count)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the Prometheus metrics exposition here after "
                         "serving (enables telemetry)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the Chrome trace_event JSON here after serving "
                         "(enables telemetry + tracing; open in Perfetto)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def serving_config_from_args(args):
    """The one flags -> :class:`ServingConfig` mapping (validated by
    the config's own ``__post_init__``)."""
    from repro_torch.runtime.config import ServingConfig
    from repro_torch.runtime.speculative import SpeculativeConfig
    from repro_torch.runtime.telemetry import TelemetryConfig

    spec = (
        SpeculativeConfig(k=args.spec_k, draft_level=args.draft_level,
                          max_len=MAX_LEN)
        if args.speculative else None
    )
    telemetry = TelemetryConfig(
        enabled=bool(args.metrics_out or args.trace_out),
        trace=bool(args.trace_out),
    )
    return ServingConfig(
        n_slots=args.slots, max_len=MAX_LEN, speculative=spec,
        cache="paged" if args.paged else "contiguous",
        page_size=args.page_size, prefill_chunk=args.prefill_chunk,
        prefix_sharing=args.prefix_sharing, n_pages=args.n_pages,
        telemetry=telemetry,
    )


def _write_outputs(srv, args) -> None:
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(srv.render_prometheus())
        print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        srv.telemetry.write_trace(args.trace_out)
        print(f"trace   -> {args.trace_out}")


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.configs import smoke
    from repro_torch.core.precision import Mode
    from repro_torch.models import init_params
    from repro_torch.runtime.config import ServingConfig
    from repro_torch.runtime.scheduler import Request
    from repro_torch.runtime.serve import BatchedServer, ContinuousBatchingServer

    cfg = smoke(args.arch)
    params = init_params(cfg, seed=0, device=args.device)
    prompts = [[1, 2, 3, 4, 5], [10, 11, 12], [7, 7, 7, 7], [3, 1, 4, 1, 5, 9]]

    if args.continuous:
        srv = ContinuousBatchingServer(cfg, params, serving_config_from_args(args),
                                       device=args.device)
        levels = args.levels.split(",") if args.levels else [None]
        reqs = [
            Request(rid=srv.next_rid(), prompt=p, max_new=args.max_new + 4 * (i % 2),
                    level=levels[i % len(levels)],
                    speculative=args.speculative)
            for i, p in enumerate(prompts)
        ]
        fins = srv.serve(reqs)
        for r in reqs:
            f = fins[r.rid]
            print(f"req{r.rid} [{r.level or 'default'}] ({f.reason}): {f.tokens}")
        print(f"stats: {srv.stats}")
        if args.paged:
            print(f"pages: {srv.cache_ops.report()}")
        _write_outputs(srv, args)
        return

    from repro_torch.runtime.telemetry import TelemetryConfig

    srv = BatchedServer(
        cfg, params,
        ServingConfig(n_slots=4, max_len=MAX_LEN, max_new=args.max_new,
                      default_level=Mode(args.mode),
                      telemetry=TelemetryConfig(
                          enabled=bool(args.metrics_out or args.trace_out),
                          trace=bool(args.trace_out))),
        device=args.device,
    )
    for i, seq in enumerate(srv.generate(prompts)):
        print(f"req{i}: {seq}")
    if args.metrics_out or args.trace_out:
        print("note: --metrics-out/--trace-out apply to --continuous; "
              "static-server metrics are limited to the weight cache")
        _write_outputs(srv, args)


if __name__ == "__main__":
    main()
