"""device_ops_per_tick (ops/tick), the serving loop: device operations
launched inside the server's ``decode-tick`` spans of the profiled batch
(the profiler's launches laid on the tracer's spans by host time), over
the number of those ticks."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ticks = tr.spans_named("decode-tick")
    if not ticks:
        return None
    return tr.launched_within(ticks) / len(ticks)
