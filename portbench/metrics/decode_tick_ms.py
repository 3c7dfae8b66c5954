"""decode_tick_ms (ms), the model step: the server's synchronised
``tick_seconds`` summed over its phases (host schedule, device dispatch
ended by a barrier, sync and eviction), over ``decode_ticks_total``, on
the batches that were not profiled."""


def _sum(snap):
    return sum(s["sum"] for s in snap.get("tick_seconds", {}).values())


def read(run):
    secs = ticks = 0.0
    for b in run.unprofiled():
        if b.before is None:
            continue
        secs += _sum(b.after) - _sum(b.before)
        ticks += b.after.get("decode_ticks_total", 0) - b.before.get("decode_ticks_total", 0)
    if ticks == 0 or secs <= 0:
        return None
    return secs / ticks * 1e3
