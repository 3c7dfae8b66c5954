"""prefill_ms_per_ktok (ms/ktok), the model step: the server's
synchronised ``prefill_seconds`` (each admission's prefill, ended by a
device barrier in the traced run) summed over the batches that were not
profiled, per thousand prompt tokens."""


def _sum(snap):
    return sum(s["sum"] for s in snap.get("prefill_seconds", {}).values())


def read(run):
    secs = tokens = 0.0
    for b in run.unprofiled():
        if b.before is None:
            continue
        secs += _sum(b.after) - _sum(b.before)
        tokens += sum(p for p, _ in b.requests)
    if tokens == 0 or secs <= 0:
        return None
    return secs / tokens * 1e6
