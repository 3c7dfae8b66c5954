"""device_idle_pct (%), the device: 100 x (1 - busy / wall) over the
profiled batch, busy being the union of the device operations' times in
the profiler's trace and wall the time between the two window marks."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
