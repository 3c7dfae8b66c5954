"""g1g2_roofline (%), the MoE block: the least time of the grouped
expert calls of the profiled batch (G2 ``fused_swiglu_grouped``, G1
``qmatmul_grouped``), each counted from its shapes, its live rows and its
live experts (the ``rows`` the call received), over the device time of
the grouped kernel (``grouped_tc``) in its trace."""

import re

from portbench.roofline import grouped
from portbench.roofline.peaks import least_s

KERNELS = re.compile(r"\bgrouped_tc\b")


def read(run):
    tr = run.trace
    if tr is None or not run.grouped_calls:
        return None
    busy = sum(o.dur_ns for o in tr.ops_matching(KERNELS)) / 1e9
    if busy <= 0:
        return None
    least = 0.0
    for kind, xs, ws, rows in run.grouped_calls:
        g, m, k = xs
        n = ws[2]
        if rows is None:
            live_r, live_e = g * m, g
        else:
            live_r, live_e = int(rows.sum()), int((rows.sum(axis=1) > 0).sum())
        if kind == "g2":
            least += least_s(grouped.g2_bytes(g, m, k, n, live_r, live_e),
                             grouped.g2_ops(live_r, k, n), "int8")
        else:
            least += least_s(grouped.g1_bytes(g, m, k, n, live_r, live_e),
                             grouped.g1_ops(live_r, k, n), "int8")
    return 100.0 * least / busy
