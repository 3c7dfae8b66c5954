"""k1k2_roofline (%), the kernels: the least time of the dense K1 / K2
products the profiled batch needed, over the device time of the K1 / K2
kernels (``gemm_tc``, ``gemm_skinny``) in its trace.

The products are counted from the configuration for every admission
(M = its prompt length) and every decode tick (M = the tick's live
lanes, from the ``decode-tick`` span): the q, k, v, o projections and,
in a dense layer, the gate / up products and the down projection
(``portbench/roofline/passes.py``)."""

import re

from portbench.roofline.passes import k1k2_least_s

KERNELS = re.compile(r"\bgemm_(tc|skinny)\b")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = sum(o.dur_ns for o in tr.ops_matching(KERNELS)) / 1e9
    if busy <= 0:
        return None
    least = sum(k1k2_least_s(run.spec, int(s.args["prompt_len"])) for s in tr.spans_named("admit"))
    least += sum(k1k2_least_s(run.spec, int(s.args["lanes"]))
                 for s in tr.spans_named("decode-tick"))
    return 100.0 * least / busy
