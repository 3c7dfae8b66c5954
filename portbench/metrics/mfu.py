"""mfu (%), the whole step: the model operations the batches that were
not profiled served (matmuls and attention, for the tokens served, live
lanes only), each at the peak of the precision it runs in on the
``q16_16`` rung (int8 for the K1 / K2 / G1 / G2 products, bf16 for K4's
prefill attention, float32 for decode attention, the router and the
head), over those batches' wall time."""

from portbench.roofline.passes import decode_ops, prefill_ops
from portbench.roofline.peaks import PEAK_OPS


def read(run):
    at_peak = wall = 0.0
    for b in run.unprofiled():
        wall += b.wall_s
        for plen, served in b.requests:
            for kind, ops in prefill_ops(run.spec, plen).items():
                at_peak += ops / PEAK_OPS[kind]
            # the first token comes from the prefill; each later one is a
            # decode step at the position of the token before it
            for j in range(1, served):
                for kind, ops in decode_ops(run.spec, plen + j - 1).items():
                    at_peak += ops / PEAK_OPS[kind]
    if wall <= 0:
        return None
    return 100.0 * at_peak / wall
