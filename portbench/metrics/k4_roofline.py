"""k4_roofline (%), the kernels: the least time of the bf16 prefill
attention the profiled batch needed (every admission, every layer; the
pairs the causal mask keeps), over the device time of K4's kernels
(``flash_fwd_tc``, ``flash_fwd_f32``) in its trace."""

import re

from portbench.roofline.passes import k4_least_s

KERNELS = re.compile(r"\bflash_fwd_(tc|f32)\b")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = sum(o.dur_ns for o in tr.ops_matching(KERNELS)) / 1e9
    if busy <= 0:
        return None
    least = sum(k4_least_s(run.spec, int(s.args["prompt_len"])) for s in tr.spans_named("admit"))
    return 100.0 * least / busy
