"""The benchmark's own arithmetic on the CPU: the traffic generator, the
roofline counts, ``mfu``, the trace reader's interval logic, the
reference's schedule, and the import rule judged by whole top-level
names."""

import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.traffic import Mix  # noqa: E402

MIXES = ("codecomp_fast", "codecomp_fast_moe")


def _mix(name):
    return Mix.load(os.path.join(ROOT, "portbench", "traffic", name + ".json"), name)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_draws_the_same_lengths_in_another_order(name):
    mix = _mix(name)
    a = mix.batch(2 ** 31 + 17, 0, 1000)
    b = mix.batch(5, 0, 1000)
    c = mix.batch(2 ** 31 + 17, 1, 1000)
    lengths = lambda batch: sorted((len(p), n) for p, n in batch)  # noqa: E731
    assert sorted(len(p) for p, _ in a) == sorted(mix.prompt_lengths())
    assert sorted(n for _, n in a) == sorted(mix.output_lengths())
    assert sorted(len(p) for p, _ in b) == sorted(len(p) for p, _ in a)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b] or lengths(a) != lengths(b)
    assert [p for p, _ in a] != [p for p, _ in c]
    assert a == mix.batch(2 ** 31 + 17, 0, 1000)
    assert all(mix.prompt["min"] <= len(p) <= mix.prompt["max"] for p, _ in a)
    assert all(mix.output["min"] <= n <= mix.output["max"] for _, n in a)
    assert max(len(p) for p, _ in a) + max(n for _, n in a) <= mix.max_len


def test_k1_bound_is_the_kernel_tables():
    from portbench.roofline import k1
    from portbench.roofline.peaks import bound_by, least_s

    m, k, n = 4500, 9216, 2304
    t = least_s(k1.nbytes(m, k, n), k1.ops(m, k, n), "int8")
    assert round(t * 1e3, 4) == 0.0966
    assert bound_by(k1.nbytes(m, k, n), k1.ops(m, k, n), "int8") == "operations"
    # a decode lane is bound by the weight bytes
    assert bound_by(k1.nbytes(1, 4096, 4096), k1.ops(1, 4096, 4096), "int8") == "bytes"


def test_k4_pairs():
    from portbench.roofline.k4 import pairs

    assert pairs(4) == 10
    assert pairs(6, window=2) == 3 + 4 * 2
    assert pairs(3, window=8) == 6


def _load(name):
    from portbench.harness import load_reader

    return load_reader(ROOT, name)


def test_mfu_for_a_known_token_count():
    from portbench.harness import Batch, Run
    from portbench.roofline.peaks import PEAK_OPS

    spec = {"d_model": 8, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
            "d_ff": 16, "vocab": 32, "layer": {"kind": "attn", "window": None, "ffn": "mlp"}}
    run = Run(spec=spec, mix=None, batches=[Batch(requests=[(3, 2)], wall_s=1e-9)])
    proj = 8 * 8 * 2 + 8 * 4 * 2 + 3 * 8 * 16          # q, o; k, v; gate, up, down
    int8 = 2 * 3 * proj * 2 + 2 * proj * 2              # 3 prompt tokens, 1 decode step
    bf16 = 2.0 * 2 * 6 * 8 * 2                          # causal pairs of 3 positions
    f32 = 2 * 8 * 32 + (4.0 * 2 * 4 * 4 * 2 + 2 * 8 * 32)   # prefill head; decode attn + head
    want = 100 * (int8 / PEAK_OPS["int8"] + bf16 / PEAK_OPS["bf16"] + f32 / PEAK_OPS["f32"]) / 1e-9
    assert _load("mfu")(run) == pytest.approx(want, rel=1e-12)


def test_trace_busy_idle_and_ticks():
    from portbench.trace import DeviceOp, Span, Trace

    ops = [DeviceOp("void gemm_tc<1, 4, EpiFloat>(int)", 100, 50, 95),
           DeviceOp("flash_fwd_tc", 120, 60, 110),          # overlaps the first
           DeviceOp("grouped_tc<2>", 300, 100, 290)]
    spans = [Span("decode-tick", 90, 200, {"lanes": 3}), Span("level-pass", 92, 150, {}),
             Span("admit", 250, 460, {"prompt_len": 7})]
    tr = Trace(window=(0, 500), ops=ops, spans=spans, launch_matched=1.0)
    assert tr.busy_s() == pytest.approx((180 - 100 + 100) / 1e9)
    assert tr.window_s == pytest.approx(500 / 1e9)
    assert tr.launched_within(tr.spans_named("decode-tick")) == 2
    # busy [100, 180] and [300, 400]: the gaps 0-100 and 180-300 lie
    # outside every span at their middles, 400-500 inside the admission
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"none": 220e-9, "admit": 100e-9})
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s())
    assert tr.top_ops(1)[0][0] == "grouped_tc<2>"


def test_reference_schedule_is_fifo_continuous_batching():
    from portbench.reference.decoder import schedule

    # two lanes: requests 0 and 1 start together; 1 leaves after 2 tokens
    # (one tick), 2 takes its lane at the next loop
    ticks = schedule([4, 2, 3], n_slots=2)
    assert ticks == [[0, 1, 2], [0], [1, 2]]
    assert schedule([1, 2], n_slots=1) == [[], [0]]


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _files(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_file_imports_the_jax_side_by_whole_top_level_name():
    from portbench.harness import FORBIDDEN

    assert "repro" in FORBIDDEN and "repro_torch" not in FORBIDDEN
    for path in _files():
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "repro", "benchmarks"), (
                path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("repro_torch", "repro"), (path, mod)


def test_forbidden_modules_compares_whole_top_level_names():
    from portbench.harness import forbidden_modules

    assert forbidden_modules(["repro_torch", "repro_torch.models", "torch", "jaxtyping"]) == []
    assert forbidden_modules(["repro_torch", "repro.core", "jax.numpy"]) == ["jax", "repro"]
