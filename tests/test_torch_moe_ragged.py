"""The grouped entries' ragged rows (``repro_torch.kernels.qmatmul::
qmatmul_grouped`` and ``kernels.fused_mlp::fused_swiglu_grouped``, G1 and
G2) on the CPU, where they run their plain versions.

``rows`` (G, L) int32 gives the live rows of each of L lane blocks of C =
M / L rows: row ``l*C + j`` of group g is live iff ``j < rows[g, l]``.  A
dead row reads as zero, so its output is the zero accumulator's; the
plain versions zero the dead rows and compute as before, which these
tests hold against the all-live contract on inputs whose dead rows were
zeroed by hand, bit for bit.  The MoE block passes its dispatch's
``counts`` clipped at C, as (E, B) int32, to both launches.  No JAX: the
bit-exact checks against the reference stay in tests/test_torch_moe.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke
from repro_torch.core.quantization import QuantizedWeightCache
from repro_torch.kernels.fused_mlp import fused_swiglu_grouped, fused_swiglu_plain
from repro_torch.kernels.qmatmul import live_rows, qmatmul_grouped, qmatmul_plain
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import attach_quantized_weights, init_from_specs, rms_norm


def _i8(gen, *shape):
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)


def _i32(gen, lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)


#: (C, rows): a decode pass (C = 8, four lanes) and a prefill (C = 24, one
#: lane block and two); an all-dead group, all live, and counts past the
#: contract's range (negative: none live; above C: all)
ROWS_CASES = [
    (8, [[0, 0, 0, 0], [8, 8, 8, 8], [1, 0, 3, 8], [-2, 11, 0, 1]]),
    (24, [[0], [24], [17], [5]]),
    (24, [[0, 0], [24, 24], [23, 1], [30, -1]]),
]


def _zeroed(x, rows):
    """x (G, M, K) with the dead rows zeroed by hand, row by row."""
    x = x.clone()
    g, m, _ = x.shape
    c = m // len(rows[0])
    for gi in range(g):
        for r in range(m):
            if r % c >= rows[gi][r // c]:
                x[gi, r] = 0
    return x


def test_live_rows_marks_each_lane_blocks_prefix():
    rows = torch.tensor([[2, 0], [3, 1]], dtype=torch.int32)
    want = [[1, 1, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0]]
    assert live_rows(rows, 6).int().tolist() == want


@pytest.mark.parametrize("epilogue", ["float", "q16", "int32"])
@pytest.mark.parametrize("c,rows", ROWS_CASES)
def test_qmatmul_grouped_rows_zero_the_dead_rows(c, rows, epilogue):
    gen = torch.Generator().manual_seed(c + len(rows[0]))
    G, L, K, N = len(rows), len(rows[0]), 40, 12
    a, b = _i8(gen, G, L * c, K), _i8(gen, G, K, N)
    ea, eb = _i32(gen, -12, -4, 1), _i32(gen, -30, 12, G, N)
    r = torch.tensor(rows, dtype=torch.int32)
    got = qmatmul_grouped(a, b, ea, eb, epilogue, rows=r)
    want = qmatmul_grouped(_zeroed(a, rows), b, ea, eb, epilogue)
    assert torch.equal(got, want)
    assert torch.equal(got, qmatmul_plain(a, b, ea, eb, epilogue, rows=r))
    zero = qmatmul_plain(torch.zeros_like(a[:1, :1]), b[:1], ea, eb[:1], epilogue)[0, 0]
    assert torch.equal(got[0], zero.expand(L * c, N))     # the all-dead group
    assert qmatmul_grouped.launches == 0


@pytest.mark.parametrize("c,rows", ROWS_CASES)
def test_fused_swiglu_grouped_rows_zero_the_dead_rows(c, rows):
    gen = torch.Generator().manual_seed(7 * c + len(rows[0]))
    G, L, K, F = len(rows), len(rows[0]), 40, 12
    x, wg, wu = _i8(gen, G, L * c, K), _i8(gen, G, K, F), _i8(gen, G, K, F)
    ea, eg, eu = _i32(gen, -8, -4, 1), _i32(gen, -12, -6, G, F), _i32(gen, -12, -6, G, F)
    r = torch.tensor(rows, dtype=torch.int32)
    got = fused_swiglu_grouped(x, wg, wu, ea, eg, eu, rows=r, return_parts=True)
    want = fused_swiglu_grouped(_zeroed(x, rows), wg, wu, ea, eg, eu, return_parts=True)
    plain = fused_swiglu_plain(x, wg, wu, ea, eg, eu, rows=r, return_parts=True)
    for name, g, w, p in zip(("out", "gate", "sig"), got, want, plain):
        assert torch.equal(g, w), name
        assert torch.equal(g, p), name
    out, gate, sig = got
    # a dead row: gate 0, the sigmoid of 0 (one constant), out 0 * 2**e
    dead = ~live_rows(r, L * c)
    assert torch.all(gate[dead] == 0)
    assert torch.all(sig[dead] == sig[0, 0, 0]) and int(sig[0, 0, 0]) == 32768
    assert torch.all(out[dead] == 0)
    assert torch.equal(fused_swiglu_grouped(x, wg, wu, ea, eg, eu, rows=r), out)
    assert fused_swiglu_grouped.launches == 0


def test_rows_none_is_every_row_live():
    gen = torch.Generator().manual_seed(3)
    G, L, C, K, N = 3, 2, 5, 16, 8
    a, b = _i8(gen, G, L * C, K), _i8(gen, G, K, N)
    ea, eb = _i32(gen, -12, -4, 1), _i32(gen, -12, -4, G, N)
    full = torch.full((G, L), C, dtype=torch.int32)
    assert torch.equal(qmatmul_grouped(a, b, ea, eb, rows=full), qmatmul_grouped(a, b, ea, eb))
    eu = _i32(gen, -12, -6, G, N)
    assert torch.equal(fused_swiglu_grouped(a, b, b, ea, eb, eu, rows=full),
                       fused_swiglu_grouped(a, b, b, ea, eb, eu))


def test_bad_rows_raise():
    gen = torch.Generator().manual_seed(4)
    a, b = _i8(gen, 2, 6, 8), _i8(gen, 2, 8, 4)
    ea, eb = _i32(gen, 0, 1, 1), _i32(gen, 0, 1, 2, 4)
    for bad, err in ((torch.ones(2, 2, dtype=torch.int64), TypeError),
                     ([[1, 1], [1, 1]], TypeError),
                     (torch.ones(3, 2, dtype=torch.int32), ValueError),      # G
                     (torch.ones(2, 4, dtype=torch.int32), ValueError),      # L does not divide M
                     (torch.ones(2, dtype=torch.int32), ValueError),         # not (G, L)
                     (torch.ones(2, 0, dtype=torch.int32), ValueError)):     # no lane block
        with pytest.raises(err, match="rows"):
            qmatmul_grouped(a, b, ea, eb, rows=bad)
        with pytest.raises(err, match="rows"):
            fused_swiglu_grouped(a, b, b, ea, eb, eb, rows=bad)
        with pytest.raises(err, match="rows"):
            qmatmul_plain(a, b, ea, eb, rows=bad)
    meta = torch.ones(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="rows on meta"):
        qmatmul_grouped(a, b, ea, eb, rows=meta)


def test_meta_rows_cost_the_capacity():
    """On meta tensors the counts are unknown: the contract's cost is the
    capacity's, with or without rows."""
    from repro_torch.launch.cost_analysis import CostCounter

    m = dict(device="meta")
    args = (torch.empty(3, 8, 64, dtype=torch.int8, **m),
            torch.empty(3, 64, 32, dtype=torch.int8, **m),
            torch.empty((), dtype=torch.int32, **m), torch.empty(3, 32, dtype=torch.int32, **m))
    rows = torch.empty(3, 2, dtype=torch.int32, **m)
    costs = []
    for kw in ({}, {"rows": rows}):
        with CostCounter() as cc:
            out = qmatmul_grouped(*args, **kw)
            g = fused_swiglu_grouped(args[0], args[1], args[1], args[2], args[3], args[3], **kw)
        assert out.shape == g.shape == (3, 8, 32) and out.is_meta
        costs.append((cc.costs.flops, cc.costs.kernel_calls))
    assert costs[0] == costs[1]


# ---------------------------------------------------------------------------
# the MoE block's rows
# ---------------------------------------------------------------------------


def _counts(ffn, x, cfg):
    """(B, E) picks per expert, recomputed from the router."""
    h = rms_norm(x, ffn["norm"], cfg.rms_eps).float()
    probs = torch.softmax(h @ ffn["router"].float(), dim=-1)
    _, idx = moe_mod.top_k_stable(probs, cfg.moe.top_k)
    return torch.nn.functional.one_hot(idx.reshape(x.shape[0], -1), cfg.moe.num_experts).sum(1)


@pytest.mark.parametrize("cf", [None, 0.5])
def test_fast_layer_rows_are_the_clipped_counts(rng, monkeypatch, cf):
    """Both grouped calls get ``counts.clamp(max=C)`` as (E, B) int32 —
    one tensor — on the dropless and the capacity-drop path, and the
    block's output equals the all-live computation on the same (zero
    padded) rows bit for bit."""
    cfg = smoke("granite_moe_3b_a800m")
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    params = init_from_specs(moe_mod.moe_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    params = attach_quantized_weights(params, QuantizedWeightCache())
    x = torch.from_numpy(rng.normal(size=(3, 24, cfg.d_model)).astype(np.float32))
    x = x.to(torch.bfloat16)
    seen = []

    def spy(fn, drop):
        def wrapper(*args, rows=None, **kw):
            seen.append(rows)
            return fn(*args, **kw) if drop else fn(*args, rows=rows, **kw)
        return wrapper

    monkeypatch.setattr(moe_mod, "fused_swiglu_grouped", spy(fused_swiglu_grouped, False))
    monkeypatch.setattr(moe_mod, "qmatmul_grouped", spy(qmatmul_grouped, False))
    got, _ = moe_mod.moe_forward(params, x, cfg, "fast")
    C = moe_mod._capacity(x.shape[1], cfg)
    counts = _counts(params, x, cfg)
    want = counts.clamp(max=C).t().to(torch.int32)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert seen[0].dtype == torch.int32 and seen[0].is_contiguous()
    assert torch.equal(seen[0], want)
    assert bool((counts > C).any()) == (cf is not None)    # the drop path drops
    monkeypatch.setattr(moe_mod, "fused_swiglu_grouped", spy(fused_swiglu_grouped, True))
    monkeypatch.setattr(moe_mod, "qmatmul_grouped", spy(qmatmul_grouped, True))
    all_live, _ = moe_mod.moe_forward(params, x, cfg, "fast")
    assert torch.equal(got, all_live)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_rows_reach_the_local_shards_of_dtensors():
    """On DTensors sharded on the experts, ``rows`` (a DTensor sharded the
    same way, or a plain tensor taken as replicated) reaches each local
    shard with its groups: a one-rank gloo mesh against the plain
    versions."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    gen = torch.Generator().manual_seed(5)
    a, b = _i8(gen, 3, 8, 16), _i8(gen, 3, 16, 8)
    ea, eb = _i32(gen, -6, -5, 1), _i32(gen, -10, -4, 3, 8)
    rows = torch.tensor([[1, 0], [4, 2], [0, 3]], dtype=torch.int32)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("expert",))
        da, db, deb = (distribute_tensor(t, mesh, [Shard(0)]) for t in (a, b, eb))
        dea = distribute_tensor(ea, mesh, [Replicate()])
        for r in (rows, distribute_tensor(rows, mesh, [Shard(0)])):
            got = qmatmul_grouped(da, db, dea, deb, rows=r).full_tensor()
            assert torch.equal(got, qmatmul_plain(a, b, ea, eb, rows=rows))
            got = fused_swiglu_grouped(da, db, db, dea, deb, deb, rows=r).full_tensor()
            assert torch.equal(got, fused_swiglu_plain(a, b, b, ea, eb, eb, rows=rows))
    finally:
        dist.destroy_process_group()
