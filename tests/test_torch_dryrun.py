"""The port's dry-run machinery (``launch.cost_analysis``,
``launch.dryrun``, ``launch.steps``), mirroring tests/test_dryrun.py.

* The cost counter on a known program, the reference's
  ``test_trip_count_multiplication``: ten 64 x 64 f32 products, each
  followed by an all-reduce, on a 2-rank fake process group, give per
  device exactly 2 * 64**3 * 10 FLOPs and 64 * 64 * 4 * 10 all-reduce
  bytes in 10 all-reduces.
* The mini dry-run on a (2, 4) fake mesh, in this process, for
  ``gemma2_2b x train_4k`` and ``mamba2_1_3b x decode_32k`` with the
  configs cut to smoke size and the shapes to (B, S) = (8, 64): status
  ``ok``, FLOPs and collective bytes above zero (the reference's
  assertions), and the per-device argument bytes equal to the local
  shards that the rules give.
* ``test_skip_rules`` and ``test_production_mesh_shapes`` mirrored.
* A kernel wrapper given ``meta`` tensors launches nothing, runs no
  plain version and hands the contract's work to the counter.
* A train cell of gemma2's smoke config executed on a (1, 1) gloo mesh
  gives bit for bit the parameters of the unsharded train step
  (``runtime.train_loop.make_train_step``) from the same state and batch.
"""

import math
import socket
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, smoke  # noqa: E402
from repro_torch.distributed.sharding import batch_pspec, serve_rules, train_rules  # noqa: E402
from repro_torch.launch import dryrun, mesh as meshmod, steps  # noqa: E402
from repro_torch.launch.cost_analysis import CostCounter  # noqa: E402

SMOKE_CELL = (8, 64)  # (B, S) of the mini dry-run's shapes
HOST8 = ((2, 4), ("data", "model"))


@pytest.fixture
def small(monkeypatch):
    """The mini dry-run's world: smoke configs, (8, 64) shapes, a (2, 4) mesh."""
    monkeypatch.setitem(meshmod.MESHES, "host8", HOST8)
    monkeypatch.setattr(steps, "get_config", smoke)
    monkeypatch.setattr(steps, "SHAPES", {k: steps.ShapeCell(v.kind, SMOKE_CELL[1], SMOKE_CELL[0])
                                          for k, v in steps.SHAPES.items()})


def test_cost_counter_known_program():
    import torch.distributed._functional_collectives as funcol

    with dryrun.fake_process_group(2):
        x = torch.empty(64, 64, device="meta")
        w = torch.empty(64, 64, device="meta")
        with CostCounter() as cc:
            for _ in range(10):
                x = funcol.all_reduce(x @ w, "sum", dist.group.WORLD)
    c = cc.costs
    assert c.flops == 2 * 64 * 64 * 64 * 10
    assert c.collective_bytes == {"all-reduce": 64 * 64 * 4 * 10}
    assert c.collective_counts == {"all-reduce": 10}
    assert c.peak_bytes >= 64 * 64 * 4


def _local_arg_bytes(arch, shape_id, sizes):
    """Per-device bytes of a cell's arguments from the rules alone."""
    from repro_torch.models import init_caches, param_specs
    from repro_torch.optim.adamw import opt_state_specs

    cfg = smoke(arch)
    cell = steps.SHAPES[shape_id]

    def local(shape, spec):
        n = 1
        for dim, entry in zip(shape, spec):
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            n *= dim // math.prod(sizes[a] for a in names)
        return n

    total = 0
    if cell.kind == "train":
        rs = train_rules(sizes)
        specs = list(steps.tree_leaves(param_specs(cfg)))
        specs += list(steps.tree_leaves(opt_state_specs(param_specs(cfg))))
        for s in specs:
            total += local(s.shape, rs.resolve(s.axes, s.shape)) * s.dtype.itemsize
        total += 2 * local((cell.batch, cell.seq), batch_pspec(rs, cell.batch)) * 4
        return total
    rs = steps._serve_ruleset(cfg, sizes)
    for s in steps.tree_leaves(param_specs(cfg)):
        total += local(s.shape, rs.resolve(s.axes, s.shape)) * 2
    caches = init_caches(cfg, cell.batch, cell.seq, device="meta")
    sh = steps._cache_shardings(caches, cfg, rs, cell.batch)
    for c, s in zip(steps.tree_leaves(caches), steps.tree_leaves(sh)):
        total += local(c.shape, s.spec) * c.element_size()
    total += local((cell.batch, 1), batch_pspec(rs, cell.batch)) * 4
    total += local((cell.batch,), batch_pspec(rs, cell.batch, extra_dims=0)) * 4
    return total


@pytest.mark.parametrize("arch,shape", [("gemma2_2b", "train_4k"), ("mamba2_1_3b", "decode_32k")])
def test_mini_dryrun(small, arch, shape):
    rec = dryrun.run_cell(arch, shape, "host8", verbose=False)
    assert rec["status"] == "ok"
    assert rec["hlo_costs"]["flops"] > 0
    assert rec["hlo_costs"]["total_collective_bytes"] > 0
    assert rec["chips"] == 8 and not dist.is_initialized()
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == _local_arg_bytes(arch, shape, dict(zip(*HOST8[::-1])))
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s", "dominant"}
    if arch == "gemma2_2b":
        # K4 on every attention layer, twice (remat's recompute), by contract
        cfg = smoke(arch)
        assert rec["hlo_costs"]["kernel_calls"] == {
            "flash_attention": 2 * cfg.n_periods * sum(s.kind == "attn" for s in cfg.period)}


def test_dryrun_cli_writes_records(small, monkeypatch, tmp_path):
    """``main`` over two cells of the (2, 4) mesh: a long-context decode
    that runs and a full-attention one that the rules skip."""
    import json

    monkeypatch.setitem(meshmod.MESHES, "single", HOST8)
    for arch in ("mamba2_1_3b", "gemma2_2b"):
        dryrun.main(["--arch", arch, "--shape", "long_500k", "--out-dir", str(tmp_path),
                     "--tag", "t"])
    ok = json.loads((tmp_path / "mamba2_1_3b-long_500k-single-precise-t.json").read_text())
    skip = json.loads((tmp_path / "gemma2_2b-long_500k-single-precise-t.json").read_text())
    assert ok["status"] == "ok" and ok["chips"] == 8 and ok["memory"]["temp_size_in_bytes"] > 0
    assert skip["status"] == "skip" and "long_500k" in skip["reason"]


def test_skip_rules():
    """long_500k runs exactly for the sub-quadratic architectures."""
    runs = {a for a in ARCH_IDS if get_config(a).is_subquadratic}
    assert runs == {"mixtral_8x22b", "jamba_v01_52b", "mamba2_1_3b"}


def test_production_mesh_shapes():
    """The shapes and meshes of the reference (no process group)."""
    S = steps.SHAPES
    assert S["train_4k"].batch == 256 and S["train_4k"].seq == 4096
    assert S["prefill_32k"].batch == 32 and S["prefill_32k"].seq == 32768
    assert S["decode_32k"].batch == 128
    assert S["long_500k"].batch == 1 and S["long_500k"].seq == 524288
    assert meshmod.mesh_shape("single") == {"data": 16, "model": 16}
    assert meshmod.mesh_shape("multi") == {"pod": 2, "data": 16, "model": 16}
    assert not dist.is_initialized()
    assert meshmod.HW.PEAK_BF16_FLOPS == 989e12 and meshmod.HW.HBM_BW == 3.35e12


def test_kernels_on_meta_count_their_contract_and_run_nothing():
    from repro_torch.kernels.cordic import rope_sincos_q16, universal_unary
    from repro_torch.kernels.flashattn import flashattn as fa
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_grouped

    k1mod = sys.modules["repro_torch.kernels.qmatmul.qmatmul"]  # the package's name is the function

    plain = []
    orig = (fa.flash_attention_plain, k1mod.qmatmul_plain)
    fa.flash_attention_plain = lambda *a, **k: plain.append("k4")
    k1mod.qmatmul_plain = lambda *a, **k: plain.append("k1")
    launches = (fa.flash_attention.launches, qmatmul.launches)
    m = dict(device="meta")
    try:
        with CostCounter() as cc:
            out = qmatmul(torch.empty(5, 64, dtype=torch.int8, **m),
                          torch.empty(64, 32, dtype=torch.int8, **m),
                          torch.empty((), dtype=torch.int32, **m),
                          torch.empty(32, dtype=torch.int32, **m))
            assert out.shape == (5, 32) and out.dtype == torch.float32 and out.is_meta
            g = qmatmul_grouped(torch.empty(3, 5, 64, dtype=torch.int8, **m),
                                torch.empty(3, 64, 32, dtype=torch.int8, **m),
                                torch.empty((), dtype=torch.int32, **m),
                                torch.empty(3, 32, dtype=torch.int32, **m), "int32")
            assert g.shape == (3, 5, 32) and g.dtype == torch.int32
            q = torch.empty(2, 10, 4, 16, dtype=torch.bfloat16, **m)
            kv = torch.empty(2, 10, 2, 16, dtype=torch.bfloat16, **m)
            o = fa.flash_attention(q, kv, kv, causal=True, window=4)
            assert o.shape == q.shape and o.dtype == torch.bfloat16
            s, c = rope_sincos_q16(torch.empty(2, 10, dtype=torch.int32, **m), 16)
            assert s.shape == c.shape == (2, 10, 8) and s.dtype == torch.int32
            u = universal_unary(torch.empty(7, 3, dtype=torch.int32, **m), "tanh")
            assert u.shape == (7, 3) and u.is_meta
    finally:
        fa.flash_attention_plain, k1mod.qmatmul_plain = orig
    assert not plain and (fa.flash_attention.launches, qmatmul.launches) == launches
    pairs = sum(min(i + 1, 4) for i in range(10))
    assert cc.costs.kernel_calls == {"qmatmul": 1, "qmatmul_grouped": 1, "flash_attention": 1,
                                     "rope_sincos_q16": 1, "universal_unary": 1}
    assert cc.costs.flops >= 2 * 5 * 32 * 64 * 4 + 2 * 2 * 4 * pairs * 32
    assert fa.causal_pairs(10, 10, True, 4) == pairs
    assert fa.causal_pairs(10, 10, True, None) == 55 and fa.causal_pairs(3, 7, False, None) == 21


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_cell_on_one_rank_matches_the_unsharded_step(monkeypatch):
    from repro_torch.launch.train import _place_tree
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.train_loop import make_train_step

    cfg = smoke("gemma2_2b")
    B, S = 2, 32
    monkeypatch.setitem(steps.SHAPES, "train_4k", steps.ShapeCell("train", S, B))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
                           .astype(np.int32))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = meshmod.make_mesh_by_name("host")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1, "model": 1}
        step, (p_ex, o_ex, b_ex), meta = steps.build_cell(
            "gemma2_2b", "train_4k", mesh, "precise", cfg=cfg, opt_cfg=ocfg)
        params = _place_tree(p_ex, init_params(cfg, seed=0, device="cpu"))
        opt = _place_tree(o_ex, o_ex, zeros=True, device="cpu")
        batch = {k: steps.place(b_ex[k], tok) for k in ("tokens", "labels")}
        params, opt, metrics = step(params, opt, batch)
        got = [t.full_tensor() for t in steps.tree_leaves(params)]
        loss = float(metrics["loss"].full_tensor())
    finally:
        dist.destroy_process_group()
    ref = init_params(cfg, seed=0, device="cpu")
    for t in steps.tree_leaves(ref):
        t.requires_grad_(True)
    ref, _, rm = make_train_step(cfg, ocfg, "precise")(ref, init_opt_state(ref),
                                                       {"tokens": tok, "labels": tok})
    assert loss == float(rm["loss"])
    want = list(steps.tree_leaves(ref))
    assert len(got) == len(want) == 20
    for a, b in zip(got, want):
        assert torch.equal(a, b.detach())


def test_train_cli_mesh_needs_the_mesh_s_ranks(capsys):
    from repro_torch.launch import train

    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="repro_torch.launch.dryrun"):
        train.main(["--arch", "gemma2_2b", "--mesh", "single", "--device", "cpu"])


def test_rules_resolve_to_dtensor_placements():
    """A dim mapped to two mesh axes is sharded on both, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import placements_for

    rs = serve_rules({"pod": 2, "data": 16, "model": 16})
    spec = rs.resolve(("expert", "embed", "mlp"), (64, 1024, 512))
    assert spec == (("pod", "data"), None, "model")
    assert placements_for(spec, ("pod", "data", "model")) == (Shard(0), Shard(0), Shard(2))
    assert placements_for((None, None), ("data", "model")) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        placements_for((("model", "data"),), ("data", "model"))
