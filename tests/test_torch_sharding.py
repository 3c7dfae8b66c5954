"""The port's sharding rules against the JAX package's, leaf for leaf.

``distributed.sharding.RuleSet.resolve`` (the reference's reads only
``mesh.shape``), ``optim.adamw.opt_state_specs`` and
``launch.steps._cache_shardings`` / ``_batch_specs`` need no devices:
the reference side runs in this process on ``jax.sharding.AbstractMesh``
meshes, the port's on ``{axis name: size}`` mappings.  Every config at
full size, on the (16, 16) and (2, 16, 16) production meshes and the
(2, 4) host mesh, under ``train_rules(fsdp=True / False)``,
``train_rules(pure_fsdp=True)`` and ``serve_rules`` with ``weight_fsdp``
and ``expert_data_shard`` both ways: every parameter and optimizer-state
leaf resolves to the reference's ``PartitionSpec`` and ``dropped`` is
the same list.  The cache and batch layouts are the reference's for
every config and every shape ``_check_long_context`` admits, at both
cache kinds (f32, and the int8 cache of ``mode == "fast"``).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_caches as jax_init_caches  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.optim.adamw import opt_state_specs as jax_opt_state_specs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import init_caches, param_specs  # noqa: E402
from repro_torch.optim.adamw import opt_state_specs  # noqa: E402

MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "host8": {"data": 2, "model": 4},
}
RULES = {
    "train_fsdp": ("train_rules", {"fsdp": True}),
    "train_nofsdp": ("train_rules", {"fsdp": False}),
    "train_pure_fsdp": ("train_rules", {"pure_fsdp": True}),
    **{f"serve_wf{wf}_ed{ed}": ("serve_rules", {"weight_fsdp": wf, "expert_data_shard": ed})
       for wf in (False, True) for ed in (False, True)},
}


def abstract(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def jax_leaves(tree, prefix=""):
    """(path, leaf) in jax.tree order for the reference's Spec / OptState trees."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from jax_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from jax_leaves(v, f"{prefix}{name}/")
    else:
        yield prefix[:-1], tree


def resolve_all(tree, rs):
    return [(path, tuple(rs.resolve(s.axes, s.shape))) for path, s in jax_leaves(tree)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_resolve_as_the_reference(arch, mesh):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jp, tp = jax_param_specs(jcfg), param_specs(tcfg)
    trees = ((jp, tp), (jax_opt_state_specs(jp), opt_state_specs(tp)))
    for name, (fn, kw) in RULES.items():
        jrs = getattr(jsh, fn)(abstract(MESHES[mesh]), **kw)
        trs = getattr(tsh, fn)(MESHES[mesh], **kw)
        for jtree, ttree in trees:
            want, got = resolve_all(jtree, jrs), resolve_all(ttree, trs)
            assert got == want, (arch, mesh, name)
        assert trs.dropped == jrs.dropped, (arch, mesh, name)
        assert [tuple(x.shape) for _, x in jax_leaves(trees[1][1])] == \
            [tuple(x.shape) for _, x in jax_leaves(trees[1][0])]
    # the port's tree walk resolves in the reference's order
    trs = tsh.train_rules(MESHES[mesh])
    jrs = jsh.train_rules(abstract(MESHES[mesh]))
    sh = tsh.tree_shardings(opt_state_specs(tp), trs)
    jsh.tree_shardings(jax_opt_state_specs(jp), jrs)
    assert trs.dropped == jrs.dropped
    assert [s.spec for _, s in jax_leaves(sh)] == [
        tuple(s.spec) for _, s in jax_leaves(jax_opt_state_specs(jp)) for s in
        [jsh.spec_sharding(s, jsh.train_rules(abstract(MESHES[mesh])))]]


def test_opt_state_specs_keep_axes_in_f32():
    specs = param_specs(get_config("gemma2_2b"))
    st = opt_state_specs(specs)
    for (_, p), (_, m), (_, v) in zip(jax_leaves(specs), jax_leaves(st.m), jax_leaves(st.v)):
        assert m.shape == v.shape == p.shape and m.axes == v.axes == p.axes
        assert m.dtype == v.dtype == torch.float32 and m.init == "zeros"
    assert st.step.shape == () and st.step.dtype == torch.int32


def _cache_specs(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _cache_specs(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(tree[k].spec)


@pytest.mark.parametrize("shape_id", list(tsteps.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_layouts_match_the_reference(arch, shape_id):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    cell = tsteps.SHAPES[shape_id]
    jcell = jsteps.SHAPES[shape_id]
    assert (cell.kind, cell.seq, cell.batch) == (jcell.kind, jcell.seq, jcell.batch)
    try:
        jsteps._check_long_context(jcfg, shape_id)
    except jsteps.SkipCell:
        with pytest.raises(tsteps.SkipCell):
            tsteps._check_long_context(tcfg, shape_id)
        return
    tsteps._check_long_context(tcfg, shape_id)
    for shape in MESHES.values():
        am = abstract(shape)
        if cell.kind == "train":
            jrs, trs = jsh.train_rules(am), tsh.train_rules(shape)
        else:
            jrs, trs = jsteps._serve_ruleset(jcfg, am), tsteps._serve_ruleset(tcfg, shape)
            assert trs.rules == jrs.rules
            for mode in ("precise", "fast"):
                jc = jax.eval_shape(lambda: jax_init_caches(jcfg, cell.batch, cell.seq,
                                                            quantized=(mode == "fast")))
                tc = init_caches(tcfg, cell.batch, cell.seq, device="meta",
                                 quantized=(mode == "fast"))
                want = dict(_cache_specs(jsteps._cache_shardings(jc, jcfg, jrs, cell.batch)))
                got = dict(_cache_specs(tsteps._cache_shardings(tc, tcfg, trs, cell.batch)))
                assert got == want, (arch, shape_id, shape, mode)
        jb, jbs = jsteps._batch_specs(jcfg, jsteps.SHAPES[shape_id], jrs)
        tb, tbs = tsteps._batch_specs(tcfg, cell, trs)
        assert {k: (v[0], str(v[1]).split(".")[-1]) for k, v in tb.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in jb.items()}
        assert {k: v.spec for k, v in tbs.items()} == {k: tuple(v.spec) for k, v in jbs.items()}
        for b in (1, 2, 8, 16, 32, 64, 128, 256, 512):
            for extra in (0, 1, 2):
                assert tsh.batch_pspec(trs, b, extra) == tuple(jsh.batch_pspec(jrs, b, extra))
