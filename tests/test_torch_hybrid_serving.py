"""Serving the families of the SSM / MLA slice on the port's servers:
mamba2_1_3b (attention-free), jamba_v01_52b (attention, mamba, MLP and
MoE in a period of 8) and minicpm3_4b (MLA), at smoke size on the CPU.

Mirrors of the reference's serving tests, on the port:

* tests/test_substrates.py::test_serving_decode_consistency_all_families
  for the three families: the static server's greedy tokens equal
  greedy re-prefill, and equal JAX's static server (its tokens come from
  ``tests/_torch_jax_child.py OUT ARCH ssm|mla|hybrid``, started once a
  session by ``start_shared``, on the same parameters);
* tests/test_scheduler.py::test_mixed_levels_identical_to_alone (jamba,
  and the other two): a ``q16_16`` / ``f32`` batch gives each request
  its tokens served alone;
* tests/test_paged_serving.py::test_paged_batch_equals_alone (jamba,
  and the other two): a batch through the paged pool equals each request
  served alone, and every page goes back to the free list;
* tests/test_cachepool.py's jamba cases: ``ContiguousCacheOps`` is the
  model's helpers bit for bit, and prefix sharing refuses SSM models;
  plus a paged pool with only slot leaves (mamba2);
* tests/test_speculative.py::test_eos_truncates_like_vanilla (jamba):
  the speculative stream stops where vanilla ``f32`` decode stops.

Besides: jamba's model records against JAX (prefill and greedy decode
logits at 1e-5 FAST / 1e-4 exact, the greedy tokens equal, the FAST
attention caches bit for bit and the SSM states within 1e-3 of their
largest magnitude, as tests/test_torch_ssm.py), speculative serving
equal to vanilla ``f32`` on both pools for the three families, and the
contiguous draft restoring every cache, SSM states included, bit for
bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import BATCHED_PROMPT, DECODE_STEPS, TOKENS  # noqa: E402
from _torch_jax_child import start_shared, wait_shared  # noqa: E402
from _torch_spec_harness import load_reference  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache  # noqa: E402
from repro_torch.models.layers import attach_quantized_weights  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    BatchedServer,
    ContiguousCacheOps,
    ContinuousBatchingServer,
    LadderSpeculativeDecoder,
    PagedCachePool,
    Request,
    ServingConfig,
    SpeculativeConfig,
    vanilla_greedy_reference,
)
from spec_harness import make_prompts  # noqa: E402

ARCHS = ("mamba2_1_3b", "jamba_v01_52b", "minicpm3_4b")
RUNS = {"mamba2_1_3b": "ssm", "jamba_v01_52b": "hybrid", "minicpm3_4b": "mla"}
MAX_LEN = 32
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17], [3, 1, 4],
           [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_child(request, tmp_path_factory):
    return start_shared(request, tmp_path_factory)


_PARAMS = {}


def _model(arch):
    """The smoke config and the port's own parameters (seed 0)."""
    if arch not in _PARAMS:
        cfg = smoke(arch)
        _PARAMS[arch] = cfg, tm.init_params(cfg, seed=0, device="cpu")
    return _PARAMS[arch]


def _server(arch, n_slots=2, cache="contiguous", **kw):
    cfg, params = _model(arch)
    kw.setdefault("max_len", MAX_LEN)
    if cache == "paged":
        kw.update(cache="paged", page_size=4)
    return ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=n_slots, **kw),
                                    device="cpu")


# ---------------------------------------------------------------------------
# isolation: a batch equals each request served alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_levels_identical_to_alone(arch):
    """A batch mixing ``q16_16`` and ``f32`` slots gives every request the
    tokens it gets served alone at its level."""
    pa, pb = [1, 2, 3, 4, 5, 6], [9, 8, 7, 6]
    srv = _server(arch, max_len=64)
    fins = srv.serve([Request(rid=0, prompt=pa, max_new=4, level="f32"),
                      Request(rid=1, prompt=pb, max_new=4, level="q16_16")])
    assert srv.stats["level_passes"] == 2 * srv.stats["decode_steps"]  # mixed batch
    alone_a = _server(arch, max_len=64).serve([Request(rid=0, prompt=pa, max_new=4,
                                                       level="f32")])[0]
    alone_b = _server(arch, max_len=64).serve([Request(rid=1, prompt=pb, max_new=4,
                                                       level="q16_16")])[1]
    assert fins[0].tokens == alone_a.tokens
    assert fins[1].tokens == alone_b.tokens
    assert alone_a.tokens != alone_b.tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_batch_equals_alone(arch):
    """A mixed-length batch through the paged pool (chunked prefill, the
    SSM state carried from chunk to chunk) equals each request served
    alone; every page goes back to the free list."""
    srv = _server(arch, cache="paged")
    outs = srv.generate(PROMPTS, max_new=6, level="f32")
    alone = _server(arch, n_slots=1, cache="paged")
    for p, o in zip(PROMPTS, outs):
        assert o == alone.generate([p], max_new=6, level="f32")[0]
    for g in srv.cache_ops.groups.values():
        assert g["alloc"].live() == []
    for node in srv.pool["slot"].values():
        for leaf in node.values():
            assert not leaf.any()  # SSM lanes zeroed at eviction


# ---------------------------------------------------------------------------
# the cache pools
# ---------------------------------------------------------------------------


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_contiguous_ops_bit_identical_to_helpers():
    """``ContiguousCacheOps`` on jamba (attention and SSM leaves) is the
    model's cache helpers, bit for bit."""
    cfg = smoke("jamba_v01_52b")
    ops = ContiguousCacheOps(cfg, n_slots=3, max_len=32, device="cpu")
    pool_ops, pool_ref = ops.alloc(), tm.init_caches(cfg, 3, 32, device="cpu")
    assert _equal(pool_ops, pool_ref)
    gen = torch.Generator().manual_seed(0)
    single = tm.model.tree_map(
        lambda leaf: torch.randn(leaf.shape, generator=gen).to(leaf.dtype),
        tm.init_caches(cfg, 1, 32, device="cpu"))
    pool_ops = ops.write(pool_ops, single, 1)
    pool_ref = tm.write_cache_slot(pool_ref, single, 1)
    assert _equal(pool_ops, pool_ref)
    assert _equal(ops.read(pool_ops, 1), tm.model.tree_map(lambda x: x[:, 1:2], pool_ref))
    snap = ops.snapshot(pool_ops, 1)
    pool_ops = ops.reset(pool_ops, 1)
    pool_ref = tm.reset_cache_slot(pool_ref, cfg, 1)
    assert _equal(pool_ops, pool_ref)
    assert not pool_ops["pos1"]["state"][:, 1].any()
    pool_ops = ops.restore(pool_ops, snap, 1)
    assert _equal(pool_ops, tm.write_cache_slot(pool_ref, single, 1))


def test_paged_pool_with_slot_leaves_only():
    """mamba2 has no position-indexed cache: the paged pool has no page
    groups, keeps the SSM leaves slot-contiguous, and its views are
    copies (a step on a view writes nothing into the pool)."""
    cfg = smoke("mamba2_1_3b")
    pool = PagedCachePool(cfg, n_slots=2, max_len=32, page_size=4, device="cpu")
    assert pool.groups == {} and pool.slot_keys == ["pos0"] and not pool.shareable
    state = pool.alloc()
    assert state["pages"] == {} and state["slot"]["pos0"]["state"].shape == (2, 2, 16, 16, 8)
    assert pool.can_admit(list(range(30)))
    single = {"pos0": {k: torch.full_like(v[:, :1], 3.0)
                       for k, v in state["slot"]["pos0"].items()}}
    state = pool.write(state, single, 1)
    assert _equal(pool.read(state, 1), single)
    view = pool.device_view(state, pool.device_tables())
    view["pos0"]["state"].fill_(7.0)
    assert (state["slot"]["pos0"]["state"][:, 1] == 3.0).all()
    pool.commit_rows(state, pool.device_tables(), view, torch.zeros(2, dtype=torch.int32),
                     torch.tensor([False, True]))
    assert (state["slot"]["pos0"]["state"][:, 1] == 7.0).all()
    assert not state["slot"]["pos0"]["state"][:, 0].any()
    state = pool.reset(state, 1)
    assert not state["slot"]["pos0"]["state"].any()


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "jamba_v01_52b"])
def test_paged_rejects_sharing_on_ssm_models(arch):
    with pytest.raises(ValueError, match="prefix_sharing"):
        PagedCachePool(smoke(arch), n_slots=2, max_len=32, page_size=4, prefix_sharing=True,
                       device="cpu")


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_serving_equals_vanilla_f32(arch, cache):
    """Speculative requests give vanilla ``f32`` greedy decode's tokens on
    both pools (the verify commits through the SSM branch of
    ``commit_segment``; the paged draft runs on copies)."""
    prompts = [[(7 * i + j) % 120 + 1 for j in range(5 + 3 * i)] for i in range(3)]
    spec = _server(arch, cache=cache, max_len=40,
                   speculative=SpeculativeConfig(k=3, max_len=40))
    got = spec.generate(prompts, max_new=6, speculative=True)
    want = _server(arch, cache=cache, max_len=40).generate(prompts, max_new=6, level="f32")
    assert got == want
    assert spec.stats["spec_rounds"] > 0 and spec.stats["spec_accepted"] > 0


def test_contiguous_draft_restores_every_cache_bit_for_bit():
    """The draft's k passes write every lane's SSM state and conv history
    (cumulative) and attention rows; after it the pool is the pre-draft
    pool bit for bit."""
    from repro_torch.core.precision import MathEngine
    from repro_torch.runtime.speculative import register_spec_steps

    cfg, params = _model("jamba_v01_52b")
    engine = MathEngine("q16_16")
    pa = attach_quantized_weights(params, engine.weight_cache)
    pool = tm.init_caches(cfg, 2, 32, device="cpu")
    tm.prefill_step(pa, torch.from_numpy(np.stack([TOKENS[0], TOKENS[0] + 20])), pool, cfg,
                    mode="exact")
    before = tm.model.tree_map(lambda x: x.clone(), pool)
    draft, _, _ = register_spec_steps(engine, cfg, 3)
    tok = torch.tensor([12, 32], dtype=torch.int32)
    pos = torch.full((2,), TOKENS.shape[1], dtype=torch.int32)
    for ri in range(len(draft)):
        drafts = draft[ri](pa, tok, pos, pool, torch.tensor([True, False]))
        assert drafts.shape == (2, 3)
        assert _equal(pool, before)


def test_eos_truncates_like_vanilla():
    """With an EOS id that fires, jamba's speculative stream stops exactly
    where vanilla ``f32`` decode stops, even when the EOS token was
    committed mid-round with verified tokens behind it."""
    cfg, params = _model("jamba_v01_52b")
    prompts = make_prompts(cfg.vocab, 2)
    ref = vanilla_greedy_reference(cfg, params, prompts, 16, 64, device="cpu")
    eos = next((t for toks in ref for t in toks[1:]), None)
    dec = LadderSpeculativeDecoder(cfg, params, SpeculativeConfig(
        k=3, draft_level="q8_8", max_len=64, eos_id=eos), device="cpu")
    got = dec.generate(prompts, max_new=16)
    for g, r in zip(got, ref):
        assert g == (r[: r.index(eos) + 1] if eos in r else r)


# ---------------------------------------------------------------------------
# against the JAX package (last: the port-only cases above run while the
# JAX children compute)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_decode_consistency_all_families(jax_child, arch):
    """The static server (one slot, ``f32``, 4 new tokens) equals greedy
    re-prefill, and JAX's static server on the same parameters."""
    records, params = load_reference(wait_shared(jax_child, arch, RUNS[arch]))
    cfg = smoke(arch)
    out = BatchedServer(cfg, params, ServingConfig(n_slots=1, max_len=64, max_new=4),
                        device="cpu").generate([BATCHED_PROMPT])[0]
    assert out == records["serve/batched"].tolist()
    seq = list(BATCHED_PROMPT)
    for _ in range(4):
        logits, _ = tm.prefill_step(params, torch.tensor([seq], dtype=torch.int32),
                                    tm.init_caches(cfg, 1, 64, device="cpu"), cfg, mode="exact")
        seq.append(int(logits[0].argmax()))
    assert out == seq


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_jamba_model_matches_reference(jax_child, mode):
    records, params = load_reference(wait_shared(jax_child, "jamba_v01_52b", "hybrid"))
    cfg = smoke("jamba_v01_52b")
    pa = attach_quantized_weights(params, QuantizedWeightCache())
    caches = tm.init_caches(cfg, 1, 32, device="cpu")
    lp, caches = tm.prefill_step(pa, torch.from_numpy(TOKENS), caches, cfg, mode=mode)
    tokens, logits = records[f"{mode}/tokens"], []
    for i in range(DECODE_STEPS):
        ld, caches = tm.decode_step(pa, torch.tensor([[int(tokens[i])]]),
                                    torch.tensor([TOKENS.shape[1] + i]), caches, cfg, mode=mode)
        logits.append(ld.numpy())
    tol = 1e-4 if mode == "exact" else 1e-5
    np.testing.assert_allclose(lp.numpy(), records[f"{mode}/logits_prefill"], atol=tol, rtol=tol)
    np.testing.assert_allclose(np.stack(logits), records[f"{mode}/logits_decode"], atol=tol,
                               rtol=tol)
    assert np.stack(logits).argmax(-1)[:, 0].tolist() == tokens[1:].tolist()
    for pos, node in caches.items():
        for leaf, got in node.items():
            got, want = got.numpy(), records[f"{mode}/c2/{pos}/{leaf}"]
            if leaf == "state":
                assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), pos
            elif mode == "fast" or leaf == "pos":
                np.testing.assert_array_equal(got, want, err_msg=f"{pos}/{leaf}")
            else:
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                           err_msg=f"{pos}/{leaf}")
