"""Serving through the port's paged cache pool, mirroring
tests/test_paged_serving.py for the ported families (deepseek_7b: full
attention; gemma2_2b: an 8-row local window in its own page group).

* against the JAX package: one mixed batch (``q16_16`` and ``f32``
  requests, more requests than slots, ragged lengths) through a paged
  server on both sides gives identical tokens.  JAX runs in a child
  process (``tests/_torch_jax_child.py OUT deepseek_7b paged``,
  ``--xla_allow_excess_precision=false``), started with the speculative
  module's runs by the first of the two modules to start
  (``start_shared``), so its compiles overlap the port's tests; the port
  is fed its parameters, on which it also serves the reference's
  mixed-level batch (two ``q16_16`` lanes, two ``f32``) and each of its
  requests alone;
* the port alone: a paged batch equals each request served alone at
  its level (isolation through the gather / scatter path), speculative
  paged serving equals paged vanilla ``f32``, slot churn drains the
  pool, EOS mode equals the contiguous engine, ``ceil(tail / C)`` chunks
  an admission, prefix sharing on equals off (3 hits), a tight pool
  queues admission and serves everything, the pool's gauges are in the
  metrics, and ``BatchedServer`` rejects the paged pool.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import (  # noqa: E402
    PAGED_MAX_LEN,
    PAGED_PAGE_SIZE,
    PAGED_WORKLOAD,
    start_shared,
    wait_shared,
)
from _torch_spec_harness import load_reference  # noqa: E402
from repro_torch.configs import smoke  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    BatchedServer,
    ContinuousBatchingServer,
    Request,
    ServingConfig,
    SpeculativeConfig,
)

MAX_LEN = 32
PROMPTS = [
    [1, 2, 3, 4, 5],
    [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17],
    [3, 1, 4],
    [2, 7, 1, 8, 2, 8, 1, 8, 2, 8],
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The smoke model's tensors are tiny: torch's intra-op threads only
    contend with the JAX child's compiles (the module runs several times
    faster on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_child(request, tmp_path_factory):
    """The JAX paged server's tokens, computed in a child process that
    runs while the port's tests do."""
    return start_shared(request, tmp_path_factory)


_MODELS, _ALONE = {}, {}


def _model(arch):
    if arch not in _MODELS:
        cfg = smoke(arch)
        _MODELS[arch] = (cfg, init_params(cfg, seed=0, device="cpu"))
    return _MODELS[arch]


def _paged(n_slots=2, **kw):
    kw.setdefault("max_len", MAX_LEN)
    return ServingConfig(n_slots=n_slots, cache="paged", page_size=4, **kw)


def _server(arch, scfg):
    cfg, params = _model(arch)
    return ContinuousBatchingServer(cfg, params, scfg, device="cpu")


def _serve_alone(arch, prompt, max_new, level):
    if arch not in _ALONE:
        _ALONE[arch] = _server(arch, _paged(n_slots=1))
    return _ALONE[arch].generate([prompt], max_new=max_new, level=level)[0]


def _drained(srv):
    return all(g["alloc"].live() == [] for g in srv.cache_ops.groups.values())


@pytest.mark.parametrize("arch", ["deepseek_7b", "gemma2_2b"])
def test_paged_batch_equals_alone(arch):
    srv = _server(arch, _paged(n_slots=2))
    outs = srv.generate(PROMPTS, max_new=6, level="f32")
    for p, o in zip(PROMPTS, outs):
        assert o == _serve_alone(arch, p, 6, "f32")
    assert _drained(srv)


def test_paged_one_fast_lane_among_f32_equals_alone():
    """Isolation across levels through the mixed-level paged pass on the
    port's own parameters: one ``q16_16`` lane among ``f32`` lanes.
    ``q16_16`` lanes that share a pass share its per-tensor activation
    exponents by design, in both packages, so on these parameters two of
    them do not each equal their run alone; the reference's two-lane
    batch runs on JAX's parameters in
    :func:`test_paged_mixed_levels_equal_alone`."""
    srv = _server("deepseek_7b", _paged(n_slots=4))
    levels = ["q16_16", "f32", "f32", "f32"]
    reqs = [Request(rid=srv.next_rid(), prompt=p, max_new=5, level=lv)
            for p, lv in zip(PROMPTS, levels)]
    fins = srv.serve(reqs)
    assert srv.stats["level_passes"] > srv.stats["decode_steps"]  # mixed passes ran
    for r, lv in zip(reqs, levels):
        assert fins[r.rid].tokens == _serve_alone("deepseek_7b", r.prompt, 5, lv)


@pytest.mark.parametrize("arch", ["deepseek_7b", "gemma2_2b"])
def test_paged_speculative_equals_vanilla_f32(arch):
    """The verify's k+1-row scatter, rejected rows with their restored
    bits, is a bit-exact page restore (gemma2: across the window)."""
    spec = SpeculativeConfig(k=3, max_len=MAX_LEN)
    s_spec = _server(arch, _paged(n_slots=2, speculative=spec))
    o_spec = s_spec.generate(PROMPTS, max_new=8, speculative=True)
    assert o_spec == _server(arch, _paged(n_slots=2)).generate(PROMPTS, max_new=8, level="f32")
    assert s_spec.stats["spec_rounds"] > 0 and _drained(s_spec)


def test_paged_slot_churn_and_reuse():
    prompts = [[(7 * i + j) % 120 + 1 for j in range(3 + (5 * i) % 9)] for i in range(7)]
    srv = _server("gemma2_2b", _paged(n_slots=2))
    outs = srv.generate(prompts, max_new=4, level="f32")
    for p, o in zip(prompts, outs):
        assert o == _serve_alone("gemma2_2b", p, 4, "f32")
    assert _drained(srv)


def test_paged_eos_mode():
    base = _server("deepseek_7b", ServingConfig(n_slots=2, max_len=MAX_LEN))
    eos = int(base.generate(PROMPTS, max_new=8, level="f32")[0][len(PROMPTS[0]) + 1])
    s_c = _server("deepseek_7b", ServingConfig(n_slots=2, max_len=MAX_LEN, eos_id=eos))
    s_p = _server("deepseek_7b", _paged(n_slots=2, eos_id=eos))
    got = s_p.generate(PROMPTS, max_new=8, level="f32")
    assert got == s_c.generate(PROMPTS, max_new=8, level="f32")
    assert got[0][-1] == eos and len(got[0]) == len(PROMPTS[0]) + 2


@pytest.mark.parametrize("chunk", [None, 8])
def test_chunk_count_per_admission(chunk):
    """``ceil(tail / C)`` chunks an admission whatever the lengths, and the
    chunk size changes no token."""
    srv = _server("deepseek_7b", _paged(n_slots=2, prefill_chunk=chunk))
    burst = [[(i * 13 + j) % 120 + 1 for j in range(1 + 2 * i)] for i in range(8)]
    outs = srv.generate(burst, max_new=2, level="f32")
    C = srv.scfg.resolved_chunk
    assert C == (chunk or 4)
    assert srv.stats["prefill_chunks"] == sum(-(-len(p) // C) for p in burst)
    assert srv.stats["prefills"] == len(burst)
    for p, o in zip(burst[::3], outs[::3]):
        assert o == _serve_alone("deepseek_7b", p, 2, "f32")


def test_prefix_sharing_token_identical_and_counted():
    shared = list(range(1, 13))  # 3 full pages of 4
    prompts = [shared + [50 + i, 70 + i] for i in range(4)]
    s_off = _server("deepseek_7b", _paged(n_slots=2))
    o_off = s_off.generate(prompts, max_new=5, level="f32")
    s_on = _server("deepseek_7b", _paged(n_slots=2, prefix_sharing=True))
    assert s_on.generate(prompts, max_new=5, level="f32") == o_off
    assert s_on.stats["prefix_hits"] == 3
    assert s_on.stats["prefix_tokens_reused"] == 3 * 12
    assert s_on.stats["prefill_chunks"] < s_off.stats["prefill_chunks"]
    g = s_on.cache_ops.groups[f"L{MAX_LEN}"]
    assert (g["table"] == 0).all() and len(s_on.cache_ops.prefix) > 0
    s_on.cache_ops.prefix.drop_all()
    assert g["alloc"].live() == []


def test_prefix_sharing_speculative_still_exact():
    prompts = [list(range(1, 9)) + [40 + i] for i in range(3)]
    s = _server("deepseek_7b", _paged(n_slots=2, prefix_sharing=True,
                                      speculative=SpeculativeConfig(k=2, max_len=MAX_LEN)))
    o = s.generate(prompts, max_new=5, speculative=True)
    assert o == _server("deepseek_7b", _paged(n_slots=2)).generate(prompts, max_new=5,
                                                                     level="f32")
    assert s.stats["prefix_hits"] > 0


def test_prefix_sharing_rejected_for_windowed_models():
    with pytest.raises(ValueError, match="prefix_sharing"):
        _server("gemma2_2b", _paged(n_slots=2, prefix_sharing=True))


def test_tight_pool_queues_admission_but_serves_all():
    """8 usable pages: a 10-token prompt takes 3 blocks and grows to 4, so
    at most two of the four slots are resident at once."""
    srv = _server("deepseek_7b", ServingConfig(n_slots=4, max_len=MAX_LEN, cache="paged",
                                               page_size=4, n_pages=9))
    prompts = [[(11 * i + j) % 120 + 1 for j in range(10)] for i in range(6)]
    outs = srv.generate(prompts, max_new=4, level="f32")
    for p, o in zip(prompts, outs):
        assert o == _serve_alone("deepseek_7b", p, 4, "f32")
    assert _drained(srv)
    assert srv.cache_ops.groups[f"L{MAX_LEN}"]["alloc"].high_water <= 8


def test_pool_gauges_in_metrics():
    srv = _server("gemma2_2b", _paged(n_slots=2))
    srv.generate(PROMPTS[:2], max_new=3, level="q16_16")
    snap = srv.metrics_snapshot()
    assert snap["pages_live"] == {"group=L8": 0, "group=L32": 0}
    assert snap["pages_free"]["group=L8"] == 2 * 2 and snap["pages_free"]["group=L32"] == 2 * 8
    assert snap["pages_high_water"]["group=L8"] == 4
    assert snap["page_allocs_total"]["group=L32"] > 0 and snap["prefill_chunks_total"] > 0
    text = srv.render_prometheus()
    assert 'pages_free{group="L32"} 16' in text and "cow_copies_total 0" in text


def test_batched_server_rejects_paged():
    cfg, params = _model("deepseek_7b")
    with pytest.raises(ValueError, match="contiguous"):
        BatchedServer(cfg, params, _paged(), device="cpu")


@pytest.fixture(scope="module")
def jax_run(jax_child):
    """(the JAX child's records, the port's parameters built from its)."""
    return load_reference(wait_shared(jax_child, "deepseek_7b", "paged"))


@pytest.fixture(scope="module")
def paged_pair(jax_run):
    """(JAX's tokens by rid, the port's run of the same batch on JAX's
    parameters)."""
    ref, params = jax_run
    srv = ContinuousBatchingServer(
        smoke("deepseek_7b"), params,
        ServingConfig(n_slots=2, max_len=PAGED_MAX_LEN, cache="paged", page_size=PAGED_PAGE_SIZE),
        device="cpu")
    fins = srv.serve([Request(rid=i, prompt=list(p), max_new=n, level=lv)
                      for i, (p, n, lv) in enumerate(PAGED_WORKLOAD)])
    return {i: ref[f"paged/tokens{i}"].tolist() for i in fins}, fins, srv


@pytest.mark.parametrize("rid", range(len(PAGED_WORKLOAD)))
def test_paged_tokens_identical_to_reference(paged_pair, rid):
    """One mixed-level batch through both packages' paged servers."""
    ref, fins, srv = paged_pair
    assert fins[rid].tokens == ref[rid]
    assert srv.stats["level_passes"] > srv.stats["decode_steps"]  # mixed passes ran


def test_paged_mixed_levels_equal_alone(jax_run):
    """The reference's batch (tests/test_paged_serving.py, two ``q16_16``
    and two ``f32`` lanes on 4 slots) on JAX's parameters: each lane's
    tokens equal serving it alone at its level."""
    _, params = jax_run
    cfg = smoke("deepseek_7b")
    srv = ContinuousBatchingServer(cfg, params, _paged(n_slots=4), device="cpu")
    alone = ContinuousBatchingServer(cfg, params, _paged(n_slots=1), device="cpu")
    levels = ["q16_16", "f32", "q16_16", "f32"]
    reqs = [Request(rid=srv.next_rid(), prompt=p, max_new=5, level=lv)
            for p, lv in zip(PROMPTS, levels)]
    fins = srv.serve(reqs)
    assert srv.stats["level_passes"] > srv.stats["decode_steps"]  # mixed passes ran
    for r, lv in zip(reqs, levels):
        assert fins[r.rid].tokens == alone.generate([r.prompt], max_new=5, level=lv)[0]
