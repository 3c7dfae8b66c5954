"""The families the MoE slice ports — granite_moe_3b_a800m and
mixtral_8x22b (Mixture-of-Experts, mixtral with an 8-row smoke window)
and command_r_35b (dense, tied embeddings) — against the JAX package at
smoke size, model and server.

JAX runs in child processes (``tests/_torch_jax_child.py OUT ARCH moe``
for the MoE models, ``... command_r_35b model``;
``--xla_allow_excess_precision=false``), started once for this module
and tests/test_torch_moe.py.  Each writes the smoke model's parameters,
then per rung a prefill of 11 tokens and 6 greedy decode steps.
Tolerances, as tests/test_torch_model.py's:

* FAST rung (K1-K4 and, for the MoE models, the grouped K1/K2 experts):
  caches bit for bit, logits within 1e-5;
* exact rung: logits and caches within 1e-4 (f32 matmuls summed in
  another order), the greedy tokens equal.

Serving (mixtral_8x22b, on JAX's parameters): the reference test's
static server on the contiguous pool (tests/test_substrates.py::
test_serving_decode_consistency_all_families[mixtral_8x22b]: one slot,
``f32``, 4 new tokens) gives JAX's tokens and its own prefill-only
greedy continuation; one mixed ``q16_16`` / ``f32`` batch through a
paged ``ContinuousBatchingServer`` gives JAX's tokens, request for
request (``... mixtral_8x22b serve``), and the same batch through the
contiguous ``ContinuousBatchingServer`` gives each ``f32`` request the
paged pool's tokens (the paged pool's chunked prefill changes FAST
activations, and the reference's contiguous server compiles a prefill
per prompt length, ~18 s of the CPU, so its ``q16_16`` lanes are held
against themselves served alone).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import (  # noqa: E402
    BATCHED_PROMPT,
    DECODE_STEPS,
    PAGED_MAX_LEN,
    PAGED_PAGE_SIZE,
    PAGED_WORKLOAD,
    TOKENS,
    start_shared,
    wait_shared,
)
from _torch_spec_harness import load_reference  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache  # noqa: E402
from repro_torch.models.layers import attach_quantized_weights  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    BatchedServer,
    ContinuousBatchingServer,
    Request,
    ServingConfig,
)

RUNS = {"granite_moe_3b_a800m": "moe", "mixtral_8x22b": "moe", "command_r_35b": "model"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_child(request, tmp_path_factory):
    return start_shared(request, tmp_path_factory)


_RUNS = {}


def _run(jax_child, arch):
    """(JAX's records, the port's parameters, the port's prefill and
    decode records per rung)."""
    if arch in _RUNS:
        return _RUNS[arch]
    ref, params = load_reference(wait_shared(jax_child, arch, RUNS[arch]))
    cfg = smoke(arch)
    pa = attach_quantized_weights(params, QuantizedWeightCache())
    runs = {}
    for mode in ("exact", "fast"):
        caches = tm.init_caches(cfg, 1, 32, device="cpu")
        lp, caches = tm.prefill_step(pa, torch.from_numpy(TOKENS), caches, cfg, mode=mode)
        c1 = {pos: {k: v.clone().numpy() for k, v in node.items()} for pos, node in caches.items()}
        tokens, logits = ref[f"{mode}/tokens"], []
        for i in range(DECODE_STEPS):
            ld, caches = tm.decode_step(pa, torch.tensor([[int(tokens[i])]]),
                                        torch.tensor([TOKENS.shape[1] + i]), caches, cfg,
                                        mode=mode)
            logits.append(ld.numpy())
        runs[mode] = {"logits_prefill": lp.numpy(), "logits_decode": np.stack(logits),
                      "c1": c1, "c2": {pos: {k: v.numpy() for k, v in node.items()}
                                       for pos, node in caches.items()}}
    _RUNS[arch] = ref, params, runs
    return _RUNS[arch]


def test_configs_resolve_at_published_widths():
    g, m, c = (get_config(a) for a in ("granite_moe_3b_a800m", "mixtral_8x22b", "command_r_35b"))
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.head_dim, g.d_ff, g.vocab) == \
        (32, 1536, 24, 8, 64, 512, 49155)
    assert (g.moe.num_experts, g.moe.top_k, g.tie_embeddings) == (40, 8, False)
    assert (m.n_layers, m.d_model, m.n_heads, m.n_kv_heads, m.head_dim, m.d_ff) == \
        (56, 6144, 48, 8, 128, 16384)
    assert (m.moe.num_experts, m.moe.top_k, m.period[0].window) == (8, 2, 4096)
    assert (c.n_layers, c.d_model, c.d_ff, c.vocab, c.tie_embeddings) == \
        (40, 8192, 22528, 256000, True)
    s = smoke("granite_moe_3b_a800m")
    assert (s.moe.num_experts, s.moe.top_k, s.moe.capacity_factor) == (4, 2, 8.0)


@pytest.mark.parametrize("arch", list(RUNS))
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_logits_match_reference(jax_child, arch, mode):
    ref, _, runs = _run(jax_child, arch)
    tol = 1e-4 if mode == "exact" else 1e-5
    np.testing.assert_allclose(runs[mode]["logits_prefill"], ref[f"{mode}/logits_prefill"],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(runs[mode]["logits_decode"], ref[f"{mode}/logits_decode"],
                               rtol=tol, atol=tol)
    # the greedy stream JAX fed (argmax of each step) is the port's too
    assert runs[mode]["logits_decode"].argmax(-1)[:, 0].tolist() == \
        ref[f"{mode}/tokens"][1:].tolist()


@pytest.mark.parametrize("arch", list(RUNS))
@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("when", ["c1", "c2"])
def test_caches_match_reference(jax_child, arch, mode, when):
    """After the prefill (c1) and after the last decode step (c2)."""
    ref, _, runs = _run(jax_child, arch)
    for pos, node in runs[mode][when].items():
        for name, got in node.items():
            want = ref[f"{mode}/{when}/{pos}/{name}"]
            if mode == "fast" or name == "pos":
                np.testing.assert_array_equal(got, want, err_msg=f"{pos}/{name}")
            else:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{pos}/{name}")


@pytest.fixture(scope="module")
def mixtral(jax_child):
    ref, params = load_reference(wait_shared(jax_child, "mixtral_8x22b", "serve"))
    return ref, smoke("mixtral_8x22b"), params


def test_static_server_matches_reference_and_prefill_greedy(mixtral):
    """The mirror of test_serving_decode_consistency_all_families
    [mixtral_8x22b]: the server's decode equals greedy re-prefill, and
    both equal JAX's server."""
    ref, cfg, params = mixtral
    srv = BatchedServer(cfg, params, ServingConfig(n_slots=1, max_len=64, max_new=4),
                        device="cpu")
    out = srv.generate([BATCHED_PROMPT])[0]
    assert out == ref["serve/batched"].tolist()
    seq = list(BATCHED_PROMPT)
    for _ in range(4):
        caches = tm.init_caches(cfg, 1, 64, device="cpu")
        logits, _ = tm.prefill_step(params, torch.tensor([seq], dtype=torch.int32), caches, cfg,
                                    mode="exact")
        seq.append(int(logits[0].argmax()))
    assert out == seq


_BATCHES = {}


def _mixed_batch(cfg, params, cache):
    """{rid: tokens} of PAGED_WORKLOAD in one batch on ``cache``'s pool."""
    if cache not in _BATCHES:
        kw = dict(cache="paged", page_size=PAGED_PAGE_SIZE) if cache == "paged" else {}
        srv = ContinuousBatchingServer(cfg, params,
                                       ServingConfig(n_slots=2, max_len=PAGED_MAX_LEN, **kw),
                                       device="cpu")
        fins = srv.serve([Request(rid=i, prompt=list(p), max_new=n, level=lv)
                          for i, (p, n, lv) in enumerate(PAGED_WORKLOAD)])
        assert srv.stats["level_passes"] > srv.stats["decode_steps"]  # mixed passes ran
        _BATCHES[cache] = {i: f.tokens for i, f in fins.items()}
    return _BATCHES[cache]


@pytest.mark.parametrize("rid", range(len(PAGED_WORKLOAD)))
def test_paged_server_tokens_match_reference(mixtral, rid):
    """One mixed-level batch (more requests than slots, ragged lengths)
    through both packages' paged servers: the same tokens."""
    ref, cfg, params = mixtral
    got = _mixed_batch(cfg, params, "paged")
    assert got[rid] == ref[f"serve/paged/tokens{rid}"].tolist()


def test_contiguous_server_mixed_batch(mixtral):
    """The same batch on the contiguous pool: every ``f32`` request gives
    the paged pool's tokens (JAX's), every ``q16_16`` request its tokens
    served alone."""
    ref, cfg, params = mixtral
    got = _mixed_batch(cfg, params, "contiguous")
    alone = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=1, max_len=PAGED_MAX_LEN),
                                     device="cpu")
    for i, (prompt, n, level) in enumerate(PAGED_WORKLOAD):
        if level == "f32":
            assert got[i] == ref[f"serve/paged/tokens{i}"].tolist(), i
        else:
            assert got[i] == alone.generate([list(prompt)], max_new=n, level=level)[0], i


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "mixtral_8x22b"])
def test_moe_speculative_equals_vanilla_f32(arch, cache):
    """Speculative requests on a smoke MoE model give vanilla ``f32``
    greedy decode's tokens on both pools, at the production capacity
    factor (1.25: prefill drops tokens; the smoke config's 8 drops none):
    the verify's segment routes each token as the vanilla decode does.
    (At full depth the two exact paths' f32 noise flips routing
    decisions, in the reference too: chip_smoke.py holds speculative
    streams to vanilla's at full width and 4 layers, and reports them at
    full depth.)"""
    import dataclasses

    from repro_torch.runtime import SpeculativeConfig

    base = smoke(arch)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=1.25))
    params = tm.init_params(cfg, seed=0, device="cpu")
    prompts = [[(7 * i + j) % 120 + 1 for j in range(5 + 3 * i)] for i in range(4)]
    kw = dict(cache="paged", page_size=4) if cache == "paged" else {}
    spec = ContinuousBatchingServer(cfg, params, ServingConfig(
        n_slots=2, max_len=48, speculative=SpeculativeConfig(k=3, max_len=48), **kw), device="cpu")
    got = spec.generate(prompts, max_new=8, speculative=True)
    want = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=2, max_len=48, **kw),
                                    device="cpu").generate(prompts, max_new=8, level="f32")
    assert got == want
    assert spec.stats["spec_rounds"] > 0 and spec.stats["spec_accepted"] > 0
