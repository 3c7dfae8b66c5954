"""The port's ladder-speculative decoding (``repro_torch.runtime.
speculative`` and the server's speculative requests) against the JAX
package, mirroring tests/test_speculative.py for the ported families
(deepseek_7b; gemma2_2b, whose 8-row local window the rounds wrap),
through the port-side harness ``tests/_torch_spec_harness.py``.

The JAX side runs in two child processes (``tests/_torch_jax_child.py
OUT ARCH spec``, excess precision off), started with the paged module's
run by the first of the two modules to start (``start_shared``), so
their compiles overlap the port-only tests:

* token exactness: each family x draft rung x seed, the speculative
  stream equals JAX's ``vanilla_greedy_reference``, and the port's own
  ``vanilla_greedy_reference`` equals it too;
* the per-round trace (drafts, verify argmaxes, commit counts, active
  lanes) of ``LadderSpeculativeDecoder`` at ``q8_8`` and at ``q16_16``
  equals JAX's on seed 0 (gemma2's JAX draft unrolled, see the child);
* rollback after one real round on a contiguous pool: the draft leaves
  the pool bit for bit as it found it, rejected rows (wrapped window
  rows included) are the pre-round rows bit for bit, kept rows within
  1e-4 of sequential ``f32`` decode of the accepted tokens (the verify's
  GEMM of k+1 rows sums in another order than decode's of 1), positions
  exact; the next query reads rows of the window that a skipped draft
  restore would have hidden;
* the acceptance counters equal ``spec_harness.simulate_acceptance``'s
  replay of the trace;
* validation, EOS, k variation, and the server: speculative serving
  equals vanilla ``f32`` serving (contiguous pool), mixed traffic, and
  the draft arbiter's escalation on low acceptance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import (  # noqa: E402
    SPEC_K,
    SPEC_MAX_LEN,
    SPEC_MAX_NEW,
    SPEC_SEEDS,
    start_shared,
    wait_shared,
)
from _torch_spec_harness import (  # noqa: E402
    FAMILIES,
    TRACE_KEYS,
    TorchExactnessHarness,
    load_reference,
)
from repro_torch.configs import smoke  # noqa: E402
from repro_torch.core.arbiter import SlotArbiterConfig  # noqa: E402
from repro_torch.core.precision import MathEngine  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    SPEC_DRAFT_LEVELS,
    ContinuousBatchingServer,
    LadderSpeculativeDecoder,
    Request,
    ServingConfig,
    SpeculativeConfig,
    register_spec_steps,
    vanilla_greedy_reference,
)
from spec_harness import DRAFT_RUNGS, make_prompts  # noqa: E402

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
def jax_children(request, tmp_path_factory):
    return start_shared(request, tmp_path_factory)


_HARNESS = {}


@pytest.fixture(scope="module")
def harness(jax_children):
    """family -> (JAX records, harness on JAX's parameters)."""
    if not _HARNESS:
        for f in FAMILIES:
            ref, params = load_reference(wait_shared(jax_children, f, "spec"))
            _HARNESS[f] = (ref, TorchExactnessHarness(f, params))
    return _HARNESS


# ---------------------------------------------------------------------------
# port-only: validation, the server (torch's own random parameters)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma2():
    cfg = smoke("gemma2_2b")
    return cfg, init_params(cfg, seed=5, device="cpu")


def _spec_cfg(**kw):
    return SpeculativeConfig(k=3, draft_level="q8_8", max_len=64, **kw)


def test_speculative_config_validation():
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpeculativeConfig(k=0)
    for bad in ("f32", "nope"):
        with pytest.raises(ValueError, match="not a draft rung"):
            SpeculativeConfig(draft_level=bad)
    assert [lv for lv, _ in SPEC_DRAFT_LEVELS] == list(DRAFT_RUNGS)


def test_k_must_fit_smallest_attention_window():
    cfg = smoke("gemma2_2b")
    w = min(l.window for l in cfg.period if l.window is not None)
    with pytest.raises(ValueError, match="smallest attention window"):
        register_spec_steps(MathEngine("q8_8"), cfg, k=w)
    register_spec_steps(MathEngine("q8_8"), cfg, k=w - 1)


def test_generate_rejects_insufficient_headroom(gemma2):
    cfg, params = gemma2
    dec = LadderSpeculativeDecoder(cfg, params, _spec_cfg(), device="cpu")
    with pytest.raises(ValueError, match="headroom"):
        dec.generate([[1, 2, 3]], max_new=200)


def test_server_speculative_matches_vanilla_f32_serving(gemma2):
    """5 requests on 3 slots (churn): every speculative request's tokens
    equal the vanilla f32 server's, and drafts were accepted."""
    cfg, params = gemma2
    prompts = make_prompts(cfg.vocab, 7) + make_prompts(cfg.vocab, 8)[:2]
    ref = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=3, max_len=64),
                                   device="cpu").generate(prompts, max_new=12, level="f32")
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(
        n_slots=3, max_len=64, speculative=_spec_cfg()), device="cpu")
    assert srv.generate(prompts, max_new=12, speculative=True) == ref
    assert srv.stats["spec_rounds"] > 0
    assert 0 < srv.stats["spec_accepted"] <= srv.stats["spec_drafted"]
    snap = srv.metrics_snapshot()
    assert snap["spec_acceptance_rate"] == srv.stats["spec_accepted"] / srv.stats["spec_drafted"]
    assert snap["host_syncs_total"]["kind=spec"] == srv.stats["spec_rounds"]


def test_server_mixed_spec_and_vanilla_traffic(gemma2):
    cfg, params = gemma2
    prompts = make_prompts(cfg.vocab, 9)
    ref = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=2, max_len=64),
                                   device="cpu").generate(prompts, max_new=8, level="f32")
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(
        n_slots=2, max_len=64, speculative=_spec_cfg()), device="cpu")
    reqs = [Request(rid=i, prompt=list(p), max_new=8, speculative=(i % 2 == 0),
                    level=None if i % 2 == 0 else "q16_16")
            for i, p in enumerate(prompts)]
    fins = srv.serve(reqs)
    for i in range(len(prompts)):
        if i % 2 == 0:
            assert fins[i].tokens == ref[i], f"spec lane {i} diverged"
        else:
            assert fins[i].n_generated == 8


def test_server_rejects_spec_request_without_spec_config(gemma2):
    cfg, params = gemma2
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=1, max_len=64),
                                   device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        srv.serve([Request(rid=0, prompt=[1, 2], max_new=2, speculative=True)])
    assert not srv.scheduler.has_work()


def test_server_low_acceptance_escalates_draft_rung(gemma2):
    cfg, params = gemma2
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(
        n_slots=1, max_len=64, speculative=_spec_cfg(),
        arbiter=SlotArbiterConfig(n_levels=2, accept_threshold=1.01, accept_patience=1,
                                  cooldown_steps=1, stable_steps=10**6)), device="cpu")
    names = tuple(lv for lv, _ in SPEC_DRAFT_LEVELS)
    assert srv.draft_arbiter.idx[0] == names.index("q8_8")
    fins = srv.serve([Request(rid=0, prompt=[3, 1, 4, 1, 5], max_new=10, speculative=True)])
    assert fins[0].n_generated == 10
    assert srv.draft_arbiter.idx[0] == names.index("q16_16")
    assert any(reason == "acceptance" for *_, reason in srv.draft_arbiter.switches)
    assert srv.metrics_snapshot()["arbiter_switches_total"]["arbiter=draft,cause=acceptance"] >= 1


# ---------------------------------------------------------------------------
# against the JAX package (parameters from the children)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("rung", DRAFT_RUNGS)
@pytest.mark.parametrize("seed", SPEC_SEEDS)
def test_token_exactness(harness, family, rung, seed):
    ref, h = harness[family]
    rep = h.run_exactness(rung, seed)
    n = len(rep.speculative)
    want = ref["spec/vanilla"][SPEC_SEEDS.index(seed) * n:(SPEC_SEEDS.index(seed) + 1) * n]
    assert rep.speculative == want.tolist(), f"{family}/{rung}/seed{seed}"
    assert rep.accounting_ok, (rep.accounting, rep.simulator)
    assert 0.0 <= rep.acceptance_rate <= 1.0


@pytest.mark.parametrize("family", FAMILIES)
def test_vanilla_reference_equals_jax(harness, family):
    ref, h = harness[family]
    prompts = [p for seed in SPEC_SEEDS for p in make_prompts(h.cfg.vocab, seed)]
    got = vanilla_greedy_reference(h.cfg, h.params, prompts, SPEC_MAX_NEW, SPEC_MAX_LEN,
                                   device="cpu")
    assert got == ref["spec/vanilla"].tolist()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("rung", DRAFT_RUNGS)
def test_round_trace_equals_jax(harness, family, rung):
    """Drafts at the rung (``q8_8``: Q8.8-snapped activations into K1/K2's
    plain versions), verify argmaxes, commit counts and active lanes of
    every round equal the reference decoder's."""
    ref, h = harness[family]
    rep = h.run_exactness(rung, SPEC_SEEDS[0])
    assert rep.speculative == ref[f"spec/{rung}/tokens"].tolist()
    for key in TRACE_KEYS:
        np.testing.assert_array_equal(rep.trace[key], ref[f"spec/{rung}/{key}"], err_msg=key)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", SPEC_SEEDS)
def test_rollback_cache(harness, family, seed):
    _, h = harness[family]
    res = h.run_rollback("q8_8", seed)
    assert res["draft_restored"], "the draft left rows of its rung in the pool"
    assert res["rejected_bit_exact"], res
    assert res["kept_max_err"] <= 1e-4, res
    assert res["positions_beyond_keep"] == 0, res
    assert res["next_logit_gap"] <= 1e-4, res


def test_draft_rollback_keeps_window_rows(harness):
    """gemma2's 8-row windows: rejected slots hold older positions the
    next query still attends to.  With the draft's restore they come back
    bit for bit and the next query agrees with sequential decode; without
    it they keep the draft's rows, which the checks catch."""
    _, h = harness["gemma2_2b"]
    runs = [h.run_rollback(rung, seed) for rung in DRAFT_RUNGS for seed in SPEC_SEEDS]
    hit = [r for r in runs if r["rejected_rows_in_next_window"] > 0]
    assert hit, runs
    assert all(r["rejected_bit_exact"] and r["next_logit_gap"] <= 1e-4 for r in hit)
    broken = h.run_rollback(DRAFT_RUNGS[0], SPEC_SEEDS[0], restore=False)
    assert not broken["draft_restored"] and not broken["rejected_bit_exact"]


def test_rollback_sweep_includes_real_rejections(harness):
    for family in FAMILIES:
        _, h = harness[family]
        assert any(h.run_rollback("q8_8", seed)["had_rejections"] for seed in SPEC_SEEDS)


def test_acceptance_rates_vary_across_rungs_and_families(harness):
    rates = [harness[f][1].run_exactness(rung, SPEC_SEEDS[0]).acceptance_rate
             for f in FAMILIES for rung in DRAFT_RUNGS]
    assert any(r > 0.0 for r in rates) and any(r < 1.0 for r in rates), rates


def test_k_variation_token_exactness(harness):
    ref, h = harness["gemma2_2b"]
    base = ref["spec/vanilla"][:3].tolist()
    for k in (1, 5):
        rep = TorchExactnessHarness("gemma2_2b", h.params, k=k).run_exactness("q16_16", 0)
        assert rep.speculative == base, f"k={k} changed tokens"
        assert rep.accounting_ok


def test_eos_truncates_like_vanilla(harness):
    ref, h = harness["deepseek_7b"]
    vanilla = ref["spec/vanilla"][:3].tolist()
    eos = vanilla[0][3]
    dec = LadderSpeculativeDecoder(h.cfg, h.params, SpeculativeConfig(
        k=SPEC_K, draft_level="q8_8", max_len=SPEC_MAX_LEN, eos_id=eos), device="cpu")
    got = dec.generate(make_prompts(h.cfg.vocab, 0), max_new=SPEC_MAX_NEW)
    for g, r in zip(got, vanilla):
        assert g == (r[: r.index(eos) + 1] if eos in r else r)
