"""The port's serving engine against the JAX package's on the same smoke
model and requests (greedy tokens identical at ``q16_16`` and ``f32`` in
one mixed batch), the per-request-precision isolation contract, slot
reuse hygiene, and a mirror of the scheduler / ``SlotArbiter`` unit
cases of tests/test_scheduler.py on the port's copies."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke as j_smoke  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.runtime.scheduler import Request as JRequest  # noqa: E402
from repro.runtime.serve import ContinuousBatchingServer as JServer  # noqa: E402
from repro.runtime.serve import ServingConfig as JConfig  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.arbiter import SlotArbiter, SlotArbiterConfig  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    BatchedServer,
    ContinuousBatchingServer,
    ContinuousScheduler,
    Request,
    ServingConfig,
)

# (prompt, max_new, level): more requests than slots, mixed levels; two
# prompt lengths only, since the JAX server compiles once per length
WORKLOAD = [
    ([1, 2, 3, 4, 5, 6], 6, "f32"),
    ([9, 8, 7, 6], 6, "q16_16"),
    ([5, 5, 5, 2, 2, 2], 4, "q16_16"),
    ([3, 1, 4, 1], 5, "f32"),
]


@pytest.fixture(scope="module")
def model():
    cfg = j_smoke("deepseek_7b")
    jp = j_init_params(cfg, jax.random.PRNGKey(4))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, t_smoke("deepseek_7b"), tp


@pytest.fixture(scope="module")
def served(model):
    jcfg, jp, tcfg, tp = model
    js = JServer(jcfg, jp, JConfig(n_slots=2, max_len=64))
    jf = js.serve([JRequest(rid=i, prompt=p, max_new=n, level=lv)
                   for i, (p, n, lv) in enumerate(WORKLOAD)])
    ts = ContinuousBatchingServer(tcfg, tp, ServingConfig(n_slots=2, max_len=64), device="cpu")
    tf = ts.serve([Request(rid=i, prompt=p, max_new=n, level=lv)
                   for i, (p, n, lv) in enumerate(WORKLOAD)])
    return js, jf, ts, tf


@pytest.mark.parametrize("rid", range(len(WORKLOAD)))
def test_greedy_tokens_identical_to_reference_server(served, rid):
    _, jf, _, tf = served
    assert tf[rid].tokens == jf[rid].tokens
    assert tf[rid].reason == jf[rid].reason == "max_new"


def test_counting_hooks_and_metric_names_match_reference(served):
    js, _, ts, _ = served
    assert ts.stats == js.stats
    assert ts.stats["level_passes"] > ts.stats["decode_steps"]  # mixed batches ran
    assert set(ts.metrics_snapshot()) == set(js.metrics_snapshot())
    # quantize-once: every weight matrix quantized at build, never per step
    assert ts.engine.weight_cache.quantize_calls == 7


@pytest.mark.parametrize("level", ["q16_16", "f32"])
def test_mixed_levels_identical_to_alone(model, level):
    *_, cfg, tp = model
    scfg = lambda: ServingConfig(n_slots=2, max_len=64)  # noqa: E731
    pa, pb = [1, 2, 3, 4, 5, 6], [9, 8, 7, 6]
    other = "f32" if level == "q16_16" else "q16_16"
    srv = ContinuousBatchingServer(cfg, tp, scfg(), device="cpu")
    fins = srv.serve([Request(rid=0, prompt=pa, max_new=5, level=level),
                      Request(rid=1, prompt=pb, max_new=5, level=other)])
    assert srv.stats["level_passes"] == 2 * srv.stats["decode_steps"]
    alone = ContinuousBatchingServer(cfg, tp, scfg(), device="cpu").serve(
        [Request(rid=0, prompt=pa, max_new=5, level=level)])[0]
    assert fins[0].tokens == alone.tokens


def test_slot_reuse_never_leaks_state(model):
    *_, cfg, tp = model
    late = [7, 3, 7, 3, 7]
    scfg = ServingConfig(n_slots=1, max_len=64, default_level="q16_16")
    churned = ContinuousBatchingServer(cfg, tp, scfg, device="cpu").generate(
        [[5, 5, 5, 5, 5, 5], [11, 12, 13], late], max_new=5)[-1]
    fresh = ContinuousBatchingServer(cfg, tp, scfg, device="cpu").generate([late], max_new=5)[0]
    assert churned == fresh


@pytest.mark.parametrize("level,mode", [("f32", "exact"), ("q16_16", "fast")])
def test_server_matches_teacher_forcing(model, level, mode):
    *_, cfg, tp = model
    srv = ContinuousBatchingServer(cfg, tp, ServingConfig(n_slots=2, max_len=64), device="cpu")
    prompt = [4, 5, 6, 7]
    got = srv.generate([prompt], max_new=4, level=level)[0]
    seq = list(prompt)
    pa = srv.params
    for _ in range(4):
        caches = tm.init_caches(cfg, 1, 64, device="cpu")
        logits, _ = tm.prefill_step(pa, torch.tensor([seq], dtype=torch.int32), caches, cfg,
                                    mode=mode)
        seq.append(int(logits[0].argmax()))
    if mode == "exact":
        assert got == seq
    else:
        # FAST prefill quantizes each activation tensor over the whole
        # prefix, decode over one row: the first token must agree
        assert got[len(prompt)] == seq[len(prompt)]


def test_eos_mode_and_batched_server(model):
    *_, cfg, tp = model
    srv = ContinuousBatchingServer(cfg, tp, ServingConfig(n_slots=2, max_len=64, eos_id=127),
                                   device="cpu")
    fins = srv.serve([Request(rid=0, prompt=[1, 2, 3], max_new=4),
                      Request(rid=1, prompt=[7, 7], max_new=3)])
    for rid, budget in ((0, 4), (1, 3)):
        assert fins[rid].reason in ("eos", "max_new") and fins[rid].n_generated <= budget
    assert srv.metrics_snapshot()["host_syncs_total"]["kind=eos"] >= 2
    static = BatchedServer(cfg, tp, ServingConfig(n_slots=2, max_len=64, max_new=4), device="cpu")
    outs = static.generate([[1, 2, 3, 4], [4, 3, 2, 1]])
    cont = ContinuousBatchingServer(cfg, tp, ServingConfig(n_slots=2, max_len=64),
                                    device="cpu").generate([[1, 2, 3, 4], [4, 3, 2, 1]], max_new=4)
    assert outs == cont  # same-length prompts: static == continuous


def test_serving_config_validation():
    """Mirrors tests/test_paged_serving.py::test_serving_config_validation:
    the paged knobs and their checks, as the reference validates them."""
    with pytest.raises(ValueError, match="cache"):
        ServingConfig(cache="mmap")
    with pytest.raises(ValueError, match="divide max_len"):
        ServingConfig(cache="paged", max_len=30, page_size=4)
    with pytest.raises(ValueError, match="requires cache='paged'"):
        ServingConfig(prefill_chunk=8)
    with pytest.raises(ValueError, match="requires cache='paged'"):
        ServingConfig(prefix_sharing=True)
    with pytest.raises(ValueError, match="n_pages"):
        ServingConfig(cache="paged", max_len=32, page_size=4, n_pages=3)
    with pytest.raises(ValueError, match="prefill_chunk == page_size"):
        ServingConfig(cache="paged", max_len=32, page_size=4, prefill_chunk=8,
                      prefix_sharing=True)
    with pytest.raises(ValueError, match="divide max_len"):
        ServingConfig(cache="paged", max_len=32, page_size=4, prefill_chunk=5)
    with pytest.raises(ValueError):
        ServingConfig(n_slots=0)
    assert ServingConfig(cache="paged", page_size=8).resolved_chunk == 8
    assert ServingConfig(cache="paged", max_len=32, page_size=4, n_pages=9).n_pages == 9
    assert ServingConfig().resolved_chunk is None
    # every case above raises on the reference's config too
    from repro.runtime.config import ServingConfig as JConfig
    for kw in ({"cache": "mmap"}, {"prefill_chunk": 8}, {"prefix_sharing": True},
               {"cache": "paged", "max_len": 32, "page_size": 4, "n_pages": 3}):
        with pytest.raises(ValueError):
            JConfig(**kw)


# ---------------------------------------------------------------------------
# scheduler and SlotArbiter (mirrors tests/test_scheduler.py)
# ---------------------------------------------------------------------------


def _req(rid, plen=4, max_new=4, level=None):
    return Request(rid=rid, prompt=list(range(1, plen + 1)), max_new=max_new, level=level)


def test_scheduler_fifo_admission_and_slot_binding():
    s = ContinuousScheduler(n_slots=2, max_len=32)
    for i in range(5):
        s.submit(_req(i))
    assert [(slot, r.rid) for slot, r in s.admit()] == [(0, 0), (1, 1)]
    assert s.admit() == []
    for _ in range(3):
        s.advance(1)
    assert s.advance(1) == "max_new"
    s.finish(1, [9, 9, 9, 9], "max_new")
    assert [(slot, r.rid) for slot, r in s.admit()] == [(1, 2)]


def test_scheduler_termination_reasons():
    s = ContinuousScheduler(n_slots=1, max_len=8, eos_id=99)
    s.submit(_req(0, plen=4, max_new=10))
    s.admit()
    assert s.advance(0, eos=False) is None
    assert s.advance(0, eos=True) == "eos"
    s.finish(0, [1, 99], "eos")
    s.submit(_req(1, plen=6, max_new=10))
    s.admit()
    assert s.advance(0) is None
    assert s.advance(0) == "max_len"


def test_scheduler_rejects_bad_requests():
    s = ContinuousScheduler(n_slots=1, max_len=8)
    s.submit(_req(0))
    with pytest.raises(ValueError):
        s.submit(_req(0))
    with pytest.raises(ValueError):
        s.submit(_req(1, plen=8))
    with pytest.raises(ValueError):
        Request(rid=2, prompt=[], max_new=4)


def test_slot_arbiter_nan_jumps_to_top_and_demotes_to_floor():
    arb = SlotArbiter(4, SlotArbiterConfig(n_levels=3, start_idx=0, stable_steps=2,
                                           cooldown_steps=2))
    arb.reset_slot(1, start_idx=1)
    idx = arb.observe(0, nonfinite=np.array([True, True, False, False]), amplitude=np.zeros(4))
    assert list(idx) == [2, 2, 0, 0]
    for step in range(1, 21):
        idx = arb.observe(step, nonfinite=np.zeros(4, bool), amplitude=np.zeros(4))
    assert list(idx) == [0, 1, 0, 0]


def test_slot_arbiter_amplitude_escalates_with_cooldown():
    arb = SlotArbiter(2, SlotArbiterConfig(n_levels=3, start_idx=0, amp_threshold=10.0,
                                           stable_steps=100, cooldown_steps=4))
    amp = np.array([100.0, 0.0])
    assert list(arb.observe(0, nonfinite=np.zeros(2, bool), amplitude=amp)) == [1, 0]
    assert list(arb.observe(1, nonfinite=np.zeros(2, bool), amplitude=amp)) == [1, 0]
    assert list(arb.observe(5, nonfinite=np.zeros(2, bool), amplitude=amp)) == [2, 0]


def test_arbiter_escalates_slot_mid_request(model):
    """An impossible amplitude threshold escalates a q16_16 request to
    f32 at a health sync; both levels then ran inside one request."""
    *_, cfg, tp = model
    srv = ContinuousBatchingServer(cfg, tp, ServingConfig(
        n_slots=1, max_len=64, health_sync_every=2, default_level="q16_16",
        arbiter=SlotArbiterConfig(n_levels=2, amp_threshold=-1.0, cooldown_steps=1,
                                  stable_steps=10**6)), device="cpu")
    fins = srv.serve([Request(rid=0, prompt=[1, 2, 3, 4], max_new=8)])
    assert fins[0].n_generated == 8
    assert srv.arbiter.idx[0] == 1
    assert any(reason == "amplitude" for *_, reason in srv.arbiter.switches)
    snap = srv.metrics_snapshot()
    assert snap["level_passes_total"]["level=q16_16"] > 0 and snap["level_passes_total"]["level=f32"] > 0
