"""The port's ``PrecisionArbiter`` against the JAX package's: the same
telemetry in, the same recommendations and decision log out, step for
step.  The scenarios are the telemetry sequences of
``tests/test_arbiter.py`` (cooldown against flapping, the non-finite
override, the promotion counter) and the arbiter cases of
``tests/test_precision.py``, plus the multi-rung ladders of the examples
and a loss regression.  Decisions compare exactly (step, entry, reason);
a Mode entry compares by its value, since the two packages have their
own ``Mode`` enums.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import arbiter as jarb  # noqa: E402
from repro_torch.core import arbiter as tarb  # noqa: E402


def healthy(start, n, loss=1.0, gnorm=1.0):
    return [(s, loss, gnorm) for s in range(start, start + n)]


#: name -> (ArbiterConfig kwargs, telemetry [(step, loss, grad_norm)],
#: step before which ``_last_switch_step`` is forced to step - 1, as
#: tests/test_arbiter.py does to start mid-cooldown, or None)
SCENARIOS = {
    # tests/test_arbiter.py
    "cooldown_suppresses_flapping": (
        dict(spike_factor=4.0, stable_steps=2, cooldown_steps=10),
        healthy(0, 16) + [(16, 1.0, 100.0)] + healthy(17, 14)
        + [(s, 1.0, 100.0) for s in range(31, 45)], None),
    "cooldown_blocks_promotion": (
        dict(spike_factor=2.0, stable_steps=1, cooldown_steps=40),
        healthy(0, 16) + [(16, 1.0, 50.0)] + healthy(17, 41), None),
    "nonfinite_inside_cooldown": (
        dict(spike_factor=4.0, stable_steps=1, cooldown_steps=100),
        healthy(0, 16) + [(16, 1.0, 500.0), (17, float("nan"), 1.0)], 16),
    "nonfinite_inf": (
        dict(cooldown_steps=10**6), healthy(0, 10) + [(10, math.inf, 1.0)], 10),
    "nonfinite_not_in_window": (
        dict(cooldown_steps=0), healthy(0, 12) + [(12, float("nan"), 1.0)] + healthy(13, 5),
        None),
    "promotion_counter_resets": (
        dict(spike_factor=4.0, stable_steps=8, cooldown_steps=0),
        healthy(0, 16) + [(16, 1.0, 100.0)] + healthy(17, 6) + [(23, 1.0, 200.0)]
        + healthy(24, 8), None),
    "decision_log_reasons": (
        dict(spike_factor=4.0, cooldown_steps=0, stable_steps=2),
        healthy(0, 16) + [(16, 1.0, 99.0)] + healthy(17, 4), None),
    # tests/test_precision.py
    "nan_fallback": (
        dict(cooldown_steps=0), healthy(0, 10, loss=2.0) + [(10, float("nan"), 1.0)], None),
    "spike_fallback_and_promotion": (
        dict(spike_factor=4.0, stable_steps=8, cooldown_steps=2),
        healthy(0, 16) + [(16, 1.0, 100.0)] + healthy(17, 32, loss=0.9), None),
    "cooldown_prevents_flapping": (
        dict(spike_factor=2.0, stable_steps=1, cooldown_steps=50),
        healthy(0, 16) + [(16, 1.0, 50.0)] + healthy(17, 23), None),
    # examples/precision_arbiter_demo.py: four rungs, a spike, then a NaN
    "four_rung_ladder": (
        dict(spike_factor=4.0, stable_steps=6, cooldown_steps=2,
             ladder=("q8_8", "q16_16", "q8_24", "f32"), start_mode="q8_8"),
        [(s, 2.0 - 0.01 * s, 1.0) for s in range(10)] + [(10, 1.9, 40.0),
                                                          (11, float("nan"), 1.0)]
        + [(s, 1.8 - 0.004 * s, 1.0) for s in range(12, 60)], None),
    # a loss trend upwards trips the regression channel
    "loss_regression": (
        dict(regress_tol=0.25, cooldown_steps=4, stable_steps=10),
        [(s, 1.0 + 0.05 * s, 1.0) for s in range(30)] + healthy(30, 40, loss=2.5), None),
    # examples/sensor_fusion.py's arbiter: spikes only, a two-rung ladder
    "sensor_fusion_ladder": (
        dict(spike_factor=6.0, regress_tol=float("inf"), stable_steps=40, cooldown_steps=10,
             ladder=("q8_24", "f32"), start_mode="q8_24"),
        [(s, 0.01 * (1 + s % 3), 0.01 + 0.001 * (s % 5)) for s in range(180)]
        + [(s, 0.5, 2.0 + s % 4) for s in range(180, 200)]
        + [(s, 0.01, 0.011) for s in range(200, 300)], None),
}


def _norm(entry):
    return getattr(entry, "value", entry)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decision_log_matches_reference(name):
    kwargs, telemetry, force_at = SCENARIOS[name]
    jcfg, tcfg = jarb.ArbiterConfig(**kwargs), tarb.ArbiterConfig(**kwargs)
    if "ladder" not in kwargs:
        assert _norm(tcfg.ladder[0]) == _norm(jcfg.ladder[0]) == "fast"
    j, t = jarb.PrecisionArbiter(jcfg), tarb.PrecisionArbiter(tcfg)
    for step, loss, gnorm in telemetry:
        if step == force_at:
            j._last_switch_step = t._last_switch_step = step - 1
        got, want = t.observe(step, loss, gnorm), j.observe(step, loss, gnorm)
        assert _norm(got) == _norm(want), (name, step)
        assert (t.rung, t._stable, list(t._losses)) == (j.rung, j._stable, list(j._losses))
    assert [(s, _norm(e), r) for s, e, r in t.decisions] == \
        [(s, _norm(e), r) for s, e, r in j.decisions]
    assert t.decisions, f"scenario {name} makes no decision"


def test_default_ladder_returns_the_ports_modes():
    from repro_torch.core.precision import Mode

    arb = tarb.PrecisionArbiter(tarb.ArbiterConfig(cooldown_steps=0))
    assert arb.mode is Mode.FAST and arb.ladder == (Mode.FAST, Mode.PRECISE)
    assert arb.observe(0, float("nan"), 1.0) is Mode.PRECISE


def test_bad_configs_raise_as_the_reference():
    with pytest.raises(ValueError, match="at least one entry"):
        tarb.PrecisionArbiter(tarb.ArbiterConfig(ladder=()))
    with pytest.raises(ValueError, match="not in the ladder"):
        tarb.PrecisionArbiter(tarb.ArbiterConfig(ladder=("q8_24", "f32"), start_mode="q16_16"))


def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sensor_fusion_example_switches_as_the_reference():
    """examples/sensor_fusion.py steps up to f32 at step 180 (the burst)
    and back to q8_24 at 239; the port's example, on the CPU, the same."""
    switches = _example("torch_sensor_fusion").main("cpu")
    assert [(s, lvl, reason.split()[0]) for s, lvl, reason, _ in switches] == [
        (180, "f32", "grad-spike"), (239, "q8_24", "stable")]


def test_precision_arbiter_demo_matches_the_reference_decisions():
    from repro.core import arbiter as j
    from repro.core.precision import MathEngine as JEngine

    got = _example("torch_precision_arbiter_demo").main("cpu")
    want_arb = j.PrecisionArbiter(j.ArbiterConfig(
        spike_factor=4.0, stable_steps=6, cooldown_steps=2,
        ladder=("q8_8", "q16_16", "q8_24", "f32"), start_mode="q8_8"))
    eng = JEngine("q8_8")
    telemetry = SCENARIOS["four_rung_ladder"][1]
    for step, loss, gnorm in telemetry:
        rec = want_arb.observe(step, loss, gnorm)
        if rec is not None:
            eng.set_level(rec)
    assert got == want_arb.decisions


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_sensor_fusion",
                                  "torch_precision_arbiter_demo"])
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main()
