"""The check that decides ``correct``, driven through the rest of a run on
the CPU (the port's plain kernel versions) at a size a test run holds:

* the plain reference agrees with the port at the cells' own limits, on a
  deepseek7b-shaped and a mixtral8x22b_2l-shaped configuration;
* the control, the reference at int4 in the program's place, reads over
  the limit;
* each fault of ``portbench/faults.py`` makes ``correct`` false: a
  decode step that leaves the KV pool as it was, half of a decode
  tick's lanes left out, a served token altered where it is produced.

The harness's look for a card is skipped (``device="cpu"``); everything
after it runs as on the card: weights drawn from the seed, the server
built and warmed up, offline batches served, the check on whole replayed
batches.  At this width the router's logits would be ~0.16 wide, so
nearly every token would sit on a routing tie; the MoE configuration's
router is scaled so its logits spread as at full width (~1.6).
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

DATA = os.path.join(ROOT, "portbench", "tests", "data")
CELLS = {"tiny_dense": "deepseek7b.codecomp_fast", "tiny_moe": "mixtral8x22b_2l.codecomp_fast"}


def _limits(cell):
    from portbench.check import load_limits

    return load_limits(ROOT, cell)


def _run(config, seed, monkeypatch, readings=()):
    from portbench import harness
    from portbench.traffic import Mix

    spec = harness.load_json(os.path.join(DATA, config + ".json"))
    draw = harness.draw_params

    def draw_scaled(cfg, s, device):
        p = draw(cfg, s, device)
        ffn = p["periods"]["pos0"]["ffn"]
        if "router" in ffn:
            ffn["router"].mul_(10.0)
        return p

    monkeypatch.setattr(harness, "draw_params", draw_scaled)
    mix = Mix.load(os.path.join(DATA, "tiny_mix.json"), "tiny_mix")
    cell = CELLS[config]
    return harness.run_cell(root=ROOT, workload=cell, spec=spec, mix=mix, seed=seed,
                            seconds=0.0, trace=False, per_layer=[],
                            limits=_limits(cell),
                            t_start=time.perf_counter(), device="cpu", readings=readings)


@pytest.mark.parametrize("config", sorted(CELLS))
def test_reference_agrees_with_the_port_and_the_control_does_not(config, monkeypatch):
    out = _run(config, 2 ** 31 + 101, monkeypatch, readings=("control",))
    assert out["failed"] == 0 and out["attempted"] == 6
    assert out["correct"], out["checks"]
    assert set(out["readings"]["control_checks"]) == set(_limits(CELLS[config]))
    assert any(c["value"] > c["limit"] for c in out["readings"]["control_checks"].values()), (
        out["readings"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["token_altered", "half_left_out", "kv_unwritten"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    import repro_torch.runtime.serve as serve_mod

    from portbench.faults import FAULTS

    name, broken = FAULTS[fault](serve_mod)
    monkeypatch.setattr(serve_mod, name, broken)
    for config in sorted(CELLS):
        out = _run(config, 2 ** 31 + 102, monkeypatch)
        assert not out["correct"], config
        assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]
