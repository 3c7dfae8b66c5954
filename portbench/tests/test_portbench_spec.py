"""BENCHMARK.json against the contract it is written to, and every entry
resolved to the files the harness finds it by."""

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    script = cmd[1]
    assert any(script.startswith(p + "/") for p in bench["paths"])
    assert os.path.exists(os.path.join(ROOT, script))
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_entries_resolve_to_their_files(bench):
    from portbench.traffic import Mix

    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            spec = json.load(f)
        assert spec["reduced"] == c["reduced"] and spec["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert len({c["file"] for c in bench["configs"]}) == len(configs)
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        Mix.load(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"), w["traffic"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits", w["name"] + ".json"))
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
    for m in bench["per_layer"]:
        path = os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py")
        assert os.path.exists(path), path
        from portbench.harness import load_reader

        assert callable(load_reader(ROOT, m["name"]))


def test_metrics_keys_units_and_bounds(bench):
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_moves_and_workloads_agree(bench):
    """Each per-layer metric moves an end-to-end metric, and every cell it
    lists reports that metric."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        moved_in = set(e2e[m["moves"]].get("workloads", cells))
        for w in m.get("workloads", cells):
            assert w in cells and w in moved_in
    for w in cells:
        reported = [m for m in bench["per_layer"] if w in m.get("workloads", cells)]
        assert reported, w
    # metrics of one layer name it letter for letter as PERF.md's list of layers
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in bench["per_layer"]}:
        assert layer in perf


def test_configs_differ_from_the_port_only_where_reduced(bench):
    """A configuration file holds the numbers it is run with; where they
    differ from the port's configuration, ``reduced`` names the key (a cut
    from the source) or ``port_differs`` does (the file follows the
    source where the port's registry departs from it)."""
    from repro_torch.configs import get_config

    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            spec = json.load(f)
        port = get_config(spec["arch"])
        layer = port.period[0]
        have = {"d_model": port.d_model, "n_layers": port.n_layers, "n_heads": port.n_heads,
                "n_kv_heads": port.n_kv_heads, "head_dim": port.head_dim, "d_ff": port.d_ff,
                "vocab": port.vocab, "rope_base": port.rope_base, "rms_eps": port.rms_eps}
        for k, v in have.items():
            assert spec[k] == v or k in spec["reduced"] or k in spec.get("port_differs", {}), (
                c["name"], k)
        assert spec["layer"]["kind"] == layer.kind and spec["layer"]["ffn"] == layer.ffn
        if spec.get("moe"):
            assert spec["moe"]["num_experts"] == port.moe.num_experts
            assert spec["moe"]["top_k"] == port.moe.top_k
        for k in spec["reduced"]:
            assert k in spec.get("published", {}), (c["name"], k)
