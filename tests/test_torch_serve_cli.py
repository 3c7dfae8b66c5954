"""The port's launcher CLI (``repro_torch.launch.serve``): the six tests
of tests/test_serve_cli.py on the port, ``main`` with ``--device cpu``.
Every serving flag must round-trip through ``serving_config_from_args``
into a validated :class:`ServingConfig`.

The launcher is the one place flag spellings meet config fields; a
typo'd ``dest`` or a forgotten field silently serves with defaults, so
this suite pins the mapping flag-by-flag, plus one end-to-end ``main``
run that writes the telemetry artifacts (--metrics-out / --trace-out)
to disk.
"""

import json

import pytest

pytest.importorskip("torch")

from repro_torch.launch.serve import MAX_LEN, build_parser, serving_config_from_args  # noqa: E402


def _cfg(argv):
    return serving_config_from_args(
        build_parser().parse_args(["--arch", "gemma2_2b"] + argv))


def test_defaults_round_trip():
    assert build_parser().parse_args(["--arch", "gemma2_2b"]).device == "cuda"
    scfg = _cfg(["--continuous"])
    assert scfg.n_slots == 2
    assert scfg.max_len == MAX_LEN
    assert scfg.cache == "contiguous"
    assert scfg.speculative is None
    assert scfg.telemetry.enabled is False
    assert scfg.telemetry.trace is False    # no --trace-out given


def test_paged_flags_round_trip():
    scfg = _cfg(["--continuous", "--paged", "--page-size", "8",
                 "--prefill-chunk", "8", "--prefix-sharing",
                 "--n-pages", "40", "--slots", "3"])
    assert scfg.cache == "paged"
    assert scfg.page_size == 8
    assert scfg.prefill_chunk == 8   # prefix sharing pins chunk == page
    assert scfg.prefix_sharing is True
    assert scfg.n_pages == 40
    assert scfg.n_slots == 3


def test_speculative_flags_round_trip():
    scfg = _cfg(["--continuous", "--speculative", "--spec-k", "4",
                 "--draft-level", "q8_8"])
    assert scfg.speculative is not None
    assert scfg.speculative.k == 4
    assert scfg.speculative.draft_level == "q8_8"
    assert scfg.speculative.max_len == MAX_LEN


@pytest.mark.parametrize("argv,enabled,trace", [
    ([], False, True),
    (["--metrics-out", "m.prom"], True, False),
    (["--trace-out", "t.json"], True, True),
    (["--metrics-out", "m.prom", "--trace-out", "t.json"], True, True),
])
def test_telemetry_enabled_iff_output_requested(argv, enabled, trace):
    scfg = _cfg(["--continuous"] + argv)
    assert scfg.telemetry.enabled is enabled
    if enabled:
        assert scfg.telemetry.trace is trace


def test_invalid_flag_combination_raises():
    # page_size must divide into max_len; the config's own validation
    # fires through the CLI path, not just direct construction
    with pytest.raises(ValueError):
        _cfg(["--continuous", "--paged", "--page-size", "1000"])


def test_main_end_to_end_writes_artifacts(tmp_path, capsys):
    from repro_torch.launch.serve import main

    metrics = tmp_path / "metrics.prom"
    trace = tmp_path / "trace.json"
    # page size 4: it must divide gemma2's 8-row sliding window too
    main(["--arch", "gemma2_2b", "--continuous", "--paged",
          "--page-size", "4", "--max-new", "2", "--device", "cpu",
          "--metrics-out", str(metrics), "--trace-out", str(trace)])

    out = capsys.readouterr().out
    assert "req" in out and "stats:" in out

    text = metrics.read_text()
    assert "# TYPE decode_ticks_total counter" in text
    assert "prefills_total 4" in text    # the launcher serves 4 prompts

    tr = json.loads(trace.read_text())
    names = {e["name"] for e in tr["traceEvents"]}
    assert "decode-tick" in names and "admit" in names
