"""The port's twins of ``examples/serve_batched.py`` and
``examples/train_tiny_lm.py`` (``examples/torch_serve_batched.py``,
``examples/torch_train_tiny_lm.py``) run at ``--tiny --device cpu``: the
plain PyTorch versions of the kernels, a few steps."""

import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_batched_example(capsys):
    out = _example("torch_serve_batched").main(["--tiny", "--device", "cpu"])
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    for rung in ("precise", "fast"):
        assert len(out[rung]) == 2
        for p, seq in zip(prompts, out[rung]):
            assert seq[:len(p)] == p and len(seq) == len(p) + 4
    assert out["switch_us"] > 0
    text = capsys.readouterr().out
    assert "FAST generations" in text and "MCU" not in text


def test_train_tiny_lm_example(tmp_path, capsys):
    out = _example("torch_train_tiny_lm").main(["--tiny", "--device", "cpu", "--steps", "3",
                                                "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in out["history"])
    assert "final loss" in capsys.readouterr().out
    assert any(tmp_path.iterdir())  # checkpoints were written
