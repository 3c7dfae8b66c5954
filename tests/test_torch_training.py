"""The training substrates of the port against the JAX package and the
reference's own tests (``tests/test_substrates.py``):

* AdamW: 3 ``adamw_update`` steps (in place) on equal numpy parameters
  and gradients match JAX's to rel 1e-6 (parameters, moments, step,
  grad norm, lr), and
  ``lr_schedule`` matches over warmup, decay and the floor;
* ``quantize_q16`` / ``compress_with_feedback``: equal to JAX's, bit for
  bit (payload, exponent, residual);
* data: ``SyntheticLM.batch`` equals JAX's bit for bit, is a pure
  function of the step, and host shards partition the global batch;
* checkpoints: the reference's roundtrip, tmp-atomicity and gc tests;
  a checkpoint the JAX ``Checkpointer`` wrote restores in the port bit
  for bit, and the port writes the same files and manifest;
* the ``Trainer`` on the CPU: the reference's loss-decreases,
  failure-injection-and-bitwise-resume, arbiter-on-NaN and
  mode-switch tests, the ``jit_switch`` dispatch, and the ``launch.train``
  smoke path;
* without a card every new entry point raises unless given ``"cpu"``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.core import quantization as jquant  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import smoke  # noqa: E402
from repro_torch.core import compress_with_feedback, quantize_q16  # noqa: E402
from repro_torch.core.precision import Mode  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import InjectedFailure, Trainer, TrainerConfig  # noqa: E402

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


def _np_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _np_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _close(got, want, rtol=1e-6):
    for (n1, a), (n2, b) in zip(_np_leaves(got), _np_leaves(want)):
        assert n1 == n2
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=1e-12,
                                   err_msg=n1)


def test_adamw_three_steps_match_jax():
    rng = np.random.default_rng(3)
    params = _tree(SHAPES, lambda s: rng.normal(size=s).astype(np.float32))
    grads = [_tree(SHAPES, lambda s: rng.normal(size=s).astype(np.float32) * 3) for _ in range(3)]
    cfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0)
    tcfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0)
    jp, js = params, jadamw.init_opt_state(params)
    tp = _torch_tree(params)
    ts = adamw.init_opt_state(tp)
    for g in grads:
        jp, js, jm = jadamw.adamw_update(cfg, jp, g, js)
        tp, ts, tm = adamw.adamw_update(tcfg, tp, _torch_tree(g), ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    _close(tp, jp)
    _close(ts.m, js.m)
    _close(ts.v, js.v)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32


def test_lr_schedule_matches_jax():
    cfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100)
    tcfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100)
    for step in (0, 1, 7, 20, 21, 55, 99, 100, 150):
        want = float(jadamw.lr_schedule(cfg, jnp.int32(step)))
        got = float(adamw.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


def test_quantize_q16_and_error_feedback_match_jax(rng):
    x = rng.normal(size=(64,)).astype(np.float32) * 40
    x[:3] = [40000.0, -40000.0, 2.0 ** -17]
    jq = jquant.quantize_q16(jnp.asarray(x))
    tq = quantize_q16(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert int(tq.exp) == int(jq.exp) == -16
    g = rng.normal(size=(33, 7)).astype(np.float32)
    res = rng.normal(size=(33, 7)).astype(np.float32) * 1e-2
    jqt, jres = jquant.compress_with_feedback(jnp.asarray(g), jnp.asarray(res))
    tqt, tres = compress_with_feedback(torch.from_numpy(g), torch.from_numpy(res))
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
    assert int(tqt.exp) == int(jqt.exp)
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))


def test_synthetic_lm_matches_jax_and_is_pure():
    cfg = dict(vocab=100, seq_len=32, global_batch=8)
    t, j = SyntheticLM(DataConfig(**cfg)), JSyntheticLM(JDataConfig(**cfg))
    for step in (0, 7, 8):
        a, b = t.batch(step), j.batch(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    assert not np.array_equal(t.batch(7)["tokens"], t.batch(8)["tokens"])
    np.testing.assert_array_equal(SyntheticLM(DataConfig(**cfg)).batch(7)["tokens"],
                                  t.batch(7)["tokens"])
    parts = [SyntheticLM(DataConfig(vocab=50, seq_len=16, global_batch=8, num_hosts=4,
                                    host_id=h)).batch(3) for h in range(4)]
    full = SyntheticLM(DataConfig(vocab=50, seq_len=16, global_batch=8)).batch(3)
    np.testing.assert_array_equal(np.concatenate([p["tokens"] for p in parts]), full["tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    ck.save(10, tree, blocking=True)
    out = ck.restore(tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32
    assert ck.latest_step() == 10


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"x": torch.zeros((2,))}, blocking=True)
    (tmp_path / "step_2.tmp").mkdir()
    (tmp_path / "step_5").mkdir()  # committed dir without manifest = corrupt
    assert ck.latest_step() == 1


def test_checkpoint_gc_keeps_newest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.zeros((2,))}, blocking=True)
    assert ck.all_steps() == [3, 4]


def test_async_save_snapshots_before_in_place_update(tmp_path):
    x = torch.zeros((1000,))
    ck = Checkpointer(tmp_path)
    ck.save(0, {"x": x})
    x.add_(1.0)  # training goes on, in place, while the thread writes
    ck.wait()
    assert torch.equal(Checkpointer(tmp_path).restore({"x": x})["x"], torch.zeros((1000,)))


def _state(rng):
    params = _tree(SHAPES, lambda s: rng.normal(size=s).astype(np.float32))
    return params


def test_checkpoint_written_by_jax_restores_bit_for_bit(tmp_path, rng):
    params = _state(rng)
    jstate = {"params": params, "opt": jadamw.init_opt_state(params)}
    jstate["opt"] = jstate["opt"]._replace(
        m=jax.tree.map(lambda p: p * 0.5, params), step=jnp.int32(7))
    JCheckpointer(tmp_path / "jax").save(7, jstate, blocking=True)
    tparams = _torch_tree(params)
    tmpl = {"params": _tree(SHAPES, lambda s: torch.zeros(s)),
            "opt": adamw.init_opt_state(tparams)}
    ck = Checkpointer(tmp_path / "jax")
    assert ck.latest_step() == 7
    out = ck.restore(tmpl)
    assert isinstance(out["opt"], adamw.OptState)
    for (n, a), (_, b) in zip(_np_leaves({"p": out["params"], "m": out["opt"].m}),
                              _np_leaves({"p": jstate["params"], "m": jstate["opt"].m})):
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert int(out["opt"].step) == 7 and out["opt"].step.dtype == torch.int32
    # the port writes the same files and manifest
    tstate = {"params": tparams, "opt": out["opt"]}
    Checkpointer(tmp_path / "torch").save(7, tstate, blocking=True)
    jd, td = tmp_path / "jax" / "step_7", tmp_path / "torch" / "step_7"
    assert sorted(p.name for p in jd.iterdir()) == sorted(p.name for p in td.iterdir())
    assert json.loads((jd / "manifest.json").read_text()) == \
        json.loads((td / "manifest.json").read_text())


# ---------------------------------------------------------------------------
# the Trainer (tests/test_substrates.py's trainer cases, on the CPU)
# ---------------------------------------------------------------------------


def _trainer(tmp_path, **kw):
    cfg = smoke("deepseek_7b")
    defaults = dict(total_steps=16, ckpt_every=8, ckpt_dir=str(tmp_path), log_every=100)
    defaults.update(kw)
    return Trainer(cfg, TrainerConfig(**defaults), device="cpu")


def test_train_loss_decreases(tmp_path):
    out = _trainer(tmp_path, total_steps=30).run()
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert last < first - 0.1, (first, last)


def test_failure_injection_and_bitwise_resume(tmp_path):
    with pytest.raises(InjectedFailure):
        _trainer(tmp_path, total_steps=16, ckpt_every=4, crash_at_step=10).run()
    # restart picks up from the last committed checkpoint (step 7)
    t2 = _trainer(tmp_path, total_steps=16, ckpt_every=4)
    assert t2.start_step == 8
    out2 = t2.run()
    ref = _trainer(str(tmp_path) + "_ref", total_steps=16, ckpt_every=4).run()
    resumed = {h["step"]: h["loss"] for h in out2["history"]}
    reference = {h["step"]: h["loss"] for h in ref["history"]}
    for s in range(10, 16):
        assert resumed[s] == pytest.approx(reference[s], rel=1e-5), s


def test_arbiter_switches_on_injected_nan(tmp_path):
    t = _trainer(tmp_path, total_steps=12, use_arbiter=True, start_mode=Mode.FAST)
    t.arbiter.observe(0, float("nan"), 1.0)
    assert t.arbiter.mode is Mode.PRECISE
    out = t.run()
    assert out["history"][-1]["mode"] in ("fast", "precise")


def test_trainer_mode_switch_preserves_training(tmp_path):
    t = _trainer(tmp_path, total_steps=20, start_mode=Mode.PRECISE)
    t.tcfg.total_steps = 10
    t.run()
    latency_us = t.engine.set_mode(Mode.FAST)
    assert latency_us >= 0
    t.tcfg.total_steps = 20
    t.start_step = 10
    out = t.run()
    modes = {h["mode"] for h in out["history"]}
    assert "fast" in modes
    assert np.isfinite(out["final_loss"])


def test_jit_switch_dispatches_by_level_index(tmp_path):
    """``jit_switch``: the step is picked from the engine's ``switched``
    table by the level's index; a run switched there equals the plain
    dispatch's, step for step."""
    losses = []
    for jit_switch in (False, True):
        t = _trainer(tmp_path / str(jit_switch), total_steps=3, ckpt_every=0,
                     start_mode="q16_16", jit_switch=jit_switch)
        t.run()
        t.engine.set_level("f32")
        t.tcfg.total_steps, t.start_step = 5, 3
        out = t.run()
        assert [h["level"] for h in out["history"]] == ["q16_16"] * 3 + ["f32"] * 2
        losses.append([h["loss"] for h in out["history"]])
    assert losses[0] == losses[1]


def test_launch_train_smoke(tmp_path, capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", "deepseek_7b", "--smoke", "--steps", "4", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    assert "final loss" in capsys.readouterr().out
    assert len(out["history"]) == 4 and Checkpointer(tmp_path).latest_step() == 3
    # the production path needs the mesh's ranks; with one it points to the dry-run
    with pytest.raises(SystemExit, match="repro_torch.launch.dryrun"):
        main(["--arch", "deepseek_7b", "--mesh", "single", "--device", "cpu"])


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(smoke("deepseek_7b"), TrainerConfig(ckpt_dir=str(tmp_path)))
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "deepseek_7b", "--steps", "1", "--ckpt-dir", str(tmp_path)])
