"""``optim.grad_compress`` against the JAX package's Q-format compressed
data-parallel mean and its train step.

* ``compressed_mean`` runs on 8 gloo ranks (``tests/_torch_dist_child.py
  gc``, started once for the module) on tests/test_grad_compress.py's
  inputs (``default_rng(0)``, shape (8, 64, 33), one (64, 33) gradient a
  rank), two rounds of error feedback; the JAX child
  (``tests/_torch_jax_child.py OUT gemma2_2b dp``, an 8-device host mesh)
  runs the reference on the same inputs.  The int8 payloads are equal
  except where ``|x 2**-e|`` lies within 1e-6 of a half-integer (the two
  sides may round such a tie apart); the means and residuals agree within
  rel 1e-6 (XLA's CPU ``exp2`` is a few ulp off on integer arguments, the
  port scales by exact powers of two).  The reference test's four
  assertions hold on the port's numbers.
* At world size 1 (one process) the mean is the local ``q 2**e`` and the
  residual ``g + r - q 2**e``, bit for bit.
* ``make_dp_train_step`` runs on 2 gloo ranks for gemma2's smoke model at
  ``"precise"``, one step with ``compress_bits=8`` and one with ``None``
  from the JAX child's parameters and batch (each rank two of its four
  rows), against the reference's ``make_dp_train_step`` on a 2-device
  mesh.  The loss agrees within rel 1e-5.  The parameters: AdamW's first
  update is ``u = g / (|g| + eps)`` per element, inside (-1, 1), scaled by
  the step's learning rate ``lr_1`` (1e-3).  Where the two compressed
  means differ by one int8 grid step, ``u`` moves by at most 1 (an
  element whose payload is 0 on one side), so ``|dp| <= lr_1``; the
  uncompressed means differ by the sides' bf16 noise, which can flip the
  sign of a near-zero gradient, so ``|dp| <= 2 lr_1``.  On both, at most
  5% of the elements move by more than 1e-6 (measured: 0.8% and 2.9%).
  Rank 0's residuals lie within one grid step ``2**e`` of the leaf (the
  port's exponent) of the reference's device 0's.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import DP_BITS, DP_OPT, GC_SHAPE, start_shared, wait_shared  # noqa: E402

HERE = Path(__file__).resolve().parent
CHILD = HERE / "_torch_dist_child.py"
N_GC = GC_SHAPE[0]
N_DP = 2
LR_1 = DP_OPT["lr"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(mode, world, out_dir, *extra):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(CHILD), mode, str(r), str(world), str(port),
                              str(out_dir / f"{mode}{r}.npz"), *map(str, extra)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _collect(procs, mode, out_dir):
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()[-3000:]
    return [dict(np.load(out_dir / f"{mode}{r}.npz")) for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    jax_dir = start_shared(request, tmp_path_factory)
    out_dir = tmp_path_factory.mktemp("dist")
    gc = _launch("gc", N_GC, out_dir)
    jax_npz = wait_shared(jax_dir, "gemma2_2b", "dp")
    dp = _launch("dp", N_DP, out_dir, jax_npz)
    with np.load(jax_npz) as f:
        ref = {k: f[k] for k in f.files}
    return {"gc": _collect(gc, "gc", out_dir), "dp": _collect(dp, "dp", out_dir), "ref": ref}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_payloads_match_the_reference(runs):
    ref = runs["ref"]
    for r, rec in enumerate(runs["gc"]):
        e = int(rec["e1"])
        g = ref["gc/g"][r]
        # the reference's payload: its residual is g - q 2**e, exactly
        q_ref = np.round((g - ref["gc/res1"][r]) * 2.0 ** -e)
        x = np.abs(g.astype(np.float64) * 2.0 ** -e)
        tie = np.abs(x - np.floor(x) - 0.5) <= 1e-6
        q = rec["q1"].reshape(g.shape).astype(np.float64)
        assert np.array_equal(q[~tie], q_ref[~tie]), r
        assert np.abs(q - q_ref).max() <= 1


def test_means_and_residuals_match_the_reference(runs):
    ref = runs["ref"]
    for r, rec in enumerate(runs["gc"]):
        for key in ("mean1", "res1", "mean2", "res2"):
            assert _rel(rec[key], ref[f"gc/{key}"][r]) <= 1e-6, (r, key)


def test_compressed_mean_close_to_exact(runs):
    # the reference test's bound: two quantization stages, ~5% on white noise
    exact = runs["ref"]["gc/exact"][0]
    mean = runs["gc"][0]["mean1"]
    rel = np.abs(mean - exact).mean() / np.abs(exact).mean()
    assert rel < 0.08, rel


def test_error_feedback_state_nonzero(runs):
    assert all(np.abs(rec["res1"]).mean() > 0 for rec in runs["gc"])


def test_wire_payloads_are_int8(runs):
    for rec in runs["gc"]:
        assert list(rec["dtypes"]) == ["torch.int8"]
        # both collectives carry the padded vector once: 2 bytes an element
        assert int(rec["wire_bytes"]) == 2 * int(rec["padded_numel"])
        assert int(rec["padded_numel"]) == 64 * 33


def test_error_feedback_reduces_accumulated_bias(runs):
    exact = runs["ref"]["gc/exact"][0]
    rec = runs["gc"][0]
    rel = np.abs(rec["mean1"] - exact).mean() / np.abs(exact).mean()
    two = rec["mean1"] + rec["mean2"]
    bias2 = np.abs(two - 2 * exact).mean() / np.abs(exact).mean()
    assert bias2 < 1.6 * rel, (bias2, rel)


def test_world_one_mean_is_the_local_dequantized_gradient():
    import torch.distributed as dist

    from repro_torch.optim.grad_compress import compressed_mean

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        gen = torch.Generator().manual_seed(0)
        g = {"a": torch.randn((37, 5), generator=gen), "b": {"c": torch.randn(8, generator=gen)}}
        r = {"a": torch.randn((37, 5), generator=gen) * 1e-2, "b": {"c": torch.zeros(8)}}
        g0 = {"a": g["a"].clone(), "c": g["b"]["c"].clone()}
        r0 = {"a": r["a"].clone(), "c": r["b"]["c"].clone()}
        stats = {}
        mean, res = compressed_mean(g, r, dist.group.WORLD, 1, stats=stats, record=("a", "b/c"))
        for path, m, new_r, key in (("a", mean["a"], res["a"], "a"),
                                    ("b/c", mean["b"]["c"], res["b"]["c"], "c")):
            rec = stats["records"][path]
            deq = rec["q"].to(torch.float32) * torch.exp2(rec["e"].to(torch.float32))
            assert torch.equal(rec["g32"], (g0[key] + r0[key]).reshape(-1))
            assert torch.equal(m.reshape(-1), deq)
            assert torch.equal(new_r.reshape(-1), rec["g32"] - deq)
            assert rec["q"].dtype == torch.int8
        assert stats["wire_bytes"] == 2 * (37 * 5 + 8)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("bits", DP_BITS, ids=lambda b: f"bits{b}")
def test_dp_train_step_matches_the_reference(runs, bits):
    key = str(bits) if bits is not None else "none"
    ref = runs["ref"]
    r0, r1 = runs["dp"]
    want_loss = float(ref[f"dp/{key}/loss"])
    for rec in (r0, r1):
        assert abs(float(rec[f"{key}/loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    bound = LR_1 * (1 + 1e-3) if bits is not None else 2 * LR_1 * (1 + 1e-3)
    moved = total = 0
    for name in r0:
        if not name.startswith(f"{key}/param/"):
            continue
        d = np.abs(r0[name].astype(np.float64) - ref[f"dp/{name}"])
        assert d.max() <= bound, (name, d.max())
        assert np.array_equal(r0[name], r1[name]), name  # replicated parameters
        moved += int((d > 1e-6).sum())
        total += d.size
    assert total and moved <= 0.05 * total, (moved, total)
    if bits is None:
        return
    assert list(r0[f"{key}/dtypes"]) == ["torch.int8"]
    for name in r0:
        if name.startswith(f"{key}/res/"):
            grid = 2.0 ** int(r0[name.replace("/res/", "/exp/", 1)])
            assert np.abs(r0[name] - ref[f"dp/{name}"]).max() <= grid, name
