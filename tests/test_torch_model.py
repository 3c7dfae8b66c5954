"""The port's deepseek_7b model (smoke config) against the JAX package,
with the JAX parameters carried across by ``convert.params_from_jax``.

The JAX side runs in a child process (``tests/_torch_jax_child.py``)
with ``--xla_allow_excess_precision=false``: by default XLA keeps the
reference's bf16 casts in f32 inside its fused scan body, while the
port rounds where the source says, so only with the flag do both
compute the written program.  (Against JAX as run by default, the
serving tests hold the greedy tokens identical.)

* int8 weight payloads and exponents: bit-exact.
* exact rung (f32): logits and caches at 1e-4 — f32 matmuls summed in
  another order, and libm ``sin``/``cos``/``pow`` ulp differences in the
  RoPE tables.
* FAST rung (kernels K1-K4): caches bit-exact, logits at 1e-5 (the f32
  head product summed in another order).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

TESTS = Path(__file__).resolve().parent
TOKENS = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]], np.int32)
NEXT = np.array([[12]], np.int32)
WEIGHTS = [("mixer", k) for k in ("wq", "wk", "wv", "wo")] + [
    ("ffn", k) for k in ("w_gate", "w_up", "w_down")]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(TESTS / "_torch_jax_child.py"), str(out)], env=env,
                   check=True, timeout=600)
    ref = dict(np.load(out))
    tree = {}
    for name, arr in ref.items():
        if name.startswith("param/") and not any(p.endswith("_q") for p in name.split("/")):
            node = tree
            parts = name.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return ref, tree


@pytest.fixture(scope="module")
def port(reference):
    from repro_torch.core.quantization import QuantizedWeightCache
    from repro_torch.models.layers import attach_quantized_weights

    _, tree = reference
    cfg = t_smoke("deepseek_7b")
    params = attach_quantized_weights(params_from_jax(tree, device="cpu"), QuantizedWeightCache())
    runs = {}
    for mode in ("exact", "fast"):
        caches = tm.init_caches(cfg, 1, 32, dtype=torch.float32, device="cpu")
        lp, caches = tm.prefill_step(params, torch.from_numpy(TOKENS), caches, cfg, mode=mode)
        c1 = {k: v.clone().numpy() for k, v in caches["pos0"].items()}
        ld, caches = tm.decode_step(params, torch.from_numpy(NEXT),
                                    torch.tensor([TOKENS.shape[1]], dtype=torch.int32), caches,
                                    cfg, mode=mode)
        c2 = {k: v.numpy() for k, v in caches["pos0"].items()}
        runs[mode] = {"logits_prefill": lp.numpy(), "logits_decode": ld.numpy(), "c1": c1, "c2": c2}
    return params, runs


@pytest.mark.parametrize("block,key", WEIGHTS)
def test_quantized_weight_payloads_bit_exact(reference, port, block, key):
    ref, _ = reference
    params, _ = port
    got = params["periods"]["pos0"][block][key + "_q"]
    base = f"param/periods/pos0/{block}/{key}_q"
    np.testing.assert_array_equal(got["q"].numpy(), ref[base + "/q"])
    np.testing.assert_array_equal(got["exp"].numpy(), ref[base + "/exp"])


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("step", ["logits_prefill", "logits_decode"])
def test_logits(reference, port, mode, step):
    ref, _ = reference
    got, want = port[1][mode][step], ref[f"{mode}/{step}"]
    assert np.all(np.isfinite(got))
    tol = 1e-4 if mode == "exact" else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert int(np.argmax(got)) == int(np.argmax(want))


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("after", ["c1", "c2"])
@pytest.mark.parametrize("leaf", ["k", "v", "pos"])
def test_caches(reference, port, mode, after, leaf):
    ref, _ = reference
    got, want = port[1][mode][after][leaf], ref[f"{mode}/{after}/{leaf}"]
    if mode == "exact" and leaf != "pos":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


def test_cache_slot_helpers_in_place():
    cfg = t_smoke("deepseek_7b")
    pool = tm.init_caches(cfg, 3, 16, device="cpu")
    single = tm.init_caches(cfg, 1, 16, device="cpu")
    single["pos0"]["k"].fill_(2.0)
    single["pos0"]["pos"].fill_(5)
    assert tm.write_cache_slot(pool, single, 1) is pool
    assert float(pool["pos0"]["k"][:, 1].min()) == 2.0 and float(pool["pos0"]["k"][:, 0].max()) == 0.0
    tm.reset_cache_slot(pool, cfg, 1)
    assert float(pool["pos0"]["k"].abs().max()) == 0.0
    assert int(pool["pos0"]["pos"].max()) == -1


def test_decode_lane_mask_leaves_non_members_untouched(port):
    params, _ = port
    cfg = t_smoke("deepseek_7b")
    caches = tm.init_caches(cfg, 2, 32, device="cpu")
    view = {k: {kk: vv[:, :1] for kk, vv in v.items()} for k, v in caches.items()}
    tm.prefill_step(params, torch.tensor([[3, 4, 5]], dtype=torch.int32), view, cfg, mode="fast")
    before = {k: v.clone() for k, v in caches["pos0"].items()}
    logits, _ = tm.decode_step(params, torch.tensor([[9], [9]], dtype=torch.int32),
                               torch.tensor([3, 0], dtype=torch.int32), caches, cfg, mode="fast",
                               lane_mask=torch.tensor([True, False]))
    for k, v in caches["pos0"].items():
        assert torch.equal(v[:, 1], before[k][:, 1])   # non-member row untouched
    assert int(caches["pos0"]["pos"][0, 0, 3]) == 3     # member row written
    assert torch.isfinite(logits).all()
