"""The modality stubs, phi3_vision_4_2b and musicgen_large, served at smoke
size against the JAX package: ``tests/test_arch_smoke.py::
test_serve_smoke`` with and without ``extra_embeds``.

JAX runs in the ``train`` children of tests/test_torch_train.py
(``tests/_torch_jax_child.py OUT ARCHS train``): on the parameters of
``init_params(PRNGKey(0))`` with attached int8 weights, per rung a
two-lane prefill of ``make_batch``'s 32 tokens with its ``extra_embeds``
(normal, std 0.02) added to the first ``stub_prefix_len`` positions, the
same prefill without them, and one greedy decode.  Tolerances, as
tests/test_torch_families.py's: FAST rung (K1-K4) caches bit for bit and
logits within 1e-5; exact rung logits within 1e-4, caches within 1e-4 of
each leaf's largest magnitude (the smoke init draws the stacked weights
at n_periods**-0.5, so the second layer's keys reach 22, and f32 noise
of the first layer grows to 3.2e-4 there, 1.4e-5 of the scale), and the
greedy tokens equal.  On the port alone: the prefix moves the logits,
and without ``extra_embeds`` a stub is its text model (the logits of the
same config with ``stub_prefix_len`` 0, bit for bit).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import STUB_MODES, start_shared  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache  # noqa: E402
from repro_torch.models.layers import attach_quantized_weights  # noqa: E402
from test_torch_train import records, unflatten  # noqa: E402

STUBS = ("phi3_vision_4_2b", "musicgen_large")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_child(request, tmp_path_factory):
    return start_shared(request, tmp_path_factory)


def _serve(cfg, params, batch, mode, extra):
    B, S = batch["tokens"].shape
    caches = tm.init_caches(cfg, B, cfg.max_seq, device="cpu")
    logits, c1 = tm.prefill_step(params, batch["tokens"], caches, cfg, mode=mode,
                                 extra_embeds=extra)
    after_prefill = {k: {n: t.clone() for n, t in v.items()} for k, v in c1.items()}
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    ld, c2 = tm.decode_step(params, tok, torch.full((B,), S, dtype=torch.int32), c1, cfg,
                            mode=mode)
    return logits, after_prefill, ld, c2


def _setup(jax_child, arch):
    rec = records(jax_child, arch)
    cfg = smoke(arch)
    params = params_from_jax(unflatten(rec, "param/"), device="cpu")
    pa = attach_quantized_weights(params, QuantizedWeightCache())
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in unflatten(rec, "batch/").items()}
    return rec, cfg, pa, batch


def _caches_close(got, want, exact):
    for pos, leaves in want.items():
        for name, w in leaves.items():
            g = got[pos][name].numpy()
            if exact:
                np.testing.assert_array_equal(g, w, err_msg=f"{pos}/{name}")
            else:
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=1e-4,
                                           err_msg=f"{pos}/{name}")


@pytest.mark.parametrize("mode", STUB_MODES)
@pytest.mark.parametrize("arch", STUBS)
def test_stub_serve_matches_jax(jax_child, arch, mode):
    rec, cfg, pa, batch = _setup(jax_child, arch)
    assert cfg.stub_prefix_len > 0 and batch["extra_embeds"].shape[1] == cfg.stub_prefix_len
    want = unflatten(rec, f"stub/{mode}/")
    logits, c1, ld, c2 = _serve(cfg, pa, batch, mode, batch["extra_embeds"])
    fast = mode == "fast"
    tol = 1e-5 if fast else 1e-4
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=tol, rtol=tol)
    np.testing.assert_allclose(ld.numpy(), want["logits_decode"], atol=tol, rtol=tol)
    assert (logits.argmax(-1).numpy() == want["logits"].argmax(-1)).all()
    _caches_close(c1, want["c1"], exact=fast)
    _caches_close(c2, want["c2"], exact=fast)
    text, _ = tm.prefill_step(pa, batch["tokens"],
                              tm.init_caches(cfg, 2, cfg.max_seq, device="cpu"), cfg, mode=mode)
    np.testing.assert_allclose(text.numpy(), want["logits_text"], atol=tol, rtol=tol)
    assert float((text - logits).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", STUBS)
def test_stub_without_prefix_is_its_text_model(jax_child, arch):
    _, cfg, pa, batch = _setup(jax_child, arch)
    plain = dataclasses.replace(cfg, stub_prefix_len=0, modality_stub=None)
    for mode in STUB_MODES:
        got = [tm.prefill_step(pa, batch["tokens"], tm.init_caches(c, 2, 64, device="cpu"), c,
                               mode=mode)[0] for c in (cfg, plain)]
        assert torch.equal(got[0], got[1]), mode
