"""The model builds its RoPE tables once a pass, not once a layer.

``models.model._layers`` calls ``layers.rope_tables`` once per prefill or
decode pass and hands the (sin, cos) pair to every attention layer
(``attention_forward(..., rope=...)``); called without it,
``attention_forward`` builds the tables itself, as the reference does in
every layer.  Both must give the same bits: logits and caches are held
``torch.equal`` against the per-layer build, on deepseek- and
gemma2-shaped smoke configs at both rungs (FAST: the K3 tables; exact:
f32 ``sin``/``cos``).  CPU only: K3 runs its plain version here.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.layers import attach_quantized_weights  # noqa: E402

TOKENS = [[5, 9, 2, 7, 1, 3, 8, 4, 6, 11, 13]]


def _serve_once(cfg, params, mode):
    """Prefill TOKENS, then two decode steps; returns every logit and
    the caches after each step."""
    caches = tm.init_caches(cfg, 1, 32, dtype=torch.float32, device="cpu")
    out = []
    logits, caches = tm.prefill_step(params, torch.tensor(TOKENS, dtype=torch.int32), caches, cfg,
                                     mode=mode)
    out.append(logits.clone())
    out.append({k: {kk: vv.clone() for kk, vv in v.items()} for k, v in caches.items()})
    for step in range(2):
        tok = torch.tensor([[int(logits.argmax())]], dtype=torch.int32)
        pos = torch.tensor([len(TOKENS[0]) + step], dtype=torch.int32)
        logits, caches = tm.decode_step(params, tok, pos, caches, cfg, mode=mode)
        out.append(logits.clone())
        out.append({k: {kk: vv.clone() for kk, vv in v.items()} for k, v in caches.items()})
    return out


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.fixture(scope="module", params=["deepseek_7b", "gemma2_2b"])
def model(request):
    cfg = smoke(request.param)
    params = tm.init_params(cfg, seed=3, device="cpu")
    return cfg, attach_quantized_weights(params, QuantizedWeightCache())


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_rope_tables_built_once_a_pass(model, mode, monkeypatch):
    cfg, params = model
    calls = {"model": 0, "attention": 0}

    def counted(where, fn):
        def wrapped(*args, **kwargs):
            calls[where] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(model_mod, "rope_tables", counted("model", model_mod.rope_tables))
    monkeypatch.setattr(attn_mod, "rope_tables", counted("attention", attn_mod.rope_tables))
    _serve_once(cfg, params, mode)
    assert cfg.n_layers > 1
    # one prefill and two decode passes
    assert calls == {"model": 3, "attention": 0}


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_rope_once_a_pass_matches_the_per_layer_build(model, mode, monkeypatch):
    cfg, params = model
    once = _serve_once(cfg, params, mode)
    # without the pass's tables every attention layer builds its own
    monkeypatch.setattr(model_mod, "rope_tables", lambda *args, **kwargs: None)
    per_layer = _serve_once(cfg, params, mode)
    assert len(once) == len(per_layer)
    for a, b in zip(once, per_layer):
        assert _same(a, b)
