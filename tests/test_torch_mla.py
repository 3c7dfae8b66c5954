"""The port's multi-head latent attention (``attention.mla_forward``,
``init_mla_cache``, ``reset_mla_cache_slot``) and the minicpm3_4b model
built on it, against the JAX package at smoke size, and the model's
once-a-pass RoPE tables, which are built from ``cfg.rope_dim``.

The JAX side runs in a child process (``tests/_torch_jax_child.py OUT
minicpm3_4b mla``, ``--xla_allow_excess_precision=false``), started once
a session by ``start_shared``: the smoke model's parameters, the model
records (prefill of 11 tokens, 6 greedy decode steps, per rung), the
segment records (a two-lane segment of 5 tokens from an exact prefill,
its commits) and layer 0's ``mla_forward``: a prefill on
K4 (D = nope + rope = 16, Dv = 8, 4 heads over 4 at smoke size), one
absorbed decode and one absorbed segment of 4, at ``exact`` and
``precise`` (the model records hold the FAST rung).  Tolerances:

* the bf16 modes: the ``precise`` layer's outputs and latent caches bit
  for bit, and the model's FAST caches after the prefill and after the
  last decode;
* the exact rung: f32 at 1e-4 (matmuls and the latent expansion summed
  in another order); logits at 1e-5 (FAST) and 1e-4 (exact), greedy
  tokens equal;
* ``commit_segment``: rolled-back rows (position past ``keep_pos``, or
  an inactive lane) bit for bit, the others at the rung's tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import (  # noqa: E402
    DECODE_STEPS,
    LAYER_SEG,
    LAYER_X_SHAPE,
    MLA_MODES,
    SEG_POSITIONS,
    SEG_TOKENS,
    TOKENS,
    layer_inputs,
    start_shared,
    wait_shared,
)
from _torch_spec_harness import load_reference  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.layers import attach_quantized_weights  # noqa: E402

ARCH = "minicpm3_4b"
S = SEG_TOKENS.shape[1]
LEAVES = ("ckv", "krope", "pos")
COMMITS = [f"commit{k}" for k in range(1, S + 1)] + ["commit_inactive"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_child(request, tmp_path_factory):
    return start_shared(request, tmp_path_factory)


@pytest.fixture(scope="module")
def ref(jax_child):
    records, params = load_reference(wait_shared(jax_child, ARCH, "mla"))
    return records, attach_quantized_weights(params, QuantizedWeightCache())


def _np(t):
    return t.to(torch.float32).numpy()


def _check(got, want, exact, what=""):
    if exact:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _layer0(params):
    mixer = params["periods"]["pos0"]["mixer"]
    return {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0])
            for k, v in mixer.items()}


@pytest.mark.parametrize("phase", ["prefill", "decode", "segment"])
@pytest.mark.parametrize("mode", MLA_MODES)
def test_mla_forward_matches_reference(ref, mode, phase):
    """Layer 0: the prefill (K4 at D = 16, Dv = 8) from a zero cache,
    then an absorbed decode and an absorbed segment from its cache."""
    records, params = ref
    cfg = smoke(ARCH)
    p0 = _layer0(params)
    dt = torch.float32 if mode == "exact" else torch.bfloat16
    x, x1, xs = (torch.from_numpy(v).to(dt) for v in layer_inputs())
    B, S0, _ = LAYER_X_SHAPE
    pos = {"prefill": (0, S0), "decode": (S0, S0 + 1), "segment": (S0, S0 + LAYER_SEG)}
    cache = attention.init_mla_cache(cfg, B, 32, device="cpu")
    q = torch.arange(0, S0, dtype=torch.int32)[None].expand(B, S0)
    out, cache = attention.mla_forward(p0, x, cfg, positions=q, mode=mode, cache=cache,
                                       prefill=True)
    if phase != "prefill":
        a, b = pos[phase]
        q = torch.arange(a, b, dtype=torch.int32)[None].expand(B, b - a)
        out, cache = attention.mla_forward(p0, x1 if phase == "decode" else xs, cfg, positions=q,
                                           mode=mode, cache=cache)
    pre = f"layer/{mode}/{phase}"
    _check(_np(out), records[f"{pre}/out"], mode == "exact", "out")
    for leaf in LEAVES:
        _check(_np(cache[leaf]), records[f"{pre}/cache/{leaf}"], mode == "exact" and leaf != "pos",
               leaf)


def test_masked_decode_is_the_pristine_view():
    """``lane_mask`` decode: the non-member lane's cache rows stay as they
    were, and both lanes compute what a decode on the reference's masked
    view (the non-member lane's cache pristine) computes."""
    cfg = smoke(ARCH)
    params = attach_quantized_weights(tm.init_params(cfg, seed=2, device="cpu"),
                                      QuantizedWeightCache())
    p0 = _layer0(params)
    x, x1, _ = (torch.from_numpy(v).to(torch.bfloat16) for v in layer_inputs())
    B, S0, _ = LAYER_X_SHAPE
    c1 = attention.init_mla_cache(cfg, B, 32, device="cpu")
    attention.mla_forward(p0, x, cfg, positions=torch.arange(S0)[None].expand(B, S0),
                          mode="fast", cache=c1, prefill=True)
    q = torch.full((B, 1), S0, dtype=torch.int32)
    masked = {k: v.clone() for k, v in c1.items()}
    out, masked = attention.mla_forward(p0, x1, cfg, positions=q, mode="fast", cache=masked,
                                        lane_mask=torch.tensor([True, False]))
    view = {k: v.clone() for k, v in c1.items()}
    attention.reset_mla_cache_slot(view, 1)
    want, view = attention.mla_forward(p0, x1, cfg, positions=q, mode="fast", cache=view)
    assert torch.equal(out, want)
    for leaf in LEAVES:
        assert torch.equal(masked[leaf][1], c1[leaf][1]), leaf
        assert torch.equal(masked[leaf][0], view[leaf][0]), leaf


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_model_matches_reference(ref, mode):
    """Prefill and greedy decode logits, the greedy tokens and the latent
    caches after the prefill and after the last decode (FAST: bit for
    bit)."""
    records, params = ref
    cfg = smoke(ARCH)
    caches = tm.init_caches(cfg, 1, 32, device="cpu")
    lp, caches = tm.prefill_step(params, torch.from_numpy(TOKENS), caches, cfg, mode=mode)
    for pos, node in caches.items():
        for leaf in LEAVES:
            _check(_np(node[leaf]), records[f"{mode}/c1/{pos}/{leaf}"],
                   mode == "exact" and leaf != "pos", f"{pos}/{leaf}")
    tokens, logits = records[f"{mode}/tokens"], []
    for i in range(DECODE_STEPS):
        ld, caches = tm.decode_step(params, torch.tensor([[int(tokens[i])]]),
                                    torch.tensor([TOKENS.shape[1] + i]), caches, cfg, mode=mode)
        logits.append(ld.numpy())
    for pos, node in caches.items():
        for leaf in LEAVES:
            _check(_np(node[leaf]), records[f"{mode}/c2/{pos}/{leaf}"],
                   mode == "exact" and leaf != "pos", f"{pos}/{leaf}")
    tol = 1e-4 if mode == "exact" else 1e-5
    np.testing.assert_allclose(lp.numpy(), records[f"{mode}/logits_prefill"], atol=tol, rtol=tol)
    np.testing.assert_allclose(np.stack(logits), records[f"{mode}/logits_decode"], atol=tol,
                               rtol=tol)
    assert np.stack(logits).argmax(-1)[:, 0].tolist() == records[f"{mode}/tokens"][1:].tolist()


def _tree(records, prefix):
    out = {}
    for name, arr in records.items():
        if name.startswith(prefix + "/"):
            pos, leaf = name[len(prefix) + 1:].split("/")
            out.setdefault(pos, {})[leaf] = torch.from_numpy(np.array(arr, copy=True))
    return out


def _tclone(tree):
    return {k: {n: v.clone() for n, v in node.items()} for k, node in tree.items()}


_SEG = {}


def _segments(ref, mode):
    if mode not in _SEG:
        records, params = ref
        cfg = smoke(ARCH)
        c1 = _tree(records, "c1")
        toks, poss = torch.from_numpy(SEG_TOKENS), torch.from_numpy(SEG_POSITIONS)
        logits, after, aux = tm.segment_step(params, toks, poss, _tclone(c1), cfg, mode=mode)
        out = {"logits": logits.numpy(), "after": _tclone(after)}
        for k in range(1, S + 1):
            out[f"commit{k}"] = tm.commit_segment(
                _tclone(after), aux, cfg, keep_pos=poss[:, k - 1],
                keep_count=torch.full((2,), k), active=torch.ones(2, dtype=torch.bool))
        out["commit_inactive"] = tm.commit_segment(
            _tclone(after), aux, cfg, keep_pos=poss[:, 2], keep_count=torch.full((2,), 3),
            active=torch.tensor([True, False]))
        _SEG[mode] = out
    return _SEG[mode]


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_segment_step_matches_reference(ref, mode):
    records, _ = ref
    seg = _segments(ref, mode)
    tol = 1e-4 if mode == "exact" else 1e-5
    np.testing.assert_allclose(seg["logits"], records[f"{mode}/seg/logits"], atol=tol, rtol=tol)
    np.testing.assert_array_equal(seg["logits"].argmax(-1),
                                  records[f"{mode}/seg/logits"].argmax(-1))
    for pos, node in _tree(records, f"{mode}/seg/after").items():
        for leaf in LEAVES:
            _check(_np(seg["after"][pos][leaf]), _np(node[leaf]),
                   mode == "exact" and leaf != "pos", f"{pos}/{leaf}")


@pytest.mark.parametrize("commit", COMMITS)
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_commit_segment_matches_reference(ref, mode, commit):
    """Rolled-back rows equal JAX's (the shared pre-segment rows) bit for
    bit; kept rows at the rung's tolerance."""
    records, _ = ref
    got, want = _segments(ref, mode)[commit], _tree(records, f"{mode}/{commit}")
    after = _tree(records, f"{mode}/seg/after")
    k = 3 if commit == "commit_inactive" else int(commit[len("commit"):])
    keep_pos = SEG_POSITIONS[:, k - 1]
    active = np.array([True, commit != "commit_inactive"])
    n_rolled = 0
    for pos in want:
        rejected = (after[pos]["pos"].numpy() > keep_pos[None, :, None]) | ~active[None, :, None]
        n_rolled += int(rejected.sum())
        for leaf in LEAVES:
            g, w = _np(got[pos][leaf]), _np(want[pos][leaf])
            np.testing.assert_array_equal(g[rejected], w[rejected], err_msg=f"{pos}/{leaf}")
            _check(g, w, mode == "exact" and leaf != "pos", f"{pos}/{leaf}")
    if k < S or commit == "commit_inactive":
        assert n_rolled > 0


def test_truncate_and_reset_latent_cache():
    """``truncate_cache_slot`` drops one slot's latent rows at positions
    >= keep_pos (payload 0, pos -1) and keeps the rest bit for bit;
    ``reset_cache_slot`` gives the slot the pristine fill."""
    cfg = smoke(ARCH)
    params = tm.init_params(cfg, seed=3, device="cpu")
    pool = tm.init_caches(cfg, 2, 32, device="cpu")
    tm.prefill_step(params, torch.from_numpy(np.stack([TOKENS[0], TOKENS[0] + 20])), pool, cfg,
                    mode="exact")
    before = _tclone(pool)
    tm.truncate_cache_slot(pool, cfg, 1, 6)
    for node, old in zip(pool.values(), before.values()):
        assert torch.equal(node["pos"][:, 1, :6], old["pos"][:, 1, :6])
        assert (node["pos"][:, 1, 6:] == -1).all()
        assert not node["ckv"][:, 1, 6:].any() and not node["krope"][:, 1, 6:].any()
        assert torch.equal(node["ckv"][:, 1, :6], old["ckv"][:, 1, :6])
        assert torch.equal(node["ckv"][:, 0], old["ckv"][:, 0])
    tm.reset_cache_slot(pool, cfg, 0)
    for node in pool.values():
        assert (node["pos"][:, 0] == -1).all() and not node["ckv"][:, 0].any()


@pytest.mark.parametrize("arch", ["minicpm3_4b", "jamba_v01_52b", "mamba2_1_3b"])
def test_rope_tables_built_from_rope_dim(monkeypatch, arch):
    """One pair of RoPE tables a pass, of ``cfg.rope_dim`` dimensions
    (MLA: the rotated part, 8 at smoke size, while ``head_dim`` is 0),
    and none for an attention-free model."""
    cfg = smoke(arch)
    calls = []
    real = model_mod.rope_tables

    def spy(positions, rope_dim, base, mode):
        calls.append(rope_dim)
        return real(positions, rope_dim, base, mode)

    monkeypatch.setattr(model_mod, "rope_tables", spy)
    params = tm.init_params(cfg, seed=0, device="cpu")
    caches = tm.init_caches(cfg, 1, 16, device="cpu")
    tm.prefill_step(params, torch.tensor([[1, 2, 3]]), caches, cfg, mode="exact")
    tm.decode_step(params, torch.tensor([[4]]), torch.tensor([3]), caches, cfg, mode="exact")
    assert calls == ([cfg.rope_dim] * 2 if cfg.has_attention else [])
    if arch == "minicpm3_4b":
        assert (cfg.rope_dim, cfg.head_dim) == (8, 0)


def test_config_and_layout():
    cfg = get_config(ARCH)
    m = cfg.mla
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab, cfg.head_dim) == \
        (62, 2560, 40, 6400, 73448, 0)
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
            m.v_head_dim, cfg.rope_dim) == (768, 256, 64, 32, 64, 32)
    assert tm.cache_layout(cfg, 1024) == [("pos0", "mla", 1024)]


def test_params_from_jax_carries_the_mla_leaves(ref):
    """``convert.params_from_jax`` (through ``load_reference``) carries
    the MLA layer's own leaves bit for bit."""
    records, params = ref
    mixer = params["periods"]["pos0"]["mixer"]
    for leaf in ("q_norm", "kv_norm", "wkv_b"):
        np.testing.assert_array_equal(mixer[leaf].numpy(),
                                      records[f"param/periods/pos0/mixer/{leaf}"], err_msg=leaf)
