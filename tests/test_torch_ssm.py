"""The port's Mamba-2 SSD layer (``repro_torch.models.ssm``) and the
mamba2_1_3b model built on it, against the JAX package at smoke size.

The JAX side runs in a child process (``tests/_torch_jax_child.py OUT
mamba2_1_3b ssm``, ``--xla_allow_excess_precision=false``), started once
a session by ``start_shared``: the smoke model's parameters, the model
records (prefill of 11 tokens, 6 greedy decode steps, per rung), the
segment records (a two-lane segment of 5 tokens from an exact prefill,
its commits at every keep count and with lane 1 inactive), layer 0's
``ssm_forward`` at every mode and ``_ssd_chunked`` / ``_ssd_segment`` on
seeded inputs.  Tolerances (measured margins on this CPU in brackets):

* K1's outputs, the five input projections of the FAST modes, bit for
  bit (``precise`` too: bf16 matmuls); the exact rung's f32 projections
  at 1e-4;
* the SSD recurrences in f32 (``_ssd_chunked``, ``_ssd_segment``, the
  SSM ``state``) within 1e-3 of the tensor's largest magnitude [4e-4]:
  exp / cumsum / einsum in another order, amplified through ``exp(dt
  A)``; the inputs of :func:`test_ssd_matches_reference` at 1e-5 [1e-6];
* layer outputs of the bf16 modes bit for bit (the bf16 rounding of
  ``y`` before the out projection hides the state's f32 noise), the
  exact rung's within 1e-4 of the largest magnitude;
* the conv history bit for bit on the FAST rung, at 1e-5 on the exact
  rung; logits at 1e-5 (FAST) and 1e-4 (exact), greedy tokens equal.

The mirrors of tests/test_moe_ssm.py's SSD cases hold the port's
``_ssd_chunked`` to a float64 recurrence at their 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import (  # noqa: E402
    DECODE_STEPS,
    LAYER_MODES,
    LAYER_X_SHAPE,
    SEG_POSITIONS,
    SEG_TOKENS,
    SSD_CHUNK,
    TOKENS,
    layer_inputs,
    ssd_inputs,
    start_shared,
    wait_shared,
)
from _torch_spec_harness import load_reference  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import attach_quantized_weights, pdot, rms_norm  # noqa: E402

ARCH = "mamba2_1_3b"
S = SEG_TOKENS.shape[1]
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
    """(JAX's records, the port's parameters with attached int8 weights)."""
    records, params = load_reference(wait_shared(jax_child, ARCH, "ssm"))
    return records, attach_quantized_weights(params, QuantizedWeightCache())


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err} > {tol} * {np.abs(want).max()}"


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _layer0(params):
    return {k: v[0] for k, v in params["periods"]["pos0"]["mixer"].items()
            if isinstance(v, torch.Tensor)} | {
        k: {n: t[0] for n, t in v.items()}
        for k, v in params["periods"]["pos0"]["mixer"].items() if isinstance(v, dict)}


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the SSD against the float64 recurrence (mirrors of tests/test_moe_ssm.py)
# ---------------------------------------------------------------------------


def _naive_ssd(x, dt, A, B_, C_):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T; y_t = C_t h_t, in float64."""
    Bb, S_, nh, hd = x.shape
    x, dt, B_, C_, A = (np.asarray(v, np.float64) for v in (x, dt, B_, C_, A))
    y = np.zeros((Bb, S_, nh, hd))
    h = np.zeros((Bb, nh, B_.shape[-1], hd))
    for t in range(S_):
        h = h * np.exp(dt[:, t] * A[None])[:, :, None, None] + np.einsum(
            "bd,bhp,bh->bhdp", B_[:, t], x[:, t], dt[:, t])
        y[:, t] = np.einsum("bd,bhdp->bhp", C_[:, t], h)
    return y


def _draw(rng, Bb, S_, nh, hd, ds):
    return (rng.normal(0, 1, (Bb, S_, nh, hd)).astype(np.float32),
            rng.uniform(0.01, 0.2, (Bb, S_, nh)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32),
            rng.normal(0, 1, (Bb, S_, ds)).astype(np.float32),
            rng.normal(0, 1, (Bb, S_, ds)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_recurrence(chunk):
    x, dt, A, B_, C_ = _draw(np.random.default_rng(0), 2, 32, 3, 5, 7)
    got, _ = ssm._ssd_chunked(*(torch.from_numpy(v) for v in (x, dt, A, B_, C_)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _naive_ssd(x, dt, A, B_, C_), atol=1e-3, rtol=1e-3)


def test_ssd_final_state_continues_correctly():
    """The state after chunked(S) plus one recurrence step equals
    chunked(S + 1) at position S."""
    S_ = 24
    x, dt, A, B_, C_ = (torch.from_numpy(v)
                        for v in _draw(np.random.default_rng(1), 1, S_ + 1, 2, 4, 6))
    _, state = ssm._ssd_chunked(x[:, :S_], dt[:, :S_], A, B_[:, :S_], C_[:, :S_], chunk=8)
    _, y_dec = ssm._recurrence_step(state, x[:, S_], dt[:, S_], A, B_[:, S_], C_[:, S_])
    full, _ = ssm._ssd_chunked(x, dt, A, B_, C_, chunk=8)
    np.testing.assert_allclose(y_dec.numpy(), full[:, S_].numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("what", ["chunked", "carried", "segment"])
def test_ssd_matches_reference(ref, what):
    """``_ssd_chunked`` from a zero and from a carried state, and
    ``_ssd_segment``'s outputs and per-position states, against JAX's."""
    records, _ = ref
    x, dt, A, B_, C_, s0 = (torch.from_numpy(v) for v in ssd_inputs())
    if what == "segment":
        y, extra = ssm._ssd_segment(x[:, :5], dt[:, :5], A, B_[:, :5], C_[:, :5], s0)
        key = "states"
    else:
        y, extra = ssm._ssd_chunked(x, dt, A, B_, C_, chunk=SSD_CHUNK,
                                    initial_state=s0 if what == "carried" else None)
        key = "final"
    np.testing.assert_allclose(y.numpy(), records[f"ssd/{what}/y"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(extra.numpy(), records[f"ssd/{what}/{key}"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# ssm_forward: layer 0 at every mode
# ---------------------------------------------------------------------------


def _inputs(mode):
    dt = torch.float32 if mode == "exact" else torch.bfloat16
    return tuple(torch.from_numpy(v).to(dt) for v in layer_inputs())


@pytest.mark.parametrize("mode", LAYER_MODES)
def test_projections_match_reference(ref, mode):
    """The five input projections: K1 on the FAST modes, bit for bit."""
    records, params = ref
    p0 = _layer0(params)
    cfg = smoke(ARCH)
    h = rms_norm(_inputs(mode)[0], p0["norm"], cfg.rms_eps)
    for w in ("wz", "wx", "wB", "wC", "wdt"):
        got = _np(pdot(h, p0[w], mode, wq=p0.get(w + "_q")))
        want = records[f"layer/{mode}/proj/{w}"]
        if mode == "exact":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=w)
        else:
            np.testing.assert_array_equal(got, want, err_msg=w)


_LAYER = {}


def _layer_runs(params, mode):
    """{phase: (out, cache, seg_aux)}: prefill from zeros, then a decode
    and a segment each from the prefill's cache."""
    if mode not in _LAYER:
        cfg = smoke(ARCH)
        p0 = _layer0(params)
        x, x1, xs = _inputs(mode)
        c1 = ssm.init_ssm_cache(cfg, LAYER_X_SHAPE[0], device="cpu")
        out, c1 = ssm.ssm_forward(p0, x, cfg, mode=mode, cache=c1, prefill=True)
        runs = {"prefill": (out, _clone(c1), {})}
        runs["decode"] = ssm.ssm_forward(p0, x1, cfg, mode=mode, cache=_clone(c1)) + ({},)
        aux = {}
        runs["segment"] = ssm.ssm_forward(p0, xs, cfg, mode=mode, cache=_clone(c1),
                                          seg_aux=aux) + (aux,)
        _LAYER[mode] = runs
    return _LAYER[mode]


@pytest.mark.parametrize("phase", ["prefill", "decode", "segment"])
@pytest.mark.parametrize("mode", LAYER_MODES)
def test_ssm_forward_matches_reference(ref, mode, phase):
    records, params = ref
    out, cache, aux = _layer_runs(params, mode)[phase]
    pre = f"layer/{mode}/{phase}"
    if mode == "exact":
        _close(_np(out), records[f"{pre}/out"], 1e-4, "out")
        np.testing.assert_allclose(_np(cache["conv"]), records[f"{pre}/cache/conv"],
                                   atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(_np(out), records[f"{pre}/out"])
        np.testing.assert_array_equal(_np(cache["conv"]), records[f"{pre}/cache/conv"])
    _close(_np(cache["state"]), records[f"{pre}/cache/state"], 1e-3, "state")
    if phase == "segment":
        _close(_np(aux["states"]), records[f"{pre}/aux/states"], 1e-3, "states")
        hist = records[f"{pre}/aux/conv_hist"]
        if mode == "exact":
            np.testing.assert_allclose(_np(aux["conv_hist"]), hist, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(_np(aux["conv_hist"]), hist)


def test_masked_decode_takes_member_lanes_only_and_a_pristine_view(ref):
    """``lane_mask`` decode: the lanes compute what a decode on the
    reference's masked view computes (the non-member lane's state and
    conv carry zero), the member lane writes the unmasked decode's cache
    and the non-member lane's cache is untouched."""
    _, params = ref
    cfg = smoke(ARCH)
    p0 = _layer0(params)
    _, x1, _ = _inputs("fast")
    c1 = _layer_runs(params, "fast")["prefill"][1]
    out, c = ssm.ssm_forward(p0, x1, cfg, mode="fast", cache=_clone(c1),
                             lane_mask=torch.tensor([True, False]))
    _, c_full = ssm.ssm_forward(p0, x1, cfg, mode="fast", cache=_clone(c1))
    view = {k: torch.stack([v[0], torch.zeros_like(v[1])]) for k, v in c1.items()}
    want, _ = ssm.ssm_forward(p0, x1, cfg, mode="fast", cache=view)
    assert torch.equal(out, want)
    for k in c1:
        assert torch.equal(c[k][1], c1[k][1]), k
        assert torch.equal(c[k][0], c_full[k][0]), k


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

_MODEL = {}


def _model_runs(params, records, mode):
    if mode not in _MODEL:
        cfg = smoke(ARCH)
        caches = tm.init_caches(cfg, 1, 32, device="cpu")
        lp, caches = tm.prefill_step(params, torch.from_numpy(TOKENS), caches, cfg, mode=mode)
        c1 = {k: v.clone() for k, v in caches["pos0"].items()}
        tokens, logits = records[f"{mode}/tokens"], []
        for i in range(DECODE_STEPS):
            ld, caches = tm.decode_step(params, torch.tensor([[int(tokens[i])]]),
                                        torch.tensor([TOKENS.shape[1] + i]), caches, cfg,
                                        mode=mode)
            logits.append(ld.numpy())
        _MODEL[mode] = lp.numpy(), np.stack(logits), c1, caches["pos0"]
    return _MODEL[mode]


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_model_matches_reference(ref, mode):
    """Prefill and greedy decode logits, the greedy tokens, and the SSM
    caches after the prefill and after the last decode."""
    records, params = ref
    lp, ld, c1, c2 = _model_runs(params, records, mode)
    tol = 1e-4 if mode == "exact" else 1e-5
    np.testing.assert_allclose(lp, records[f"{mode}/logits_prefill"], atol=tol, rtol=tol)
    np.testing.assert_allclose(ld, records[f"{mode}/logits_decode"], atol=tol, rtol=tol)
    assert ld.argmax(-1)[:, 0].tolist() == records[f"{mode}/tokens"][1:].tolist()
    for when, got in (("c1", c1), ("c2", c2)):
        _close(_np(got["state"]), records[f"{mode}/{when}/pos0/state"], 1e-3, when)
        if mode == "fast":
            np.testing.assert_array_equal(_np(got["conv"]), records[f"{mode}/{when}/pos0/conv"])
        else:
            np.testing.assert_allclose(_np(got["conv"]), records[f"{mode}/{when}/pos0/conv"],
                                       atol=1e-4, rtol=1e-4)


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
        out = {"logits": logits.numpy(), "after": _tclone(after), "aux": aux, "c1": c1}
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
    want = _tree(records, f"{mode}/seg/after")["pos0"]
    _close(_np(seg["after"]["pos0"]["state"]), _np(want["state"]), 1e-3, "state")


@pytest.mark.parametrize("commit", COMMITS)
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_commit_segment_matches_reference(ref, mode, commit):
    """Each keep count picks JAX's candidate (state at 1e-3, conv rows of
    the FAST rung bit for bit); an inactive lane is its pre-segment
    cache, bit for bit."""
    records, _ = ref
    seg = _segments(ref, mode)
    got, want = seg[commit]["pos0"], _tree(records, f"{mode}/{commit}")["pos0"]
    _close(_np(got["state"]), _np(want["state"]), 1e-3, commit)
    if mode == "fast":
        assert torch.equal(got["conv"], want["conv"])
    else:
        np.testing.assert_allclose(_np(got["conv"]), _np(want["conv"]), atol=1e-4, rtol=1e-4)
    aux = seg["aux"]["pos0"]
    if commit == "commit_inactive":
        for leaf in ("state", "conv"):
            assert torch.equal(got[leaf][:, 1], seg["c1"]["pos0"][leaf][:, 1]), leaf
        k, lanes = 3, [0]
    else:
        k, lanes = int(commit[len("commit"):]), [0, 1]
    for b in lanes:
        # the candidate after position k, and the conv rows [k, k + K - 1)
        assert torch.equal(got["state"][:, b], aux["states"][:, b, k - 1])
        assert torch.equal(got["conv"][:, b], aux["conv_hist"][:, b, k:k + 3].to(torch.float32))


def test_truncate_with_snapshot_equals_commit():
    """``truncate_cache_slot(ssm_snapshot=...)`` with a segment candidate
    is that slot's commit; without a snapshot it raises, as the
    reference does; ``reset_cache_slot`` zeroes only the slot."""
    cfg = smoke(ARCH)
    params = attach_quantized_weights(tm.init_params(cfg, seed=1, device="cpu"),
                                      QuantizedWeightCache())
    pool = tm.init_caches(cfg, 2, 32, device="cpu")
    tm.prefill_step(params, torch.from_numpy(np.stack([TOKENS[0], TOKENS[0] + 20])), pool, cfg,
                    mode="exact")
    toks, poss = torch.from_numpy(SEG_TOKENS), torch.from_numpy(SEG_POSITIONS)
    _, after, aux = tm.segment_step(params, toks, poss, _tclone(pool), cfg)
    committed = tm.commit_segment(_tclone(after), aux, cfg, keep_pos=poss[:, 1],
                                  keep_count=torch.full((2,), 2),
                                  active=torch.ones(2, dtype=torch.bool))
    a = aux["pos0"]
    snap = {"pos0": {"state": a["states"][:, 1, 1], "conv": a["conv_hist"][:, 1, 2:5]}}
    truncated = tm.truncate_cache_slot(_tclone(after), cfg, 1, 13, ssm_snapshot=snap)
    for leaf in ("state", "conv"):
        assert torch.equal(truncated["pos0"][leaf][:, 1], committed["pos0"][leaf][:, 1])
        assert torch.equal(truncated["pos0"][leaf][:, 0], after["pos0"][leaf][:, 0])
    with pytest.raises(ValueError, match="ssm_snapshot"):
        tm.truncate_cache_slot(_tclone(after), cfg, 1, 13)
    reset = tm.reset_cache_slot(_tclone(after), cfg, 0)
    for leaf in ("state", "conv"):
        assert not reset["pos0"][leaf][:, 0].any()
        assert torch.equal(reset["pos0"][leaf][:, 1], after["pos0"][leaf][:, 1])


def test_reset_ssm_cache_slot_matches_reference():
    """``reset_ssm_cache_slot`` zeroes one slot, leaf for leaf as the
    reference's does, and leaves the others."""
    import jax.numpy as jnp

    from repro.models import ssm as ref_ssm

    rng = np.random.default_rng(7)
    cache = {"state": rng.standard_normal((3, 4, 16, 8), dtype=np.float32),
             "conv": rng.standard_normal((3, 3, 160), dtype=np.float32)}
    want = ref_ssm.reset_ssm_cache_slot({k: jnp.asarray(v) for k, v in cache.items()}, 1)
    got = ssm.reset_ssm_cache_slot({k: torch.from_numpy(v.copy()) for k, v in cache.items()}, 1)
    for leaf in cache:
        np.testing.assert_array_equal(got[leaf].numpy(), np.asarray(want[leaf]), err_msg=leaf)
        assert not got[leaf][1].any()


def test_config_and_layout():
    cfg = get_config(ARCH)
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, s.d_inner(cfg.d_model),
            s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.d_conv) == \
        (48, 2048, 50280, 4096, 64, 64, 128, 4)
    assert not cfg.has_attention
    assert tm.cache_layout(cfg, 1024) == [("pos0", "mamba", None)]
    c = tm.init_caches(smoke(ARCH), 3, 16, dtype=torch.bfloat16, device="meta")["pos0"]
    # SSM caches stay f32 whatever the pool's dtype, as the reference's
    assert c["state"].dtype == c["conv"].dtype == torch.float32
    assert c["state"].shape == (2, 3, 16, 16, 8) and c["conv"].shape == (2, 3, 3, 160)


def test_segment_states_are_sequential_decode_bit_for_bit():
    """``_ssd_segment``'s per-position states are the single-token
    recurrence's, bit for bit (the rollback candidates a commit picks)."""
    x, dt, A, B_, C_, s0 = (torch.from_numpy(v) for v in ssd_inputs())
    _, states = ssm._ssd_segment(x[:, :6], dt[:, :6], A, B_[:, :6], C_[:, :6], s0)
    state = s0
    for i in range(6):
        state, _ = ssm._recurrence_step(state, x[:, i], dt[:, i], A, B_[:, i], C_[:, i])
        assert torch.equal(states[:, i], state), i


def test_params_from_jax_carries_the_ssm_leaves(ref):
    """``convert.params_from_jax`` (through ``load_reference``) carries
    the SSM layer's own leaves bit for bit."""
    records, params = ref
    mixer = params["periods"]["pos0"]["mixer"]
    for leaf in ("A_log", "D", "dt_bias", "conv_w", "conv_b", "out_norm"):
        want = records[f"param/periods/pos0/mixer/{leaf}"]
        assert mixer[leaf].dtype == torch.float32
        np.testing.assert_array_equal(mixer[leaf].numpy(), want, err_msg=leaf)
