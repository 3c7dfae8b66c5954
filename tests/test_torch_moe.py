"""The port's Mixture-of-Experts block (``repro_torch.models.moe``) and
the grouped K1/K2 entries it runs on, against the JAX package.

JAX runs ``moe_forward`` on layer 0 of the smoke granite_moe_3b_a800m and
mixtral_8x22b models in a child process (``tests/_torch_jax_child.py
OUT ARCH moe``, ``--xla_allow_excess_precision=false``, started for this
module and tests/test_torch_families.py by the first of them), on one
input with a zero row (uniform routing: tied probabilities) at the smoke
capacity factor (no pick dropped), and on a longer input at capacity
factor 0.5, where every row drops picks.  Tolerances, both inputs:

* ``fast`` and ``fast8`` (the grouped int8 experts on attached weights):
  bit for bit;
* ``precise`` (bf16 expert einsums): at most one bf16 step at the
  output's scale, 2**-8 * max|out| (measured: bit for bit);
* ``exact`` (f32 einsums summed in another order): 1e-6 * max|out|;
* the aux losses (f32 means): 1e-6 relative.

Without JAX: the mirrors of tests/test_moe_ssm.py's dense-oracle and
capacity-drop tests and tests/test_fused_mlp.py's fused-expert test, the
stable top-k on an all-equal row, the grouped entries' plain versions
(K1's / K2's with a group axis) against the per-expert ones bit for bit, the two grouped calls a
FAST layer makes, and the per-(period, expert, channel) weight
exponents.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import (  # noqa: E402
    MOE_DROP_CF,
    MOE_DROP_X_SHAPE,
    MOE_MODES,
    start_shared,
    wait_shared,
)
from _torch_spec_harness import load_reference  # noqa: E402
from repro_torch.configs import smoke  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache, quantize_pow2  # noqa: E402
from repro_torch.kernels.fused_mlp import (  # noqa: E402
    fused_swiglu_grouped,
    fused_swiglu_plain,
)
from repro_torch.kernels.qmatmul import (  # noqa: E402
    qmatmul_grouped,
    qmatmul_plain,
)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    attach_quantized_weights,
    init_from_specs,
    rms_norm,
)

ARCHS = ("granite_moe_3b_a800m", "mixtral_8x22b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_child(request, tmp_path_factory):
    return start_shared(request, tmp_path_factory)


_REFS = {}


def _reference(jax_child, arch):
    """(JAX's records, the port's parameters from JAX's, with the int8
    copies attached)."""
    if arch not in _REFS:
        ref, params = load_reference(wait_shared(jax_child, arch, "moe"))
        _REFS[arch] = ref, params, attach_quantized_weights(params, QuantizedWeightCache())
    return _REFS[arch]


def _layer0_ffn(params):
    def first(node):
        return {k: first(v) for k, v in node.items()} if isinstance(node, dict) else node[0]
    return first(params["periods"]["pos0"]["ffn"])


def _check_moe(ref, params, attached, cfg, key, mode):
    ffn = _layer0_ffn(params if mode in ("exact", "precise") else attached)
    dt = torch.float32 if mode == "exact" else torch.bfloat16
    x = ref[f"{key}/x"]
    out, aux = moe_mod.moe_forward(ffn, torch.from_numpy(x).to(dt), cfg, mode)
    assert out.dtype == dt and out.shape == x.shape
    got, want = out.float().numpy(), ref[f"{key}/{mode}/out"]
    scale = np.abs(want).max()
    if mode in ("fast", "fast8"):
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-6 * scale if mode == "exact" else 2.0 ** -8 * scale
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(aux.numpy(), ref[f"{key}/{mode}/aux"], rtol=1e-6)


@pytest.mark.parametrize("mode", MOE_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(jax_child, arch, mode):
    ref, params, attached = _reference(jax_child, arch)
    _check_moe(ref, params, attached, smoke(arch), "moe", mode)


def _dropped_picks(ffn, x, cfg):
    """Picks past their expert's capacity, per batch row (the dispatch's
    count, recomputed from the router)."""
    h = rms_norm(x, ffn["norm"], cfg.rms_eps).float()
    _, idx = moe_mod.top_k_stable(torch.softmax(h @ ffn["router"].float(), dim=-1),
                                  cfg.moe.top_k)
    counts = torch.nn.functional.one_hot(idx.reshape(x.shape[0], -1), cfg.moe.num_experts).sum(1)
    return (counts - moe_mod._capacity(x.shape[1], cfg)).clamp_min(0).sum(-1).tolist()


@pytest.mark.parametrize("mode", MOE_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_drops_match_reference(jax_child, arch, mode):
    """The capacity-drop path (picks past C scattered to the sink column,
    their gates zeroed in the combine) against JAX's at every rung, on
    MOE_DROP_X at capacity factor MOE_DROP_CF, where every row drops
    picks; tolerances as above."""
    ref, params, attached = _reference(jax_child, arch)
    cfg = smoke(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_DROP_CF))
    x = torch.from_numpy(ref["moe/drop/x"])
    assert x.shape == MOE_DROP_X_SHAPE
    assert all(n > 0 for n in _dropped_picks(_layer0_ffn(params), x, cfg))
    _check_moe(ref, params, attached, cfg, "moe/drop", mode)


def test_top_k_stable_breaks_ties_to_the_lower_expert():
    """``jax.lax.top_k``'s order: a zero input row routes on a uniform
    softmax, and its k picks must be experts 0..k-1 in that order."""
    probs = torch.softmax(torch.zeros(3, 40), dim=-1)
    vals, idx = moe_mod.top_k_stable(probs, 8)
    assert idx.tolist() == [list(range(8))] * 3
    assert torch.equal(vals, probs[:, :8])
    x = torch.tensor([[0.1, 0.5, 0.5, 0.2, 0.5]])
    assert moe_mod.top_k_stable(x, 3)[1].tolist() == [[1, 2, 4]]


# ---------------------------------------------------------------------------
# mirrors of tests/test_moe_ssm.py and tests/test_fused_mlp.py (no JAX)
# ---------------------------------------------------------------------------


def tiny_moe_cfg(E=4, k=2, cf=8.0):
    return ModelConfig(
        name="tiny-moe", d_model=32, n_layers=1,
        period=(LayerSpec(kind="attn", ffn="moe"),),
        vocab=64, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=48,
        moe=MoEConfig(num_experts=E, top_k=k, capacity_factor=cf),
    )


def _tiny_params(cfg):
    gen = torch.Generator().manual_seed(0)
    return init_from_specs(moe_mod.moe_specs(cfg), gen, "cpu")


def dense_moe_oracle(params, x, cfg):
    """Route every token to its top-k experts with NO capacity limit
    (float64 numpy)."""
    xf = x.double().numpy()
    h = xf / np.sqrt((xf * xf).mean(-1, keepdims=True) + cfg.rms_eps)
    h = h * (1.0 + params["norm"].double().numpy())
    logits = h @ params["router"].double().numpy()
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    k = cfg.moe.top_k
    wg, wu, wd = (params[n].double().numpy() for n in ("w_gate", "w_up", "w_down"))
    out = np.zeros_like(h)
    for b in range(x.shape[0]):
        for s in range(x.shape[1]):
            top = np.argsort(-p[b, s])[:k]
            gates = p[b, s, top] / p[b, s, top].sum()
            for e, g in zip(top, gates):
                a = h[b, s] @ wg[e]
                u = h[b, s] @ wu[e]
                out[b, s] += g * (((a / (1 + np.exp(-a))) * u) @ wd[e])
    return out


def test_moe_matches_dense_oracle_dropless(rng):
    cfg = tiny_moe_cfg()
    params = _tiny_params(cfg)
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 32)).astype(np.float32))
    got, aux = moe_mod.moe_forward(params, x, cfg)
    want = dense_moe_oracle(params, x, cfg)
    # expert einsums run in bf16 (production dtype): the reference's tolerance
    np.testing.assert_allclose(got.double().numpy(), want, atol=0.4, rtol=0.05)
    assert np.isfinite(float(aux[0])) and float(aux[0]) > 0


def test_moe_capacity_drops_tokens(rng):
    """With capacity_factor ~ 0, (almost) everything drops -> output ~ 0."""
    cfg = tiny_moe_cfg(cf=0.01)
    params = _tiny_params(cfg)
    x = torch.from_numpy(rng.normal(0, 1, (1, 256, 32)).astype(np.float32))
    got, _ = moe_mod.moe_forward(params, x, cfg)
    dense = dense_moe_oracle(params, x, cfg)
    # capacity 8 slots/expert vs 512 assignments: >90% dropped
    assert np.abs(got.numpy()).sum() < 0.2 * np.abs(dense).sum()


def test_moe_fused_expert_path(rng):
    cfg = smoke("mixtral_8x22b")
    params = _tiny_params(cfg)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 16, cfg.d_model)).astype(np.float32))
    qparams = attach_quantized_weights(params, QuantizedWeightCache())
    fused, aux_f = moe_mod.moe_forward(qparams, x, cfg, "fast")
    unfused, aux_u = moe_mod.moe_forward(params, x, cfg, "fast")
    precise, _ = moe_mod.moe_forward(params, x, cfg, "precise")
    f, u, p = (v.float().numpy() for v in (fused, unfused, precise))
    scale = max(np.abs(p).max(), 1e-6)
    assert np.abs(f - p).max() < 0.15 * scale + 1e-3
    assert np.abs(f - u).max() < 0.15 * scale + 1e-3
    np.testing.assert_allclose(aux_f.numpy(), aux_u.numpy(), rtol=1e-5)


@pytest.mark.parametrize("mode,calls", [("fast", 1), ("fast8", 1), ("exact", 0), ("precise", 0)])
def test_fast_layer_makes_one_call_of_each_grouped_entry(monkeypatch, rng, mode, calls):
    """The FAST expert path is exactly one grouped K2 and one grouped K1
    call a layer (the card counts them as launches), both given the
    dispatch's live rows (``counts`` clipped at C, as (E, B) int32); the
    float rungs make none."""
    cfg = smoke("granite_moe_3b_a800m")
    params = attach_quantized_weights(_tiny_params(cfg), QuantizedWeightCache())
    seen = {"k2": 0, "k1": 0}
    rows = []

    def counted(key, fn):
        def wrapper(*args, **kw):
            seen[key] += 1
            rows.append(kw.get("rows"))
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(moe_mod, "fused_swiglu_grouped", counted("k2", fused_swiglu_grouped))
    monkeypatch.setattr(moe_mod, "qmatmul_grouped", counted("k1", qmatmul_grouped))
    x = torch.from_numpy(rng.normal(size=(3, 5, cfg.d_model)).astype(np.float32))
    x = x.to(torch.float32 if mode == "exact" else torch.bfloat16)
    moe_mod.moe_forward(params, x, cfg, mode)
    assert seen == {"k2": calls, "k1": calls}
    if calls:
        h = rms_norm(x, params["norm"], cfg.rms_eps).float()
        _, idx = moe_mod.top_k_stable(torch.softmax(h @ params["router"].float(), dim=-1),
                                      cfg.moe.top_k)
        counts = torch.nn.functional.one_hot(idx.reshape(3, -1), cfg.moe.num_experts).sum(1)
        want = counts.clamp(max=moe_mod._capacity(5, cfg)).t().to(torch.int32)
        assert all(torch.equal(r, want) for r in rows)


# ---------------------------------------------------------------------------
# the grouped entries (their plain versions: K1's / K2's with a leading
# group axis) against the per-expert K1 / K2
# ---------------------------------------------------------------------------

# (G, M, K, N): M <= 8 is the card's skinny shape, M > 8 its tensor-core
# tiles; K and N multiples of 4
GROUPED_SHAPES = [(3, 1, 64, 32), (4, 8, 96, 64), (5, 17, 64, 96), (2, 40, 128, 20)]


def _i8(gen, *shape):
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)


def _i32(gen, lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)


@pytest.mark.parametrize("epilogue", ["float", "q16", "int32"])
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_qmatmul_grouped_plain_is_per_expert_plain(shape, epilogue):
    G, M, K, N = shape
    gen = torch.Generator().manual_seed(G * 1000 + M)
    a, b = _i8(gen, G, M, K), _i8(gen, G, K, N)
    ea, eb = _i32(gen, -12, -4, 1), _i32(gen, -30, 12, G, N)
    got = qmatmul_grouped(a, b, ea, eb, epilogue)      # a CPU tensor: the plain version
    assert torch.equal(got, qmatmul_plain(a, b, ea, eb, epilogue))
    for g in range(G):
        assert torch.equal(got[g], qmatmul_plain(a[g], b[g], ea, eb[g], epilogue))
    assert qmatmul_grouped.launches == 0


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_fused_swiglu_grouped_plain_is_per_expert_plain(shape):
    G, M, K, F = shape
    gen = torch.Generator().manual_seed(G * 1000 + M + 7)
    x, wg, wu = _i8(gen, G, M, K), _i8(gen, G, K, F), _i8(gen, G, K, F)
    ea, eg, eu = _i32(gen, -8, -4, 1), _i32(gen, -12, -6, G, F), _i32(gen, -12, -6, G, F)
    out, gate, sig = fused_swiglu_grouped(x, wg, wu, ea, eg, eu, return_parts=True)
    for g in range(G):
        w_out, w_gate, w_sig = fused_swiglu_plain(x[g], wg[g], wu[g], ea, eg[g], eu[g],
                                                  return_parts=True)
        assert torch.equal(out[g], w_out)
        assert torch.equal(gate[g], w_gate) and torch.equal(sig[g], w_sig)
    assert torch.equal(out, fused_swiglu_plain(x, wg, wu, ea, eg, eu))
    assert fused_swiglu_grouped.launches == 0


def test_grouped_entries_reject_bad_shapes():
    gen = torch.Generator().manual_seed(0)
    a, b = _i8(gen, 2, 4, 8), _i8(gen, 3, 8, 4)
    with pytest.raises(ValueError, match="shapes"):
        qmatmul_grouped(a, b, _i32(gen, 0, 1, 1), _i32(gen, 0, 1, 2, 4))
    with pytest.raises(ValueError, match="exponents"):
        qmatmul_grouped(a, b[:2], _i32(gen, 0, 1, 1), _i32(gen, 0, 1, 2, 5))
    with pytest.raises(ValueError, match="exponent shapes"):
        fused_swiglu_grouped(a, b[:2], b[:2], _i32(gen, 0, 1, 1), _i32(gen, 0, 1, 4),
                             _i32(gen, 0, 1, 2, 4))


# ---------------------------------------------------------------------------
# the attached expert weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_weights_one_exponent_per_period_expert_channel(jax_child, arch):
    """``attach_quantized_weights`` on the stacked (P, E, d, f) expert
    weights: one exponent per (period, expert, output channel), each
    (period, expert) slice quantized as a matrix of its own, and payloads
    and exponents bit-equal to JAX's; ``params_from_jax`` carries the MoE
    tree unchanged."""
    ref, params, attached = _reference(jax_child, arch)
    cfg = smoke(arch)
    ffn = attached["periods"]["pos0"]["ffn"]
    E, P = cfg.moe.num_experts, cfg.n_periods
    for key, out in (("w_gate", cfg.d_ff), ("w_up", cfg.d_ff), ("w_down", cfg.d_model)):
        q, e = ffn[key + "_q"]["q"], ffn[key + "_q"]["exp"]
        assert q.dtype == torch.int8 and e.shape == (P, E, 1, out)
        np.testing.assert_array_equal(q.numpy(), ref[f"param/periods/pos0/ffn/{key}_q/q"])
        np.testing.assert_array_equal(e.numpy(), ref[f"param/periods/pos0/ffn/{key}_q/exp"])
        w = params["periods"]["pos0"]["ffn"][key]
        one = quantize_pow2(w[1, E - 1], bits=8, axis=1)
        assert torch.equal(q[1, E - 1], one.q) and torch.equal(e[1, E - 1], one.exp)
    for key in ("norm", "router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(params["periods"]["pos0"]["ffn"][key].numpy(),
                                      ref[f"param/periods/pos0/ffn/{key}"])
