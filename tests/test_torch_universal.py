"""The port's universal CORDIC family — K5 (sqrt exp log tanh sigmoid),
K6 (atan2) and K7 (div) — and K4's gemma2 extensions (head width 256,
score softcap) against the JAX package.

The plain versions, which the CUDA kernels are held against on the card
(tests/test_torch_cuda.py, chip_smoke.py), must be bit-exact against
the numpy-int64 oracles of ``src/repro/kernels/cordic/ref.py`` over
seeded int32 sweeps with the edge values, across the ``stages`` and
``frac_bits`` / ``iterations`` sweeps, and against the Pallas kernels in
interpret mode at one small shape each.  The engine's fixed rungs and
``PrecisionPolicy`` are bit-exact against the JAX engine; its ``f32``
rung at 2 f32 ulps (libm differences).  K4's plain twin with a softcap
and D = 256 is held against ``chunked_attention(cap=...)`` at the
reference tests' 2e-3 (f32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.precision import MathEngine as JEngine  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core import cordic as jcordic  # noqa: E402
from repro.core import qformat as jq  # noqa: E402
from repro.kernels.cordic import ops as rops  # noqa: E402
from repro.kernels.cordic import ref  # noqa: E402
from repro.kernels.cordic.universal import (  # noqa: E402
    atan2_kernel_call,
    div_kernel_call,
    universal_kernel_call,
)
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.core.precision import MathEngine as TEngine  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy as TPolicy  # noqa: E402
from repro_torch.kernels.cordic import (  # noqa: E402
    FLOAT_EDGES,
    UNARY_OPS,
    atan2_24_f32,
    atan2_f32,
    atan2_q16,
    atan2_q16_plain,
    div_f32,
    div_q16,
    div_q16_plain,
    rope_freq_limbs,
    rope_sincos_plain,
    universal_unary,
    universal_unary_plain,
)
from repro_torch.kernels.cordic import ops as tops  # noqa: E402
from repro_torch.kernels.flashattn import (  # noqa: E402
    bf16_close,
    flash_attention,
    flash_attention_plain,
    p_rounding_case,
)

EDGES = np.array([0, 1, -1, 2, -2, 3, 65535, 65536, 65537, -65536, 32768, 2**31 - 1, -(2**31),
                  -(2**31) + 1, 2**31 - 2, 123456789, -123456789, 681391, -772244, 681390,
                  -772243, 2**30, -(2**30)], np.int32)


def _words(seed, n=4096):
    """int32 words: the edges, the whole int32 range and the Q16.16
    region most callers use."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        EDGES,
        rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32),
        rng.integers(-40 * 65536, 40 * 65536, n).astype(np.int32),
        rng.integers(-300, 300, 64).astype(np.int32),
    ])


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# K5 / K6 / K7 plain versions: oracles and Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", sorted(UNARY_OPS))
@pytest.mark.parametrize("stages", [20, 16, 3, 30])
def test_unary_plain_bit_exact_vs_oracle(op, stages):
    w = _words(stages)
    want = ref.UNARY_REFS[op](w, stages=stages)
    got = universal_unary_plain(_t(w), op, stages).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iterations,frac_bits", [(16, 16), (24, 24), (12, 16), (32, 24)])
def test_atan2_plain_bit_exact_vs_oracle(iterations, frac_bits):
    x = np.concatenate([_words(1), EDGES, np.zeros_like(EDGES)])
    y = np.concatenate([np.roll(_words(1), 11), np.zeros_like(EDGES), EDGES])
    want = ref.atan2_ref(y, x, iterations=iterations, frac_bits=frac_bits)
    got = atan2_q16_plain(_t(y), _t(x), iterations, frac_bits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iterations", [17, 10, 24])
def test_div_plain_bit_exact_vs_oracle(iterations):
    num = np.concatenate([_words(2), EDGES, np.zeros_like(EDGES)])
    den = np.concatenate([np.roll(_words(2), 5), np.zeros_like(EDGES), EDGES])
    den[:40] = np.arange(-20, 20)                     # tiny denominators
    want = ref.div_ref(num, den, iterations=iterations)
    got = div_q16_plain(_t(num), _t(den), iterations).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_versions_bit_exact_vs_pallas_kernels():
    """One small shape each, the Pallas kernels in interpret mode (one
    block of 8 x 128 words, a ragged tail padded with 0); K5 at the op
    serving runs (tanh), every op is held against the oracles above."""
    w = _words(3, 600)[:1000].reshape(10, 100)
    want = np.asarray(universal_kernel_call(w, op="tanh", block_rows=8, interpret=True))
    np.testing.assert_array_equal(universal_unary(_t(w), "tanh").numpy(), want)
    y = np.roll(w, 3)
    want = np.asarray(atan2_kernel_call(y, w, block_rows=8, interpret=True))
    np.testing.assert_array_equal(atan2_q16(_t(y), _t(w)).numpy(), want)
    want = np.asarray(div_kernel_call(y, w, block_rows=8, interpret=True))
    np.testing.assert_array_equal(div_q16(_t(y), _t(w)).numpy(), want)


def test_wrappers_route_cpu_and_check_inputs():
    w = _t(EDGES)
    before = (universal_unary.launches, atan2_q16.launches, div_q16.launches)
    universal_unary(w, "tanh")
    atan2_q16(w, w)
    div_q16(w, w)
    assert (universal_unary.launches, atan2_q16.launches, div_q16.launches) == before
    with pytest.raises(ValueError, match="unknown universal op"):
        universal_unary(w, "cbrt")
    with pytest.raises(TypeError):
        universal_unary(w.to(torch.int64), "exp")
    with pytest.raises(ValueError):
        atan2_q16(w, w[:3])


# ---------------------------------------------------------------------------
# K6's and K7's float entries: plain versions against the reference ops
# ---------------------------------------------------------------------------

#: the finite float edges of the float entries.  NaN and +-inf are held on
#: the card only (tests/test_torch_cuda.py): XLA's and torch's CPU casts of
#: NaN differ.
FINITE_EDGES = np.array([v for v in FLOAT_EDGES if np.isfinite(v)], np.float32)


def _float_pairs(seed, n=600):
    """Seeded f32 (y, x) over the Q16.16 range and past it (every seventh
    an exact half of the Q16.16 grid), then the edges paired every way."""
    rng = np.random.default_rng(seed)
    f = np.concatenate([rng.uniform(-300, 300, n), rng.uniform(-40000, 40000, n),
                        rng.standard_normal(n) * 1e-4]).astype(np.float32)
    f[::7] = (np.round(f[::7].astype(np.float64) * 65536) + 0.5) / 65536
    ey, ex = (a.ravel() for a in np.meshgrid(FINITE_EDGES, FINITE_EDGES, indexing="ij"))
    return np.concatenate([np.roll(f, 5), ey]), np.concatenate([f, ex])


@jax.jit
def _ref_atan2_24_chain(y, x, iterations):
    """cordic_atan2_24's chain with another count, on the Pallas kernel."""
    m = jnp.maximum(jnp.abs(y), jnp.abs(x))
    s = jnp.where(m > 0, m, jnp.float32(1.0))
    out = atan2_kernel_call(jq.to_fixed(y / s, jq.Q8_24), jq.to_fixed(x / s, jq.Q8_24),
                            iterations=iterations, frac_bits=24, interpret=True)
    return jq.from_fixed(out, jq.Q8_24)


_ref_atan2_24_chain = jax.jit(_ref_atan2_24_chain.__wrapped__, static_argnames=("iterations",))


def _reference_float_op(entry, y, x, iterations):
    y, x = jnp.asarray(y), jnp.asarray(x)
    if entry == "atan2":
        return rops.atan2(y, x, iterations=iterations, interpret=True)
    if entry == "div":
        return rops.div(y, x, iterations=iterations, interpret=True)
    if iterations == jcordic.ITER_Q24:
        return JEngine("q8_24").call("atan2", y, x)     # cordic_atan2_24
    return _ref_atan2_24_chain(y, x, iterations=iterations)


FLOAT_ENTRY_CASES = [("atan2", atan2_f32, 16), ("atan2", atan2_f32, 7),
                     ("atan2_24", atan2_24_f32, 24), ("atan2_24", atan2_24_f32, 12),
                     ("div", div_f32, 17), ("div", div_f32, 9)]


@pytest.mark.parametrize("entry,fn,iterations", FLOAT_ENTRY_CASES,
                         ids=[f"{e}-{i}" for e, _, i in FLOAT_ENTRY_CASES])
def test_float_entries_plain_bit_exact_vs_reference_ops(entry, fn, iterations):
    """The float entries' plain versions (what a CPU tensor runs) against
    the reference's jitted float ops (``kernels.cordic.ops.atan2`` /
    ``div`` on the Pallas kernels in interpret mode, the reference
    engine's q8_24 atan2), bit for bit."""
    y, x = _float_pairs(iterations)
    want = np.asarray(_reference_float_op(entry, y, x, iterations))
    got = fn(_t(y), _t(x), iterations).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_float_entries_route_cpu_and_check_inputs():
    y = _t(np.linspace(-3, 3, 13, dtype=np.float32))
    entries = (atan2_f32, atan2_24_f32, div_f32)
    before = [fn.launches for fn in entries]
    for fn in entries:
        assert fn(y, y.flip(0)).dtype == torch.float32
    assert [fn.launches for fn in entries] == before
    for fn in entries:
        with pytest.raises(TypeError, match="float32"):
            fn(y.double(), y.double())
        with pytest.raises(TypeError, match="float32"):
            fn(y.to(torch.int32), y.to(torch.int32))
        with pytest.raises(ValueError, match="shapes differ"):
            fn(y, y[:3])
    # the engine's ops take any float input and reach the float entries
    got = tops.atan2(y.double(), np.ones(13))
    np.testing.assert_array_equal(got.numpy(), atan2_f32(y, torch.ones(13)).numpy())


# ---------------------------------------------------------------------------
# float-boundary ops and the engine
# ---------------------------------------------------------------------------


ENGINE_OPS = ["atan2", "div", "sqrt", "exp", "log", "tanh", "sigmoid"]


def _engine_args(op, rng):
    if op in ("atan2", "div"):
        return (rng.uniform(-30, 30, 512).astype(np.float32),
                rng.uniform(-30, 30, 512).astype(np.float32))
    if op in ("sqrt", "log"):
        return (rng.uniform(0.01, 300, 512).astype(np.float32),)
    return (rng.uniform(-8, 8, 512).astype(np.float32),)


@pytest.mark.parametrize("op,level", [(op, lv) for op in ENGINE_OPS for lv in ("q16_16", "f32")]
                         + [("atan2", "q8_24"), ("div", "q8_24"), ("exp", "q8_24")])
def test_engine_ops_match_reference_engine(op, level):
    args = _engine_args(op, np.random.default_rng(len(op)))
    want = np.asarray(JEngine(level).call(op, *[jnp.asarray(a) for a in args]))
    got = TEngine(level).call(op, *[_t(a) for a in args]).numpy()
    # q8_24 has an atan2 of its own; its div and exp fall to the f32 rung
    # (nearest more precise), where a / b rounds the same everywhere
    if level == "q16_16" or (level == "q8_24" and op in ("atan2", "div")):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-7)


@pytest.mark.parametrize("op", ENGINE_OPS)
def test_float_ops_bit_exact_vs_reference_engine(op):
    """``kernels.cordic.ops`` (K5-K7 at the float boundary) against the
    JAX engine's q16_16 rung, which runs the same bodies."""
    args = _engine_args(op, np.random.default_rng(len(op)))
    want = np.asarray(JEngine("q16_16").call(op, *[jnp.asarray(a) for a in args]))
    if op in ("atan2", "div"):
        got = getattr(tops, op)(*[_t(a) for a in args])
    else:
        got = tops.unary_op(_t(args[0]), op)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sincos_and_rope_tables_ops_match_reference():
    rng = np.random.default_rng(11)
    t = rng.uniform(-20, 20, 512).astype(np.float32)
    je = JEngine("q16_16")
    s, c = tops.sincos(_t(t))
    np.testing.assert_array_equal(s.numpy(), np.asarray(je.call("sin", jnp.asarray(t))))
    np.testing.assert_array_equal(c.numpy(), np.asarray(je.call("cos", jnp.asarray(t))))
    hi, lo = rope_freq_limbs(64, 10000.0)
    pos = torch.arange(0, 4000, 7, dtype=torch.int32)
    s, c = tops.rope_tables(pos, torch.from_numpy(hi), torch.from_numpy(lo))
    ws, wc = rope_sincos_plain(pos, 64)
    np.testing.assert_array_equal(s.numpy(), ws.numpy() / 65536.0)
    np.testing.assert_array_equal(c.numpy(), wc.numpy() / 65536.0)


def test_policy_pins_ops_like_the_reference():
    rng = np.random.default_rng(8)
    y, x = _engine_args("atan2", rng)
    (t,) = _engine_args("tanh", rng)
    pol_j = JPolicy(default="q16_16", per_op={"atan2": "q8_24"})
    pol_t = TPolicy(default="q16_16", per_op={"atan2": "q8_24"})
    assert pol_t.per_op == (("atan2", "q8_24"),) and "atan2" in pol_t and "exp" not in pol_t
    je, te = JEngine("f32"), TEngine("f32")
    with je.at(pol_j), te.at(pol_t):
        assert te.level_for("atan2") == "q8_24" and te.level_for("tanh") == "q16_16"
        np.testing.assert_array_equal(te.call("atan2", _t(y), _t(x)).numpy(),
                                      np.asarray(je.call("atan2", jnp.asarray(y), jnp.asarray(x))))
        np.testing.assert_array_equal(te.call("tanh", _t(t)).numpy(),
                                      np.asarray(je.call("tanh", jnp.asarray(t))))
    assert te.policy is None and te.level_for("tanh") == "f32"
    assert te.set_policy(pol_t) > 0.0 and te.set_policy(TPolicy(default="q16_16",
                                                                per_op={"atan2": "q8_24"})) == 0.0
    te2 = TEngine("q16_16", policy=TPolicy(per_op={"exp": "f32"}))
    assert te2.level_for("exp") == "f32" and te2.level_for("log") == "q16_16"


# ---------------------------------------------------------------------------
# K4 at gemma2's head width, with the score softcap
# ---------------------------------------------------------------------------

# (B, S, H, KV, D, causal, window, softcap)
K4_GEMMA_CASES = [
    (1, 40, 4, 2, 256, True, None, 50.0),
    (1, 45, 2, 1, 256, True, 16, 50.0),       # sliding window
    (2, 30, 2, 2, 64, True, None, 5.0),       # a cap that bites
]


@pytest.mark.parametrize("case", K4_GEMMA_CASES)
def test_flash_plain_softcap_matches_chunked_attention(case):
    B, S, H, KV, D, causal, window, cap = case
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32) * 3
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32) * 3
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window, softcap=cap).numpy()
    want = np.asarray(chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.broadcast_to(jnp.arange(S)[None], (B, S)), causal=causal, window=window,
        cap=cap))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    uncapped = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    assert np.abs(uncapped - want).max() > 1e-2      # the cap changed the result


def test_p_rounding_case_discriminates():
    """Rounded p (the reference) against unrounded p (the same inputs
    in f32): the case must fail the bf16 tolerance when p is left
    unrounded, so a kernel that skips the rounding fails on the card."""
    q, k, v = p_rounding_case()
    want = flash_attention_plain(q, k, v, causal=False).float()
    unrounded = flash_attention_plain(q.float(), k.float(), v.float(), causal=False)
    assert bf16_close(want, want)
    assert not bf16_close(unrounded.to(torch.bfloat16).float(), want)
    ref_np = np.asarray(chunked_attention(
        jnp.asarray(q.float().numpy(), jnp.bfloat16), jnp.asarray(k.float().numpy(), jnp.bfloat16),
        jnp.asarray(v.float().numpy(), jnp.bfloat16), q_positions=jnp.arange(64)[None],
        causal=False), np.float32)
    assert bf16_close(want, torch.from_numpy(ref_np))
