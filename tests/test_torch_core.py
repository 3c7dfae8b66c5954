"""The port's engine core against the JAX package, bit for bit: Q-format
conversion and saturating arithmetic, ``q_mul``, ``quantize_pow2``, the
CORDIC bodies over the int32 edges, the exact RoPE phase, the weight
cache's counting hooks and the engine's level dispatch.

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cordic as jc  # noqa: E402
from repro.core import qformat as jq  # noqa: E402
from repro.core.precision import MathEngine as JEngine  # noqa: E402
from repro.core.quantization import quantize_pow2 as j_quantize  # noqa: E402
from repro_torch.core import cordic as tc  # noqa: E402
from repro_torch.core import qformat as tq  # noqa: E402
from repro_torch.core.precision import MathEngine as TEngine  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache  # noqa: E402
from repro_torch.core.quantization import quantize_pow2 as t_quantize  # noqa: E402

I32_EDGES = np.array(
    [0, 1, -1, 2, -2, 65535, 65536, -65536, 2**31 - 1, -(2**31), -(2**31) + 1, 2**31 - 2,
     2**30, -(2**30), 205887, -205887, 102944, -102944, 411775, -411775,
     2**31 - 205887, -(2**31) + 205887, 45426, 681391, -772244, 727, -727],
    dtype=np.int64,
).astype(np.int32)


def _int32_inputs(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    wide = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    near = rng.integers(-(8 << 16), 8 << 16, n, dtype=np.int64).astype(np.int32)
    return np.concatenate([I32_EDGES, wide, near])


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


# ---------------------------------------------------------------------------
# Q-format core
# ---------------------------------------------------------------------------

FORMATS = ["Q16_16", "Q8_24", "Q8_8", "Q1_15", "Q0_7"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_to_from_fixed_bit_exact(fmt):
    jf, tf = getattr(jq, fmt), getattr(tq, fmt)
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.uniform(-1.2, 1.2, 500) * tf.max_value,
        np.array([0.0, -0.0, 0.5 / tf.scale, 1.5 / tf.scale, 2.5 / tf.scale, -2.5 / tf.scale,
                  tf.max_value, tf.min_value, 3 * tf.max_value, 3 * tf.min_value]),
    ]).astype(np.float32)
    raw_j = jq.to_fixed(jnp.asarray(x), jf)
    raw_t = tq.to_fixed(torch.from_numpy(x), tf)
    _eq(raw_j, raw_t)
    _eq(jq.from_fixed(raw_j, jf), tq.from_fixed(raw_t, tf))


@pytest.mark.parametrize("op", ["q_add_sat", "q_sub_sat", "q_add", "q_sub"])
def test_saturating_add_sub_bit_exact(op):
    a = _int32_inputs(2, 1024)
    b = np.roll(a, 7)
    _eq(getattr(jq, op)(jnp.asarray(a), jnp.asarray(b)),
        getattr(tq, op)(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("frac_bits", [8, 16, 24])
@pytest.mark.parametrize("rounding", [True, False])
@pytest.mark.parametrize("saturate", [True, False])
def test_q_mul_bit_exact(frac_bits, rounding, saturate):
    a = _int32_inputs(3, 1024)
    b = np.roll(a, 11)
    got = tq.q_mul(torch.from_numpy(a), torch.from_numpy(b), frac_bits=frac_bits,
                   rounding=rounding, saturate=saturate)
    want = jq.q_mul(jnp.asarray(a), jnp.asarray(b), frac_bits=frac_bits,
                    rounding=rounding, saturate=saturate)
    _eq(want, got)


# ---------------------------------------------------------------------------
# quantize_pow2
# ---------------------------------------------------------------------------


def _quant_eq(x, axis):
    jt = j_quantize(jnp.asarray(x), bits=8, axis=axis)
    tt = t_quantize(torch.from_numpy(x), bits=8, axis=axis)
    _eq(jt.q, tt.q)
    _eq(jt.exp, tt.exp)


@pytest.mark.parametrize("axis", [None, 0, 1, -1, (0,), (1,), (0, 2)])
def test_quantize_pow2_axes_bit_exact(axis):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 7)) * rng.uniform(0.01, 40, (3, 1, 7))).astype(np.float32)
    _quant_eq(x, axis)


def test_quantize_pow2_amax_zero_gives_exponent_zero():
    x = np.zeros((4, 6), np.float32)
    x[1] = 0.75
    _quant_eq(x, None)
    _quant_eq(x, 0)
    t = t_quantize(torch.from_numpy(x), axis=0)
    assert t.exp.flatten().tolist() == [0, -7, 0, 0]


def test_quantize_pow2_half_to_even_ties():
    # amax 127 -> exp 0: payload = round(x), ties to even
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.5], np.float32)
    _quant_eq(x, None)
    assert t_quantize(torch.from_numpy(x)).q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -128]


@pytest.mark.parametrize("k", [-6, -1, 0, 1, 3, 10])
def test_quantize_pow2_at_and_just_above_powers_of_two(k):
    """ceil(log2 amax) in f32: at 2**k the exponent is k-7; one ulp
    above, f32 log2 may round back to k and the payload clips to 127 —
    the port computes it the same way (f32 log2, ceil), not with frexp."""
    for amax in (np.float32(2.0 ** k), np.float32(2.0 ** k) * np.float32(1 + 2.0 ** -23)):
        x = np.array([amax, -amax / 3, amax / 7, 0.0], np.float32)
        _quant_eq(x, None)


def test_weight_cache_counting_hooks():
    cache = QuantizedWeightCache()
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 4)).astype(np.float32))
    a = cache.get("w", w, axis=1)
    b = cache.get("w", w, axis=1)
    assert a is b and cache.quantize_calls == 1 and cache.hits == 1
    with pytest.raises(ValueError):
        cache.get("w", w.T.contiguous(), axis=1)
    assert cache.invalidate("w") == 1 and len(cache) == 0


# ---------------------------------------------------------------------------
# CORDIC bodies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iterations,frac_bits", [(16, 16), (24, 24), (12, 16)])
def test_cordic_sincos_bit_exact_over_int32(iterations, frac_bits):
    th = _int32_inputs(6)
    js, jcos = jc.cordic_sincos_q16(jnp.asarray(th), iterations=iterations, frac_bits=frac_bits)
    ts, tcos = tc.cordic_sincos_q16(torch.from_numpy(th), iterations=iterations,
                                   frac_bits=frac_bits)
    _eq(js, ts)
    _eq(jcos, tcos)


@pytest.mark.parametrize("body", ["sigmoid_q16_body", "tanh_q16_body", "exp_q16_body"])
def test_hyperbolic_bodies_bit_exact_over_int32(body):
    t = _int32_inputs(7)
    _eq(getattr(jc, body)(jnp.asarray(t)), getattr(tc, body)(torch.from_numpy(t)))


def test_div_body_bit_exact_over_int32():
    num = _int32_inputs(8, 2048)
    den = np.concatenate([np.roll(num, 5)[:-8], np.array([0, 0, 1, -1, 65536, -65536,
                                                           2**31 - 1, -(2**31)], np.int32)])
    _eq(jc.div_q16_body(jnp.asarray(num), jnp.asarray(den)),
        tc.div_q16_body(torch.from_numpy(num), torch.from_numpy(den)))


@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_exact_rope_phase_bit_exact(head_dim):
    pos = np.concatenate([np.arange(0, 32769, 97), [32767, 32768, 65535, 524287, 2**31 - 1]])
    pos = pos.astype(np.int32)
    hi, lo = jc.rope_inv_freq_q64(head_dim)
    thi, tlo = tc.rope_inv_freq_q64(head_dim)
    np.testing.assert_array_equal(hi, thi)
    np.testing.assert_array_equal(lo, tlo)
    want = jc.exact_rope_phase_q16(jnp.asarray(pos)[:, None], jnp.asarray(hi)[None],
                                   jnp.asarray(lo)[None])
    got = tc.exact_rope_phase_q16(torch.from_numpy(pos)[:, None],
                                  torch.from_numpy(hi.astype(np.int64))[None],
                                  torch.from_numpy(lo.astype(np.int64))[None])
    _eq(want, got)


def test_cordic_constants_match_reference():
    assert tc.CORDIC_K_INV_Q16 == jc.CORDIC_K_INV_Q16
    assert (tc.PI_Q16, tc.HALF_PI_Q16, tc.TWO_PI_Q16) == (jc.PI_Q16, jc.HALF_PI_Q16, jc.TWO_PI_Q16)
    np.testing.assert_array_equal(tc.ATAN_TABLE_Q16, jc.ATAN_TABLE_Q16)
    assert tc.hyperbolic_schedule(20) == jc.hyperbolic_schedule(20)
    assert (tc.LN2_Q16, tc.INV_LN2_Q16, tc.EXP_SAT_HI_Q16, tc.EXP_FLUSH_LO_Q16) == (
        jc.LN2_Q16, jc.INV_LN2_Q16, jc.EXP_SAT_HI_Q16, jc.EXP_FLUSH_LO_Q16)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,level", [("sin", "q16_16"), ("cos", "q16_16"), ("sin", "q8_24"),
                                      ("mul", "q16_16"), ("add", "f32"), ("cos", "f32")])
def test_engine_dispatch_matches_reference(op, level):
    rng = np.random.default_rng(9)
    x = rng.uniform(-3, 3, 64).astype(np.float32)
    je, te = JEngine(level), TEngine(level)
    if op in ("mul", "add"):
        a = (x * 65536).astype(np.int32) if level != "f32" else x
        b = np.roll(a, 3)
        want = je.call(op, jnp.asarray(a), jnp.asarray(b))
        got = te.call(op, torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    else:
        want = np.asarray(je.call(op, jnp.asarray(x)))
        got = te.call(op, torch.from_numpy(x)).numpy()
        if level == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)  # libm ulp differences
        else:
            np.testing.assert_array_equal(got, want)


def test_engine_switched_table_and_set_level():
    te = TEngine("q16_16")
    table, names = te.switched("sin", levels=("q16_16", "f32"))
    assert names == ("q16_16", "f32") and len(table) == 2
    x = torch.tensor([0.5, -1.0])
    np.testing.assert_allclose(table[1](x).numpy(), torch.sin(x).numpy())
    assert te.set_level("f32") >= 0.0 and te.level.name == "f32"
    assert te.switch_stats.count == 1
    assert te.level_index(("q16_16", "f32")) == 1
    with te.at("q8_24"):
        assert te.level.name == "q8_24"
    assert te.level.name == "f32"
