"""The port's C3 (``core/linalg.py``, ``kernels/linalg``), the Q-format
limb helpers, ``static_footprint_bytes`` and the engine's ``matmul`` op
against the JAX package, on the CPU (plain versions).

Tolerances: every integer result bit-exact — ``qmatmul_deferred`` against
JAX's and against ``tests/test_linalg.py``'s numpy oracle (which clips the
int64 tile sums, so it equals JAX's only while a tile's sum fits int32:
the saturating and wrapping cases are held against JAX alone),
``qmatmul_per_element`` and the (hi, lo) helpers against JAX;
``matmul_float`` at 1e-6 relative (f32 sums in another order).

JAX compiles ``qmatmul_deferred`` once per (shape, tile_k, rounding), a
quarter second each, so the whole tile_k 1-40 x rounding grid is held
against the oracle and a spread of it against JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import linalg as jla  # noqa: E402
from repro.core import qformat as jq  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import linalg as tla  # noqa: E402
from repro_torch.core import qformat as tq  # noqa: E402
from repro_torch.kernels.linalg import qmatmul_deferred, qmatmul_deferred_plain  # noqa: E402
from test_linalg import numpy_oracle_deferred, rand_q  # noqa: E402

SHAPES = [(4, 4, 4), (8, 16, 8), (33, 40, 17), (64, 64, 64)]
JAX_GRID = [1, 7, 32, 40]
EDGES = np.array([0, 1, -1, 2, -2, 65535, 65536, -65536, 32768, 2**31 - 1, -(2**31),
                  -(2**31) + 1, 123456789, -123456789, 2**30, -(2**30)], np.int32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _port(a, b, **kw):
    return tla.qmatmul_deferred(_t(a), _t(b), **kw).numpy()


def _jax(a, b, **kw):
    return np.asarray(jla.qmatmul_deferred(a, b, **kw))


@pytest.mark.parametrize("shape", SHAPES)
def test_deferred_matches_reference_and_oracle(shape):
    rng = np.random.default_rng(sum(shape))
    M, K, N = shape
    a, b = rand_q(rng, (M, K)), rand_q(rng, (K, N))
    got = _port(a, b, tile_k=32)
    np.testing.assert_array_equal(got, _jax(a, b, tile_k=32))
    np.testing.assert_array_equal(got, numpy_oracle_deferred(a, b, tile_k=32))


@pytest.mark.parametrize("rounding", [True, False])
@pytest.mark.parametrize("tile_k", range(1, 41))
def test_deferred_tile_grid_matches_oracle(tile_k, rounding):
    """tests/test_linalg.py's property grid, every point: ragged last
    tiles (K = 45 is a multiple of few tile sizes) round once each."""
    rng = np.random.default_rng(1000 * tile_k + rounding)
    a, b = rand_q(rng, (7, 45)), rand_q(rng, (45, 5))
    got = _port(a, b, tile_k=tile_k, rounding=rounding)
    np.testing.assert_array_equal(got, numpy_oracle_deferred(a, b, tile_k=tile_k,
                                                             rounding=rounding))
    if tile_k in JAX_GRID:
        np.testing.assert_array_equal(got, _jax(a, b, tile_k=tile_k, rounding=rounding))


def _saturating(rng, M, K, N):
    """Operands near +-32767.0 against ones of magnitude <= 1: products
    near the int32 edge, so whole tiles wrap and tiles saturate."""
    a = rng.integers(32760 * 65536, 2**31 - 1, (M, K)) * rng.choice([-1, 1], (M, K))
    b = rng.integers(-65536, 65537, (K, N))
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("tile_k", [1, 3, 40])
@pytest.mark.parametrize("saturate", [True, False])
def test_deferred_saturating_and_wrapping_match_reference(tile_k, saturate):
    rng = np.random.default_rng(tile_k + 7 * saturate)
    a, b = _saturating(rng, 6, 41, 5)
    got = _port(a, b, tile_k=tile_k, saturate=saturate)
    np.testing.assert_array_equal(got, _jax(a, b, tile_k=tile_k, saturate=saturate))
    if saturate and tile_k == 1:
        assert (np.abs(got.astype(np.int64)) == 2**31 - 1).any() or (got == -(2**31)).any()


@pytest.mark.parametrize("frac_bits", [1, 8, 24, 31])
def test_deferred_full_int32_range_wraps_like_the_limbs(frac_bits):
    """Any int32 words: tile sums wrap mod 2**64 in the reference's
    limbs; only bits [frac_bits, frac_bits + 32) reach the result."""
    rng = np.random.default_rng(frac_bits)
    a = rng.integers(-(2**31), 2**31, (5, 37)).astype(np.int32)
    b = rng.integers(-(2**31), 2**31, (37, 3)).astype(np.int32)
    np.testing.assert_array_equal(_port(a, b, frac_bits=frac_bits, tile_k=13),
                                  _jax(a, b, frac_bits=frac_bits, tile_k=13))


def test_deferred_identity_zero_and_empty():
    rng = np.random.default_rng(3)
    a = rand_q(rng, (16, 16))
    eye = np.asarray(jq.to_fixed(np.eye(16, dtype=np.float32)))
    np.testing.assert_array_equal(_port(a, eye), a)
    np.testing.assert_array_equal(_port(a, np.zeros((16, 16), np.int32)), 0)
    assert _port(np.zeros((3, 0), np.int32), np.zeros((0, 2), np.int32)).tolist() == [[0, 0]] * 3


def test_deferred_wrapper_runs_the_plain_version_on_the_cpu():
    a = torch.ones((2, 3), dtype=torch.int32) << 16
    before = qmatmul_deferred.launches
    assert torch.equal(qmatmul_deferred(a, a.T.contiguous()),
                       qmatmul_deferred_plain(a, a.T.contiguous()))
    assert qmatmul_deferred.launches == before
    with pytest.raises(ValueError, match="frac_bits"):
        qmatmul_deferred(a, a.T, frac_bits=32)
    with pytest.raises(ValueError, match="unsupported device"):
        qmatmul_deferred(a.to("meta"), a.T.to("meta"))


def test_per_element_matches_reference():
    rng = np.random.default_rng(5)
    for rounding in (True, False):
        a, b = rand_q(rng, (5, 7), scale=3.0), rand_q(rng, (7, 3), scale=3.0)
        np.testing.assert_array_equal(
            tla.qmatmul_per_element(_t(a), _t(b), rounding=rounding).numpy(),
            np.asarray(jla.qmatmul_per_element(a, b, rounding=rounding)))
    a = rng.integers(-(2**31), 2**31, (4, 6)).astype(np.int32)
    b = rng.integers(-(2**31), 2**31, (6, 2)).astype(np.int32)
    np.testing.assert_array_equal(tla.qmatmul_per_element(_t(a), _t(b)).numpy(),
                                  np.asarray(jla.qmatmul_per_element(a, b)))


def test_derive_tile_size_matches_reference():
    for args in [(8192 + 4096, 4), (4 * 2**20, 1, 128), (1, 4), (12, 4), (10**9, 2, 64)]:
        assert tla.derive_tile_size(*args) == jla.derive_tile_size(*args)


def test_matmul_float_matches_reference():
    rng = np.random.default_rng(11)
    a = rng.uniform(-1, 1, (33, 70)).astype(np.float32)
    b = rng.uniform(-1, 1, (70, 9)).astype(np.float32)
    got = tla.matmul_float(_t(a), _t(b)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jla.matmul_float(a, b)), rtol=1e-6, atol=1e-6)


def test_widening_helpers_match_reference_over_int32_edges():
    A, B = (x.reshape(-1) for x in np.meshgrid(EDGES, EDGES))
    jh, jl = jq.widening_mul_i32(A, B)
    th, tl = tq.widening_mul_i32(_t(A), _t(B))
    u = lambda x: np.asarray(x).astype(np.int64)  # noqa: E731
    np.testing.assert_array_equal(th.numpy(), u(jh))
    np.testing.assert_array_equal(tl.numpy(), u(jl))
    for add in (0, 1, 2**15, 2**31 + 5, 2**32 - 1):
        jr, tr = jq.add_64(jh, jl, np.uint32(add)), tq.add_64(th, tl, add)
        np.testing.assert_array_equal(np.stack([t.numpy() for t in tr]), u(np.stack(jr)))
    jr, tr = jq.add_64_pair(jh, jl, jl, jh), tq.add_64_pair(th, tl, tl, th)
    np.testing.assert_array_equal(np.stack([t.numpy() for t in tr]), u(np.stack(jr)))
    for n in (1, 15, 16, 17, 31):
        jr, tr = jq.shift_right_64(jh, jl, n), tq.shift_right_64(th, tl, n)
        np.testing.assert_array_equal(np.stack([t.numpy() for t in tr]), u(np.stack(jr)))
    with pytest.raises(ValueError):
        tq.shift_right_64(th, tl, 32)


def test_static_footprint_is_the_papers_88_bytes():
    assert tq.static_footprint_bytes() == jq.static_footprint_bytes()
    assert tq.static_footprint_bytes()["total_bytes"] == 88
    assert tq.static_footprint_bytes(13, 24) == jq.static_footprint_bytes(13, 24)


def test_core_exports_the_references_names_it_has():
    missing = {n for n in jcore.__all__ if n not in tcore.__all__}
    # not ported yet, each named in repro_torch/core/__init__.py's docstring
    assert missing == {
        "PrecisionContext", "atan2_q16", "cordic_atan2", "cordic_atan2_24", "cordic_div",
        "cordic_exp", "cordic_log", "cordic_sigmoid", "cordic_sqrt", "cordic_tanh", "div_q16",
        "exp_q16", "log_q16", "rope_tables_cordic", "sigmoid_q16", "sqrt_q16", "tanh_q16"}
    assert tcore.OP_SET == jcore.OP_SET


# ---------------------------------------------------------------------------
# the engine's matmul
# ---------------------------------------------------------------------------


def test_engine_registers_the_whole_op_set():
    eng = tcore.MathEngine("q16_16")
    for op in tcore.OP_SET:
        assert "q16_16" in eng._impls[op] or "f32" in eng._impls[op], op
    assert eng._impls["matmul"]["q16_16"] is tla.qmatmul_deferred
    assert eng._impls["matmul"]["f32"] is tla.matmul_float


@pytest.mark.parametrize("level", ["q16_16", "f32", "q8_8", "q8_24"])
def test_engine_matmul_matches_reference_engine(level):
    """q16_16 (and q8_8, which resolves up to it) on Q16.16 words,
    bit-exact; f32 (and q8_24, which resolves up to it) on floats."""
    rng = np.random.default_rng(17)
    af = rng.uniform(-1, 1, (12, 70)).astype(np.float32)
    bf = rng.uniform(-1, 1, (70, 6)).astype(np.float32)
    j_eng, t_eng = jcore.MathEngine(level), tcore.MathEngine(level)
    if level in ("q16_16", "q8_8"):
        a, b = np.asarray(jq.to_fixed(af)), np.asarray(jq.to_fixed(bf))
        got = t_eng.call("matmul", _t(a), _t(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_eng.call("matmul", a, b)))
    else:
        got = t_eng.call("matmul", _t(af), _t(bf)).numpy()
        np.testing.assert_allclose(got, np.asarray(j_eng.call("matmul", af, bf)), rtol=1e-6,
                                   atol=1e-6)


def test_engine_matmul_within_the_references_float_bound():
    """tests/test_linalg.py::test_error_vs_float_bound on both rungs: at
    most ceil(K/32) * 2**-17 + 1e-6 from the float64 product."""
    rng = np.random.default_rng(42)
    af = rng.uniform(-1, 1, (64, 64)).astype(np.float32)
    bf = rng.uniform(-1, 1, (64, 64)).astype(np.float32)
    a, b = tq.to_fixed(_t(af)), tq.to_fixed(_t(bf))
    want = tq.from_fixed(a).double() @ tq.from_fixed(b).double()
    bound = 2 * 2.0 ** -17 + 1e-6
    eng = tcore.MathEngine("q16_16")
    assert (tq.from_fixed(eng.call("matmul", a, b)).double() - want).abs().max() <= bound
    with eng.at("f32"):
        got = eng.call("matmul", tq.from_fixed(a), tq.from_fixed(b))
    assert (got.double() - want).abs().max() <= bound


def test_compile_op_runs_each_path_once_and_registers_it():
    """The reference's test_compile_op_aot_paths: a 'square' op at both
    rungs.  Eager torch compiles nothing; each implementation runs once
    on the example and then serves ``call``."""
    runs = []

    def precise_fn(x):
        runs.append("f32")
        return torch.matmul(x, x)

    def fast_fn(x):
        runs.append("q16_16")
        q = tq.to_fixed(x)
        return tq.from_fixed(tla.qmatmul_deferred(q, q))

    eng = tcore.MathEngine(tcore.Mode.PRECISE)
    x = _t(np.random.default_rng(0).uniform(-1, 1, (16, 16)).astype(np.float32))
    eng.compile_op("square", {tcore.Mode.PRECISE: precise_fn, tcore.Mode.FAST: fast_fn}, x)
    assert sorted(runs) == ["f32", "q16_16"]
    precise = eng.call("square", x)
    eng.set_mode(tcore.Mode.FAST)
    fast = eng.call("square", x)
    np.testing.assert_allclose(fast.numpy(), precise.numpy(), atol=1e-2)
    with pytest.raises(ValueError, match="no implementations"):
        eng.compile_op("square", {}, x)
