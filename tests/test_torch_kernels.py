"""The port's kernels K1-K4 — their plain PyTorch versions, which the
CUDA kernels are held against on the card — against the JAX package's
Pallas kernels (interpret mode) and their numpy oracles; plus the
wrappers' contract checks and device routing.

Tolerances: integer outputs bit-exact.  The float epilogues of K1/K2
are exact scalings of exact integers, so the plain versions equal the
float64 oracles rounded to f32 bit for bit; XLA's own f32 forms (the
Pallas kernel in interpret mode, ``fused_swiglu_parts``) may differ by
an ulp, so they are held at the reference tests' f32 tolerance (rtol
1e-6 for K1, 1e-5 for K2's three-factor product).  Attention at 2e-3
(f32) and 2e-2 (bf16), the reference tests' bounds for summation-order
and bf16-rounding differences.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cordic as jcordic  # noqa: E402
from repro.kernels.cordic.cordic import cordic_kernel_call  # noqa: E402
from repro.kernels.cordic.ref import cordic_sincos_ref  # noqa: E402
from repro.kernels.flashattn.flashattn import flash_attention_call  # noqa: E402
from repro.kernels.flashattn.ref import attention_ref  # noqa: E402
from repro.kernels.fused_mlp.ops import fused_swiglu_parts  # noqa: E402
from repro.kernels.fused_mlp.ref import fused_swiglu_ref  # noqa: E402
from repro.kernels.qmatmul.qmatmul import qmatmul_kernel_call  # noqa: E402
from repro.kernels.qmatmul.ref import qmatmul_ref  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels.cordic import (  # noqa: E402
    cordic_sincos,
    cordic_sincos_plain,
    rope_sincos_plain,
    rope_sincos_q16,
)
from repro_torch.kernels.flashattn import (  # noqa: E402
    KEY_TILE,
    bf16_close,
    flash_attention,
    flash_attention_plain,
    p_rounding_case,
)
from repro_torch.kernels.fused_mlp import fused_swiglu, fused_swiglu_plain  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# K1 qmatmul
# ---------------------------------------------------------------------------

# (M, K, N, ea, eb range): ordinary exponents, e <= -48 and e >= 16
K1_CASES = [
    (5, 260, 36, -7, (-9, -3)),
    (12, 64, 40, -30, (-30, -18)),   # e = ea + eb <= -48: right shifts of 32+
    (6, 96, 32, 10, (6, 20)),        # e >= 16: left shifts that wrap or vanish
]


@pytest.mark.parametrize("case", K1_CASES)
@pytest.mark.parametrize("epilogue", ["int32", "q16", "float"])
def test_qmatmul_plain_matches_oracle_and_pallas(case, epilogue):
    M, K, N, ea, (lo, hi) = case
    rng = np.random.default_rng(M * 1000 + K)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    eb = rng.integers(lo, hi, (N,), dtype=np.int32)
    got = qmatmul_plain(_t(a), _t(b), torch.tensor(ea, dtype=torch.int32), _t(eb), epilogue).numpy()
    want = qmatmul_ref(a, b, np.int32(ea), eb, epilogue=epilogue)
    pallas = np.asarray(qmatmul_kernel_call(a, b, np.int32(ea), eb, bm=128, bn=128, bk=128,
                                            epilogue=epilogue, interpret=True))
    if epilogue == "float":
        np.testing.assert_array_equal(got, want)
        # XLA's f32 exp2 inside the Pallas kernel drifts by a few ulp at
        # exponents near -55; the oracle (and the port) scale exactly
        np.testing.assert_allclose(got, pallas, rtol=1e-6 if ea > -20 else 1e-5)
        return
    np.testing.assert_array_equal(got, pallas)
    if epilogue == "q16":
        # right shifts of 32 or more: the kernel (XLA) fills with the
        # sign, ref.py's int64 oracle rounds to 0 — a disagreement inside
        # the reference (ROADMAP.md queue 3); the port follows the kernel
        far = (np.int64(ea) + eb.astype(np.int64) + 16) <= -32
        np.testing.assert_array_equal(got[:, ~far], want[:, ~far])
        assert set(np.unique(got[:, far])) <= {-1, 0}
    else:
        np.testing.assert_array_equal(got, want)


def test_qmatmul_wrapper_routes_cpu_to_plain_and_checks_inputs():
    a = torch.randint(-128, 128, (3, 8), dtype=torch.int8)
    b = torch.randint(-128, 128, (8, 4), dtype=torch.int8)
    ea, eb = torch.tensor(-3, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    before = qmatmul.launches
    np.testing.assert_array_equal(qmatmul(a, b, ea, eb, "q16").numpy(),
                                  qmatmul_plain(a, b, ea, eb, "q16").numpy())
    assert qmatmul.launches == before  # the plain version is no launch
    with pytest.raises(TypeError):
        qmatmul(a.to(torch.int32), b, ea, eb)
    with pytest.raises(ValueError):
        qmatmul(a, b, ea, eb, "bogus")
    with pytest.raises(ValueError):
        qmatmul(a, b[:7], ea, eb)
    big = torch.zeros((1, (1 << 17) + 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="2\\*\\*17"):
        qmatmul(big, torch.zeros(((1 << 17) + 4, 4), dtype=torch.int8), ea, eb)


# ---------------------------------------------------------------------------
# K2 fused SwiGLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,ea", [((8, 128, 128), -7), ((5, 96, 44), -12)])
def test_fused_swiglu_plain_matches_reference(shape, ea):
    M, K, F = shape
    rng = np.random.default_rng(K + F)
    x = rng.integers(-128, 128, (M, K), dtype=np.int8)
    wg = rng.integers(-128, 128, (K, F), dtype=np.int8)
    wu = rng.integers(-128, 128, (K, F), dtype=np.int8)
    eg = rng.integers(-14, -2, (F,), dtype=np.int32)
    eu = rng.integers(-14, -2, (F,), dtype=np.int32)
    out, gate, sig = fused_swiglu_plain(_t(x), _t(wg), _t(wu), torch.tensor(ea, dtype=torch.int32),
                                        _t(eg), _t(eu), return_parts=True)
    j_out, j_gate, j_sig = fused_swiglu_parts(x, wg, wu, np.int32(ea), eg, eu)
    np.testing.assert_array_equal(gate.numpy(), np.asarray(j_gate))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(j_sig))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-30)
    r_out, r_gate, r_sig = fused_swiglu_ref(x, wg, wu, ea, eg, eu, return_parts=True)
    np.testing.assert_array_equal(gate.numpy(), r_gate)
    np.testing.assert_array_equal(sig.numpy(), r_sig)
    # three f32 roundings ((g*u) rounded, *sig rounded; the 2**e is exact)
    np.testing.assert_allclose(out.numpy(), r_out, rtol=3e-7, atol=1e-30)


def test_fused_swiglu_wrapper_routes_cpu_to_plain():
    x = torch.randint(-128, 128, (2, 8), dtype=torch.int8)
    w = torch.randint(-128, 128, (8, 4), dtype=torch.int8)
    e = torch.zeros(4, dtype=torch.int32)
    ea = torch.tensor(-6, dtype=torch.int32)
    before = fused_swiglu.launches
    np.testing.assert_array_equal(fused_swiglu(x, w, w, ea, e, e).numpy(),
                                  fused_swiglu_plain(x, w, w, ea, e, e).numpy())
    assert fused_swiglu.launches == before
    with pytest.raises(ValueError):
        fused_swiglu(x, w, w[:, :3], ea, e, e)


# ---------------------------------------------------------------------------
# K3 CORDIC sincos
# ---------------------------------------------------------------------------


def test_cordic_plain_matches_oracle_and_pallas():
    rng = np.random.default_rng(11)
    th = np.concatenate([
        np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**31 - 205887, 205887, -205887, 102944,
                  -102944, 411775], np.int64).astype(np.int32),
        rng.integers(-(2**31), 2**31, 3000, dtype=np.int64).astype(np.int32),
    ])
    s, c = cordic_sincos_plain(_t(th))
    rs, rc = cordic_sincos_ref(th)
    np.testing.assert_array_equal(s.numpy(), rs)
    np.testing.assert_array_equal(c.numpy(), rc)
    ps, pc = cordic_kernel_call(jnp.asarray(th), interpret=True)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ps))
    np.testing.assert_array_equal(c.numpy(), np.asarray(pc))


@pytest.mark.parametrize("rope_dim", [16, 128])
def test_rope_sincos_plain_matches_reference_tables(rope_dim):
    pos = np.arange(0, 1024, 7, dtype=np.int32)[None]
    hi, lo = jcordic.rope_inv_freq_q64(rope_dim)
    theta = jcordic.exact_rope_phase_q16(jnp.asarray(pos)[..., None], jnp.asarray(hi)[None],
                                         jnp.asarray(lo)[None])
    js, jc = jcordic.cordic_sincos_q16(theta)
    s, c = rope_sincos_plain(_t(pos), rope_dim)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    before = rope_sincos_q16.launches
    s2, _ = rope_sincos_q16(_t(pos), rope_dim)
    assert rope_sincos_q16.launches == before
    np.testing.assert_array_equal(s2.numpy(), s.numpy())


def test_cuda_header_constants_match_generators():
    """cordic.cuh carries the reference's generator outputs as literals."""
    src = (CSRC / "cordic.cuh").read_text()

    def array(name):
        body = re.search(name + r"\[HYPER_STAGES\] = \{([^}]*)\}", src).group(1)
        return [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]

    def const(name):
        return int(re.search(r"constexpr int32_t " + name + r" = (-?\d+);", src).group(1))

    sched = jcordic.hyperbolic_schedule(20)
    assert array("HYPER_SHIFT") == list(sched)
    assert array("ATANH_Q29") == [int(v) for v in jcordic.atanh_table(sched, 29)]
    assert const("K_H_INV_Q29") == jcordic.hyper_gain_inverse(sched, 29)
    assert const("LN2_Q16") == jcordic.LN2_Q16
    assert const("INV_LN2_Q16") == jcordic.INV_LN2_Q16
    assert const("EXP_SAT_HI_Q16") == jcordic.EXP_SAT_HI_Q16
    assert const("EXP_FLUSH_LO_Q16") == jcordic.EXP_FLUSH_LO_Q16


def _switch(src, func):
    """{case: literal} and the default's shift base of the constexpr table
    function ``func`` (one ``switch``) in a CUDA source."""
    body = src[src.index(func + "("):]
    body = body[: body.index("default:") + 80]
    cases = {int(i): int(v) for i, v in re.findall(r"case (\d+): return (\d+);", body)}
    base = int(re.search(r"default: return int32_t\{1\} << \((\d+) - i\)", body).group(1))
    return cases, base


def test_cuda_compiled_schedules_match_generators():
    """The schedules K5, K3 and K6 compile in (cordic.cuh) against the
    reference's generators: K5's shifts, atanh entries and gains at 20
    and 13 stages, the atan tables of K3 and K6 at (16, 16) and (24, 24)
    with their pi, and K7's Horner quotient at 17 steps."""
    hdr = (CSRC / "cordic.cuh").read_text()
    m = re.search(r"hyper_shift_at\(int j\) \{ return j < (\d+) \? j \+ 1 : \(j < (\d+) \? j : "
                  r"j - 1\); \}", hdr)
    first, second = int(m.group(1)), int(m.group(2))
    for stages in (20, 13):
        sched = jcordic.hyperbolic_schedule(stages)
        assert [j + 1 if j < first else (j if j < second else j - 1) for j in range(stages)] == \
            list(sched)
    cases, base = _switch(hdr, "atanh_q29_at")
    shifts = tuple(range(1, 30))
    want = [int(v) for v in jcordic.atanh_table(shifts, 29)]
    assert [cases.get(i, 1 << (base - i)) for i in shifts] == want
    k13 = int(re.search(r"constexpr int32_t K_H_INV13_Q29 = (\d+);", hdr).group(1))
    assert k13 == jcordic.hyper_gain_inverse(jcordic.hyperbolic_schedule(13), 29)

    body = hdr[hdr.index("atan_at(int frac, int i)"):]
    f16, f24 = body.split("if (frac == 16)", 1)[1].split("switch (i)")[1:3]
    for frac, text in ((16, f16), (24, f24)):
        cases, base = _switch("f(" + text, "f")
        assert base == frac
        assert [cases.get(i, 1 << (frac - i)) for i in range(frac)] == \
            [int(v) for v in jcordic.atan_table(frac, frac)]
    m = re.search(r"pi_at\(int frac\) \{ return frac == 16 \? (\d+) : (\d+); \}", hdr)
    assert (int(m.group(1)), int(m.group(2))) == (jcordic.angle_consts(16)[0],
                                                  jcordic.angle_consts(24)[0])
    # K3 and K6 step with that table; K6 and K7 compile the reference's
    # default counts (universal.py: atan2 16 at frac 16, ITER_Q24 at 24,
    # div 17)
    assert "rq::atan_at(FRAC, i)" in (CSRC / "cordic.cu").read_text()
    uni = (CSRC / "universal.cu").read_text()
    assert "rq::atan_at(FRAC, i)" in uni and "compiled_atan<16>" in uni
    assert "compiled_atan<24>" in uni and jcordic.ITER_Q24 == 24
    assert int(re.search(r"constexpr int DIV_STEPS = (\d+);", uni).group(1)) == 17


def test_cordic_wrapper_rejects_wrong_dtype():
    with pytest.raises(TypeError):
        cordic_sincos(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        rope_sincos_q16(torch.zeros(4, dtype=torch.int64), 16)


# ---------------------------------------------------------------------------
# K4 flash attention
# ---------------------------------------------------------------------------

# (B, S, H, KV, D, Dv, causal, window, dtype)
K4_CASES = [
    (1, 64, 4, 4, 32, 32, True, None, "float32"),
    (2, 40, 4, 2, 16, 16, True, None, "float32"),      # GQA
    (1, 70, 2, 1, 32, 16, True, None, "bfloat16"),     # GQA, Dv != D
    (1, 33, 2, 2, 16, 16, False, None, "float32"),     # non-causal, ragged Skv
    (1, 48, 2, 2, 16, 16, True, 8, "float32"),         # sliding window
    (1, 1100, 2, 1, 16, 16, True, None, "float32"),    # two 1024-key chunks
]


def _rand_qkv(case, seed=0):
    B, S, H, KV, D, Dv, causal, window, dt = case
    rng = np.random.default_rng(seed + S)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, Dv)).astype(np.float32)
    if dt == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("case", K4_CASES)
def test_flash_plain_matches_chunked_attention(case):
    B, S, H, KV, D, Dv, causal, window, dt = case
    q, k, v = _rand_qkv(case)
    tol = 2e-3 if dt == "float32" else 2e-2
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else (jnp.bfloat16, torch.bfloat16)
    got = flash_attention_plain(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), causal=causal,
                                window=window).to(torch.float32).numpy()
    want = np.asarray(chunked_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        q_positions=jnp.broadcast_to(jnp.arange(S)[None], (B, S)), causal=causal, window=window,
    ), np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    # the numpy oracle (GQA by repetition, heads folded)
    G = H // KV
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(B * x.shape[2], S, -1)  # noqa: E731
    ref = attention_ref(fold(q), fold(np.repeat(k, G, axis=2)), fold(np.repeat(v, G, axis=2)),
                        scale=1.0 / math.sqrt(D), causal=causal, window=window)
    ref = ref.reshape(B, H, S, Dv).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", [K4_CASES[0], K4_CASES[1]])
def test_flash_plain_matches_pallas_kernel(case):
    B, S, H, KV, D, Dv, causal, window, dt = case
    q, k, v = _rand_qkv(case, seed=1)
    G = H // KV
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(B * x.shape[2], S, -1)  # noqa: E731
    want = np.asarray(flash_attention_call(
        fold(q), fold(np.repeat(k, G, axis=2)), fold(np.repeat(v, G, axis=2)),
        scale=1.0 / math.sqrt(D), causal=causal, bq=64, bk=128, interpret=True))
    want = want.reshape(B, H, S, Dv).transpose(0, 2, 1, 3)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


def test_flash_noncausal_ragged_is_not_forced_causal():
    """The reference kernel pads a ragged non-causal call into causal
    masking (flashattn.py:114-120); the port masks padded keys only."""
    case = (1, 37, 2, 2, 16, 16, False, None, "float32")
    q, k, v = _rand_qkv(case, seed=2)
    got = flash_attention(_t(q), _t(k), _t(v), causal=False).numpy()
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(2, 37, 16)  # noqa: E731
    ref = attention_ref(fold(q), fold(k), fold(v), scale=0.25, causal=False)
    np.testing.assert_allclose(got, ref.reshape(1, 2, 37, 16).transpose(0, 2, 1, 3),
                               atol=2e-3, rtol=2e-3)


def test_key_tile_matches_the_kernel():
    """KEY_TILE is the bf16 kernel's key tile per head-width class
    (flashattn.cu: TcTile)."""
    src = (CSRC / "flashattn.cu").read_text()
    small, big = re.search(r"BKV = WD <= 128 \? (\d+) : (\d+);", src).groups()
    assert KEY_TILE == {128: int(small), 256: int(big)}


def _f32_plans():
    """The f32 kernel's tile plans as the source instantiates them
    (flashattn.cu: ``F32Plan<WD, R, RL, BKV, PK, NS>``), each field
    evaluated from the source: {(WD, R, RL, BKV, PK, NS): {name: value}}."""
    src = (CSRC / "flashattn.cu").read_text()
    body = re.search(r"struct F32Plan \{(.*?)\n\};", src, re.S).group(1)
    fields = re.findall(r"static constexpr int (\w+) = ([^;]+);", body)
    plans = {}
    for args in set(re.findall(r"F32Plan<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>", src)):
        env = dict(zip(("WD_", "R_", "RL_", "BKV_", "PK_", "NS_"), map(int, args)))
        for name, expr in fields:
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))
        plans[tuple(map(int, args))] = env
    return plans


F32_PLANS = [(128, 16, 8, 128, 32, 1), (128, 8, 8, 128, 32, 1), (256, 8, 4, 128, 32, 2)]


@pytest.mark.parametrize("plan", F32_PLANS)
def test_f32_tile_plan_fits_and_owns_every_element_once(plan):
    """The f32 kernel's shared memory fits a block's 232,448 bytes; its
    thread -> (query, key) map of S and thread -> (query, column) map of
    O cover a block's tiles exactly once, each warp within its own rows;
    every piece of a warp's P^T is written exactly once; a panel holds a
    d-slice of K^T and a key slice of V, and the slices, pieces and
    per-lane chunks tile the head width and the key tile; the d-major
    tiles' padded rows take the transposing stores (8 lanes along d, 4
    along rows) on 32 distinct banks, and every 128-bit access is 16-byte
    aligned."""
    plans = _f32_plans()
    assert sorted(plans) == sorted(F32_PLANS)
    p = plans[plan]
    assert (p["WD"], p["R"], p["RL"], p["BKV"], p["PK"], p["NS"]) == plan
    assert p["SMEM"] <= 232_448
    assert p["SMEM"] == 4 * (p["WD"] * p["QS"] + 2 * p["PANEL"] + p["NW"] * p["PK"] * p["PR"])
    R, RL, LKG, BQ, BKV, PK, WD, NS = (p[k] for k in ("R", "RL", "LKG", "BQ", "BKV", "PK", "WD",
                                                       "NS"))
    assert p["PANEL"] >= max(p["DS"] * p["KS"], BKV // NS * WD)
    assert p["DS"] * NS == WD and p["DS"] % 8 == 0 and (BKV // NS) % PK == 0
    assert p["LRG"] * LKG == 32 and p["KC"] >= 1 and p["CC"] >= 1 and BKV % PK == 0
    assert 4 * LKG * p["KC"] == BKV and 4 * LKG * p["CC"] == WD
    warp, lane, r, c, e = np.ix_(np.arange(p["NW"]), np.arange(32), np.arange(RL),
                                 np.arange(max(p["KC"], p["CC"])), np.arange(4))
    ry, kx = lane // LKG, lane % LKG
    shape = np.broadcast_shapes(warp.shape, lane.shape, r.shape, c.shape, e.shape)
    rows = np.broadcast_to(warp * R + RL * ry + r, shape)
    cols = np.broadcast_to(4 * LKG * c + 4 * kx + e, shape)
    for n_chunks, width in ((p["KC"], BKV), (p["CC"], WD)):
        own = np.zeros((BQ, width), dtype=int)
        np.add.at(own, (rows[:, :, :, :n_chunks], cols[:, :, :, :n_chunks]), 1)
        assert (own == 1).all()
    assert ((rows // R) == warp).all()
    keys, local = cols[:, :, :, :p["KC"]], rows[:, :, :, :p["KC"]] % R
    for pc in range(BKV // PK):
        mine = (keys >= pc * PK) & (keys < (pc + 1) * PK)
        for w in range(p["NW"]):
            piece = np.zeros((PK, R), dtype=int)
            np.add.at(piece, (keys[w][mine[w]] - pc * PK, local[w][mine[w]]), 1)
            assert (piece == 1).all()
    for stride in (p["QS"], p["KS"], p["PR"], WD):
        assert stride % 4 == 0
    lane = np.arange(32)
    for stride in (p["QS"], p["KS"]):
        assert len(set((((lane % 8) * stride + lane // 8) % 32).tolist())) == 32


@pytest.mark.parametrize("width_class", sorted(KEY_TILE))
def test_bf16_tolerance_holds_at_the_kernel_key_tile(width_class):
    """The bf16 kernel rounds p against the running max of its key tiles;
    the plain version at that chunk stays within bf16_close of its
    1024-key chunks (seeded draws: causal, a sliding window, a softcap;
    and p_rounding_case).  Small heads: the tile, not the width, sets the
    rounding points."""
    chunk = KEY_TILE[width_class]
    rng = np.random.default_rng(width_class)
    for draw in range(4):
        sc = 1.0 + draw
        q, k, v = (_t(sc * rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
                   for shape in ((1, 200, 2, 32), (1, 200, 1, 32), (1, 200, 1, 32)))
        for kw in ({}, {"window": 48}, {"softcap": 5.0}):
            got = flash_attention_plain(q, k, v, chunk=chunk, **kw).float()
            assert bf16_close(got, flash_attention_plain(q, k, v, **kw).float()), (draw, kw)
    q, k, v = p_rounding_case()
    got = flash_attention_plain(q, k, v, causal=False, chunk=chunk).float()
    assert bf16_close(got, flash_attention_plain(q, k, v, causal=False).float())


def test_flash_wrapper_checks_inputs():
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))
    with pytest.raises(TypeError):
        flash_attention(q, q.double(), q)
