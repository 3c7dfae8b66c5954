"""Each CUDA kernel of the port against its plain PyTorch version, on
the card.  Imports no JAX, so it runs on the H100 machine as is::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs the card (marker ``cuda``) and skips without one.
Tolerances: integer outputs bit-exact (K1, K2's gate and sigmoid, K3,
K5-K7), and K6's and K7's float entries bit-exact (their bits) against
the to_fixed -> kernel -> from_fixed chain on the card; K2's f32 product at rtol 1e-6 (one multiply order, each rounded
once); attention at 2e-3 (f32) and, in bf16, 2**-6 of each element's
magnitude plus its output row's rms (``kernels.flashattn.bf16_close``:
the kernel's 64-key (D <= 128) or 32-key (D = 256) tiles round p
against other running maxima than the plain version's 1024-key chunks, and the output is rounded to bf16 once
more).  ``kernels.flashattn.p_rounding_case`` fails that tolerance
unless p is rounded to v's dtype before P.V (tests/test_torch_universal.py
checks that the case discriminates, on the CPU)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cordic import (  # noqa: E402
    FLOAT_EDGES,
    UNARY_OPS,
    atan2_24_f32,
    atan2_24_f32_plain,
    atan2_f32,
    atan2_f32_plain,
    atan2_q16,
    atan2_q16_plain,
    cordic_sincos,
    cordic_sincos_plain,
    div_f32,
    div_f32_plain,
    div_q16,
    div_q16_plain,
    rope_sincos_plain,
    rope_sincos_q16,
    universal_unary,
    universal_unary_plain,
)
from repro_torch.kernels.flashattn import (  # noqa: E402
    bf16_close,
    flash_attention,
    flash_attention_plain,
    p_rounding_case,
)
from repro_torch.kernels.fused_mlp import fused_swiglu, fused_swiglu_plain  # noqa: E402
from repro_torch.kernels.linalg import qmatmul_deferred, qmatmul_deferred_plain  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain  # noqa: E402

# (B, S, H, KV, D, Dv, causal, window, dtype)
K4_CASES = [
    (1, 64, 4, 4, 32, 32, True, None, torch.float32),
    (2, 40, 4, 2, 16, 16, True, None, torch.float32),     # GQA
    (1, 70, 2, 1, 32, 16, True, None, torch.bfloat16),    # GQA, Dv != D
    (1, 33, 2, 2, 16, 16, False, None, torch.float32),    # non-causal, ragged Skv
    (1, 48, 2, 2, 16, 16, True, 8, torch.float32),        # sliding window
    (1, 300, 32, 32, 128, 128, True, None, torch.bfloat16),  # deepseek-7b heads
    (1, 130, 32, 8, 128, 128, True, None, torch.float32),
    (1, 77, 4, 2, 36, 20, True, None, torch.bfloat16),    # widths off the 16-byte loads
]
# gemma2-2b heads: (B, S, H, KV, D, window, softcap, dtype)
K4_GEMMA_CASES = [
    (1, 200, 8, 4, 256, None, 50.0, torch.float32),
    (1, 200, 8, 4, 256, 64, 50.0, torch.bfloat16),
    (1, 150, 4, 2, 256, 100, None, torch.float32),
    (2, 90, 4, 4, 192, None, 5.0, torch.bfloat16),
]
EDGES = [0, 1, -1, 2, -2, 3, 65535, 65536, 65537, -65536, 32768, 2**31 - 1, -(2**31),
         -(2**31) + 1, 2**31 - 2, 123456789, -123456789, 681391, -772244, 2**30, -(2**30)]


def _words(n, device, seed=0):
    """int32 words: the edges, tiny values, the whole int32 range and
    the Q16.16 region most callers use."""
    g = torch.Generator().manual_seed(seed)
    return torch.cat([
        torch.tensor(EDGES, dtype=torch.int32), torch.arange(-40, 40, dtype=torch.int32),
        torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, dtype=torch.int32),
        torch.randint(-40 * 65536, 40 * 65536, (n,), generator=g, dtype=torch.int32),
    ]).to(device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# (M, K, N): small ragged shapes, then gemma2-2b's projections wq, wk/wv,
# wo and w_down at decode and prefill sizes
QMATMUL_SHAPES = [(m, 260, 132) for m in (1, 5, 70)] + [
    (m, k, n) for m in (1, 4, 600) for (k, n) in ((2304, 2048), (2304, 1024), (2048, 2304),
                                                   (9216, 2304))]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", QMATMUL_SHAPES)
@pytest.mark.parametrize("epilogue", ["float", "q16", "int32"])
def test_cuda_qmatmul_matches_plain(cuda, M, K, N, epilogue):
    g = torch.Generator().manual_seed(M)
    a = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8).to(cuda)
    b = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8).to(cuda)
    ea = torch.tensor([-20], dtype=torch.int32, device=cuda)
    eb = torch.randint(-40, 30, (N,), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(qmatmul(a, b, ea, eb, epilogue), qmatmul_plain(a, b, ea, eb, epilogue))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,F", [(1, 256, 100), (40, 256, 100), (1, 2304, 9216),
                                   (600, 2304, 9216), (9, 2304, 9216), (480, 4096, 11008),
                                   (4500, 2304, 9216)])
def test_cuda_fused_swiglu_matches_plain(cuda, M, K, F):
    g = torch.Generator().manual_seed(M)
    x = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8).to(cuda)
    wg = torch.randint(-128, 128, (K, F), generator=g, dtype=torch.int8).to(cuda)
    wu = torch.randint(-128, 128, (K, F), generator=g, dtype=torch.int8).to(cuda)
    ea = torch.tensor([-6], dtype=torch.int32, device=cuda)
    e = torch.randint(-14, -2, (F,), generator=g, dtype=torch.int32).to(cuda)
    out, gate, sig = fused_swiglu(x, wg, wu, ea, e, e, return_parts=True)
    w_out, w_gate, w_sig = fused_swiglu_plain(x, wg, wu, ea, e, e, return_parts=True)
    assert torch.equal(gate, w_gate) and torch.equal(sig, w_sig)
    torch.testing.assert_close(out, w_out, rtol=1e-6, atol=0)


# the edges of the tensor-core tiles (64 or 128 rows, 128 / 64 columns,
# 64-deep k steps, skinny below 9 rows) and a ragged K, N that takes the
# 4-byte copies (neither a multiple of 16)
QMATMUL_TILE_EDGES = [(m, 2304, 2048) for m in (9, 16, 17, 65, 127, 129, 480, 4500)] + [
    (m, 4100, 2052) for m in (9, 129, 480)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", QMATMUL_TILE_EDGES)
@pytest.mark.parametrize("epilogue", ["float", "q16", "int32"])
def test_cuda_qmatmul_tile_edges_match_plain(cuda, M, K, N, epilogue):
    g = torch.Generator().manual_seed(M + K)
    a = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8).to(cuda)
    b = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8).to(cuda)
    ea = torch.tensor([-20], dtype=torch.int32, device=cuda)
    eb = torch.randint(-40, 30, (N,), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(qmatmul(a, b, ea, eb, epilogue), qmatmul_plain(a, b, ea, eb, epilogue))


@pytest.mark.cuda
def test_cuda_cordic_matches_plain(cuda):
    th = torch.randint(-(2**31), 2**31 - 1, (5000,), dtype=torch.int32).to(cuda)
    for got, want in zip(cordic_sincos(th), cordic_sincos_plain(th)):
        assert torch.equal(got, want)
    pos = torch.arange(300, dtype=torch.int32, device=cuda)[None]
    for got, want in zip(rope_sincos_q16(pos, 128), rope_sincos_plain(pos, 128)):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES)
def test_cuda_flash_matches_plain(cuda, case):
    B, S, H, KV, D, Dv, causal, window, dt = case
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dt)
               for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, Dv)))
    got = flash_attention(q, k, v, causal=causal, window=window).float()
    want = flash_attention_plain(q, k, v, causal=causal, window=window).float()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    else:
        assert bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_GEMMA_CASES)
def test_cuda_flash_gemma2_heads_match_plain(cuda, case):
    B, S, H, KV, D, window, cap, dt = case
    g = torch.Generator().manual_seed(S + D)
    q, k, v = (3 * torch.randn(shape, generator=g).to(cuda, dt)
               for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    got = flash_attention(q, k, v, causal=True, window=window, softcap=cap).float()
    want = flash_attention_plain(q, k, v, causal=True, window=window, softcap=cap).float()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    else:
        assert bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [17, 63, 65, 129, 1000])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_cuda_flash_bf16_tile_edges_match_plain(cuda, S, D):
    """The bf16 kernel's 128-query blocks (64 at D = 256 on small grids)
    and 64-key (D <= 128) or 32-key (D = 256) tiles at and around their
    edges, 32 heads over 8 kv heads."""
    g = torch.Generator().manual_seed(S * D)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
               for shape in ((1, S, 32, D), (1, S, 8, D), (1, S, 8, D)))
    got = flash_attention(q, k, v).float()
    assert bf16_close(got, flash_attention_plain(q, k, v).float())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [17, 63, 65, 129, 1000])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_cuda_flash_f32_tile_edges_match_plain(cuda, S, D):
    """The f32 kernel's 64- or 128-query blocks (8 or 16 rows a warp) and
    128-key tiles at and around their edges, 32 heads over 8."""
    g = torch.Generator().manual_seed(S * D + 1)
    q, k, v = (torch.randn(shape, generator=g).to(cuda)
               for shape in ((1, S, 32, D), (1, S, 8, D), (1, S, 8, D)))
    got = flash_attention(q, k, v)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v), atol=2e-3, rtol=2e-3)


# (S, Skv, D, Dv, causal, window, softcap), 32 heads over 8
K4_F32_EDGES = [
    (2000, 2000, 128, 128, True, None, None),   # 128-query blocks fill the card
    (77, 77, 36, 20, True, None, None),         # off the bf16 kernel's 16-byte loads
    (77, 77, 37, 22, True, None, None),         # off the f32 kernel's: 4-byte copies
    (70, 130, 128, 128, False, None, None),     # non-causal, ragged Skv > S
    (1000, 1000, 128, 128, True, 130, None),    # window past whole tiles
    (1000, 1000, 256, 256, True, 130, 50.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_F32_EDGES)
def test_cuda_flash_f32_edges_match_plain(cuda, case):
    S, Skv, D, Dv, causal, window, cap = case
    g = torch.Generator().manual_seed(S + Skv + D)
    q, k, v = (torch.randn(shape, generator=g).to(cuda)
               for shape in ((1, S, 32, D), (1, Skv, 8, D), (1, Skv, 8, Dv)))
    kw = dict(causal=causal, window=window, softcap=cap)
    got = flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, **kw), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_flash_window_past_whole_tiles(cuda, dt):
    """gemma2-2b's local layer at 4500 tokens: softcap 50, window 4096,
    so whole key tiles fall out of the window of every query block."""
    g = torch.Generator().manual_seed(4500)
    q, k, v = (2 * torch.randn(shape, generator=g).to(cuda, dt)
               for shape in ((1, 4500, 8, 256), (1, 4500, 4, 256), (1, 4500, 4, 256)))
    got = flash_attention(q, k, v, window=4096, softcap=50.0).float()
    want = flash_attention_plain(q, k, v, window=4096, softcap=50.0).float()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    else:
        assert bf16_close(got, want)


@pytest.mark.cuda
def test_cuda_flash_rounds_p_before_pv(cuda):
    q, k, v = p_rounding_case(cuda)
    got = flash_attention(q, k, v, causal=False).float()
    assert bf16_close(got, flash_attention_plain(q, k, v, causal=False).float())


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(UNARY_OPS))
@pytest.mark.parametrize("stages", [20, 13])
def test_cuda_universal_unary_matches_plain(cuda, op, stages):
    w = _words(20000, cuda, seed=stages)
    assert torch.equal(universal_unary(w, op, stages), universal_unary_plain(w, op, stages))


@pytest.mark.cuda
@pytest.mark.parametrize("frac_bits", [16, 24])
def test_cuda_atan2_matches_plain(cuda, frac_bits):
    x = _words(20000, cuda, seed=frac_bits)
    y = torch.roll(x, 7)
    z = torch.zeros_like(x)
    for a, b in ((y, x), (x, z), (z, x), (z, z)):
        got = atan2_q16(a, b, iterations=frac_bits, frac_bits=frac_bits)
        assert torch.equal(got, atan2_q16_plain(a, b, frac_bits, frac_bits))


@pytest.mark.cuda
def test_cuda_div_matches_plain(cuda):
    num = _words(20000, cuda, seed=3)
    den = torch.roll(num, 5)
    z = torch.zeros_like(num)
    for a, b in ((num, den), (num, z), (z, num), (z, z)):
        assert torch.equal(div_q16(a, b), div_q16_plain(a, b))


# K6 and K7: V = 4 pairs a thread by 16-byte loads; the engine's counts
# (atan2 16 at frac 16 and 24 at frac 24, div 17) run compiled, others
# per element.  Ragged lengths, a view off the 16-byte alignment and the
# edge grid of chip_smoke.py (every pair of the edge words and -40..40).
PAIR_SIZES = [1, 3, 4, 5, 1023, 4097]


def _edge_grid(device):
    e = torch.tensor(EDGES + list(range(-40, 41)), dtype=torch.int32, device=device)
    return tuple(t.reshape(-1).contiguous() for t in torch.meshgrid(e, e, indexing="ij"))


def _pair_inputs(device, seed):
    """(y, x) cases: the edge grid, random words at each ragged length,
    and a view off the 16-byte alignment."""
    ey, ex = _edge_grid(device)
    g = torch.Generator().manual_seed(seed)
    cases = [(ey, ex)]
    for n in PAIR_SIZES:
        w = _words(n, "cpu", seed=seed + n)[: 2 * n + 5]
        cases.append((torch.roll(w, 3).to(device), w.to(device)))
    w = torch.randint(-(2**31), 2**31 - 1, (8194,), generator=g, dtype=torch.int32).to(device)
    cases.append((w[1:4097], w[4098:]))   # 4 and 8 bytes off the 16-byte alignment
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,frac_bits", [(16, 16), (24, 24), (7, 16), (32, 16),
                                                  (7, 24), (32, 24), (16, 24)])
def test_cuda_atan2_schedules_match_plain(cuda, iterations, frac_bits):
    for y, x in _pair_inputs(cuda, iterations + frac_bits):
        got = atan2_q16(y, x, iterations, frac_bits)
        assert torch.equal(got, atan2_q16_plain(y, x, iterations, frac_bits)), y.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [17, 9, 32])
def test_cuda_div_schedules_match_plain(cuda, iterations):
    for num, den in _pair_inputs(cuda, iterations):
        assert torch.equal(div_q16(num, den, iterations), div_q16_plain(num, den, iterations))


def _float_cases(device, seed):
    """f32 (y, x) cases: the float edges paired every way (NaN, +-inf,
    +-0, subnormals, halves of the Q16.16 and Q8.24 grids, +-32768 and
    their neighbours, the f32 extremes), seeded floats over the Q16.16
    range and beyond at ragged lengths, and a misaligned view."""
    import numpy as np

    e = torch.tensor(np.array(FLOAT_EDGES, dtype=np.float32))
    ey, ex = (t.reshape(-1).contiguous() for t in torch.meshgrid(e, e, indexing="ij"))
    cases = [(ey.to(device), ex.to(device))]
    rng = np.random.default_rng(seed)
    for n in PAIR_SIZES + [70001]:
        f = np.concatenate([rng.uniform(-300, 300, n), rng.uniform(-40000, 40000, n),
                            rng.standard_normal(n) * 1e-4]).astype(np.float32)
        f[::7] = (np.round(f[::7] * 65536) + 0.5) / 65536       # exact halves
        t = torch.from_numpy(f).to(device)
        cases.append((torch.roll(t, 5), t))
    cases.append((cases[-1][0][1:], cases[-1][1][1:]))
    return cases


FLOAT_ENTRIES = [("atan2_f32", atan2_f32, atan2_f32_plain, it) for it in (16, 7, 32)]
FLOAT_ENTRIES += [("atan2_24_f32", atan2_24_f32, atan2_24_f32_plain, it) for it in (24, 7, 16, 32)]
FLOAT_ENTRIES += [("div_f32", div_f32, div_f32_plain, it) for it in (17, 9, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,fn,plain,iterations", FLOAT_ENTRIES,
                         ids=[f"{n}-{i}" for n, _, _, i in FLOAT_ENTRIES])
def test_cuda_float_entries_match_chain(cuda, name, fn, plain, iterations):
    """The float entries against the composed chain on the card, bit for
    bit (-0.0 is not 0.0), with one launch each."""
    for y, x in _float_cases(cuda, iterations):
        before = fn.launches
        got = fn(y, x, iterations)
        assert fn.launches == before + 1
        want = plain(y, x, iterations)
        assert got.dtype == torch.float32 and got.shape == y.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (name, y.numel())


# K5's tiles: a block takes 2048 words, queues its live elements per path
# and skips the queues when one path takes the whole tile; 20 and 13
# stages run compiled-in schedules, any other count the generic kernel
K5_TILE = 2048
K5_SIZES = [1, 3, 4097, K5_TILE + 1]


def _k5_inputs(op, kind, n, g):
    """``n`` words of one kind: every element live (one path, or tanh's
    and sigmoid's near and far paths mixed), every element an early exit,
    or the whole int32 range mixed with the live region."""
    u = 65536
    live = {"sqrt": (1, 2**31 - 1), "log": (1, 2**31 - 1), "exp": (-772243, 681390),
            "tanh": (-4 * u, 4 * u), "sigmoid": (-8 * u, 8 * u)}[op]
    dead = {"sqrt": (-(2**31), 1), "log": (-(2**31), 1), "exp": (681391, 2**31 - 1),
            "tanh": (386122, 2**31 - 1), "sigmoid": (2 * 386122, 2**31 - 1)}[op]
    if kind == "near":     # tanh / sigmoid: |t| <= 1 only
        live = (-u, u + 1) if op == "tanh" else (-2 * u, 2 * u + 1)
    lo, hi = {"live": live, "near": live, "dead": dead}.get(kind, (-(2**31), 2**31 - 1))
    w = torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32)
    if kind == "mixed":
        w[::2] = torch.randint(-40 * u, 40 * u, ((n + 1) // 2,), generator=g, dtype=torch.int32)
    return w


# (op, kind): "near" only where an op has two live paths
K5_TILE_CASES = [(op, kind) for op in sorted(UNARY_OPS) for kind in ("live", "dead", "mixed")]
K5_TILE_CASES += [(op, "near") for op in ("sigmoid", "tanh")]


@pytest.mark.cuda
@pytest.mark.parametrize("op,kind", K5_TILE_CASES)
@pytest.mark.parametrize("stages", [20, 13, 7, 64])
def test_cuda_universal_unary_tiles_match_plain(cuda, op, kind, stages):
    g = torch.Generator().manual_seed(stages * 7 + len(kind))
    for n in K5_SIZES + [3 * K5_TILE]:
        w = _k5_inputs(op, kind, n, g).to(cuda)
        assert torch.equal(universal_unary(w, op, stages), universal_unary_plain(w, op, stages)), n
    # a view off the 16-byte alignment takes the scalar loads
    w = _k5_inputs(op, kind, 2 * K5_TILE + 1, g).to(cuda)[1:]
    assert torch.equal(universal_unary(w, op, stages), universal_unary_plain(w, op, stages))
    e = torch.tensor(EDGES, dtype=torch.int32, device=cuda)
    assert torch.equal(universal_unary(e, op, stages), universal_unary_plain(e, op, stages))


# K3: the edge angles of chip_smoke.py, +-pi, +-pi/2 and the theta + pi
# wrap near INT32_MAX, in Q16.16 and Q8.24
def _k3_edges(frac_bits):
    from repro_torch.core.cordic import angle_consts

    pi, half_pi, two_pi = angle_consts(frac_bits)
    e = [0, 1, -1, 2**31 - 1, -(2**31), 2**31 - pi, -(2**31) + pi, 2**31 - pi - 1,
         2**31 - pi + 1, 2**30, -(2**30), pi, -pi, pi - 1, -pi + 1, half_pi, -half_pi,
         half_pi + 1, -half_pi - 1, two_pi, -two_pi, two_pi + pi, 3 * two_pi - 1]
    e += [k * two_pi + d for k in (-3, -1, 1, 2) for d in (-pi - 1, -pi, -pi + 1, pi - 1, pi)]
    return [v for v in e if -(2**31) <= v < 2**31]


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,frac_bits", [(16, 16), (24, 24), (16, 24), (7, 16),
                                                  (32, 16), (20, 24)])
def test_cuda_cordic_elementwise_matches_plain(cuda, iterations, frac_bits):
    g = torch.Generator().manual_seed(iterations + frac_bits)
    edges = torch.tensor(_k3_edges(frac_bits), dtype=torch.int32)
    for n in (1, 3, 4, 4097, 70001):
        th = torch.cat([edges, torch.randint(-(2**31), 2**31 - 1, (n,), generator=g,
                                             dtype=torch.int32)]).to(cuda)
        for t in (th, th[1:]):   # 16-byte vectors, and a view off them
            got = cordic_sincos(t, iterations, frac_bits)
            want = cordic_sincos_plain(t, iterations, frac_bits)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (n, t.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("rope_dim", [64, 128, 256, 20])
@pytest.mark.parametrize("shape", [(1,), (7,), (300,), (4500,), (3, 5), (4, 1), (2, 300)])
def test_cuda_rope_tables_match_plain(cuda, rope_dim, shape):
    g = torch.Generator().manual_seed(rope_dim + sum(shape))
    n = 1
    for d in shape:
        n *= d
    # positions from 0, then arbitrary ones up to the uint32 range
    for pos in (torch.arange(n, dtype=torch.int32).reshape(shape),
                torch.randint(-(2**31), 2**31 - 1, shape, generator=g, dtype=torch.int32)):
        pos = pos.to(cuda)
        got = rope_sincos_q16(pos, rope_dim)
        want = rope_sincos_plain(pos, rope_dim)
        assert got[0].shape == shape + (rope_dim // 2,)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# the deferred-correction matmul (C3): M, K, N at and across the kernel's
# 64 x 64 output blocks and 16-deep k steps, tile_k from 1 to K (ragged
# last tiles), both roundings, saturating and wrapping combines; any
# int32 words (tile sums wrap mod 2**64) and Q16.16 operands near
# +-32767.0 whose tiles saturate; bit-exact
DEFERRED_DIMS = (1, 17, 33, 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("M", DEFERRED_DIMS)
@pytest.mark.parametrize("K", DEFERRED_DIMS)
@pytest.mark.parametrize("N", DEFERRED_DIMS)
def test_cuda_qmatmul_deferred_edges_match_plain(cuda, M, K, N):
    g = torch.Generator().manual_seed(M * 7 + K * 3 + N)
    a = torch.randint(-(2**31), 2**31 - 1, (M, K), generator=g, dtype=torch.int32).to(cuda)
    b = torch.randint(-(2**31), 2**31 - 1, (K, N), generator=g, dtype=torch.int32).to(cuda)
    for tile_k in sorted({1, 7, 32, 40, K}):
        for rounding in (True, False):
            for saturate in (True, False):
                kw = dict(tile_k=tile_k, rounding=rounding, saturate=saturate)
                assert torch.equal(qmatmul_deferred(a, b, **kw),
                                   qmatmul_deferred_plain(a, b, **kw)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("tile_k", [1, 2, 32])
@pytest.mark.parametrize("frac_bits", [16, 1, 31])
def test_cuda_qmatmul_deferred_saturating_operands_match_plain(cuda, tile_k, frac_bits):
    g = torch.Generator().manual_seed(tile_k + frac_bits)
    a = torch.randint(32760 * 65536, 2**31 - 1, (130, 96), generator=g, dtype=torch.int32)
    a = a * (torch.randint(0, 2, a.shape, generator=g, dtype=torch.int32) * 2 - 1)
    b = torch.randint(-65536, 65537, (96, 70), generator=g, dtype=torch.int32)
    a, b = a.to(cuda), b.to(cuda)
    outs = {}
    for saturate in (True, False):
        kw = dict(tile_k=tile_k, frac_bits=frac_bits, saturate=saturate)
        outs[saturate] = qmatmul_deferred(a, b, **kw)
        assert torch.equal(outs[saturate], qmatmul_deferred_plain(a, b, **kw)), kw
    if frac_bits == 16 and tile_k == 1:   # the saturating combine saturated
        assert int((outs[True].abs() == 2**31 - 1).sum()) > 0


@pytest.mark.cuda
def test_cuda_engine_matmul_launches_the_kernel_once(cuda):
    from repro_torch.core import MathEngine, to_fixed

    g = torch.Generator().manual_seed(0)
    a = to_fixed(torch.rand(300, 200, generator=g) * 2 - 1).to(cuda)
    b = to_fixed(torch.rand(200, 100, generator=g) * 2 - 1).to(cuda)
    eng = MathEngine("q16_16")
    before = qmatmul_deferred.launches
    got = eng.call("matmul", a, b)
    assert qmatmul_deferred.launches == before + 1
    assert torch.equal(got, qmatmul_deferred_plain(a, b))


# ---------------------------------------------------------------------------
# the paged pool and the speculative draft's rollback on CUDA tensors
# ---------------------------------------------------------------------------


def _paged_script(device):
    """One scripted sequence on a deepseek_7b smoke pool with sharing on:
    a slot written with random rows, a prefix shared into another slot
    and copied on write, one row committed for a member lane and one for
    a masked lane.  Returns the pool and its state (sink page included)."""
    from repro_torch.configs import smoke
    from repro_torch.models import init_caches
    from repro_torch.runtime import PagedCachePool

    cfg = smoke("deepseek_7b")
    pool = PagedCachePool(cfg, 2, 32, 4, prefix_sharing=True, device=device)
    state = pool.alloc()
    g = torch.Generator().manual_seed(0)
    single = {k: {n: (torch.randint(0, 32, v.shape, generator=g, dtype=v.dtype) if n == "pos"
                      else torch.randn(v.shape, generator=g)).to(device)
                  for n, v in node.items()}
              for k, node in init_caches(cfg, 1, 32, device="cpu").items()}
    pool.write(state, single, 0)
    grp = pool.groups["L32"]
    pid = int(grp["table"][0, 1])
    grp["alloc"].incref(pid)
    grp["table"][1, 1] = pid
    pool._dirty = True
    pool.ensure_rows(state, 1, 4, 7)          # copy-on-write of the shared page
    pool.ensure_rows(state, 1, 8, 8)
    tables = pool.device_tables()
    view = pool.device_view(state, tables)
    poked = {k: {n: v + 3 for n, v in node.items()} for k, node in view.items()}
    pos = torch.tensor([8, 8], dtype=torch.int32, device=device)
    pool.commit_rows(state, tables, poked, pos, torch.tensor([False, True], device=device),
                     n_rows=2)
    return pool, state, single, poked


@pytest.mark.cuda
def test_cuda_paged_commit_cow_and_sink_match_cpu(cuda):
    """The same script on CUDA and CPU tensors gives the same pages bit for
    bit; the zero page stays pristine, the masked lane's rows landed on
    the sink page only, and the copied page carries the shared bits."""
    pool, state, single, poked = _paged_script(cuda)
    _, ref, _, _ = _paged_script("cpu")
    for key, node in state["pages"].items():
        for name, arr in node.items():
            assert torch.equal(arr[:, :-1].cpu(), ref["pages"][key][name][:, :-1]), (key, name)
            assert bool((arr[:, 0] == (-1 if name == "pos" else 0)).all())
    sink = state["pages"]["pos0"]["k"][:, pool.sink("L32")]
    assert torch.equal(sink[:, :2], poked["pos0"]["k"][:, 0, 8:10])  # the masked lane's rows
    assert torch.equal(pool.read(state, 0)["pos0"]["k"], single["pos0"]["k"])
    read = pool.read(state, 1)
    assert torch.equal(read["pos0"]["k"][:, 0, 4:8], single["pos0"]["k"][:, 0, 4:8])
    assert torch.equal(read["pos0"]["k"][:, 0, 8:10], poked["pos0"]["k"][:, 1, 8:10])


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_cuda_speculative_serving_equals_vanilla_and_draft_restores_pool(cuda, cache):
    """gemma2_2b smoke on the card (drafts through K1, K2, K3 and K5): the
    contiguous draft leaves the pool bit for bit as it found it, and
    speculative serving gives vanilla f32 serving's tokens on both pools."""
    from repro_torch.configs import smoke
    from repro_torch.models import init_caches, init_params, prefill_step
    from repro_torch.runtime import ContinuousBatchingServer, ServingConfig, SpeculativeConfig

    cfg = smoke("gemma2_2b")
    params = init_params(cfg, seed=5, device=cuda)
    kw = dict(cache="paged", page_size=4) if cache == "paged" else {}
    spec = SpeculativeConfig(k=3, draft_level="q8_8", max_len=64)
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=3, max_len=64,
                                                              speculative=spec, **kw),
                                   device=cuda)
    prompts = [[(5 * i + j) % 200 + 1 for j in range(6 + 4 * i)] for i in range(5)]
    got = srv.generate(prompts, max_new=12, speculative=True)
    want = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=3, max_len=64, **kw),
                                    device=cuda).generate(prompts, max_new=12, level="f32")
    assert got == want and srv.stats["spec_rounds"] > 0
    if cache == "contiguous":
        pool = init_caches(cfg, 2, 64, device=cuda)
        toks = torch.tensor(prompts[:2][0][:6], dtype=torch.int32, device=cuda)
        for i in range(2):
            view = {k: {n: v[:, i:i + 1] for n, v in node.items()} for k, node in pool.items()}
            prefill_step(srv.params, toks[None] + i, view, cfg, mode="exact")
        before = {k: {n: v.clone() for n, v in node.items()} for k, node in pool.items()}
        tok = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
        pos = torch.tensor([6, 6], dtype=torch.int32, device=cuda)
        srv._spec_draft[0](srv.params, tok, pos, pool, torch.tensor([True, False], device=cuda))
        for k, node in pool.items():
            for n, v in node.items():
                assert torch.equal(v, before[k][n]), (k, n)


# the grouped K1 / K2 entries of the MoE experts: (E, M, K, N) —
# granite-moe-3b-a800m's prefill (C = 120) and 4-lane decode (M = 32), a
# single-lane pass (M = 8: the skinny shape), mixtral-8x22b's decode, and
# ragged tile edges (K, N not multiples of 16: the 4-byte copies)
GROUPED_K2 = [(40, 120, 1536, 512), (40, 32, 1536, 512), (40, 8, 1536, 512),
              (8, 32, 6144, 16384), (3, 1, 100, 52), (3, 9, 100, 52), (3, 129, 1536, 512)]
GROUPED_K1 = [(40, 120, 512, 1536), (40, 32, 512, 1536), (40, 8, 512, 1536),
              (8, 32, 16384, 6144), (3, 1, 100, 52), (3, 65, 100, 52), (3, 129, 512, 1536)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,M,K,F", GROUPED_K2)
def test_cuda_fused_swiglu_grouped_matches_plain(cuda, E, M, K, F):
    from repro_torch.kernels.fused_mlp import fused_swiglu_grouped, fused_swiglu_plain

    g = torch.Generator().manual_seed(E * 1000 + M)
    x = torch.randint(-128, 128, (E, M, K), generator=g, dtype=torch.int8).to(cuda)
    wg = torch.randint(-128, 128, (E, K, F), generator=g, dtype=torch.int8).to(cuda)
    wu = torch.randint(-128, 128, (E, K, F), generator=g, dtype=torch.int8).to(cuda)
    ea = torch.tensor([-6], dtype=torch.int32, device=cuda)
    eg = torch.randint(-14, -2, (E, F), generator=g, dtype=torch.int32).to(cuda)
    eu = torch.randint(-14, -2, (E, F), generator=g, dtype=torch.int32).to(cuda)
    n0 = fused_swiglu_grouped.launches
    got = fused_swiglu_grouped(x, wg, wu, ea, eg, eu, return_parts=True)
    want = fused_swiglu_plain(x, wg, wu, ea, eg, eu, return_parts=True)
    assert fused_swiglu_grouped.launches == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("E,M,K,N", GROUPED_K1)
@pytest.mark.parametrize("epilogue", ["float", "q16", "int32"])
def test_cuda_qmatmul_grouped_matches_plain(cuda, E, M, K, N, epilogue):
    from repro_torch.kernels.qmatmul import qmatmul_grouped, qmatmul_plain

    g = torch.Generator().manual_seed(E * 1000 + M + 1)
    a = torch.randint(-128, 128, (E, M, K), generator=g, dtype=torch.int8).to(cuda)
    b = torch.randint(-128, 128, (E, K, N), generator=g, dtype=torch.int8).to(cuda)
    ea = torch.tensor([-20], dtype=torch.int32, device=cuda)
    eb = torch.randint(-40, 30, (E, N), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(qmatmul_grouped(a, b, ea, eb, epilogue),
                       qmatmul_plain(a, b, ea, eb, epilogue))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [17, 480, 1000])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_flash_head_dim_64_matches_plain(cuda, S, dt):
    """granite-moe-3b-a800m's heads: 24 of 64 over 8 kv heads (the <= 128
    class, half of each tile masked)."""
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(1, S, h, 64, generator=g).to(cuda, dt) for h in (24, 8, 8))
    got = flash_attention(q, k, v).float()
    want = flash_attention_plain(q, k, v).float()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    else:
        assert bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "mixtral_8x22b"])
def test_cuda_moe_fast_layer_two_grouped_launches(cuda, monkeypatch, arch):
    """A FAST MoE block on the card: one grouped K2 and one grouped K1
    launch, and the block's output through K2's and K1's plain
    versions (with the group axis) on the same card bit for bit."""
    from repro_torch.configs import smoke
    from repro_torch.core.quantization import QuantizedWeightCache
    from repro_torch.kernels.fused_mlp import fused_swiglu_grouped, fused_swiglu_plain
    from repro_torch.kernels.qmatmul import qmatmul_grouped, qmatmul_plain
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import attach_quantized_weights, init_from_specs

    cfg = smoke(arch)
    params = init_from_specs(moe_mod.moe_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    params = attach_quantized_weights({k: v.to(cuda) for k, v in params.items()},
                                      QuantizedWeightCache())
    x = torch.randn(3, 10, cfg.d_model, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda, torch.bfloat16)
    n2, n1 = fused_swiglu_grouped.launches, qmatmul_grouped.launches
    got, _ = moe_mod.moe_forward(params, x, cfg, "fast")
    assert (fused_swiglu_grouped.launches - n2, qmatmul_grouped.launches - n1) == (1, 1)
    monkeypatch.setattr(moe_mod, "fused_swiglu_grouped", fused_swiglu_plain)
    monkeypatch.setattr(moe_mod, "qmatmul_grouped", qmatmul_plain)
    want, _ = moe_mod.moe_forward(params, x, cfg, "fast")
    assert torch.equal(got, want)


# slice 10's shapes: K1 at the SSM / MLA projections (N = 16, 64, 128, 288,
# 3840), K4 at minicpm3-4b's MLA prefill (D = 96, Dv = 64, 40 over 40 heads)
SLICE10_K1 = [(m, k, n) for m in (4, 33) for (k, n) in
              ((2048, 128), (2048, 64), (4096, 16), (4096, 128), (2560, 288), (768, 3840))]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", SLICE10_K1)
def test_cuda_qmatmul_ssm_mla_projections_match_plain(cuda, M, K, N):
    g = torch.Generator().manual_seed(M * K + N)
    a = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8).to(cuda)
    b = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8).to(cuda)
    ea = torch.tensor([-9], dtype=torch.int32, device=cuda)
    eb = torch.randint(-12, -4, (N,), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(qmatmul(a, b, ea, eb), qmatmul_plain(a, b, ea, eb))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [17, 480])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_flash_mla_heads_match_plain(cuda, S, dt):
    g = torch.Generator().manual_seed(S + 96)
    q, k = (torch.randn(1, S, 40, 96, generator=g).to(cuda, dt) for _ in range(2))
    v = torch.randn(1, S, 40, 64, generator=g).to(cuda, dt)
    got, want = flash_attention(q, k, v).float(), flash_attention_plain(q, k, v).float()
    assert got.shape == (1, S, 40, 64)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    else:
        assert bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["mamba2_1_3b", "jamba_v01_52b", "minicpm3_4b"])
def test_cuda_ssm_mla_speculative_serving_and_draft_restore(cuda, arch, cache):
    """The smoke SSM / MLA models on the card: speculative serving gives
    vanilla f32 serving's tokens on both pools, and the contiguous draft
    leaves the pool (SSM states included) bit for bit as it found it."""
    from repro_torch.configs import smoke
    from repro_torch.models import init_caches, init_params, prefill_step
    from repro_torch.runtime import ContinuousBatchingServer, ServingConfig, SpeculativeConfig

    cfg = smoke(arch)
    params = init_params(cfg, seed=5, device=cuda)
    kw = dict(cache="paged", page_size=4) if cache == "paged" else {}
    spec = SpeculativeConfig(k=3, draft_level="q16_16", max_len=64)
    srv = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=3, max_len=64,
                                                              speculative=spec, **kw),
                                   device=cuda)
    prompts = [[(5 * i + j) % 120 + 1 for j in range(6 + 4 * i)] for i in range(4)]
    got = srv.generate(prompts, max_new=10, speculative=True)
    want = ContinuousBatchingServer(cfg, params, ServingConfig(n_slots=3, max_len=64, **kw),
                                    device=cuda).generate(prompts, max_new=10, level="f32")
    assert got == want and srv.stats["spec_rounds"] > 0
    if cache == "contiguous":
        pool = init_caches(cfg, 2, 64, device=cuda)
        toks = torch.tensor(prompts[0][:6], dtype=torch.int32, device=cuda)
        for i in range(2):
            view = {k: {n: v[:, i:i + 1] for n, v in node.items()} for k, node in pool.items()}
            prefill_step(srv.params, toks[None] + i, view, cfg, mode="exact")
        before = {k: {n: v.clone() for n, v in node.items()} for k, node in pool.items()}
        tok = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
        pos = torch.tensor([6, 6], dtype=torch.int32, device=cuda)
        srv._spec_draft[1](srv.params, tok, pos, pool, torch.tensor([True, False], device=cuda))
        for k, node in pool.items():
            for n, v in node.items():
                assert torch.equal(v, before[k][n]), (k, n)


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["precise", "fast"])
@pytest.mark.parametrize("arch", ["gemma2_2b", "deepseek_7b"])
def test_cuda_train_loss_and_grads_match_plain(cuda, arch, mode):
    """``train_loss`` and its gradients on the card (K1, K3, K4, K5 with
    their autograd Functions; K2 never) against the plain versions on the
    CPU, same parameters: loss rel 1e-3, every gradient leaf within 5e-2
    of its norm (bf16 products summed in other orders).  Dense models:
    a MoE router turns such ulps into other experts (granite's FAST loss
    moved by 1.4e-3 between the card and the CPU); MoE training is held
    against JAX on the CPU (tests/test_torch_train.py)."""
    from repro_torch.configs import smoke
    from repro_torch.kernels.fused_mlp import fused_swiglu as k2
    from repro_torch.models.model import init_params, train_loss

    cfg = smoke(arch)
    tok = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    base = init_params(cfg, seed=3, device="cpu")

    def copy(tree, dev):
        return {k: copy(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
                for k, v in tree.items()}

    out = {}
    for dev in ("cpu", cuda):
        params = copy(base, dev)
        leaves = list(_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        batch = {"tokens": tok.to(dev), "labels": tok.to(dev)}
        k1, k4, k2_before = qmatmul.launches, flash_attention.launches, k2.launches
        loss, _ = train_loss(params, batch, cfg, mode=mode)
        grads = torch.autograd.grad(loss, leaves)
        out[str(dev)] = (float(loss.detach()), [g.detach().cpu().double() for g in grads])
        if dev != "cpu":
            assert flash_attention.launches > k4 and k2.launches == k2_before
            assert (qmatmul.launches > k1) == (mode == "fast")
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-3 * abs(lc)
    for a, b in zip(gg, gc):
        assert (a - b).norm() <= 5e-2 * b.norm() + 1e-12


@pytest.mark.cuda
def test_cuda_trainer_resume_bitwise(cuda, tmp_path):
    """The reference's failure-injection test on the card (gemma2's smoke
    config): resumed losses within rel 1e-5 of an uninterrupted run."""
    from repro_torch.configs import smoke
    from repro_torch.runtime import InjectedFailure, Trainer, TrainerConfig

    def trainer(d, **kw):
        return Trainer(smoke("gemma2_2b"), TrainerConfig(total_steps=16, ckpt_every=4,
                                                         ckpt_dir=str(d), **kw), device=cuda)

    with pytest.raises(InjectedFailure):
        trainer(tmp_path / "a", crash_at_step=10).run()
    t2 = trainer(tmp_path / "a")
    assert t2.start_step == 8
    resumed = {h["step"]: h["loss"] for h in t2.run()["history"]}
    ref = {h["step"]: h["loss"] for h in trainer(tmp_path / "b").run()["history"]}
    for s in range(10, 16):
        assert resumed[s] == pytest.approx(ref[s], rel=1e-5), s
