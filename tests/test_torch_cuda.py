"""Each CUDA kernel of the port against its plain PyTorch version, on
the card.  Imports no JAX, so it runs on the H100 machine as is::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs the card (marker ``cuda``) and skips without one.
Tolerances: integer outputs bit-exact; K2's f32 product at rtol 1e-6
(one multiply order, each rounded once); attention at 2e-3 (f32) and
2e-2 (bf16) — summation order and bf16 rounding of p."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cordic import (  # noqa: E402
    cordic_sincos,
    cordic_sincos_plain,
    rope_sincos_plain,
    rope_sincos_q16,
)
from repro_torch.kernels.flashattn import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.fused_mlp import fused_swiglu, fused_swiglu_plain  # noqa: E402
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
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 5, 70])
@pytest.mark.parametrize("epilogue", ["float", "q16", "int32"])
def test_cuda_qmatmul_matches_plain(cuda, M, epilogue):
    g = torch.Generator().manual_seed(M)
    a = torch.randint(-128, 128, (M, 260), generator=g, dtype=torch.int8).to(cuda)
    b = torch.randint(-128, 128, (260, 132), generator=g, dtype=torch.int8).to(cuda)
    ea = torch.tensor([-20], dtype=torch.int32, device=cuda)
    eb = torch.randint(-40, 30, (132,), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(qmatmul(a, b, ea, eb, epilogue), qmatmul_plain(a, b, ea, eb, epilogue))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 40])
def test_cuda_fused_swiglu_matches_plain(cuda, M):
    g = torch.Generator().manual_seed(M)
    x = torch.randint(-128, 128, (M, 256), generator=g, dtype=torch.int8).to(cuda)
    wg = torch.randint(-128, 128, (256, 100), generator=g, dtype=torch.int8).to(cuda)
    wu = torch.randint(-128, 128, (256, 100), generator=g, dtype=torch.int8).to(cuda)
    ea = torch.tensor([-6], dtype=torch.int32, device=cuda)
    e = torch.randint(-14, -2, (100,), generator=g, dtype=torch.int32).to(cuda)
    out, gate, sig = fused_swiglu(x, wg, wu, ea, e, e, return_parts=True)
    w_out, w_gate, w_sig = fused_swiglu_plain(x, wg, wu, ea, e, e, return_parts=True)
    assert torch.equal(gate, w_gate) and torch.equal(sig, w_sig)
    torch.testing.assert_close(out, w_out, rtol=1e-6, atol=0)


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
    tol = 2e-3 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
