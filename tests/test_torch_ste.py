"""The gradients the FAST training rung runs through its kernels, against
the JAX package (in this process, on the CPU):

* ``qdot_ste`` (K1, straight-through): the reference's
  ``tests/test_kernel_qmatmul.py::test_qdot_ste_gradient`` on the port
  (the direction of the quantized-forward gradient agrees with the exact
  float gradient, cos > 0.99), and its gradients equal to JAX's
  ``qdot_ste``'s on the same operands (rel 1e-5: both backwards are f32
  products of the same operands and cotangent, whose forwards agree to
  the last bit but one, the reference's XLA ``exp2`` being an ulp off);
* ``DotFastSTE`` (``dot_fast_int8`` under autograd): ``jax.grad`` of the
  reference's ``dot_fast_int8`` (rel 1e-5);
* the CORDIC tanh and sigmoid (K5) STE: ``jax.grad`` of ``ptanh`` /
  ``psigmoid`` / ``psilu`` / ``softcap`` at ``"fast"`` — the forwards are
  bit-exact, so the analytic backwards agree to 1 ulp (rel 1e-6);
* K4's autograd Function (``flash_attention`` under autograd): dq, dk
  and dv against ``jax.grad`` of ``chunked_attention`` (causal, sliding
  window, score softcap, GQA, ragged S), f32 to rel 1e-5 of each
  gradient's norm; bf16 to rel 2e-2, the reference's backward rounding
  its bf16 cotangents where the port keeps f32.  The written-out
  backward gives the same gradients at any key-chunk size (8 against the
  reference's 1024).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_jax_child import start_shared  # noqa: E402

from repro.kernels.qmatmul import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels.flashattn import flash_attention, flash_attention_backward  # noqa: E402
from repro_torch.kernels.qmatmul import qdot_ste  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def jax_children(request, tmp_path_factory):
    """Start the ``train`` children of tests/test_torch_train.py now, so
    their compiles overlap this module's."""
    start_shared(request, tmp_path_factory)


def _t(a, grad=True):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_qdot_ste_gradient_direction_and_jax(rng):
    a = rng.uniform(-1, 1, (16, 64)).astype(np.float32)
    b = rng.uniform(-1, 1, (64, 32)).astype(np.float32)
    ta, tb = _t(a), _t(b)
    ga_q, gb_q = torch.autograd.grad((qdot_ste(ta, tb) ** 2).sum(), (ta, tb))
    ta2, tb2 = _t(a), _t(b)
    ga_f, gb_f = torch.autograd.grad((torch.matmul(ta2, tb2) ** 2).sum(), (ta2, tb2))
    cos = lambda x, y: float((x * y).sum() / (x.norm() * y.norm() + 1e-9))
    assert cos(ga_q, ga_f) > 0.99
    assert cos(gb_q, gb_f) > 0.99
    ja, jb = jax.grad(lambda a, b: jnp.sum(jops.qdot_ste(a, b) ** 2), argnums=(0, 1))(a, b)
    assert _rel(ga_q, ja) < 1e-5 and _rel(gb_q, jb) < 1e-5


@pytest.mark.parametrize("cached", [False, True])
def test_dot_fast_ste_matches_jax(rng, cached):
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48, 24)).astype(np.float32) * 0.2
    g = rng.normal(size=(2, 5, 24)).astype(np.float32)
    jwq = jtwq = None
    if cached:
        from repro.core.quantization import quantize_pow2 as jq
        from repro_torch.core.quantization import quantize_pow2 as tq

        jwq = jq(jnp.asarray(w), bits=8, axis=1)
        jwq = {"q": jwq.q, "exp": jwq.exp}
        twq = tq(torch.from_numpy(w), bits=8, axis=1)
        jtwq = {"q": twq.q, "exp": twq.exp}
    jx, jw = jax.grad(lambda x, w: jnp.sum(jlayers.dot_fast_int8(x, w, wq=jwq) * g),
                      argnums=(0, 1))(x, w)
    tx, tw = _t(x), _t(w)
    gx, gw = torch.autograd.grad((tlayers.dot_fast_int8(tx, tw, wq=jtwq) * _t(g, False)).sum(),
                                 (tx, tw))
    assert _rel(gx, jx) < 1e-5 and _rel(gw, jw) < 1e-5


@pytest.mark.parametrize("fn", ["ptanh", "psigmoid", "psilu", "softcap"])
def test_cordic_ste_matches_jax(rng, fn):
    x = rng.uniform(-6, 6, (257,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    if fn == "softcap":
        x = x * 10
        jf = lambda u: jlayers.softcap(u, 30.0, "fast")
        tf = lambda u: tlayers.softcap(u, 30.0, "fast")
    else:
        jf = lambda u: getattr(jlayers, fn)(u, "fast")
        tf = lambda u: getattr(tlayers, fn)(u, "fast")
    jy = np.asarray(jf(jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda u: jnp.sum(jf(u) * g))(jnp.asarray(x)))
    tx = _t(x)
    ty = tf(tx)
    np.testing.assert_array_equal(ty.detach().numpy(), jy)
    (tg,) = torch.autograd.grad((ty * _t(g, False)).sum(), (tx,))
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-6, atol=1e-7)


#: ((B, S, H, KV, D, Dv, window, cap), dtype)
ATTN_CASES = [
    ((2, 17, 4, 2, 16, 16, None, None), "float32"),     # GQA, ragged S
    ((1, 40, 4, 1, 8, 12, 7, None), "float32"),         # MQA, window, Dv != D
    ((2, 33, 2, 2, 8, 8, 5, 3.0), "float32"),           # window and score softcap
    ((2, 33, 4, 2, 8, 8, 5, 3.0), "bfloat16"),          # all of them, bf16
]


@pytest.mark.parametrize("case,dtype", ATTN_CASES)
def test_flash_attention_grad_matches_jax(case, dtype):
    B, S, H, KV, D, Dv, window, cap = case
    r = np.random.default_rng(S)
    q, k, v = (r.normal(size=shape).astype(np.float32) for shape in
               ((B, S, H, D), (B, S, KV, D), (B, S, KV, Dv)))
    g = r.normal(size=(B, S, H, Dv)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))

    def loss(q, k, v):
        out = chunked_attention(q, k, v, q_positions=pos, window=window, cap=cap)
        return jnp.sum(out.astype(jnp.float32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, window=window, softcap=cap)
    got = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), (tq, tk, tv))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt
        assert _rel(a.float(), np.asarray(b.astype(jnp.float32))) < tol, name
    small = flash_attention_backward(tq.detach(), tk.detach(), tv.detach(),
                                     torch.from_numpy(g).to(tdt), window=window, softcap=cap,
                                     chunk=8)
    for a, b in zip(got, small):
        assert _rel(b.float(), a.float().numpy()) < (1e-5 if dtype == "float32" else 1e-2)
