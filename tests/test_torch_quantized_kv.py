"""The port's int8 KV cache (``init_caches(quantized=True)``: int8 k / v
payloads, one power-of-two exponent per row and kv head), mirroring
tests/test_quantized_kv.py's four tests, then held against the JAX
package's cache bit for bit.

JAX runs in child processes (``tests/_torch_jax_child.py OUT ARCH qkv``,
``--xla_allow_excess_precision=false``; one per architecture, started
for this module): the reference test's run (parameters from
``PRNGKey(7)``, a 24-token prefill and 4 teacher-forced decodes at the
default ``precise`` mode) on a bf16 and an int8 cache, and on
the FAST rung an int8 cache after a two-lane prefill, a decode, a
5-token segment (mixtral's 8-row window wraps inside it) and its commit
with one lane inactive.

* int8 against the unquantized cache (the reference's bound,
  ``diff < 0.08 * scale + 0.15``), at bf16 as the reference compares,
  the gap equal to JAX's within 1e-2, and on the port's f32 cache too;
  deepseek keeps the reference's non-strict xfail (its reason below);
* the port's logits against JAX's on the bf16 and int8 caches: within 1e-2 (the
  ``precise`` rung's bf16 matmuls summed in another order; measured
  4.5e-3 on gemma2, 5e-7 on the others);
* payloads, exponents and positions bit for bit after every step, and
  the commit restores the rejected rows' ``k_exp`` / ``v_exp`` too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import (  # noqa: E402
    QKV_B,
    QKV_S,
    QKV_STEPS,
    SEG_POSITIONS,
    SEG_PROMPT,
    SEG_TOKENS,
    start_shared,
    wait_shared,
)
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.quantization import QuantizedWeightCache, quantize_pow2  # noqa: E402
from repro_torch.models.attention import _q8  # noqa: E402
from repro_torch.models.layers import attach_quantized_weights  # noqa: E402

DEEPSEEK_XFAIL = pytest.mark.xfail(
    reason="pre-existing in the reference (tests/test_quantized_kv.py): dense-GQA int8-KV "
    "logit error 0.73 > 0.45 bound on this toolchain.  Measured per-(layer, kv-head) dequant "
    "error is UNIFORM and already at the int8 pow2 floor (k: 0.40/0.41/0.64/0.71%, "
    "v: 0.69/0.66/0.65/0.40% of head amax; grid step is 0.39-0.79%), so finer per-head "
    "exponents cannot close it — the excess is cross-layer amplification of near-tied logits "
    "on the random-init smoke model (per-step logit diffs 0.12/0.11/0.73/0.20).  See ROADMAP "
    "'Known-failing tier-1 tests'",
    strict=False,
)
ARCHS = ("deepseek_7b", "gemma2_2b", "mixtral_8x22b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_child(request, tmp_path_factory):
    return start_shared(request, tmp_path_factory)


def _tree(ref, prefix):
    tree: dict = {}
    for name, arr in ref.items():
        if name.startswith(prefix):
            node = tree
            parts = name.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree


_RUNS = {}


def _run(jax_child, arch):
    """(JAX's records, the port's parameters, the port's logits on each
    cache for the reference test's teacher-forced run)."""
    if arch in _RUNS:
        return _RUNS[arch]
    ref = dict(np.load(wait_shared(jax_child, arch, "qkv")))
    cfg = smoke(arch)
    params = params_from_jax(_tree(ref, "qkvparam/"), device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (QKV_B, QKV_S)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (QKV_STEPS, QKV_B, 1)))
    outs = {}
    for name, kw in (("bf16", {"dtype": torch.bfloat16}), ("f32", {}),
                     ("int8", {"quantized": True})):
        caches = tm.init_caches(cfg, QKV_B, 64, device="cpu", **kw)
        logits, caches = tm.prefill_step(params, toks, caches, cfg)
        seq = [logits.float().numpy()]
        pos = torch.full((QKV_B,), QKV_S, dtype=torch.int32)
        for i in range(QKV_STEPS):
            logits, caches = tm.decode_step(params, forced[i], pos, caches, cfg)
            seq.append(logits.float().numpy())
            pos = pos + 1
        outs[name] = np.stack(seq)
    _RUNS[arch] = ref, params, outs
    return _RUNS[arch]


@pytest.mark.parametrize("base", ["bf16", "f32"])
@pytest.mark.parametrize("arch", [pytest.param("deepseek_7b", marks=DEEPSEEK_XFAIL),
                                  "gemma2_2b", "mixtral_8x22b"])
def test_quantized_decode_close_to_bf16(jax_child, arch, base):
    """Greedy decode logits through the int8 cache track the unquantized
    cache's within Q-format error (int8 grid ~ 0.8% of slot amax), on
    the same teacher-forced stream; ``base`` is the unquantized cache's
    dtype (bf16 is the reference's)."""
    ref, _, outs = _run(jax_child, arch)
    diff = np.abs(outs["int8"] - outs[base]).max()
    scale = np.abs(outs[base]).max()
    if base == "bf16":
        jax_diff = np.abs(ref["qkv/int8/logits"] - ref["qkv/bf16/logits"]).max()
        assert abs(diff - jax_diff) < 1e-2, (arch, diff, jax_diff)
    assert diff < 0.08 * scale + 0.15, (arch, diff, scale)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference_on_each_cache(jax_child, arch, cache):
    ref, _, outs = _run(jax_child, arch)
    np.testing.assert_allclose(outs[cache], ref[f"qkv/{cache}/logits"], rtol=0, atol=1e-2)


def test_kv_quantization_is_core_pow2_kept_axes():
    """The KV-cache quantizer IS quantize_pow2's kept-axes form: one
    exponent per (batch, seq, kv-head) slice, bit-identical payloads
    (the reference test's data: a slice whose amax rounds to 128 clips to
    127, past half a step)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(2, 5, 3, 16)) * 10.0).astype(np.float32))
    q, e = _q8(x, axes=(3,))
    assert q.dtype == torch.int8 and e.shape == (2, 5, 3)
    qt = quantize_pow2(x, bits=8, axis=(0, 1, 2))
    assert torch.equal(q, qt.q) and torch.equal(e, qt.exp.reshape(2, 5, 3))
    # per-head independence: rescaling ONE head leaves every other
    # head's payload and exponent untouched
    y = x.clone()
    y[:, :, 1] *= 64.0
    q2, e2 = _q8(y, axes=(3,))
    assert torch.equal(q2[:, :, [0, 2]], q[:, :, [0, 2]])
    assert torch.equal(e2[:, :, [0, 2]], e[:, :, [0, 2]])
    assert torch.equal(e2[:, :, 1], e[:, :, 1] + 6)
    # round-trip error bounded by half a grid step per head
    deq = q.double() * torch.exp2(e.double())[..., None]
    step = torch.exp2(e.double())
    assert ((deq - x.double()).abs().amax(dim=3) <= step / 2 + 1e-6).all()
    assert (x.double().abs().amax(dim=3) / step <= 127.5).all()


def test_quantized_cache_layout():
    c = tm.init_caches(smoke("deepseek_7b"), 2, 32, device="cpu", quantized=True)
    node = c["pos0"]
    assert set(node) == {"k", "v", "pos", "k_exp", "v_exp"}
    assert node["k"].dtype == node["v"].dtype == torch.int8
    assert node["k_exp"].dtype == torch.int32 and node["k_exp"].shape == node["k"].shape[:-1]


def _nbytes(caches):
    return sum(v.numel() * v.element_size() for node in caches.values() for v in node.values())


def test_quantized_cache_halves_bytes():
    # smoke dims (hd=16): per-head exponent overhead is 4/16/2 = 12.5%
    cfg = smoke("deepseek_7b")
    full = _nbytes(tm.init_caches(cfg, 2, 64, dtype=torch.bfloat16, device="cpu"))
    quant = _nbytes(tm.init_caches(cfg, 2, 64, device="cpu", quantized=True))
    assert quant < 0.75 * full, (quant, full)
    # production dims (hd=128): overhead 1.6% -> true halving; shapes only
    prod = get_config("deepseek_7b")
    full_p = _nbytes(tm.init_caches(prod, 8, 32768, dtype=torch.bfloat16, device="meta"))
    quant_p = _nbytes(tm.init_caches(prod, 8, 32768, device="meta", quantized=True))
    assert quant_p < 0.53 * full_p, (quant_p, full_p)


# ---------------------------------------------------------------------------
# bit for bit against JAX's int8 cache on the FAST rung
# ---------------------------------------------------------------------------

_FAST = {}


def _fast(jax_child, arch):
    """JAX's records and the port's int8 caches after each step."""
    if arch in _FAST:
        return _FAST[arch]
    ref, params, _ = _run(jax_child, arch)
    cfg = smoke(arch)
    pa = attach_quantized_weights(params, QuantizedWeightCache())

    def clone(c):
        return {pos: {k: v.clone() for k, v in node.items()} for pos, node in c.items()}

    caches = tm.init_caches(cfg, 2, 32, device="cpu", quantized=True)
    _, caches = tm.prefill_step(pa, torch.from_numpy(SEG_PROMPT), caches, cfg, mode="fast")
    got = {"c1": clone(caches)}
    _, c2 = tm.decode_step(pa, torch.from_numpy(SEG_TOKENS[:, :1]),
                           torch.from_numpy(SEG_POSITIONS[:, 0]), clone(caches), cfg, mode="fast")
    got["c2"] = c2
    logits, after, aux = tm.segment_step(pa, torch.from_numpy(SEG_TOKENS),
                                         torch.from_numpy(SEG_POSITIONS), caches, cfg,
                                         mode="fast")
    got["seg"] = clone(after)
    got["seg_logits"] = logits.numpy()
    got["commit"] = tm.commit_segment(after, aux, cfg,
                                      keep_pos=torch.from_numpy(SEG_POSITIONS[:, 2]),
                                      keep_count=None, active=torch.tensor([True, False]))
    _FAST[arch] = ref, got
    return _FAST[arch]


@pytest.mark.parametrize("step", ["c1", "c2", "seg", "commit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_bit_equal_to_reference(jax_child, arch, step):
    """Payloads, exponents and positions after the prefill (c1), a decode
    (c2), a segment (seg) and its commit (keep_count 3 on lane 0, lane 1
    inactive, so the commit restores rejected rows' exponents too)."""
    ref, got = _fast(jax_child, arch)
    for pos, node in got[step].items():
        assert set(node) == {"k", "v", "pos", "k_exp", "v_exp"}
        for name, v in node.items():
            np.testing.assert_array_equal(v.numpy(), ref[f"int8/{step}/{pos}/{name}"],
                                          err_msg=f"{arch} {step} {pos}/{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_segment_logits_and_commit_restores_exponents(jax_child, arch):
    ref, got = _fast(jax_child, arch)
    # the FAST head's f32 product summed in another order
    np.testing.assert_allclose(got["seg_logits"], ref["int8/seg/logits"], rtol=1e-5, atol=1e-5)
    # lane 1 was inactive: every leaf of it is back to the prefill's
    for pos, node in got["commit"].items():
        for name in ("k_exp", "v_exp", "k", "v", "pos"):
            assert torch.equal(node[name][:, 1], got["c1"][pos][name][:, 1]), (pos, name)
    # and the segment did change lane 1's exponents before the commit
    assert any(not torch.equal(got["seg"][pos]["k_exp"][:, 1], got["c1"][pos]["k_exp"][:, 1])
               for pos in got["seg"])


@pytest.mark.parametrize("arch", ["deepseek_7b", "mixtral_8x22b"])
def test_int8_decode_lane_mask_is_the_pristine_view(arch):
    """``decode_step(lane_mask=...)`` on an int8 cache computes a
    non-member lane as the reference's pristine masked view does (its
    cache pristine but for its own fresh, quantized row) without
    materialising that view: the same logits bit for bit, member rows
    written, the non-member's rows untouched."""
    cfg = smoke(arch)
    params = attach_quantized_weights(tm.init_params(cfg, seed=1, device="cpu"),
                                      QuantizedWeightCache())
    caches = tm.init_caches(cfg, 2, 32, device="cpu", quantized=True)
    tm.prefill_step(params, torch.from_numpy(SEG_PROMPT), caches, cfg, mode="fast")
    tok = torch.from_numpy(SEG_TOKENS[:, :1])
    pos = torch.from_numpy(SEG_POSITIONS[:, 0])
    mask = torch.tensor([True, False])

    def clone(c):
        return {k: {n: v.clone() for n, v in node.items()} for k, node in c.items()}

    got_c = clone(caches)
    got, _ = tm.decode_step(params, tok, pos, got_c, cfg, mode="fast", lane_mask=mask)
    view = tm.reset_cache_slot(clone(caches), cfg, 1)
    want, _ = tm.decode_step(params, tok, pos, view, cfg, mode="fast", lane_mask=mask,
                             pristine_view=False)
    assert torch.equal(got, want)
    for key, node in got_c.items():
        for name, leaf in node.items():
            assert torch.equal(leaf[:, 0], view[key][name][:, 0]), (key, name)
            assert torch.equal(leaf[:, 1], caches[key][name][:, 1]), (key, name)
