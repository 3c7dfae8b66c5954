"""The port's segment steps (``segment_step``, ``commit_segment``,
``truncate_cache_slot``, ``cache_layout`` and the S > 1 cached attention
path) against the JAX package, on the deepseek_7b and gemma2_2b smoke
models (gemma2's local layers hold an 8-row rolling buffer, which the
11-token prompt fills and the 5-token segment at positions 11..15
wraps).

The JAX side runs in two child processes, one per model, started
together (``tests/_torch_jax_child.py OUT ARCH segment``), with
``--xla_allow_excess_precision=false`` so that its FAST rung rounds its
bf16 casts where the source says (see tests/test_torch_model.py).  Both
sides start the segment from the same two-lane cache, JAX's exact-rung
prefill, and the port is fed JAX's parameters.

* exact rung (f32): logits and caches at 1e-4, the slice-1 standard
  (f32 matmuls summed in another order, libm ulps in RoPE and tanh);
* FAST rung (K1-K5): caches bit-exact; logits at 1e-5 (deepseek) and
  1e-5 plus two steps of the final softcap's Q16.16 grid (gemma2; see
  tests/test_torch_gemma2.py);
* ``commit_segment``: the rolled-back rows (new position past
  ``keep_pos``, or an inactive lane) bit-exact with JAX's, the kept rows
  at the rung's cache tolerance, positions bit-exact;
* ``truncate_cache_slot`` and ``cache_layout``: equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, smoke as j_smoke  # noqa: E402
from repro.models import cache_layout as j_cache_layout  # noqa: E402
from repro.models import truncate_cache_slot as j_truncate_cache_slot  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config, smoke as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

from _torch_jax_child import SEG_POSITIONS, SEG_PROMPT, SEG_TOKENS  # noqa: E402

TESTS = Path(__file__).resolve().parent

ARCHS = ("deepseek_7b", "gemma2_2b")
MODES = ("exact", "fast")
LEAVES = ("k", "v", "pos")
S = SEG_TOKENS.shape[1]
COMMITS = [f"commit{k}" for k in range(1, S + 1)] + ["commit_inactive"]
FAST_LOGIT_TOL = {"deepseek_7b": 1e-5, "gemma2_2b": 1e-5 + 30.0 * 2.0 ** -15}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{arch: (npz dict, parameter tree)} from the two JAX children."""
    out_dir = tmp_path_factory.mktemp("jax_seg")
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    procs = {arch: subprocess.Popen([sys.executable, str(TESTS / "_torch_jax_child.py"),
                                     str(out_dir / f"{arch}.npz"), arch, "segment"], env=env)
             for arch in ARCHS}
    out = {}
    for arch, proc in procs.items():
        assert proc.wait(timeout=600) == 0, arch
        ref = dict(np.load(out_dir / f"{arch}.npz"))
        tree = {}
        for name, arr in ref.items():
            if name.startswith("param/") and not any(p.endswith("_q") for p in name.split("/")):
                node = tree
                parts = name.split("/")[1:]
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = arr
        out[arch] = (ref, tree)
    return out


def _tree(ref, prefix):
    """{pos_i: {leaf: tensor}} of the npz entries under ``prefix``."""
    out = {}
    for name, arr in ref.items():
        if name.startswith(prefix + "/"):
            pos, leaf = name[len(prefix) + 1:].split("/")
            out.setdefault(pos, {})[leaf] = torch.from_numpy(np.array(arr, copy=True))
    return out


def _clone(tree):
    return {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in tree.items()}


@pytest.fixture(scope="module")
def port(reference):
    """{arch: {mode: records}}: the port's segment from JAX's cache, the
    lane-masked segment, and each commit of the child's list."""
    from repro_torch.core.quantization import QuantizedWeightCache
    from repro_torch.models.layers import attach_quantized_weights

    out = {}
    toks, poss = torch.from_numpy(SEG_TOKENS), torch.from_numpy(SEG_POSITIONS)
    for arch in ARCHS:
        ref, tree = reference[arch]
        cfg = t_smoke(arch)
        params = attach_quantized_weights(params_from_jax(tree, device="cpu"),
                                          QuantizedWeightCache())
        c1 = _tree(ref, "c1")
        out[arch] = {"cfg": cfg, "params": params, "c1": c1}
        for mode in MODES:
            logits, after, aux = tm.segment_step(params, toks, poss, _clone(c1), cfg, mode=mode)
            rec = {"logits": logits.numpy(), "after": _clone(after)}
            m_logits, m_after, _ = tm.segment_step(params, toks, poss, _clone(c1), cfg,
                                                   mode=mode, lane_mask=torch.tensor([True, False]))
            rec["masked"] = {"logits": m_logits.numpy(), "after": m_after}
            for k in range(1, S + 1):
                rec[f"commit{k}"] = tm.commit_segment(
                    _clone(after), aux, cfg, keep_pos=poss[:, k - 1],
                    keep_count=torch.full((2,), k), active=torch.ones(2, dtype=torch.bool))
            rec["commit_inactive"] = tm.commit_segment(
                _clone(after), aux, cfg, keep_pos=poss[:, 2], keep_count=torch.full((2,), 3),
                active=torch.tensor([True, False]))
            out[arch][mode] = rec
    return out


def _assert_cache(got, want, mode, what):
    for pos in want:
        for leaf in LEAVES:
            g, w = got[pos][leaf].numpy(), want[pos][leaf].numpy()
            if mode == "exact" and leaf != "pos":
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=f"{what} {pos}/{leaf}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{what} {pos}/{leaf}")


def _assert_logits(got, want, arch, mode):
    assert np.all(np.isfinite(got))
    tol = 1e-4 if mode == "exact" else FAST_LOGIT_TOL[arch]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_segment_step_logits_match_reference(reference, port, arch, mode):
    ref, _ = reference[arch]
    got = port[arch][mode]["logits"]
    assert got.shape == (2, S, t_smoke(arch).vocab)
    _assert_logits(got, ref[f"{mode}/seg/logits"], arch, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_segment_step_caches_match_reference(reference, port, arch, mode):
    ref, _ = reference[arch]
    _assert_cache(port[arch][mode]["after"], _tree(ref, f"{mode}/seg/after"), mode, "after")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lane_masked_segment_matches_reference(reference, port, arch, mode):
    ref, _ = reference[arch]
    rec = port[arch][mode]["masked"]
    _assert_logits(rec["logits"], ref[f"{mode}/masked/logits"], arch, mode)
    _assert_cache(rec["after"], _tree(ref, f"{mode}/masked/after"), mode, "masked after")


@pytest.mark.parametrize("commit", COMMITS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_commit_segment_matches_reference(reference, port, arch, mode, commit):
    """Rows the commit rolls back equal JAX's bit for bit (they are the
    shared pre-segment rows, wrapped slots included); kept rows at the
    rung's cache tolerance."""
    ref, _ = reference[arch]
    got, want = port[arch][mode][commit], _tree(ref, f"{mode}/{commit}")
    after = _tree(ref, f"{mode}/seg/after")
    k = 3 if commit == "commit_inactive" else int(commit[len("commit"):])
    keep_pos = SEG_POSITIONS[:, k - 1]
    active = np.array([True, commit != "commit_inactive"])
    n_rolled = 0
    for pos in want:
        rejected = (after[pos]["pos"].numpy() > keep_pos[None, :, None]) | ~active[None, :, None]
        n_rolled += int(rejected.sum())
        for leaf in LEAVES:
            g, w = got[pos][leaf].numpy(), want[pos][leaf].numpy()
            np.testing.assert_array_equal(g[rejected], w[rejected], err_msg=f"{pos}/{leaf}")
    if k < S or commit == "commit_inactive":
        assert n_rolled > 0
    _assert_cache(got, want, mode, commit)


@pytest.mark.parametrize("arch", ARCHS)
def test_commit_restores_wrapped_rows_bit_for_bit(port, arch):
    """keep_count 1: every row the segment wrote past the first is the
    pre-segment row again — on gemma2's local layers, rows of positions
    4..7 that the segment's 12..15 overwrote."""
    c1, rec = port[arch]["c1"], port[arch]["exact"]["commit1"]
    for pos in c1:
        slots = SEG_POSITIONS[0, 1:] % c1[pos]["pos"].shape[-1]
        for leaf in LEAVES:
            assert torch.equal(rec[pos][leaf][:, :, slots], c1[pos][leaf][:, :, slots])
    if arch == "gemma2_2b":   # the local layer's slot 4: position 4, then 12, then 4 again
        assert int(port[arch]["exact"]["after"]["pos0"]["pos"][0, 0, 4]) == 12
        assert int(rec["pos0"]["pos"][0, 0, 4]) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_segment_equals_sequential_decode_on_the_exact_rung(port, arch):
    """Five sequential decode steps from the same cache give the segment's
    logits (f32 noise) and argmaxes, and the same cache."""
    p = port[arch]
    cfg, params = p["cfg"], p["params"]
    caches = _clone(p["c1"])
    logits = []
    for i in range(S):
        lg, caches = tm.decode_step(params, torch.from_numpy(SEG_TOKENS[:, i:i + 1]),
                                    torch.from_numpy(SEG_POSITIONS[:, i]), caches, cfg,
                                    mode="exact")
        logits.append(lg.numpy())
    seq = np.stack(logits, axis=1)
    np.testing.assert_allclose(p["exact"]["logits"], seq, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(p["exact"]["logits"].argmax(-1), seq.argmax(-1))
    _assert_cache(caches, p["exact"]["after"], "exact", "sequential")


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_through_segments_matches_prefill(port, arch):
    """The paged server's chunked prefill on the port's steps: 4-token
    segments from an empty cache, the ragged last chunk padded and its
    pad rows rolled back by commit_segment; the next token and the cache
    equal a whole prefill's (exact rung)."""
    p = port[arch]
    cfg, params = p["cfg"], p["params"]
    prompt = torch.from_numpy(SEG_PROMPT[:1])                     # 11 tokens
    whole = tm.init_caches(cfg, 1, 32, device="cpu")
    want, whole = tm.prefill_step(params, prompt, whole, cfg, mode="exact")
    caches, C, n = tm.init_caches(cfg, 1, 32, device="cpu"), 4, prompt.shape[1]
    for c0 in range(0, n, C):
        r = min(C, n - c0)
        toks = torch.zeros((1, C), dtype=torch.int32)
        toks[0, :r] = prompt[0, c0:c0 + r]
        pos = torch.arange(c0, c0 + C, dtype=torch.int32)[None]
        logits, caches, aux = tm.segment_step(params, toks, pos, caches, cfg, mode="exact")
        tm.commit_segment(caches, aux, cfg, keep_pos=pos[:, r - 1], keep_count=torch.tensor([r]),
                          active=torch.tensor([True]))
        last = logits[:, r - 1]
    np.testing.assert_allclose(last.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    assert int(last.argmax()) == int(want.argmax())
    _assert_cache(caches, whole, "exact", "chunked")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slot,keep_pos", [(0, 7), (1, 3), (1, 100)])
def test_truncate_cache_slot_matches_reference(reference, arch, slot, keep_pos):
    ref, _ = reference[arch]
    c1 = _tree(ref, "c1")
    want = j_truncate_cache_slot({p: {k: jnp.asarray(v.numpy()) for k, v in leaves.items()}
                                  for p, leaves in c1.items()}, j_smoke(arch), slot, keep_pos)
    got = tm.truncate_cache_slot(c1, t_smoke(arch), slot, keep_pos)
    for pos in want:
        for leaf in LEAVES:
            np.testing.assert_array_equal(got[pos][leaf].numpy(), np.asarray(want[pos][leaf]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_len", [4, 32, 8192])
def test_cache_layout_matches_reference(arch, max_len):
    assert tm.cache_layout(t_smoke(arch), max_len) == j_cache_layout(j_smoke(arch), max_len)
    assert tm.cache_layout(get_config(arch), max_len) == j_cache_layout(j_get_config(arch),
                                                                       max_len)


def test_segment_longer_than_the_window_raises(port):
    p = port["gemma2_2b"]
    toks = torch.ones((1, 9), dtype=torch.int32)
    pos = torch.arange(11, 20, dtype=torch.int32)[None]
    caches = {k: {kk: vv[:, :1].clone() for kk, vv in v.items()} for k, v in p["c1"].items()}
    with pytest.raises(ValueError, match="exceeds cache length"):
        tm.segment_step(p["params"], toks, pos, caches, p["cfg"], mode="exact")


def test_int8_kv_cache_and_ssm_snapshots_raise_naming_their_items(port):
    """The int8 KV cache (ROADMAP.md queue 1 item 7b) no longer raises:
    a segment on it writes quantized rows with their exponents, records
    the exponent rows for the rollback, and a commit that rejects every
    row restores the cache bit for bit (JAX's int8 segment:
    tests/test_torch_quantized_kv.py).  SSM snapshots are ported (item
    10, tests/test_torch_ssm.py): on a model without SSM layers a
    snapshot is unused, as in the reference, and the truncation is the
    one without it."""
    p = port["deepseek_7b"]
    cfg = p["cfg"]
    caches = tm.init_caches(cfg, 2, 32, device="cpu", quantized=True)
    tm.prefill_step(p["params"], torch.from_numpy(SEG_PROMPT), caches, cfg, mode="exact")
    before = _clone(caches)
    _, after, aux = tm.segment_step(p["params"], torch.from_numpy(SEG_TOKENS),
                                    torch.from_numpy(SEG_POSITIONS), caches, cfg, mode="exact")
    assert {"k_exp", "v_exp"} <= set(aux["pos0"])
    assert not torch.equal(after["pos0"]["k_exp"], before["pos0"]["k_exp"])
    tm.commit_segment(after, aux, cfg, keep_pos=torch.full((2,), SEG_POSITIONS[0, 0] - 1),
                      keep_count=None, active=torch.ones(2, dtype=torch.bool))
    for name, leaf in before["pos0"].items():
        assert torch.equal(after["pos0"][name], leaf), name
    with_snapshot = tm.truncate_cache_slot(_clone(p["c1"]), p["cfg"], 0, 3, ssm_snapshot={})
    without = tm.truncate_cache_slot(_clone(p["c1"]), p["cfg"], 0, 3)
    for key, node in without.items():
        for name, leaf in node.items():
            assert torch.equal(with_snapshot[key][name], leaf), (key, name)
