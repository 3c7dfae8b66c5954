"""``train_loss`` and its gradients against the JAX package, every arch of
``ARCH_IDS`` at smoke size.

JAX runs in child processes (``tests/_torch_jax_child.py OUT ARCHS
train``, ``--xla_allow_excess_precision=false``; four of them, started
once for this module and tests/test_torch_stubs.py): each writes its
archs' parameters, the batch of ``tests/test_arch_smoke.py::make_batch``
(B = 2, S = 32, ``extra_embeds`` for the modality stubs) and
``jax.value_and_grad(train_loss)`` at ``"precise"`` and, for
deepseek_7b, granite_moe_3b_a800m and mamba2_1_3b, at ``"fast"`` (the
reference's ``test_fast_mode_smoke`` archs).  The port runs the same
parameters and batch through ``train_loss`` (remat on, as the
reference's default) and ``torch.autograd.grad``.

Tolerances:

* loss and every metric: relative 1e-3 (``tokens`` exact: 64, as
  ``test_train_step_smoke`` pins);
* every gradient leaf: ``||g_port - g_jax|| <= GRAD_TOL * ||g_jax||``.
  Both sides compute bf16 products (the precise rung) or int8 products
  with bf16 outputs (the FAST rung), summed in other orders, and the
  reference's backward rounds its bf16 cotangents where the port keeps
  f32, so a leaf differs by a few bf16 ulps of its norm.
  jamba_v01_52b is held to JAMBA_GRAD_TOL: its bf16 gradients are
  ill-conditioned in the reference itself.  Two compilations of the
  same JAX step (XLA's excess precision on, and off as the child runs
  it) differ by 0.10-2.7 of the norm per leaf, with losses 5.5083 and
  5.4667; the port lies within 0.144 of the child's (worst leaf:
  ``periods/pos1/mixer/wB``) and its loss within 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_child import TRAIN_GROUPS, TRAIN_MODES, start_shared, wait_shared  # noqa: E402
from repro_torch.configs import ARCH_IDS, smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import train_loss  # noqa: E402

LOSS_RTOL = 1e-3
GRAD_TOL = 5e-2
JAMBA_GRAD_TOL = 0.15
CASES = [(arch, mode) for arch in ARCH_IDS for mode in TRAIN_MODES.get(arch, ("precise",))]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_child(request, tmp_path_factory):
    return start_shared(request, tmp_path_factory)


def records(jax_child, arch):
    """{key without the arch prefix: array} of the child that ran ``arch``."""
    group = next(g for g in TRAIN_GROUPS if arch in g.split(","))
    with np.load(wait_shared(jax_child, group, "train")) as f:
        return {k[len(arch) + 1:]: f[k] for k in f.files if k.startswith(arch + "/")}


def unflatten(rec, prefix):
    out = {}
    for key, val in rec.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def flat_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def port_train(rec, cfg, mode):
    """(loss, metrics, {leaf path: grad}) of the port on JAX's parameters."""
    params = params_from_jax(unflatten(rec, "param/"), device="cpu")
    leaves = dict(flat_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in unflatten(rec, "batch/").items()}
    loss, metrics = train_loss(params, batch, cfg, mode=mode)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("arch,mode", CASES)
def test_train_loss_and_grads_match_jax(jax_child, arch, mode):
    rec = records(jax_child, arch)
    cfg = smoke(arch)
    loss, metrics, grads = port_train(rec, cfg, mode)
    want = rec[f"train/{mode}/loss"]
    np.testing.assert_allclose(float(loss.detach()), want, rtol=LOSS_RTOL)
    want_metrics = unflatten(rec, f"train/{mode}/metrics/")
    assert set(metrics) == set(want_metrics)
    assert float(metrics["tokens"]) == 64.0
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), v, rtol=LOSS_RTOL, err_msg=k)
    want_grads = dict(flat_leaves(unflatten(rec, f"train/{mode}/grad/")))
    assert set(grads) == set(want_grads)
    worst = {}
    for name, g in grads.items():
        w = want_grads[name].astype(np.float64)
        diff = np.linalg.norm(g.detach().double().numpy() - w)
        worst[name] = diff / max(np.linalg.norm(w), 1e-30)
    tol = JAMBA_GRAD_TOL if arch == "jamba_v01_52b" else GRAD_TOL
    bad = {k: v for k, v in worst.items() if v > tol}
    assert not bad, (arch, mode, bad)
