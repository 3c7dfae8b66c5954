"""One gloo rank of the port's data-parallel tests
(tests/test_torch_grad_compress.py).

Usage: python tests/_torch_dist_child.py MODE RANK WORLD PORT OUT.npz [JAX.npz]

``gc``: ``compressed_mean`` of rank RANK's slice of the reference test's
gradients (``default_rng(0)``, ``GC_SHAPE``) over WORLD ranks, two rounds
of error feedback; writes the means, residuals, the first round's int8
payload and exponent, and the payload dtypes and wire bytes.
``dp``: ``make_dp_train_step`` of gemma2's smoke model at ``"precise"``
on a ("data",) mesh of WORLD ranks, from the parameters and batch of
the JAX child's ``dp`` records (rank r takes rows [r B/W, (r+1) B/W)),
one step for each ``compress_bits`` of ``DP_BITS``; writes the loss, the
grad norm, the parameters and residuals after each step, each leaf's
payload exponent, and the wire bytes and payload dtypes.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

GC_SHAPE = (8, 64, 33)
DP_OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10}
DP_BITS = (8, None)


def _flat(tree, prefix, out):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _flat(tree[k], f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = tree[k].detach().numpy()


def _unflatten(rec, prefix):
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


def gc(rank, world, out):
    from repro_torch.optim.grad_compress import compressed_mean

    g = np.random.default_rng(0).normal(0, 1, GC_SHAPE).astype(np.float32)[rank]
    res = {"w": torch.zeros(g.shape)}
    rec = {}
    for rnd in (1, 2):
        stats = {}
        mean, res = compressed_mean({"w": torch.from_numpy(g.copy())}, res,
                                    dist.group.WORLD, world, 8, stats=stats, record=("w",))
        rec[f"mean{rnd}"] = mean["w"].numpy().copy()
        rec[f"res{rnd}"] = res["w"].numpy().copy()
        if rnd == 1:
            r = stats["records"]["w"]
            rec["q1"], rec["e1"] = r["q"].numpy(), r["e"].numpy()
            rec["wire_bytes"] = np.asarray(stats["wire_bytes"])
            rec["padded_numel"] = np.asarray(stats["padded_numel"])
            rec["dtypes"] = np.asarray(sorted(stats["payload_dtypes"]))
    np.savez(out, **rec)


def dp(rank, world, out, jax_npz):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import smoke
    from repro_torch.convert import params_from_jax
    from repro_torch.optim import AdamWConfig, init_opt_state, make_dp_train_step

    cfg = smoke("gemma2_2b")
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    with np.load(jax_npz) as f:
        recs = {k: f[k] for k in f.files if k.startswith("dp/param/") or k.startswith("dp/batch/")}
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _unflatten(recs, "dp/batch/").items()}
    rows = batch["tokens"].shape[0] // world
    batch = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
    rec = {}
    for bits in DP_BITS:
        params = params_from_jax(_unflatten(recs, "dp/param/"), device="cpu")
        leaves = []
        _collect(params, leaves)
        for t in leaves:
            t.requires_grad_(True)
        res = _zeros_like(params)
        paths = []
        _paths(params, "", paths)
        step = make_dp_train_step(cfg, AdamWConfig(**DP_OPT), mesh, compress_bits=bits,
                                  mode="precise", record=tuple(paths) if bits else ())
        params, _, res, metrics = step(params, init_opt_state(params), res, batch)
        key = f"{bits if bits is not None else 'none'}"
        rec[f"{key}/loss"] = metrics["loss"].numpy()
        rec[f"{key}/grad_norm"] = metrics["grad_norm"].numpy()
        _flat(params, f"{key}/param", rec)
        _flat(res, f"{key}/res", rec)
        rec[f"{key}/wire_bytes"] = np.asarray(step.stats.get("wire_bytes", 0))
        rec[f"{key}/dtypes"] = np.asarray(sorted(step.stats.get("payload_dtypes", ())))
        for path, r in step.stats.get("records", {}).items():
            rec[f"{key}/exp/{path}"] = r["e"].numpy()
    np.savez(out, **rec)


def _collect(tree, out):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _collect(tree[k], out)
        else:
            out.append(tree[k])


def _paths(tree, prefix, out):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _paths(tree[k], f"{prefix}{k}/", out)
        else:
            out.append(prefix + k)


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros(v.shape)
            for k, v in tree.items()}


def main(mode, rank, world, port, out, jax_npz=None):
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        if mode == "gc":
            gc(rank, world, out)
        else:
            dp(rank, world, out, jax_npz)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
