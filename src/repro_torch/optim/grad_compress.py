"""Q-format gradient compression for the data-parallel reduction, and the
data-parallel train step that uses it.

Reference: ``src/repro/optim/grad_compress.py:36-130`` —
``_compress_leaf``, ``compressed_mean`` and ``make_dp_train_step``.  The
reference runs inside ``shard_map`` over the mesh's ``data`` axis; here
every rank runs the step on its own batch shard and the leaves meet in
``torch.distributed`` collectives over the mesh's ``data`` group.

A plain f32 ring all-reduce moves about 2 x 4 bytes an element a
device.  The compressed reducer moves int8 payloads, one leaf at a time:

    g + residual -> pad to a multiple of n_dev -> global amax (all_reduce MAX)
      -> pow2 exponent e -> int8 payload q (half-to-even rounding)
      -> all_to_all_single (each rank owns 1/n of the vector)
      -> exact int32 sum -> requantize by the shift ceil(log2 n_dev)
      -> int8 all-gather -> times 2**(e + shift) / n_dev

Wire bytes: 2 x numel a device (the two int8 payloads), against 8 x
numel for the f32 ring.  Error feedback keeps the local quantization
error, ``g + r - q 2**e``, as the next step's residual (EF-SGD).

The exponent is ``core.quantization.pow2_exponent`` (the reference's f32
``log2`` form); the scales are exact powers of two (the reference's XLA
``exp2`` is a few ulp off on the CPU).  To fit a full-size model on one
card, ``compressed_mean`` works one leaf at a time and IN PLACE: the
residual leaf becomes ``g + r`` and then the new residual, and an f32
gradient leaf becomes the mean.  The reference is plain JAX, not a
Pallas kernel, and so is this module plain PyTorch.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.quantization import pow2_exponent

__all__ = ["compressed_mean", "make_dp_train_step", "tree_paths"]


def tree_paths(tree, prefix: str = ""):
    """(``a/b/c`` path, leaf) pairs of a dict tree in sorted-key order
    (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    # ``all_gather_single`` where this torch has it (it deprecates the other)
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _compress_leaf(g: torch.Tensor, r: torch.Tensor, group, n_dev: int, bits: int,
                   stats: Optional[dict], record: Optional[dict]) -> torch.Tensor:
    """One leaf: ``r`` becomes the new residual in place; returns the mean
    (written into ``g`` when ``g`` is f32)."""
    f32 = torch.float32
    r.add_(g.to(f32))                                       # g + r, in place
    n = r.numel()
    pad = -n % n_dev
    flat = r.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    amax = torch.linalg.vector_norm(flat, float("inf")).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    e = pow2_exponent(amax[0], bits)
    qmax = 2 ** (bits - 1) - 1
    if record is not None:
        record["g32"] = flat[:n].clone()
        record["e"] = e.clone()
    # x = (g + r) 2**-e exactly; q = round(x) (half to even); the error
    # (x - q) 2**e is exact too (|x - q| <= 1/2 within a factor 2 of x),
    # so it equals the reference's g + r - q 2**e bit for bit
    flat.mul_(torch.exp2(-e.to(f32)))
    q = torch.clamp(torch.round(flat), -qmax - 1, qmax).to(torch.int8)
    flat.sub_(q).mul_(torch.exp2(e.to(f32)))
    if pad:
        r.view(-1).copy_(flat[:n])
    del flat
    if record is not None:
        record["q"] = q.clone()

    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)           # int8 on the wire
    del q
    local_sum = recv.view(n_dev, -1).to(torch.int32).sum(dim=0)   # exact
    del recv
    # the sum is in units of 2**e: requantizing is a relative shift
    shift = int(math.ceil(math.log2(n_dev)))
    q2 = torch.clamp(torch.round(local_sum.to(f32) * (2.0 ** -shift)), -qmax - 1,
                     qmax).to(torch.int8)
    del local_sum
    gathered = torch.empty(q2.numel() * n_dev, dtype=torch.int8, device=q2.device)
    _all_gather(gathered, q2, group)                        # int8 on the wire
    if stats is not None:
        stats["wire_bytes"] = stats.get("wire_bytes", 0) + gathered.numel() * 2
        stats["padded_numel"] = stats.get("padded_numel", 0) + gathered.numel()
        stats.setdefault("payload_dtypes", set()).update({str(q2.dtype), str(gathered.dtype)})
    factor = torch.exp2((e + shift).to(f32)) / n_dev
    mean = g if g.dtype == f32 else torch.empty(g.shape, dtype=f32, device=g.device)
    mean.view(-1).copy_(gathered[:n])
    mean.mul_(factor)
    if record is not None:
        record["mean"] = mean.reshape(-1).clone()
        record["res"] = r.reshape(-1).clone()
    return mean


def compressed_mean(grads: dict, residuals: dict, group, n_dev: int, bits: int = 8, *,
                    stats: Optional[dict] = None, record: Sequence[str] = ()):
    """Leaf-wise compressed data-parallel mean with error feedback over
    the ``torch.distributed`` group ``group`` of ``n_dev`` ranks.

    ``grads`` / ``residuals``: dict trees of one structure (residuals f32,
    zeros at the start).  Returns ``(mean_grads, residuals)``: the
    residual leaves are updated in place, f32 gradient leaves hold the
    mean in place.  ``stats`` (a dict) accumulates ``wire_bytes`` (both
    int8 payloads), ``padded_numel`` and ``payload_dtypes``; for each
    leaf path in ``record`` it also keeps ``stats["records"][path]`` =
    ``{"g32": g + r, "q": the int8 payload, "e": the exponent, "mean",
    "res": the new residual}`` (flat copies)."""
    if record and stats is None:
        raise ValueError("compressed_mean: record= needs stats=")
    res = dict(tree_paths(residuals))
    means = {}
    for path, g in tree_paths(grads):
        rec = None
        if path in record:
            rec = stats.setdefault("records", {}).setdefault(path, {})
        means[path] = _compress_leaf(g, res[path], group, n_dev, bits, stats, rec)
    return _unflatten(grads, means), residuals


def _unflatten(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], flat, f"{prefix}{k}/") for k in tree}
    return flat[prefix[:-1]]


def make_dp_train_step(cfg, opt_cfg, mesh, *, compress_bits: Optional[int] = 8,
                       mode: str = "precise", record: Sequence[str] = ()):
    """Data-parallel train step over the ``data`` dimension of ``mesh``
    (a ``DeviceMesh``) with the explicit, optionally compressed gradient
    reduction.

    Returns ``step(params, opt_state, residuals, batch) -> (params,
    opt_state, residuals, metrics)``, computed locally on each rank from
    its own batch shard: ``train_loss`` and its gradients, the compressed
    mean (``compress_bits=None``: an f32 all-reduce sum divided by the
    group size, the reference's ``pmean``; gloo has no AVG), AdamW in
    place, and ``loss`` averaged over the group (the other metrics are the
    rank's own, as the reference's replicated outputs are device 0's).
    Parameters are replicated (pure DP) and every leaf must require grad.
    ``step.stats`` holds the last step's ``wire_bytes``,
    ``padded_numel``, ``payload_dtypes``, ``compress_s`` and the
    ``records`` of the leaves named in ``record``."""
    from repro_torch.models.model import train_loss
    from repro_torch.optim.adamw import adamw_update

    group = mesh.get_group("data")
    n_dev = mesh.size(list(mesh.mesh_dim_names).index("data"))

    def step(params, opt_state, residuals, batch):
        loss, metrics = train_loss(params, batch, cfg, mode=mode)
        paths, leaves = zip(*tree_paths(params))
        grads = _unflatten(params, dict(zip(paths, torch.autograd.grad(loss, list(leaves)))))
        stats: dict = {}
        sync = torch.cuda.synchronize if loss.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            if compress_bits is not None:
                grads, residuals = compressed_mean(grads, residuals, group, n_dev,
                                                   compress_bits, stats=stats, record=record)
            else:
                for _, g in tree_paths(grads):
                    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
                    g.div_(n_dev)
            sync()
            stats["compress_s"] = time.perf_counter() - t0
            params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
            del grads
            loss_mean = loss.detach().clone()
            dist.all_reduce(loss_mean, op=dist.ReduceOp.SUM, group=group)
            loss_mean /= n_dev
        step.stats = stats
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, residuals, dict(metrics, loss=loss_mean, **om)

    step.stats = {}
    return step
