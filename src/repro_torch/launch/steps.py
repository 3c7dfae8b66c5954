"""Cell builder: (architecture x input shape x mesh x mode) -> a step
function, its example arguments placed on the mesh, and the cell's
metadata.

Reference: ``src/repro/launch/steps.py:37-380`` — ``SHAPES``,
``ShapeCell``, ``SkipCell``, ``GRAD_ACCUM``, ``cell_ids``,
``build_cell`` and the helpers ``_check_long_context``,
``_batch_specs``, ``_cache_shardings`` (the leaf rules ``:142-168``),
``_serve_ruleset`` and ``_make_constrain``, with the reference's names
and rules.

The reference returns a jitted function and ShapeDtypeStruct inputs;
here ``example_args`` are DTensors on ``meta`` local tensors, placed by
the rules (``distributed.sharding``), and ``step_fn`` is the eager step:
called on them under a fake process group it is the dry-run's trace
(``launch.dryrun``), called on real DTensors it is the production step.
The model's ``constrain`` hook is ``_make_constrain``'s: a
``DTensor.redistribute`` to the reference's layout at each of the
reference's constraint points; on a plain tensor it returns its input.
Training accumulates gradients over ``GRAD_ACCUM`` microbatches in a
loop (the reference's ``lax.scan``) and applies AdamW in place.

Layouts the port reaches differently from the reference: the embedding
lookup of a vocab-sharded table is ``torch.nn.functional.embedding``
(DTensor's masked lookup and all-reduce; ``models.model._embed``); a
microbatch is every ``grad_accum``-th row of the batch (the reference
takes contiguous blocks), so the batch dimension stays sharded through
the split; plain index tensors a step builds (positions, masks,
accumulators) are replicated on the mesh where they meet sharded ones
(``compat.replicated_like``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.compat import is_dtensor
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (
    NamedSharding,
    RuleSet,
    batch_pspec,
    mesh_axis_sizes,
    placements_for,
    serve_rules,
    train_rules,
    tree_shardings,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, init_caches, param_specs, prefill_step, train_loss
from repro_torch.optim.adamw import AdamWConfig, adamw_update, opt_state_specs

__all__ = ["SHAPES", "ShapeCell", "SkipCell", "GRAD_ACCUM", "build_cell", "cell_ids",
           "meta_dtensor", "place", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str       # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train", 4096, 256),
    "prefill_32k": ShapeCell("prefill", 32768, 32),
    "decode_32k": ShapeCell("decode", 32768, 128),
    "long_500k": ShapeCell("decode", 524288, 1),
}


class SkipCell(Exception):
    """Raised when a cell is skipped by the assignment's rules (with the reason)."""


def cell_ids():
    from repro_torch.configs import ARCH_IDS

    return [(a, s) for a in ARCH_IDS for s in SHAPES]


def tree_leaves(tree):
    """Leaves of a tree of dicts (in sorted-key order), tuples and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from tree_leaves(x)
    else:
        yield tree


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def meta_dtensor(shape, dtype, sharding: NamedSharding, requires_grad: bool = False):
    """A DTensor of global ``shape`` placed by ``sharding``, its local
    shard an (unallocated) ``meta`` tensor."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    placements = sharding.placements
    local = list(shape)
    for size, p in zip(mesh.shape, placements):
        if p.is_shard():
            local[p.dim] //= size
    t = DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
                           run_check=False, shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    return t.requires_grad_(True) if requires_grad else t


def place(example, full: torch.Tensor):
    """``full`` (the same global value on every rank) placed as the
    example argument ``example`` is: the production step's real
    argument, on ``full``'s device, requiring grad where ``example``
    does."""
    from torch.distributed.tensor import distribute_tensor

    t = distribute_tensor(full.detach().to(example.dtype), example.device_mesh,
                          example.placements)
    return t.requires_grad_(True) if example.requires_grad else t


def _specs_to_meta(specs, shardings, dtype=None, requires_grad: bool = False):
    return _tree_map(lambda s, sh: meta_dtensor(s.shape, dtype or s.dtype, sh, requires_grad),
                     specs, shardings)


def _make_constrain(rs: RuleSet, batch: int, seq: int):
    sizes = rs.shape
    bspec = batch_pspec(rs, batch, extra_dims=0)
    batch_names = bspec[0]
    seq_axis = rs.rules.get("seq")
    model_size = sizes.get("model", 1)

    from torch.distributed.tensor import Replicate

    def constrain(x, kind):
        if not is_dtensor(x):
            return x
        spec = None
        if isinstance(kind, tuple) and kind[0] == "heads3d":
            # (..., n*d) about to split into n heads: keep a mesh dim's
            # shard of the flat axis only where it divides n
            n = kind[1]
            mesh = x.device_mesh
            pl = [p if not (p.is_shard() and p.dim == x.ndim - 1) or n % size == 0
                  else Replicate() for p, size in zip(x.placements, mesh.shape)]
            return x if pl == list(x.placements) else x.redistribute(mesh, pl)
        if kind == "residual" and x.ndim == 3:
            s_name = (seq_axis if (seq_axis and x.shape[1] % model_size == 0 and x.shape[1] > 1)
                      else None)
            spec = (batch_names, s_name, None)
        elif kind == "moe4d" and x.ndim == 4:
            # (B, E, C, d): batch stays sharded through the gather and experts
            spec = (batch_names, None, None, None)
        elif kind == "moe3d" and x.ndim == 3:
            spec = (batch_names, None, None)
        elif kind == "heads4d" and x.ndim == 4:
            # TP through the mixer: heads over model, the whole sequence a device
            h_name = "model" if x.shape[2] % model_size == 0 else None
            spec = (batch_names, None, h_name, None)
        if spec is None:
            return x
        return x.redistribute(x.device_mesh, placements_for(spec, x.device_mesh.mesh_dim_names))

    return constrain


def _cache_shardings(caches, cfg: ModelConfig, rs: RuleSet, batch: int):
    """The reference's per-leaf cache layout (``steps.py:142-168``): a dict
    tree of NamedSharding for a cache tree (leaves ``(n_periods, B, ...)``)."""
    sizes = rs.shape
    bnames = batch_pspec(rs, batch, extra_dims=0)[0]
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)

    def seq_name(L: int, kv_sharded: bool = True):
        """Sequence sharding of caches: context parallelism (batch axis
        idle -> seq over 'data') and the kv-head fallback (kv heads not
        divisible by 'model' -> seq over 'model')."""
        axes = []
        if bnames is None:
            axes.append("data")
        if not kv_sharded:
            axes.append("model")
        if not axes:
            return None
        size = math.prod(sizes[a] for a in axes)
        if L % size != 0 or L < size:
            if "data" in axes and L % data == 0 and L >= data:
                axes = ["data"]
            else:
                return None
        return axes[0] if len(axes) == 1 else tuple(axes)

    def leaf_spec(name, x):
        nd = x.ndim  # leading axis is n_periods
        if name in ("k", "v"):           # (Pd, B, L, kv, hd)
            kv_ok = x.shape[3] % model == 0
            return (None, bnames, seq_name(x.shape[2], kv_ok), "model" if kv_ok else None, None)
        if name in ("k_exp", "v_exp"):   # (Pd, B, L, KV)
            kv_ok = x.shape[3] % model == 0
            return (None, bnames, seq_name(x.shape[2], kv_ok), "model" if kv_ok else None)
        if name == "pos":                # (Pd, B, L), sharded like k/v's L
            kv_ok = (cfg.n_kv_heads % model == 0) if cfg.n_kv_heads else True
            if cfg.mla is not None:
                kv_ok = False
            return (None, bnames, seq_name(x.shape[2], kv_ok))
        if name in ("ckv", "krope"):     # (Pd, B, L, r): MLA latent, no head dim
            return (None, bnames, seq_name(x.shape[2], False), None)
        if name == "state":              # (Pd, B, nh, ds, hd)
            return (None, bnames, "model" if x.shape[2] % model == 0 else None, None, None)
        if name == "conv":               # (Pd, B, K-1, conv_dim)
            return (None, bnames, None, "model" if x.shape[3] % model == 0 else None)
        return (None,) * nd

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else NamedSharding(rs.mesh, leaf_spec(k, v))
                for k, v in node.items()}

    return walk(caches)


def _check_long_context(cfg: ModelConfig, shape_id: str):
    if shape_id == "long_500k" and not cfg.is_subquadratic:
        raise SkipCell(
            f"{cfg.name}: long_500k skipped — pure full-attention architecture "
            "(assignment: run only for SSM/hybrid/sliding-window archs; see DESIGN.md §4)"
        )


#: microbatch counts for activation-heavy train cells (gradient accumulation)
GRAD_ACCUM = {
    "mixtral-8x22b": 8,
    "jamba-v0.1-52b": 16,
    "command-r-35b": 2,
    "minicpm3-4b": 2,
    "granite-moe-3b-a800m": 2,
    "mamba2-1.3b": 2,
}


def build_cell(arch: str, shape_id: str, mesh, mode: str = "precise", *, fsdp: bool = True,
               remat: bool = True, opt_cfg: Optional[AdamWConfig] = None,
               grad_accum: Optional[int] = None, sharding: str = "default", cfg=None):
    """Returns ``(step_fn, example_args, meta)``.  ``mesh``: a
    ``DeviceMesh``.  ``step_fn(*example_args)`` under a fake process
    group is the dry-run; with real DTensors it is the production step.
    ``cfg`` overrides ``get_config(arch)`` (tests at smoke size)."""
    cfg = cfg or get_config(arch)
    cell = SHAPES[shape_id]
    _check_long_context(cfg, shape_id)

    if cell.kind == "train":
        accum = grad_accum if grad_accum is not None else GRAD_ACCUM.get(cfg.name, 1)
        return _build_train(cfg, cell, mesh, mode, fsdp=fsdp, remat=remat, opt_cfg=opt_cfg,
                            grad_accum=accum, sharding=sharding)
    if cell.kind == "prefill":
        return _build_prefill(cfg, cell, mesh, mode)
    return _build_decode(cfg, cell, mesh, mode)


# ---------------------------------------------------------------------------


def _batch_specs(cfg: ModelConfig, cell: ShapeCell, rs: RuleSet):
    """({name: (shape, dtype)}, {name: NamedSharding}) of a batch."""
    B, S = cell.batch, cell.seq
    toks = ((B, S), torch.int32)
    specs = {"tokens": toks, "labels": toks}
    shard = {
        "tokens": NamedSharding(rs.mesh, batch_pspec(rs, B)),
        "labels": NamedSharding(rs.mesh, batch_pspec(rs, B)),
    }
    if cfg.modality_stub:
        specs["extra_embeds"] = ((B, cfg.stub_prefix_len, cfg.d_model), torch.bfloat16)
        shard["extra_embeds"] = NamedSharding(rs.mesh, batch_pspec(rs, B, extra_dims=2))
    return specs, shard


def _batch_meta(specs, shard):
    return {k: meta_dtensor(*specs[k], shard[k]) for k in specs}


def _meta(cfg, cell, mode, kind, rs):
    return {"arch": cfg.name, "mode": mode, "batch": cell.batch, "seq": cell.seq,
            "kind": kind, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "dropped_rules": rs.dropped}


def _build_train(cfg, cell, mesh, mode, *, fsdp, remat, opt_cfg, grad_accum: int = 1,
                 sharding: str = "default"):
    rs = train_rules(mesh, fsdp=fsdp, pure_fsdp=(sharding == "pure_fsdp"))
    opt_cfg = opt_cfg or AdamWConfig()

    p_specs = param_specs(cfg)
    p_args = _specs_to_meta(p_specs, tree_shardings(p_specs, rs), requires_grad=True)
    o_specs = opt_state_specs(p_specs)
    o_args = _specs_to_meta(o_specs, tree_shardings(o_specs, rs))
    b_args = _batch_meta(*_batch_specs(cfg, cell, rs))
    constrain = _make_constrain(rs, cell.batch, cell.seq)

    def grad_fn(params, batch):
        loss, metrics = train_loss(params, batch, cfg, mode=mode, remat=remat,
                                   constrain=constrain)
        grads = torch.autograd.grad(loss, list(tree_leaves(params)))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            # gradient accumulation: activation memory is one microbatch's;
            # microbatch i is rows i, i + grad_accum, ... (the batch dim
            # stays sharded through the split)
            grads = loss = None
            per = []
            for i in range(grad_accum):
                mb = {k: v.reshape((v.shape[0] // grad_accum, grad_accum) + v.shape[1:])[:, i]
                      for k, v in batch.items()}
                l, m, g = grad_fn(params, mb)
                with torch.no_grad():
                    grads = list(g) if grads is None else [a.add_(b) for a, b in zip(grads, g)]
                loss = l if loss is None else loss + l
                per.append(m)
            with torch.no_grad():
                grads = [g.div_(grad_accum) for g in grads]
            loss = loss / grad_accum
            metrics = {k: sum(m[k] for m in per) / grad_accum for k in per[0]}
        grads = _rebuild(params, iter(grads))
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return step, (p_args, o_args, b_args), _meta(cfg, cell, mode, "train", rs)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def _serve_ruleset(cfg, mesh):
    model = mesh_axis_sizes(mesh).get("model", 1)
    wbytes_dev = 2 * cfg.param_count() / model  # bf16, model-sharded only
    return serve_rules(mesh, weight_fsdp=wbytes_dev > 5 * 2**30)


def _cache_args(cfg, cell, rs, mode):
    caches = init_caches(cfg, cell.batch, cell.seq, device="meta", quantized=(mode == "fast"))
    shard = _cache_shardings(caches, cfg, rs, cell.batch)
    return _tree_map(lambda c, sh: meta_dtensor(c.shape, c.dtype, sh), caches, shard)


def _build_prefill(cfg, cell, mesh, mode):
    rs = _serve_ruleset(cfg, mesh)
    p_specs = param_specs(cfg)
    p_args = _specs_to_meta(p_specs, tree_shardings(p_specs, rs), dtype=torch.bfloat16)
    b_args = _batch_meta(*_batch_specs(cfg, cell, rs))
    constrain = _make_constrain(rs, cell.batch, cell.seq)
    c_args = _cache_args(cfg, cell, rs, mode)

    @torch.no_grad()
    def step(params, tokens, caches, *extra_embeds):
        ee = extra_embeds[0] if extra_embeds else None
        return prefill_step(params, tokens, caches, cfg, mode=mode, extra_embeds=ee,
                            constrain=constrain)

    extra = (b_args["extra_embeds"],) if cfg.modality_stub else ()
    return step, (p_args, b_args["tokens"], c_args) + extra, _meta(cfg, cell, mode, "prefill",
                                                                    rs)


def _build_decode(cfg, cell, mesh, mode):
    rs = _serve_ruleset(cfg, mesh)
    p_specs = param_specs(cfg)
    p_args = _specs_to_meta(p_specs, tree_shardings(p_specs, rs), dtype=torch.bfloat16)
    B = cell.batch
    tok = meta_dtensor((B, 1), torch.int32, NamedSharding(mesh, batch_pspec(rs, B)))
    pos = meta_dtensor((B,), torch.int32, NamedSharding(mesh, batch_pspec(rs, B, extra_dims=0)))
    c_args = _cache_args(cfg, cell, rs, mode)
    constrain = _make_constrain(rs, B, 1)

    @torch.no_grad()
    def step(params, token, position, caches):
        return decode_step(params, token, position, caches, cfg, mode=mode, constrain=constrain)

    return step, (p_args, tok, pos, c_args), _meta(cfg, cell, mode, "decode", rs)
