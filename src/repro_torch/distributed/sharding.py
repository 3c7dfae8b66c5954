"""Logical-axis sharding rules (MaxText-style), with auto-drop.

Reference: ``src/repro/distributed/sharding.py:36-153`` — ``RuleSet``,
``train_rules``, ``serve_rules``, ``spec_sharding``, ``tree_shardings``
and ``batch_pspec``, rule for rule.

Models declare *logical* axes on every parameter dimension ('embed',
'heads', 'mlp', 'vocab', 'expert', 'ssm', ...); a ``RuleSet`` maps them
to mesh axes per deployment (TRAIN: data parallel over (pod, data),
tensor parallel over model, FSDP 'embed' -> data; SERVE: weights
replicated over data but for the MoE 'expert' axis).  A dimension not
divisible by its mapped mesh axes' size is not sharded (auto-drop), and
the drop is recorded in ``dropped`` for the dry-run report.

``RuleSet.resolve`` returns the reference's per-dimension mapping as a
plain tuple (``None``, a mesh-axis name, or a tuple of names: a JAX
``PartitionSpec``'s entries).  The rule set needs only the mesh's
SHAPE, ``{axis name: size}``, so the rules of the 256- and 512-device
meshes can be resolved with no process group; a ``DeviceMesh`` works
too.  ``spec_sharding`` turns a resolved mapping into DTensor
placements on a ``DeviceMesh``: one ``Shard(d)`` or ``Replicate()`` per
mesh dimension; a tensor dimension mapped to two mesh axes gets
``Shard(d)`` on both, which DTensor splits in mesh-dimension order —
the reference's major-to-minor order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.models.layers import Spec

__all__ = ["RuleSet", "NamedSharding", "train_rules", "serve_rules", "spec_sharding",
           "tree_shardings", "batch_pspec", "placements_for", "mesh_axis_sizes"]

AxisMap = Union[None, str, Tuple[str, ...]]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping already."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class RuleSet:
    rules: Dict[str, AxisMap]
    mesh: object                     # a DeviceMesh, or {axis name: size}
    dropped: list = dataclasses.field(default_factory=list)

    @property
    def shape(self) -> Dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    def _axis_size(self, names: Tuple[str, ...]) -> int:
        shape = self.shape
        return math.prod(shape[n] for n in names)

    def resolve(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> tuple:
        mesh_shape = self.shape
        out = []
        used = set()
        for dim, ax in zip(shape, axes):
            mapped = self.rules.get(ax) if ax is not None else None
            if mapped is None:
                out.append(None)
                continue
            names = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            names = tuple(n for n in names if n in mesh_shape and n not in used)
            if not names or dim % self._axis_size(names) != 0:
                if names:
                    self.dropped.append((ax, tuple(shape), names))
                out.append(None)
                continue
            used.update(names)
            out.append(names[0] if len(names) == 1 else names)
        return tuple(out)


def train_rules(mesh, fsdp: bool = True, pure_fsdp: bool = False) -> RuleSet:
    """Default: TP over 'model' + FSDP over 'data' (Megatron-style 2D).
    ``pure_fsdp``: no tensor parallelism, every mesh axis data parallel,
    parameters and optimizer state sharded over all axes (ZeRO-3)."""
    if pure_fsdp:
        return RuleSet(
            rules={
                "batch": ("pod", "data", "model"),
                "embed": ("data", "model"),
                "heads": None,
                "kv": None,
                "mlp": None,
                "vocab": None,
                "expert": None,
                "ssm": None,
                "seq": None,
                "layer": None,
            },
            mesh=mesh,
        )
    return RuleSet(
        rules={
            "batch": ("pod", "data"),
            "embed": "data" if fsdp else None,
            "heads": "model",
            "kv": "model",
            "mlp": "model",
            "vocab": "model",
            "expert": None,        # TP within an expert
            "ssm": "model",
            "seq": "model",        # SP on residuals between periods
            "layer": None,
        },
        mesh=mesh,
    )


def serve_rules(mesh, expert_data_shard: bool = True, weight_fsdp: bool = False) -> RuleSet:
    """``weight_fsdp`` shards the 'embed' dim of weights over data, for
    models whose bf16 weights exceed a device under model sharding
    alone."""
    return RuleSet(
        rules={
            "batch": ("pod", "data"),
            "embed": "data" if weight_fsdp else None,
            "heads": "model",
            "kv": "model",
            "mlp": "model",
            "vocab": "model",
            "expert": ("pod", "data") if expert_data_shard else None,
            "ssm": "model",
            "seq": None,
            "layer": None,
        },
        mesh=mesh,
    )


def placements_for(spec: Sequence[AxisMap], mesh_names: Sequence[str]) -> tuple:
    """DTensor placements of a resolved mapping: for each mesh dimension,
    ``Shard(d)`` for the tensor dimension ``d`` mapped to it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [mesh_names.index(n) for n in names]
        if order != sorted(order):
            raise ValueError(f"mesh axes {names} of dim {d} are not in mesh order {mesh_names}")
        for n in names:
            by_axis[n] = d
    return tuple(Shard(by_axis[n]) if n in by_axis else Replicate() for n in mesh_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved mapping on a ``DeviceMesh`` (JAX's ``NamedSharding``)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, tuple(self.mesh.mesh_dim_names))


def spec_sharding(spec: Spec, rs: RuleSet) -> NamedSharding:
    return NamedSharding(rs.mesh, rs.resolve(spec.axes, spec.shape))


def tree_shardings(specs, rs: RuleSet):
    """dict tree of Spec -> dict tree of NamedSharding, resolved leaf by
    leaf in ``jax.tree`` order (sorted keys; an OptState's fields in
    order), so ``rs.dropped`` lists the drops as the reference's does."""
    if isinstance(specs, Spec):
        return spec_sharding(specs, rs)
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):      # OptState
        return type(specs)(*(tree_shardings(s, rs) for s in specs))
    return {k: tree_shardings(specs[k], rs) for k in sorted(specs)}


def batch_pspec(rs: RuleSet, batch_size: int, extra_dims: int = 1) -> tuple:
    """Mapping of a (B, ...) array: batch over (pod, data) with auto-drop
    for small batches (long_500k B=1 -> replicated)."""
    shape = rs.shape
    names = tuple(n for n in ("pod", "data") if n in shape)
    if not names or batch_size % math.prod(shape[n] for n in names) != 0:
        # try data alone before giving up
        if "data" in shape and batch_size % shape["data"] == 0:
            names = ("data",)
        else:
            return (None,) * (1 + extra_dims)
    spec = names if len(names) > 1 else names[0]
    return (spec,) + (None,) * extra_dims
