"""Drivers and cell building (reference: ``src/repro/launch``): the
``serve`` and ``train`` command lines (``train --mesh`` runs the sharded
train cell), ``mesh`` (the production DeviceMeshes and the H100's
roofline constants), ``steps`` (``build_cell``: a step, its DTensor
arguments placed by the sharding rules, its metadata), ``cost_analysis``
(per-device FLOPs, bytes, collectives and memory of a traced step, in
place of the reference's ``hlo_analysis``) and ``dryrun`` (a cell traced
on a fake process group, with its roofline).

The names below load their module on first use, so ``python -m
repro_torch.launch.<module>`` runs a module that the package has not
imported yet."""

import importlib

_EXPORTS = {
    "HW": "mesh", "make_mesh_by_name": "mesh", "make_production_mesh": "mesh",
    "mesh_shape": "mesh",
    "GRAD_ACCUM": "steps", "SHAPES": "steps", "ShapeCell": "steps", "SkipCell": "steps",
    "build_cell": "steps", "cell_ids": "steps",
    "CostCounter": "cost_analysis", "Costs": "cost_analysis",
    "model_flops": "dryrun", "roofline": "dryrun", "run_cell": "dryrun",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
