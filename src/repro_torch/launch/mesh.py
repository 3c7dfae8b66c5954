"""Production mesh construction.

Reference: ``src/repro/launch/mesh.py:15-39`` — ``make_production_mesh``
and ``make_mesh_by_name`` with the reference's shapes and axis names,
and the card's roofline constants in ``HW``.

The meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects over
the process group that stands (``init_device_mesh``): ``single`` is
(16, 16) over ``data, model``, ``multi`` (2, 16, 16) over ``pod, data,
model``, ``host`` (1, n) over ``data, model`` with n the group's world
size.  Mesh construction is a FUNCTION: importing this module touches no
process-group state.  The dry-run (``launch.dryrun``) opens a fake
process group of the mesh's size first; a real run needs that many
ranks.
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_mesh_by_name", "mesh_shape", "HW"]

#: name -> (shape, axis names); ``host`` is sized at call time
MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


def _device_type() -> str:
    """``cpu`` under a gloo group, else ``cuda``: NCCL, and the fake
    group of the dry-run, which models the card's meshes (its local
    tensors live on ``meta``; a CPU mesh would all-gather where the card
    runs an all-to-all)."""
    import torch.distributed as dist

    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    return _mesh(*MESHES["multi" if multi_pod else "single"])


def make_mesh_by_name(name: str):
    if name in MESHES:
        return _mesh(*MESHES[name])
    if name == "host":  # whatever the process group that stands has (tests)
        import torch.distributed as dist

        return _mesh((1, dist.get_world_size()), ("data", "model"))
    raise ValueError(name)


def mesh_shape(name: str) -> dict:
    """{axis name: size} of a named production mesh, with no process
    group (what ``distributed.sharding.RuleSet`` reads)."""
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


class HW:
    """NVIDIA H100 SXM 80GB roofline constants per card (H100 SXM data
    sheet, dense, no sparsity).  ``LINK_BW`` is one direction of the
    card's NVLink 4 (900 GB/s bidirectional): a 16-wide mesh axis spans
    more than one 8-GPU NVLink node, whose inter-node links are slower,
    so the collective term is optimistic there."""

    PEAK_BF16_FLOPS = 989e12       # FLOP/s, bf16 tensor cores (H100 SXM data sheet, dense)
    PEAK_INT8_OPS = 1979e12        # OP/s, int8 tensor cores (H100 SXM data sheet, dense)
    HBM_BW = 3.35e12               # bytes/s, HBM3 (H100 SXM data sheet)
    LINK_BW = 450e9                # bytes/s, NVLink 4, one direction (H100 SXM data sheet)
    HBM_BYTES = 80e9               # bytes, 80 GB (H100 SXM data sheet)
