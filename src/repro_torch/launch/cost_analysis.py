"""Per-device costs of a traced step: FLOPs, bytes, collectives, memory.

Reference: ``src/repro/launch/hlo_analysis.py`` — ``analyze_hlo`` walks
the compiled HLO text of a JAX step and returns ``HloCosts`` (``:89-128``:
``flops``, ``bytes``, ``collective_bytes`` and ``collective_counts`` by
type, ``total_collective_bytes``, ``as_dict``), all per device.
PyTorch has no HLO: the port counts the step while it RUNS, on ``meta``
tensors, under :class:`CostCounter`, a ``TorchDispatchMode`` that stands
below DTensor.  It declines DTensor operations (a mode above DTensor
would see the GLOBAL operation: a (16, 16) mesh's product counted 256
times over), so it sees what each device runs — the local operations on
the shards and the collectives DTensor issues — once, as the reference's
per-device SPMD program does:

* ``flops`` — ``torch.utils.flop_counter``'s count of every matmul-like
  operation on its local shapes, plus the contract's operations of every
  hand-written kernel a wrapper was called with on a meta tensor
  (``compat.meta_kernel``: K1-K5 count their own work, never their plain
  version's);
* ``bytes`` — operand and result bytes of every operation that moves
  memory (views, aliases and allocations move none), plus each kernel's
  contract bytes.  PyTorch runs eagerly, so there is no fusion: every
  intermediate counts, where the reference counts XLA's fused ops;
* ``collective_bytes`` / ``collective_counts`` — the output bytes and the
  number of each collective (all-gather, all-reduce, reduce-scatter,
  all-to-all, broadcast), the reference's ``_shape_bytes(op.shape)``;
* ``peak_bytes`` — the most bytes the trace held live at once (each
  operation's fresh outputs, freed when PyTorch frees them); and
  ``argument_bytes``, the local bytes of the step's arguments.

There are no loop trip counts to multiply: eager PyTorch runs every
iteration.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import compat

__all__ = ["Costs", "CostCounter", "COLLECTIVE_OPS", "tensor_bytes"]

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "broadcast")

#: collective op name stems (``_c10d_functional`` and ``c10d``) -> type
_COLLECTIVES = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("broadcast", "broadcast"),
    ("shard_dim_alltoall", "all-to-all"),
)
#: DTensor's own shard-to-shard all-to-all is an op of ``_dtensor``
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")
#: operations that move no bytes: allocations without a fill, metadata
_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
         "alias", "lift_fresh", "_to_copy_meta", "wait_tensor", "_wrap_tensor_autograd",
         "set_", "resize_", "record_stream", "_local_scalar_dense"}


def tensor_bytes(t) -> int:
    """Local bytes of a tensor (a DTensor's shard)."""
    if compat.is_dtensor(t):
        t = t.to_local()
    return t.numel() * t.element_size()


@dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    peak_bytes: float = 0.0
    argument_bytes: float = 0.0
    kernel_calls: Dict[str, int] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def total_collective_count(self) -> float:
        return sum(self.collective_counts.values())

    def scaled(self, k: float) -> "Costs":
        return Costs(self.flops * k, self.bytes * k,
                     {o: b * k for o, b in self.collective_bytes.items()},
                     {o: c * k for o, c in self.collective_counts.items()},
                     self.peak_bytes, self.argument_bytes, dict(self.kernel_calls))

    def add(self, other: "Costs") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        for o, b in other.collective_bytes.items():
            self.collective_bytes[o] = self.collective_bytes.get(o, 0.0) + b
        for o, c in other.collective_counts.items():
            self.collective_counts[o] = self.collective_counts.get(o, 0.0) + c

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "total_collective_count": self.total_collective_count,
            "peak_bytes": self.peak_bytes,
            "argument_bytes": self.argument_bytes,
            "kernel_calls": dict(self.kernel_calls),
        }


def _collective(func) -> str:
    ns = func.namespace
    if ns not in _COLLECTIVE_NAMESPACES:
        return ""
    name = func._opname
    for stem, kind in _COLLECTIVES:
        if name.startswith(stem) or name.startswith("_" + stem):
            return kind
    return ""


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


class CostCounter(TorchDispatchMode):
    """Counts the local work of what runs inside it into ``self.costs``
    (see the module docstring).  DTensor operations are declined, so
    DTensor runs them and the counter sees their local parts; DTensor's
    own shape propagation (fake tensors) is not counted."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._live = 0
        self._sink = self._kernel

    def _kernel(self, name: str, ops: float, nbytes: float) -> None:
        self.costs.flops += ops
        self.costs.bytes += nbytes
        self.costs.kernel_calls[name] = self.costs.kernel_calls.get(name, 0) + 1

    def __enter__(self):
        compat.COST_SINKS.append(self._sink)
        return super().__enter__()

    def __exit__(self, *exc):
        compat.COST_SINKS.remove(self._sink)
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self._live += n
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live)

        def free(counter=self, n=n):
            counter._live -= n

        weakref.finalize(t, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(compat.is_dtensor(t) for t in _tensors((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if any(_is_fake(t) for t in ins + outs):
            return out
        c = self.costs
        kind = _collective(func)
        if kind:
            b = float(sum(t.numel() * t.element_size() for t in outs))
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + b
            c.collective_counts[kind] = c.collective_counts.get(kind, 0.0) + 1
            c.bytes += b
            return out
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        schema = func._schema
        aliases = [r.alias_info is not None for r in schema.returns]
        if func._opname not in _FREE and not (aliases and all(aliases)
                                              and not schema.is_mutable):
            c.bytes += float(sum(t.numel() * t.element_size() for t in ins + outs))
        if not any(aliases):
            for t in outs:
                self._track(t)
        return out
