"""Runtime precision ladder — the paper's C4 engine (§4), generalised.

Reference: ``src/repro/core/precision.py``.  Ported: the level registry
(``q8_8 < q16_16 < q8_24 < f32``), :class:`PrecisionLevel`,
:func:`resolve_level`, the ``Mode`` compat aliases,
:class:`PrecisionPolicy` (per-op level overrides) and
:class:`MathEngine` with ``register``, ``call``, ``set_level``,
``set_policy``, ``at`` (a level or a policy), ``compile_op``, ``weight_cache``,
``invalidate_weights`` and ``switched``.

``switched`` has no ``lax.switch`` to build here: PyTorch runs eagerly,
so it returns the per-level TABLE of callables, indexed by an int —
``table[level_idx](*args)`` — which is what the serving loop dispatches
through.  ``call`` resolves the op's level through the active policy
(per-op override, else the policy's default, else the engine's level)
and the ladder fallback, as the reference's context tables do; the
immutable ``PrecisionContext`` objects themselves are not carried over.

``_default_ops`` registers the reference's whole op set, ``OP_SET``:
``mul``/``add``/``sub`` (Q-format core), ``sin``/``cos`` (kernel K3),
``matmul`` (C3: ``core.linalg.qmatmul_deferred`` on Q16.16 words at
``q16_16`` — the hand-written deferred-correction kernel on a CUDA
tensor — and ``matmul_float`` at ``f32``), and the universal family at
the float boundary — ``atan2`` (K6, with a ``q8_24`` rung), ``div``
(K7), ``sqrt``/``exp``/``log``/``tanh``/``sigmoid`` (K5).  On CUDA
tensors the fixed rungs launch those kernels; the ``f32`` rung is the
torch function.

``compile_op`` keeps the reference's name and role (every path ready
before the first switch), but eager PyTorch has nothing to lower ahead
of time: it runs each given implementation once on the example
arguments, which builds (and loads) every kernel the op reaches, and
then registers the implementations.
"""

from __future__ import annotations

import contextlib
import enum
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.barrier import TwoPhaseBarrier
from repro_torch.core.qformat import Q8_8, Q8_24, Q16_16, QFormat

__all__ = [
    "Mode",
    "OP_SET",
    "PrecisionLevel",
    "PrecisionPolicy",
    "MathEngine",
    "SwitchStats",
    "register_level",
    "level",
    "ladder",
    "ladder_names",
    "resolve_level",
    "MODE_ALIASES",
]


class Mode(str, enum.Enum):
    """Paper §4.2: m in {FAST, PRECISE} — compat aliases into the ladder."""

    FAST = "fast"
    PRECISE = "precise"


@dataclass(frozen=True)
class PrecisionLevel:
    """One rung: a name bound to a fixed-point format or a float dtype."""

    name: str
    qformat: Optional[QFormat] = None
    dtype: Any = None
    description: str = ""

    @property
    def is_fixed(self) -> bool:
        return self.qformat is not None

    @property
    def mode(self) -> Mode:
        return Mode.FAST if self.is_fixed else Mode.PRECISE


#: The paper's operation set F (Eq. 19), extended with the universal-
#: CORDIC family and the linear-vectoring division (the reference's).
OP_SET = (
    "mul", "add", "sub", "sin", "cos", "matmul",
    "atan2", "sqrt", "exp", "log", "tanh", "sigmoid", "div",
)

_LEVELS: Dict[str, PrecisionLevel] = {}
MODE_ALIASES: Dict[Mode, str] = {Mode.FAST: "q16_16", Mode.PRECISE: "f32"}


def register_level(lvl: PrecisionLevel, *, index: Optional[int] = None) -> PrecisionLevel:
    """Add (or replace) a named level; ``index`` inserts mid-ladder."""
    if lvl.name in _LEVELS or index is None:
        _LEVELS[lvl.name] = lvl
        return lvl
    items = list(_LEVELS.items())
    items.insert(index, (lvl.name, lvl))
    _LEVELS.clear()
    _LEVELS.update(items)
    return lvl


def level(name: str) -> PrecisionLevel:
    return _LEVELS[name]


def ladder() -> Tuple[PrecisionLevel, ...]:
    return tuple(_LEVELS.values())


def ladder_names() -> Tuple[str, ...]:
    return tuple(_LEVELS)


LevelSpec = Union[PrecisionLevel, Mode, str]


def resolve_level(spec: LevelSpec) -> PrecisionLevel:
    """PrecisionLevel | Mode | level name | 'fast'/'precise' -> level."""
    if isinstance(spec, PrecisionLevel):
        return spec
    if isinstance(spec, Mode):
        return _LEVELS[MODE_ALIASES[spec]]
    if isinstance(spec, str):
        if spec in _LEVELS:
            return _LEVELS[spec]
        try:
            return _LEVELS[MODE_ALIASES[Mode(spec)]]
        except ValueError:
            raise KeyError(f"unknown precision level {spec!r}; have {ladder_names()}") from None
    raise TypeError(f"cannot resolve precision level from {spec!r}")


register_level(PrecisionLevel("q8_8", qformat=Q8_8, description="int16 activations"))
register_level(PrecisionLevel("q16_16", qformat=Q16_16, description="paper Q16.16"))
register_level(PrecisionLevel("q8_24", qformat=Q8_24, description="high-precision angle"))
register_level(PrecisionLevel("f32", dtype=torch.float32, description="IEEE 754 binary32"))


@dataclass(frozen=True)
class PrecisionPolicy:
    """op -> level overrides on top of a default level.

    ``default`` None means "the engine's current level" — the policy then
    only pins the listed ops.  Hashable: ``per_op`` is normalised to a
    sorted tuple of (op, level name) at construction."""

    default: Optional[str] = None
    per_op: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.default is not None:
            object.__setattr__(self, "default", resolve_level(self.default).name)
        items = self.per_op.items() if isinstance(self.per_op, Mapping) else self.per_op
        norm = tuple(sorted((op, resolve_level(lv).name) for op, lv in items))
        object.__setattr__(self, "per_op", norm)

    def level_for(self, op: str, fallback: str) -> str:
        for name, lv in self.per_op:
            if name == op:
                return lv
        return self.default if self.default is not None else fallback

    def __contains__(self, op: str) -> bool:
        return any(name == op for name, _ in self.per_op)


@dataclass
class SwitchStats:
    count: int = 0
    last_latency_us: float = 0.0
    total_latency_us: float = 0.0
    history: list = field(default_factory=list)


class MathEngine:
    """Paper §4.4 public API, ladder edition (see module docstring)."""

    def __init__(self, level: LevelSpec = Mode.PRECISE, *,
                 barrier: Optional[TwoPhaseBarrier] = None,
                 policy: Optional[PrecisionPolicy] = None):
        self._impls: Dict[str, Dict[str, Callable]] = {}
        self._level = resolve_level(level)
        self._policy = policy
        self._barrier = barrier or TwoPhaseBarrier()
        self._lock = threading.RLock()
        self._inflight: Any = None
        self._weight_cache = None
        self.switch_stats = SwitchStats()
        self._default_ops()

    # -- registration -----------------------------------------------------

    def _default_ops(self):
        from repro_torch.core import cordic, linalg, qformat
        from repro_torch.kernels.cordic import ops

        self.register(
            "mul",
            q8_8=partial(qformat.q_mul, frac_bits=8),
            q16_16=qformat.q_mul,
            q8_24=partial(qformat.q_mul, frac_bits=24),
            f32=lambda a, b: a * b,
        )
        self.register("add", q16_16=qformat.q_add, f32=lambda a, b: a + b)
        self.register("sub", q16_16=qformat.q_sub, f32=lambda a, b: a - b)
        self.register(
            "sin",
            q16_16=lambda t: cordic.cordic_sincos(t)[0],
            q8_24=lambda t: cordic.cordic_sincos24(t)[0],
            f32=torch.sin,
        )
        self.register(
            "cos",
            q16_16=lambda t: cordic.cordic_sincos(t)[1],
            q8_24=lambda t: cordic.cordic_sincos24(t)[1],
            f32=torch.cos,
        )
        self.register("matmul", q16_16=linalg.qmatmul_deferred, f32=linalg.matmul_float)
        self.register("atan2", q16_16=ops.atan2, q8_24=ops.atan2_24, f32=torch.atan2)
        for op, f32 in (("sqrt", torch.sqrt), ("exp", torch.exp), ("log", torch.log),
                        ("tanh", torch.tanh), ("sigmoid", torch.sigmoid)):
            self.register(op, q16_16=partial(ops.unary_op, op=op), f32=f32)
        self.register("div", q16_16=ops.div, f32=lambda a, b: a / b)

    def register(self, name: str, *, fast: Optional[Callable] = None,
                 precise: Optional[Callable] = None, **level_impls: Callable) -> None:
        """Register per-level implementations of an op (``fast`` ->
        q16_16, ``precise`` -> f32, or level names as keywords); the
        previous registration is replaced wholesale."""
        table: Dict[str, Callable] = {}
        if fast is not None:
            table[MODE_ALIASES[Mode.FAST]] = fast
        if precise is not None:
            table[MODE_ALIASES[Mode.PRECISE]] = precise
        for lv, fn in level_impls.items():
            table[resolve_level(lv).name] = fn
        if not table:
            raise ValueError(f"register({name!r}): no implementations given")
        self._impls[name] = table

    def compile_op(self, name: str, impls: Dict[LevelSpec, Callable], *example_args) -> None:
        """Make every path of ``name`` ready NOW, so no call after
        ``set_level`` builds a kernel.  The reference lowers and compiles
        each implementation ahead of time (and takes lowering keywords);
        eager PyTorch has nothing to lower, so each implementation runs
        once on ``example_args``, which builds and loads the CUDA kernels
        it reaches, and the table is then registered as ``register``
        does.  ``impls`` keys may be Modes or level names.  The example
        outputs are discarded; on a CUDA tensor the warm-up is
        synchronised."""
        table = {resolve_level(lv).name: fn for lv, fn in impls.items()}
        if not table:
            raise ValueError(f"compile_op({name!r}): no implementations given")
        for fn in table.values():
            fn(*example_args)
        for a in example_args:
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                torch.cuda.synchronize(a.device)
        self._impls[name] = table

    def _impl_for(self, name: str, level_name: str) -> Callable:
        """Exact level, else the nearest MORE precise level with an
        implementation, else the nearest less precise."""
        impls = self._impls[name]
        if level_name in impls:
            return impls[level_name]
        names = ladder_names()
        r = names.index(level_name)
        for nm in names[r + 1:]:
            if nm in impls:
                return impls[nm]
        for nm in reversed(names[:r]):
            if nm in impls:
                return impls[nm]
        raise KeyError(f"op {name!r} has no implementation reachable from level {level_name!r}")

    # -- levels -------------------------------------------------------------

    @property
    def level(self) -> PrecisionLevel:
        return self._level

    @property
    def mode(self) -> Mode:
        return self._level.mode

    @property
    def policy(self) -> Optional[PrecisionPolicy]:
        return self._policy

    def set_mode(self, mode: LevelSpec) -> float:
        return self.set_level(mode)

    def set_level(self, spec: LevelSpec) -> float:
        """Two-phase transition (quiesce the in-flight step, agree,
        swap one reference).  Returns the latency in microseconds."""
        target = resolve_level(spec)
        with self._lock:
            if target is self._level:
                return 0.0
            return self._swap(lambda: setattr(self, "_level", target), tag=target.name)

    def set_policy(self, policy: Optional[PrecisionPolicy]) -> float:
        """Swap the per-op policy through the same two-phase barrier; an
        equal policy is a free no-op."""
        with self._lock:
            if policy == self._policy:
                return 0.0
            return self._swap(lambda: setattr(self, "_policy", policy), tag=f"policy:{policy!r}")

    @contextlib.contextmanager
    def at(self, spec: Union[LevelSpec, PrecisionPolicy]):
        """Scoped dispatch: ``with engine.at("q8_24"): ...`` switches the
        level, ``with engine.at(PrecisionPolicy(...)): ...`` the policy;
        the previous one is restored on exit."""
        if isinstance(spec, PrecisionPolicy):
            prev_policy = self._policy
            self.set_policy(spec)
            try:
                yield self
            finally:
                self.set_policy(prev_policy)
            return
        prev = self._level
        self.set_level(spec)
        try:
            yield self
        finally:
            self.set_level(prev)

    # -- quantized-weight cache --------------------------------------------

    @property
    def weight_cache(self):
        """The engine's quantize-once weight store (created lazily)."""
        with self._lock:
            if self._weight_cache is None:
                from repro_torch.core.quantization import QuantizedWeightCache

                self._weight_cache = QuantizedWeightCache()
            return self._weight_cache

    def invalidate_weights(self, name: Optional[str] = None) -> float:
        """Drop cached quantized weights through the two-phase barrier."""
        cache = self.weight_cache
        with self._lock:
            return self._swap(lambda: cache.invalidate(name), tag=f"weights:{name}")

    def _swap(self, swap_fn: Callable[[], Any], tag: str) -> float:
        t0 = time.perf_counter()
        self._barrier.transition(inflight=self._inflight, swap_fn=swap_fn)
        latency_us = (time.perf_counter() - t0) * 1e6
        s = self.switch_stats
        s.count += 1
        s.last_latency_us = latency_us
        s.total_latency_us += latency_us
        s.history.append((tag, latency_us))
        return latency_us

    # -- dispatch ----------------------------------------------------------

    def level_for(self, name: str) -> str:
        """The level ``call(name, ...)`` dispatches at: the policy's
        override or default, else the engine's level."""
        if self._policy is None:
            return self._level.name
        return self._policy.level_for(name, self._level.name)

    def call(self, name: str, *args, **kw):
        """Dispatch at the op's level (see :meth:`level_for`), tracking
        the in-flight result so the barrier can quiesce it."""
        out = self._impl_for(name, self.level_for(name))(*args, **kw)
        self._inflight = out
        return out

    def switched(self, name: str, levels: Optional[Sequence[LevelSpec]] = None
                 ) -> Tuple[Tuple[Callable, ...], Tuple[str, ...]]:
        """The per-level table of ``name``'s implementations, in the order
        of ``levels`` (default: the whole ladder): dispatch with
        ``table[level_idx](*args)``."""
        names = (tuple(resolve_level(lv).name for lv in levels)
                 if levels is not None else ladder_names())
        return tuple(self._impl_for(name, nm) for nm in names), names

    def level_index(self, levels: Optional[Sequence[str]] = None) -> int:
        """Index of the current level in ``levels`` (nearest more precise
        entry when absent, else the most precise)."""
        names = tuple(resolve_level(lv).name for lv in levels) if levels else ladder_names()
        if self._level.name in names:
            return names.index(self._level.name)
        full = ladder_names()
        rank = full.index(self._level.name)
        above = [i for i, nm in enumerate(names) if full.index(nm) > rank]
        if above:
            return min(above, key=lambda i: full.index(names[i]))
        return max(range(len(names)), key=lambda i: full.index(names[i]))
