"""Device resolution, float policy and the CUDA kernel loader.

Reference: ``src/repro/compat.py`` (JAX version shims and the Pallas
``interpret`` default).  Here the device decides which path runs: a
kernel wrapper takes its plain PyTorch version only for a CPU tensor
and launches its CUDA kernel for a CUDA tensor — there is no backend
switch and no fallback.

Float policy: TF32 is switched off for matmuls and cuDNN once, at
import, so the exact (``f32``) rung computes in full float32 on the card
as the JAX package does under XLA.

Sharded and traced calls: a kernel wrapper given a ``DTensor`` runs its
kernel on the local shards (:func:`dtensor_local`, :func:`from_local`:
the rules' placements, Partial sums settled first), and given a
``meta`` tensor (the dry-run's trace) it launches nothing and runs no
plain version: :func:`meta_kernel` hands the contract's operations and
bytes to the active cost counters (``launch.cost_analysis``) and the
wrapper returns empty outputs of the contract's shapes.

Kernel build: every ``kernels/csrc/<name>.cu`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface,
loaded with :mod:`ctypes`.  The build runs at first use into ``build/``
at the repository root (one ``nvcc`` per source, all started together
by :func:`build_kernels`), keyed by a hash of the sources and flags so a
stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

__all__ = [
    "resolve_device",
    "CSRC_DIR",
    "BUILD_DIR",
    "KERNEL_SOURCES",
    "NVCC_FLAGS",
    "build_kernels",
    "load_kernel_library",
    "kernel_function",
    "current_stream",
    "check_launch",
    "COST_SINKS",
    "meta_kernel",
    "is_dtensor",
    "dtensor_local",
    "settled_placements",
    "from_local",
    "replicated_like",
    "gather_inner",
    "product_out",
    "grad_layout",
    "gather_contraction",
    "keep_layout",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CSRC_DIR = Path(__file__).resolve().parent / "kernels" / "csrc"
#: repository root (``src/repro_torch/compat.py`` -> three levels up)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: one shared library per source; the header is shared by all of them
KERNEL_SOURCES = ("qmatmul", "fused_mlp", "cordic", "flashattn", "universal", "linalg")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA without one raises —
    the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available. The port runs on the "
            "card by default; pass device='cpu' to run the plain PyTorch "
            "versions of its kernels."
        )
    return dev


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_kernels(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every missing library in ``names`` — one ``nvcc`` per
    source, all started together — and return the build log's summary
    ``{name: seconds}`` (0.0 for a library already built).  Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    times = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        msgs = "\n".join(
            f"--- {n} ---\n" + (BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return times


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``lib<name>.so``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_kernels([name])
            lib = ctypes.CDLL(str(path))
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.repro_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def kernel_function(lib: str, name: str, argtypes: tuple):
    """The launcher ``name`` of ``lib<lib>.so`` with its C signature
    declared (``argtypes``; every launcher returns an int error code)."""
    fn = getattr(load_kernel_library(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def current_stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(lib: str, rc: int, what: str) -> None:
    """Raise with CUDA's own message if a launcher of ``lib<lib>.so``
    returned an error (it returns ``cudaGetLastError()`` right after
    the launch)."""
    if rc != 0:
        msg = load_kernel_library(lib).repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device address of ``t`` (None for a null pointer)."""
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# DTensor shards and meta traces
# ---------------------------------------------------------------------------

#: callbacks ``(name, ops, nbytes)`` of the cost counters that trace a step
COST_SINKS: list = []


def meta_kernel(name: str, ops: float, nbytes: float, out):
    """A kernel called on ``meta`` tensors: nothing launches and no plain
    version runs; ``ops`` and ``nbytes`` (the contract's work, as
    ``chip_smoke.py``'s bounds count it) go to every active cost counter.
    Returns ``out`` (the wrapper's empty outputs)."""
    for sink in COST_SINKS:
        sink(name, float(ops), float(nbytes))
    return out


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:          # a torch built without distributed
        return ()
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_type())


def settled_placements(x, placements=None) -> list:
    """``placements`` (default: ``x``'s own) with every Partial sum
    settled to Replicate."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if p.is_partial() else p
            for p in (placements if placements is not None else x.placements)]


def dtensor_local(x, placements=None):
    """``x``'s local shard after redistributing it to ``placements``
    (default: its own, with every Partial sum settled to Replicate)."""
    want = settled_placements(x, placements)
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return x.to_local()


def from_local(local: torch.Tensor, mesh, placements):
    """A kernel's local output as a DTensor with ``placements``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, list(placements), run_check=False)


def replicated_like(ref, t: torch.Tensor):
    """``t`` replicated on ``ref``'s mesh when ``ref`` is a DTensor (an
    index or accumulator a model step builds beside sharded
    activations), else ``t`` itself."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import Replicate

    return from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim)


def _gathered(x):
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


class _GradLayout(torch.autograd.Function):
    """The identity forward; backward, ``layout`` applied to the gradient."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout(g), None


def grad_layout(y, layout):
    """``y`` whose gradient (when ``y`` is a DTensor that autograd
    records) is laid out by ``layout`` before it flows on: the backward
    twin of a layout point, where the op the gradient meets next (a view,
    a product) cannot take the gradient's own layout."""
    if not is_dtensor(y) or not y.requires_grad:
        return y
    return _GradLayout.apply(y, layout)


def gather_inner(x):
    """``x`` with the shards of its inner dimensions (all but the first
    and the last) gathered when it is a DTensor: the layout of the left
    operand of a (..., K) x (K, N) product (the sequence-parallel
    residual meeting a tensor-parallel weight).  DTensor flattens the
    leading dimensions for the product and, before torch 2.13, refuses
    to flatten a sharded inner one.  A plain tensor is returned as is."""
    if not is_dtensor(x) or x.ndim < 3:
        return x
    return _gathered(x)


def keep_layout(y):
    """``y`` whose gradient (a DTensor's) takes ``y``'s own placements."""
    if not is_dtensor(y):
        return y
    mesh, pl = y.device_mesh, list(y.placements)
    return grad_layout(y, lambda g: g if list(g.placements) == pl else g.redistribute(mesh, pl))


def product_out(y):
    """A product's output ``y``, whose gradient (when ``y`` is a DTensor)
    has its inner shards gathered before the product's backward flattens
    it: the backward twin of :func:`gather_inner`."""
    return y if y.ndim < 3 else grad_layout(y, _gathered)


def gather_contraction(x, w):
    """The right operand ``w`` (..., K, N) of a product with ``x`` (..., K),
    its K shards gathered over every mesh dimension that does not shard
    ``x``'s K the same way: FSDP's weight all-gather, which keeps the
    activations where they are (left to itself DTensor may gather the
    activations instead, a batch of them per device).  Plain tensors are
    returned as they are."""
    if not is_dtensor(w) or not is_dtensor(x):
        return w
    from torch.distributed.tensor import Replicate

    k = w.ndim - 2
    pl = [Replicate() if pw.is_shard() and pw.dim == k
          and not (px.is_shard() and px.dim == x.ndim - 1) else pw
          for px, pw in zip(x.placements, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(w.device_mesh, pl)
