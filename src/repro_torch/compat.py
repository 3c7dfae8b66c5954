"""Device resolution, float policy and the CUDA kernel loader.

Reference: ``src/repro/compat.py`` (JAX version shims and the Pallas
``interpret`` default).  Here the device decides which path runs: a
kernel wrapper takes its plain PyTorch version only for a CPU tensor
and launches its CUDA kernel for a CUDA tensor — there is no backend
switch and no fallback.

Float policy: TF32 is switched off for matmuls and cuDNN once, at
import, so the exact (``f32``) rung computes in full float32 on the card
as the JAX package does under XLA.

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
