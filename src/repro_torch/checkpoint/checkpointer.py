"""Atomic, async, topology-independent checkpointing.

Reference: ``src/repro/checkpoint/checkpointer.py`` — the same class,
the same on-disk layout, so a checkpoint that either package writes has
the same files:

* **Atomic**: a save writes ``step_N.tmp/`` and renames it to
  ``step_N/`` after an fsync; a half-written save is never listed, and
  ``_gc`` then keeps the newest ``keep`` committed steps;
* **Async**: ``save()`` copies every tensor to host memory first (the
  only part that waits on the card) and serializes in a background
  thread; a class-level registry of pending saves, keyed by directory,
  makes a new Checkpointer on the same directory join a save still in
  flight before it lists steps;
* **Layout**: ``manifest.json`` (``step`` and, per leaf, ``name``,
  ``file``, ``shape``, ``dtype``) plus one ``.npy`` per leaf, named by its
  tree path as JAX names it: dict keys as they are, a NamedTuple field
  (``OptState``) as ``.field``, joined by ``/``; the file is the name with
  ``/`` replaced by ``__``.  Dict keys are walked in sorted order, as
  ``jax.tree`` walks them.

``restore(template)`` reads into the structure of ``template`` (dicts,
NamedTuples and tensors) and puts each leaf on its template leaf's
device with its dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["Checkpointer"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_names(tree, prefix=()):
    """[(name, leaf)] in JAX's flattening order and naming."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in
                _flatten_with_names(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields for item in
                _flatten_with_names(getattr(tree, f), prefix + (f".{f}",))]
    return [("/".join(prefix), tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` (the order of :func:`_flatten_with_names`)."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    return next(leaves)


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf (never a view of a tensor that training
    goes on to update in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class Checkpointer:
    #: in-process registry of in-flight async saves, keyed by resolved
    #: directory: a NEW Checkpointer on the same directory joins a
    #: pending save first, so a restart never reads a stale latest_step
    _pending: dict = {}
    _pending_lock = threading.Lock()

    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0
        self.last_save_s = 0.0
        self._join_pending()

    def _key(self) -> str:
        return str(self.dir.resolve())

    def _join_pending(self) -> None:
        # the lock also serializes against save()'s register+start pair,
        # so a fetched thread is always already started (join-able)
        with self._pending_lock:
            thread = Checkpointer._pending.get(self._key())
        if thread is not None and thread is not threading.current_thread():
            thread.join()

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot now (device -> host), serialize in the background
        (unless ``blocking``)."""
        self.wait()  # one in-flight save at a time
        host = [(name, _to_host(leaf)) for name, leaf in _flatten_with_names(tree)]

        def work():
            t0 = time.time()
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": []}
            for name, leaf in host:
                fname = name.replace("/", "__") + ".npy"
                np.save(tmp / fname, leaf)
                manifest["leaves"].append({"name": name, "file": fname,
                                           "shape": list(leaf.shape), "dtype": str(leaf.dtype)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            fd = os.open(tmp, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self.save_count += 1
            self.last_save_s = time.time() - t0
            self._gc()
            with Checkpointer._pending_lock:
                if Checkpointer._pending.get(self._key()) is threading.current_thread():
                    del Checkpointer._pending[self._key()]

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            with self._pending_lock:
                Checkpointer._pending[self._key()] = self._thread
                self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        self._join_pending()  # never list around an uncommitted save
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore step ``step`` (default: the newest) into the structure
        of ``template``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        out = []
        for name, tmpl in _flatten_with_names(template):
            arr = np.load(d / by_name[name]["file"])
            assert list(arr.shape) == list(tmpl.shape), (name, arr.shape, tuple(tmpl.shape))
            t = torch.from_numpy(np.array(arr, copy=True))
            if isinstance(tmpl, torch.Tensor):
                t = t.to(device=tmpl.device, dtype=tmpl.dtype)
            out.append(t)
        return _unflatten(template, iter(out))
