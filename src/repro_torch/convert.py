"""Carry parameters across from the JAX package.

``params_from_jax`` takes the reference's parameter tree ALREADY
converted to numpy by the caller (``jax.tree.map(np.asarray, params)``)
and returns the port's tree of tensors with the same nesting, so both
packages compute the same model in the tests.  The port never imports
JAX; the conversion to numpy is the caller's side of the boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.compat import resolve_device

__all__ = ["params_from_jax", "to_numpy_tree"]


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    arr = np.asarray(tree)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def to_numpy_tree(tree):
    """The reverse direction for comparisons: tensors -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree
