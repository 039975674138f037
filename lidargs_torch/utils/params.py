"""Parameters across the two packages.

The JAX package keeps its parameters as a pytree of nested dicts
(`anchor`, `mlp_opacity: {l1: {w, b}, l2: {w, b}}`, ...) and checkpoints it
as a flat npz keyed by the `/`-joined path (`mlp_opacity/l1/w`). The port
keeps the same keys in nested dicts of tensors, so either form loads here.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def params_from_jax(tree, device="cuda") -> dict:
    """Nested dicts of arrays (numpy, or anything `np.asarray` takes) ->
    the same nesting of tensors on `device`, dtypes kept."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def load_params_npz(path: str, device="cuda") -> dict:
    """Read a flat `a/b/c`-keyed npz into nested dicts of tensors."""
    tree: dict = {}
    with np.load(path) as archive:
        for key in archive.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = archive[key]
    return params_from_jax(tree, device)
