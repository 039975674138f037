"""Parameters across the two packages.

The JAX package keeps its parameters as a pytree of nested dicts
(`anchor`, `mlp_opacity: {l1: {w, b}, l2: {w, b}}`, ...) and checkpoints it
as a flat npz keyed by the `/`-joined path (`mlp_opacity/l1/w`). The port
keeps the same keys in nested dicts of tensors, so either form loads here.
A JAX `TrainState` (params, Adam moments, statistics) carries across with
`train_state_from_jax`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..train.optim import AdamState
from ..train.trainer import TrainState
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


def train_state_from_jax(state, device="cuda"):
    """A JAX package `TrainState` (leaves as numpy, or anything `np.asarray`
    takes) -> the port's `TrainState` on `device`: params, both Adam moments
    and their count, `valid`, `step` and the four densification
    statistics."""
    conv = lambda x: params_from_jax(x, device)
    return TrainState(
        params=params_from_jax(state.params, device),
        opt=AdamState(mu=params_from_jax(state.opt.mu, device),
                      nu=params_from_jax(state.opt.nu, device),
                      count=conv(state.opt.count)),
        valid=conv(state.valid),
        step=conv(state.step),
        opacity_accum=conv(state.opacity_accum),
        anchor_demon=conv(state.anchor_demon),
        offset_grad_accum=conv(state.offset_grad_accum),
        offset_denom=conv(state.offset_denom),
    )
