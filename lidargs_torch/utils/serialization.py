"""Trees of tensors <-> npz, for snapshots and checkpoints.

Counterpart of `lidargs_tpu/utils/serialization.py`: a flat npz archive
keyed by each leaf's path, the keys `/`-joined as the JAX package builds
them from its pytrees (a dict key, a NamedTuple field name, a sequence
index): `params/anchor`, `params/mlp_cov/l1/w`, `opt/mu/anchor`,
`opt/count`, `valid`, `step`. The port's trees are nested dicts and
NamedTuples with the same names, so an archive written by either package
loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) of every leaf; None is an empty subtree."""
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, join(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from tree_paths(getattr(tree, k), join(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, join(i))
    else:
        yield prefix, tree


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pytree_npz(path: str, tree) -> None:
    np.savez_compressed(path, **{k: _numpy(v) for k, v in tree_paths(tree)})


def load_pytree_npz(path: str, like):
    """Restore into the structure of `like`: each leaf takes the dtype (and,
    for a tensor, the device) of `like`'s leaf at its path. Raises KeyError
    when the archive lacks one."""
    with np.load(path) as archive:
        def restore(ref, key):
            if key not in archive:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = archive[key]
            if isinstance(ref, torch.Tensor):
                return torch.from_numpy(np.array(arr)).to(dtype=ref.dtype, device=ref.device)
            return np.asarray(arr, dtype=np.asarray(ref).dtype)

        def build(tree, prefix):
            join = lambda k: f"{prefix}/{k}" if prefix else str(k)
            if tree is None:
                return None
            if isinstance(tree, dict):
                return {k: build(v, join(k)) for k, v in tree.items()}
            if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                return type(tree)(*(build(getattr(tree, k), join(k)) for k in tree._fields))
            if isinstance(tree, (list, tuple)):
                return type(tree)(build(v, join(i)) for i, v in enumerate(tree))
            return restore(tree, prefix)

        return build(like, "")
