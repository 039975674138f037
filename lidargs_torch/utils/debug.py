"""Failure snapshots: dump the full render input state on a non-finite loss.

Counterpart of `lidargs_tpu/utils/debug.py`, writing the same npz layout
(`params/...`, `valid`, `frame/<field>`, `extra/...`), so a snapshot from
either package re-renders in either. The training loop calls
`snapshot_if_nonfinite` where it already reads the loss on the host; the
dumped state plus one `render_field` call is the offline repro.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..lidar.frames import LidarFrame

_FRAME_FIELDS = ("w2s_rot", "w2s_trans", "center", "beams", "gt_image", "uid", "pixel_mask")


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten(prefix: str, tree: dict, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _flatten(key, v, out)
        elif v is not None:
            out[key] = _numpy(v)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def dump_render_snapshot(path: str, params: dict, valid, frame: LidarFrame,
                         extra: Optional[dict] = None) -> str:
    """All render inputs -> one npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat: dict = {}
    _flatten("params", params, flat)
    flat["valid"] = _numpy(valid)
    _flatten("frame", {f: getattr(frame, f) for f in _FRAME_FIELDS}, flat)
    _flatten("extra", extra or {}, flat)
    np.savez_compressed(path, **flat)
    return path


def load_render_snapshot(path: str, device="cuda") -> Tuple[dict, torch.Tensor, LidarFrame,
                                                           dict]:
    """-> (params, valid, LidarFrame, extra), tensors on `device` (extra
    stays numpy), ready to re-render."""
    from .device import resolve_device
    from .params import params_from_jax

    dev = resolve_device(device)
    with np.load(path) as archive:
        tree = _unflatten({k: archive[k] for k in archive.files})
    fr = tree.get("frame", {})
    t = lambda x: None if x is None else torch.from_numpy(np.array(x)).to(dev)
    frame = LidarFrame(**{f: t(fr.get(f)) for f in _FRAME_FIELDS})
    return (params_from_jax(tree.get("params", {}), dev), t(tree["valid"]), frame,
            tree.get("extra", {}))


def snapshot_if_nonfinite(loss: float, model_path: str, iteration: int, params: dict,
                          valid, frame: LidarFrame, logger=None) -> Optional[str]:
    """If `loss` is NaN/inf, dump the render inputs under
    <model_path>/debug/nonfinite_iter<it>.npz and return the path."""
    if math.isfinite(loss):
        return None
    path = os.path.join(model_path, "debug", f"nonfinite_iter{iteration}.npz")
    dump_render_snapshot(path, params, valid, frame,
                         extra={"iteration": np.int64(iteration), "loss": np.float64(loss)})
    if logger is not None:
        logger.error(f"iter {iteration}: NON-FINITE loss {loss} — render inputs "
                     f"snapshotted to {path} (offline repro: "
                     f"utils.debug.load_render_snapshot + render_field)")
    return path
