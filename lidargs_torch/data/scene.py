"""Scene orchestration: dataset -> frames + anchor field, snapshot and
checkpoint I/O.

Counterpart of `lidargs_tpu/data/scene.py`, writing the same files: the
init cloud `points3d.ply`; snapshots under
`point_cloud/iteration_<it>/` (`point_cloud.ply` with the live anchors,
`mlp_checkpoints.npz` with the heads, `meta.json` with the voxel size and
anchor count); full-resume checkpoints `chkpnt<it>.npz` of the whole
TrainState. Either package loads what the other wrote.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..models.field import AnchorField, init_field_from_points, init_field_params
from ..utils.device import resolve_device
from ..utils.serialization import load_pytree_npz, save_pytree_npz
from .ply import read_anchor_model, read_point_cloud, write_anchor_model, write_point_cloud
from .waymo import SceneData, read_lidar_scene

_MLP_KEYS = (
    "mlp_opacity", "mlp_cov", "mlp_color", "mlp_raydrop",
    "mlp_featbank", "appearance", "appearance_rd",
)


@dataclass
class Scene:
    data: SceneData
    field: AnchorField
    model_path: str

    @classmethod
    def create(cls, cfg: TrainConfig, load_iteration: Optional[Union[int, str]] = None,
               seed: int = 0, init_ply: Optional[str] = None, device="cuda",
               write_init: bool = True) -> "Scene":
        """Read the dataset and build the field: from the snapshot of
        `load_iteration` (an iteration, or "best" for
        `point_cloud/iteration_best`), else from the `init_ply` point cloud
        (the --warmup restart), else from the fused frames' init cloud, which
        is written to `points3d.ply` (unless `write_init` is False: a fleet's
        ranks other than the coordinator). The heads are drawn from a
        generator seeded with `cfg.seed`; `seed` seeds the init cloud's
        sample."""
        dev = resolve_device(device)
        data = read_lidar_scene(cfg.data.source_path, data_label=cfg.data.data_label,
                                num_frames=cfg.data.num_frames,
                                init_samples=cfg.data.init_points, seed=seed, device=dev)
        os.makedirs(cfg.model_path, exist_ok=True)
        if load_iteration is not None:
            field = cls._load_field(cfg.model_path, load_iteration, cfg.model, dev)
        else:
            if init_ply is not None:
                try:
                    init_points = read_anchor_model(init_ply)[0]
                except (KeyError, ValueError):      # a point cloud, not a snapshot
                    init_points = read_point_cloud(init_ply)
            else:
                init_points = data.init_points
                if write_init:
                        write_point_cloud(os.path.join(cfg.model_path, "points3d.ply"),
                                      init_points.cpu().numpy())
            field = init_field_from_points(
                cfg.model, init_points, num_cameras=len(data.train_frames),
                generator=torch.Generator().manual_seed(cfg.seed), device=dev)
        return cls(data=data, field=field, model_path=cfg.model_path)

    # --- model snapshots (the reference's scene.save: PLY + MLP heads) ---

    def save(self, params: dict, valid, iteration) -> str:
        out_dir = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        os.makedirs(out_dir, exist_ok=True)
        mask = valid.cpu()
        write_anchor_model(
            os.path.join(out_dir, "point_cloud.ply"),
            *(params[k].detach().cpu()[mask].numpy() for k in
              ("anchor", "offset", "feat", "scaling", "rotation", "opacity")),
        )
        save_pytree_npz(os.path.join(out_dir, "mlp_checkpoints.npz"),
                        {k: params[k] for k in _MLP_KEYS if k in params})
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump({"voxel_size": self.field.voxel_size, "n_anchors": int(mask.sum())}, f)
        return out_dir

    @staticmethod
    def _load_field(model_path: str, iteration, mcfg: ModelConfig, device) -> AnchorField:
        out_dir = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
        rows = read_anchor_model(os.path.join(out_dir, "point_cloud.ply"))
        with open(os.path.join(out_dir, "meta.json")) as f:
            meta = json.load(f)
        n = rows[0].shape[0]
        if n > mcfg.anchor_capacity:
            raise ValueError(f"snapshot has {n} anchors > capacity")
        params = init_field_params(mcfg, generator=torch.Generator().manual_seed(0),
                                   device=device)
        for name, arr in zip(("anchor", "offset", "feat", "scaling", "rotation", "opacity"),
                             rows):
            params[name][:n] = torch.from_numpy(np.ascontiguousarray(arr)).to(params[name])
        mlps_like = {k: params[k] for k in _MLP_KEYS if k in params}
        params.update(load_pytree_npz(os.path.join(out_dir, "mlp_checkpoints.npz"), mlps_like))
        valid = torch.arange(mcfg.anchor_capacity, device=params["anchor"].device) < n
        return AnchorField(params=params, valid=valid, voxel_size=meta["voxel_size"])

    # --- full-resume checkpoints ---

    def save_train_state(self, state, iteration: int) -> str:
        path = os.path.join(self.model_path, f"chkpnt{iteration}.npz")
        save_pytree_npz(path, state)
        return path

    def load_train_state(self, iteration: int, like):
        return load_pytree_npz(os.path.join(self.model_path, f"chkpnt{iteration}.npz"), like)
