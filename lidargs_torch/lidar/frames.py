"""LidarFrame: the per-frame "camera" of the range-view renderer.

Counterpart of `lidargs_tpu/lidar/frames.py`. The renderer needs only:
  * the world->sensor rigid transform,
  * the sensor origin in world coordinates,
  * the ascending beam-inclination table,
  * the 3-channel GT range image [raydrop, intensity, depth].
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device


class LidarFrame:
    """Per-frame tensors, all on one device."""

    def __init__(self, w2s_rot, w2s_trans, center, beams, gt_image, uid,
                 pixel_mask=None):
        self.w2s_rot = w2s_rot        # [3,3] world->sensor rotation
        self.w2s_trans = w2s_trans    # [3]   world->sensor translation
        self.center = center          # [3]   sensor origin in world
        self.beams = beams            # [H]   ascending inclinations (rad)
        self.gt_image = gt_image      # [3,H,W] raydrop, intensity, depth
        self.uid = uid                # []    frame index
        self.pixel_mask = pixel_mask  # optional [H,W] bool loss mask

    @property
    def H(self) -> int:
        return self.gt_image.shape[-2]

    @property
    def W(self) -> int:
        return self.gt_image.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.gt_image.device

    def to(self, device) -> "LidarFrame":
        mv = lambda x: None if x is None else x.to(device)
        return LidarFrame(mv(self.w2s_rot), mv(self.w2s_trans), mv(self.center),
                          mv(self.beams), mv(self.gt_image), mv(self.uid),
                          mv(self.pixel_mask))

    @classmethod
    def from_lidar2world(cls, l2w: np.ndarray, beams: np.ndarray,
                         gt_image: np.ndarray, uid: int = 0,
                         pixel_mask: Optional[np.ndarray] = None,
                         device="cuda") -> "LidarFrame":
        """Build from a 4x4 lidar->world pose (inverted in float64, as the
        JAX package does)."""
        dev = resolve_device(device)
        l2w = np.asarray(l2w, dtype=np.float64)
        w2l = np.linalg.inv(l2w)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return cls(
            w2s_rot=f32(w2l[:3, :3]),
            w2s_trans=f32(w2l[:3, 3]),
            center=f32(l2w[:3, 3]),
            beams=f32(beams),
            gt_image=f32(gt_image),
            uid=torch.tensor(uid, dtype=torch.int32, device=dev),
            pixel_mask=(None if pixel_mask is None else
                        torch.as_tensor(np.asarray(pixel_mask, bool), device=dev)),
        )

    def transform_to_sensor(self, points: torch.Tensor) -> torch.Tensor:
        """World -> sensor frame."""
        return points @ self.w2s_rot.T + self.w2s_trans
