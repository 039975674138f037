"""AlignMiF-format Waymo/KITTI scene reader.

Counterpart of `lidargs_tpu/data/waymo.py` (the reference's
waymo_readCamerasFromTransforms/readwaymoInfo): transforms_train/test JSON
plus per-frame npy range images -> `num_frames` LidarFrames with the
reference's interleaved test-frame placement (waymo test idx {10,20,31,41},
kitti {13,26,39}), the GT channel layout [raydrop, clip(intensity,0,1),
depth], and a world-frame init cloud of `init_samples` points drawn from
the back-projected panoramas.

The frames and the back-projection live on the requested device; the init
sample's indices are drawn on the host with numpy's generator, as the JAX
package draws them, so both packages pick the same points.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..lidar.beams import uniform_beam_inclinations
from ..lidar.frames import LidarFrame
from ..lidar.pano import pano_to_lidar
from ..utils.device import resolve_device

WAYMO_TEST_IDX = (10, 20, 31, 41)
KITTI_TEST_IDX = (13, 26, 39)


@dataclass
class SceneData:
    train_frames: List[LidarFrame]
    test_frames: List[LidarFrame]
    init_points: torch.Tensor        # [N,3] world, float32, on the frames' device
    beam_inclinations: np.ndarray    # [H]
    H: int
    W: int
    data_name: str                   # "waymo" | "kitti"


def _frame_for_index(idx: int, frames_train, frames_test, data_name: str):
    """The reference's interleaved index arithmetic, quirks included: waymo
    indices 30 and 40 read the train frame one further on."""
    if data_name == "waymo":
        if idx in WAYMO_TEST_IDX:
            return frames_test[idx // 10 - 1], True
        if idx in (30, 40):
            return frames_train[idx - idx // 10 + 1], False
        return frames_train[idx - idx // 10], False
    else:  # kitti
        if idx in KITTI_TEST_IDX:
            return frames_test[idx // 13 - 1], True
        return frames_train[idx - idx // 13], False


def read_lidar_scene(
    path: str,
    data_label: str = "waymo",
    num_frames: int = 50,
    init_samples: int = 500_000,
    seed: int = 0,
    device="cuda",
) -> SceneData:
    dev = resolve_device(device)
    train_json = ("transforms_train.json" if data_label == "waymo"
                  else f"transforms_{data_label}_train.json")
    test_json = ("transforms_test.json" if data_label == "waymo"
                 else f"transforms_{data_label}_test.json")
    with open(os.path.join(path, train_json)) as f:
        contents = json.load(f)
    with open(os.path.join(path, test_json)) as f:
        contents_test = json.load(f)

    W = contents["w_lidar"]
    H = contents["h_lidar"]
    if "beam_inclinations" in contents:
        beams = np.asarray(contents["beam_inclinations"], np.float64)
        data_name = "waymo"
    else:
        beams = uniform_beam_inclinations(2.0, 26.9, H)
        data_name = "kitti"
    beams_dev = torch.as_tensor(beams, dtype=torch.float64, device=dev)

    train_frames: List[LidarFrame] = []
    test_frames: List[LidarFrame] = []
    pcds = []
    for idx in range(num_frames):
        meta, is_test = _frame_for_index(idx, contents["frames"], contents_test["frames"],
                                         data_name)
        l2w = np.asarray(meta["lidar2world"], np.float64)
        rv = np.load(os.path.join(path, meta["lidar_file_path"].replace(" ", "")))
        intensity = rv[:, :, 1]
        depth = rv[:, :, 2]
        raydrop = (depth > 0.0).astype(np.float32)
        gt = np.stack([raydrop, np.clip(intensity, 0, 1).astype(np.float32),
                       depth.astype(np.float32)], axis=0)
        frame = LidarFrame.from_lidar2world(l2w, beams, gt, uid=idx, device=dev)
        (test_frames if is_test else train_frames).append(frame)

        pts_local = pano_to_lidar(torch.as_tensor(depth, device=dev), beams_dev)
        l2w_t = torch.as_tensor(l2w, device=dev)
        pcds.append(pts_local @ l2w_t[:3, :3].T + l2w_t[:3, 3])

    cloud = torch.cat(pcds, 0)
    sel = np.random.default_rng(seed).choice(cloud.shape[0], init_samples, replace=True)
    return SceneData(
        train_frames=train_frames,
        test_frames=test_frames,
        init_points=cloud[torch.as_tensor(sel, device=dev)].to(torch.float32),
        beam_inclinations=beams,
        H=H,
        W=W,
        data_name=data_name,
    )
