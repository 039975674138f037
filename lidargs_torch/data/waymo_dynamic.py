"""Dynamic Waymo scenes (DyNFL preprocessing): the background / vehicle
decomposition.

Counterpart of `lidargs_tpu/data/waymo_dynamic.py`, which re-designs the
reference's partially released dynamic mode (`scene/waymoDynamic.py` and
`scene/dataset_readers_dynmaic.py`) and repairs what keeps it from running.

Input bundle (per driving context, produced by DyNFL's preprocessing):
  range_images1.npy            [N, H, W, 3]  (dist, intensity, elongation)
  ray_object_indices.npy       [N, H, W]     per-ray object index (-1 = bg)
  normals.npy                  [N, H, W, 3]
  valid_normal_flags.npy       [N, H, W]
  objects_id_2_{tsfm,corners,anchors,frameidx,dynamic_flag}.npy  (dict pickles)
  object_ids_per_frame.npy / objects_id_types_per_frame.npy
  training_lidar_calibration.parquet   (beam inclinations, row 4), or
  beam_inclinations.npy        [H]
  meta_info.json               frames[i+50].lidar2world poses

Decomposition: model_id == STATIC renders the background (every dynamic
vehicle masked out); each dynamic vehicle id becomes its own sub-scene in
a canonical object frame, from a Kabsch fit of its box corners at each
occurrence against an axis-aligned anchor box. Each sub-scene trains
through the masked losses (`LidarFrame.pixel_mask`).

The bundle's bookkeeping (masks, poses, Kabsch) stays NumPy on the host,
float64 for the poses; the frames, the back-projection of the masked
pixels and the init cloud live on the requested device (the card unless
the caller passes device="cpu"). The init sample's indices are drawn with
numpy's generator, as the JAX package draws them.

A ray of the background (object index -1) indexes the frame's object list
from its end, as in the JAX package: if a frame lists a dynamic vehicle
last, its mask takes every background ray of the frame and the background
loses them. The port keeps that behaviour so that both packages give the
same sub-scenes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..lidar.frames import LidarFrame
from ..lidar.pano import pano_to_lidar
from ..utils.device import resolve_device

STATIC = 0          # pseudo model id of the background scene
VEHICLE_TYPE = 1    # waymo object type "vehicle"


def kabsch(x1: np.ndarray, x2: np.ndarray,
           weights: Optional[np.ndarray] = None,
           eps: float = 1e-7) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted Kabsch/Umeyama rigid fit x2 ~ R @ x1 + t, in float64
    (kabsch_transformation_estimation, waymoDynamic.py:172-221)."""
    n = x1.shape[0]
    w = np.ones((n,)) if weights is None else np.asarray(weights, np.float64)
    w = w / (w.sum() + eps)
    m1 = (w[:, None] * x1).sum(0)
    m2 = (w[:, None] * x2).sum(0)
    a = (x1 - m1) * w[:, None]
    cov = a.T @ (x2 - m2)
    u, _, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    R = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    t = m2 - R @ m1
    return R, t


def _apply(pose: np.ndarray, pts: torch.Tensor) -> torch.Tensor:
    """pts [N, 3] float64 through the 4x4 float64 pose, on pts' device."""
    p = torch.as_tensor(pose, dtype=torch.float64, device=pts.device)
    return pts @ p[:3, :3].T + p[:3, 3]


class WaymoDynamicScene:
    """Loader over the DyNFL-preprocessed context directory (host arrays)."""

    def __init__(self, context_dir: str, scene_size: int = 50,
                 frame_offset: int = 50, calib_row: int = 4):
        d = Path(context_dir)
        self.scene_size = scene_size

        ri = np.load(d / "range_images1.npy", allow_pickle=True)
        ri = np.asarray(ri, np.float32)[:scene_size]
        self.first_dist = ri[..., 0]                      # [N, H, W]
        self.first_intensity = np.tanh(ri[..., 1])
        self.first_elongation = ri[..., 2]
        self.first_masks = self.first_dist > 0

        self.ray_object_indices = np.load(
            d / "ray_object_indices.npy", allow_pickle=True)[:scene_size]
        self.normals = np.asarray(
            np.load(d / "normals.npy", allow_pickle=True), np.float32)[:scene_size]
        self.valid_normal_flag = np.load(
            d / "valid_normal_flags.npy", allow_pickle=True)[:scene_size]
        load_dict = lambda name: np.load(d / name, allow_pickle=True).item()
        self.objects_id_2_tsfm = load_dict("objects_id_2_tsfm.npy")
        self.objects_id_types_per_frame = np.load(
            d / "objects_id_types_per_frame.npy", allow_pickle=True)
        self.objects_id_2_corners = load_dict("objects_id_2_corners.npy")
        self.objects_id_2_anchors = load_dict("objects_id_2_anchors.npy")
        self.objects_id_2_frameidx = load_dict("objects_id_2_frameidx.npy")
        self.objects_id_2_dynamic_flag = load_dict("objects_id_2_dynamic_flag.npy")
        self.object_ids_per_frame = np.load(
            d / "object_ids_per_frame.npy", allow_pickle=True)

        self.beam_inclinations = self._load_beams(d, calib_row)

        with open(d / "meta_info.json") as f:
            frames = json.load(f)["frames"]
        self.l2w = [np.array(frames[i + frame_offset]["lidar2world"], np.float64)
                    for i in range(scene_size)]

        self._map_types()
        self._index_dynamic_objects()

    @staticmethod
    def _load_beams(d: Path, calib_row: int) -> np.ndarray:
        """The beam inclinations: row `calib_row` of the parquet calibration
        when the bundle has one (read with pandas and pyarrow, which must
        then be installed), else `beam_inclinations.npy`."""
        pq = d / "training_lidar_calibration.parquet"
        if pq.exists():
            try:
                import pandas as pd

                df = pd.read_parquet(
                    pq, engine="pyarrow",
                    columns=["[LiDARCalibrationComponent].beam_inclination.values"],
                )
            except ImportError as e:
                raise ImportError(
                    f"{pq} needs pandas and pyarrow to be read ({e}); without them, "
                    "ship the beams as beam_inclinations.npy in place of the parquet "
                    "file") from e
            return np.asarray(df.iloc[calib_row, 0], np.float64)
        alt = d / "beam_inclinations.npy"
        if alt.exists():
            return np.load(alt)
        raise FileNotFoundError(f"no beam calibration found in {d}")

    # --- object bookkeeping (waymoDynamic.py:118-170) ---

    def _map_types(self):
        self.object_id_2_type: Dict = {}
        for f in range(self.scene_size):
            for oid, typ in zip(self.object_ids_per_frame[f],
                                self.objects_id_types_per_frame[f]):
                self.object_id_2_type[oid] = typ

    def _index_dynamic_objects(self):
        self.object_id_2_global_idx: Dict = {}
        cnt = 0
        for f in range(self.scene_size):
            for oid in self.object_ids_per_frame[f]:
                dyn = self.objects_id_2_dynamic_flag.get(oid, False)
                typ = self.object_id_2_type.get(oid, -1)
                if oid not in self.object_id_2_global_idx and dyn \
                        and typ == VEHICLE_TYPE:
                    self.object_id_2_global_idx[oid] = cnt
                    cnt += 1
        self.dynamic_object_counter = cnt

    def dynamic_object_ids(self) -> List:
        return list(self.object_id_2_global_idx.keys())

    def object_frames(self, object_id) -> List[int]:
        return list(self.objects_id_2_frameidx[object_id])

    def object_aabb(self, object_id) -> np.ndarray:
        """[6] (min_xyz, max_xyz) of the object's anchor box."""
        a = np.asarray(self.objects_id_2_anchors[object_id])
        return np.concatenate([a.min(0), a.max(0)])

    # --- masks (waymoDynamic.py:245-292) ---

    def _hits(self, frame_idx: int, is_target) -> np.ndarray:
        """[H, W] bool: the rays whose object satisfies `is_target`. A ray's
        object is its frame's object list at the ray's index, -1 (a
        background ray) reading the last entry, as in the JAX package."""
        ids = self.object_ids_per_frame[frame_idx]
        target = np.array([bool(is_target(oid)) for oid in ids], dtype=bool)
        return target[self.ray_object_indices[frame_idx]]

    def _base_mask(self, frame_idx: int) -> np.ndarray:
        return self.first_masks[frame_idx] & self.valid_normal_flag[frame_idx]

    def masks_for_object(self, frame_idx: int, object_id):
        """(static_mask, object_only_mask) for one frame."""
        dyn = self._hits(frame_idx, lambda oid: oid == object_id)
        base = self._base_mask(frame_idx)
        obj_only = base & dyn
        return base & ~obj_only, obj_only

    def static_mask(self, frame_idx: int) -> np.ndarray:
        """All dynamic vehicles cut out."""
        dyn = self._hits(frame_idx, lambda oid: any(
            oid == d for d in self.object_id_2_global_idx))
        base = self._base_mask(frame_idx)
        return base & ~(base & dyn)

    # --- canonical object pose (waymoDynamic.py:225-244, indexed by
    # occurrence order, as get_obj2world's caller intends) ---

    def object_to_world(self, occurrence_idx: int, object_id) -> np.ndarray:
        corners = np.asarray(self.objects_id_2_corners[object_id][occurrence_idx],
                             np.float64)
        x = np.linalg.norm(corners[0] - corners[4])
        y = np.linalg.norm(corners[0] - corners[3])
        z = np.linalg.norm(corners[0] - corners[1])
        anchor = np.array([
            [0, 0, 0], [0, 0, z], [0, y, z], [0, y, 0],
            [x, 0, 0], [x, 0, z], [x, y, z], [x, y, 0],
        ]) + corners.mean(0)
        R, _t = kabsch(anchor, corners)
        o2w = np.eye(4)
        o2w[:3, :3] = R
        o2w[:3, 3] = corners[0]
        return o2w

    # --- range view / point extraction (waymoDynamic.py:293-360) ---

    def range_view_gt(self, frame_idx: int) -> np.ndarray:
        """[3, H, W]: raydrop(=dist>0), clipped intensity, dist."""
        dist = self.first_dist[frame_idx]
        inten = np.clip(self.first_intensity[frame_idx], 0, 1)
        return np.stack([(dist > 0).astype(np.float32), inten, dist], 0)

    def _masked_points(self, frame_idx: int, mask: np.ndarray,
                       device="cuda") -> torch.Tensor:
        """Back-project the frame's masked pixels: sensor-frame xyz [N, 3]
        float64 on `device`, row-major, zero ranges dropped."""
        dev = resolve_device(device)
        dist = torch.as_tensor(np.where(mask, self.first_dist[frame_idx], 0.0), device=dev)
        return pano_to_lidar(dist, torch.as_tensor(self.beam_inclinations, device=dev))

    def static_points_world(self, frame_idx: int, device="cuda") -> torch.Tensor:
        pts = self._masked_points(frame_idx, self.static_mask(frame_idx), device)
        return _apply(self.l2w[frame_idx], pts)

    def object_points_canonical(self, frame_idx: int, occurrence_idx: int,
                                object_id, device="cuda") -> torch.Tensor:
        _, obj_mask = self.masks_for_object(frame_idx, object_id)
        pts = self._masked_points(frame_idx, obj_mask, device)
        w2l = np.linalg.inv(self.l2w[frame_idx])
        o2l = w2l @ self.object_to_world(occurrence_idx, object_id)
        return _apply(np.linalg.inv(o2l), pts)


class DynamicModelData(NamedTuple):
    """One trainable sub-scene (background or a single dynamic vehicle)."""

    model_id: object
    train_frames: List[LidarFrame]
    test_frames: List[LidarFrame]
    init_points: torch.Tensor        # [samples, 3] float32, on the frames' device
    beams: np.ndarray


# test splits match the static reader (dataset_readers.py:480-486)
DYNAMIC_TEST_POS = (10, 20, 31, 41)


def read_dynamic_model(scene: WaymoDynamicScene, model_id,
                       init_samples: int = 500_000,
                       min_frames: int = 5,
                       min_points: int = 100,
                       seed: int = 0,
                       device="cuda") -> Optional[DynamicModelData]:
    """Build the per-model sub-scene (readDynamicWaymoInfo semantics,
    dataset_readers_dynmaic.py:111-223, with the release bugs fixed).
    model_id == STATIC -> background; otherwise a dynamic vehicle id.
    Returns None when the object has too few frames/points."""
    dev = resolve_device(device)
    beams = scene.beam_inclinations
    if model_id == STATIC:
        occurred = list(range(scene.scene_size))
        samples = init_samples
    else:
        occurred = scene.object_frames(model_id)
        samples = min(init_samples, 10_000)
    if len(occurred) < min_frames:
        return None

    frames: List[LidarFrame] = []
    clouds = []
    for occ_i, f in enumerate(occurred):
        l2w = scene.l2w[f]
        gt = scene.range_view_gt(f)
        if model_id == STATIC:
            mask = scene.static_mask(f)
            pose = l2w                               # sensor pose in world
            clouds.append(scene.static_points_world(f, dev))
        else:
            o2w = scene.object_to_world(occ_i, model_id)
            # the sensor pose in the object's canonical frame: the object
            # replaces "world" for this sub-scene
            pose = np.linalg.inv(o2w) @ l2w
            _, mask = scene.masks_for_object(f, model_id)
            clouds.append(scene.object_points_canonical(f, occ_i, model_id, dev))
        frames.append(LidarFrame.from_lidar2world(pose, beams, gt, uid=f, pixel_mask=mask,
                                                  device=dev))

    cloud = torch.cat(clouds, 0)
    if cloud.shape[0] < min_points:
        return None
    sel = np.random.default_rng(seed).choice(cloud.shape[0], samples, replace=True)
    cloud = cloud[torch.as_tensor(sel, device=dev)].to(torch.float32)

    train, test = [], []
    for i, fr in enumerate(frames):
        (test if i in DYNAMIC_TEST_POS else train).append(fr)
    return DynamicModelData(model_id, train, test, cloud, np.asarray(beams))


def read_dynamic_scene(context_dir: str, device="cuda", **kw):
    """All sub-scenes of a context: background + every dynamic vehicle."""
    scene = WaymoDynamicScene(context_dir)
    models = []
    for model_id in [STATIC] + scene.dynamic_object_ids():
        m = read_dynamic_model(scene, model_id, device=device, **kw)
        if m is not None:
            models.append(m)
    return scene, models
