"""Synthetic multi-view LiDAR datasets with consistent geometry.

Counterpart of `lidargs_tpu/data/synthetic.py` (host-side numpy, the same
files from the same seed). It writes an AlignMiF-format dataset
(transforms_train/test.json + npy range images) by ray-casting a
procedural world analytically from a sensor moving along +x: ground plane
and spheres (`make_world_dataset`), or a street of building facades,
parked cars and trees with cos-incidence shading (`make_street_dataset`).
Every frame observes the same world, so a field trained on it must
converge.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ..lidar.beams import uniform_beam_inclinations


def _ray_grid(H: int, W: int, beams: np.ndarray) -> np.ndarray:
    rows = np.arange(H)
    cols = np.arange(W)
    alpha = beams[H - 1 - rows][:, None]
    beta = -(cols[None, :] - W / 2.0) / W * 2.0 * np.pi
    return np.stack(
        [np.cos(alpha) * np.cos(beta), np.cos(alpha) * np.sin(beta),
         np.sin(alpha) * np.ones_like(beta)], -1
    )


def raycast_world(origin: np.ndarray, dirs: np.ndarray, spheres: np.ndarray,
                  albedo: np.ndarray, ground_z: float = 0.0,
                  far: float = 75.0, boxes: np.ndarray = None,
                  box_albedo: np.ndarray = None,
                  lambertian: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic depth+intensity: nearest hit of ground plane / spheres /
    axis-aligned boxes. spheres: [S, 4] (cx, cy, cz, r); albedo: [S+1]
    (ground first); boxes: [B, 6] (xmin, ymin, zmin, xmax, ymax, zmax).

    lambertian=True shades intensity with |n . d| cos-incidence so the
    intensity image carries real geometric structure (walls darken at
    grazing azimuths, ground darkens with range); the analytic surface
    normal also makes depth-gradient metrics interpretable."""
    H, W, _ = dirs.shape
    depth = np.full((H, W), np.inf)
    mat = np.full((H, W), -1, np.int64)
    cosi = np.ones((H, W))

    dz = dirs[..., 2]
    t_g = np.where(dz < -1e-6, (ground_z - origin[2]) / np.where(dz < -1e-6, dz, 1.0),
                   np.inf)
    hit_g = t_g < depth
    depth = np.where(hit_g, t_g, depth)
    mat = np.where(hit_g, 0, mat)
    cosi = np.where(hit_g, np.abs(dz), cosi)

    for i, (cx, cy, cz, r) in enumerate(spheres):
        oc = origin - np.array([cx, cy, cz])
        b = 2.0 * (dirs @ oc)
        c = oc @ oc - r * r
        disc = b * b - 4.0 * c
        ok = disc > 0
        t = np.where(ok, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, np.inf)
        t = np.where(t > 0.1, t, np.inf)
        closer = t < depth
        depth = np.where(closer, t, depth)
        mat = np.where(closer, i + 1, mat)
        # sphere normal at hit: (o + t d - c)/r; cos = |n . d|
        t_f = np.where(np.isfinite(t), t, 0.0)
        hitp = origin[None, None] + t_f[..., None] * dirs
        n = (hitp - np.array([cx, cy, cz])[None, None]) / r
        cs = np.abs(np.sum(n * dirs, -1))
        cosi = np.where(closer, cs, cosi)

    S = len(spheres)
    if boxes is not None:
        for j, (x0, y0, z0, x1, y1, z1) in enumerate(boxes):
            lo = np.array([x0, y0, z0])
            hi_ = np.array([x1, y1, z1])
            safe = np.where(np.abs(dirs) > 1e-12, dirs, 1e-12)
            t_lo = (lo[None, None] - origin[None, None]) / safe
            t_hi = (hi_[None, None] - origin[None, None]) / safe
            t1 = np.minimum(t_lo, t_hi)
            t2 = np.maximum(t_lo, t_hi)
            # entry slab axis gives the face normal axis
            tn_axis = np.argmax(t1, -1)
            tn = np.max(t1, -1)
            tf = np.min(t2, -1)
            hit = (tn <= tf) & (tn > 0.1)
            t = np.where(hit, tn, np.inf)
            closer = t < depth
            depth = np.where(closer, t, depth)
            mat = np.where(closer, S + 1 + j, mat)
            cs = np.abs(np.take_along_axis(dirs, tn_axis[..., None], -1)[..., 0])
            cosi = np.where(closer, cs, cosi)

    alb = albedo if box_albedo is None else np.concatenate([albedo, box_albedo])
    inten = np.where(mat >= 0, alb[np.maximum(mat, 0)], 0.0)
    if lambertian:
        inten = inten * np.clip(cosi, 0.05, 1.0)
    # mild lambertian-ish range falloff for realism
    inten = inten * np.clip(1.0 - depth / (2.0 * far), 0.2, 1.0)
    drop = (depth > far) | ~np.isfinite(depth)
    depth = np.where(drop, 0.0, depth)
    inten = np.where(drop, 0.0, inten)
    return depth.astype(np.float32), inten.astype(np.float32)


def make_world_dataset(root: str, n_frames: int = 50, H: int = 32,
                       W: int = 1024, n_spheres: int = 40,
                       seed: int = 0) -> None:
    """Write an AlignMiF-format dataset of a consistent procedural world."""
    rng = np.random.default_rng(seed)
    beams = uniform_beam_inclinations(3.0, 25.0, H)
    dirs = _ray_grid(H, W, beams)

    road_len = n_frames * 0.6
    spheres = np.stack([
        rng.uniform(-10, road_len + 10, n_spheres),
        rng.uniform(-18, 18, n_spheres),
        rng.uniform(0.5, 3.0, n_spheres),
        rng.uniform(0.8, 3.0, n_spheres),
    ], -1)
    albedo = np.concatenate([[0.35], rng.uniform(0.3, 1.0, n_spheres)])

    os.makedirs(os.path.join(root, "lidar"), exist_ok=True)
    test_idx = {10, 20, 31, 41} if n_frames >= 42 else set()
    frames_train, frames_test = [], []
    for i in range(n_frames):
        l2w = np.eye(4)
        l2w[:3, 3] = [0.6 * i, 0.0, 2.0]
        # sensor frame == world orientation; rays cast from the pose origin
        depth, inten = raycast_world(l2w[:3, 3], dirs, spheres, albedo)
        rv = np.stack([np.zeros_like(depth), inten, depth], -1)
        fname = f"lidar/frame_{i:03d}.npy"
        np.save(os.path.join(root, fname), rv)
        meta = {"file_path": fname, "lidar_file_path": fname,
                "lidar2world": l2w.tolist()}
        (frames_test if i in test_idx else frames_train).append(meta)

    base = {
        "w_lidar": W, "h_lidar": H,
        "fl_x": 1.0, "fl_y": 1.0, "cx": 0.5, "cy": 0.5, "w": W, "h": H,
        "beam_inclinations": beams.tolist(),
    }
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({**base, "frames": frames_train}, f)
    with open(os.path.join(root, "transforms_test.json"), "w") as f:
        json.dump({**base, "frames": frames_test}, f)


def make_street_dataset(root: str, n_frames: int = 50, H: int = 32,
                        W: int = 1024, seed: int = 0) -> None:
    """Structured urban-canyon fixture: a street of
    axis-aligned building facades on both sides, parked-car boxes, tree
    spheres, and a cos-incidence-shaded ground — all range images are exact
    analytic intersections, so PSNR/chamfer trends are interpretable (sharp
    depth discontinuities at facade edges, planar regions that must come
    out flat, ~meter-scale structures at known ranges)."""
    rng = np.random.default_rng(seed)
    beams = uniform_beam_inclinations(3.0, 25.0, H)
    dirs = _ray_grid(H, W, beams)

    road_len = n_frames * 0.6 + 20
    boxes = []
    box_albedo = []
    # building facades: irregular heights/setbacks on both street sides
    for side in (-1.0, 1.0):
        x = -10.0
        while x < road_len:
            w = rng.uniform(6.0, 14.0)
            depth_b = rng.uniform(6.0, 12.0)
            h = rng.uniform(4.0, 12.0)
            setback = rng.uniform(8.0, 12.0)
            y0 = side * setback
            y1 = side * (setback + depth_b)
            boxes.append([x, min(y0, y1), 0.0, x + w, max(y0, y1), h])
            box_albedo.append(rng.uniform(0.4, 0.9))
            x += w + rng.uniform(0.5, 3.0)
    # parked cars: low boxes near the curbs
    for _ in range(n_frames // 4):
        x = rng.uniform(-5, road_len)
        side = rng.choice([-1.0, 1.0])
        y = side * rng.uniform(5.0, 7.0)
        boxes.append([x, y - 1.0, 0.0, x + rng.uniform(3.5, 5.0), y + 1.0,
                      rng.uniform(1.4, 1.9)])
        box_albedo.append(rng.uniform(0.2, 0.6))
    boxes = np.array(boxes)
    box_albedo = np.array(box_albedo)
    # trees: spheres on 3m stems (stem omitted)
    n_trees = n_frames // 3
    spheres = np.stack([
        rng.uniform(-10, road_len, n_trees),
        rng.choice([-1.0, 1.0], n_trees) * rng.uniform(6.0, 8.5, n_trees),
        rng.uniform(2.5, 4.0, n_trees),
        rng.uniform(1.0, 2.0, n_trees),
    ], -1)
    albedo = np.concatenate([[0.35], rng.uniform(0.5, 0.95, n_trees)])

    os.makedirs(os.path.join(root, "lidar"), exist_ok=True)
    test_idx = {10, 20, 31, 41} if n_frames >= 42 else set()
    frames_train, frames_test = [], []
    for i in range(n_frames):
        l2w = np.eye(4)
        l2w[:3, 3] = [0.6 * i, 0.0, 2.0]
        depth, inten = raycast_world(
            l2w[:3, 3], dirs, spheres, albedo,
            boxes=boxes, box_albedo=box_albedo, lambertian=True,
        )
        rv = np.stack([np.zeros_like(depth), inten, depth], -1)
        fname = f"lidar/frame_{i:03d}.npy"
        np.save(os.path.join(root, fname), rv)
        meta = {"file_path": fname, "lidar_file_path": fname,
                "lidar2world": l2w.tolist()}
        (frames_test if i in test_idx else frames_train).append(meta)

    base = {
        "w_lidar": W, "h_lidar": H,
        "fl_x": 1.0, "fl_y": 1.0, "cx": 0.5, "cy": 0.5, "w": W, "h": H,
        "beam_inclinations": beams.tolist(),
    }
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({**base, "frames": frames_train}, f)
    with open(os.path.join(root, "transforms_test.json"), "w") as f:
        json.dump({**base, "frames": frames_test}, f)
