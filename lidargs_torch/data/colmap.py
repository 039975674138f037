"""COLMAP sparse-reconstruction parsers (binary + text).

Counterpart of `lidargs_tpu/data/colmap.py`, NumPy on the host as there:
cameras.bin/txt (intrinsics), images.bin/txt (extrinsics) and
points3D.bin/txt (the seed cloud) of COLMAP's public on-disk formats, as
the reference's legacy 3DGS data path reads them (`scene/colmap_loader.py`,
dispatched when a dataset has a `sparse/` directory).
"""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np


class CameraModel(NamedTuple):
    model_id: int
    model_name: str
    num_params: int


CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


class Camera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class Image(NamedTuple):
    id: int
    qvec: np.ndarray       # (w, x, y, z) world->camera rotation
    tvec: np.ndarray       # world->camera translation
    camera_id: int
    name: str
    xys: np.ndarray        # [n, 2] observed keypoints
    point3D_ids: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), largest-pivot method."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def _read(fid, n_bytes: int, fmt: str):
    return struct.unpack("<" + fmt, fid.read(n_bytes))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(f, 8 * model.num_params,
                                    "d" * model.num_params))
            cams[cid] = Camera(cid, model.model_name, int(w), int(h), params)
    return cams


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cams[int(parts[0])] = Camera(
                int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, 8, "Q")
            rec = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            data = np.frombuffer(f.read(rec.itemsize * n_pts), dtype=rec)
            xys = np.stack([data["x"], data["y"]], -1) if n_pts else \
                np.empty((0, 2))
            ids = data["id"].copy()
            images[iid] = Image(iid, qvec, tvec, cam_id, name.decode("utf-8"),
                                xys, ids)
    return images


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        obs = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(v) for v in obs]).reshape(-1, 3) if obs else \
            np.empty((0, 3))
        images[iid] = Image(iid, qvec, tvec, cam_id, name,
                            xys[:, :2], xys[:, 2].astype(np.int64))
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (xyz [n,3], rgb [n,3], error [n])."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            data = _read(f, 43, "QdddBBBd")
            xyzs.append(data[1:4])
            rgbs.append(data[4:7])
            errs.append(data[7])
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return (np.array(xyzs).reshape(-1, 3), np.array(rgbs).reshape(-1, 3),
            np.array(errs))


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyzs.append([float(v) for v in p[1:4]])
            rgbs.append([int(v) for v in p[4:7]])
            errs.append(float(p[7]))
    return (np.array(xyzs).reshape(-1, 3), np.array(rgbs).reshape(-1, 3),
            np.array(errs))


class ColmapScene(NamedTuple):
    cameras: Dict[int, Camera]
    images: Dict[int, Image]
    points: np.ndarray        # [n, 3]
    colors: np.ndarray        # [n, 3] uint8
    poses_c2w: Dict[int, np.ndarray]  # image id -> 4x4 camera-to-world


def read_colmap_scene(sparse_dir: str) -> ColmapScene:
    """Load a COLMAP sparse model directory (bin preferred, txt fallback)."""
    def pick(name):
        b = os.path.join(sparse_dir, name + ".bin")
        t = os.path.join(sparse_dir, name + ".txt")
        return (b, True) if os.path.exists(b) else (t, False)

    p, binary = pick("cameras")
    cams = read_cameras_binary(p) if binary else read_cameras_text(p)
    p, binary = pick("images")
    imgs = read_images_binary(p) if binary else read_images_text(p)
    p, binary = pick("points3D")
    xyz, rgb, _ = read_points3d_binary(p) if binary else read_points3d_text(p)

    poses = {}
    for iid, im in imgs.items():
        R = qvec2rotmat(im.qvec)
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ im.tvec
        poses[iid] = c2w
    return ColmapScene(cams, imgs, xyz, rgb.astype(np.uint8), poses)
