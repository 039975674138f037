"""Camera-image scene readers: Blender/NeRF-synthetic + COLMAP dispatch.

Counterpart of `lidargs_tpu/data/blender.py` (the reference's legacy 3DGS
scene path, `scene/dataset_readers.py:154-335`, and the
`sceneLoadTypeCallbacks` dispatch of `scene/__init__.py`): a camera-image
dataset (poses, intrinsics, images, seed point cloud) read into a uniform
CameraScene. The LiDAR pipeline does not use it.

NumPy on the host, as in the JAX package. PIL is imported only where an
image is read from disk or resized, so everything else runs without it.
"""
from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class CameraFrame(NamedTuple):
    """One posed camera image (CameraInfo, dataset_readers.py:29-40)."""

    uid: int
    R: np.ndarray           # [3,3] world->camera rotation, stored TRANSPOSED
                            # (the reference's glm convention, :273)
    T: np.ndarray           # [3] world->camera translation
    fov_x: float
    fov_y: float
    image: Optional[np.ndarray]   # [H,W,3] float32 in [0,1] (None if missing)
    image_path: str
    image_name: str
    width: int
    height: int

    @property
    def c2w(self) -> np.ndarray:
        w2c = np.eye(4)
        w2c[:3, :3] = self.R.T
        w2c[:3, 3] = self.T
        return np.linalg.inv(w2c)


class CameraScene(NamedTuple):
    """SceneInfo analogue (dataset_readers.py:42-48)."""

    points: np.ndarray        # [N,3] seed point cloud
    colors: np.ndarray        # [N,3] float32 in [0,1]
    train_cameras: List[CameraFrame]
    test_cameras: List[CameraFrame]
    translate: np.ndarray     # nerf++ normalization (getNerfppNorm)
    radius: float


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def _load_image(path: str, white_background: bool) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    from PIL import Image as PILImage

    im = np.asarray(PILImage.open(path).convert("RGBA"), np.float32) / 255.0
    bg = 1.0 if white_background else 0.0
    rgb = im[..., :3] * im[..., 3:4] + bg * (1.0 - im[..., 3:4])
    return rgb.astype(np.float32)


def _nerfpp_norm(cams: List[CameraFrame]) -> Tuple[np.ndarray, float]:
    """getNerfppNorm (dataset_readers.py:58-80): camera-center centroid +
    1.1x max distance radius."""
    centers = np.stack([c.c2w[:3, 3] for c in cams], axis=1)   # [3, N]
    center = centers.mean(axis=1)
    radius = 1.1 * float(np.linalg.norm(centers - center[:, None], axis=0).max())
    return -center, radius


def read_cameras_from_transforms(
    path: str, transformsfile: str, white_background: bool = False,
    extension: str = ".png",
) -> List[CameraFrame]:
    """readCamerasFromTransforms (dataset_readers.py:215-300): OpenGL/Blender
    camera axes flipped to COLMAP (Y down, Z forward); fovy derived from
    camera_angle_x, or per-frame fl_x/fl_y when absent."""
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents.get("camera_angle_x")
    frames = contents["frames"]
    if frames and frames[0]["file_path"].split(".")[-1].lower() in (
        "jpg", "jpeg", "png"
    ):
        extension = ""
    out = []
    for idx, frame in enumerate(frames):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        image = _load_image(cam_name, white_background)
        if image is not None:
            h, w = image.shape[:2]
        else:
            h = int(frame.get("h", contents.get("h", 0)))
            w = int(frame.get("w", contents.get("w", 0)))
            if h == 0 or w == 0:
                continue
        if fovx is not None:
            fx = fov2focal(fovx, w)
            fov_y = focal2fov(fx, h)
            fov_x = fovx
        else:
            fov_y = focal2fov(frame["fl_y"], h)
            fov_x = focal2fov(frame["fl_x"], w)
        out.append(CameraFrame(
            uid=idx, R=R, T=T, fov_x=fov_x, fov_y=fov_y, image=image,
            image_path=cam_name,
            image_name=os.path.splitext(os.path.basename(cam_name))[0],
            width=w, height=h,
        ))
    return out


def read_blender_scene(
    path: str, white_background: bool = False, eval_split: bool = True,
    extension: str = ".png", n_random_points: int = 10_000, seed: int = 0,
) -> CameraScene:
    """readNerfSyntheticInfo (dataset_readers.py:302-335): train/test
    transforms; without COLMAP data the seed cloud is random points in the
    synthetic scene bounds [-1.3, 1.3]^3."""
    train = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension
    )
    test_file = os.path.join(path, "transforms_test.json")
    test = (read_cameras_from_transforms(
        path, "transforms_test.json", white_background, extension)
        if os.path.exists(test_file) else [])
    if not eval_split:
        train = train + test
        test = []
    translate, radius = _nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        from .ply import read_ply

        f = read_ply(ply_path)
        points = np.stack([f["x"], f["y"], f["z"]], -1).astype(np.float32)
        if "red" in f:
            colors = np.stack(
                [f["red"], f["green"], f["blue"]], -1
            ).astype(np.float32) / 255.0
        else:
            colors = np.zeros_like(points)
    else:
        rng = np.random.default_rng(seed)
        points = (rng.random((n_random_points, 3)) * 2.6 - 1.3).astype(np.float32)
        colors = rng.random((n_random_points, 3)).astype(np.float32)
    return CameraScene(points, colors, train, test, translate, radius)


def read_colmap_camera_scene(
    path: str, images_dir: str = "images", eval_split: bool = False,
    llffhold: int = 8, lod: int = 0, white_background: bool = False,
) -> CameraScene:
    """readColmapSceneInfo (dataset_readers.py:154-213): COLMAP sparse
    reconstruction -> posed cameras (sorted by image name; every llffhold-th
    becomes test when eval_split) + the triangulated point cloud.

    `lod` reproduces the reference's LOD split quirk
    (dataset_readers.py:172-180): lod < 50 puts the FIRST lod+1 cameras in
    test, lod >= 50 the first lod+1 in train."""
    from .colmap import qvec2rotmat, read_colmap_scene

    sc = read_colmap_scene(os.path.join(path, "sparse", "0"))
    cams = []
    for img_id in sorted(sc.images, key=lambda i: sc.images[i].name):
        im = sc.images[img_id]
        cam = sc.cameras[im.camera_id]
        Rw2c = qvec2rotmat(im.qvec)
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model in ("PINHOLE", "OPENCV", "SIMPLE_RADIAL", "RADIAL"):
            fx = cam.params[0]
            fy = cam.params[1] if cam.model in ("PINHOLE", "OPENCV") else cam.params[0]
        else:
            raise ValueError(f"unsupported COLMAP camera model {cam.model}")
        image = _load_image(os.path.join(path, images_dir, im.name),
                            white_background)
        cams.append(CameraFrame(
            uid=img_id, R=Rw2c.T, T=im.tvec.astype(np.float64),
            fov_x=focal2fov(fx, cam.width), fov_y=focal2fov(fy, cam.height),
            image=image, image_path=os.path.join(path, images_dir, im.name),
            image_name=os.path.splitext(im.name)[0],
            width=cam.width, height=cam.height,
        ))
    if eval_split:
        if lod > 0:
            if lod < 50:
                train = [c for i, c in enumerate(cams) if i > lod]
                test = [c for i, c in enumerate(cams) if i <= lod]
            else:
                train = [c for i, c in enumerate(cams) if i <= lod]
                test = [c for i, c in enumerate(cams) if i > lod]
        else:
            train = [c for i, c in enumerate(cams) if i % llffhold != 0]
            test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, []
    translate, radius = _nerfpp_norm(train if train else cams)
    colors = (sc.colors.astype(np.float32) / 255.0
              if sc.colors.size else np.zeros((0, 3), np.float32))
    return CameraScene(sc.points.astype(np.float32), colors, train, test,
                       translate, radius)


def load_camera_at_scale(
    cam: CameraFrame, resolution_scale: float = 1.0, resolution: int = -1,
) -> CameraFrame:
    """loadCam's resolution logic (utils/camera_utils.py:23-62 — upstream
    3DGS semantics; the reference's LiDAR fork ships that block commented
    out and always uses full resolution, so this also covers the upstream
    behavior the fork inherited):

      * resolution in {1,2,4,8}: divide both axes by
        resolution_scale * resolution (rounded);
      * resolution == -1: auto-downscale so width <= 1600 px, then apply
        resolution_scale;
      * any other value: treat `resolution` as the target width.

    FoV angles are resolution-invariant, so only image/width/height change.
    """
    orig_w, orig_h = cam.width, cam.height
    if resolution in (1, 2, 4, 8):
        tw = round(orig_w / (resolution_scale * resolution))
        th = round(orig_h / (resolution_scale * resolution))
    else:
        if resolution == -1:
            global_down = orig_w / 1600.0 if orig_w > 1600 else 1.0
        else:
            global_down = orig_w / float(resolution)
        scale = float(global_down) * float(resolution_scale)
        tw, th = int(orig_w / scale), int(orig_h / scale)
    tw, th = max(tw, 1), max(th, 1)
    image = cam.image
    if image is not None and (tw, th) != (orig_w, orig_h):
        from PIL import Image as PILImage

        im = PILImage.fromarray(
            (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        )
        image = np.asarray(
            im.resize((tw, th), PILImage.BILINEAR), np.float32
        ) / 255.0
    return cam._replace(image=image, width=tw, height=th)


def camera_lists_by_scale(
    scene: CameraScene,
    resolution_scales: Tuple[float, ...] = (1.0,),
    resolution: int = -1,
) -> Tuple[dict, dict]:
    """Scene.__init__'s per-scale camera dicts (scene/__init__.py:60-71 +
    cameraList_from_camInfos): {resolution_scale: [CameraFrame, ...]} for
    train and test."""
    train = {
        s: [load_camera_at_scale(c, s, resolution)
            for c in scene.train_cameras]
        for s in resolution_scales
    }
    test = {
        s: [load_camera_at_scale(c, s, resolution)
            for c in scene.test_cameras]
        for s in resolution_scales
    }
    return train, test


def camera_to_json(idx: int, cam: CameraFrame) -> dict:
    """camera_to_JSON (utils/camera_utils.py:64-84): the cameras.json entry
    the reference's Scene writes for external viewers."""
    c2w = cam.c2w
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [row.tolist() for row in c2w[:3, :3]],
        "fy": fov2focal(cam.fov_y, cam.height),
        "fx": fov2focal(cam.fov_x, cam.width),
    }


def save_cameras_json(path: str, scene: CameraScene) -> str:
    """Scene.__init__'s cameras.json dump (scene/__init__.py:66-74)."""
    out = os.path.join(path, "cameras.json")
    entries = [camera_to_json(i, c)
               for i, c in enumerate(scene.train_cameras + scene.test_cameras)]
    with open(out, "w") as f:
        json.dump(entries, f)
    return out


def load_camera_scene(path: str, **kw) -> CameraScene:
    """sceneLoadTypeCallbacks dispatch (scene/__init__.py:46-58): COLMAP
    layout if sparse/ exists, else Blender transforms_train.json."""
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_camera_scene(path, **kw)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, **kw)
    raise ValueError(f"no COLMAP sparse/ or transforms_train.json under {path}")
