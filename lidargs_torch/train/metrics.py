"""Evaluation metrics of a rendered range view.

Counterpart of `lidargs_tpu/train/metrics.py`: intensity L1/PSNR/SSIM/
MAE/RMSE/MedAE under the rendered ray-drop mask, ray-drop accuracy, and
depth MAE/RMSE/MedAE with the depth clamped to [depth_min, depth_max]
(host side, numpy/scipy). The eval SSIM follows
skimage.structural_similarity's defaults (uniform 7x7 window, unbiased
covariance, border crop). With `compute_chamfer` (the default, as in the
JAX package) it adds the depth chamfer distance and F-score (tau = 0.05 on
squared distances) of the back-projected clouds: those are computed on the
device of the render, and only their scalars come to the host.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from scipy import ndimage

from ..lidar.pano import pano_to_lidar
from ..ops.knn import chamfer_distance, fscore


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def eval_ssim(img1: np.ndarray, img2: np.ndarray, win: int = 7,
              data_range: float = 1.0) -> float:
    """skimage.metrics.structural_similarity semantics: uniform win x win
    filter, unbiased covariance (N/(N-1)), crop (win-1)//2 borders."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    NP = win * win
    cov_norm = NP / (NP - 1)
    uf = lambda x: ndimage.uniform_filter(x, size=win, mode="nearest")
    ux, uy = uf(img1), uf(img2)
    uxx, uyy, uxy = uf(img1 * img1), uf(img2 * img2), uf(img1 * img2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux**2 + uy**2 + c1) * (vx + vy + c2)
    )
    pad = (win - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def evaluate_frame(
    render_color,                 # [2,H,W]
    render_depth,                 # [H,W]
    gt_image,                     # [3,H,W] raydrop, intensity, depth
    beams,
    depth_min: float = 5.0,
    depth_max: float = 80.0,
    compute_chamfer: bool = True,
) -> Dict[str, float]:
    if compute_chamfer:
        depth_cd, depth_fscore = _chamfer_metrics(render_color, render_depth, gt_image,
                                                  beams, depth_min, depth_max)
    render_color = _host(render_color)
    render_depth = _host(render_depth)
    gt_image = _host(gt_image)

    ray_drop = gt_image[0]
    gt_intensity = gt_image[1] * ray_drop
    gt_depth = gt_image[2] * ray_drop

    rd_mask = (render_color[1] > 0.5).astype(np.float32)
    image = np.clip(render_color[0], 0.0, 1.0) * rd_mask

    err = np.abs(image - gt_intensity)
    mse = float((err**2).mean())
    out = {
        "intensity_l1": float(err.mean()),
        "intensity_psnr": float(20 * np.log10(1.0 / np.sqrt(max(mse, 1e-20)))),
        "intensity_mae": float(err.mean()),
        "intensity_rmse": float(np.sqrt((err**2).mean())),
        "intensity_medae": float(np.median(err)),
        "intensity_ssim": eval_ssim(image, gt_intensity),
        "raydrop_acc": float((rd_mask == ray_drop).mean()),
    }

    depth_render = np.clip(render_depth, depth_min, depth_max) * rd_mask
    derr = np.abs(depth_render - gt_depth)
    out.update(
        depth_mae=float(derr.mean()),
        depth_rmse=float(np.sqrt((derr**2).mean())),
        depth_medae=float(np.median(derr)),
    )
    if compute_chamfer:
        out["depth_cd"] = depth_cd
        out["depth_fscore"] = depth_fscore
    return out


def _chamfer_metrics(render_color, render_depth, gt_image, beams, depth_min: float,
                     depth_max: float):
    """(depth_cd, depth_fscore) of the masked, clamped rendered depth against
    the GT depth, on the device of `render_depth` (the CPU for numpy
    inputs); an empty cloud on either side gives (inf, 0)."""
    depth = torch.as_tensor(render_depth)
    dev = depth.device
    color = torch.as_tensor(render_color, device=dev)
    gt = torch.as_tensor(gt_image, device=dev)
    beams = torch.as_tensor(beams, device=dev)
    rd_mask = (color[1] > 0.5).to(torch.float32)
    pred_pts = pano_to_lidar(depth.clamp(depth_min, depth_max) * rd_mask, beams)
    gt_pts = pano_to_lidar(gt[2] * gt[0], beams)
    if len(pred_pts) == 0 or len(gt_pts) == 0:
        return float("inf"), 0.0
    cd, d1, d2, v1, v2 = chamfer_distance(pred_pts, gt_pts)
    return cd, fscore(d1, d2, threshold=0.05, v1=v1, v2=v2)[0]


def mean_metrics(per_frame: list[Dict[str, float]]) -> Dict[str, float]:
    keys = per_frame[0].keys()
    return {k: float(np.mean([m[k] for m in per_frame])) for k in keys}
