"""Evaluation metrics of a rendered range view (host side, numpy/scipy).

Counterpart of `lidargs_tpu/train/metrics.py`: intensity L1/PSNR/SSIM/
MAE/RMSE/MedAE under the rendered ray-drop mask, ray-drop accuracy, and
depth MAE/RMSE/MedAE with the depth clamped to [depth_min, depth_max]. The
eval SSIM follows skimage.structural_similarity's defaults (uniform 7x7
window, unbiased covariance, border crop).

Chamfer distance and F-score wait for the port of `ops/knn.py`; until then
`evaluate_frame` takes only `compute_chamfer=False`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy import ndimage


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
    compute_chamfer: bool = False,
) -> Dict[str, float]:
    if compute_chamfer:
        raise NotImplementedError("chamfer/F-score need ops/knn.py, not ported yet")
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
    return out


def mean_metrics(per_frame: list[Dict[str, float]]) -> Dict[str, float]:
    keys = per_frame[0].keys()
    return {k: float(np.mean([m[k] for m in per_frame])) for k in keys}
