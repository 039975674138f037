"""The training loss, the reference's: a frozen copy of the port's
(`train/losses.py`): the 11x11 sigma-1.5 gaussian-window SSIM as two
shift-and-accumulate passes, the five-term LiDAR loss, and the surfel
variant's normal consistency. The scale regularizer multiplies the scales
out with `torch.prod` and its own backward (the port has a hand one).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def l1_loss(x, y):
    return torch.mean(torch.abs(x - y))


def l2_loss(x, y):
    return torch.mean((x - y) ** 2)


def _sep_conv(x: torch.Tensor, g: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero-padded 'same' 1-D convolution along `axis` of [C,H,W] as a
    shift-and-accumulate sum of `len(g)` scaled slices, exact in float32."""
    taps = g.shape[0]
    r = taps // 2
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - axis)] = r          # F.pad lists the last axis first
    pad[2 * (x.dim() - 1 - axis) + 1] = r
    xp = F.pad(x, pad)
    n = x.shape[axis]
    out = torch.zeros_like(x)
    for t in range(taps):
        out = out + g[t] * xp.narrow(axis, t, n)
    return out


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """[C,H,W] single-image SSIM, mean-reduced."""
    x = torch.arange(window_size, dtype=torch.float32, device=img1.device) - window_size // 2
    g = torch.exp(-(x ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()

    def conv(z):
        return _sep_conv(_sep_conv(z, g, axis=1), g, axis=2)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # window variances are >= 0; clamp the residual float cancellation so
    # the denominator stays positive
    s1 = (conv(img1 * img1) - mu1_sq).clamp_min(0.0)
    s2 = (conv(img2 * img2) - mu2_sq).clamp_min(0.0)
    s12 = conv(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(m)


class LossTerms(NamedTuple):
    total: torch.Tensor
    depth: torch.Tensor
    intensity: torch.Tensor
    raydrop: torch.Tensor
    scale_reg: torch.Tensor
    grad_x: torch.Tensor
    l1_intensity: torch.Tensor
    ssim_intensity: torch.Tensor


def lidar_losses(
    render_color: torch.Tensor,   # [2,H,W] intensity, raydrop
    render_depth: torch.Tensor,   # [H,W]
    gt_image: torch.Tensor,       # [3,H,W] raydrop, intensity, depth
    scaling: torch.Tensor,        # [N,3] (or [C,k,3]) decoded cov scales
    scaling_mask: torch.Tensor,   # [N] (or [C,k]) gaussians that exist
    lambda_dssim: float = 0.2,
    raydrop_lambda: float = 10.0,
    scale_reg: float = 0.01,
    grad_clip_x: float = 0.01,
    pixel_mask: Optional[torch.Tensor] = None,   # optional [H,W] bool loss mask
) -> LossTerms:
    """The five-term training loss: GT-raydrop-masked depth L1, the
    intensity L1/SSIM mix, raydrop MSE, the scale-product regularizer and
    the masked azimuth-gradient L1. `pixel_mask` restricts every pixel term
    to a region."""
    ray_drop = gt_image[0:1]
    if pixel_mask is not None:
        ray_drop = ray_drop * pixel_mask[None]
    gt_intensity = gt_image[1:2] * ray_drop
    gt_depth = gt_image[2:3] * ray_drop

    render_intensity = render_color[0:1] * ray_drop
    render_raydrop = render_color[1:2]
    if pixel_mask is not None:
        render_raydrop = render_raydrop * pixel_mask[None]
    depth = render_depth[None] * ray_drop

    raydrop_loss = raydrop_lambda * l2_loss(render_raydrop, ray_drop)
    ll1 = l1_loss(render_intensity, gt_intensity)
    depth_loss = l1_loss(depth, gt_depth)
    ssim_loss = 1.0 - ssim(render_intensity, gt_intensity)
    intensity_loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * ssim_loss

    mask_f = scaling_mask.to(scaling.dtype)
    n_sel = mask_f.sum().clamp_min(1.0)
    scaling_reg = scale_reg * torch.sum(torch.prod(scaling, dim=-1) * mask_f) / n_sel

    pred_gx = torch.abs(depth[:, :, :-1] - depth[:, :, 1:])
    gt_gx = torch.abs(gt_depth[:, :, :-1] - gt_depth[:, :, 1:])
    mask_dx = ray_drop[:, :, :-1] * (gt_gx < grad_clip_x)
    grad_loss = l1_loss(pred_gx * mask_dx, gt_gx * mask_dx)

    total = depth_loss + intensity_loss + raydrop_loss + scaling_reg + grad_loss
    return LossTerms(
        total=total,
        depth=depth_loss,
        intensity=intensity_loss,
        raydrop=raydrop_loss,
        scale_reg=scaling_reg,
        grad_x=grad_loss,
        l1_intensity=ll1,
        ssim_intensity=ssim_loss,
    )


# --- surfel (2DGS) regularizers: the surfel rasterizer computes the
# distortion, normal and median-depth channels; the weights follow the 2DGS
# paper ---


def depth_normals(depth: torch.Tensor, beams: torch.Tensor, W: int) -> torch.Tensor:
    """Differentiable surface normals of a range image: back-project each
    pixel along its beam ray and cross the finite differences. [3, H, W],
    zero where the cross product vanishes."""
    H = beams.shape[0]
    dev = depth.device
    rows = torch.arange(H, device=dev)[:, None].expand(H, depth.shape[1])
    cols = torch.arange(depth.shape[1], device=dev)[None, :].expand(H, depth.shape[1])
    alp = beams[H - 1 - rows]
    beta = -(cols.to(torch.float32) - W / 2.0) / W * 2.0 * math.pi
    dirs = torch.stack([torch.cos(alp) * torch.cos(beta), torch.cos(alp) * torch.sin(beta),
                        torch.sin(alp)], 0)
    pts = dirs * depth[None]                                   # [3,H,W]
    dc = torch.diff(pts, dim=2, append=pts[:, :, -1:])
    dr = torch.diff(pts, dim=1, append=pts[:, -1:, :])
    n = torch.linalg.cross(dc, dr, dim=0)
    # double where: sqrt at 0 has a NaN gradient even where the rows are
    # masked downstream (empty pixels have zero cross products)
    nn2 = (n * n).sum(0, keepdim=True)
    ok = nn2 > 1e-16
    return torch.where(ok, n, torch.zeros_like(n)) / torch.sqrt(
        torch.where(ok, nn2, torch.ones_like(nn2)))


def normal_consistency_loss(normal: torch.Tensor, depth: torch.Tensor, beams: torch.Tensor,
                            W: int, hit_mask: torch.Tensor) -> torch.Tensor:
    """2DGS normal consistency: the mean of 1 - |n_render . n_depth| over the
    hit pixels with depth > 0. Both normals are in the sensor frame
    (`render_surfels` emits sensor-frame normals)."""
    nd = depth_normals(depth, beams, W)
    rn2 = (normal * normal).sum(0, keepdim=True)
    rok = rn2 > 1e-16
    nr = torch.where(rok, normal, torch.zeros_like(normal)) / torch.sqrt(
        torch.where(rok, rn2, torch.ones_like(rn2)))
    cos = (nr * nd).sum(0)
    m = hit_mask * (depth > 0)
    return ((1.0 - cos.abs()) * m).sum() / m.sum().clamp_min(1.0)
