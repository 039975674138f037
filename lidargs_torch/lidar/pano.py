"""Range-view (panorama) <-> point-cloud transforms on tensors.

Counterpart of `lidargs_tpu/lidar/pano.py`, with the same conventions:

  * azimuth:  beta = pi - atan2(y, x); column c = beta / (2*pi/W). The
    inverse per-pixel mapping is beta = -(c - W/2)/W * 2*pi.
  * elevation: alpha = atan2(z, sqrt(x^2+y^2)); beam tables ascend, row
    r = H-1-beam_index (row 0 is the highest beam).
  * a range value of 0 means "no return" (ray dropped).

Each function works on the device of its input (numpy arrays are taken as
CPU tensors) and computes in float64, as the numpy reference does; the
evaluation calls `pano_to_lidar` on every rendered frame, on the card.
"""
from __future__ import annotations

import math

import torch


def _t(x, device=None, dtype=torch.float64) -> torch.Tensor:
    """A tensor of `dtype` on `device` (default: where `x` already lives)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def find_closest_beam(beams, angles) -> torch.Tensor:
    """Nearest beam index per angle: clamp below/above, else the nearer of
    the two bracketing beams (ties -> lower index)."""
    angles = _t(angles)
    beams = _t(beams, angles.device)
    pos = torch.searchsorted(beams, angles, side="left")
    pos = pos.clamp(1, len(beams) - 1)
    before = beams[pos - 1]
    after = beams[pos]
    nearer_after = (after - angles) < (angles - before)
    idx = torch.where(nearer_after, pos, pos - 1)
    idx = torch.where(angles >= beams[-1], len(beams) - 1, idx)
    return torch.where(angles <= beams[0], 0, idx)


def lidar_to_pano_with_intensities(points_with_intensities, H: int, W: int,
                                   beam_inclinations=None, lidar_K=None,
                                   max_depth: float = 80.0):
    """Bin a sensor-frame point cloud [N, 4] into (range, intensity)
    panoramas [H, W] with a min-depth z-buffer (the nearest point wins)."""
    pts = _t(points_with_intensities)
    xyz, inten = pts[:, :3], pts[:, 3]
    dist = torch.linalg.vector_norm(xyz, dim=1)

    beta = math.pi - torch.atan2(xyz[:, 1], xyz[:, 0])
    c = torch.round(beta / (2.0 * math.pi / W)).to(torch.int64)
    alpha = torch.atan2(xyz[:, 2], torch.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2))
    if beam_inclinations is not None:
        r = H - 1 - find_closest_beam(_t(beam_inclinations, pts.device), alpha)
    else:
        fov_up, fov = lidar_K
        fov_down = fov - fov_up
        a = alpha + fov_down / 180.0 * math.pi
        r = torch.round(H - a / (fov / 180.0 * math.pi / H)).to(torch.int64)

    ok = (dist < max_depth) & (r >= 0) & (r < H) & (c >= 0) & (c < W)
    r, c, dist, inten = r[ok], c[ok], dist[ok], inten[ok]

    # z-buffer: the nearest point of each pixel, first in a stable
    # far-to-near order when two tie, as the numpy reference's sequential
    # writes leave it
    order = torch.argsort(-dist, stable=True)
    r, c, dist, inten = r[order], c[order], dist[order], inten[order]
    flat = r * W + c
    last = torch.full((H * W,), -1, dtype=torch.int64, device=pts.device)
    last.scatter_reduce_(0, flat, torch.arange(len(flat), device=pts.device), "amax")
    hit = last >= 0
    pano = torch.zeros(H * W, dtype=torch.float64, device=pts.device)
    intensities = torch.zeros_like(pano)
    pano[hit] = dist[last[hit]]
    intensities[hit] = inten[last[hit]]
    return pano.reshape(H, W), intensities.reshape(H, W)


def ray_dirs_from_beams(H: int, W: int, beam_inclinations) -> torch.Tensor:
    """[H, W, 3] unit ray directions in the sensor frame, float64."""
    beams = _t(beam_inclinations)
    i = torch.arange(W, dtype=torch.float64, device=beams.device)[None, :]
    beta = -(i - W / 2.0) / W * 2.0 * math.pi
    alpha = beams.flip(0)[:, None]
    ones = torch.ones((H, W), dtype=torch.float64, device=beams.device)
    return torch.stack([torch.cos(alpha) * torch.cos(beta) * ones,
                        torch.cos(alpha) * torch.sin(beta) * ones,
                        torch.sin(alpha) * ones], -1)


def pano_to_lidar_with_intensities(pano, intensities, beam_inclinations=None,
                                   lidar_K=None) -> torch.Tensor:
    """(H, W) range + intensity panoramas -> [N, 4] sensor-frame points,
    float64, one per pixel with a non-zero range, in row-major order."""
    pano = _t(pano)
    dev = pano.device
    H, W = pano.shape
    if beam_inclinations is not None:
        dirs = ray_dirs_from_beams(H, W, _t(beam_inclinations, dev))
    else:
        fov_up, fov = lidar_K
        i = torch.arange(W, dtype=torch.float64, device=dev)[None, :]
        j = torch.arange(H, dtype=torch.float64, device=dev)[:, None]
        beta = -(i - W / 2.0) / W * 2.0 * math.pi
        alpha = (fov_up - j / H * fov) / 180.0 * math.pi
        dirs = torch.stack([torch.cos(alpha) * torch.cos(beta),
                            torch.cos(alpha) * torch.sin(beta),
                            torch.sin(alpha) * torch.ones((H, W), dtype=torch.float64,
                                                          device=dev)], -1)
    out = torch.cat([dirs * pano[..., None], _t(intensities, dev)[..., None]], -1)
    return out[pano != 0.0]


def pano_to_lidar(pano, beam_inclinations=None, lidar_K=None) -> torch.Tensor:
    """(H, W) range panorama -> [N, 3] points."""
    pano = _t(pano)
    return pano_to_lidar_with_intensities(
        pano, torch.zeros_like(pano), beam_inclinations=beam_inclinations, lidar_K=lidar_K
    )[:, :3]
