"""Per-gaussian range-view projection ("preprocess"), the reference's.

A frozen copy of the port's plain `preprocess_gaussians`, `pack_splats`
and `visible_filter`, differentiated by autograd (the port's step runs a
hand VJP instead). One vectorized function over all gaussians:

  * view transform + euclidean range cull
  * micro cross-section basis u1, u2 perpendicular to the ray
  * covariance projected on that plane, + lowpass, scaled by 1/dist^2
  * conic + max-eigenvalue radius
  * azimuth column p_c and elevation row p_r (binary search over the
    ascending beam table, fractional interpolation, divergence rejection)
  * anisotropic pixel radii and the reference's 16x1-block rect, kept in
    pixel units as the "parity rect" that compositing masks with.

Everything stays float32, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import RasterConfig

_TWO_PI = 2.0 * math.pi


def unit_x(n: int, dtype, device) -> torch.Tensor:
    """[n] (1, 0, ..., 0), made on `device` by a kernel: a tensor built from
    Python data would be a host-to-device copy, which a CUDA graph cannot
    hold."""
    return torch.eye(n, dtype=dtype, device=device)[0]


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (r, x, y, z) -> [..., 3, 3] rotation matrix. The caller
    normalizes."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)^T v for unit q = (r, x, y, z), without [P, 3, 3] matrices:
    R(q*) v = v + 2 q_v x (q_v x v - r v) for the conjugate q*."""
    r = q[..., :1]
    qv = -q[..., 1:]
    uv = _cross(qv, v)
    return v + 2.0 * (r * uv + _cross(qv, uv))


class Splats(NamedTuple):
    """Preprocessed per-gaussian render state. The leading shape [P] is
    whatever the caller passed in."""

    valid: torch.Tensor        # [P] bool — survives culling
    depth: torch.Tensor        # [P] euclidean range (4*far on invalid rows)
    sphere_mean: torch.Tensor  # [P,3] unit view direction of the mean
    u1: torch.Tensor           # [P,3] cross-section basis 1 (view space)
    u2: torch.Tensor           # [P,3] cross-section basis 2 (view space)
    conic: torch.Tensor        # [P,3] inverse 2x2 covariance (a, b, c)
    opacity: torch.Tensor      # [P]
    feat: torch.Tensor         # [P,C] composited channels
    center: torch.Tensor       # [P,2] float image coords (p_c, p_r)
    radii_xy: torch.Tensor     # [P,2] int32 pixel radii (r_x, r_y)
    pix_rect: torch.Tensor     # [P,4] int32 parity rect x0, x1, y0, y1


def _project_rows(alpha_el: torch.Tensor, beams: torch.Tensor, rda: float,
                  margin: float = 2.0):
    """Elevation angle -> fractional row (pre-flip), local beam gap and
    divergence rejection, including the asymmetric index-0 branch."""
    H = beams.shape[0]
    idx = torch.searchsorted(beams, alpha_el.contiguous(), side="left")
    idx = idx.clamp(0, H - 1)
    hi = idx > 0
    before = torch.where(hi, beams[(idx - 1).clamp_min(0)], beams[0])
    after = torch.where(hi, beams[idx], beams[1])
    gap = after - before
    row_hi = (idx - 1).to(alpha_el.dtype) + (alpha_el - before) / gap
    row_lo = 1 + (alpha_el - after) / gap
    row = torch.where(hi, row_hi, row_lo)
    ok = torch.where(hi, alpha_el <= after + margin * rda,
                     alpha_el >= before - margin * rda)
    return row, gap, ok


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C round() for the (non-negative after clamping) rect bounds."""
    return torch.floor(x + 0.5)


def preprocess_gaussians(
    means3d: torch.Tensor,     # [...,3] world
    scales: torch.Tensor,      # [...,3] covariance scales (activated)
    quats: torch.Tensor,       # [...,4] normalized (r,x,y,z)
    opacities: torch.Tensor,   # [...]
    feat: torch.Tensor,        # [...,C]
    mask: torch.Tensor,        # [...] bool — upstream validity
    w2s_rot: torch.Tensor,     # [3,3]
    w2s_trans: torch.Tensor,   # [3]
    beams: torch.Tensor,       # [H] ascending inclinations
    W: int,
    cfg: RasterConfig,
) -> Splats:
    H = beams.shape[0]
    f32 = torch.float32
    p_view_raw = means3d @ w2s_rot.T + w2s_trans

    # padded/degenerate rows are replaced by a safe point before any
    # singular op, as in the JAX package
    sq = (p_view_raw * p_view_raw).sum(-1)
    mask = mask & (sq > 0.0)
    e_x = unit_x(3, p_view_raw.dtype, means3d.device)
    p_view = torch.where(mask[..., None], p_view_raw, e_x)
    dist = torch.sqrt((p_view * p_view).sum(-1))
    valid = mask & (dist < cfg.far) & (dist > cfg.near)

    # --- micro cross-section basis (view space) ---
    safe_dist = dist.clamp_min(1e-12)
    dirn = p_view / safe_dist[..., None]
    horiz2 = dirn[..., 0] ** 2 + dirn[..., 1] ** 2
    degenerate = horiz2 <= 0.0
    valid = valid & ~degenerate
    u1_raw = torch.stack([dirn[..., 1], -dirn[..., 0], torch.zeros_like(dist)], -1)
    u1_raw = torch.where(degenerate[..., None], e_x, u1_raw)
    u1_len = torch.sqrt(torch.where(degenerate, torch.ones_like(horiz2), horiz2))
    u1 = u1_raw / u1_len[..., None]
    u2 = _cross(dirn, u1)

    # --- projected 2x2 covariance: cov_ab = (S R^T W^T u_a) . (S R^T W^T u_b)
    v1 = quat_rotate_inv(quats, u1 @ w2s_rot) * scales
    v2 = quat_rotate_inv(quats, u2 @ w2s_rot) * scales
    inv_d2 = 1.0 / (dist * dist).clamp_min(1e-20)
    a = ((v1 * v1).sum(-1) + cfg.lowpass) * inv_d2
    b = (v1 * v2).sum(-1) * inv_d2
    c = ((v2 * v2).sum(-1) + cfg.lowpass) * inv_d2

    det = a * c - b * b
    valid = valid & (det > 0.0)
    det_safe = torch.where(det > 0.0, det, torch.ones_like(det))
    conic = torch.stack([c, -b, a], -1) / det_safe[..., None]

    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt((mid * mid - det).clamp_min(1e-9))
    sigma = torch.sqrt(lam_max.clamp_min(1e-9))

    # --- range-image coordinates ---
    p_flat = torch.where(degenerate[..., None], e_x, p_view)
    beta = math.pi - torch.atan2(p_flat[..., 1], p_flat[..., 0])
    p_c = beta / (_TWO_PI / W)
    horiz = torch.sqrt(torch.where(degenerate, torch.ones_like(horiz2),
                                   p_flat[..., 0] ** 2 + p_flat[..., 1] ** 2))
    alpha_el = torch.atan2(p_flat[..., 2], horiz)
    row, gap, row_ok = _project_rows(alpha_el, beams, cfg.ray_divergence_angle)
    valid = valid & row_ok
    p_r = H - row - 1.0

    # tan of the column pitch in f32, as jnp.tan of the weak-typed scalar
    tan_col = torch.tan(torch.full((), _TWO_PI / W, dtype=f32, device=means3d.device))
    r_y = torch.ceil(3.0 * sigma / torch.tan(gap.abs()))
    r_x = torch.ceil(3.0 * sigma / tan_col)

    # --- the reference's tile rect (BLOCK 16x1), kept in pixel units ---
    bx, by = cfg.ref_block_x, cfg.ref_block_y
    grid_x = -(-W // bx)
    rmin_x = torch.floor((p_c - r_x) / bx).clamp(0, grid_x)
    rmax_x = torch.floor((p_c + r_x + bx - 1) / bx).clamp(0, grid_x)
    rmin_y = _round_half_away((p_r - r_y) / by).clamp(0, H)
    rmax_y = torch.maximum(_round_half_away(p_r + r_y / by),
                           _round_half_away(p_r / by) + 1).clamp(0, H)
    valid = valid & ((rmax_x - rmin_x) * (rmax_y - rmin_y) > 0)

    pix_rect = torch.stack([rmin_x * bx, rmax_x * bx, rmin_y * by, rmax_y * by], -1)

    v1d = valid[..., None]
    # finite sort-last sentinel (inf would 0*inf=NaN in masked compositing)
    depth_sentinel = 4.0 * cfg.far
    return Splats(
        valid=valid,
        depth=torch.where(valid, dist, torch.full_like(dist, depth_sentinel)).to(f32),
        sphere_mean=dirn.to(f32),
        u1=u1.to(f32),
        u2=u2.to(f32),
        conic=torch.where(v1d, conic, torch.zeros_like(conic)).to(f32),
        opacity=torch.where(valid, opacities, torch.zeros_like(opacities)).to(f32),
        feat=feat.to(f32),
        center=torch.stack([p_c, p_r], -1).to(f32),
        radii_xy=torch.where(v1d, torch.stack([r_x, r_y], -1),
                             torch.zeros_like(pix_rect[..., :2])).to(torch.int32),
        pix_rect=pix_rect.to(torch.int32),
    )


class PackedCols:
    """Column layout of the packed per-gaussian render state [P, F]: one
    wide row per gaussian, so binning and compositing gather one
    contiguous 4*F-byte row. rect/center/valid ride along as floats (pixel
    coords < 2^24 are exact in f32). The CUDA composite kernel reads the
    same layout (csrc/composite_fwd.cu)."""

    MEAN = slice(0, 3)        # sphere_mean (unit view dir)
    U1 = slice(3, 6)          # cross-section basis 1
    U2 = slice(6, 9)
    CONIC = slice(9, 12)      # (a, b, c)
    OPACITY = 12
    DEPTH = 13
    FEAT0 = 14                # feat columns [FEAT0, FEAT0+C)

    @staticmethod
    def rect(C: int) -> slice:       # parity rect x0,x1,y0,y1
        return slice(14 + C, 18 + C)

    @staticmethod
    def center(C: int) -> slice:     # float image coords (p_c, p_r)
        return slice(18 + C, 20 + C)

    @staticmethod
    def validf(C: int) -> int:
        return 20 + C

    @staticmethod
    def width(C: int) -> int:        # padded to a multiple of 8 columns
        return -(-(21 + C) // 8) * 8


def pack_splats(sp: Splats) -> torch.Tensor:
    """Splats -> packed [..., F] f32 (PackedCols layout)."""
    C = sp.feat.shape[-1]
    cols = [
        sp.sphere_mean,
        sp.u1,
        sp.u2,
        sp.conic,
        sp.opacity[..., None],
        sp.depth[..., None],
        sp.feat,
        sp.pix_rect.to(torch.float32),
        sp.center,
        sp.valid.to(torch.float32)[..., None],
    ]
    pk = torch.cat(cols, dim=-1)
    return F.pad(pk, (0, PackedCols.width(C) - pk.shape[-1]))


def visible_filter(
    anchors: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    mask: torch.Tensor,
    w2s_rot: torch.Tensor,
    w2s_trans: torch.Tensor,
    beams: torch.Tensor,
    W: int,
    cfg: RasterConfig,
) -> torch.Tensor:
    """Anchor pre-culling (the reference's prefilter_voxel): the `radii > 0`
    boolean mask of the anchors projected as gaussians."""
    P = anchors.shape[0]
    dev = anchors.device
    splats = preprocess_gaussians(
        anchors, scales, quats,
        torch.ones((P,), dtype=torch.float32, device=dev),
        torch.zeros((P, 1), dtype=torch.float32, device=dev),
        mask, w2s_rot, w2s_trans, beams, W, cfg,
    )
    return splats.valid
