"""Per-gaussian range-view projection ("preprocess").

Counterpart of `lidargs_tpu/ops/projection.py`: `preprocess_gaussians`,
and `preprocess_gaussians_hv`, the same function with a hand-derived
single-pass VJP. One vectorized function over all gaussians:

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

from ..config import RasterConfig

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


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """World-space covariance Sigma = R S^2 R^T, [..., 3, 3]."""
    RS = quat_to_rotmat(quats) * scales[..., None, :]
    return RS @ RS.transpose(-1, -2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)^T v for unit q = (r, x, y, z), without [P, 3, 3] matrices:
    R(q*) v = v + 2 q_v x (q_v x v - r v) for the conjugate q*."""
    r = q[..., :1]
    qv = -q[..., 1:]
    uv = _cross(qv, v)
    return v + 2.0 * (r * uv + _cross(qv, uv))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v for unit q = (r, x, y, z)."""
    r = q[..., :1]
    qv = q[..., 1:]
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


class _PreprocessHV(torch.autograd.Function):
    """`preprocess_gaussians` with the JAX package's hand-derived
    single-pass VJP (`_pg_hv_bwd`): the forward saves only its inputs, and
    the backward recomputes the forward chain (every guard and mask
    included) and accumulates every input cotangent in one pass.

    The cotangents of means, scales, quats, opacities, feat and the pose
    (w2s_rot, w2s_trans) are exact. The `beams` table gets a ZERO gradient,
    as in the JAX package: it is a fixed sensor calibration and is never
    trained (autograd of the plain function would propagate into it).
    `valid`, `radii_xy` and `pix_rect` are not differentiable."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, feat, mask,
                w2s_rot, w2s_trans, beams, W: int, cfg: RasterConfig):
        out = preprocess_gaussians(means3d, scales, quats, opacities, feat, mask,
                                   w2s_rot, w2s_trans, beams, W, cfg)
        ctx.save_for_backward(means3d, scales, quats, opacities, mask,
                              w2s_rot, w2s_trans, beams)
        ctx.W, ctx.cfg = W, cfg
        ctx.mark_non_differentiable(out.valid, out.radii_xy, out.pix_rect)
        return tuple(out)

    @staticmethod
    def backward(ctx, _g_valid, g_depth, g_mean, g_u1, g_u2, g_conic, g_opac,
                 g_feat, g_center, _g_radii, _g_rect):
        means3d, scales, quats, opacities, mask, w2s_rot, w2s_trans, beams = ctx.saved_tensors
        W, cfg = ctx.W, ctx.cfg
        grads = _pg_hv_bwd(means3d, scales, quats, mask, w2s_rot, w2s_trans, beams, W, cfg,
                           g_depth, g_mean, g_u1, g_u2, g_conic, g_opac, g_center)
        g_means, g_scales, g_quats, g_opac_in, g_R, g_t = grads
        return (g_means, g_scales, g_quats, g_opac_in, g_feat, None,
                g_R, g_t, torch.zeros_like(beams), None, None)


def preprocess_gaussians_hv(means3d, scales, quats, opacities, feat, mask,
                            w2s_rot, w2s_trans, beams, W: int,
                            cfg: RasterConfig) -> Splats:
    """`preprocess_gaussians` with the hand-derived single-pass VJP of
    `_PreprocessHV` (zero gradient for `beams`)."""
    return Splats(*_PreprocessHV.apply(means3d, scales, quats, opacities, feat, mask,
                                       w2s_rot, w2s_trans, beams, W, cfg))


def _pg_hv_bwd(means3d, scales, quats, mask, w2s_rot, w2s_trans, beams, W: int,
               cfg: RasterConfig,
               g_depth, g_mean, g_u1, g_u2, g_conic, g_opac, g_center):
    """The input cotangents of `preprocess_gaussians` (the JAX package's
    `_pg_hv_bwd`, line for line), in the inputs' dtype: (means, scales,
    quats, opacities, w2s_rot, w2s_trans). The feat cotangent passes
    through unchanged."""
    H = beams.shape[0]
    dt = means3d.dtype
    two_pi = 2.0 * math.pi
    g_depth, g_mean, g_u1, g_u2, g_conic, g_opac, g_center = (
        x.to(dt) for x in (g_depth, g_mean, g_u1, g_u2, g_conic, g_opac, g_center))
    zero = torch.zeros((), dtype=dt, device=means3d.device)
    one = torch.ones((), dtype=dt, device=means3d.device)

    # ---- recompute the forward chain (every guard and mask included) ----
    p_view_raw = means3d @ w2s_rot.T + w2s_trans
    sq = (p_view_raw * p_view_raw).sum(-1)
    mask2 = mask & (sq > 0.0)
    e_x = unit_x(3, dt, means3d.device)
    p_view = torch.where(mask2[..., None], p_view_raw, e_x)
    dist = torch.sqrt((p_view * p_view).sum(-1))
    valid = mask2 & (dist < cfg.far) & (dist > cfg.near)

    safe_dist = dist.clamp_min(1e-12)
    dirn = p_view / safe_dist[..., None]
    horiz2 = dirn[..., 0] ** 2 + dirn[..., 1] ** 2
    degenerate = horiz2 <= 0.0
    valid = valid & ~degenerate
    u1_raw = torch.stack([dirn[..., 1], -dirn[..., 0], torch.zeros_like(dist)], -1)
    u1_raw = torch.where(degenerate[..., None], e_x, u1_raw)
    u1_len = torch.sqrt(torch.where(degenerate, one, horiz2))
    u1 = u1_raw / u1_len[..., None]
    u2 = _cross(dirn, u1)

    u1w = u1 @ w2s_rot
    u2w = u2 @ w2s_rot
    w1 = quat_rotate_inv(quats, u1w)
    w2 = quat_rotate_inv(quats, u2w)
    v1 = w1 * scales
    v2 = w2 * scales
    inv_d2 = 1.0 / (dist * dist).clamp_min(1e-20)
    a = ((v1 * v1).sum(-1) + cfg.lowpass) * inv_d2
    b = (v1 * v2).sum(-1) * inv_d2
    c = ((v2 * v2).sum(-1) + cfg.lowpass) * inv_d2
    det = a * c - b * b
    validc = valid & (det > 0.0)
    det_safe = torch.where(det > 0.0, det, one)

    p_flat = torch.where(degenerate[..., None], e_x, p_view)
    horiz = torch.sqrt(torch.where(degenerate, one, p_flat[..., 0] ** 2 + p_flat[..., 1] ** 2))
    alpha_el = torch.atan2(p_flat[..., 2], horiz)
    row, gap, row_ok = _project_rows(alpha_el, beams, cfg.ray_divergence_angle)
    # the conic/opacity/depth masks use the FINAL valid, which includes the
    # rect-area test, so the radii chain is recomputed (none of its outputs
    # is differentiable)
    validf = validc & row_ok
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt((mid * mid - det).clamp_min(1e-9))
    sigma = torch.sqrt(lam_max.clamp_min(1e-9))
    beta = math.pi - torch.atan2(p_flat[..., 1], p_flat[..., 0])
    p_c = beta / (two_pi / W)
    p_r = H - row - 1.0
    tan_col = torch.tan(torch.full((), two_pi / W, dtype=torch.float32, device=means3d.device))
    r_y = torch.ceil(3.0 * sigma / torch.tan(gap.abs()))
    r_x = torch.ceil(3.0 * sigma / tan_col.to(dt))
    bx, by = cfg.ref_block_x, cfg.ref_block_y
    grid_x = -(-W // bx)
    rmin_x = torch.floor((p_c - r_x) / bx).clamp(0, grid_x)
    rmax_x = torch.floor((p_c + r_x + bx - 1) / bx).clamp(0, grid_x)
    rmin_y = _round_half_away((p_r - r_y) / by).clamp(0, H)
    rmax_y = torch.maximum(_round_half_away(p_r + r_y / by),
                           _round_half_away(p_r / by) + 1).clamp(0, H)
    vf = validf & ((rmax_x - rmin_x) * (rmax_y - rmin_y) > 0)
    vf3 = vf[..., None]

    # ---- cotangent accumulation (reverse order) ----
    # conic = [c, -b, a] / det_safe, zero where not valid
    g_conic = torch.where(vf3, g_conic, zero)
    g0, g1, g2 = g_conic[..., 0], g_conic[..., 1], g_conic[..., 2]
    inv_det = 1.0 / det_safe
    g_a = g2 * inv_det
    g_b = -g1 * inv_det
    g_c = g0 * inv_det
    g_det = -(c * g0 - b * g1 + a * g2) * inv_det * inv_det
    # det = a c - b^2 (only where det > 0 did the division use det)
    g_a = g_a + g_det * c
    g_c = g_c + g_det * a
    g_b = g_b - 2.0 * b * g_det

    # a, b, c <- v1, v2, inv_d2
    g_v1 = (2.0 * g_a[..., None] * v1 + g_b[..., None] * v2) * inv_d2[..., None]
    g_v2 = (2.0 * g_c[..., None] * v2 + g_b[..., None] * v1) * inv_d2[..., None]
    g_invd2 = (g_a * ((v1 * v1).sum(-1) + cfg.lowpass)
               + g_b * (v1 * v2).sum(-1)
               + g_c * ((v2 * v2).sum(-1) + cfg.lowpass))
    # inv_d2 = 1 / max(d^2, eps): d > near >= 0 where the conic cotangent
    # is nonzero, so the max is inactive there
    g_dist = -2.0 * g_invd2 * inv_d2 / dist.clamp_min(1e-12)

    # v = w * s
    g_w1 = g_v1 * scales
    g_w2 = g_v2 * scales
    g_scales = g_v1 * w1 + g_v2 * w2

    # w = R(q)^T u  ->  g_u = R(q) g_w ; g_R(q) = u g_w^T (outer, per row)
    g_u1w = quat_rotate(quats, g_w1)
    g_u2w = quat_rotate(quats, g_w2)
    G = u1w[..., :, None] * g_w1[..., None, :] + u2w[..., :, None] * g_w2[..., None, :]
    r_, x_, y_, z_ = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    G00, G01, G02 = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    G10, G11, G12 = G[..., 1, 0], G[..., 1, 1], G[..., 1, 2]
    G20, G21, G22 = G[..., 2, 0], G[..., 2, 1], G[..., 2, 2]
    g_qr = 2.0 * (-G01 * z_ + G02 * y_ + G10 * z_ - G12 * x_ - G20 * y_ + G21 * x_)
    g_qx = 2.0 * (G01 * y_ + G02 * z_ + G10 * y_ - 2 * x_ * G11
                  - r_ * G12 + G20 * z_ + r_ * G21 - 2 * x_ * G22)
    g_qy = 2.0 * (-2 * y_ * G00 + x_ * G01 + r_ * G02 + x_ * G10
                  + z_ * G12 - r_ * G20 + z_ * G21 - 2 * y_ * G22)
    g_qz = 2.0 * (-2 * z_ * G00 - r_ * G01 + x_ * G02 + r_ * G10
                  - 2 * z_ * G11 + y_ * G12 + x_ * G20 + y_ * G21)
    g_quats = torch.stack([g_qr, g_qx, g_qy, g_qz], -1)

    # u1w = u1 @ R -> g_u1 += g_u1w @ R^T
    g_u1 = g_u1 + g_u1w @ w2s_rot.T
    g_u2 = g_u2 + g_u2w @ w2s_rot.T

    # u2 = dirn x u1
    g_dirn = _cross(u1, g_u2)
    g_u1 = g_u1 + _cross(g_u2, dirn)

    # u1 = u1_raw / u1_len with the degenerate guard (both constant there)
    live = ~degenerate
    g_u1m = torch.where(live[..., None], g_u1, zero)
    g_u1raw = g_u1m / u1_len[..., None]
    g_u1len = -(g_u1m * u1).sum(-1) / u1_len
    # u1_len = sqrt(horiz2) on live rows; horiz2 = nx^2 + ny^2
    g_h2 = torch.where(live, 0.5 * g_u1len / u1_len, zero)
    # u1_raw = [ny, -nx, 0]
    g_nx = -g_u1raw[..., 1] + 2.0 * g_h2 * dirn[..., 0]
    g_ny = g_u1raw[..., 0] + 2.0 * g_h2 * dirn[..., 1]
    g_dirn = g_dirn + torch.stack([g_nx, g_ny, torch.zeros_like(g_nx)], -1)

    # sphere_mean output
    g_dirn = g_dirn + g_mean

    # center: p_c = (pi - atan2(py, px)) W / 2pi; p_r = H - row - 1 with
    # drow/dalpha = 1/gap; alpha = atan2(pz, horiz), horiz = |(px, py)|
    # (all on p_flat; constant e_x on degenerate rows)
    g_pc = g_center[..., 0]
    g_pr = g_center[..., 1]
    h2f = torch.where(live, p_flat[..., 0] ** 2 + p_flat[..., 1] ** 2, one)
    d2f = h2f + p_flat[..., 2] ** 2
    Wc = W / two_pi
    g_fx = torch.where(live, g_pc * Wc * p_flat[..., 1] / h2f, zero)
    g_fy = torch.where(live, -g_pc * Wc * p_flat[..., 0] / h2f, zero)
    g_alpha = -g_pr / gap
    g_fz = torch.where(live, g_alpha * horiz / d2f, zero)
    g_hor = torch.where(live, -g_alpha * p_flat[..., 2] / d2f, zero)
    g_fx = g_fx + torch.where(live, g_hor * p_flat[..., 0] / horiz, zero)
    g_fy = g_fy + torch.where(live, g_hor * p_flat[..., 1] / horiz, zero)
    g_pview = torch.stack([g_fx, g_fy, g_fz], -1)

    # depth = where(valid, dist, sentinel)
    g_dist = g_dist + torch.where(vf, g_depth, zero)

    # dirn = p_view / safe_dist: g_p += (g_dirn - dirn (dirn . g_dirn)) / d
    gd_dot = (g_dirn * dirn).sum(-1)
    g_pview = g_pview + (g_dirn - dirn * gd_dot[..., None]) / safe_dist[..., None]
    # dist = |p_view| (p_view is e_x on masked rows, so dist = 1 there)
    g_pview = g_pview + g_dist[..., None] * dirn

    # p_view = where(mask2, p_view_raw, e_x)
    g_praw = torch.where(mask2[..., None], g_pview, zero)

    # p_view_raw = means @ R^T + t
    g_means = g_praw @ w2s_rot
    lead = tuple(range(g_praw.dim() - 1))
    g_t = g_praw.sum(dim=lead)
    # pose rotation: p = m R^T (R_ji gets m_i g_p_j), plus the u1w/u2w
    # chains (u1w_j = u1_i R_ij)
    flat = lambda x: x.reshape(-1, 3)
    g_R = (flat(g_praw).T @ flat(means3d)
           + flat(u1).T @ flat(g_u1w)
           + flat(u2).T @ flat(g_u2w))

    # opacity = where(valid, opacities, 0)
    g_opacities = torch.where(vf, g_opac, zero)
    return g_means, g_scales, g_quats, g_opacities, g_R, g_t


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
