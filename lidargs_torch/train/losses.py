"""Losses and image metrics of the training step.

Counterpart of `lidargs_tpu/train/losses.py`: l1/l2, PSNR, the 11x11
sigma-1.5 gaussian-window SSIM with zero 'same' padding, and the five-term
LiDAR training loss. The SSIM windows are two shift-and-accumulate 1-D
passes (`_sep_conv`), never a convolution: a convolution in reduced
precision (cuDNN takes TF32 by default) lets conv(x^2) - mu^2 cancel below
the c2 = 9e-4 stabilizer and drives the loss to +/-inf.

The surfel (2DGS) regularizers: `depth_normals` and
`normal_consistency_loss`. The ray-drop segmentation losses (weighted
cross-entropy and Lovasz-softmax, `raydrop_lossf`): the JAX package defines
and tests them, and neither package's training step uses them.
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


def psnr(img, gt):
    mse = torch.mean((img - gt) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse.clamp_min(1e-20)))


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


class _ProdLast(torch.autograd.Function):
    """`torch.prod(x, dim=-1)` with `torch.prod`'s gradient, bit for bit,
    computed on the device alone. PyTorch's backward of `prod` reads its
    count of zero factors back to the host to pick a formula, which a CUDA
    graph cannot hold; here both formulas run and a `where` on the device
    picks PyTorch's: `g * (prod / x)` where no factor is zero, else the
    products of the other factors (exclusive products from both ends).
    Those are written out, not `cumprod`s: a `cumprod` over a last dimension
    of 2 or 3 runs one scan a row on the card, slower than the rest of the
    step's loss. With at most 3 factors (the scales: 3 beam, 2 surfel) each
    exclusive product has at most two, so any order of multiplication gives
    `cumprod`'s bits; more factors are refused."""

    @staticmethod
    def forward(ctx, x):
        if x.shape[-1] > 3:
            raise ValueError(f"prod_last takes at most 3 factors, got {x.shape[-1]}")
        out = torch.prod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        g, out = g.unsqueeze(-1), out.unsqueeze(-1)
        n = x.shape[-1]
        left, right = [torch.ones_like(x[..., 0])], [torch.ones_like(x[..., 0])]
        for i in range(n - 1):
            left.append(left[-1] * x[..., i])
            right.append(right[-1] * x[..., n - 1 - i])
        others = torch.stack(left, -1) * torch.stack(right[::-1], -1)
        return torch.where((x == 0).any(), g * others, g * (out / x))


def prod_last(x: torch.Tensor) -> torch.Tensor:
    """The product over the last dimension (`_ProdLast`)."""
    return _ProdLast.apply(x)


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
    scaling_reg = scale_reg * torch.sum(prod_last(scaling) * mask_f) / n_sel

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


# ---------------------------------------------------------------------------
# ray-drop segmentation losses
# ---------------------------------------------------------------------------

def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multi-class Lovasz-softmax: probas [P, C], labels [P] in [0, C) or
    -1 (ignored); the mean over the classes present in `labels`."""
    P, C = probas.shape
    losses, present = [], []
    for c in range(C):
        fg = ((labels == c) & (labels >= 0)).to(torch.float32)
        errors = (fg - probas[:, c]).abs()
        order = torch.sort(-errors, stable=True).indices
        losses.append(torch.dot(errors[order], lovasz_grad(fg[order])))
        present.append(fg.sum() > 0)
    present = torch.stack(present).to(torch.float32)
    return (torch.stack(losses) * present).sum() / present.sum().clamp_min(1.0)


def get_ce_weights(gt_label: torch.Tensor, n_classes: int,
                   max_weights: float = 50.0) -> torch.Tensor:
    """Inverse-frequency class weights, sqrt, clipped at `max_weights`."""
    counts = torch.stack([(gt_label == c).sum().to(torch.float32) + 1e-20
                          for c in range(n_classes)])
    return torch.sqrt(counts.sum() / counts).clamp(0.0, max_weights)


def raydrop_lossf(est: torch.Tensor, gt: torch.Tensor, lambda_bce: float = 0.15,
                  lambda_lov: float = 0.15, reweight: bool = True) -> torch.Tensor:
    """Weighted cross-entropy plus Lovasz-softmax. est: [B, C] logits; gt:
    [B] int labels (-1 = ignore)."""
    B, C = est.shape
    logp = F.log_softmax(est, dim=1)
    ok = gt >= 0
    gt_safe = torch.where(ok, gt, torch.zeros_like(gt))
    nll = -logp.gather(1, gt_safe[:, None])[:, 0]
    if reweight:
        w = get_ce_weights(torch.where(ok, gt, torch.full_like(gt, C)), C)
        ws = w[gt_safe] * ok
    else:
        ws = ok.to(torch.float32)
    ce = (nll * ws).sum() / ws.sum().clamp_min(1e-20)
    lov = lovasz_softmax_flat(F.softmax(est, dim=1), torch.where(ok, gt, torch.full_like(gt, -1)))
    return lambda_bce * ce + lambda_lov * lov
