"""The training step, the reference's: render -> loss -> autograd -> Adam.

The loss of one frame is the port's (`train/trainer.py` `frame_loss`): the
five-term LiDAR loss and, for the surfel variant, the distortion and
normal-consistency terms from `dist_from` and `normal_from` on. Gradients
come from autograd through the plain pipeline. The densification
statistics are not kept: no densify falls in the steps the reference
follows.

`rows` keeps only the first `rows` pixel rows of the frame in the loss, the
mean taken over them: the fault "half of the batch left out" that the
benchmark's controls plant here.
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import ModelConfig, OptConfig, RasterConfig
from .field import Frame, render
from .losses import lidar_losses, normal_consistency_loss
from .optim import AdamState, adam_update, lr_schedules, tree_leaves, tree_unflatten


def frame_loss(params: dict, valid: torch.Tensor, step: int, frame: Frame, bg: torch.Tensor,
               mcfg: ModelConfig, rcfg: RasterConfig, ocfg: OptConfig, variant: str,
               rows: Optional[int] = None, probe: Optional[dict] = None) -> torch.Tensor:
    out, ng = render(params, valid, frame, mcfg, rcfg, bg, variant, probe)
    r = slice(None, rows)
    gt = frame.gt_image[:, r]
    color, depth = out.color[:, r], out.depth[r]
    total = lidar_losses(color, depth, gt, ng.scaling[..., :2] if variant == "surfel"
                         else ng.scaling, ng.mask, lambda_dssim=ocfg.lambda_dssim,
                         raydrop_lambda=ocfg.raydrop_lambda, scale_reg=ocfg.scale_reg,
                         grad_clip_x=ocfg.grad_clip_x).total
    if variant == "surfel":
        hit = gt[0]
        if step >= ocfg.dist_from:
            total = total + ocfg.dist_lambda * (out.distortion[r] * hit).sum() / hit.sum().clamp_min(1.0)
        if step >= ocfg.normal_from:
            total = total + ocfg.normal_lambda * normal_consistency_loss(
                out.normal[:, r], depth, frame.beams[frame.beams.shape[0] - depth.shape[0]:],
                frame.W, hit)
    return total


def train_step(params: dict, opt: AdamState, valid: torch.Tensor, step: int, frame: Frame,
               bg: torch.Tensor, mcfg: ModelConfig, rcfg: RasterConfig, ocfg: OptConfig,
               variant: str, rows: Optional[int] = None, probe: Optional[dict] = None):
    """One step: (new params, new AdamState, loss, gradients). A parameter
    the loss does not reach gets a zero gradient."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        total = frame_loss(tree_unflatten(params, leaves), valid, step, frame, bg, mcfg, rcfg,
                           ocfg, variant, rows, probe)
        gs = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(x) if g is None else g
                                    for g, x in zip(gs, leaves)])
    new_params, new_opt = adam_update(params, grads, opt, lr_schedules(ocfg),
                                      torch.full((), step, dtype=torch.int32,
                                                 device=valid.device), ocfg)
    return new_params, new_opt, total.detach(), grads
