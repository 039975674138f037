"""Golden O(P*HW) renderer — the test oracle.

Counterpart of `lidargs_tpu/ops/reference.py`: all gaussians, globally
depth-sorted, composited against every pixel with the per-pixel semantics
of the reference walk, parity-rect masking included. The tiled path must
match it (same chunk size => same reduction order).
"""
from __future__ import annotations

import torch

from ..config import RasterConfig
from .composite import composite_depth_ordered, pixel_rays
from .projection import Splats


def render_reference(splats: Splats, beams: torch.Tensor, W: int,
                     bg: torch.Tensor, cfg: RasterConfig):
    """Returns (color [C,H,W], depth [H,W], occ [H,W], final_T [H,W])."""
    H = beams.shape[0]
    dev = splats.depth.device

    order = torch.argsort(splats.depth, stable=True)   # invalid -> 4*far -> last
    sorted_ids = order[None, :]                        # one list = whole image
    sorted_valid = splats.valid[order][None, :]

    rows = torch.arange(H, dtype=torch.int32, device=dev).repeat_interleave(W)
    cols = torch.arange(W, dtype=torch.int32, device=dev).repeat(H)
    dirs = pixel_rays(rows, cols, beams, W)[None]

    out = composite_depth_ordered(splats, sorted_ids, sorted_valid,
                                  dirs, cols[None], rows[None], cfg)
    C = splats.feat.shape[-1]
    final_T = out.final_T.reshape(H, W)
    color = out.color.reshape(C, H, W) + final_T[None] * bg[:, None, None]
    depth = out.depth.reshape(H, W)
    return color, depth, 1.0 - final_T, final_T
