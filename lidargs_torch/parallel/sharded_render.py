"""One frame rendered with its anchors and tiles split over the ranks of a
mesh axis.

Counterpart of `lidargs_tpu/parallel/sharded_render.py`, one process per
device instead of `shard_map`:

  * each rank prefilters, decodes and projects only its contiguous anchor
    shard (the capacity must divide by the axis) and packs its splats;
  * ONE all-gather of the packed rows in rank order, which is the global
    anchor order, so the stable depth sort and the binning keys are the
    single-device path's;
  * each rank bins and composites only its window of Tl = ceil(T / D)
    tiles, `render_packed_window(tile_lo=rank * Tl, n_tiles=Tl)`: one K1
    launch (K3 with `fused_gather`) per rank;
  * one all-gather of the strips, and the image assembled from them (the
    last window's overhang dropped) with the background.

Gradients: the packed rows' all-gather backward sums the [P, F] cotangent
over the ranks and keeps this rank's rows (`reduce_scatter_rows`); the
strips' all-gather backward keeps this rank's strips (every rank holds the
same loss); the parameters enter through `_Replicated`, whose backward sums
their gradients over the ranks in one all-reduce, so every rank ends with
the single-device gradient, as the JAX package's `shard_map` transpose
gives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import ModelConfig, RasterConfig
from ..lidar.frames import LidarFrame
from ..models.field import field_splats
from ..ops.projection import PackedCols, pack_splats
from ..ops.rasterize import RenderOut, permutation_rows, render_packed_window
from ..train.optim import tree_leaves, tree_unflatten
from .collectives import (
    all_gather_rows, all_reduce_sum, rank, reduce_scatter_rows, world,
)
from .mesh import Mesh, make_mesh

ANCHOR_KEYS = ("anchor", "offset", "feat", "scaling", "rotation", "opacity")


class _AllGatherRows(torch.autograd.Function):
    """`all_gather_rows` with a gradient: the sum over ranks of the
    cotangent's rows of this rank (`sum_grad`), or those rows of this
    rank's own cotangent (when every rank computed the same loss from the
    gathered rows and no other rank's share reached it)."""

    @staticmethod
    def forward(ctx, x, group, sum_grad: bool):
        ctx.group, ctx.sum_grad, ctx.n = group, sum_grad, x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            return reduce_scatter_rows(g.contiguous(), ctx.group), None, None
        r = rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None, None


class _Replicated(torch.autograd.Function):
    """The identity on tensors every rank holds alike; the backward sums
    their gradients over the ranks of `group` in one fused all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group, ctx.device = group, xs[0].device
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, device=ctx.device) if g is None else g
              for g, s in zip(gs, ctx.shapes)]
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        return (None, *(p.view(s) for p, s in
                        zip(torch.split(flat, [g.numel() for g in gs]), ctx.shapes)))


def _gather(x, group, sum_grad: bool):
    return x if world(group) == 1 else _AllGatherRows.apply(x, group, sum_grad)


def render_field_sharded(params: dict, valid: torch.Tensor, frame: LidarFrame,
                         mcfg: ModelConfig, rcfg: RasterConfig, bg: torch.Tensor,
                         mesh: Optional[Mesh] = None, axis: str = "tile") -> RenderOut:
    """One frame's render with anchors and tiles split over `axis` of
    `mesh` (default: the one-process 1x1 mesh). Every rank of the axis
    calls it with the same replicated parameters and gets the whole
    RenderOut; its forward equals `render_field`'s."""
    mesh = mesh if mesh is not None else make_mesh()
    group = mesh.tile_group if axis == "tile" else mesh.data_group
    D = mesh.shape[axis]
    r = mesh.tile_index if axis == "tile" else mesh.data_index
    H, W = frame.H, frame.W
    gy, gx = rcfg.grid_shape(H, W)
    T = gy * gx
    Cap = params["anchor"].shape[0]
    if Cap % D != 0:
        raise ValueError(f"anchor capacity {Cap} not divisible by mesh axis {D}")
    Tl = -(-T // D)                   # tiles per rank; the last window may overhang
    C = mcfg.color_channel

    leaves = tree_leaves(params)
    if world(group) > 1 and torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        params = tree_unflatten(params, list(_Replicated.apply(group, *leaves)))
    n_l = Cap // D
    params_l = {k: (v[r * n_l:(r + 1) * n_l] if k in ANCHOR_KEYS else v)
                for k, v in params.items()}
    valid_l = valid[r * n_l:(r + 1) * n_l]
    # the JAX package's sharded render decodes every anchor of its shard
    splats = field_splats(params_l, valid_l, frame, mcfg,
                          dataclasses.replace(rcfg, visible_anchor_cap=0))[0]
    pk = _gather(pack_splats(splats), group, True)                   # [P, F]

    Pn = pk.shape[0]
    V = min(rcfg.max_visible, Pn)
    depth = pk[:, PackedCols.DEPTH].detach()
    sel = torch.sort(depth, stable=True).indices
    pkv = permutation_rows(pk, sel, V)
    vvalid = pkv[:, PackedCols.validf(C)] > 0.0
    n_dropped = (depth < 4.0 * rcfg.far).sum() - vvalid.sum()

    color_t, depth_t, final_T_t, n_overflow = render_packed_window(
        pkv, frame.beams, W, rcfg, C, tile_lo=r * Tl, n_tiles=Tl)
    strips = torch.cat([color_t, depth_t[:, None], final_T_t[:, None]], 1)
    strips = _gather(strips, group, False)[:T]                       # [T, C+2, npix]
    visible = all_gather_rows(splats.valid.to(torch.uint8), group) > 0
    n_overflow = all_reduce_sum(n_overflow.to(torch.int64).reshape(1), group)[0]

    th, tw = rcfg.tile_h, rcfg.tile_w
    img = strips.reshape(gy, gx, C + 2, th, tw).permute(2, 0, 3, 1, 4)
    img = img.reshape(C + 2, gy * th, gx * tw)[:, :H, :W]
    color, depth_img, final_T = img[:C], img[C], img[C + 1]
    color = color + final_T[None] * bg[:, None, None]
    return RenderOut(
        color=color,
        depth=depth_img,
        occ=1.0 - final_T,
        final_T=final_T,
        visible=visible,
        n_dropped=n_dropped,
        n_overflow=n_overflow,
    )
