"""Tiled range-view rasterization, the reference's.

A frozen copy of the port's materialized path (`ops/rasterize.py`), with
the capacity caps that `RasterConfig` declares: the cull keeps the nearest
`max_visible` gaussians by one stable depth sort, each gaussian touches at
most `max_tiles_per_gaussian` tiles around its center tile, and each tile
composites its nearest `tile_capacity` instances. The permutation and the
tile gather are plain indexing, differentiated by autograd, and the
composite is the plain chunk scan (`composite.composite_tiles_plain`).
Only the dense emission grid (`instance_capacity` 0) is written out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .composite import composite_tiles_plain, pixel_rays
from .config import RasterConfig
from .projection import PackedCols, Splats, pack_splats

_I32 = torch.int32


class RenderOut(NamedTuple):
    color: torch.Tensor       # [C, H, W] (bg already blended)
    depth: torch.Tensor       # [H, W]
    occ: torch.Tensor         # [H, W] 1 - final transmittance
    final_T: torch.Tensor     # [H, W]
    visible: torch.Tensor     # [P] bool
    n_dropped: torch.Tensor   # [] valid gaussians beyond max_visible
    n_overflow: torch.Tensor  # [] instances beyond tile_capacity


class TileLists(NamedTuple):
    """What the composite reads: [T, K, F] lists, [T] counts, [T, 8, NPIX]
    pixel blocks."""

    inst: torch.Tensor
    counts: torch.Tensor
    pix: torch.Tensor


def _tile_rects(rect, center, cfg: RasterConfig):
    """Per-gaussian touched-tile window, clipped to max_tiles_per_gaussian
    around the center tile."""
    tw, th = cfg.tile_w, cfg.tile_h
    tx0 = rect[:, 0] // tw
    tx1 = -(-rect[:, 1] // tw)
    ty0 = rect[:, 2] // th
    ty1 = -(-rect[:, 3] // th)
    w = (tx1 - tx0).clamp_min(0)
    h = (ty1 - ty0).clamp_min(0)
    cap = cfg.max_tiles_per_gaussian
    wc = w.clamp(1, cap)
    hc = torch.minimum(h.clamp_min(1), (cap // wc.clamp_min(1)).clamp_min(1))
    cx = (center[:, 0] / tw).to(_I32)
    cy = (center[:, 1] / th).to(_I32)
    cx = torch.minimum(torch.maximum(cx, tx0), torch.maximum(tx1 - 1, tx0))
    cy = torch.minimum(torch.maximum(cy, ty0), torch.maximum(ty1 - 1, ty0))
    x0 = torch.minimum(torch.maximum(cx - wc // 2, tx0), torch.maximum(tx1 - wc, tx0))
    y0 = torch.minimum(torch.maximum(cy - hc // 2, ty0), torch.maximum(ty1 - hc, ty0))
    return x0, y0, wc, hc


def bin_instances(rect, center, valid, cfg: RasterConfig, gx: int, gy: int):
    """Depth-ordered gaussians -> ([T, K] ids, [T] counts clipped to K,
    overflow count): one instance per touched tile, sorted by the fused
    key `tile << shift | gid`, the nearest K of each tile kept."""
    if cfg.instance_capacity > 0:
        raise ValueError("the reference writes out the dense emission grid only")
    V = valid.shape[0]
    T = gx * gy
    dev = valid.device
    cap = cfg.max_tiles_per_gaussian
    x0, y0, wc, hc = _tile_rects(rect, center, cfg)
    shift = max(int(V - 1).bit_length(), 1)
    j = torch.arange(cap, dtype=_I32, device=dev)[None, :]
    inv_wc = 1.0 / wc.to(torch.float32)[:, None]
    jy = torch.floor(j.to(torch.float32) * inv_wc + 0.01).to(_I32)
    jx = j - jy * wc[:, None]
    inst_ok = (jy < hc[:, None]) & valid[:, None]
    tile = (y0[:, None] + jy) * gx + (x0[:, None] + jx)
    inst_ok = inst_ok & (tile >= 0) & (tile < T)
    tile = torch.where(inst_ok, tile, T)
    gid = torch.arange(V, dtype=_I32, device=dev)[:, None]
    s_key = torch.sort(((tile << shift) | gid).reshape(-1)).values
    bounds = torch.arange(T + 1, dtype=_I32, device=dev) << shift
    starts = torch.searchsorted(s_key, bounds, out_int32=True)
    counts = starts[1:] - starts[:-1]
    K = cfg.tile_capacity
    n_overflow = (counts - K).clamp_min(0).sum()
    idx = (starts[:-1, None] + torch.arange(K, dtype=_I32, device=dev)[None, :])
    ids = s_key[idx.clamp(0, V * cap - 1)] & ((1 << shift) - 1)
    return ids, counts.clamp_max(K), n_overflow


def tile_pixels(H: int, W: int, cfg: RasterConfig, beams) -> torch.Tensor:
    """[T, 8, NPIX] pixel blocks: rows 0-2 the unit ray, 3 the column, 4
    the row, 5-7 zero."""
    gy, gx = cfg.grid_shape(H, W)
    th, tw = cfg.tile_h, cfg.tile_w
    dev = beams.device
    t = torch.arange(gx * gy, dtype=_I32, device=dev)
    rows = (t // gx)[:, None] * th + torch.arange(th, dtype=_I32, device=dev)[None, :]
    cols = (t % gx)[:, None] * tw + torch.arange(tw, dtype=_I32, device=dev)[None, :]
    pix_y = rows.repeat_interleave(tw, dim=1)
    pix_x = cols.repeat(1, th)
    dirs = pixel_rays(pix_y.clamp_max(H - 1), pix_x % W, beams, W)
    blk = torch.stack([dirs[..., 0], dirs[..., 1], dirs[..., 2],
                       pix_x.to(torch.float32), pix_y.to(torch.float32)], dim=1)
    return F.pad(blk, (0, 0, 0, 3))


def depth_sorted(pk: torch.Tensor, depth: torch.Tensor, V: int) -> torch.Tensor:
    """The first V rows of `pk` in stable depth order (plain indexing)."""
    sel = torch.sort(depth, stable=True).indices
    return pk[sel[:V]]


def tile_lists(pkv: torch.Tensor, beams: torch.Tensor, W: int, cfg: RasterConfig,
               C: int, cols=PackedCols):
    """(TileLists, overflow count) of depth-ordered packed rows."""
    H = beams.shape[0]
    gy, gx = cfg.grid_shape(H, W)
    ids, counts, n_overflow = bin_instances(pkv[:, cols.rect(C)].to(_I32),
                                            pkv[:, cols.center(C)],
                                            pkv[:, cols.validf(C)] > 0.0, cfg, gx, gy)
    V, Fw = pkv.shape
    inst = pkv[ids.reshape(-1).clamp(0, V - 1)].reshape(*ids.shape, Fw)
    return TileLists(inst, counts, tile_pixels(H, W, cfg, beams)), n_overflow


def untile(x: torch.Tensor, H: int, W: int, cfg: RasterConfig) -> torch.Tensor:
    """[T, c, NPIX] (or [T, NPIX]) tile strips -> [c, H, W] (or [H, W])."""
    gy, gx = cfg.grid_shape(H, W)
    th, tw = cfg.tile_h, cfg.tile_w
    if x.dim() == 2:
        return x.reshape(gy, gx, th, tw).permute(0, 2, 1, 3).reshape(gy * th, gx * tw)[:H, :W]
    c = x.shape[1]
    return x.reshape(gy, gx, c, th, tw).permute(2, 0, 3, 1, 4).reshape(
        c, gy * th, gx * tw)[:, :H, :W]


def render_tiled(splats: Splats, beams: torch.Tensor, W: int, bg: torch.Tensor,
                 cfg: RasterConfig, probe: dict | None = None) -> RenderOut:
    """The tiled render of projected splats. `probe`, when given, gets the
    frame's TileLists (detached) under "lists", which the counts read."""
    H = beams.shape[0]
    C = splats.feat.shape[-1]
    P = splats.valid.shape[0]
    V = min(cfg.max_visible, P)
    pkv = depth_sorted(pack_splats(splats), splats.depth, V)
    n_dropped = splats.valid.sum() - (pkv[:, PackedCols.validf(C)] > 0.0).sum()
    tl, n_overflow = tile_lists(pkv, beams, W, cfg, C)
    if probe is not None:
        probe["lists"] = tl._replace(inst=tl.inst.detach())
    out8 = composite_tiles_plain(tl.inst, tl.counts, tl.pix, C, cfg)
    final_T = untile(out8[:, C + 1], H, W, cfg)
    color = untile(out8[:, :C], H, W, cfg) + final_T[None] * bg[:, None, None]
    return RenderOut(color=color, depth=untile(out8[:, C], H, W, cfg), occ=1.0 - final_T,
                     final_T=final_T, visible=splats.valid, n_dropped=n_dropped,
                     n_overflow=n_overflow)
