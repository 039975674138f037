"""Tiled range-view rasterization — the production render path.

Counterpart of `lidargs_tpu/ops/rasterize.py` (both gathers, with the backward):

  1. cull + compact + depth presort in ONE stable sort on depth (invalid
     rows carry the same finite 4*far sentinel, so stability keeps the
     row order, and every count after it, equal to the JAX package's);
  2. instance expansion: each gaussian emits one instance per touched
     tile, bounded by max_tiles_per_gaussian around its center tile;
  3. one sort of fused int32 keys `tile << ceil_log2(V) | gid`;
  4. per-tile ranges by a left searchsorted and a static per-tile
     capacity; overflow drops the farthest instances and is counted;
  5. compositing: the CUDA kernels K1 (forward) and K2 (backward) on the
     card, their plain versions on the CPU (composite_kernel.py).

With `RasterConfig.fused_gather` steps 4-5 take the fused-window form
instead: one dense gather of every sorted slot's row into `buf`, per-tile
[start, count) windows into it (`bin_instances_windows`), and the window
kernels K3 (forward) and K4 (backward) on the card, their plain versions on
the CPU. The gradient reaches the packed rows through autograd's backward
of that gather, as JAX's flows through the transpose of `jnp.take`.

Physical tiles are tile_h x 128 pixels; parity with the reference's 16x1
strips is kept through the per-pixel parity-rect mask (projection.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import RasterConfig
from .composite import pixel_rays
from .composite_kernel import CompositeTiles, CompositeWindows
from .projection import PackedCols, Splats, pack_splats

_I32 = torch.int32


class _PermutationRows(torch.autograd.Function):
    """`pk[sel[:V]]` for a permutation `sel` of pk's rows, with a gather as
    its backward: the rows of the cotangent go back through the inverse
    permutation (one integer sort), and rows outside the first V get zero.
    No scatter-add, so the backward is exact and deterministic."""

    @staticmethod
    def forward(ctx, pk, sel, V: int):
        ctx.save_for_backward(sel)
        ctx.V = V
        return pk[sel[:V].clamp(0, pk.shape[0] - 1)]

    @staticmethod
    def backward(ctx, d_pkv):
        (sel,) = ctx.saved_tensors
        V = ctx.V
        inv = torch.argsort(sel)             # inv[r] = position of row r in sel
        d_rows = d_pkv[inv.clamp_max(V - 1)]
        keep = (inv < V).reshape((-1,) + (1,) * (d_rows.dim() - 1))
        return torch.where(keep, d_rows, torch.zeros_like(d_rows)), None, None


def permutation_rows(pk: torch.Tensor, sel: torch.Tensor, V: int) -> torch.Tensor:
    """`pk[sel[:V]]` (a clamped row gather), where `sel` is a permutation
    of pk's rows, with the gather VJP of `_PermutationRows`."""
    return _PermutationRows.apply(pk, sel, V)


class RenderOut(NamedTuple):
    color: torch.Tensor       # [C, H, W] (bg already blended)
    depth: torch.Tensor       # [H, W]
    occ: torch.Tensor         # [H, W] 1 - final transmittance
    final_T: torch.Tensor     # [H, W]
    visible: torch.Tensor     # [P] bool — per input gaussian (radii > 0)
    n_dropped: torch.Tensor   # [] valid gaussians beyond max_visible
    n_overflow: torch.Tensor  # [] instances beyond tile_capacity


def _tile_rects(rect, center, cfg: RasterConfig):
    """Per-gaussian touched-tile window in the physical tiling, clipped to
    max_tiles_per_gaussian around the center tile.

    rect: [P, 4] int32 parity rect (x0, x1, y0, y1); center: [P, 2] float."""
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
    # astype(int32) truncates toward zero, as .to(int32) does
    cx = (center[:, 0] / tw).to(_I32)
    cy = (center[:, 1] / th).to(_I32)
    cx = torch.minimum(torch.maximum(cx, tx0), torch.maximum(tx1 - 1, tx0))
    cy = torch.minimum(torch.maximum(cy, ty0), torch.maximum(ty1 - 1, ty0))
    x0 = torch.minimum(torch.maximum(cx - wc // 2, tx0), torch.maximum(tx1 - wc, tx0))
    y0 = torch.minimum(torch.maximum(cy - hc // 2, ty0), torch.maximum(ty1 - hc, ty0))
    return x0, y0, wc, hc


def _bin_sorted(rect, center, valid, cfg: RasterConfig, gx: int, gy: int):
    """Expand gaussians to (tile, id) instances and sort the fused keys.
    Returns (sorted keys, [T+1] window starts, [T] raw counts, shift, key
    count, overflow).

    PRECONDITION: the input is depth-ordered (render_tiled's cull sort), so
    the gaussian index IS the depth rank and one sort of the fused int32
    key `tile << shift | gid` orders instances by (tile, depth)."""
    V = valid.shape[0]
    T = gx * gy
    dev = valid.device
    cap = cfg.max_tiles_per_gaussian
    x0, y0, wc, hc = _tile_rects(rect, center, cfg)

    shift = max(int(V - 1).bit_length(), 1)
    if shift + int(T).bit_length() > 31:
        raise ValueError(
            f"fused binning key overflows int32: V={V} tiles={T}; "
            "reduce max_visible or enlarge tiles"
        )
    if cap > 64:
        raise ValueError(f"max_tiles_per_gaussian={cap} exceeds 64")

    E = cfg.instance_capacity
    n_lost = torch.zeros((), dtype=torch.int64, device=dev)
    if E <= 0 or E >= V * cap:
        # dense emission grid: every gaussian owns `cap` slots. The float
        # reciprocal floor is exact in f32 for j < 64, wc <= 64.
        j = torch.arange(cap, dtype=_I32, device=dev)[None, :]
        inv_wc = 1.0 / wc.to(torch.float32)[:, None]
        jy = torch.floor(j.to(torch.float32) * inv_wc + 0.01).to(_I32)
        jx = j - jy * wc[:, None]
        inst_ok = (jy < hc[:, None]) & valid[:, None]
        tile = (y0[:, None] + jy) * gx + (x0[:, None] + jx)
        inst_ok = inst_ok & (tile >= 0) & (tile < T)
        tile = torch.where(inst_ok, tile, T)                      # sentinel last
        gid = torch.arange(V, dtype=_I32, device=dev)[:, None]
        key = ((tile << shift) | gid).reshape(-1)
        n_keys = V * cap
    else:
        # rank-search emission: slot s maps to gaussian i(s) =
        # searchsorted(offsets, s, right) - 1 and within-rect rank
        # j = s - offsets[i]; slots come out in depth order, so budget
        # overflow drops the farthest gaussians' instances (counted).
        n_i = torch.where(valid, wc * hc, 0).to(_I32)
        offsets = F.pad(torch.cumsum(n_i, 0, dtype=_I32), (1, 0))   # [V+1]
        total = offsets[-1]
        s = torch.arange(E, dtype=_I32, device=dev)
        i_s = torch.searchsorted(offsets, s, right=True, out_int32=True) - 1
        i_s = i_s.clamp(0, V - 1)
        j_s = s - offsets[i_s]
        inv_wc = 1.0 / wc.to(torch.float32)
        jy = torch.floor(j_s.to(torch.float32) * inv_wc[i_s] + 0.01).to(_I32)
        jx = j_s - jy * wc[i_s]
        tile = (y0[i_s] + jy) * gx + (x0[i_s] + jx)
        inst_ok = (s < total) & (tile >= 0) & (tile < T)
        tile = torch.where(inst_ok, tile, T)
        key = (tile << shift) | i_s
        n_keys = E
        n_lost = (total - E).clamp_min(0).to(torch.int64)

    s_key = torch.sort(key).values

    bounds = torch.arange(T + 1, dtype=_I32, device=dev) << shift
    starts = torch.searchsorted(s_key, bounds, out_int32=True)    # left
    counts = starts[1:] - starts[:-1]
    K = cfg.tile_capacity
    n_overflow = (counts - K).clamp_min(0).sum() + n_lost
    return s_key, starts, counts, shift, n_keys, n_overflow


def bin_instances(rect, center, valid, cfg: RasterConfig, gx: int, gy: int):
    """Materialized per-tile id lists (see _bin_sorted): ([T, K] gaussian
    ids, [T] int32 counts, overflow count)."""
    s_key, starts, counts, shift, n_keys, n_overflow = _bin_sorted(
        rect, center, valid, cfg, gx, gy
    )
    K = cfg.tile_capacity
    idx = starts[:-1, None] + torch.arange(K, dtype=_I32, device=starts.device)[None, :]
    idx = idx.clamp(0, n_keys - 1)                    # take(mode="clip")
    ids = s_key[idx] & ((1 << shift) - 1)
    return ids, counts.clamp_max(K), n_overflow


def bin_instances_windows(rect, center, valid, cfg: RasterConfig, gx: int, gy: int):
    """Fused-gather form (see _bin_sorted): per-slot gaussian ids in sorted
    (tile, depth) order and per-tile windows into that list: ([n_keys] gid,
    [T] starts, [T] counts clipped to K, overflow count), every integer as
    the JAX package's. `starts` is the unclipped left searchsorted, so a
    tile that overflows leaves a gap before the next tile's start; slots in
    no tile's first-K window (that gap, the sentinels) carry real rows that
    no kernel reads."""
    s_key, starts, counts, shift, _n_keys, n_overflow = _bin_sorted(
        rect, center, valid, cfg, gx, gy
    )
    K = cfg.tile_capacity
    gid = s_key & ((1 << shift) - 1)
    return gid, starts[:-1], counts.clamp_max(K), n_overflow


def _tile_pixels(H: int, W: int, cfg: RasterConfig, gx: int, gy: int, beams):
    """Per-tile pixel coords + ray dirs for all gy*gx tiles."""
    th, tw = cfg.tile_h, cfg.tile_w
    dev = beams.device
    t = torch.arange(gx * gy, dtype=_I32, device=dev)
    rows = (t // gx)[:, None] * th + torch.arange(th, dtype=_I32, device=dev)[None, :]
    cols = (t % gx)[:, None] * tw + torch.arange(tw, dtype=_I32, device=dev)[None, :]
    pix_y = rows.repeat_interleave(tw, dim=1)                 # [T, th*tw]
    pix_x = cols.repeat(1, th)
    safe_rows = pix_y.clamp_max(H - 1)
    dirs = pixel_rays(safe_rows, pix_x % W, beams, W)
    return pix_x, pix_y, dirs


def _pix_blocks(pix_x, pix_y, dirs):
    """[T, 8, NPIX] pixel blocks for the composite kernel: rows 0-2 unit ray
    dir xyz, row 3 pixel column, row 4 pixel row (as f32), rows 5-7 zero."""
    rows = [
        dirs[..., 0], dirs[..., 1], dirs[..., 2],
        pix_x.to(torch.float32), pix_y.to(torch.float32),
    ]
    blk = torch.stack(rows, dim=1)                            # [T, 5, npix]
    return F.pad(blk, (0, 0, 0, 3))


def tile_inputs(pkv: torch.Tensor, beams: torch.Tensor, W: int,
                cfg: RasterConfig, C: int):
    """Bin the depth-ordered packed rows and gather each tile's list: the
    composite kernel's inputs ([T, K, F] instances, [T] int32 counts,
    [T, 8, NPIX] pixel blocks) and the overflow count. The materialized
    form, whatever `cfg.fused_gather` says (`window_inputs` is the other)."""
    H = beams.shape[0]
    gy, gx = cfg.grid_shape(H, W)
    T = gy * gx
    V, Fw = pkv.shape
    K = cfg.tile_capacity
    vvalid = pkv[:, PackedCols.validf(C)] > 0.0
    rect = pkv[:, PackedCols.rect(C)].to(_I32)
    center = pkv[:, PackedCols.center(C)]

    ids, counts, n_overflow = bin_instances(rect, center, vvalid, cfg, gx, gy)
    # one wide row gather materialises the per-tile instance lists; its
    # backward is autograd's indexing backward, an accumulating index_put
    # whose order on CUDA PyTorch does not promise, so two identical steps
    # may differ in the last bits (chip_smoke.py reports the difference)
    inst = pkv[ids.reshape(-1).clamp(0, V - 1)].reshape(T, K, Fw)
    pix_x, pix_y, dirs = _tile_pixels(H, W, cfg, gx, gy, beams)
    return inst, counts, _pix_blocks(pix_x, pix_y, dirs), n_overflow


def window_inputs(pkv: torch.Tensor, beams: torch.Tensor, W: int, cfg: RasterConfig,
                  C: int, cols=PackedCols):
    """Bin the depth-ordered packed rows into windows: the window kernels'
    inputs ([n_keys + K, F] buf, every sorted slot's row and K zero rows of
    padding so that no window runs off its end; [T] int32 starts and
    counts; [T, 8, NPIX] pixel blocks) and the overflow count. `cols` names
    the rect, center and valid columns (PackedCols, or SurfelCols for
    surfels)."""
    H = beams.shape[0]
    gy, gx = cfg.grid_shape(H, W)
    V = pkv.shape[0]
    gid, starts, counts, n_overflow = bin_instances_windows(
        pkv[:, cols.rect(C)].to(_I32), pkv[:, cols.center(C)], pkv[:, cols.validf(C)] > 0.0,
        cfg, gx, gy)
    buf = F.pad(pkv[gid.clamp(0, V - 1)], (0, 0, 0, cfg.tile_capacity))
    pix_x, pix_y, dirs = _tile_pixels(H, W, cfg, gx, gy, beams)
    return buf, starts, counts, _pix_blocks(pix_x, pix_y, dirs), n_overflow


def render_packed_window(pkv: torch.Tensor, beams: torch.Tensor, W: int,
                         cfg: RasterConfig, C: int):
    """Bin + composite every tile against the packed gaussian set, through
    the [T, K, F] lists or, with `cfg.fused_gather`, the windows. Returns
    per-tile strips (color [T,C,npix], depth, final_T, overflow)."""
    if cfg.fused_gather:
        buf, starts, counts, pix, n_overflow = window_inputs(pkv, beams, W, cfg, C)
        out8 = CompositeWindows.apply(buf, starts, counts, pix, C, cfg)
    else:
        inst, counts, pix, n_overflow = tile_inputs(pkv, beams, W, cfg, C)
        out8 = CompositeTiles.apply(inst, counts, pix, C, cfg)
    return out8[:, :C], out8[:, C], out8[:, C + 1], n_overflow


def cull_sorted_rows(splats: Splats, cfg: RasterConfig):
    """Cull + compact + depth presort in ONE stable sort: the first
    min(max_visible, P) packed rows in depth order ([V, F]) and the count of
    valid gaussians beyond max_visible."""
    P = splats.valid.shape[0]
    C = splats.feat.shape[-1]
    V = min(cfg.max_visible, P)
    pk = pack_splats(splats)                                    # [P, F]
    sel = torch.sort(splats.depth, stable=True).indices
    pkv = permutation_rows(pk, sel, V)                          # [V, F]
    vvalid = pkv[:, PackedCols.validf(C)] > 0.0
    n_dropped = splats.valid.sum() - vvalid.sum()
    return pkv, n_dropped


def render_tiled(
    splats: Splats,
    beams: torch.Tensor,
    W: int,
    bg: torch.Tensor,
    cfg: RasterConfig,
) -> RenderOut:
    H = beams.shape[0]
    gy, gx = cfg.grid_shape(H, W)
    C = splats.feat.shape[-1]

    pkv, n_dropped = cull_sorted_rows(splats, cfg)
    color_t, depth_t, final_T_t, n_overflow = render_packed_window(pkv, beams, W, cfg, C)

    # --- reassemble tiles into the image ---
    th, tw = cfg.tile_h, cfg.tile_w
    color = color_t.reshape(gy, gx, C, th, tw).permute(2, 0, 3, 1, 4)
    color = color.reshape(C, gy * th, gx * tw)[:, :H, :W]
    depth = depth_t.reshape(gy, gx, th, tw).permute(0, 2, 1, 3)
    depth = depth.reshape(gy * th, gx * tw)[:H, :W]
    final_T = final_T_t.reshape(gy, gx, th, tw).permute(0, 2, 1, 3)
    final_T = final_T.reshape(gy * th, gx * tw)[:H, :W]

    color = color + final_T[None] * bg[:, None, None]
    return RenderOut(
        color=color,
        depth=depth,
        occ=1.0 - final_T,
        final_T=final_T,
        visible=splats.valid,
        n_dropped=n_dropped,
        n_overflow=n_overflow,
    )
