"""Surfel composite over per-tile instance lists: kernels K5 (forward) and
K6 (backward), their window forms K7 and K8, their plain versions, and the
autograd functions that join them.

`surfel_composite_tiles` is the forward of the JAX package's
`surfel_composite_tiles` (`lidargs_tpu/ops/pallas_surfel.py`, kernel body
`_fwd_kernel`/`_fwd_tile`); `surfel_composite_tiles_bwd` is its VJP (kernel
body `_bwd_tile`). On a CUDA tensor each launches its hand-written kernel
(`csrc/surfel_fwd.cu`, `csrc/surfel_bwd.cu`, built with nvcc for sm_90a at
the first call and loaded with ctypes); on a CPU tensor each runs its plain
PyTorch version with the same signature and layout. There is no fallback
from one to the other: a CUDA tensor a kernel cannot take raises.

The window forms (`surfel_composite_windows`, K7, the forward of the JAX
package's `surfel_composite_windows`, kernel body `_fwd_kernel_fused`;
`surfel_composite_windows_bwd`, K8, kernel body `_bwd_kernel_fused`) take
one dense sorted buffer and per-tile windows into it, with the layout and
write rule of the beam's K3 and K4 (`composite_kernel.py`).

Layout (shared by both):
  inst   [T, K, F] f32     depth-ordered packed surfels (SurfelCols)
  counts [T]       i32     live rows per tile
  pix    [T, 8, NPIX] f32  rows 0-2 unit ray dir, row 3 column, row 4 row
  out    [T, 16, NPIX] f32 rows 0..C-1 features, C depth, C+1 final
                           transmittance, C+2..C+4 normal, C+5 median depth,
                           C+6 distortion, C+7 and C+8 the M1/M2 totals the
                           backward reads, zeros after
  dinst  [T, K, F] f32     d Tu(3), d Tv(3), d Tw(3), d normal(3), d opacity,
                           zero at DEPTH, d features(C), d center(2); zero in
                           the rect, valid and pad columns and on rows no
                           pixel walked
"""
from __future__ import annotations

import ctypes

import torch

from ..config import RasterConfig
from ..utils import cuda_build
from .composite_kernel import (check_rows_aligned, check_saved, check_tile_inputs,
                               check_window_inputs, scatter_windows, window_rows)
from .surfel import SurfelCols as S
from .surfel import pair_geometry, surfel_composite

OUT_ROWS = 16

# the launch functions' arguments between the tensor pointers and the
# stream: T, K, F, NPIX, C and the eight constants of `_consts`
_ARGS = [ctypes.c_int] * 5 + [ctypes.c_float] * 8


def _consts(cfg: RasterConfig):
    """The kernels' float constants, each rounded to float32 as the plain
    versions round a Python scalar: alpha_min, alpha_clamp,
    transmittance_min, surfel_near, filter_inv_square, the distortion map's
    far/(far-near) and far/(far-near)*near (taken in double, as Python
    does), and the near cut's 1e-9 depth floor."""
    fn, nn = cfg.surfel_far, cfg.surfel_near
    return (cfg.alpha_min, cfg.alpha_clamp, cfg.transmittance_min, nn,
            cfg.filter_inv_square, fn / (fn - nn), fn / (fn - nn) * nn, 1e-9)


def surfel_composite_tiles_plain(inst: torch.Tensor, counts: torch.Tensor,
                                 pix: torch.Tensor, C: int,
                                 cfg: RasterConfig) -> torch.Tensor:
    """The plain PyTorch version of K5: the chunk scan `surfel_composite`
    on the same inputs, written out in the kernel's [T, 16, NPIX] layout."""
    T, K, _ = inst.shape
    npix = pix.shape[-1]
    inst_valid = (torch.arange(K, device=inst.device)[None, :]
                  < counts.to(torch.int64)[:, None])
    dirs = pix[:, 0:3].transpose(1, 2)                        # [T, NPIX, 3]
    Tr, _done, color, dep, nrm, m1, m2, dist, med = surfel_composite(
        inst, inst_valid, dirs, pix[:, 3].to(torch.int32), pix[:, 4].to(torch.int32), C, cfg)
    pad = torch.zeros((T, OUT_ROWS - C - 9, npix), dtype=torch.float32, device=inst.device)
    one = lambda x: x[:, None]
    return torch.cat([color, one(dep), one(Tr), nrm, one(med), one(dist), one(m1), one(m2),
                      pad], 1)


def surfel_composite_tiles(inst: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor,
                           C: int, cfg: RasterConfig) -> torch.Tensor:
    """[T, K, F] surfels + [T] counts + [T, 8, NPIX] pixel blocks ->
    [T, 16, NPIX]: K5 on a CUDA tensor, the plain version on a CPU tensor."""
    if inst.device.type == "cpu":
        return surfel_composite_tiles_plain(inst, counts, pix, C, cfg)
    if inst.device.type != "cuda":
        raise ValueError(f"surfel_composite_tiles: unsupported device {inst.device}")
    check_tile_inputs(inst, counts, pix, C, OUT_ROWS - 9, S.validf(C) + 1)
    check_rows_aligned(inst)
    T, K, Fw = inst.shape
    npix = pix.shape[2]
    out = torch.empty((T, OUT_ROWS, npix), dtype=torch.float32, device=inst.device)
    if T == 0:
        return out
    cuda_build.launch("surfel_fwd", "lidargs_surfel_fwd", _ARGS, (inst, counts, pix, out),
                      (T, K, Fw, npix, C, *_consts(cfg)))
    return out


def surfel_composite_tiles_bwd_plain(inst: torch.Tensor, counts: torch.Tensor,
                                     pix: torch.Tensor, res: torch.Tensor, g: torch.Tensor,
                                     C: int, cfg: RasterConfig) -> torch.Tensor:
    """The plain PyTorch version of K6: the TPU kernel's `_bwd_tile`, one
    forward-order pass over chunks of `cfg.chunk` rows with its chunk
    weights rule (`_chunk_weights`), vectorized over tiles. Every "behind"
    term is a total from the forward's output `res` minus a running prefix;
    the distortion's gradients take their closed forms (see `_bwd_tile`),
    and the median's cotangent goes to the applied rows with T-before > 0.5
    whose depth equals the saved median."""
    T, K, Fw = inst.shape
    npix = pix.shape[-1]
    dev = inst.device
    CH = min(cfg.chunk, K)
    n_ch = -(-K // CH)
    inst_p = torch.nn.functional.pad(inst, (0, 0, 0, n_ch * CH - K))
    dirx, diry, dirz, px, py = (pix[:, i:i + 1] for i in range(5))      # [T,1,NP]
    r = lambda i, n=1: res[:, i:i + n]
    q = lambda i, n=1: g[:, i:i + n]
    totc, totd, Tfin, totn = r(0, C), r(C), r(C + 1), r(C + 2, 3)
    med, totdist, totm1, totm2 = r(C + 5), r(C + 6), r(C + 7), r(C + 8)
    gc, gd, gT, gn = q(0, C), q(C), q(C + 1), q(C + 2, 3)
    gmed, gdist, gm1, gm2 = q(C + 5), q(C + 6), q(C + 7), q(C + 8)
    Wtot = 1.0 - Tfin
    # every suffix ("behind") term is linear in one running prefix of
    # w * direct; the distortion chain's suffix contributes 2 * totdist
    TOT = ((gc * totc).sum(1, keepdim=True) + gd * totd + (gn * totn).sum(1, keepdim=True)
           + gdist * 2.0 * totdist + gm1 * totm1 + gm2 * totm2)
    cnt = counts.to(torch.int64)[:, None, None]
    fn_, nn_ = cfg.surfel_far, cfg.surfel_near
    fis = cfg.filter_inv_square

    Tr = torch.ones((T, 1, npix), dtype=torch.float32, device=dev)
    done = torch.zeros((T, 1, npix), dtype=torch.bool, device=dev)
    acc_w = torch.zeros((T, 1, npix), dtype=torch.float32, device=dev)
    am1 = torch.zeros_like(acc_w)
    am2 = torch.zeros_like(acc_w)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    excl = lambda x: torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(x, 1)[:, :-1]], 1)
    rows = []
    for i in range(n_ch):
        s = inst_p[:, i * CH:(i + 1) * CH]
        gm = pair_geometry(s, dirx, diry, dirz, px, py, C, cfg)
        alpha = gm.alpha
        rowi = torch.arange(i * CH, (i + 1) * CH, device=dev)[None, :, None]
        passed = (rowi < cnt) & gm.passed
        # chunk weights: the prefix product over passed rows agrees with the
        # sequential transmittance up to the first crossing; a row is dead
        # once T * incl falls under T_min (incl never increases)
        one_m = 1.0 - torch.where(passed, alpha, zero)
        incl = torch.cumprod(one_m, 1)
        P = Tr * torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
        dead = Tr * incl < cfg.transmittance_min
        applied = passed & ~dead & ~done
        w = torch.where(applied, alpha * P, zero)
        t_fac = torch.cumprod(torch.where(dead, 1.0, one_m), 1)[:, -1:]
        T_new = Tr * torch.where(done, 1.0, t_fac)
        done = done | dead[:, -1:] | (T_new < cfg.transmittance_min)

        depth = gm.depth
        m = fn_ / (fn_ - nn_) * (1.0 - nn_ / depth.clamp_min(1e-9))
        wm = w * m
        wm2 = wm * m
        m1pre = am1 + excl(wm)
        m2pre = am2 + excl(wm2)
        psi = m * m * (1.0 - P) + m2pre - 2.0 * m * m1pre
        s_k = m * m * (P - w - Tfin) - 2.0 * m * (totm1 - m1pre - wm) + (totm2 - m2pre - wm2)
        feat = [s[:, :, S.FEAT0 + c, None] for c in range(C)]
        nrm = gm.n
        direct = (sum(gc[:, c:c + 1] * feat[c] for c in range(C)) + gd * depth
                  + sum(gn[:, k:k + 1] * nrm[k] for k in range(3))
                  + gdist * (psi + s_k) + gm1 * m + gm2 * m * m)
        wdir = w * direct
        behind = TOT - acc_w - torch.cumsum(wdir, 1)
        live = applied & (gm.araw <= cfg.alpha_clamp)
        # masked, not multiplied by zero: rows that are not applied may hold
        # large or infinite intermediates
        on = lambda mask, x: torch.where(mask, x, zero)
        dalpha = on(live, P * direct - (behind + gT * Tfin) / (1.0 - alpha))

        # the w-weighted value chains: m, depth, the median
        d_m = gdist * 2.0 * w * (m * Wtot - totm1) + gm1 * w + gm2 * 2.0 * wm
        med_sel = applied & (P > 0.5) & (depth == med)
        dm_ddep = on(depth > 1e-9, fn_ / (fn_ - nn_) * nn_ / (depth * depth))
        d_dep = on(applied, gd * w + d_m * dm_ddep) + on(med_sel, gmed.expand_as(depth))

        # alpha = min(clamp, opacity e), e = exp(-rho / 2)
        dop = dalpha * gm.e
        drho = -0.5 * dalpha * gm.araw
        drho3d = on(gm.use3d, drho)
        drho2d = on(~gm.use3d, drho)
        red = lambda x: x.sum(2)                                         # [T,CH]
        d_cenx = red(fis * 80.0 * gm.dxc * drho2d)
        d_ceny = red(fis * 200.0 * gm.dyc * drho2d)
        # rho3d = sx^2 + sy^2, sx = (dp . Tu) / max(|Tu|^2, eps): the radial
        # term dies where the clamp is active, as autodiff of max
        sx, sy, dp, tu, tv = gm.sx, gm.sy, gm.dp, gm.tu, gm.tv
        dsx = 2.0 * sx * drho3d
        dsy = 2.0 * sy * drho3d
        ncu = (gm.tu_sq > 1e-20).to(torch.float32)
        ncv = (gm.tv_sq > 1e-20).to(torch.float32)
        ddp = [dsx * tu[a] / gm.tu_tu + dsy * tv[a] / gm.tv_tv for a in range(3)]
        d_tu = [red(dsx * (dp[a] - ncu * 2.0 * sx * tu[a]) / gm.tu_tu) for a in range(3)]
        d_tv = [red(dsy * (dp[a] - ncv * 2.0 * sy * tv[a]) / gm.tv_tv) for a in range(3)]
        # depth = use3d ? lam2 : rho_r; dp = lam2 dir - Tw; lam2 = (Tw . n) / cos2
        dirv = (dirx, diry, dirz)
        d_lam2 = on(gm.use3d, d_dep) + ddp[0] * dirx + ddp[1] * diry + ddp[2] * dirz
        d_rho_r = red(on(~gm.use3d, d_dep))
        d_lam = red(d_lam2 / gm.cos2s)
        d_cos2 = on(gm.hit, -d_lam2 * gm.lam2 / gm.cos2s)
        tw_ok = (gm.tw_sq > 1e-20).to(torch.float32)[..., 0]
        twv = [x[..., 0] for x in gm.tw]
        nv = [x[..., 0] for x in nrm]
        rho_r = gm.rho_r[..., 0]
        d_tw = [-red(ddp[a]) + d_lam * nv[a] + tw_ok * d_rho_r * twv[a] / rho_r
                for a in range(3)]
        d_n = [d_lam * twv[a] + red(d_cos2 * dirv[a]) + red(w * gn[:, a:a + 1])
               for a in range(3)]
        z = torch.zeros_like(d_lam)
        cols = (d_tu + d_tv + d_tw + d_n + [red(dop), z]
                + [red(w * gc[:, c:c + 1]) for c in range(C)] + [d_cenx, d_ceny])
        d_s = torch.stack(cols, -1)                                       # [T,CH,16+C]
        rows.append(torch.nn.functional.pad(d_s, (0, Fw - d_s.shape[-1])))

        acc_w = acc_w + wdir.sum(1, keepdim=True)
        am1 = am1 + wm.sum(1, keepdim=True)
        am2 = am2 + wm2.sum(1, keepdim=True)
        Tr = T_new
    if not rows:
        return torch.zeros_like(inst)
    return torch.cat(rows, 1)[:, :K].contiguous()


def surfel_composite_tiles_bwd(inst: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor,
                               res: torch.Tensor, g: torch.Tensor, C: int,
                               cfg: RasterConfig) -> torch.Tensor:
    """The VJP of `surfel_composite_tiles`: [T, K, F] surfels, [T] counts,
    [T, 8, NPIX] pixel blocks, the forward's output `res` and the output
    cotangent `g` (both [T, 16, NPIX]) -> dinst [T, K, F]. K6 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if inst.device.type == "cpu":
        return surfel_composite_tiles_bwd_plain(inst, counts, pix, res, g, C, cfg)
    if inst.device.type != "cuda":
        raise ValueError(f"surfel_composite_tiles_bwd: unsupported device {inst.device}")
    check_tile_inputs(inst, counts, pix, C, OUT_ROWS - 9, S.validf(C) + 1)
    check_saved(inst, pix, OUT_ROWS, res=res, g=g)
    T, K, Fw = inst.shape
    npix = pix.shape[2]
    dinst = torch.empty_like(inst)      # the kernel writes every row, zeros included
    if T == 0:
        return dinst
    cuda_build.launch("surfel_bwd", "lidargs_surfel_bwd", _ARGS,
                      (inst, counts, pix, res, g, dinst), (T, K, Fw, npix, C, *_consts(cfg)))
    return dinst


class SurfelCompositeTiles(torch.autograd.Function):
    """`surfel_composite_tiles` with `surfel_composite_tiles_bwd` as its
    backward (K5 and K6 on the card). Only `inst` gets a gradient, as in the
    JAX package's custom VJP (zero for the counts and the pixel blocks)."""

    @staticmethod
    def forward(ctx, inst, counts, pix, C: int, cfg: RasterConfig):
        out = surfel_composite_tiles(inst, counts, pix, C, cfg)
        ctx.save_for_backward(inst, counts, pix, out)
        ctx.C, ctx.cfg = C, cfg
        return out

    @staticmethod
    def backward(ctx, g):
        inst, counts, pix, out = ctx.saved_tensors
        dinst = surfel_composite_tiles_bwd(inst, counts, pix, out, g.contiguous(), ctx.C,
                                           ctx.cfg)
        return dinst, None, None, None, None


def surfel_composite_windows_plain(buf: torch.Tensor, starts: torch.Tensor,
                                   counts: torch.Tensor, pix: torch.Tensor, C: int,
                                   cfg: RasterConfig) -> torch.Tensor:
    """The plain PyTorch version of K7: each tile's window gathered into a
    [T, K, F] list (`window_rows`), then `surfel_composite_tiles_plain`."""
    return surfel_composite_tiles_plain(window_rows(buf, starts, cfg.tile_capacity), counts,
                                        pix, C, cfg)


def surfel_composite_windows(buf: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor,
                             pix: torch.Tensor, C: int, cfg: RasterConfig) -> torch.Tensor:
    """[E, F] buffer + [T] starts and counts + [T, 8, NPIX] pixel blocks ->
    [T, 16, NPIX]: K7 on a CUDA tensor, the plain version on a CPU tensor."""
    if buf.device.type == "cpu":
        return surfel_composite_windows_plain(buf, starts, counts, pix, C, cfg)
    if buf.device.type != "cuda":
        raise ValueError(f"surfel_composite_windows: unsupported device {buf.device}")
    K = cfg.tile_capacity
    check_window_inputs(buf, starts, counts, pix, K, C, OUT_ROWS - 9, S.validf(C) + 1)
    check_rows_aligned(buf)
    T, npix = pix.shape[0], pix.shape[2]
    out = torch.empty((T, OUT_ROWS, npix), dtype=torch.float32, device=buf.device)
    if T == 0:
        return out
    cuda_build.launch("surfel_fwd", "lidargs_surfel_fwd_windows", _ARGS,
                      (buf, starts, counts, pix, out), (T, K, buf.shape[1], npix, C, *_consts(cfg)))
    return out


def surfel_composite_windows_bwd_plain(buf: torch.Tensor, starts: torch.Tensor,
                                       counts: torch.Tensor, pix: torch.Tensor,
                                       res: torch.Tensor, g: torch.Tensor, C: int,
                                       cfg: RasterConfig) -> torch.Tensor:
    """The plain PyTorch version of K8: `surfel_composite_tiles_bwd_plain` on
    the gathered windows, its rows [0, counts[t]) written at rows
    [starts[t], starts[t] + counts[t]) of a zeroed [E, F] dbuf."""
    dinst = surfel_composite_tiles_bwd_plain(window_rows(buf, starts, cfg.tile_capacity),
                                             counts, pix, res, g, C, cfg)
    return scatter_windows(dinst, starts, counts, buf.shape[0])


def surfel_composite_windows_bwd(buf: torch.Tensor, starts: torch.Tensor,
                                 counts: torch.Tensor, pix: torch.Tensor, res: torch.Tensor,
                                 g: torch.Tensor, C: int, cfg: RasterConfig) -> torch.Tensor:
    """The VJP of `surfel_composite_windows`: -> dbuf [E, F], the gradient of
    each tile's rows at those rows and zero on every other row. K8 on a CUDA
    tensor (into a zeroed dbuf), the plain version on a CPU tensor."""
    if buf.device.type == "cpu":
        return surfel_composite_windows_bwd_plain(buf, starts, counts, pix, res, g, C, cfg)
    if buf.device.type != "cuda":
        raise ValueError(f"surfel_composite_windows_bwd: unsupported device {buf.device}")
    K = cfg.tile_capacity
    check_window_inputs(buf, starts, counts, pix, K, C, OUT_ROWS - 9, S.validf(C) + 1)
    check_saved(buf, pix, OUT_ROWS, res=res, g=g)
    T, npix = pix.shape[0], pix.shape[2]
    dbuf = torch.zeros_like(buf)        # the kernel writes the owned rows alone
    if T == 0:
        return dbuf
    cuda_build.launch("surfel_bwd", "lidargs_surfel_bwd_windows", _ARGS,
                      (buf, starts, counts, pix, res, g, dbuf),
                      (T, K, buf.shape[1], npix, C, *_consts(cfg)))
    return dbuf


class SurfelCompositeWindows(torch.autograd.Function):
    """`surfel_composite_windows` with `surfel_composite_windows_bwd` as its
    backward (K7 and K8 on the card). Only `buf` gets a gradient, as in the
    JAX package's custom VJP of `surfel_composite_windows`."""

    @staticmethod
    def forward(ctx, buf, starts, counts, pix, C: int, cfg: RasterConfig):
        out = surfel_composite_windows(buf, starts, counts, pix, C, cfg)
        ctx.save_for_backward(buf, starts, counts, pix, out)
        ctx.C, ctx.cfg = C, cfg
        return out

    @staticmethod
    def backward(ctx, g):
        buf, starts, counts, pix, out = ctx.saved_tensors
        dbuf = surfel_composite_windows_bwd(buf, starts, counts, pix, out, g.contiguous(),
                                            ctx.C, ctx.cfg)
        return dbuf, None, None, None, None, None
