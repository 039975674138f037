"""Composite over per-tile instance lists: kernels K1 (forward) and K2
(backward), their window forms K3 and K4, their plain versions, and the
autograd functions that join them.

`composite_tiles` is the forward of `composite_tiles_pallas`
(`lidargs_tpu/ops/pallas_composite.py`, kernel body `_fwd_kernel`);
`composite_tiles_bwd` is its VJP (kernel body `_bwd_tile`). On a CUDA tensor
each launches its hand-written kernel (`csrc/composite_fwd.cu`,
`csrc/composite_bwd.cu`, built with nvcc for sm_90a at the first call and
loaded with ctypes); on a CPU tensor each runs its plain PyTorch version
(`composite_tiles_plain`, `composite_tiles_bwd_plain`) with the same
signature and layout. There is no fallback from one to the other: a CUDA
tensor a kernel cannot take raises. `CompositeTiles` is the
`torch.autograd.Function` with `composite_tiles` forward and
`composite_tiles_bwd` backward, as `composite_tiles_pallas` is a custom VJP.

The window forms take one dense depth-sorted buffer instead of the
`[T, K, F]` lists: `composite_windows` (K3, the forward of
`composite_windows_pallas`, kernel body `_fwd_kernel_fused`) reads tile t's
rows `buf[starts[t] : starts[t] + counts[t])`; `composite_windows_bwd` (K4,
kernel body `_bwd_kernel_fused`) writes their gradients at the same rows of
a zeroed `dbuf` and no other row, which is the JAX package's `dbuf` after
`mask_unwritten_rows`. `CompositeWindows` joins them.

Layout (shared by both):
  inst   [T, K, F] f32   depth-ordered packed instances (PackedCols)
  counts [T]       i32   live rows per tile
  pix    [T, 8, NPIX] f32  rows 0-2 unit ray dir, row 3 column, row 4 row
  out    [T, 8, NPIX] f32  rows 0..C-1 features, row C depth, row C+1 final
                           transmittance, the rest zero
  dinst  [T, K, F] f32   d loss / d inst: mean(3), u1(3), u2(3), conic(3),
                         opacity, depth, features(C); zero in the rect,
                         center, valid and pad columns and on rows no pixel
                         walked
  buf    [E, F] f32      window form: rows in sorted (tile, depth) order, the
                         last K of them zero padding (E >= starts[t] + K)
  starts [T]    i32      window form: tile t's first row in buf
  dbuf   [E, F] f32      window form: the gradient of tile t's rows [starts[t],
                         starts[t] + counts[t]) at those rows, zero elsewhere
"""
from __future__ import annotations

import ctypes

import torch

from ..config import RasterConfig
from ..utils import cuda_build
from .composite import composite_packed
from .projection import PackedCols as PC

OUT_ROWS = 8
PIX_ROWS = 8             # rows of a pixel block
MAX_NPIX = 1024          # one thread per pixel; a backward kernel's block holds a tile
FWD_CHUNK = 64           # rows a shared-memory stage of the forward kernels holds
FWD_SMEM = 48 * 1024     # bytes of shared memory a block gets without opting in

# the launch functions' arguments between the tensor pointers and the
# stream: T, K, F, NPIX, C, alpha_min, alpha_clamp, transmittance_min
_ARGS = [ctypes.c_int] * 5 + [ctypes.c_float] * 3


def _consts(cfg: RasterConfig):
    return cfg.alpha_min, cfg.alpha_clamp, cfg.transmittance_min


def composite_tiles_plain(inst: torch.Tensor, counts: torch.Tensor,
                          pix: torch.Tensor, C: int,
                          cfg: RasterConfig) -> torch.Tensor:
    """The plain PyTorch version of K1: the chunked prefix-product scan of
    `composite_packed` on the same inputs, written out in the kernel's
    [T, 8, NPIX] layout."""
    T, K, _ = inst.shape
    npix = pix.shape[-1]
    inst_valid = (torch.arange(K, device=inst.device)[None, :]
                  < counts.to(torch.int64)[:, None])
    dirs = pix[:, 0:3].transpose(1, 2)                       # [T, NPIX, 3]
    pix_x = pix[:, 3].to(torch.int32)
    pix_y = pix[:, 4].to(torch.int32)
    out = composite_packed(inst, inst_valid, dirs, pix_x, pix_y, C, cfg)
    pad = torch.zeros((T, OUT_ROWS - C - 2, npix), dtype=torch.float32,
                      device=inst.device)
    return torch.cat([out.color, out.depth[:, None], out.final_T[:, None], pad], 1)


def _check_inputs(rows, ints: dict, pix, T: int, C: int, max_c: int, row_width: int):
    """The checks shared by both forms: float32 `rows` at least `row_width`
    wide in its last dimension, each of `ints` an int32 [T] tensor,
    [T, 8, NPIX] float32 pixel blocks with NPIX in 1..MAX_NPIX, all
    contiguous on one device, and C in 1..max_c."""
    dev = rows.device
    if pix.device != dev or any(x.device != dev for x in ints.values()):
        raise ValueError(f"inputs on different devices: {rows.device}, "
                         f"{[x.device for x in ints.values()]}, {pix.device}")
    if rows.dtype != torch.float32 or pix.dtype != torch.float32:
        raise TypeError(f"rows and pix must be float32, got {rows.dtype}, {pix.dtype}")
    for name, x in ints.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if tuple(x.shape) != (T,):
            raise ValueError(f"{name} shape {tuple(x.shape)} != ({T},)")
    if pix.dim() != 3 or pix.shape[0] != T or pix.shape[1] != PIX_ROWS:
        raise ValueError(f"pix shape {tuple(pix.shape)} != ({T}, {PIX_ROWS}, NPIX)")
    if not 1 <= C <= max_c:
        raise ValueError(f"C={C} outside 1..{max_c}")
    if rows.shape[-1] < row_width:
        raise ValueError(f"row width {rows.shape[-1]} is narrower than {row_width} for C={C}")
    if not 1 <= pix.shape[2] <= MAX_NPIX:
        raise ValueError(f"NPIX={pix.shape[2]} outside 1..{MAX_NPIX}")
    if not (rows.is_contiguous() and pix.is_contiguous()
            and all(x.is_contiguous() for x in ints.values())):
        raise ValueError("inputs must be contiguous")


def check_rows_aligned(rows: torch.Tensor) -> None:
    """Raise unless the forward kernels' bulk copies can stage `rows`
    (`csrc/fwd_stage.cuh`): rows of F floats with F % 4 == 0 (whole 16-byte
    units) from a 16-byte aligned base, so every row and every window
    starts on a 16-byte boundary, and two stages of FWD_CHUNK rows within
    FWD_SMEM bytes."""
    F = rows.shape[-1]
    if F % 4 or rows.data_ptr() % 16:
        raise ValueError(f"rows of {F} floats at {rows.data_ptr():#x}: the forward kernels "
                         "stage 16-byte units and need F % 4 == 0 and a 16-byte aligned base")
    if 2 * FWD_CHUNK * F * 4 > FWD_SMEM:
        raise ValueError(f"rows of {F} floats: two stages of {FWD_CHUNK} exceed {FWD_SMEM} "
                         "bytes of shared memory")


def warp_row_mask(rows: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor, rect: int,
                  valid: int | None = None) -> torch.Tensor:
    """The forward kernels' per-warp row masks (`warp_rows` in
    `csrc/fwd_stage.cuh`), written plainly: [T, K, n_warps] bool, row k of
    tile t set for warp w iff k < counts[t], the row is valid where `valid`
    names its flag's column (flag > 0), and its parity rect [x0, x1) x
    [y0, y1) (columns rect .. rect + 3) meets the box of warp w's pixel
    columns and rows: pixels [32 w, 32 w + 32) of the tile, the last warp's
    padding adding nothing. A lane's rect test can pass only on a row its
    warp's mask holds."""
    T, K, _ = rows.shape
    npix = pix.shape[2]
    pad = -npix % 32
    inf = float("inf")

    def box(v):                                                # [T, NPIX] -> 2 x [T, 1, n_warps]
        lo = torch.nn.functional.pad(v, (0, pad), value=inf).view(T, -1, 32).amin(-1)
        hi = torch.nn.functional.pad(v, (0, pad), value=-inf).view(T, -1, 32).amax(-1)
        return lo[:, None], hi[:, None]

    (x_lo, x_hi), (y_lo, y_hi) = box(pix[:, 3]), box(pix[:, 4])
    x0, x1, y0, y1 = (rows[:, :, rect + i, None] for i in range(4))        # [T, K, 1]
    mask = (x0 <= x_hi) & (x1 > x_lo) & (y0 <= y_hi) & (y1 > y_lo)
    mask &= (torch.arange(K, device=rows.device)[None, :, None]
             < counts.to(torch.int64)[:, None, None])
    if valid is not None:
        mask &= rows[:, :, valid, None] > 0.0
    return mask


def check_tile_inputs(inst, counts, pix, C: int, max_c: int, row_width: int):
    """Raise on inputs a composite kernel cannot take: [T, K, F] float32
    rows at least `row_width` wide, [T] int32 counts, [T, 8, NPIX] float32
    pixel blocks with NPIX in 1..MAX_NPIX, all contiguous on one device, and
    C in 1..max_c."""
    if inst.dim() != 3 or counts.dim() != 1:
        raise ValueError("expected inst [T,K,F], counts [T], pix [T,8,NPIX]")
    _check_inputs(inst, {"counts": counts}, pix, inst.shape[0], C, max_c, row_width)


def check_window_inputs(buf, starts, counts, pix, K: int, C: int, max_c: int,
                        row_width: int):
    """Raise on inputs a window kernel cannot take: an [E, F] float32 buffer
    with E >= K, [T] int32 starts and counts, and the pixel blocks and C of
    `check_tile_inputs`. That every window [starts[t], starts[t] + K) lies
    inside buf is `window_rows`'s check: on the card it would cost a read
    of `starts` back to the host on every call."""
    if buf.dim() != 2 or starts.dim() != 1:
        raise ValueError("expected buf [E,F], starts [T], counts [T], pix [T,8,NPIX]")
    if buf.shape[0] < K:
        raise ValueError(f"buf has {buf.shape[0]} rows, fewer than K={K}")
    _check_inputs(buf, {"starts": starts, "counts": counts}, pix, starts.shape[0], C, max_c,
                  row_width)


def window_rows(buf: torch.Tensor, starts: torch.Tensor, K: int) -> torch.Tensor:
    """[T, K, F]: rows [starts[t], starts[t] + K) of buf for each tile (a
    gather). Raises if a window reaches past buf's end."""
    T = starts.shape[0]
    if T and (int(starts.min()) < 0 or int(starts.max()) + K > buf.shape[0]):
        raise ValueError(f"a window [start, start + {K}) leaves buf's {buf.shape[0]} rows")
    idx = starts.to(torch.int64)[:, None] + torch.arange(K, device=buf.device)[None, :]
    return buf[idx]


def scatter_windows(dinst: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """[n_rows, F] zeros with rows [0, counts[t]) of each tile's [K, F]
    block of dinst written at rows [starts[t], starts[t] + counts[t]): the
    window kernels' write rule. The owned ranges are disjoint."""
    T, K, Fw = dinst.shape
    k = torch.arange(K, device=dinst.device)[None, :]
    own = k < counts.to(torch.int64)[:, None]
    out = torch.zeros((n_rows, Fw), dtype=dinst.dtype, device=dinst.device)
    out[(starts.to(torch.int64)[:, None] + k)[own]] = dinst[own]
    return out


def mask_unwritten_rows(dbuf: torch.Tensor, starts: torch.Tensor, K: int) -> torch.Tensor:
    """Zero every row of dbuf that lies in no tile's [start, start + K)
    window (the JAX package's `mask_unwritten_rows`, with `where`, not a
    multiply). On the window kernels' output it changes nothing: a row they
    write lies in its own tile's window, and every other row is zero."""
    r = torch.arange(dbuf.shape[0], dtype=torch.int32, device=dbuf.device)
    t = (torch.searchsorted(starts, r, right=True, out_int32=True) - 1).clamp(
        0, starts.shape[0] - 1)
    written = (r >= starts[t]) & (r < starts[t] + K)
    return torch.where(written[:, None], dbuf, torch.zeros((), dtype=dbuf.dtype,
                                                            device=dbuf.device))


def check_saved(inst, pix, out_rows: int, **tensors):
    """Raise unless each of `tensors` (a forward's output, its cotangent)
    is a contiguous float32 [T, out_rows, NPIX] tensor on inst's device."""
    shape = (pix.shape[0], out_rows, pix.shape[2])
    for name, x in tensors.items():
        if x.device != inst.device:
            raise ValueError(f"{name} on {x.device}, inst on {inst.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def composite_tiles(inst: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor,
                    C: int, cfg: RasterConfig) -> torch.Tensor:
    """[T, K, F] instances + [T] counts + [T, 8, NPIX] pixel blocks ->
    [T, 8, NPIX]: K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if inst.device.type == "cpu":
        return composite_tiles_plain(inst, counts, pix, C, cfg)
    if inst.device.type != "cuda":
        raise ValueError(f"composite_tiles: unsupported device {inst.device}")
    check_tile_inputs(inst, counts, pix, C, OUT_ROWS - 2, PC.rect(C).stop)
    check_rows_aligned(inst)
    T, K, Fw = inst.shape
    npix = pix.shape[2]
    out = torch.empty((T, OUT_ROWS, npix), dtype=torch.float32, device=inst.device)
    if T == 0:
        return out
    cuda_build.launch("composite_fwd", "lidargs_composite_fwd", _ARGS, (inst, counts, pix, out),
                      (T, K, Fw, npix, C, *_consts(cfg)))
    return out


def composite_tiles_bwd_plain(inst: torch.Tensor, counts: torch.Tensor,
                              pix: torch.Tensor, res: torch.Tensor, g: torch.Tensor,
                              C: int, cfg: RasterConfig) -> torch.Tensor:
    """The plain PyTorch version of K2: the TPU kernel's `_bwd_tile`, one
    forward-order pass over chunks of `cfg.chunk` rows with its chunk
    weights rule (`_chunk_weights`), vectorized over tiles.

    It is not autograd of `composite_tiles_plain`: like the kernels it
    takes the packed u1, u2 as unit vectors and drops the scan's /|u|^2, so
    its per-row d_u1, d_u2 differ from that route's and agree only after
    the projection's normalization removes their radial part."""
    T, K, Fw = inst.shape
    npix = pix.shape[-1]
    dev = inst.device
    CH = min(cfg.chunk, K)
    n_ch = -(-K // CH)
    inst_p = torch.nn.functional.pad(inst, (0, 0, 0, n_ch * CH - K))
    dirx, diry, dirz, px, py = (pix[:, i:i + 1] for i in range(5))      # [T,1,NP]
    gc, gd, gT = g[:, :C], g[:, C:C + 1], g[:, C + 1:C + 2]
    totc, totd, Tfin = res[:, :C], res[:, C:C + 1], res[:, C + 1:C + 2]
    # every suffix ("behind") term is linear in one running prefix of
    # w * direct: behind = TOT - (inclusive prefix of w * direct)
    TOT = (gc * totc).sum(1, keepdim=True) + gd * totd
    cnt = counts.to(torch.int64)[:, None, None]
    rect = PC.rect(C).start

    Tr = torch.ones((T, 1, npix), dtype=torch.float32, device=dev)
    done = torch.zeros((T, 1, npix), dtype=torch.bool, device=dev)
    acc_w = torch.zeros((T, 1, npix), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rows = []
    for i in range(n_ch):
        s = inst_p[:, i * CH:(i + 1) * CH]
        col = lambda j: s[:, :, j, None]                                 # [T,CH,1]
        dxv, dyv, dzv = col(0) - dirx, col(1) - diry, col(2) - dirz
        ddx = dxv * col(3) + dyv * col(4) + dzv * col(5)
        ddy = dxv * col(6) + dyv * col(7) + dzv * col(8)
        ca, cb, cc = col(9), col(10), col(11)
        power = -0.5 * (ca * ddx * ddx + cc * ddy * ddy) - cb * ddx * ddy
        e = torch.exp(power)
        araw = col(PC.OPACITY) * e
        alpha = araw.clamp_max(cfg.alpha_clamp)
        rowi = torch.arange(i * CH, (i + 1) * CH, device=dev)[None, :, None]
        passed = ((rowi < cnt)
                  & (px >= col(rect)) & (px < col(rect + 1))
                  & (py >= col(rect + 2)) & (py < col(rect + 3))
                  & (power <= 0.0) & (alpha >= cfg.alpha_min))
        # chunk weights: the prefix product over passed rows agrees with the
        # sequential transmittance up to the first crossing; a row is dead
        # once T * incl falls under T_min (incl never increases)
        one_m = 1.0 - torch.where(passed, alpha, zero)
        incl = torch.cumprod(one_m, 1)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
        P = Tr * excl
        dead = Tr * incl < cfg.transmittance_min
        applied = passed & ~dead & ~done
        w = torch.where(applied, alpha * P, zero)
        t_fac = torch.cumprod(torch.where(dead, 1.0, one_m), 1)[:, -1:]
        T_new = Tr * torch.where(done, 1.0, t_fac)
        done = done | dead[:, -1:] | (T_new < cfg.transmittance_min)

        direct = sum(gc[:, c:c + 1] * col(PC.FEAT0 + c) for c in range(C)) + gd * col(PC.DEPTH)
        wdir = w * direct
        behind = TOT - acc_w - torch.cumsum(wdir, 1)
        inv1m = 1.0 / (1.0 - alpha)
        live = applied & (araw <= cfg.alpha_clamp)
        dalpha = torch.where(live, P * direct - inv1m * (behind + gT * Tfin), zero)
        # masked, not multiplied by zero: rows that are not live may hold
        # large or infinite intermediates
        on = lambda x: torch.where(live, x, zero)
        dpower = on(dalpha * araw)
        d_ddx = on(-dpower * (ca * ddx + cb * ddy))
        d_ddy = on(-dpower * (cc * ddy + cb * ddx))
        red = lambda x: x.sum(2)                                         # [T,CH]
        cols = [
            red(d_ddx * col(3) + d_ddy * col(6)),
            red(d_ddx * col(4) + d_ddy * col(7)),
            red(d_ddx * col(5) + d_ddy * col(8)),
            red(d_ddx * dxv), red(d_ddx * dyv), red(d_ddx * dzv),
            red(d_ddy * dxv), red(d_ddy * dyv), red(d_ddy * dzv),
            red(on(-0.5 * ddx * ddx * dpower)), red(on(-ddx * ddy * dpower)),
            red(on(-0.5 * ddy * ddy * dpower)),
            red(on(dalpha * e)),
            red(w * gd),
        ] + [red(w * gc[:, c:c + 1]) for c in range(C)]
        d_s = torch.stack(cols, -1)                                      # [T,CH,14+C]
        rows.append(torch.nn.functional.pad(d_s, (0, Fw - d_s.shape[-1])))
        acc_w = acc_w + wdir.sum(1, keepdim=True)
        Tr = T_new
    if not rows:
        return torch.zeros_like(inst)
    return torch.cat(rows, 1)[:, :K].contiguous()


def composite_tiles_bwd(inst: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor,
                        res: torch.Tensor, g: torch.Tensor, C: int,
                        cfg: RasterConfig) -> torch.Tensor:
    """The VJP of `composite_tiles`: [T, K, F] instances, [T] counts,
    [T, 8, NPIX] pixel blocks, the forward's output `res` and the output
    cotangent `g` (both [T, 8, NPIX]) -> dinst [T, K, F]. K2 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if inst.device.type == "cpu":
        return composite_tiles_bwd_plain(inst, counts, pix, res, g, C, cfg)
    if inst.device.type != "cuda":
        raise ValueError(f"composite_tiles_bwd: unsupported device {inst.device}")
    check_tile_inputs(inst, counts, pix, C, OUT_ROWS - 2, PC.rect(C).stop)
    check_saved(inst, pix, OUT_ROWS, res=res, g=g)
    T, K, Fw = inst.shape
    npix = pix.shape[2]
    dinst = torch.empty_like(inst)      # the kernel writes every row, zeros included
    if T == 0:
        return dinst
    cuda_build.launch("composite_bwd", "lidargs_composite_bwd", _ARGS,
                      (inst, counts, pix, res, g, dinst), (T, K, Fw, npix, C, *_consts(cfg)))
    return dinst


class CompositeTiles(torch.autograd.Function):
    """`composite_tiles` with `composite_tiles_bwd` as its backward (K1 and
    K2 on the card). Only `inst` gets a gradient, as in the JAX package's
    custom VJP (zero for the counts and the pixel blocks)."""

    @staticmethod
    def forward(ctx, inst, counts, pix, C: int, cfg: RasterConfig):
        out = composite_tiles(inst, counts, pix, C, cfg)
        ctx.save_for_backward(inst, counts, pix, out)
        ctx.C, ctx.cfg = C, cfg
        return out

    @staticmethod
    def backward(ctx, g):
        inst, counts, pix, out = ctx.saved_tensors
        dinst = composite_tiles_bwd(inst, counts, pix, out, g.contiguous(), ctx.C, ctx.cfg)
        return dinst, None, None, None, None


def composite_windows_plain(buf: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor,
                            pix: torch.Tensor, C: int, cfg: RasterConfig) -> torch.Tensor:
    """The plain PyTorch version of K3: each tile's window gathered into a
    [T, K, F] list (`window_rows`), then `composite_tiles_plain`."""
    return composite_tiles_plain(window_rows(buf, starts, cfg.tile_capacity), counts, pix,
                                 C, cfg)


def composite_windows(buf: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor,
                      pix: torch.Tensor, C: int, cfg: RasterConfig) -> torch.Tensor:
    """[E, F] buffer + [T] starts and counts + [T, 8, NPIX] pixel blocks ->
    [T, 8, NPIX]: K3 on a CUDA tensor, the plain version on a CPU tensor."""
    if buf.device.type == "cpu":
        return composite_windows_plain(buf, starts, counts, pix, C, cfg)
    if buf.device.type != "cuda":
        raise ValueError(f"composite_windows: unsupported device {buf.device}")
    K = cfg.tile_capacity
    check_window_inputs(buf, starts, counts, pix, K, C, OUT_ROWS - 2, PC.rect(C).stop)
    check_rows_aligned(buf)
    T, npix = pix.shape[0], pix.shape[2]
    out = torch.empty((T, OUT_ROWS, npix), dtype=torch.float32, device=buf.device)
    if T == 0:
        return out
    cuda_build.launch("composite_fwd", "lidargs_composite_fwd_windows", _ARGS,
                      (buf, starts, counts, pix, out), (T, K, buf.shape[1], npix, C, *_consts(cfg)))
    return out


def composite_windows_bwd_plain(buf: torch.Tensor, starts: torch.Tensor,
                                counts: torch.Tensor, pix: torch.Tensor, res: torch.Tensor,
                                g: torch.Tensor, C: int, cfg: RasterConfig) -> torch.Tensor:
    """The plain PyTorch version of K4: `composite_tiles_bwd_plain` on the
    gathered windows, its rows [0, counts[t]) written at rows [starts[t],
    starts[t] + counts[t]) of a zeroed [E, F] dbuf (`scatter_windows`)."""
    dinst = composite_tiles_bwd_plain(window_rows(buf, starts, cfg.tile_capacity), counts,
                                      pix, res, g, C, cfg)
    return scatter_windows(dinst, starts, counts, buf.shape[0])


def composite_windows_bwd(buf: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor,
                          pix: torch.Tensor, res: torch.Tensor, g: torch.Tensor, C: int,
                          cfg: RasterConfig) -> torch.Tensor:
    """The VJP of `composite_windows`: -> dbuf [E, F], the gradient of each
    tile's rows at those rows and zero on every other row. K4 on a CUDA
    tensor (into a zeroed dbuf), the plain version on a CPU tensor."""
    if buf.device.type == "cpu":
        return composite_windows_bwd_plain(buf, starts, counts, pix, res, g, C, cfg)
    if buf.device.type != "cuda":
        raise ValueError(f"composite_windows_bwd: unsupported device {buf.device}")
    K = cfg.tile_capacity
    check_window_inputs(buf, starts, counts, pix, K, C, OUT_ROWS - 2, PC.rect(C).stop)
    check_saved(buf, pix, OUT_ROWS, res=res, g=g)
    T, npix = pix.shape[0], pix.shape[2]
    dbuf = torch.zeros_like(buf)        # the kernel writes the owned rows alone
    if T == 0:
        return dbuf
    cuda_build.launch("composite_bwd", "lidargs_composite_bwd_windows", _ARGS,
                      (buf, starts, counts, pix, res, g, dbuf),
                      (T, K, buf.shape[1], npix, C, *_consts(cfg)))
    return dbuf


class CompositeWindows(torch.autograd.Function):
    """`composite_windows` with `composite_windows_bwd` as its backward (K3
    and K4 on the card). Only `buf` gets a gradient, as in the JAX package's
    custom VJP of `composite_windows_pallas`."""

    @staticmethod
    def forward(ctx, buf, starts, counts, pix, C: int, cfg: RasterConfig):
        out = composite_windows(buf, starts, counts, pix, C, cfg)
        ctx.save_for_backward(buf, starts, counts, pix, out)
        ctx.C, ctx.cfg = C, cfg
        return out

    @staticmethod
    def backward(ctx, g):
        buf, starts, counts, pix, out = ctx.saved_tensors
        dbuf = composite_windows_bwd(buf, starts, counts, pix, out, g.contiguous(), ctx.C,
                                     ctx.cfg)
        return dbuf, None, None, None, None, None
