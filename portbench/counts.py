"""The yardstick's arithmetic: the H100's peaks, the FP32 operations and
bytes the work of a step or frame needs, and the composite kernels' bound.

The pair walk and the byte rule are frozen copies of `chip_smoke.py`'s
(`walked_pairs`, `walked_surfel_pairs`, `tile_bytes`, `bound` and the
`OPS_*` constants, counted there from the kernels' sources). They are fed
with what the reference derives for the cell's inputs (its tile lists,
its visible anchors, its kept gaussians), never with the port's tensors
or its capacities: a later change that pads less or takes a kernel off the
path leaves these counts as they are.

The decode's and the projection's operations per row are those of the
port's `utils/roofline.py`, counted here over the live rows (the visible
anchors, the rendered gaussians) where it counts the capacity. The surfel
preprocess, the loss and Adam have no count in the port; theirs are
counted here from the reference's code, one per add, multiply, divide,
compare, select, square root or transcendental.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .reference.projection import PackedCols as PC
from .reference.surfel import SurfelCols as S
from .reference.surfel import pair_geometry

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12    # H100 SXM FP32, outside the tensor cores (the port turns TF32 off)
# the beam composite, per pixel-instance pair (K1 / K2)
OPS_IN_RECT = 35               # inside the parity rect: the alpha and the blend
OPS_OUT_RECT = 4               # the rect test alone
OPS_APPLIED_BWD = 80           # K2 per applied pair, + 14 + C for the reduction
# the surfel composite, per pixel-surfel pair (K5 / K6)
OPS_S_OUT_RECT = 5
OPS_S_IN_RECT = 85
OPS_S_FWD_APPLIED = 28         # + 2 C
OPS_S_BWD_APPLIED = 288        # + 4 C
# the other stages: the decode and the projection as the port's
# `utils/roofline.py` counts them per row (its "mlp decode" and "projection
# + pack" stages), here per live row instead of per capacity row
OPS_DECODE_ELEMENTWISE = 60    # per decoded gaussian, besides the heads' products
OPS_PROJECT = 160              # preprocess_gaussians per decoded gaussian
OPS_SURFEL_PROJECT = 300       # preprocess_surfels per surfel (no count in the port; this
#                                one: rotation 45, axes and center 60, normal 40, projected
#                                extent 90, rect 65)
OPS_LOSS_PIXEL = 270           # the SSIM's five windows as two 11-tap passes (220), its
#                                combination (20), the L1 / L2 / azimuth-gradient terms (30)
OPS_ADAM = 14                  # per parameter element: two moments, bias corrections, step
BWD_FACTOR = 2                 # a backward's operations per forward operation (dX and dW)


class Bound(NamedTuple):
    bytes: int
    ops: int

    @property
    def ms(self) -> float:
        return max(self.bytes / PEAK_BYTES_PER_S, self.ops / PEAK_FP32_OPS_PER_S) * 1e3


def tile_bytes(counts, rows_walked: int, cols: int, pix, *elements: int) -> int:
    """Bytes a composite over tiles must move: `cols` columns of the rows
    some pixel's walk reaches, the counts, the five pixel rows it reads,
    and `elements` more f32 elements (other inputs, the output)."""
    T, _, npix = pix.shape
    return 4 * (rows_walked * cols + counts.numel() + T * 5 * npix + sum(elements))


def walked_pairs(inst, counts, pix, C: int, cfg, group: int = 16):
    """(applied, other in rect, out of rect, rows reached): the pixel-
    instance pairs the beam composite's walk visits, each pixel's live rows
    up to and including its first transmittance crossing."""
    T, K, _ = inst.shape
    rc = PC.rect(C).start
    k = torch.arange(K, device=inst.device)[None, :, None]
    n_app = n_in = n_out = n_rows = 0
    for t0 in range(0, T, group):
        r = inst[t0:t0 + group]
        col = lambda i: r[:, :, i, None]
        dirx, diry, dirz, px, py = (pix[t0:t0 + group, i, None, :] for i in range(5))
        live = k < counts[t0:t0 + group, None, None]
        in_rect = (live & (px >= col(rc)) & (px < col(rc + 1))
                   & (py >= col(rc + 2)) & (py < col(rc + 3)))
        dx, dy, dz = col(0) - dirx, col(1) - diry, col(2) - dirz
        ddx = dx * col(3) + dy * col(4) + dz * col(5)
        ddy = dx * col(6) + dy * col(7) + dz * col(8)
        power = -0.5 * (col(9) * ddx * ddx + col(11) * ddy * ddy) - col(10) * ddx * ddy
        alpha = (col(PC.OPACITY) * torch.exp(power)).clamp_max(cfg.alpha_clamp)
        passed = in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
        t_incl = torch.cumprod(torch.where(passed, 1.0 - alpha, 1.0), dim=1)
        cross = (passed & (t_incl < cfg.transmittance_min)).to(torch.int32)
        visited = live & ((torch.cumsum(cross, 1) - cross) == 0)
        applied = visited & passed & (cross == 0)
        n_app += int(applied.sum())
        n_in += int((visited & in_rect).sum())
        n_out += int((visited & ~in_rect).sum())
        n_rows += int(visited.any(dim=2).sum())
    return n_app, n_in - n_app, n_out, n_rows


def walked_surfel_pairs(inst, counts, pix, C: int, cfg, group: int = 16):
    """(applied, other past the cheap tests, stopped by them, rows reached)
    of the surfel composite's walk."""
    T, K, _ = inst.shape
    rc, vf = S.rect(C).start, S.validf(C)
    k = torch.arange(K, device=inst.device)[None, :, None]
    n_app = n_in = n_out = n_rows = 0
    for t0 in range(0, T, group):
        r = inst[t0:t0 + group]
        col = lambda i: r[:, :, i, None]
        dirx, diry, dirz, px, py = (pix[t0:t0 + group, i, None, :] for i in range(5))
        live = k < counts[t0:t0 + group, None, None]
        cheap = (live & (col(vf) > 0.0) & (px >= col(rc)) & (px < col(rc + 1))
                 & (py >= col(rc + 2)) & (py < col(rc + 3)))
        g = pair_geometry(r, dirx, diry, dirz, px, py, C, cfg)
        passed = live & g.passed
        t_incl = torch.cumprod(torch.where(passed, 1.0 - g.alpha, 1.0), dim=1)
        cross = (passed & (t_incl < cfg.transmittance_min)).to(torch.int32)
        visited = live & ((torch.cumsum(cross, 1) - cross) == 0)
        applied = visited & passed & (cross == 0)
        n_app += int(applied.sum())
        n_in += int((visited & cheap).sum())
        n_out += int((visited & ~cheap).sum())
        n_rows += int(visited.any(dim=2).sum())
    return n_app, n_in - n_app, n_out, n_rows


def composite_bounds(lists, C: int, cfg, variant: str) -> tuple:
    """(forward Bound, backward Bound) of the composite kernels on one
    frame's tile lists (K1 / K2 beam, K5 / K6 surfel)."""
    inst, counts, pix = lists.inst, lists.counts, lists.pix
    T, _, npix = pix.shape
    if variant == "beam":
        a, o, x, rows = walked_pairs(inst, counts, pix, C, cfg)
        cols, out_rows, res_rows = PC.rect(C).stop, 8, C + 2
        fwd_ops = OPS_IN_RECT * (a + o) + OPS_OUT_RECT * x
        bwd_ops = (OPS_APPLIED_BWD + 14 + C) * a + OPS_IN_RECT * o + OPS_OUT_RECT * x
    else:
        a, o, x, rows = walked_surfel_pairs(inst, counts, pix, C, cfg)
        cols, out_rows, res_rows = S.validf(C), 16, C + 9
        fwd_ops = (OPS_S_IN_RECT + OPS_S_FWD_APPLIED + 2 * C) * a + OPS_S_IN_RECT * o \
            + OPS_S_OUT_RECT * x
        bwd_ops = (OPS_S_BWD_APPLIED + 4 * C) * a + OPS_S_IN_RECT * o + OPS_S_OUT_RECT * x
    fwd = Bound(tile_bytes(counts, rows, cols, pix, T * out_rows * npix), fwd_ops)
    # the backward reads the forward's columns, res and g, and writes the
    # gradient of every walked row once
    bwd = Bound(tile_bytes(counts, rows, cols, pix, 2 * T * res_rows * npix, rows * cols),
                bwd_ops)
    return fwd, bwd


class Work(NamedTuple):
    """What the reference derives for one frame, the counts' inputs."""

    visible_anchors: int      # live anchors that pass the prefilter
    kept: int                 # decoded gaussians that are rendered (visible, opacity > 0)
    pixels: int
    live_params: int          # parameter elements of the live anchors and the heads
    composite_fwd: Bound
    composite_bwd: Bound
    stages: tuple = ()        # (name, Bound) of each stage the configuration names


def decode_ops(model: dict) -> int:
    """FP32 operations of the decode per anchor, forward: the four heads'
    two products (two per multiply-add) and the element-wise rest."""
    from .scene import mlp_dims

    hid = model["mlp_hidden"]
    return sum(2 * d_in * hid + 2 * hid * d_out for d_in, d_out in mlp_dims(model).values()) \
        + OPS_DECODE_ELEMENTWISE * model["n_offsets"]


def step_ops(w: Work, model: dict, variant: str, train: bool) -> int:
    """FP32 operations of a frame (render) or a training step on it; a
    stage's operations count as the frame's forward."""
    proj = OPS_PROJECT if variant == "beam" else OPS_SURFEL_PROJECT
    fwd = (decode_ops(model) * w.visible_anchors + proj * w.kept
           + sum(b.ops for _, b in w.stages))
    if not train:
        return fwd + w.composite_fwd.ops
    return ((1 + BWD_FACTOR) * (fwd + OPS_LOSS_PIXEL * w.pixels) + w.composite_fwd.ops
            + w.composite_bwd.ops + OPS_ADAM * w.live_params)
