"""The forward fronts as one kernel each: F1 (beam) and F2 (surfel), and
their plain versions.

`front_packed` is the front of a re-simulated beam frame, prefilter ->
decode -> projection -> pack, on the anchor rows it is given. On a CUDA
tensor it launches the hand-written kernel F1 (`csrc/front_fwd.cu`, built
with nvcc for sm_90a at the first call and loaded with ctypes); on a CPU
tensor it runs its plain version, `pack_splats(field_splats(...)[0])`, the
torch path itself. `surfel_front_packed` is the surfel frame's front,
prefilter -> decode -> surfel preprocess: F2 (`csrc/surfel_front_fwd.cu`)
on a CUDA tensor, `field_surfels(...)[0]` on a CPU tensor. The two kernels
share the prefilter, the decode and the walk (`csrc/front_decode.cuh`) and
differ in the row they write. There is no fallback from a kernel to its
plain version: a CUDA input the kernels cannot take raises
(`check_front_inputs`).

F1 and F2 compute no gradient: they serve the forward frame alone
(`models/field.py` `render_frame_packed`, `render_surfel_packed`), for the
layouts `takes` names: heads that share one input (`heads_fusable`) of
HIDDEN units each, at most MAX_CHANNELS channels, no feature bank and no
visible-anchor cap. The frame takes the packed path for those layouts
alone, on the CPU too, so that the CPU tests hold the choice the card
makes. The launches are counted under each kernel's symbol,
`lidargs_front_fwd` and `lidargs_surfel_front_fwd`, in
`utils/cuda_build.py` `launches`.

Layout:
  pk      [P, F] f32  rows, P = B * k, row a * k + j the j-th gaussian of
                      anchor a: PackedCols (F1) or SurfelCols (F2)
  depth   [P]    f32  range, 4 * far on invalid rows (the cull sort's key)
  valid   [P]    bool survives culling (RenderOut.visible, SurfelOut.visible)
  n_valid []     i64  the count of valid rows
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from typing import Optional

from ..config import ModelConfig, RasterConfig
from ..lidar.frames import LidarFrame
from ..utils import cuda_build
from .projection import PackedCols, pack_splats
from .surfel import SurfelCols

HEADS = ("mlp_opacity", "mlp_color", "mlp_raydrop", "mlp_cov")
ANCHOR_INPUTS = ("anchor", "offset", "feat", "scaling", "rotation")
HIDDEN = 32                 # hidden units of each head (`kHd` of the kernel)
MAX_CHANNELS = 4            # channels C the kernel is instantiated for
FRAME_INPUTS = ("w2s_rot", "w2s_trans", "center", "beams")

# the launch function's arguments between the tensor pointers and the
# stream: B, k, fd, d_in, C, H, W, bx, by, then near, far, lowpass, margin,
# col_pitch, inv_col, inv_bx, inv_by, sentinel
_ARGS = [ctypes.c_int] * 9 + [ctypes.c_float] * 9
# F2's: F1's, then the surfel centre's divergence margin
_SURFEL_ARGS = _ARGS + [ctypes.c_float]


def front_packed_plain(params: dict, valid: torch.Tensor, frame: LidarFrame,
                       mcfg: ModelConfig, rcfg: RasterConfig):
    """The plain version of F1, the torch path: (pack_splats of
    `field_splats`' Splats, their depth, valid and valid count)."""
    from ..models.field import field_splats

    sp = field_splats(params, valid, frame, mcfg, rcfg)[0]
    return pack_splats(sp), sp.depth, sp.valid, sp.valid.sum()


def surfel_front_packed_plain(params: dict, valid: torch.Tensor, frame: LidarFrame,
                              mcfg: ModelConfig, rcfg: RasterConfig):
    """The plain version of F2, the torch path: (`field_surfels`' packed
    rows, their depth column, valid and valid count)."""
    from ..models.field import field_surfels

    pk = field_surfels(params, valid, frame, mcfg, rcfg)[0]
    vis = pk[:, SurfelCols.validf(mcfg.color_channel)] > 0.0
    return pk, pk[:, SurfelCols.DEPTH], vis, vis.sum()


def head_widths(mcfg: ModelConfig) -> tuple:
    """The second layers' widths of the four heads, in HEADS' order."""
    k = mcfg.n_offsets
    return (k, (mcfg.color_channel - 1) * k, k, 7 * k)


def refusal(params: dict, mcfg: ModelConfig, rcfg: RasterConfig) -> Optional[str]:
    """Why `front_packed` and `surfel_front_packed` do not compute this
    layout's front, or None where they do: the four heads read one input
    (`heads_fusable`), each of HIDDEN units, C in 1..MAX_CHANNELS, no
    feature bank, no visible-anchor cap. The one place that decides it, for
    both kernels: `models/field.py` `frame_render` chooses the packed frame
    by it, `check_front_inputs` refuses by it."""
    from ..models.field import heads_fusable

    cap = rcfg.visible_anchor_cap
    if not heads_fusable(mcfg, params):
        return "the heads read different inputs (add_*_dist differ, or appearance rows)"
    if mcfg.use_feat_bank:
        return "a feature bank"
    if cap and cap > 0:
        return f"visible_anchor_cap={cap}"
    if mcfg.mlp_hidden != HIDDEN:
        return f"mlp_hidden={mcfg.mlp_hidden}, not {HIDDEN}"
    if not 1 <= mcfg.color_channel <= MAX_CHANNELS:
        return f"color_channel={mcfg.color_channel} outside 1..{MAX_CHANNELS}"
    return None


def takes(params: dict, mcfg: ModelConfig, rcfg: RasterConfig) -> bool:
    """Whether `front_packed` and `surfel_front_packed` compute this
    layout's front (`refusal`)."""
    return refusal(params, mcfg, rcfg) is None


def check_front_inputs(params: dict, valid: torch.Tensor, frame: LidarFrame,
                       mcfg: ModelConfig, rcfg: RasterConfig) -> int:
    """Raise on inputs F1 and F2 cannot take; return the heads' input width
    d_in. They take a layout of `takes`, contiguous float32 anchor rows [B, ...]
    and a bool [B] `valid` on one card, heads shaped as the layout says
    (d_in = feat_dim + 3, +1 with the distance), a beam table of at least 2
    rows (as `render_field` needs too) and the frame's pose on the same
    card."""
    why = refusal(params, mcfg, rcfg)
    if why is not None:
        raise ValueError(f"F1 and F2 do not take this layout: {why}")
    dev = valid.device
    B = valid.shape[0]
    k, fd = mcfg.n_offsets, mcfg.feat_dim
    if valid.dtype != torch.bool or valid.dim() != 1:
        raise TypeError(f"valid must be a bool [B] tensor, got {valid.dtype} {tuple(valid.shape)}")
    want = {"anchor": (B, 3), "offset": (B, k, 3), "feat": (B, fd), "scaling": (B, 6),
            "rotation": (B, 4)}
    d_in = params["mlp_opacity"]["l1"]["w"].shape[0]
    if d_in not in (fd + 3, fd + 4):
        raise ValueError(f"heads read {d_in} inputs, not feat_dim + 3 or + 4 = {fd + 3}, {fd + 4}")
    for name, width in zip(HEADS, head_widths(mcfg)):
        want[f"{name}.l1.w"] = (d_in, HIDDEN)
        want[f"{name}.l1.b"] = (HIDDEN,)
        want[f"{name}.l2.w"] = (HIDDEN, width)
        want[f"{name}.l2.b"] = (width,)
    for n in FRAME_INPUTS:
        want[f"frame.{n}"] = {"w2s_rot": (3, 3), "w2s_trans": (3,), "center": (3,),
                              "beams": (frame.beams.shape[0],)}[n]
    for name, shape in want.items():
        x = _input(params, frame, name)
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, valid on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if frame.beams.shape[0] < 2:
        raise ValueError("the beam table needs at least 2 rows")
    if rcfg.ref_block_x < 1 or rcfg.ref_block_y < 1:
        raise ValueError("ref_block_x and ref_block_y must be positive")
    return d_in


def _input(params: dict, frame: LidarFrame, name: str) -> torch.Tensor:
    if name.startswith("frame."):
        return getattr(frame, name[len("frame."):])
    if "." in name:
        head, layer, part = name.split(".")
        return params[head][layer][part]
    return params[name]


def _f32(x: float) -> float:
    """x rounded to float32, as PyTorch casts a Python scalar."""
    return float(np.float32(x))


def front_packed(params: dict, valid: torch.Tensor, frame: LidarFrame,
                 mcfg: ModelConfig, rcfg: RasterConfig):
    """The forward beam front on the anchor rows of `params` / `valid`:
    (pk [P, F], depth [P], valid [P], n_valid). F1 on a CUDA tensor, the
    plain version on a CPU tensor."""
    if valid.device.type == "cpu":
        return front_packed_plain(params, valid, frame, mcfg, rcfg)
    return _launch("front_fwd", "lidargs_front_fwd", _ARGS, PackedCols, (), params, valid,
                   frame, mcfg, rcfg)


def surfel_front_packed(params: dict, valid: torch.Tensor, frame: LidarFrame,
                        mcfg: ModelConfig, rcfg: RasterConfig):
    """The forward surfel front on the anchor rows of `params` / `valid`:
    (pk [P, F] in SurfelCols, depth [P], valid [P], n_valid). F2 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if valid.device.type == "cpu":
        return surfel_front_packed_plain(params, valid, frame, mcfg, rcfg)
    return _launch("surfel_front_fwd", "lidargs_surfel_front_fwd", _SURFEL_ARGS, SurfelCols,
                   (rcfg.surfel_ray_divergence_angle,), params, valid, frame, mcfg, rcfg)


def _launch(source: str, symbol: str, scalar_types: list, cols, extra: tuple, params: dict,
            valid: torch.Tensor, frame: LidarFrame, mcfg: ModelConfig, rcfg: RasterConfig):
    """F1 or F2 (`symbol` of `csrc/<source>.cu`) on the rows [0, B), rows
    of `cols`' width; `extra` the scalars after F1's."""
    if valid.device.type != "cuda":
        raise ValueError(f"{symbol}: unsupported device {valid.device}")
    outs, tensors, scalars = launch_args(params, valid, frame, mcfg, rcfg, cols)
    if valid.shape[0] > 0:
        cuda_build.launch(source, symbol, scalar_types, tensors, scalars + extra)
    return outs


def launch_args(params: dict, valid: torch.Tensor, frame: LidarFrame, mcfg: ModelConfig,
                rcfg: RasterConfig, cols=PackedCols):
    """The outputs (pk of `cols`' width, depth, valid, n_valid zeroed), the
    tensors and F1's scalars of a launch of F1 or F2, after
    `check_front_inputs`."""
    d_in = check_front_inputs(params, valid, frame, mcfg, rcfg)
    dev = valid.device
    B, k, C = valid.shape[0], mcfg.n_offsets, mcfg.color_channel
    P = B * k
    pk = torch.empty((P, cols.width(C)), dtype=torch.float32, device=dev)
    depth = torch.empty((P,), dtype=torch.float32, device=dev)
    vout = torch.empty((P,), dtype=torch.bool, device=dev)
    n_valid = torch.zeros((), dtype=torch.int64, device=dev)
    heads = [params[h][layer][part] for h in HEADS for layer, part in
             (("l1", "w"), ("l1", "b"), ("l2", "w"), ("l2", "b"))]
    tensors = ([params[n] for n in ANCHOR_INPUTS] + [valid] + heads
               + [getattr(frame, n) for n in FRAME_INPUTS] + [pk, depth, vout, n_valid])
    pitch = _f32(2.0 * math.pi / frame.W)
    bx, by = rcfg.ref_block_x, rcfg.ref_block_y
    scalars = (B, k, mcfg.feat_dim, d_in, C, frame.beams.shape[0], frame.W, bx, by,
               rcfg.near, rcfg.far, rcfg.lowpass, 2.0 * rcfg.ray_divergence_angle, pitch,
               _f32(np.float32(1.0) / np.float32(pitch)), _f32(np.float32(1.0) / np.float32(bx)),
               _f32(np.float32(1.0) / np.float32(by)), 4.0 * rcfg.far)
    return (pk, depth, vout, n_valid), tensors, scalars
