"""Forward composite over per-tile instance lists: kernel K1 and its plain
version.

`composite_tiles` is the counterpart of `composite_tiles_pallas`
(`lidargs_tpu/ops/pallas_composite.py`, kernel body `_fwd_kernel`). On a
CUDA tensor it launches the hand-written kernel of `csrc/composite_fwd.cu`
(built with nvcc for sm_90a at the first call, loaded with ctypes); on a CPU
tensor it runs `composite_tiles_plain`, the plain PyTorch version with the
same signature and output layout. There is no fallback from one to the
other: a CUDA tensor the kernel cannot take raises.

Layout (shared by both):
  inst   [T, K, F] f32   depth-ordered packed instances (PackedCols)
  counts [T]       i32   live rows per tile
  pix    [T, 8, NPIX] f32  rows 0-2 unit ray dir, row 3 column, row 4 row
  out    [T, 8, NPIX] f32  rows 0..C-1 features, row C depth, row C+1 final
                           transmittance, the rest zero
"""
from __future__ import annotations

import ctypes

import torch

from ..config import RasterConfig
from ..utils import cuda_build
from .composite import composite_packed
from .projection import PackedCols

OUT_ROWS = 8
MAX_NPIX = 1024          # one thread per pixel, one block per tile

# Launches of the CUDA kernel since the last reset (a plain count; the CPU
# path does not add to it).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = cuda_build.load("composite_fwd")
        fn = lib.lidargs_composite_fwd
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, I, I, I, I, I, Fl, Fl, Fl, P]
        fn.restype = I
        lib.lidargs_cuda_error_string.argtypes = [I]
        lib.lidargs_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.lidargs_cuda_error_string)
    return _fn


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


def _check_cuda_inputs(inst, counts, pix, C: int):
    dev = inst.device
    if counts.device != dev or pix.device != dev:
        raise ValueError(f"inputs on different devices: {inst.device}, "
                         f"{counts.device}, {pix.device}")
    if inst.dtype != torch.float32 or pix.dtype != torch.float32:
        raise TypeError(f"inst and pix must be float32, got {inst.dtype}, {pix.dtype}")
    if counts.dtype != torch.int32:
        raise TypeError(f"counts must be int32, got {counts.dtype}")
    if inst.dim() != 3 or pix.dim() != 3 or counts.dim() != 1:
        raise ValueError("expected inst [T,K,F], counts [T], pix [T,8,NPIX]")
    T, K, Fw = inst.shape
    if counts.shape[0] != T or pix.shape[0] != T or pix.shape[1] != OUT_ROWS:
        raise ValueError(f"shape mismatch: inst {tuple(inst.shape)}, counts "
                         f"{tuple(counts.shape)}, pix {tuple(pix.shape)}")
    if not 1 <= C <= OUT_ROWS - 2:
        raise ValueError(f"C={C} does not fit {OUT_ROWS} output rows")
    if Fw < PackedCols.rect(C).stop:
        raise ValueError(f"row width {Fw} is narrower than PackedCols for C={C}")
    if not 1 <= pix.shape[2] <= MAX_NPIX:
        raise ValueError(f"NPIX={pix.shape[2]} outside 1..{MAX_NPIX}")
    if not (inst.is_contiguous() and counts.is_contiguous() and pix.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def composite_tiles(inst: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor,
                    C: int, cfg: RasterConfig) -> torch.Tensor:
    """[T, K, F] instances + [T] counts + [T, 8, NPIX] pixel blocks ->
    [T, 8, NPIX]: K1 on a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if inst.device.type == "cpu":
        return composite_tiles_plain(inst, counts, pix, C, cfg)
    if inst.device.type != "cuda":
        raise ValueError(f"composite_tiles: unsupported device {inst.device}")
    _check_cuda_inputs(inst, counts, pix, C)
    T, K, Fw = inst.shape
    npix = pix.shape[2]
    out = torch.empty((T, OUT_ROWS, npix), dtype=torch.float32, device=inst.device)
    if T == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(inst.device):
        stream = torch.cuda.current_stream(inst.device).cuda_stream
        err = fn(inst.data_ptr(), counts.data_ptr(), pix.data_ptr(), out.data_ptr(),
                 T, K, Fw, npix, C, cfg.alpha_min, cfg.alpha_clamp,
                 cfg.transmittance_min, stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: {err_str(err).decode()}")
    launches += 1
    return out
