"""Depth-ordered alpha compositing over chunked instance lists (plain
PyTorch).

Counterpart of `lidargs_tpu/ops/composite.py`. The serial front-to-back
walk of the reference (stop at the first instance i with
T*(1-alpha_i) < T_min, and do not apply that instance) is expressed with
prefix products over [n_lists, chunk, n_pix] blocks: because every
(1-alpha) factor is <= 1, the naive prefix agrees with the true
transmittance up to and including the first crossing. This is the plain
version the CUDA composite kernel is held to, and the CPU path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import RasterConfig
from .projection import PackedCols as PC


class CompositeOut(NamedTuple):
    color: torch.Tensor    # [n_lists, C, n_pix]
    depth: torch.Tensor    # [n_lists, n_pix]
    final_T: torch.Tensor  # [n_lists, n_pix]


class _Gathered(NamedTuple):
    """One chunk of per-instance gaussian state, gathered for a list."""

    sphere_mean: torch.Tensor  # [L, K, 3]
    u1: torch.Tensor           # [L, K, 3]
    u2: torch.Tensor           # [L, K, 3]
    conic: torch.Tensor        # [L, K, 3]
    opacity: torch.Tensor      # [L, K]
    depth: torch.Tensor        # [L, K]
    feat: torch.Tensor         # [L, K, C]
    pix_rect: torch.Tensor     # [L, K, 4]
    valid: torch.Tensor        # [L, K]


def gather_instances(splats, ids: torch.Tensor, valid: torch.Tensor) -> _Gathered:
    return _Gathered(
        sphere_mean=splats.sphere_mean[ids],
        u1=splats.u1[ids],
        u2=splats.u2[ids],
        conic=splats.conic[ids],
        opacity=splats.opacity[ids],
        depth=splats.depth[ids],
        feat=splats.feat[ids],
        pix_rect=splats.pix_rect[ids],
        valid=valid & splats.valid[ids],
    )


def instance_alpha(
    ch: _Gathered,
    pix_dir: torch.Tensor,   # [L, n_pix, 3] unit ray dirs
    pix_x: torch.Tensor,     # [L, n_pix] int columns
    pix_y: torch.Tensor,     # [L, n_pix] int rows
    cfg: RasterConfig,
):
    """Alpha + pass mask for a [L, K] chunk against [L, n_pix] pixels,
    including the parity-rect test."""
    d_vec = ch.sphere_mean[:, :, None, :] - pix_dir[:, None, :, :]   # [L,K,npix,3]
    u1_sq = (ch.u1 * ch.u1).sum(-1)[:, :, None]
    u2_sq = (ch.u2 * ch.u2).sum(-1)[:, :, None]
    dx = (d_vec * ch.u1[:, :, None, :]).sum(-1) / u1_sq.clamp_min(1e-20)
    dy = (d_vec * ch.u2[:, :, None, :]).sum(-1) / u2_sq.clamp_min(1e-20)

    con = ch.conic
    power = (
        -0.5 * (con[:, :, 0, None] * dx * dx + con[:, :, 2, None] * dy * dy)
        - con[:, :, 1, None] * dx * dy
    )
    alpha = torch.clamp_max(ch.opacity[:, :, None] * torch.exp(power), cfg.alpha_clamp)

    rect = ch.pix_rect
    px, py = pix_x[:, None, :], pix_y[:, None, :]
    in_rect = (
        (px >= rect[:, :, 0, None]) & (px < rect[:, :, 1, None])
        & (py >= rect[:, :, 2, None]) & (py < rect[:, :, 3, None])
    )
    pass_ = ch.valid[:, :, None] & in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
    return alpha, pass_


def composite_chunk(carry, ch_alpha_pass_featdep, cfg: RasterConfig):
    """One scan step: fold a [L, K, n_pix] chunk into the running
    (T, done, color, depth) state with the prefix-product formulation."""
    T, done, color, depth_acc = carry
    alpha, pass_, feat, dep = ch_alpha_pass_featdep

    a_eff = torch.where(pass_, alpha, torch.zeros_like(alpha))
    one_m = 1.0 - a_eff
    # exclusive prefix product within the chunk, seeded by carry T
    prefix = torch.cat([torch.ones_like(one_m[:, :1]),
                        torch.cumprod(one_m, dim=1)[:, :-1]], dim=1)
    P = T[:, None, :] * prefix
    crossing = pass_ & (P * (1.0 - alpha) < cfg.transmittance_min)
    dead = torch.cumsum(crossing.to(torch.int32), dim=1) > 0     # at-or-after first
    applied = pass_ & ~dead & ~done[:, None, :]

    w = torch.where(applied, alpha * P, torch.zeros_like(alpha))
    color = color + torch.einsum("lkp,lkc->lcp", w, feat)
    depth_acc = depth_acc + (w * dep[:, :, None]).sum(1)
    T = T * torch.where(applied, 1.0 - alpha, torch.ones_like(alpha)).prod(1)
    done = done | (crossing & ~done[:, None, :]).any(1)
    return (T, done, color, depth_acc)


def _init_carry(L: int, C: int, n_pix: int, device):
    f32 = torch.float32
    return (
        torch.ones((L, n_pix), dtype=f32, device=device),
        torch.zeros((L, n_pix), dtype=torch.bool, device=device),
        torch.zeros((L, C, n_pix), dtype=f32, device=device),
        torch.zeros((L, n_pix), dtype=f32, device=device),
    )


def composite_depth_ordered(
    splats,
    sorted_ids: torch.Tensor,     # [L, K_total] per-list depth-ordered gaussian ids
    sorted_valid: torch.Tensor,   # [L, K_total] instance validity
    pix_dir: torch.Tensor,        # [L, n_pix, 3]
    pix_x: torch.Tensor,          # [L, n_pix]
    pix_y: torch.Tensor,          # [L, n_pix]
    cfg: RasterConfig,
) -> CompositeOut:
    """Composite each list's instances (already depth-sorted) over its
    pixels, gathering each chunk's rows from `splats`."""
    L, K_total = sorted_ids.shape
    n_pix = pix_x.shape[1]
    C = splats.feat.shape[-1]
    K = min(cfg.chunk, K_total)
    n_chunks = -(-K_total // K)
    pad = n_chunks * K - K_total
    sorted_ids = F.pad(sorted_ids, (0, pad))
    sorted_valid = F.pad(sorted_valid, (0, pad))

    carry = _init_carry(L, C, n_pix, pix_x.device)
    for i in range(n_chunks):
        sl = slice(i * K, (i + 1) * K)
        ch = gather_instances(splats, sorted_ids[:, sl], sorted_valid[:, sl])
        alpha, pass_ = instance_alpha(ch, pix_dir, pix_x, pix_y, cfg)
        carry = composite_chunk(carry, (alpha, pass_, ch.feat, ch.depth), cfg)
    T, _done, color, depth = carry
    return CompositeOut(color=color, depth=depth, final_T=T)


def composite_packed(
    inst: torch.Tensor,           # [L, K, F] pre-gathered packed instances (PackedCols)
    inst_valid: torch.Tensor,     # [L, K] front-packed validity
    pix_dir: torch.Tensor,        # [L, n_pix, 3]
    pix_x: torch.Tensor,          # [L, n_pix]
    pix_y: torch.Tensor,          # [L, n_pix]
    C: int,
    cfg: RasterConfig,
) -> CompositeOut:
    """composite_depth_ordered on instances already gathered into one dense
    [L, K, F] tensor."""
    L, K_total, _ = inst.shape
    n_pix = pix_x.shape[1]
    K = min(cfg.chunk, K_total)
    n_chunks = -(-K_total // K)
    pad = n_chunks * K - K_total
    inst = F.pad(inst, (0, 0, 0, pad))
    inst_valid = F.pad(inst_valid, (0, pad))

    carry = _init_carry(L, C, n_pix, pix_x.device)
    for i in range(n_chunks):
        ch_i = inst[:, i * K:(i + 1) * K]
        ch = _Gathered(
            sphere_mean=ch_i[..., PC.MEAN],
            u1=ch_i[..., PC.U1],
            u2=ch_i[..., PC.U2],
            conic=ch_i[..., PC.CONIC],
            opacity=ch_i[..., PC.OPACITY],
            depth=ch_i[..., PC.DEPTH],
            feat=ch_i[..., PC.FEAT0:PC.FEAT0 + C],
            pix_rect=ch_i[..., PC.rect(C)].to(torch.int32),
            valid=inst_valid[:, i * K:(i + 1) * K] & (ch_i[..., PC.validf(C)] > 0.0),
        )
        alpha, pass_ = instance_alpha(ch, pix_dir, pix_x, pix_y, cfg)
        carry = composite_chunk(carry, (alpha, pass_, ch.feat, ch.depth), cfg)
    T, _done, color, depth = carry
    return CompositeOut(color=color, depth=depth, final_T=T)


def pixel_rays(rows: torch.Tensor, cols: torch.Tensor, beams: torch.Tensor, W: int):
    """Unit ray dirs for integer pixel coords: alpha = beams[H-1-row],
    beta = -(col - W/2)/W * 2*pi."""
    H = beams.shape[0]
    alp = beams[H - 1 - rows]
    beta = -(cols.to(torch.float32) - W / 2.0) / W * 2.0 * math.pi
    return torch.stack(
        [torch.cos(alp) * torch.cos(beta), torch.cos(alp) * torch.sin(beta), torch.sin(alp)],
        dim=-1,
    )
