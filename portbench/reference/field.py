"""The anchor field's decode and the two render paths, the reference's.

A frozen copy of the port's plain decode (`models/field.py`: Scaffold-GS
anchors decoded by view-conditioned two-layer MLP heads, each head applied
on its own) and of its render paths: prefilter -> decode -> projection ->
tiled splat (beam), or -> surfel preprocess -> tiled surfel splat
(surfel). Everything is plain PyTorch in float32, differentiated by
autograd. The feature bank and the appearance embedding are not written
out: the benchmark's configurations use neither.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import ModelConfig, RasterConfig
from .projection import preprocess_gaussians, visible_filter
from .rasterize import RenderOut, render_tiled
from .surfel import SurfelOut, preprocess_surfels, render_surfels


class Frame(NamedTuple):
    """A sensor pose and its ground truth, as the reference reads them."""

    w2s_rot: torch.Tensor      # [3, 3]
    w2s_trans: torch.Tensor    # [3]
    center: torch.Tensor       # [3]
    beams: torch.Tensor        # [H] ascending inclinations
    gt_image: torch.Tensor     # [3, H, W] raydrop, intensity, depth

    @property
    def W(self) -> int:
        return self.gt_image.shape[-1]


class NeuralGaussians(NamedTuple):
    xyz: torch.Tensor            # [C, k, 3]
    feat: torch.Tensor           # [C, k, channels]
    opacity: torch.Tensor        # [C, k]
    scaling: torch.Tensor        # [C, k, 3]
    rot: torch.Tensor            # [C, k, 4]
    mask: torch.Tensor           # [C, k]


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x @ p["l1"]["w"] + p["l1"]["b"]) @ p["l2"]["w"] + p["l2"]["b"]


def decode(params: dict, valid: torch.Tensor, anchor_visible: torch.Tensor,
           cam_center: torch.Tensor, cfg: ModelConfig) -> NeuralGaussians:
    """Every anchor's k neural gaussians for this view, masked."""
    if cfg.use_feat_bank or cfg.appearance_dim > 0:
        raise ValueError("the reference decodes without a feature bank or appearance")
    k = cfg.n_offsets
    anchor = params["anchor"]
    n = anchor.shape[0]
    ob_view = anchor - cam_center
    d2 = (ob_view * ob_view).sum(1, keepdim=True)
    ok = d2 > 0.0
    ob_dist = torch.sqrt(torch.where(ok, d2, torch.ones_like(d2)))
    ob_view = torch.where(ok, ob_view, torch.zeros_like(ob_view)) / ob_dist
    with_dist = torch.cat([params["feat"], ob_view, ob_dist], 1)
    no_dist = torch.cat([params["feat"], ob_view], 1)
    pick = lambda on: with_dist if on else no_dist
    neural_op = torch.tanh(apply_mlp(params["mlp_opacity"], pick(cfg.add_opacity_dist)))
    col_in = pick(cfg.add_color_dist)
    intensity = torch.sigmoid(apply_mlp(params["mlp_color"], col_in))
    raydrop = torch.sigmoid(apply_mlp(params["mlp_raydrop"], col_in))
    scale_rot = apply_mlp(params["mlp_cov"], pick(cfg.add_cov_dist)).reshape(n, k, 7)
    color = torch.cat([intensity.reshape(n, k, cfg.color_channel - 1),
                       raydrop.reshape(n, k, 1)], -1)
    scaling_all = torch.exp(params["scaling"])
    scaling = scaling_all[:, None, 3:] * torch.sigmoid(scale_rot[..., :3])
    q = scale_rot[..., 3:7]
    qn2 = (q * q).sum(-1, keepdim=True)
    unit = torch.zeros_like(q)
    unit[..., 0] = 1.0
    rot = torch.where(qn2 > 0, q, unit) / torch.sqrt(torch.where(qn2 > 0, qn2,
                                                                 torch.ones_like(qn2)))
    xyz = anchor[:, None, :] + params["offset"] * scaling_all[:, None, :3]
    vis = (valid & anchor_visible)[:, None]
    return NeuralGaussians(xyz=xyz, feat=color, opacity=neural_op, scaling=scaling, rot=rot,
                           mask=vis & (neural_op > 0.0))


@torch.no_grad()
def prefilter(params: dict, valid: torch.Tensor, frame: Frame,
              rcfg: RasterConfig) -> torch.Tensor:
    """The anchors projected with their offset scales: those with radii > 0."""
    scales = torch.exp(params["scaling"][:, :3])
    q = params["rotation"]
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1e-12)
    return visible_filter(params["anchor"], scales, q, valid, frame.w2s_rot, frame.w2s_trans,
                          frame.beams, frame.W, rcfg)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def render(params: dict, valid: torch.Tensor, frame: Frame, mcfg: ModelConfig,
           rcfg: RasterConfig, bg: torch.Tensor, variant: str,
           probe: Optional[dict] = None):
    """(RenderOut or SurfelOut, NeuralGaussians) of one frame. `probe`,
    when given, gets the frame's tile lists ("lists"), its visible anchors
    ("visible_anchors") and its rendered gaussians ("kept")."""
    anchor_visible = prefilter(params, valid, frame, rcfg)
    ng = decode(params, valid, anchor_visible, frame.center, mcfg)
    if probe is not None:
        probe["visible_anchors"] = int((valid & anchor_visible).sum())
        probe["kept"] = int(ng.mask.sum())
    if variant == "beam":
        splats = preprocess_gaussians(_flat(ng.xyz), _flat(ng.scaling), _flat(ng.rot),
                                      _flat(ng.opacity), _flat(ng.feat), _flat(ng.mask),
                                      frame.w2s_rot, frame.w2s_trans, frame.beams, frame.W,
                                      rcfg)
        out: RenderOut = render_tiled(splats, frame.beams, frame.W, bg, rcfg, probe)
        return out, ng
    if variant == "surfel":
        pk = preprocess_surfels(_flat(ng.xyz), _flat(ng.scaling)[:, :2], _flat(ng.rot),
                                _flat(ng.opacity), _flat(ng.feat), _flat(ng.mask),
                                frame.w2s_rot, frame.w2s_trans, frame.beams, frame.W, rcfg)
        out: SurfelOut = render_surfels(pk, frame.beams, frame.W, bg, rcfg,
                                        C=ng.feat.shape[-1], probe=probe)
        return out, ng
    raise ValueError(f"unknown variant {variant!r}")
